from .inference_model import InferenceModel

__all__ = ["InferenceModel"]
