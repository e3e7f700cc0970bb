from .estimator import bert_input_fn

__all__ = ["bert_input_fn"]
