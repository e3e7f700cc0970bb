from .time_sequence import TimeSequenceFeatureTransformer, roll_windows

__all__ = ["TimeSequenceFeatureTransformer", "roll_windows"]
