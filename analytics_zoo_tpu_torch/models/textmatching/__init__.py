from .knrm import KNRM, KNRMNet

__all__ = ["KNRM", "KNRMNet"]
