from .estimator import (BERTClassifier, BERTNER, BERTSQuAD,
                        BERTBaseEstimator, bert_input_fn)

__all__ = ["BERTBaseEstimator", "BERTClassifier", "BERTNER", "BERTSQuAD",
           "bert_input_fn"]
