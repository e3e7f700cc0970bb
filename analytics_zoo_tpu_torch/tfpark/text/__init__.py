from .estimator import (BERTClassifier, BERTNER, BERTSQuAD,
                        BERTBaseEstimator, bert_input_fn)
from .keras import NER, POSTagger, IntentEntity

__all__ = ["BERTBaseEstimator", "BERTClassifier", "BERTNER", "BERTSQuAD",
           "bert_input_fn", "NER", "POSTagger", "IntentEntity"]
