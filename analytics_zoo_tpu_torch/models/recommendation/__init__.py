from .neuralcf import NeuralCF, NeuralCFNet
from .session_recommender import SessionRecommender, SessionRecommenderNet
from .wide_and_deep import ColumnFeatureInfo, WideAndDeep, WideAndDeepNet

__all__ = ["NeuralCF", "NeuralCFNet", "SessionRecommender",
           "SessionRecommenderNet", "ColumnFeatureInfo", "WideAndDeep",
           "WideAndDeepNet"]
