from .text_classifier import TextClassifier, TextClassifierNet

__all__ = ["TextClassifier", "TextClassifierNet"]
