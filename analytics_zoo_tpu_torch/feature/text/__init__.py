from .text_set import (DistributedTextSet, LocalTextSet, TextFeature,
                       TextSet)

__all__ = ["DistributedTextSet", "LocalTextSet", "TextFeature", "TextSet"]
