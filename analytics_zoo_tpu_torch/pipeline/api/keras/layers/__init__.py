from .self_attention import (BERT, MultiHeadAttention, TransformerBlock,
                             TransformerLayer)

__all__ = ["BERT", "MultiHeadAttention", "TransformerBlock",
           "TransformerLayer"]
