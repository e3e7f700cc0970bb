"""The port's compute ops: the flash-attention kernels (``attention``) and
the embedding lookup."""

from .embedding import embedding_lookup

__all__ = ["embedding_lookup"]
