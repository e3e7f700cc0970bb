"""keras2 embedding (counterpart of ``analytics_zoo_tpu/pipeline/api/
keras2/layers/embeddings.py``): ``Embedding(input_dim, output_dim,
embeddings_initializer, input_length)`` over the v1 ``Embedding`` with
zero-based ids, as tf.keras numbers them."""

from __future__ import annotations

from ...keras import layers as K1
from .core import _shape

__all__ = ["Embedding"]


def Embedding(input_dim, output_dim, embeddings_initializer="uniform",
              weights=None, trainable=True, input_length=None,
              input_shape=None, **kwargs):
    """``input_length`` is v1's ``input_shape=(length,)``; keras-2 callers
    pass ``weights=[matrix]``, v1 takes the bare matrix."""
    if input_length is not None and input_shape is None:
        input_shape = (int(input_length),)
    if isinstance(weights, (list, tuple)):
        if len(weights) != 1:
            raise ValueError(
                f"weights must be [embedding_matrix], got {len(weights)} "
                "arrays")
        weights = weights[0]
    return K1.Embedding(input_dim=int(input_dim),
                        output_dim=int(output_dim),
                        init_method=embeddings_initializer,
                        weights=weights, trainable=trainable,
                        zero_based_id=True,
                        input_shape=_shape(None, input_shape), **kwargs)
