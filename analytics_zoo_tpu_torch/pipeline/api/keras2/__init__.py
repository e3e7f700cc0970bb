"""keras2 API (counterpart of ``analytics_zoo_tpu/pipeline/api/keras2``):
tf.keras argument names (``units``, ``filters``, ``kernel_size``,
``rate``, ``padding``, ``data_format``) over the port's Keras v1 layers,
plus the ``Maximum``/``Minimum``/``Average`` merges.

Each factory returns the v1 ``torch.nn`` module the JAX factory's flax
module corresponds to, with the same field mapping, so keras2 and v1
layers compose in one ``Sequential``/``Model`` and their weights cross
through ``interop`` under the same names. ``Input``, ``Model`` and
``Sequential`` are the v1 engine's.
"""

from ..keras.engine.topology import Input, Model, Sequential
from . import layers

__all__ = ["Input", "Model", "Sequential", "layers"]
