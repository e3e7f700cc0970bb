"""On-device input preprocessing, the train step's "prologue" (counterpart
of ``analytics_zoo_tpu/orca/learn/prologue.py``).

The host ships narrow source dtypes (uint8 pixels, int32 ids and labels)
and the step starts by casting and normalising them on the device, so the
wire carries 2-4x fewer bytes than a host-side float pipeline would.

Bit-identity contract: every op computes in float32 with the same formula
as its numpy host twin, so "normalize on the device" gives the exact bits
of "normalize on the host, ship f32". Each :class:`LeafOp` carries both:
the device function is a torch function, and the host twin is the JAX
package's numpy twin, bit for bit.

Usage::

    from analytics_zoo_tpu_torch.orca.learn.prologue import (
        BatchPrologue, image_normalize)

    est = TPUEstimator(module, loss=..., optimizer=...,
                       prologue=BatchPrologue(x=(image_normalize(),)))

The engine applies the prologue at the start of every train, eval and
predict step.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

# f32 channel stats in 0-255 scale (the JAX package's
# orca/data/image/imagenet.py constants)
IMAGENET_MEAN = (123.675, 116.28, 103.53)
IMAGENET_STD = (58.395, 57.12, 57.375)

__all__ = ["LeafOp", "BatchPrologue", "image_normalize", "rescale",
           "one_hot", "cast", "compose"]


class LeafOp:
    """One per-tensor prologue op: a device (torch) implementation used
    inside the step and a host (numpy) twin used as the reference float
    path. The two must be bit-identical on f32."""

    def __init__(self, device_fn: Callable, host_fn: Callable,
                 name: str = "leaf_op"):
        self._device = device_fn
        self._host = host_fn
        self.name = name

    def __call__(self, a):
        return self._device(a)

    def host(self, a: np.ndarray) -> np.ndarray:
        return self._host(a)

    def __repr__(self):
        return f"LeafOp({self.name})"


def image_normalize(mean: Sequence[float] = IMAGENET_MEAN,
                    std: Sequence[float] = IMAGENET_STD) -> LeafOp:
    """uint8 pixels → f32 ``(x - mean) * (1/std)`` per channel. The inverse
    std is precomputed in f32 so device and host multiply by the same
    bits."""
    mean_np = np.asarray(mean, np.float32)
    inv_np = (np.float32(1.0) / np.asarray(std, np.float32)).astype(
        np.float32)

    def dev(a):
        return (a.to(torch.float32) - torch.from_numpy(mean_np).to(a.device)) \
            * torch.from_numpy(inv_np).to(a.device)

    def host(a):
        return ((a.astype(np.float32) - mean_np) * inv_np).astype(np.float32)

    return LeafOp(dev, host, f"image_normalize(mean={tuple(mean)})")


def rescale(factor: float = 1.0 / 255.0) -> LeafOp:
    """uint8/int → f32 ``x * factor`` (e.g. the /255 pixel scaling)."""
    f = np.float32(factor)

    def dev(a):
        return a.to(torch.float32) * torch.tensor(f, device=a.device)

    def host(a):
        return (a.astype(np.float32) * f).astype(np.float32)

    return LeafOp(dev, host, f"rescale({factor})")


def one_hot(num_classes: int) -> LeafOp:
    """int labels → f32 one-hot rows (ships 4·k× fewer bytes than host-side
    one-hot for k classes; int32 wire vs f32 dense)."""

    def dev(a):
        # a negative or out-of-range label matches no class: a zero row
        classes = torch.arange(num_classes, device=a.device)
        return (a.long()[..., None] == classes).to(torch.float32)

    def host(a):
        # the JAX package's twin of jax.nn.one_hot: out-of-range and
        # negative labels produce an all-zero row (np.eye indexing would
        # raise or wrap)
        idx = np.asarray(a, np.int64)
        flat = idx.reshape(-1)
        out = np.zeros((flat.size, num_classes), np.float32)
        ok = (flat >= 0) & (flat < num_classes)
        out[np.nonzero(ok)[0], flat[ok]] = 1.0
        return out.reshape(idx.shape + (num_classes,))

    return LeafOp(dev, host, f"one_hot({num_classes})")


def cast(dtype) -> LeafOp:
    """Plain dtype cast (e.g. int labels that a loss wants as f32)."""

    target = torch.from_numpy(np.empty(0, np.dtype(dtype))).dtype

    def dev(a):
        return a.to(target)

    def host(a):
        return a.astype(np.dtype(dtype))

    return LeafOp(dev, host, f"cast({np.dtype(dtype).name})")


def compose(*ops: LeafOp) -> LeafOp:
    """Chain LeafOps left-to-right."""

    def dev(a):
        for op in ops:
            a = op(a)
        return a

    def host(a):
        for op in ops:
            a = op.host(a)
        return a

    return LeafOp(dev, host, "∘".join(op.name for op in ops))


def _as_ops(spec) -> Optional[Tuple[Optional[LeafOp], ...]]:
    if spec is None:
        return None
    if isinstance(spec, LeafOp):
        return (spec,)
    return tuple(spec)


class BatchPrologue:
    """Per-leaf prologue for one batch: ``x``/``y`` are tuples of
    :class:`LeafOp` (or None to pass a leaf through) aligned with the batch's
    feature/label tuples. A single LeafOp is treated as a 1-tuple. A spec
    shorter than the leaf tuple leaves the trailing leaves untouched; longer
    is an error (it would silently drop user intent).
    """

    def __init__(self, x=None, y=None):
        self.x_ops = _as_ops(x)
        self.y_ops = _as_ops(y)

    @staticmethod
    def _apply(ops, leaves, host: bool):
        if ops is None or leaves is None:
            return leaves
        if len(ops) > len(leaves):
            raise ValueError(
                f"prologue declares {len(ops)} ops for {len(leaves)} "
                "batch leaves")
        out = []
        for i, leaf in enumerate(leaves):
            op = ops[i] if i < len(ops) else None
            if op is None:
                out.append(leaf)
            else:
                out.append(op.host(leaf) if host else op(leaf))
        return tuple(out)

    # --- device side (run at the start of each step) -------------------------
    def apply_x(self, x):
        return self._apply(self.x_ops, x, host=False)

    def __call__(self, x, y):
        return self._apply(self.x_ops, x, host=False), \
            self._apply(self.y_ops, y, host=False)

    # --- host reference float path (tests, precomputation) -------------------
    def host_x(self, x):
        return self._apply(self.x_ops, x, host=True)

    def host(self, x, y):
        return self._apply(self.x_ops, x, host=True), \
            self._apply(self.y_ops, y, host=True)

    def __repr__(self):
        return f"BatchPrologue(x={self.x_ops}, y={self.y_ops})"
