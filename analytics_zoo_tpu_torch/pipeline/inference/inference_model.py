"""InferenceModel (counterpart of ``analytics_zoo_tpu/pipeline/inference/
inference_model.py``) on one device.

The JAX package keeps one set of weights on the mesh and a shape-bucketed
executable cache. PyTorch runs eagerly, so there is nothing to compile per
bucket; the buckets stay because they keep the shapes the kernels see to a
small fixed set (the CUDA kernels are built once, at the first bucket
``precompile`` warms), and because the serving scheduler sizes its batches
by them (``serving/scheduler.py``).

``predict`` pads the batch up to its bucket, copies it host -> device from
pinned memory without blocking, runs the module under
``torch.inference_mode()``, and slices the padding off.

Not ported yet: ``quantize``, hot reload, checkpoints, encrypted blobs, the
TF/torch-to-flax loaders and multi-GPU batch sharding.
"""

from __future__ import annotations

import logging
import math
import threading
from typing import Dict, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from ...common.context import resolve_device

logger = logging.getLogger("analytics_zoo_tpu_torch")


def _bucket(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1] * math.ceil(n / buckets[-1])


class InferenceModel:
    """Serves one ``nn.Module`` on one device: ``cuda`` unless the caller
    passes ``device="cpu"`` (raises when no GPU is present and the CPU was
    not asked for)."""

    DEFAULT_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256)

    def __init__(self, supported_concurrent_num: int = 1,
                 batch_buckets: Sequence[int] = DEFAULT_BUCKETS,
                 device: Union[None, str, torch.device] = None):
        # concurrency arg kept for API parity; the module is reentrant
        # under inference_mode, so workers share one copy of the weights
        self.concurrency = supported_concurrent_num
        self.device = resolve_device(device)
        self.buckets = tuple(sorted(set(int(b) for b in batch_buckets)))
        self._module: Optional[nn.Module] = None
        # warmed (bucket, signature) registry, read by the scheduler's
        # per-model stats
        self._cache: Dict[Tuple, bool] = {}
        self._lock = threading.Lock()

    @property
    def device_count(self) -> int:
        return 1

    @property
    def module(self) -> Optional[nn.Module]:
        return self._module

    # --- loaders ------------------------------------------------------------
    def load_module(self, module: nn.Module,
                    state_dict: Optional[Mapping[str, torch.Tensor]] = None
                    ) -> "InferenceModel":
        """Load a torch module (and optionally its weights), move it to
        the device and put it in eval mode (the torch-native twin of the
        JAX package's ``load_jax``)."""
        if state_dict is not None:
            module.load_state_dict(state_dict, strict=True)
        self._module = module.to(self.device).eval()
        self._cache.clear()
        return self

    # --- predict ------------------------------------------------------------
    def precompile(self, example, max_bucket: Optional[int] = None
                   ) -> "InferenceModel":
        """Run a zero-filled batch of every bucket size (up to the bucket
        ``max_bucket`` lands in) through ``predict``, so the kernels build
        and the allocator warms before the first request. ``example`` is a
        batch (leading dim = batch, any size) or a list of such arrays."""
        multi = isinstance(example, (list, tuple))
        xs = [np.asarray(a) for a in (example if multi else [example])]
        if max_bucket is None:
            targets = list(self.buckets)
        else:
            top = _bucket(max_bucket, self.buckets)
            targets = [b for b in self.buckets if b <= top]
            if top not in targets:
                targets.append(top)
        for b in targets:
            probe = [np.zeros((b,) + a.shape[1:], a.dtype) for a in xs]
            self.predict(probe if multi else probe[0])
        return self

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def predict(self, inputs):
        """Bucketed batch predict: numpy in, numpy out (a tuple/list of
        arrays for a module with several outputs)."""
        if self._module is None:
            raise RuntimeError("no model loaded")
        xs = inputs if isinstance(inputs, (list, tuple)) else [inputs]
        xs = [np.asarray(a) for a in xs]
        n = len(xs[0])
        b = _bucket(n, self.buckets)
        padded = [np.concatenate(
            [a, np.zeros((b - n,) + a.shape[1:], a.dtype)]) if b > n
            else a for a in xs]
        key = (b,) + tuple((a.shape[1:], str(a.dtype)) for a in padded)
        with self._lock:
            self._cache.setdefault(key, True)
        dev = [self._to_device(a) for a in padded]
        with torch.inference_mode():
            out = self._module(*dev)
        if isinstance(out, (list, tuple)):
            return type(out)(o.cpu().numpy()[:n] for o in out)
        return out.cpu().numpy()[:n]
