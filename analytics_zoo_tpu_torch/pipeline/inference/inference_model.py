"""InferenceModel (counterpart of ``analytics_zoo_tpu/pipeline/inference/
inference_model.py``) on one device.

The JAX package keeps one set of weights on the mesh and a shape-bucketed
executable cache. PyTorch runs eagerly, so there is nothing to compile per
bucket; the buckets stay because they keep the shapes the kernels see to a
small fixed set (the CUDA kernels are built once, at the first bucket
``precompile`` warms), and because the serving scheduler sizes its batches
by them (``serving/scheduler.py``).

``predict`` pads the batch up to its bucket, copies it host -> device from
pinned memory without blocking, runs the prologue (when one is set) and
the module under ``torch.inference_mode()``, and slices the padding off.

Besides ``load_module``: an on-device input prologue (``set_prologue``),
weight-only int8 quantization (``quantize``), whole-model files
(``save``/``load``, and ``save_encrypted``/``load_encrypted`` sealed by
``utils/crypto``), checkpoint-plane checkpoints (``save_checkpoint``/
``load_checkpoint``) and hot reload from a watched checkpoint root
(``enable_hot_reload``, counters in ``ckpt_stats``). ``load_torch``
serves a user's ``nn.Module`` as it is, ``distributed_predict`` predicts
over XShards, and ``transfer_stats`` counts the bytes and seconds of
every host -> device copy of ``predict``.

Saved state is plain values: the module's ``state_dict`` as CPU tensors
and, for a module of this package with ``config`` and ``from_config``
(the detector's servable), its class path and config, from which
``load`` rebuilds it (files are read with
``torch.load(weights_only=True)``). A checkpoint the JAX package wrote (a
flax tree, an estimator state) is adopted through ``interop``; the flax
module a JAX serving checkpoint pickles is never run (the checkpoint
reader turns it into a stand-in), so adopting it needs a module loaded
first, as the JAX package needs one for an estimator checkpoint.

Not ported yet: the TF loaders (ROADMAP A9) and multi-GPU batch sharding
(A10).
"""

from __future__ import annotations

import copy
import importlib
import io
import logging
import math
import os
import threading
import time
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from ...common.context import resolve_device
from ...native.infeed import PipelineStats

logger = logging.getLogger("analytics_zoo_tpu_torch")

_PKG = "analytics_zoo_tpu_torch."


def _bucket(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1] * math.ceil(n / buckets[-1])


# --- module specs: plain values that rebuild a module of this package --------
def module_spec(module) -> Optional[Dict[str, Any]]:
    """``{"class": "module:qualname", "config": {...}}`` for a module of
    this package whose class rebuilds it with ``from_config(config)``,
    else None."""
    cls = type(module)
    if not (cls.__module__.startswith(_PKG)
            and hasattr(cls, "from_config")):
        return None
    return {"class": f"{cls.__module__}:{cls.__qualname__}",
            "config": module.config}


def build_module(spec) -> Optional[nn.Module]:
    """The module a :func:`module_spec` describes; None for anything else,
    a JAX checkpoint's stand-in for its flax module included."""
    if not (isinstance(spec, dict) and isinstance(spec.get("class"), str)
            and spec["class"].startswith(_PKG)):
        return None
    mod_name, _, qual = spec["class"].partition(":")
    cls = importlib.import_module(mod_name)
    for part in qual.split("."):
        cls = getattr(cls, part)
    return cls.from_config(spec["config"])


# --- weight-only int8 --------------------------------------------------------
def _quantize_array(arr: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """The JAX package's symmetric per-output-channel int8 of one f32 leaf,
    on a torch weight whose output channel is axis 0 (a flax kernel's is
    its last axis): the same numpy arithmetic, so the same bytes."""
    scale = np.abs(arr).max(axis=tuple(range(1, arr.ndim)),
                            keepdims=True) / 127.0
    scale = np.where(scale == 0, 1.0, scale).astype(np.float32)
    q = np.clip(np.round(arr / scale), -127, 127).astype(np.int8)
    return q, scale


def _dequantize_hook(module: nn.Module, _args):
    for name in module._int8_weights:
        # a plain tensor attribute, read by the module's forward as it read
        # the parameter it replaces
        setattr(module, name, getattr(module, name + "_int8").to(
            torch.float32) * getattr(module, name + "_scale"))


def quantize_module(module: nn.Module, min_elements: int = 4096) -> int:
    """Replace every float parameter with at least ``min_elements`` entries
    and two or more axes by an int8 buffer ``<name>_int8`` and its f32
    scale ``<name>_scale``, dequantized by a forward pre-hook before each
    call. Returns the number of tensors quantized."""
    n = 0
    for mod in list(module.modules()):
        names = []
        for name, p in list(mod.named_parameters(recurse=False)):
            if (not p.is_floating_point() or p.numel() < min_elements
                    or p.dim() < 2):
                continue
            q, scale = _quantize_array(p.detach().float().cpu().numpy())
            del mod._parameters[name]
            mod.register_buffer(name + "_int8",
                                torch.from_numpy(q).to(p.device))
            mod.register_buffer(name + "_scale",
                                torch.from_numpy(scale).to(p.device))
            names.append(name)
        if names:
            mod._int8_weights = tuple(names)
            mod.register_forward_pre_hook(_dequantize_hook)
            _dequantize_hook(mod, ())
            n += len(names)
    return n


def _is_flat(tree: Mapping) -> bool:
    return not any(isinstance(v, Mapping) for v in tree.values())


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
        # on-device input prologue (orca/learn/prologue.BatchPrologue)
        self._prologue = None
        # warmed (bucket, signature) registry, read by the scheduler's
        # per-model stats
        self._cache: Dict[Tuple, bool] = {}
        self._lock = threading.Lock()
        # hot reload (enable_hot_reload): the watcher and the counters
        # ckpt_stats() and the serving metrics()["ckpt"] read
        self._watcher = None
        self._loaded_step: Optional[int] = None
        self._ckpt_counters: Dict = {"hot_reloads": 0, "full_reloads": 0,
                                     "reload_skips": 0,
                                     "last_reload_step": None}
        # serving-ingress transfers (predict's host -> device copies)
        self._tstats = PipelineStats()

    @property
    def device_count(self) -> int:
        return 1

    @property
    def module(self) -> Optional[nn.Module]:
        return self._module

    def transfer_stats(self) -> Dict:
        """Serving-ingress transfer counters (h2d seconds/bytes/MB/s) of
        ``predict``'s host -> device copies; the serving engine's
        ``metrics()`` shows them as ``"transfer"``."""
        return self._tstats.snapshot()

    def set_prologue(self, prologue) -> "InferenceModel":
        """Run an on-device input prologue (cast + normalize + ...) before
        the module, so clients enqueue narrow source dtypes (uint8 images,
        int32 ids) and the cast happens after the wire. Accepts a
        :class:`~analytics_zoo_tpu_torch.orca.learn.prologue.BatchPrologue`
        or a LeafOp / tuple of LeafOps for the positional inputs. ``None``
        clears it."""
        from ...orca.learn.prologue import BatchPrologue
        if prologue is not None and not isinstance(prologue, BatchPrologue):
            prologue = BatchPrologue(x=prologue)
        self._prologue = prologue
        self._cache.clear()
        return self

    # --- loaders ------------------------------------------------------------
    def load_module(self, module: nn.Module,
                    state_dict: Optional[Mapping[str, torch.Tensor]] = None
                    ) -> "InferenceModel":
        """Load a torch module (and optionally its weights), move it to
        the device and put it in eval mode (the torch-native twin of the
        JAX package's ``load_jax``)."""
        if state_dict is not None:
            module.load_state_dict(_tensors(state_dict), strict=True)
        self._module = module.to(self.device).eval()
        self._cache.clear()
        return self

    def load_torch(self, torch_module: nn.Module) -> "InferenceModel":
        """Serve a user's torch module as it is, on this model's device
        (the JAX package converts it to flax; here it needs no
        conversion)."""
        return self.load_module(torch_module)

    # --- int8 weight quantization -------------------------------------------
    def quantize(self, min_elements: int = 4096) -> "InferenceModel":
        """Weight-only int8 quantization (the reference's local int8
        quantization, ~4x model-size reduction): float weights with at
        least ``min_elements`` entries are stored as int8 with a symmetric
        per-output-channel scale and dequantized on the device before each
        forward (:func:`quantize_module`). The quantized module is a copy:
        the module given to ``load_module`` keeps its weights."""
        if self._module is None:
            raise RuntimeError("no model loaded")
        module = copy.deepcopy(self._module)
        n = quantize_module(module, min_elements)
        self._module = module
        self._cache.clear()
        logger.info("quantized %d weight tensors to int8", n)
        return self

    # --- whole-model files --------------------------------------------------
    def _state_doc(self, module=None) -> dict:
        """The serving document: the served module's state as CPU tensors
        and the spec that rebuilds it (``module``, when given, supplies
        the spec; the JAX package's signature passes the module)."""
        if self._module is None:
            raise RuntimeError("no model loaded")
        return {"module": module_spec(module if module is not None
                                      else self._module),
                "state": {"params": {k: v.detach().cpu().clone()
                                     for k, v in
                                     self._module.state_dict().items()},
                          "extra_vars": {}}}

    def _dump_blob(self, module=None) -> bytes:
        buf = io.BytesIO()
        torch.save(self._state_doc(module), buf)
        return buf.getvalue()

    def _load_blob(self, raw: bytes) -> "InferenceModel":
        doc = torch.load(io.BytesIO(raw), map_location="cpu",
                         weights_only=True)
        return self._adopt_doc(doc, path="<blob>")

    def save(self, module, path: str):
        """Write the served model to ``path`` (``torch.save`` of plain
        values). ``module`` may be None: the loaded one."""
        with open(path, "wb") as f:
            f.write(self._dump_blob(module))

    def load(self, model_path: str, weight_path: Optional[str] = None
             ) -> "InferenceModel":
        """Load a :meth:`save` file or a checkpoint-plane directory or root
        (the latter through :meth:`load_checkpoint`)."""
        if os.path.isdir(model_path):
            return self.load_checkpoint(model_path)
        with open(model_path, "rb") as f:
            return self._load_blob(f.read())

    def save_encrypted(self, module, path: str, passphrase: str):
        """Encrypted model at rest (the reference's encrypted-model
        serving): the :meth:`save` bytes sealed with authenticated
        encryption (``utils/crypto``: PBKDF2 key derivation, HMAC-CTR
        stream cipher, encrypt-then-MAC)."""
        from ...utils.crypto import encrypt_bytes
        with open(path, "wb") as f:
            f.write(encrypt_bytes(self._dump_blob(module), passphrase))

    def load_encrypted(self, path: str, passphrase: str) -> "InferenceModel":
        """Load a :meth:`save_encrypted` file. The integrity tag is checked
        before anything is deserialized, so a tampered file or a wrong key
        raises without reading attacker-controlled bytes."""
        from ...utils.crypto import decrypt_bytes
        with open(path, "rb") as f:
            return self._load_blob(decrypt_bytes(f.read(), passphrase))

    # --- state adoption ------------------------------------------------------
    @staticmethod
    def _state_to_variables(state) -> Tuple[Dict, Any]:
        """Checkpoint state -> (variables, module spec or None). Accepts
        serving documents (``{"module", "state": {params, extra_vars}}``,
        of either package) and raw estimator states (``{params,
        extra_vars, opt_state, ...}`` of the JAX package, ``{params,
        opt_state, step, ...}`` of this one)."""
        inner = state.get("state", state)
        variables = {"params": inner["params"],
                     **(inner.get("extra_vars") or {})}
        return variables, state.get("module")

    @staticmethod
    def _state_dict_of(variables: Mapping) -> Dict[str, Any]:
        """``variables`` as a ``state_dict``: a flat state dict as it is,
        a flax tree (``params`` with ``batch_stats``) through
        ``interop``."""
        from ... import interop
        if _is_flat(variables["params"]):
            return dict(variables["params"])
        return interop.flax_to_state_dict(
            {k: v for k, v in variables.items()
             if k in ("params", "batch_stats")})

    def _adopt_doc(self, state, path: str) -> "InferenceModel":
        variables, spec = self._state_to_variables(state)
        module = build_module(spec)
        if module is None:
            if self._module is None:
                raise ValueError(
                    f"{path}: the checkpoint carries no module of this "
                    "package; load one first (load_module) for weights-only "
                    "adoption")
            self._module = self._with_state(self._module, variables)
            self._cache.clear()
            return self
        return self.load_module(module,
                                self._state_dict_of(variables))

    def _with_state(self, module: nn.Module, variables) -> nn.Module:
        """A copy of ``module`` holding ``variables`` (the live module is
        never written in place: a batch in flight finishes on the weights
        it started with)."""
        new = copy.deepcopy(module)
        new.load_state_dict(_tensors(self._state_dict_of(variables)),
                            strict=True)
        return new.eval()

    # --- checkpoint plane (manifest + content-addressed blobs) --------------
    def save_checkpoint(self, module, root: str, step: int = 0,
                        passphrase: Optional[str] = None) -> str:
        """Write a committed checkpoint-plane checkpoint (atomic, per-leaf
        content-addressed, optionally encrypted at rest) under ``root`` —
        the producer side of :meth:`enable_hot_reload`."""
        from ...ckpt import CheckpointPlane
        plane = CheckpointPlane(root, passphrase=passphrase,
                                async_save=False)
        return plane.save(self._state_doc(module), step, blocking=True)

    def load_checkpoint(self, root: str, step: Optional[int] = None,
                        passphrase: Optional[str] = None
                        ) -> "InferenceModel":
        """Load from a checkpoint-plane root (newest committed checkpoint;
        uncommitted/corrupt dirs are skipped) or a single checkpoint dir,
        of either package. Checkpoints without a module of this package
        (estimator checkpoints, the JAX package's serving checkpoints) need
        a module loaded first: their weights are adopted into it."""
        from ...ckpt import (CheckpointPlane, is_plane_dir,
                             load_checkpoint_dir, parse_step)
        if is_plane_dir(root) or os.path.exists(
                os.path.join(root, "state.pkl")):
            path = root                                     # one ckpt dir
            state = load_checkpoint_dir(root, passphrase)
        else:
            path, state = CheckpointPlane(
                root, passphrase=passphrase).restore(step=step)
        self._loaded_step = parse_step(os.path.basename(path))
        return self._adopt_doc(state, path)

    # --- serving hot-reload -------------------------------------------------
    def enable_hot_reload(self, root: str, poll_s: float = 2.0,
                          passphrase: Optional[str] = None,
                          start_at: Optional[int] = None):
        """Watch ``root`` for newly COMMITTED checkpoints and swap the
        weights into the live model. A state of the served module's
        structure swaps in as a new copy of the module (in-flight batches
        finish on the old weights, the next predict uses the new ones); a
        structure mismatch falls back to a full reload when the checkpoint
        carries a module of this package, else it is skipped. Returns the
        :class:`~analytics_zoo_tpu_torch.ckpt.CheckpointWatcher`
        (``poll_now()`` forces a synchronous check). ``start_at`` skips
        steps <= it; the default is the step ``load_checkpoint`` loaded
        this model from."""
        from ...ckpt import CheckpointWatcher
        self.disable_hot_reload()
        if start_at is None:
            start_at = self._loaded_step
        self._watcher = CheckpointWatcher(
            root, self._hot_swap, poll_s=poll_s, passphrase=passphrase,
            start_at=start_at)
        self._watcher.start()
        return self._watcher

    def disable_hot_reload(self):
        if self._watcher is not None:
            self._watcher.stop()
            self._watcher = None

    def apply_checkpoint(self, path: str, state, step: int):
        """Adopt an already-loaded checkpoint state into the live model —
        the public form of the hot-reload callback, for consumers that
        run their own CheckpointWatcher."""
        return self._hot_swap(path, state, step)

    def _hot_swap(self, path: str, state, step: int):
        variables, spec = self._state_to_variables(state)
        live = self._module
        same = False
        if live is not None:
            sd = self._state_dict_of(variables)
            own = live.state_dict()
            same = set(sd) == set(own) and all(
                tuple(np.shape(sd[k])) == tuple(own[k].shape)
                and _dtype_name(sd[k]) == _dtype_name(own[k]) for k in own)
        module = None if same else build_module(spec)
        if same:
            self._module = self._with_state(live, variables)
        elif module is not None:
            self.load_module(module, self._state_dict_of(variables))
            self._ckpt_counters["full_reloads"] += 1
        else:
            self._ckpt_counters["reload_skips"] += 1
            logger.warning("hot-reload skipped: %s does not match the "
                           "served model's structure and carries no "
                           "module", path)
            return
        self._ckpt_counters["hot_reloads"] += 1
        self._ckpt_counters["last_reload_step"] = int(step)
        self._loaded_step = int(step)
        logger.info("hot-reloaded weights from %s (step %d%s)", path, step,
                    "" if same else ", structure changed")

    def ckpt_stats(self) -> Dict:
        """Hot-reload counters for the serving metrics surface (empty until
        the first reload attempt, so metrics() can omit the section)."""
        return {k: v for k, v in self._ckpt_counters.items()
                if v is not None} if any(
            v for v in self._ckpt_counters.values()) else {}

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
        t0 = time.perf_counter()
        a = np.ascontiguousarray(arr)
        t = torch.from_numpy(a)
        if self.device.type == "cuda":
            t = t.pin_memory().to(self.device, non_blocking=True)
        else:
            t = t.to(self.device)
        self._tstats.add("h2d", time.perf_counter() - t0, nbytes=a.nbytes)
        return t

    def predict(self, inputs):
        """Bucketed batch predict: numpy in, numpy out (a tuple/list of
        arrays for a module with several outputs)."""
        module = self._module
        if module is None:
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
            if self._prologue is not None:
                dev = list(self._prologue.apply_x(tuple(dev)))
            out = module(*dev)
        if isinstance(out, (list, tuple)):
            return type(out)(o.cpu().numpy()[:n] for o in out)
        return out.cpu().numpy()[:n]

    def distributed_predict(self, shards, batch_size: int = 64):
        """Predict over XShards (reference: PythonOrca.
        inferenceModelDistriPredict): each partition's features through
        :meth:`predict`, returned as XShards of ``{"prediction": ...}``."""
        from ...orca.learn.utils import xshards_from_arrays
        norm = xshards_from_arrays(shards)

        def run(part):
            return {"prediction": self.predict(list(part["x"]))}

        return norm.transform_shard(run)


def _dtype_name(a) -> str:
    if isinstance(a, torch.Tensor):
        return str(a.dtype).replace("torch.", "")
    return np.asarray(a).dtype.name


def _tensors(sd: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    return {k: v if isinstance(v, torch.Tensor)
            else torch.from_numpy(np.array(v)) for k, v in sd.items()}
