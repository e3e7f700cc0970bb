"""The training engine (counterpart of ``analytics_zoo_tpu/orca/learn/
engine.py``) on one device, with every plane off.

The JAX engine jits one XLA program per step over the device mesh. PyTorch
runs eagerly, so a step here is the module's forward, autograd's backward
(through the flash-attention kernels on the card), the gradient clipping
and the ``torch.optim`` update, in that order; the steps keep the JAX
engine's names and semantics:

* ``_train_step``: per-example loss, reduced as the weighted mean over the
  real rows of the batch (``w=None``: every row is real); clip; update.
  With a schedule (the optimizer factory's ``lr_at``) every param group's
  lr is set to ``lr_at(step)`` first, ``step`` counting the updates made
  before this one, as optax's ``scale_by_schedule`` counts them.
* ``_eval_step``: loss times the row count, and the metric states, so that
  ``evaluate`` sums them over batches.
* ``_predict_step``: the module in ``eval()`` mode.

The module's ``train()``/``eval()`` mode takes the place of the flax
``train`` argument, and its buffers (BatchNorm's running statistics)
that of the flax collections besides ``params``: a train step updates
them in the forward, ``get_state``/``set_state`` carry them with the
parameters, and the optimizer never sees them. ``build`` hands the
engine's ``torch.Generator`` once to every layer of the module that draws
random numbers in training (``DrawsRandom``: dropout, the Keras noise
layers, ``RReLU``, ``GaussianSampler``); each train step reseeds it from
``seed`` and the step, so a step's draws are a function of both, as
``fold_in(PRNGKey(seed), step)`` makes them in JAX (the two generators
give different bits). Parameters are initialised when the module is
constructed; ``build`` moves nothing and re-initialises nothing, so
weights a caller loaded (for example through ``interop``) are what
trains. A width that waits for the first input (a lazy parameter, as the
Keras layers' are) is materialised before ``build`` by
:meth:`TrainEngine.materialize`: one sample row through the module in
evaluation mode, as flax's init runs one, or by loading a state.

A ``prologue`` (``orca/learn/prologue.BatchPrologue``) runs at the start
of every train, eval and predict step, on the device. ``train_batch``
records each step's host dispatch time as the ``step`` stage of
``pipeline_stats`` when the estimator set one.

Not ported: scan fusion (``fuse`` is always 1), and the comms, sharding,
fsdp and compile-cache planes.
"""

from __future__ import annotations

import itertools
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
from torch import nn

from ...obs import trace as _trace
from ...pipeline.api.keras.layers.self_attention import DrawsRandom
from .metrics import Metric
from .utils import Batch

_SEED_MIX = 0x9E3779B97F4A7C15      # odd 64-bit constant: seed and step mix


def has_lazy_params(module: nn.Module) -> bool:
    """Whether ``module`` still holds a parameter or buffer whose shape
    waits for the first input."""
    from torch.nn.parameter import is_lazy
    return any(is_lazy(t) for t in itertools.chain(module.parameters(),
                                                   module.buffers()))


class TrainEngine:
    """Owns the module, its optimizer and the train/eval/predict steps.

    module : ``nn.Module`` already on ``device``
    optimizer : factory ``params -> torch.optim.Optimizer``
    loss_fn : ``(y_true, y_pred) -> per-example loss`` (or None: the model
        returns its loss)
    metrics : dict name -> Metric
    """

    def __init__(self, module: nn.Module,
                 optimizer: Callable[..., torch.optim.Optimizer],
                 loss_fn: Optional[Callable], metrics: Dict[str, Metric],
                 device: torch.device, seed: int = 0, prologue=None):
        self.module = module
        self.make_optimizer = optimizer
        self.lr_at = getattr(optimizer, "lr_at", None)
        self.loss_fn = loss_fn
        self.metrics = metrics
        self.device = device
        self.seed = seed
        self.prologue = prologue
        self.pipeline_stats = None      # the estimator's PipelineStats
        self.opt: Optional[torch.optim.Optimizer] = None
        self.step = 0
        self._gen = torch.Generator(device=device)
        self._clip_norm: Optional[float] = None
        self._clip_min: Optional[float] = None
        self._clip_max: Optional[float] = None

    # --- gradient clipping --------------------------------------------------
    _KEEP = object()                    # "leave this clip setting as-is"

    def set_gradient_clipping(self, *, norm=_KEEP, min_value=_KEEP,
                              max_value=_KEEP):
        """Update clip settings; unspecified kwargs keep their value."""
        if norm is not TrainEngine._KEEP:
            self._clip_norm = norm
        if min_value is not TrainEngine._KEEP:
            self._clip_min = min_value
        if max_value is not TrainEngine._KEEP:
            self._clip_max = max_value

    def clear_gradient_clipping(self):
        self.set_gradient_clipping(norm=None, min_value=None, max_value=None)

    def _clip_grads(self, grads):
        """Global-norm clipping (scale by min(1, clip / max(norm, 1e-12))),
        then clipping by value, in place."""
        if self._clip_norm is not None:
            gnorm = torch.linalg.vector_norm(
                torch.stack([torch.linalg.vector_norm(g) for g in grads]))
            scale = torch.clamp(self._clip_norm / gnorm.clamp_min(1e-12),
                                max=1.0)
            for g in grads:
                g.mul_(scale)
        if self._clip_min is not None or self._clip_max is not None:
            for g in grads:
                g.clamp_(self._clip_min, self._clip_max)

    # --- init ---------------------------------------------------------------
    def materialize(self, batch: Optional[Batch] = None,
                    state_dict: Optional[Dict[str, Any]] = None):
        """Give every lazy width of the module its size, from a state dict
        (loaded) or else from the first row of ``batch`` (run through the
        module in evaluation mode, without gradients); a module without
        lazy parameters is left untouched."""
        if not has_lazy_params(self.module):
            return
        if state_dict is not None:
            self.module.load_state_dict(_as_tensors(state_dict), strict=True)
        elif batch is not None:
            b = Batch(x=tuple(a[:1] for a in batch.x), y=None,
                      w=None).to(self.device)
            was_training = self.module.training
            with torch.no_grad():
                self._apply(self._pre_x(b.x), False)
            self.module.train(was_training)

    def build(self):
        """Create the optimizer over the module's parameters and point
        every layer that draws random numbers at the engine's generator
        (once)."""
        if self.opt is not None:
            return
        if has_lazy_params(self.module):
            raise RuntimeError("the module has parameters whose width comes "
                               "from the first input; fit, or load a "
                               "state, before building the optimizer")
        self.opt = self.make_optimizer(list(self.module.parameters()))
        for m in self.module.modules():
            if isinstance(m, DrawsRandom):
                m.generator = self._gen
        self.step = 0

    # --- model application --------------------------------------------------
    def _pre(self, x, y):
        """The prologue (a no-op without one)."""
        if self.prologue is None:
            return x, y
        return self.prologue(x, y)

    def _pre_x(self, x):
        return x if self.prologue is None else self.prologue.apply_x(x)

    def _apply(self, x, train: bool):
        self.module.train(train)
        return self.module(*x)

    def _compute_loss(self, y, preds, w):
        if self.loss_fn is None:
            per_ex = preds              # the model returned its loss
        else:
            y0 = y[0] if (isinstance(y, tuple) and len(y) == 1) else y
            per_ex = self.loss_fn(y0, preds)
        per_ex = per_ex.reshape(per_ex.shape[0], -1).mean(-1)
        if w is None:                   # full batch: every row is real
            return per_ex.mean()
        return (per_ex * w).sum() / w.sum().clamp_min(1e-8)

    # --- steps --------------------------------------------------------------
    def _train_step(self, x, y, w) -> torch.Tensor:
        self._gen.manual_seed((self.seed * _SEED_MIX + self.step)
                              & 0x7FFFFFFFFFFFFFFF)
        self.opt.zero_grad(set_to_none=True)
        x, y = self._pre(x, y)
        preds = self._apply(x, True)
        loss = self._compute_loss(y, preds, w)
        loss.backward()
        grads = [p.grad for p in self.module.parameters()
                 if p.grad is not None]
        self._clip_grads(grads)
        if self.lr_at is not None:
            lr = self.lr_at(self.step)
            for group in self.opt.param_groups:
                group["lr"] = lr
        self.opt.step()
        return loss.detach()

    def _eval_step(self, metric_states, x, y, w):
        with torch.no_grad():
            x, y = self._pre(x, y)
            preds = self._apply(x, False)
            loss = (self._compute_loss(y, preds, w)
                    if (y is not None or self.loss_fn is None)
                    else torch.zeros((), device=self.device))
            y0 = None
            if y is not None:
                y0 = y[0] if (isinstance(y, tuple) and len(y) == 1) else y
            if w is None:
                w = torch.ones(x[0].shape[0], device=self.device)
            new_states = {name: m.update(metric_states[name], y0, preds, w)
                          for name, m in self.metrics.items()}
            count = w.sum()
        return new_states, loss * count, count

    def _predict_step(self, x):
        with torch.no_grad():
            return self._apply(self._pre_x(x), False)

    # --- public API ---------------------------------------------------------
    def train_batch(self, batch: Batch) -> torch.Tensor:
        """One optimizer step on a host batch; returns the loss as a device
        scalar (read it after the epoch, so the host keeps issuing)."""
        t0 = time.perf_counter()
        # obs span (one flag check disarmed): the step-indexed segment the
        # Perfetto timeline renders
        with _trace.span("engine.dispatch", step=self.step):
            b = batch.to(self.device)
            loss = self._train_step(b.x, b.y, b.w)
        self.step += 1
        if self.pipeline_stats is not None:
            self.pipeline_stats.add("step", time.perf_counter() - t0)
        return loss

    def init_metric_states(self):
        return {name: m.init_state(self.device)
                for name, m in self.metrics.items()}

    def eval_batch(self, metric_states, batch: Batch):
        b = batch.to(self.device)
        return self._eval_step(metric_states, b.x, b.y, b.w)

    def finalize_metrics(self, metric_states, loss_sum, count
                         ) -> Dict[str, float]:
        out = {name: float(m.compute(metric_states[name]))
               for name, m in self.metrics.items()}
        out["loss"] = float(loss_sum / max(count, 1e-8))
        out["num_samples"] = int(count)
        return out

    def predict_batch(self, x):
        return self._predict_step(Batch(x=x, y=None, w=None)
                                  .to(self.device).x)

    # --- state access -------------------------------------------------------
    def get_state(self) -> Dict[str, Any]:
        """Module state (parameters and buffers), optimizer state, step and
        the parameters' names in the optimizer's order, as CPU tensors."""
        def cpu(obj):
            if isinstance(obj, torch.Tensor):
                return obj.detach().cpu().clone()
            if isinstance(obj, dict):
                return {k: cpu(v) for k, v in obj.items()}
            if isinstance(obj, (list, tuple)):
                return type(obj)(cpu(v) for v in obj)
            return obj

        return {"params": cpu(self.module.state_dict()),
                "opt_state": (cpu(self.opt.state_dict())
                              if self.opt is not None else None),
                "step": self.step,
                "param_names": [n for n, _ in
                                self.module.named_parameters()]}

    def set_state(self, state: Dict[str, Any]):
        """Adopt a copy of a state of :meth:`get_state`'s form; numpy leaves
        (as a checkpoint reads them back) become tensors first. The
        optimizer's ``load_state_dict`` keeps tensors already on its device,
        so the copy keeps training from writing into the caller's state (a
        scheduler may resume from it again)."""
        state = _as_tensors(state)
        self.module.load_state_dict(state["params"], strict=True)
        if state.get("opt_state") is not None:
            self.build()
            self.opt.load_state_dict(_cloned(state["opt_state"]))
        self.step = int(state["step"])


def _cloned(obj):
    if isinstance(obj, torch.Tensor):
        return obj.clone()
    if isinstance(obj, dict):
        return {k: _cloned(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_cloned(v) for v in obj]
    return obj


def _as_tensors(obj):
    if isinstance(obj, np.ndarray):
        return torch.from_numpy(np.array(obj))
    if isinstance(obj, dict):
        return {k: _as_tensors(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_as_tensors(v) for v in obj]
    return obj
