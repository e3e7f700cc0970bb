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
``pipeline_stats`` when the estimator set one. Each train dispatch
fires the ``engine.dispatch`` fault site inside a section of the active
dispatch watchdog (``resilience/watchdog.py``), as the JAX engine does.

**Fused groups** (the JAX engine's ``lax.scan`` of k steps):
``train_batch_group`` and ``eval_batch_group`` take a stacked superbatch
(leaves ``(k, batch, ...)``) and run its k steps, each exactly as
``train_batch``/``eval_batch`` would, returning the per-step losses
``(k,)``. On the CPU the group is k eager steps in a loop. On the card it
is one replay of a CUDA graph (``graphs.py``), captured once per
signature (k, the leaves' shapes and dtypes, the clip settings; a new
optimizer from ``build`` drops every graph): the first group of a signature runs its k steps eagerly on
the engine's side stream (the warm-up: optimizer state, kernel builds and
library handles come into being, and these are the group's real steps),
then the graph is captured on that stream, and every later group copies
its superbatch into the graph's static inputs and replays. What makes the
graph replay what the eager steps compute:

* the lr is a device tensor per param group (the card's optimizers are
  built capturable, ``optimizers_impl.py``), written from ``lr_at`` before
  an eager step and copied from a per-replay ``(k,)`` table inside the
  graph;
* step slot i of a graph draws from its own generator, registered with
  the graph and seeded before each replay as the eager step would seed
  the engine's generator;
* the optimizer state and parameters keep their storage: ``set_state``
  and ``restore_snapshot`` replace the optimizer's state tensors and so
  drop the captured graphs.

:meth:`TrainEngine.graph_gate` says, before anything is captured, why a
module cannot be (an optimizer built without ``capturable``, a schedule
over a float lr, a random layer on a torch without graph-safe
generators, an optimizer that names its own ``graph_refusal``, as
gradient accumulation's ``MultiSteps`` does): the estimator then runs it
unfused, logs the reason and puts it in each epoch's stats
(``unfused_reason``), and
a group handed to the engine on the card anyway raises before it
captures.

Not ported: the comms, sharding, fsdp and compile-cache planes.
"""

from __future__ import annotations

import itertools
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils import _pytree as pytree

from ...obs import trace as _trace
from ...pipeline.api.keras.layers.self_attention import DrawsRandom
from ...resilience import faults as _faults
from ...resilience import watchdog as _watchdog
from . import graphs
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
        self._random_layers: List[nn.Module] = []
        self._clip_norm: Optional[float] = None
        self._clip_min: Optional[float] = None
        self._clip_max: Optional[float] = None
        self._clip_chain: Tuple[Tuple, ...] = ()
        self._graphs: Dict[Any, graphs.StepGraph] = {}
        self._graph_stream = None       # side stream: warm-up and capture

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

    def set_clip_chain(self, chain):
        """Clippings applied in the given order before the settings above,
        as an optax chain of them would: each ``("norm", c)`` or
        ``("value", lo, hi)``; ``()`` for none."""
        self._clip_chain = tuple(tuple(c) for c in chain)

    @staticmethod
    def _clip_norm_(grads, clip):
        """Scale by min(1, clip / max(norm, 1e-12)), in place."""
        gnorm = torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(g) for g in grads]))
        scale = torch.clamp(clip / gnorm.clamp_min(1e-12), max=1.0)
        for g in grads:
            g.mul_(scale)

    def _clip_grads(self, grads):
        """The clip chain in its order, then global-norm clipping, then
        clipping by value, in place."""
        for kind, *args in self._clip_chain:
            if kind == "norm":
                self._clip_norm_(grads, args[0])
            else:
                for g in grads:
                    g.clamp_(*args)
        if self._clip_norm is not None:
            self._clip_norm_(grads, self._clip_norm)
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
        # graphs captured over an earlier optimizer (its state and lr
        # tensors) must never replay over this one
        self.release_graphs()
        self.opt = self.make_optimizer(list(self.module.parameters()))
        self._random_layers = [m for m in self.module.modules()
                               if isinstance(m, DrawsRandom)]
        self._set_generator(self._gen)
        self.step = 0

    def _set_generator(self, gen: torch.Generator):
        for m in self._random_layers:
            m.generator = gen

    def _step_seed(self, step: int) -> int:
        return (self.seed * _SEED_MIX + step) & 0x7FFFFFFFFFFFFFFF

    def _lr_tensors(self) -> Optional[List[torch.Tensor]]:
        """The param groups' lr tensors (the card's optimizers), or None
        when some group holds a float lr."""
        lrs = [g["lr"] for g in self.opt.param_groups]
        return lrs if all(isinstance(v, torch.Tensor) for v in lrs) else None

    def _set_lr(self, lr: float):
        """Every param group's lr for the next update: written into the
        group's lr tensor (an eager fill, no host sync), or set as a
        float."""
        for group in self.opt.param_groups:
            if isinstance(group["lr"], torch.Tensor):
                group["lr"].fill_(lr)
            else:
                group["lr"] = lr

    def graph_gate(self, training: bool = True) -> Optional[str]:
        """Why this engine's fused groups cannot be CUDA graphs on its
        device, or None when they can (always None off the card, where a
        group is k eager steps). Decided from the module and optimizer
        alone, before anything is captured; ``training=False`` asks for
        evaluation's groups, which never step the optimizer, so only the
        module is consulted."""
        if self.device.type != "cuda":
            return None
        if not training:
            return self._module_gate()
        self.build()
        refusal = getattr(self.opt, "graph_refusal", None)
        if refusal:
            return refusal
        for group in self.opt.param_groups:
            if group.get("capturable") is False:
                return (f"{type(self.opt).__name__} was built without "
                        "capturable=True")
        if self.lr_at is not None and self._lr_tensors() is None:
            return "an lr schedule over a float lr"
        return self._module_gate()

    def _module_gate(self) -> Optional[str]:
        self.build()
        if self._random_layers and not graphs.generators_supported():
            return ("a layer draws random numbers and this torch cannot "
                    "register a generator with a CUDA graph")
        return None

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
    def _update(self, x, y, w) -> torch.Tensor:
        """Forward, backward, clip and the optimizer's update: one train
        step without its seeding and lr (the part a graph captures)."""
        self.opt.zero_grad(set_to_none=True)
        x, y = self._pre(x, y)
        preds = self._apply(x, True)
        loss = self._compute_loss(y, preds, w)
        loss.backward()
        grads = [p.grad for p in self.module.parameters()
                 if p.grad is not None]
        self._clip_grads(grads)
        self.opt.step()
        return loss.detach()

    def _train_step(self, x, y, w) -> torch.Tensor:
        self._gen.manual_seed(self._step_seed(self.step))
        if self.lr_at is not None:
            self._set_lr(self.lr_at(self.step))
        return self._update(x, y, w)

    def _train_multi_step(self, xs, ys) -> torch.Tensor:
        """k eager train steps over a stacked superbatch (leaves ``(k,
        batch, ...)``, every row real), each exactly ``_train_step``;
        counts ``step`` as it goes. Returns the losses ``(k,)``."""
        losses = []
        for i in range(xs[0].shape[0]):
            losses.append(self._train_step(
                tuple(a[i] for a in xs),
                tuple(a[i] for a in ys) if ys is not None else None, None))
            self.step += 1
        return torch.stack(losses)

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

    def _eval_multi_step(self, metric_states, xs, ys):
        """k eval steps over a stacked superbatch, chaining the metric
        states; returns the states and the per-step loss sums and counts
        ``(k,)`` (summed by the caller with the unfused steps', in step
        order)."""
        losses, counts = [], []
        for i in range(xs[0].shape[0]):
            metric_states, loss, n = self._eval_step(
                metric_states, tuple(a[i] for a in xs),
                tuple(a[i] for a in ys) if ys is not None else None, None)
            losses.append(loss)
            counts.append(n)
        return metric_states, torch.stack(losses), torch.stack(counts)

    def _predict_step(self, x):
        with torch.no_grad():
            return self._apply(self._pre_x(x), False)

    # --- CUDA graphs of fused groups ---------------------------------------
    def _signature(self, kind: str, batch: Batch, extra=()):
        return (kind, batch.fused, tuple(
            (tuple(t.shape), t.dtype) for t in batch.leaves()),
            self._clip_norm, self._clip_min, self._clip_max,
            self._clip_chain) + tuple(extra)

    def _side_stream(self):
        if self._graph_stream is None:
            self._graph_stream = torch.cuda.Stream(self.device)
        self._graph_stream.wait_stream(torch.cuda.current_stream(self.device))
        return self._graph_stream

    def _refuse_capture(self, training: bool = True):
        reason = self.graph_gate(training)
        if reason is not None:
            raise RuntimeError(f"a fused group cannot be captured: {reason}")

    def _graph_train(self, b: Batch) -> torch.Tensor:
        """One fused train group on the card: the first of its signature
        runs eagerly on the side stream and is then captured; later ones
        replay."""
        k = b.fused
        key = self._signature("train", b)
        g = self._graphs.get(key)
        step0 = self.step
        lrs = ([self.lr_at(step0 + i) for i in range(k)]
               if self.lr_at is not None else None)
        if g is None:
            self._refuse_capture()
            stream = self._side_stream()
            with torch.cuda.stream(stream):
                for t in b.leaves():
                    t.record_stream(stream)
                losses = self._train_multi_step(b.x, b.y)
            self._graphs[key] = self._capture_train(b, k, stream,
                                                    lrs is not None)
            return losses
        for i, gen in enumerate(g.gens):
            gen.manual_seed(self._step_seed(step0 + i))
        inputs = list(b.x) + list(b.y or ())
        if lrs is not None:
            inputs.append(torch.tensor(lrs, dtype=torch.float32)
                          .pin_memory())
        losses = g.replay(inputs).clone()
        self.step = step0 + k
        return losses

    def _capture_train(self, b: Batch, k: int, stream, scheduled: bool):
        nx = len(b.x)
        ny = len(b.y or ())
        static = [torch.empty_like(t) for t in list(b.x) + list(b.y or ())]
        lr_ts = self._lr_tensors() if scheduled else None
        if scheduled:
            static.append(torch.empty(k, dtype=torch.float32,
                                      device=self.device))
        gens = ([torch.Generator(device=self.device) for _ in range(k)]
                if self._random_layers else [])

        def body(*ins):
            xs, ys = ins[:nx], (ins[nx:nx + ny] if b.y is not None
                                else None)
            losses = []
            for i in range(k):
                if gens:
                    self._set_generator(gens[i])
                if lr_ts is not None:
                    for t in lr_ts:
                        t.copy_(ins[-1][i])
                losses.append(self._update(
                    tuple(a[i] for a in xs),
                    tuple(a[i] for a in ys) if ys is not None else None,
                    None))
            return torch.stack(losses)

        try:
            return graphs.capture("train", body, static, stream, gens,
                                  release=self.release_graphs)
        finally:
            self._set_generator(self._gen)

    def _graph_eval(self, metric_states, b: Batch):
        key = self._signature("eval", b, extra=tuple(sorted(metric_states)))
        g = self._graphs.get(key)
        state_leaves, spec = pytree.tree_flatten(metric_states)
        if g is None:
            self._refuse_capture(training=False)
            stream = self._side_stream()
            with torch.cuda.stream(stream):
                for t in b.leaves():
                    t.record_stream(stream)
                out = self._eval_multi_step(metric_states, b.x, b.y)
            nx, ny = len(b.x), len(b.y or ())
            static = [torch.empty_like(t) for t in
                      list(b.x) + list(b.y or ()) + state_leaves]

            def body(*ins):
                states = pytree.tree_unflatten(list(ins[nx + ny:]), spec)
                states, losses, counts = self._eval_multi_step(
                    states, ins[:nx],
                    ins[nx:nx + ny] if b.y is not None else None)
                return pytree.tree_flatten(states)[0] + [losses, counts]

            self._graphs[key] = graphs.capture(
                "eval", body, static, stream, release=self.release_graphs)
            return out
        outs = [t.clone() for t in g.replay(
            list(b.x) + list(b.y or ()) + state_leaves)]
        return pytree.tree_unflatten(outs[:-2], spec), outs[-2], outs[-1]

    def release_graphs(self):
        """Drop the captured graphs and their memory pools (an AutoML
        trial's when its fit returns: ``graphs.released_on_exit``)."""
        self._graphs.clear()

    # --- public API ---------------------------------------------------------
    def train_batch(self, batch: Batch) -> torch.Tensor:
        """One optimizer step on a host batch; returns the loss as a device
        scalar (read it after the epoch, so the host keeps issuing)."""
        # resilience hooks (one global read each when disarmed): the
        # `engine.dispatch` fault site, and a watchdog section bounding the
        # dispatch so a wedged device becomes a classified hang
        wd = _watchdog.active()
        token = wd.enter("engine.dispatch") if wd is not None else None
        t0 = time.perf_counter()
        try:
            # obs span (one flag check disarmed): the step-indexed segment
            # the Perfetto timeline renders
            with _trace.span("engine.dispatch", step=self.step):
                _faults.fire("engine.dispatch")
                b = batch.to(self.device)
                loss = self._train_step(b.x, b.y, b.w)
        finally:
            if token is not None:
                wd.exit(token)
        self.step += 1
        if self.pipeline_stats is not None:
            self.pipeline_stats.add("step", time.perf_counter() - t0)
        return loss

    def train_batch_group(self, batch: Batch) -> torch.Tensor:
        """Run the k fused train steps of a stacked superbatch (every x/y
        leaf ``(k, batch, ...)``, no padding): one graph replay on the card
        (an error when ``graph_gate`` refuses), k eager steps on the CPU.
        Returns the per-step losses ``(k,)``."""
        k = int(batch.fused)
        wd = _watchdog.active()
        token = wd.enter("engine.dispatch") if wd is not None else None
        t0 = time.perf_counter()
        try:
            with _trace.span("engine.dispatch", step=self.step, fused=k):
                _faults.fire("engine.dispatch")
                b = batch.to(self.device)
                if self.device.type == "cuda":
                    losses = self._graph_train(b)
                else:
                    losses = self._train_multi_step(b.x, b.y)
        finally:
            if token is not None:
                wd.exit(token)
        if self.pipeline_stats is not None:
            self.pipeline_stats.add("step", time.perf_counter() - t0,
                                    count=k)
        return losses

    def init_metric_states(self):
        return {name: m.init_state(self.device)
                for name, m in self.metrics.items()}

    def eval_batch(self, metric_states, batch: Batch):
        b = batch.to(self.device)
        return self._eval_step(metric_states, b.x, b.y, b.w)

    def eval_batch_group(self, metric_states, batch: Batch):
        """The k fused eval steps of a stacked superbatch: one graph replay
        on the card (an error when ``graph_gate`` refuses), k eager steps on
        the CPU. Returns (states, per-step
        loss sums ``(k,)``, per-step counts ``(k,)``)."""
        t0 = time.perf_counter()
        b = batch.to(self.device)
        if self.device.type == "cuda":
            out = self._graph_eval(metric_states, b)
        else:
            out = self._eval_multi_step(metric_states, b.x, b.y)
        if self.pipeline_stats is not None:
            self.pipeline_stats.add("step", time.perf_counter() - t0,
                                    count=int(batch.fused))
        return out

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
        the parameters' names in the optimizer's order, as CPU tensors. A
        param group's lr tensor is written as its float."""
        def cpu(obj):
            if isinstance(obj, torch.Tensor):
                return obj.detach().cpu().clone()
            if isinstance(obj, dict):
                return {k: cpu(v) for k, v in obj.items()}
            if isinstance(obj, (list, tuple)):
                return type(obj)(cpu(v) for v in obj)
            return obj

        opt_state = None
        if self.opt is not None:
            opt_state = cpu(self.opt.state_dict())
            for group in opt_state["param_groups"]:
                if isinstance(group.get("lr"), torch.Tensor):
                    group["lr"] = float(group["lr"])
        return {"params": cpu(self.module.state_dict()),
                "opt_state": opt_state,
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
            self._load_opt_state(_cloned(state["opt_state"]))
        self.step = int(state["step"])

    def _load_opt_state(self, opt_state: Dict[str, Any]):
        """Load an optimizer state dict into the built optimizer, keeping
        how this device built it: the groups' ``capturable``/``fused``/
        ``foreach`` flags stay this optimizer's (so state steps land where
        it keeps them), and an lr tensor stays the same tensor, given the
        state's lr. The state's tensors replace the optimizer's, so the
        captured graphs go."""
        lr_ts = [g["lr"] for g in self.opt.param_groups]
        for mine, theirs in zip(self.opt.param_groups,
                                opt_state["param_groups"]):
            for flag in ("capturable", "fused", "foreach", "differentiable"):
                if flag in mine:
                    theirs[flag] = mine[flag]
        self.opt.load_state_dict(opt_state)
        for group, t in zip(self.opt.param_groups, lr_ts):
            if isinstance(t, torch.Tensor):
                t.fill_(float(group["lr"]))
                group["lr"] = t
        self.release_graphs()

    def snapshot(self):
        """A copy of the whole training state on its device (parameters,
        buffers, optimizer state, step, and torch's default generators),
        so a caller can run real steps (the fuse probe) and roll them back
        exactly. Costs one transient copy of the parameters and optimizer
        state."""
        rng = [torch.random.get_rng_state()]
        if self.device.type == "cuda":
            rng.append(torch.cuda.get_rng_state(self.device))
        return (_cloned(self.module.state_dict()),
                _cloned(self.opt.state_dict()) if self.opt is not None
                else None, self.step, rng)

    def restore_snapshot(self, snap):
        params, opt_state, step, rng = snap
        self.module.load_state_dict(params, strict=True)
        if opt_state is not None:
            self._load_opt_state(opt_state)
        self.step = step
        torch.random.set_rng_state(rng[0])
        if len(rng) > 1:
            torch.cuda.set_rng_state(rng[1], self.device)


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
