"""Weight bridge between the JAX package's flax parameter trees and the
port's ``state_dict``s.

A flax tree is given as nested dicts of numpy arrays (``jax.device_get``
of the ``params`` collection, with or without the ``{"params": ...}``
wrapper). The port's modules carry the flax module names as submodule
names, so the mapping is by name, leaf by leaf:

* Dense ``kernel (in, out)``    <-> Linear ``weight (out, in)`` (transposed)
* Conv ``kernel (kh, kw, in, out)`` <-> ``weight (out, in, kh, kw)``, the
  1-D Conv ``kernel (k, in, out)`` <-> ``Conv1d.weight (out, in, k)`` and
  the 3-D Conv ``kernel (kd, kh, kw, in, out)`` <-> ``Conv3d.weight (out,
  in, kd, kh, kw)``
* flax's LSTM cells (``OptimizedLSTMCell``) are Dense layers by name
  (``ii``/``if``/``ig``/``io`` without bias, ``hi``/``hf``/``hg``/``ho``
  with), so the Dense rule covers them (``zouwu/model/nets.py``).
* LayerNorm and BatchNorm ``scale`` / ``bias`` <-> ``weight`` / ``bias``
* Dense ``bias``, embedding tables (``embedding``) and free parameters
  such as ``position_embedding`` are copied as they are.
* The ``batch_stats`` collection's ``mean`` / ``var`` <-> the BatchNorm
  buffers ``running_mean`` / ``running_var`` (a flax ``{"params": ...,
  "batch_stats": ...}`` variables dict is taken whole).

Every conversion is exact (a transpose or a copy), so a round trip
flax -> torch -> flax gives back the same bytes. A missing or an extra key,
or a shape that differs from the module's, raises.

Optimizer state crosses too, for the ported optimizers, so a run restored
from the other package's checkpoint continues as it would have (bit for bit
in exact arithmetic):

* optax ``adam``/``adamw`` under ``inject_hyperparams``: ``mu`` ->
  ``exp_avg``, ``nu`` -> ``exp_avg_sq``, ``count`` -> ``step``, and the
  injected ``learning_rate`` -> each param group's ``lr``;
* optax ``sgd`` with momentum: the ``TraceState`` trace -> each
  parameter's ``momentum_buffer``;
* a scheduled optimizer's ``ScaleByScheduleState.count`` (optax does not
  wrap a schedule in ``inject_hyperparams``) <-> the engine's step, which
  the port's schedule reads;
* the port's optax-formula optimizers (``orca/learn/optimizers``):
  ``adagrad``'s (and the Ftrl fallback's) ``ScaleByRssState.
  sum_of_squares`` -> ``sum``; ``rmsprop``'s ``ScaleByRmsState.nu`` ->
  ``square_avg``; ``adamax``'s ``ScaleByAdamState`` ``mu``/``nu``/
  ``count`` -> ``exp_avg``/``exp_inf``/``step``; ``adadelta``'s
  ``ScaleByAdaDeltaState`` ``e_g``/``e_x`` -> ``square_avg``/
  ``acc_delta``. These states exist from optax's init (the accumulator at
  0.1, the others at 0), so they cross before the first step too.
* optax ``MultiSteps`` (the JAX ``ZooOptimizer``): ``MultiStepsState``'s
  ``mini_step`` and ``gradient_step`` <-> the port's ``MultiSteps``
  counters, ``acc_grads`` <-> each parameter's ``acc`` (the running mean),
  and ``inner_opt_state`` <-> the inner optimizer's state by the rules
  above, its counts being the window count ``gradient_step``. A state
  taken in the middle of a window resumes there.

Free parameters named ``weight`` (the Keras ``Scale``, ``CMul``, ``Mul``
and the autograd ``Parameter``) cannot be told from a Linear's weight by
their name alone: :func:`state_dict_to_flax` given the module keeps the
names a module lists in ``flax_free_params`` as they are.

Moments follow their parameter's mapping (a Dense or Conv kernel's moments
are transposed as it is). The optax side may be optax's own namedtuples or the
checkpoint reader's stand-ins for them (``ckpt.format.stand_in``): both are
matched by class name and field, so this module imports neither JAX nor
optax. :func:`state_from_jax` and :func:`state_to_jax` convert whole
engine states, as a checkpoint holds them, BatchNorm statistics (JAX's
``extra_vars["batch_stats"]``, the port's buffers) included.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch
from torch import nn
from torch.nn.parameter import is_lazy


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if isinstance(val, Mapping):
            out.update(_flatten(val, name + "."))
        else:
            out[name] = val
    return out


# flax batch_stats leaf <-> torch BatchNorm buffer
_STATS = {"mean": "running_mean", "var": "running_var"}
_BUFFERS = {v: k for k, v in _STATS.items()}
# kernel (flax) -> weight (torch) axis order, by rank: Dense, 1-D, 2-D and
# 3-D Conv
_TO_TORCH = {2: (1, 0), 3: (2, 1, 0), 4: (3, 2, 0, 1), 5: (4, 3, 0, 1, 2)}
_TO_FLAX = {2: (1, 0), 3: (2, 1, 0), 4: (2, 3, 1, 0), 5: (2, 3, 4, 1, 0)}


def _split_variables(variables: Mapping[str, Any]):
    """A flax ``params`` tree, or a variables dict ``{"params", ...}`` that
    may hold ``batch_stats`` -> (params, batch_stats or None)."""
    if "params" in variables and set(variables) <= {"params", "batch_stats"}:
        return variables["params"], variables.get("batch_stats")
    return variables, None


def flax_to_state_dict(variables: Mapping[str, Any]
                       ) -> Dict[str, torch.Tensor]:
    """flax ``params`` tree or variables dict (with ``batch_stats``) ->
    torch ``state_dict`` (CPU tensors)."""
    params, batch_stats = _split_variables(variables)
    sd: Dict[str, torch.Tensor] = {}
    for name, leaf in _flatten(params).items():
        arr = np.asarray(leaf)
        path, _, leaf_name = name.rpartition(".")
        prefix = path + "." if path else ""
        if leaf_name == "kernel":
            if arr.ndim not in _TO_TORCH:
                raise ValueError(f"{name}: only Dense (2-D) and Conv (3-D "
                                 f"to 5-D) kernels are bridged, got shape "
                                 f"{arr.shape}")
            sd[prefix + "weight"] = torch.from_numpy(
                np.ascontiguousarray(arr.transpose(_TO_TORCH[arr.ndim])))
        elif leaf_name == "scale":
            sd[prefix + "weight"] = torch.from_numpy(arr.copy())
        else:
            sd[name] = torch.from_numpy(arr.copy())
    for name, leaf in _flatten(batch_stats or {}).items():
        path, _, leaf_name = name.rpartition(".")
        sd[f"{path}.{_STATS[leaf_name]}"] = torch.from_numpy(
            np.array(leaf))
    return sd


def _tree_set(tree: Dict[str, Any], path: Sequence[str], key: str,
              value) -> None:
    node = tree
    for part in path:
        node = node.setdefault(part, {})
    node[key] = value


def _free_params(module: Optional[nn.Module]) -> set:
    """The state_dict keys of the parameters ``module``'s submodules list
    in ``flax_free_params``: kept under their own names."""
    if module is None:
        return set()
    return {f"{prefix}.{p}" if prefix else p
            for prefix, m in module.named_modules()
            for p in getattr(m, "flax_free_params", ())}


def state_dict_to_flax(state_dict: Mapping[str, torch.Tensor],
                       module: Optional[nn.Module] = None
                       ) -> Dict[str, Any]:
    """torch ``state_dict`` -> flax ``params`` tree of numpy arrays (the
    inverse of :func:`flax_to_state_dict`; BatchNorm buffers go to
    :func:`state_dict_to_batch_stats`). Given the ``module``, its free
    parameters keep their names (see the module docstring)."""
    free = _free_params(module)
    tree: Dict[str, Any] = {}
    for name, tensor in state_dict.items():
        *path, leaf_name = name.split(".")
        if leaf_name in _BUFFERS:
            continue
        arr = tensor.detach().cpu().numpy()
        if leaf_name == "weight" and name not in free:
            if arr.ndim in _TO_FLAX:
                leaf_name = "kernel"
                arr = np.ascontiguousarray(arr.transpose(_TO_FLAX[arr.ndim]))
            elif arr.ndim == 1:
                leaf_name = "scale"
            else:
                raise ValueError(f"{name}: unexpected weight rank "
                                 f"{arr.ndim}")
        else:
            arr = arr.copy()
        _tree_set(tree, path, leaf_name, arr)
    return tree


def state_dict_to_batch_stats(state_dict: Mapping[str, torch.Tensor]
                              ) -> Dict[str, Any]:
    """The BatchNorm buffers of a torch ``state_dict`` -> flax's
    ``batch_stats`` tree (empty for a module without BatchNorm)."""
    tree: Dict[str, Any] = {}
    for name, tensor in state_dict.items():
        *path, leaf_name = name.split(".")
        if leaf_name in _BUFFERS:
            _tree_set(tree, path, _BUFFERS[leaf_name],
                      tensor.detach().cpu().numpy().copy())
    return tree


def load_flax_params(module: nn.Module, variables: Mapping[str, Any]
                     ) -> nn.Module:
    """Copy a flax parameter tree, or a variables dict (with the
    ``batch_stats`` of a module with BatchNorm), into ``module``; a lazy
    width takes the tree's. Raises on a missing or extra key or a shape
    mismatch, naming every offender."""
    sd = flax_to_state_dict(variables)
    own = module.state_dict()
    missing = sorted(set(own) - set(sd))
    extra = sorted(set(sd) - set(own))
    # a lazy width (the Keras layers') takes the loaded shape
    wrong = sorted(f"{k}: {tuple(sd[k].shape)} vs {tuple(own[k].shape)}"
                   for k in set(sd) & set(own)
                   if not is_lazy(own[k])
                   and tuple(sd[k].shape) != tuple(own[k].shape))
    if missing or extra or wrong:
        raise ValueError(f"flax params do not fit {type(module).__name__}: "
                         f"missing {missing}, extra {extra}, "
                         f"shape mismatch {wrong}")
    module.load_state_dict(sd, strict=True)
    return module


# --- optimizer state ---------------------------------------------------------
_INJECT = ("InjectStatefulHyperparamsState",)
_SCHEDULE = ("ScaleByScheduleState",)


def _find(tree, names) -> Optional[Any]:
    """The first namedtuple in ``tree`` whose class name is in ``names``."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        if type(tree).__name__ in names:
            return tree
    if isinstance(tree, (list, tuple)):
        for v in tree:
            found = _find(v, names)
            if found is not None:
                return found
    return None


def _by_name(flax_tree, param_names: Sequence[str]) -> List[torch.Tensor]:
    sd = flax_to_state_dict(flax_tree)
    return [sd[n] for n in param_names]


# optax state class -> (optax field, torch state key) of its moments, for
# the states without a count (they exist from optax's init on)
_MOMENTS = {
    "ScaleByRssState": (("sum_of_squares", "sum"),),
    "ScaleByRmsState": (("nu", "square_avg"),),
    "ScaleByAdaDeltaState": (("e_g", "square_avg"), ("e_x", "acc_delta")),
}


def _adam_keys(is_adamax: bool):
    return ("exp_avg", "exp_inf" if is_adamax else "exp_avg_sq")


def optax_state_to_torch(opt_state, optimizer: torch.optim.Optimizer,
                         param_names: Sequence[str]) -> Dict[str, Any]:
    """An optax state of Adam, AdamW, SGD or one of the port's
    optax-formula optimizers -> a ``state_dict`` for ``optimizer`` (built
    over the parameters ``param_names`` names, in order). An Adam-type or
    SGD state before the first step gives an empty ``state``, as torch's
    own optimizers start."""
    from .orca.learn.optimizers.optimizers_impl import (AdamaxRule,
                                                        MultiSteps)
    if isinstance(optimizer, MultiSteps):
        ms = _find(opt_state, ("MultiStepsState",))
        out = optax_state_to_torch(ms.inner_opt_state, optimizer.inner,
                                   param_names)
        out["multi_steps"] = {
            "mini_step": int(np.asarray(ms.mini_step)),
            "gradient_step": int(np.asarray(ms.gradient_step)),
            "acc": dict(enumerate(_by_name(ms.acc_grads, param_names)))}
        return out
    groups = copy.deepcopy(optimizer.state_dict()["param_groups"])
    inject = _find(opt_state, _INJECT)
    if inject is not None:
        lr = float(np.asarray(inject.hyperparams["learning_rate"]))
        for g in groups:
            g["lr"] = lr
    state: Dict[int, Dict[str, torch.Tensor]] = {}
    adam = _find(opt_state, ("ScaleByAdamState",))
    trace = _find(opt_state, ("TraceState",))
    moments = _find(opt_state, tuple(_MOMENTS))
    if adam is not None:
        step = int(np.asarray(adam.count))
        mu_key, nu_key = _adam_keys(isinstance(optimizer, AdamaxRule))
        if step > 0:
            mus = _by_name(adam.mu, param_names)
            nus = _by_name(adam.nu, param_names)
            for i, (mu, nu) in enumerate(zip(mus, nus)):
                state[i] = {"step": torch.tensor(float(step)),
                            mu_key: mu, nu_key: nu}
    elif moments is not None:
        for field, key in _MOMENTS[type(moments).__name__]:
            for i, t in enumerate(_by_name(getattr(moments, field),
                                           param_names)):
                state.setdefault(i, {})[key] = t
    elif trace is not None:
        counter = inject or _find(opt_state, _SCHEDULE)
        steps = int(np.asarray(counter.count)) if counter is not None else 1
        if steps > 0:
            for i, buf in enumerate(_by_name(trace.trace, param_names)):
                state[i] = {"momentum_buffer": buf}
    return {"state": state, "param_groups": groups}


def _to_flax(named: Mapping[str, Any]) -> Dict[str, Any]:
    return state_dict_to_flax({k: torch.as_tensor(np.asarray(v))
                               for k, v in named.items()})


def torch_state_to_optax(torch_state: Mapping[str, Any],
                         param_names: Sequence[str], template, step: int):
    """A torch ``state_dict`` of an optimizer above -> the optax state of
    ``template`` (the JAX optimizer's state, e.g. ``tx.init(params)``),
    rebuilt with the template's own classes. ``step`` is the engine's
    step count (the injected state's ``count``)."""
    ms = torch_state.get("multi_steps")
    if ms is not None:
        inner = {k: v for k, v in torch_state.items() if k != "multi_steps"}

        def fill_ms(node):
            if type(node).__name__ == "MultiStepsState":
                window = int(ms["gradient_step"])
                by_index = {int(i): a for i, a in ms["acc"].items()}
                acc = (_to_flax({n: by_index[i]
                                 for i, n in enumerate(param_names)})
                       if by_index else node.acc_grads)
                return node._replace(
                    mini_step=np.asarray(ms["mini_step"], np.asarray(
                        node.mini_step).dtype),
                    gradient_step=np.asarray(window, np.asarray(
                        node.gradient_step).dtype),
                    inner_opt_state=torch_state_to_optax(
                        inner, param_names, node.inner_opt_state, window),
                    acc_grads=acc)
            if isinstance(node, (list, tuple)) and not hasattr(node,
                                                               "_fields"):
                return type(node)(fill_ms(v) for v in node)
            return node
        return fill_ms(template)
    st = torch_state["state"]
    lr = float(torch_state["param_groups"][0]["lr"])

    def moments(key, like):
        if not st:          # before the first step: the template's zeros
            return like
        return _to_flax({n: st[i][key] for i, n in enumerate(param_names)})

    def fill(node):
        name = type(node).__name__
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            if name == "ScaleByAdamState":
                count = int(np.asarray(st[0]["step"])) if st else 0
                mu_key, nu_key = _adam_keys(bool(st) and "exp_inf" in st[0])
                return node._replace(
                    count=np.asarray(count, np.asarray(node.count).dtype),
                    mu=moments(mu_key, node.mu),
                    nu=moments(nu_key, node.nu))
            if name in _MOMENTS:
                return node._replace(**{
                    field: moments(key, getattr(node, field))
                    for field, key in _MOMENTS[name]})
            if name in _SCHEDULE:
                return node._replace(
                    count=np.asarray(step, np.asarray(node.count).dtype))
            if name == "TraceState":
                return node._replace(trace=moments("momentum_buffer",
                                                   node.trace))
            if name in _INJECT:
                hp = dict(node.hyperparams)
                hp["learning_rate"] = np.asarray(
                    lr, np.asarray(hp["learning_rate"]).dtype)
                return node._replace(
                    count=np.asarray(step, np.asarray(node.count).dtype),
                    hyperparams=hp, inner_state=fill(node.inner_state))
            return node
        if isinstance(node, (list, tuple)):
            return type(node)(fill(v) for v in node)
        return node

    return fill(template)


def state_from_jax(jax_state: Mapping[str, Any], module: nn.Module,
                   optimizer: Optional[torch.optim.Optimizer]
                   ) -> Dict[str, Any]:
    """A JAX engine state (``{"params", "extra_vars", "opt_state",
    "step"}``, as its checkpoints hold it) -> the port engine's state for
    ``module`` and ``optimizer`` (no optimizer: the moments are
    dropped)."""
    names = [n for n, _ in module.named_parameters()]
    variables = {"params": jax_state["params"]}
    stats = (jax_state.get("extra_vars") or {}).get("batch_stats")
    if stats:
        variables["batch_stats"] = stats
    out = {"params": flax_to_state_dict(variables),
           "opt_state": None, "step": int(jax_state["step"])}
    if optimizer is not None and jax_state.get("opt_state") is not None:
        out["opt_state"] = optax_state_to_torch(jax_state["opt_state"],
                                                optimizer, names)
    return out


def state_to_jax(port_state: Mapping[str, Any], opt_template
                 ) -> Dict[str, Any]:
    """The port engine's state (with its ``param_names``, as its
    checkpoints hold it) -> a JAX engine state whose optimizer state has
    the form of ``opt_template``."""
    names = list(port_state["param_names"])
    step = int(port_state["step"])
    opt = port_state.get("opt_state")
    sd = {k: torch.as_tensor(np.asarray(v))
          for k, v in port_state["params"].items()}
    stats = state_dict_to_batch_stats(sd)
    return {"params": state_dict_to_flax(sd),
            "extra_vars": {"batch_stats": stats} if stats else {},
            "opt_state": (None if opt is None else torch_state_to_optax(
                opt, names, opt_template, step)),
            "step": step, "tp_specs": None}
