"""The symbolic graph behind the functional Keras API and autograd
(counterpart of ``analytics_zoo_tpu/pipeline/api/keras/engine/graph.py``).

A :class:`Variable` is a node of a small DAG: a placeholder (``op`` None)
or the output of a layer or a plain function applied to parent
Variables. A functional ``Model`` evaluates the DAG inside one
``nn.Module`` whose children are the graph's layers.

Calling any ``torch.nn.Module`` on a Variable records it as a node, the
port's own layers and stock torch modules alike: on the first Variable
constructed, :func:`_install_symbolic_dispatch` wraps ``nn.Module.__call__``
so that a call whose positional arguments hold a Variable becomes
:func:`symbolic_apply`, and every other call goes through unchanged (the
JAX package patches flax's module call the same way). ``keras_call`` does
the same for callables that are not modules.
"""

from __future__ import annotations

import functools
import itertools
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from torch import nn

_uid_counter = itertools.count()


class Variable:
    """A symbolic tensor: placeholder (op=None) or the output of applying a
    layer / plain function to parent Variables."""

    def __init__(self, shape: Optional[Tuple] = None,
                 name: Optional[str] = None, op: Any = None,
                 parents: Sequence["Variable"] = (),
                 op_kwargs: Optional[dict] = None):
        _install_symbolic_dispatch()  # lazily, on first symbolic tensor
        self._uid = next(_uid_counter)
        self.shape = tuple(shape) if shape is not None else None
        self.name = name or f"var_{self._uid}"
        self.op = op                      # None | nn.Module | callable
        self.parents = list(parents)
        self.op_kwargs = op_kwargs or {}

    # --- autograd operator sugar --------------------------------------------
    def _binop(self, other, fn, name):
        if isinstance(other, Variable):
            return Variable(op=fn, parents=[self, other], name=name)
        return Variable(op=lambda a, _o=other: fn(a, _o), parents=[self],
                        name=name)

    def __add__(self, other):
        return self._binop(other, lambda a, b: a + b, "add")

    def __radd__(self, other):
        return self._binop(other, lambda a, b: b + a, "radd")

    def __sub__(self, other):
        return self._binop(other, lambda a, b: a - b, "sub")

    def __rsub__(self, other):
        return self._binop(other, lambda a, b: b - a, "rsub")

    def __mul__(self, other):
        return self._binop(other, lambda a, b: a * b, "mul")

    def __rmul__(self, other):
        return self._binop(other, lambda a, b: b * a, "rmul")

    def __truediv__(self, other):
        return self._binop(other, lambda a, b: a / b, "div")

    def __rtruediv__(self, other):
        return self._binop(other, lambda a, b: b / a, "rdiv")

    def __neg__(self):
        return Variable(op=lambda a: -a, parents=[self], name="neg")

    def __pow__(self, p):
        return Variable(op=lambda a: a ** p, parents=[self], name="pow")

    def __getitem__(self, idx):
        return Variable(op=lambda a: a[idx], parents=[self], name="slice")

    def index_select(self, dim: int, index: int):
        """Element ``index`` of axis ``dim``, the axis dropped."""
        return Variable(op=lambda a: a.select(dim, index),
                        parents=[self], name="index_select")

    def slice(self, dim: int, start_index: int, length: int):
        return Variable(op=lambda a: a.narrow(dim, start_index, length),
                        parents=[self], name="slice_range")


def has_variable(args) -> bool:
    return any(isinstance(a, Variable) for a in args)


def symbolic_apply(module, *args, **kwargs) -> Variable:
    """Record `module(*args)` as a graph node (all args must be Variables)."""
    parents = [a for a in args if isinstance(a, Variable)]
    if len(parents) != len(args):
        raise TypeError("mixing Variables and arrays in one call is not "
                        "supported; wrap constants with autograd ops instead")
    return Variable(op=module, parents=parents,
                    name=getattr(module, "name", None) or
                    type(module).__name__.lower(), op_kwargs=kwargs)


def keras_call(fn: Callable) -> Callable:
    """Decorator for a callable's ``__call__``: Variable inputs build a
    graph node, tensors compute. Modules need none: the dispatch below
    records every ``nn.Module`` called on a Variable."""

    @functools.wraps(fn)
    def wrapper(self, *args, **kwargs):
        if has_variable(args):
            return symbolic_apply(self, *args, **kwargs)
        return fn(self, *args, **kwargs)

    return wrapper


def _install_symbolic_dispatch():
    """Teach every ``nn.Module`` to record itself as a graph node when it
    is called on Variables. Installed once, on the first Variable, so a
    program that never builds a functional graph runs torch's own
    ``__call__`` untouched; once installed, a call without a Variable
    among its positional arguments goes straight to it."""
    global _dispatch_installed
    if _dispatch_installed:
        return
    _dispatch_installed = True
    orig = nn.Module.__call__

    def dispatching_call(self, *args, **kwargs):
        for a in args:
            if isinstance(a, Variable):
                return symbolic_apply(self, *args, **kwargs)
        return orig(self, *args, **kwargs)

    nn.Module.__call__ = dispatching_call


_dispatch_installed = False


def call_layer(layer, *xs, train: bool = False, **kwargs):
    """Invoke a child layer. A module takes train or eval mode from its
    parent's ``train()``/``eval()``, so ``train`` is for the JAX package's
    signature only."""
    return layer(*xs, **kwargs)


def topo_order(outputs: Sequence[Variable]) -> List[Variable]:
    order: List[Variable] = []
    seen: Dict[int, bool] = {}

    def visit(v: Variable):
        if v._uid in seen:
            return
        seen[v._uid] = True
        for p in v.parents:
            visit(p)
        order.append(v)

    for o in outputs:
        visit(o)
    return order


def graph_modules(outputs: Sequence[Variable]):
    """The unique layer modules reachable from `outputs` (by identity, so a
    shared instance shares its weights) and the (node uid, layer index)
    slots. The functional Model holds the modules as its children
    ``layers_{i}``, flax's names for them."""
    modules: List[nn.Module] = []
    slots: List[Tuple[int, int]] = []
    seen: Dict[int, int] = {}
    for v in topo_order(outputs):
        if isinstance(v.op, nn.Module):
            key = id(v.op)
            if key not in seen:
                seen[key] = len(modules)
                modules.append(v.op)
            slots.append((v._uid, seen[key]))
    return tuple(modules), tuple(slots)


def evaluate_graph(inputs: Sequence[Variable], outputs: Sequence[Variable],
                   xs: Sequence[Any], train: bool = False,
                   bound: Optional[Dict[int, Any]] = None):
    """Evaluate the DAG on tensors ``xs``. ``bound`` maps a node's uid to
    the module to call for it (default: the node's own op)."""
    bound = bound or {}
    cache: Dict[int, Any] = {}
    for var, x in zip(inputs, xs):
        cache[var._uid] = x
    for v in topo_order(outputs):
        if v._uid in cache:
            continue
        if v.op is None:
            raise ValueError(
                f"placeholder {v.name} is not among the model inputs")
        parent_vals = [cache[p._uid] for p in v.parents]
        if isinstance(v.op, nn.Module):
            layer = bound.get(v._uid, v.op)
            cache[v._uid] = call_layer(layer, *parent_vals, train=train,
                                       **v.op_kwargs)
        else:
            cache[v._uid] = v.op(*parent_vals, **v.op_kwargs)
    outs = tuple(cache[o._uid] for o in outputs)
    return outs[0] if len(outs) == 1 else outs

