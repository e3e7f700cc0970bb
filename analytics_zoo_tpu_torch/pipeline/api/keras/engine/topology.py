"""Sequential and functional Model fronts of the Keras API (counterpart of
``analytics_zoo_tpu/pipeline/api/keras/engine/topology.py``).

A model is an ``nn.Module`` (``to_module()``): ``Sequential`` chains its
layers as children ``layers_0``, ``layers_1``, ...; ``Model`` evaluates
the symbolic DAG of ``engine/graph.py`` with the graph's unique layers as
children ``layers_{i}``. These are flax's names, so ``interop`` maps the
JAX package's parameter trees onto the port's ``state_dict`` by name, and
``get_weights()`` returns the flax-shaped tree. ``compile``/``fit``/
``evaluate``/``predict`` go through the port's ``TPUEstimator``, which runs
on ``device`` (default: the card; ``"cpu"`` asks for the CPU).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

from torch import nn

from .graph import Variable, call_layer, evaluate_graph, graph_modules


def Input(shape: Tuple[int, ...] = (), name: Optional[str] = None) -> Variable:
    """Symbolic placeholder; `shape` excludes the batch dim."""
    return Variable(shape=(None,) + tuple(shape), name=name or "input")


class _SequentialModule(nn.Module):
    """Applies the layers in order; the modules among them are children
    ``layers_{i}``, ``i`` their place in the list."""

    def __init__(self, layers: Sequence[Any]):
        super().__init__()
        self.layer_list = list(layers)
        for i, lyr in enumerate(self.layer_list):
            if isinstance(lyr, nn.Module):
                self.add_module(f"layers_{i}", lyr)

    def forward(self, *xs):
        x = xs[0] if len(xs) == 1 else xs
        for lyr in self.layer_list:
            x = call_layer(lyr, *x) if isinstance(x, tuple) \
                else call_layer(lyr, x)
        return x


class _GraphModule(nn.Module):
    """Evaluates a functional graph; its unique layers are the children
    ``layers_{i}``."""

    def __init__(self, inputs: Sequence[Variable],
                 outputs: Sequence[Variable]):
        super().__init__()
        modules, slots = graph_modules(outputs)
        self.inputs, self.outputs = tuple(inputs), tuple(outputs)
        for i, m in enumerate(modules):
            self.add_module(f"layers_{i}", m)
        self._bound = {uid: modules[i] for uid, i in slots}

    def forward(self, *xs):
        return evaluate_graph(self.inputs, self.outputs, xs,
                              train=self.training, bound=self._bound)


class KerasNet:
    """compile/fit/evaluate/predict shared by Sequential and Model, over
    the port's estimator (built on first use, on ``device``)."""

    def __init__(self, device=None):
        self.device = device
        self._module: Optional[nn.Module] = None
        self._estimator = None
        self._compile_args: Dict[str, Any] = {}
        self._tb_dir: Optional[Tuple[str, str]] = None

    # -- module construction (implemented by subclasses) ---------------------
    def _build_module(self) -> nn.Module:
        raise NotImplementedError

    def to_module(self) -> nn.Module:
        """The model as an ``nn.Module`` (the same one, holding the
        weights, until the model changes)."""
        if self._module is None:
            self._module = self._build_module()
        return self._module

    # -- training surface ----------------------------------------------------
    def compile(self, optimizer="adam", loss="mean_squared_error",
                metrics: Optional[List] = None):
        self._compile_args = dict(optimizer=optimizer, loss=loss,
                                  metrics=metrics)
        self._estimator = None  # rebuilt lazily with the module
        return self

    @property
    def estimator(self):
        if self._estimator is None:
            from .....orca.learn.estimator import TPUEstimator
            args = self._compile_args or dict(optimizer="adam",
                                              loss="mean_squared_error",
                                              metrics=None)
            self._estimator = TPUEstimator(
                self.to_module(), loss=args["loss"],
                optimizer=args["optimizer"], metrics=args["metrics"],
                device=self.device)
            if self._tb_dir is not None:
                self._estimator.set_tensorboard(*self._tb_dir)
        return self._estimator

    def set_tensorboard(self, log_dir: str, app_name: str):
        self._tb_dir = (log_dir, app_name)
        if self._estimator is not None:
            self._estimator.set_tensorboard(log_dir, app_name)

    def get_train_summary(self, tag: str = "Loss"):
        return self.estimator.get_train_summary(tag)

    def get_validation_summary(self, tag: str):
        return self.estimator.get_validation_summary(tag)

    def fit(self, x, y=None, batch_size: int = 32, nb_epoch: int = 10,
            validation_data=None, distributed: bool = True, **kwargs):
        data = {"x": x, "y": y} if y is not None else x
        if validation_data is not None and isinstance(validation_data, tuple):
            validation_data = {"x": validation_data[0],
                               "y": validation_data[1]}
        return self.estimator.fit(data, epochs=nb_epoch,
                                  batch_size=batch_size,
                                  validation_data=validation_data, **kwargs)

    def evaluate(self, x, y=None, batch_size: int = 32, **kwargs):
        data = {"x": x, "y": y} if y is not None else x
        return self.estimator.evaluate(data, batch_size=batch_size, **kwargs)

    def predict(self, x, batch_size: int = 32, distributed: bool = False,
                **kwargs):
        """Arrays, a dict ``{"x": ...}``, or XShards (with
        ``feature_cols``; the result is XShards with ``"prediction"``)."""
        from .....orca.data.shard import HostXShards
        data = x if isinstance(x, (dict, HostXShards)) else {"x": x}
        return self.estimator.predict(data, batch_size=batch_size, **kwargs)

    def get_weights(self):
        """The parameters as the JAX package's flax tree of numpy arrays
        (``{"layers_0": {"Dense_0": {"kernel", "bias"}}, ...}``); None
        while a width still waits for the first input."""
        from ..... import interop
        from .....orca.learn.engine import has_lazy_params
        module = self.estimator.module
        if has_lazy_params(module):
            return None
        return interop.state_dict_to_flax(module.state_dict(), module)

    def save_weights(self, path: str):
        self.estimator.save(path)

    def load_weights(self, path: str):
        self.estimator.load(path)

    def summary(self) -> str:
        text = repr(self.to_module())
        print(text)
        return text


class Sequential(KerasNet):
    """A stack of layers applied in order."""

    def __init__(self, layers: Optional[Sequence[Any]] = None, device=None):
        super().__init__(device)
        self._layers: List[Any] = list(layers or [])

    def add(self, layer) -> "Sequential":
        if isinstance(layer, KerasNet):
            layer = layer.to_module()
        self._layers.append(layer)
        self._module = None
        self._estimator = None
        return self

    def _build_module(self) -> nn.Module:
        return _SequentialModule(self._layers)

    def __call__(self, x):
        """Symbolic or eager application of the whole stack."""
        return self.to_module()(x)


class Model(KerasNet):
    """Functional graph model from ``Input`` Variables to outputs."""

    def __init__(self, input, output, device=None):
        super().__init__(device)
        ins = input if isinstance(input, (list, tuple)) else [input]
        outs = output if isinstance(output, (list, tuple)) else [output]
        if not all(isinstance(v, Variable) for v in list(ins) + list(outs)):
            raise TypeError("Model(input, output) takes symbolic Variables "
                            "from Input(...)")
        self.inputs = tuple(ins)
        self.outputs = tuple(outs)

    def _build_module(self) -> nn.Module:
        return _GraphModule(self.inputs, self.outputs)

    def __call__(self, *xs):
        return self.to_module()(*xs)
