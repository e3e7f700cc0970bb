"""The port's low-level pipeline Estimator (``analytics_zoo_tpu_torch/
pipeline/estimator``) against the JAX package's, on the CPU.

Both start from the same weights (the JAX engine's flax init, bridged
with ``interop``) and step the same minibatches: ``train_minibatch``'s
losses and the final parameters at rtol/atol 1e-5 (a two-layer MLP in
f32: the rounding differs in the last bits only), with no clipping
(Adam), clipping by value (``set_constant_gradient_clipping``: optax
``clip`` at max(|min|, |max|)) and by global norm
(``set_l2_norm_gradient_clipping``), each clipping shown to bind (the
unclipped run misses the clipped one's parameters by more than the
tolerance); both clippings set in either order, which JAX chains with
the latest setter first (the two orders shown to differ); ``train`` over
an iterable of minibatches and ``evaluate`` as JAX's; ``train`` over a
dict through ``TPUEstimator.fit``.
"""

import jax
import numpy as np
import pytest
import torch
from torch import nn

import flax.linen as fnn
from analytics_zoo_tpu.orca.learn.optimizers import optimizers_impl as jopt
from analytics_zoo_tpu.pipeline.estimator import Estimator as JEstimator
from analytics_zoo_tpu_torch import interop
from analytics_zoo_tpu_torch.orca.learn.optimizers import \
    optimizers_impl as topt
from analytics_zoo_tpu_torch.pipeline.estimator import \
    Estimator as TEstimator

TOL = dict(rtol=1e-5, atol=1e-5)
LOSS = "mean_squared_error"


class _JMLP(fnn.Module):
    @fnn.compact
    def __call__(self, x):
        h = fnn.relu(fnn.Dense(8)(x))
        return fnn.Dense(1)(h)


class _TMLP(nn.Module):
    def __init__(self):
        super().__init__()
        self.Dense_0, self.Dense_1 = nn.Linear(4, 8), nn.Linear(8, 1)

    def forward(self, x):
        return self.Dense_1(torch.relu(self.Dense_0(x)))


def _data():
    rng = np.random.RandomState(0)
    x = rng.randn(64, 4).astype(np.float32)
    y = (x @ rng.randn(4, 1) * 3).astype(np.float32)
    return x, y


def _pair(opt, clips=()):
    x, _ = _data()
    jest = JEstimator(_JMLP(), optim_methods=getattr(jopt, opt[0])(**opt[1]))
    test = TEstimator(_TMLP(), optim_methods=getattr(topt, opt[0])(**opt[1]),
                      device="cpu")
    for est in (jest, test):
        for clip in clips:
            if clip == "value":
                est.set_constant_gradient_clipping(-0.05, 0.02)
            else:
                est.set_l2_norm_gradient_clipping(0.5)
    eng = jest._engine_for(LOSS)
    eng.build((x[:32],))
    interop.load_flax_params(test.model, jax.device_get(eng.params))
    return jest, test


def _weights(est):
    return {k: v.numpy() for k, v in est.model.state_dict().items()}


@pytest.mark.parametrize("opt,clip", [
    (("Adam", dict(lr=1e-2)), None),
    (("SGD", dict(learningrate=0.05, momentum=0.9)), "value"),
    (("SGD", dict(learningrate=0.05, momentum=0.9)), "norm")])
def test_train_minibatch_matches_jax(orca_context, opt, clip):
    x, y = _data()
    jest, test = _pair(opt, (clip,) if clip else ())
    jl = [jest.train_minibatch(x[:32], y[:32]) for _ in range(10)]
    tl = [test.train_minibatch(x[:32], y[:32]) for _ in range(10)]
    np.testing.assert_allclose(tl, jl, **TOL)
    want = interop.flax_to_state_dict(jax.device_get(jest._engine.params))
    got = _weights(test)
    for k in want:
        np.testing.assert_allclose(got[k], want[k].numpy(), err_msg=k,
                                   **TOL)
    jev = jest.evaluate({"x": x, "y": y}, batch_size=32)
    tev = test.evaluate({"x": x, "y": y}, batch_size=32)
    np.testing.assert_allclose(tev["loss"], jev["loss"], **TOL)
    if clip is not None:            # the clipping binds: the control misses
        _, free = _pair(opt)
        for _ in range(10):
            free.train_minibatch(x[:32], y[:32])
        assert max(np.abs(_weights(free)[k] - got[k]).max()
                   for k in got) > 1e-3


def test_both_clippings_in_call_order_match_jax(orca_context):
    x, y = _data()
    opt = ("SGD", dict(learningrate=0.05, momentum=0.9))
    got = {}
    for clips in (("value", "norm"), ("norm", "value")):
        jest, test = _pair(opt, clips)
        jl = [jest.train_minibatch(x[:32], y[:32]) for _ in range(10)]
        tl = [test.train_minibatch(x[:32], y[:32]) for _ in range(10)]
        np.testing.assert_allclose(tl, jl, err_msg=str(clips), **TOL)
        want = interop.flax_to_state_dict(
            jax.device_get(jest._engine.params))
        got[clips] = _weights(test)
        for k in want:
            np.testing.assert_allclose(got[clips][k], want[k].numpy(),
                                       err_msg=f"{clips} {k}", **TOL)
    a, b = got.values()             # the order matters: the control
    assert max(np.abs(a[k] - b[k]).max() for k in a) > 1e-3


def test_train_over_minibatches_and_dict(orca_context):
    x, y = _data()
    jest, test = _pair(("SGD", dict(learningrate=0.05)))
    batches = [(x[i:i + 16], y[i:i + 16]) for i in range(0, 64, 16)]
    jl = jest.train(batches, epochs=2)
    tl = test.train(batches, epochs=2)
    assert len(tl) == 8
    np.testing.assert_allclose(tl, jl, **TOL)
    losses = test.train({"x": x, "y": y}, epochs=2, batch_size=32)
    assert len(losses) == 2 and np.isfinite(losses).all()
    for est in (jest, test):
        with pytest.raises(NotImplementedError, match="fresh Estimator"):
            est.clear_gradient_clipping()
