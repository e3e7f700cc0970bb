"""The port's optax-formula optimizers (``Adagrad``, ``Adadelta``,
``Adamax``, ``RMSprop``, ``Ftrl``) against the JAX package's classes, on
the CPU.

Each case runs the JAX class's optax transform and the port's
``torch.optim`` optimizer over the same gradient sequence (numpy-seeded)
from the same parameters, and holds the parameters after every step at
rtol 1e-5 / atol 1e-6: both compute in f32 in the same order of
operations, and differ only in the last bits of a ``rsqrt``/``sqrt`` or of
the lr cast, which a few steps grow to a few ulps. The optimizer state
crosses through ``interop`` both ways mid-run and the run continues to
the same parameters. Torch's built-in Adagrad and RMSprop are the control
that must miss: their epsilon and initial accumulator are not optax's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from analytics_zoo_tpu.orca.learn.optimizers import optimizers_impl as jopt
from analytics_zoo_tpu_torch import interop
from analytics_zoo_tpu_torch.orca.learn.optimizers import \
    optimizers_impl as topt

TOL = dict(rtol=1e-5, atol=1e-6)

CASES = {
    "adagrad": ("Adagrad", dict(learningrate=0.05)),
    "adagrad_decay_wd": ("Adagrad", dict(learningrate=0.05,
                                         learningrate_decay=0.1,
                                         weightdecay=0.01)),
    "adadelta": ("Adadelta", dict()),
    "adadelta_rho": ("Adadelta", dict(decayrate=0.5, epsilon=1e-6)),
    "adamax": ("Adamax", dict(lr=0.01)),
    "rmsprop": ("RMSprop", dict(lr=0.01)),
    "rmsprop_decay": ("RMSprop", dict(lr=0.01, decayrate=0.5)),
    "ftrl": ("Ftrl", dict(learningrate=0.05,
                          l2_regularization_strength=0.01)),
}


def _params(seed=0):
    rng = np.random.RandomState(seed)
    return {"Dense_0": {"kernel": rng.randn(4, 3).astype(np.float32),
                        "bias": rng.randn(3).astype(np.float32)}}


def _grads(steps, seed=1):
    rng = np.random.RandomState(seed)
    return [{"Dense_0": {"kernel": rng.randn(4, 3).astype(np.float32),
                         "bias": rng.randn(3).astype(np.float32)}}
            for _ in range(steps)]


class _Port:
    """The port's optimizer over an ``nn.Linear`` holding ``params``,
    stepped as the engine steps it (the schedule's lr set first)."""

    def __init__(self, factory, params):
        self.lin = torch.nn.Linear(4, 3)
        self.holder = torch.nn.Module()
        self.holder.Dense_0 = self.lin
        interop.load_flax_params(self.holder, params)
        self.names = [n for n, _ in self.holder.named_parameters()]
        self.opt = factory(list(self.holder.parameters()))
        self.lr_at = getattr(factory, "lr_at", None)
        self.step = 0

    def apply(self, grads):
        sd = interop.flax_to_state_dict(grads)
        for name, p in self.holder.named_parameters():
            p.grad = sd[name].clone()
        if self.lr_at is not None:
            for group in self.opt.param_groups:
                group["lr"] = self.lr_at(self.step)
        self.opt.step()
        self.step += 1

    def params(self):
        return interop.state_dict_to_flax(self.holder.state_dict())


class _Jax:
    def __init__(self, tx, params):
        self.tx = tx
        self.params = jax.tree.map(jnp.asarray, params)
        self.state = tx.init(self.params)

    def apply(self, grads):
        updates, self.state = self.tx.update(
            jax.tree.map(jnp.asarray, grads), self.state, self.params)
        self.params = optax.apply_updates(self.params, updates)


def _close(got, want, msg=""):
    for k in ("kernel", "bias"):
        np.testing.assert_allclose(got["Dense_0"][k],
                                   np.asarray(want["Dense_0"][k]),
                                   err_msg=f"{msg} {k}", **TOL)


def _make(case):
    name, kwargs = CASES[case]
    return (getattr(jopt, name)(**kwargs).to_optax(),
            getattr(topt, name)(**kwargs).to_torch())


@pytest.mark.parametrize("case", sorted(CASES))
def test_optimizer_steps_match_jax(case):
    tx, factory = _make(case)
    j, t = _Jax(tx, _params()), _Port(factory, _params())
    for i, g in enumerate(_grads(6)):
        j.apply(g)
        t.apply(g)
        _close(t.params(), j.params, f"{case} step {i + 1}")


@pytest.mark.parametrize("case", sorted(CASES))
def test_optimizer_state_crosses_interop_both_ways(case):
    """3 steps on one side, the state carried over, 3 more on the other;
    also before any step."""
    grads = _grads(6)
    for k in (0, 3):
        # JAX -> port
        tx, factory = _make(case)
        j = _Jax(tx, _params())
        for g in grads[:k]:
            j.apply(g)
        t = _Port(factory, jax.device_get(j.params))
        t.opt.load_state_dict(interop.optax_state_to_torch(
            jax.device_get(j.state), t.opt, t.names))
        t.step = k
        for g in grads[k:]:
            j.apply(g)
            t.apply(g)
        _close(t.params(), j.params, f"{case} jax->port after {k}")
        # port -> JAX
        tx, factory = _make(case)
        t = _Port(factory, _params())
        for g in grads[:k]:
            t.apply(g)
        j = _Jax(tx, t.params())
        j.state = jax.tree.map(
            jnp.asarray, interop.torch_state_to_optax(
                t.opt.state_dict(), t.names, jax.device_get(j.state), k))
        for g in grads[k:]:
            j.apply(g)
            t.apply(g)
        _close(t.params(), j.params, f"{case} port->jax after {k}")


@pytest.mark.parametrize("name,builtin", [
    ("Adagrad", lambda ps: torch.optim.Adagrad(ps, lr=0.05)),
    ("RMSprop", lambda ps: torch.optim.RMSprop(ps, lr=0.01, alpha=0.99,
                                               eps=0.1)),
])
def test_torch_builtins_miss_the_optax_formulas(name, builtin):
    """Control: torch's own Adagrad (accumulator from 0, eps outside the
    root) and RMSprop (eps outside the root; an eps of 0.1 on both sides,
    where optax's 1e-8 would hide the difference under gradients of order
    1) leave the tolerance after two steps, where the port's rules hold
    it."""
    kwargs = CASES[name.lower()][1]
    if name == "RMSprop":
        kwargs = dict(kwargs, decayrate=0.99, epsilon=0.1)
    tx = getattr(jopt, name)(**kwargs).to_optax()
    j, t = _Jax(tx, _params()), _Port(builtin, _params())
    grads = _grads(2)
    for g in grads:
        j.apply(g)
        t.apply(g)
    with pytest.raises(AssertionError):
        _close(t.params(), j.params)
    t = _Port(getattr(topt, name)(**kwargs).to_torch(), _params())
    for g in grads:
        t.apply(g)
    _close(t.params(), j.params)


def test_adamax_default_eps_where_a_gradient_is_zero():
    """The JAX class's eps, 1e-38, is an f32 subnormal. XLA on the CPU
    flushes it to 0, so a parameter whose gradient is exactly 0 gets 0 / 0
    = NaN there; the port keeps the subnormal and moves it by 0. Every
    other parameter agrees."""
    tx = jopt.Adamax().to_optax()
    j, t = _Jax(tx, _params()), _Port(topt.Adamax().to_torch(), _params())
    g = _grads(1)[0]
    g["Dense_0"]["bias"][1] = 0.0
    j.apply(g)
    t.apply(g)
    jb = np.asarray(j.params["Dense_0"]["bias"])
    tb = t.params()["Dense_0"]["bias"]
    assert np.isnan(jb[1])
    assert tb[1] == _params()["Dense_0"]["bias"][1]
    np.testing.assert_allclose(tb[[0, 2]], jb[[0, 2]], **TOL)
    _close({"Dense_0": {"kernel": t.params()["Dense_0"]["kernel"],
                        "bias": tb[[0, 2]]}},
           {"Dense_0": {"kernel": j.params["Dense_0"]["kernel"],
                        "bias": jb[[0, 2]]}})


def test_convert_optimizer_learning_rate_rule_matches_jax():
    """An explicit learning rate goes to the name's ``lr`` or
    ``learningrate``; a name without one (adadelta) raises, as in JAX."""
    p = [torch.nn.Parameter(torch.ones(2))]
    for name in ("adagrad", "adamax", "rmsprop", "ftrl", "sgd", "adam",
                 "adamw"):
        assert topt.convert_optimizer(name, 0.125)(p).defaults["lr"] == \
            0.125
        jopt.convert_optimizer(name, learning_rate=0.125)
    for convert in (topt.convert_optimizer, jopt.convert_optimizer):
        with pytest.raises(ValueError, match="no learning-rate"):
            convert("adadelta", learning_rate=0.1)
    assert topt.convert_optimizer("adadelta")(p).defaults["lr"] == 1.0
    # LBFGS is no name in either table; its learningrate is its lr
    for convert in (topt.convert_optimizer, jopt.convert_optimizer):
        with pytest.raises(ValueError, match="lbfgs"):
            convert("lbfgs")
    assert jopt.LBFGS(learningrate=0.125).lr == 0.125
    assert topt.convert_optimizer(topt.LBFGS(learningrate=0.125))(
        p).defaults["lr"] == 0.125
