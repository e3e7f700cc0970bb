"""The port's GANEstimator (``analytics_zoo_tpu_torch/orca/learn/
gan_estimator.py``) against the JAX package's, on the CPU.

* Both loss kinds against JAX's on seeded logits, with and without mask
  weights, at rtol/atol 1e-6.
* One D step and one G step from bridged weights, fed the very noise the
  JAX estimator's jitted steps draw (``jax.random.normal`` on the keys
  ``train`` hands them: ``fold_in(PRNGKey(seed + 100), step * 7 + 1)``,
  then ``step * 7 + 3``): losses and parameters at rtol/atol 1e-5 (a few
  f32 operations in another order; Adam, and SGD with momentum for the
  Wasserstein case), the weighted real term included (a
  batch whose last rows are padding, ``w`` 0 there); the G step leaves
  the discriminator bit for bit as it was, the D step the generator.
* Two epochs of ``train`` on both sides, the port fed JAX's noise in
  ``train``'s order and both shuffling alike (the native runtime's
  permutation): per-epoch losses at 1e-5, parameters at 1e-4 (Adam
  divides near-zero second moments: the rounding of 20 updates shows
  there first).
* ``generate``'s shape.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

import flax.linen as fnn
from analytics_zoo_tpu.orca.learn import gan_estimator as jgan
from analytics_zoo_tpu.orca.learn.optimizers import optimizers_impl as jopt
from analytics_zoo_tpu_torch import interop
from analytics_zoo_tpu_torch.orca.learn import gan_estimator as tgan
from analytics_zoo_tpu_torch.orca.learn.optimizers import \
    optimizers_impl as topt

NOISE = 4
TOL = dict(rtol=1e-5, atol=1e-5)


class _JG(fnn.Module):
    @fnn.compact
    def __call__(self, z):
        h = fnn.relu(fnn.Dense(16)(z))
        return fnn.Dense(2)(h)


class _JD(fnn.Module):
    @fnn.compact
    def __call__(self, x):
        h = fnn.relu(fnn.Dense(16)(x))
        return fnn.Dense(1)(h)


class _TG(nn.Module):
    def __init__(self):
        super().__init__()
        self.Dense_0, self.Dense_1 = nn.Linear(NOISE, 16), nn.Linear(16, 2)

    def forward(self, z):
        return self.Dense_1(torch.relu(self.Dense_0(z)))


class _TD(nn.Module):
    def __init__(self):
        super().__init__()
        self.Dense_0, self.Dense_1 = nn.Linear(2, 16), nn.Linear(16, 1)

    def forward(self, x):
        return self.Dense_1(torch.relu(self.Dense_0(x)))


def _real(n=80):
    rng = np.random.RandomState(0)
    return (rng.randn(n, 2) * 0.3 + np.array([2.0, -1.0])).astype(
        np.float32)


@pytest.mark.parametrize("kind", ["modified", "wasserstein"])
def test_losses_match_jax(kind):
    rng = np.random.RandomState(1)
    real, fake = (rng.randn(8, 1).astype(np.float32) for _ in range(2))
    w = np.array([1, 1, 1, 1, 1, 0, 0, 1], np.float32)
    jg, jd = jgan.gan_loss_fns(kind)
    tg, td = tgan.gan_loss_fns(kind)
    t = torch.from_numpy
    np.testing.assert_allclose(float(tg(t(fake))), float(jg(fake)),
                               rtol=1e-6, atol=1e-6)
    for weights in (None, w):
        want = float(jd(real, fake, weights))
        got = float(td(t(real), t(fake),
                       None if weights is None else t(weights)))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    # the mask weights the real term alone
    assert float(td(t(real), t(fake), t(w))) != float(td(t(real), t(fake)))
    with pytest.raises(ValueError, match="unknown gan loss"):
        tgan.gan_loss_fns("minimax")


def _pair(kind="modified", opt=("Adam", dict(lr=1e-2))):
    losses = {} if kind == "modified" else dict(
        zip(("generator_loss_fn", "discriminator_loss_fn"),
            jgan.gan_loss_fns(kind)))
    j = jgan.GANEstimator(_JG(), _JD(), noise_dim=NOISE,
                          generator_optimizer=getattr(jopt, opt[0])(**opt[1]),
                          discriminator_optimizer=getattr(jopt, opt[0])(
                              **opt[1]),
                          **losses)
    j._build(_real()[:1])
    tlosses = {} if kind == "modified" else dict(
        zip(("generator_loss_fn", "discriminator_loss_fn"),
            tgan.gan_loss_fns(kind)))
    g = interop.load_flax_params(_TG(), jax.device_get(j.g_params))
    d = interop.load_flax_params(_TD(), jax.device_get(j.d_params))
    t = tgan.GANEstimator(g, d, noise_dim=NOISE,
                          generator_optimizer=getattr(topt, opt[0])(**opt[1]),
                          discriminator_optimizer=getattr(topt, opt[0])(
                              **opt[1]),
                          device="cpu", **tlosses)
    return j, t


def _params(module):
    return {k: v.clone() for k, v in module.state_dict().items()}


def _match(module, flax_params, tol=TOL):
    want = interop.flax_to_state_dict(jax.device_get(flax_params))
    for k, v in module.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), err_msg=k,
                                   **tol)


@pytest.mark.parametrize("kind,weighted", [
    ("modified", False), ("modified", True), ("wasserstein", True)])
def test_d_and_g_steps_match_jax(orca_context, kind, weighted):
    # the Wasserstein critic's last bias has a gradient of exactly 0 (its
    # two terms cancel), which Adam would turn into a step of ~lr on the
    # sign of JAX's rounding residue: that case steps with SGD
    j, t = _pair(kind, ("Adam", dict(lr=1e-2)) if kind == "modified"
                 else ("SGD", dict(learningrate=1e-2, momentum=0.9)))
    real = _real(32)
    w = None
    if weighted:                        # the last 5 rows pad the batch
        w = np.ones(32, np.float32)
        w[-5:] = 0.0
    k_d = jax.random.fold_in(jax.random.PRNGKey(j.seed + 100), 1)
    k_g = jax.random.fold_in(k_d, 3)
    noise_d = np.asarray(jax.random.normal(k_d, (32, NOISE)))
    noise_g = np.asarray(jax.random.normal(k_g, (32, NOISE)))
    g_before = _params(t.generator)
    j.d_params, j.d_opt, jdl = j._jit_d(
        j.g_params, j.d_params, j.d_opt, jnp.asarray(real),
        None if w is None else jnp.asarray(w), k_d)
    tdl = t.d_step(torch.from_numpy(real),
                   None if w is None else torch.from_numpy(w),
                   torch.from_numpy(noise_d))
    np.testing.assert_allclose(float(tdl), float(jdl), **TOL)
    _match(t.discriminator, j.d_params)
    for k, v in t.generator.state_dict().items():
        torch.testing.assert_close(v, g_before[k], rtol=0, atol=0)
    d_before = _params(t.discriminator)
    j.g_params, j.g_opt, jgl = j._jit_g(j.g_params, j.d_params, j.g_opt,
                                        32, k_g)
    tgl = t.g_step(torch.from_numpy(noise_g))
    np.testing.assert_allclose(float(tgl), float(jgl), **TOL)
    _match(t.generator, j.g_params)
    for k, v in t.discriminator.state_dict().items():
        torch.testing.assert_close(v, d_before[k], rtol=0, atol=0)


def _jax_noise(seed, batch, n_batches):
    """The noise JAX's ``train`` draws, in the order it draws it."""
    rng = jax.random.PRNGKey(seed + 100)
    for step in range(n_batches):
        rng = jax.random.fold_in(rng, step * 7 + 1)
        yield torch.from_numpy(np.asarray(jax.random.normal(
            rng, (batch, NOISE))))
        rng = jax.random.fold_in(rng, step * 7 + 3)
        yield torch.from_numpy(np.asarray(jax.random.normal(
            rng, (batch, NOISE))))


def test_train_matches_jax(orca_context):
    """80 rows at batch 32: three batches an epoch, the last padded (its
    real term weighted)."""
    j, t = _pair()
    real = _real(80)
    stream = _jax_noise(t.seed, 32, 6)
    t.noise = lambda b: next(stream)
    jstats = j.train({"x": real}, epochs=2, batch_size=32, verbose=False)
    tstats = t.train({"x": real}, epochs=2, batch_size=32, verbose=False)
    for key in ("g_loss", "d_loss"):
        np.testing.assert_allclose([s[key] for s in tstats],
                                   [s[key] for s in jstats], **TOL)
    assert t.step == j.step == 6
    _match(t.generator, j.g_params, dict(rtol=1e-4, atol=1e-4))
    _match(t.discriminator, j.d_params, dict(rtol=1e-4, atol=1e-4))
    samples = t.generate(10)
    assert samples.shape == (10, 2) and np.isfinite(samples).all()
    assert j.generate(10).shape == samples.shape
