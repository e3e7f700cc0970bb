"""GANEstimator (counterpart of ``analytics_zoo_tpu/orca/learn/
gan_estimator.py``): alternating discriminator and generator updates.

The generator and the discriminator are ``torch.nn`` modules (their
weights made when they are constructed; a lazy width is sized by one zero
noise row through the generator and its output through the
discriminator, as the JAX ``_build`` runs flax's init). Each batch of
``train`` takes ``d_steps`` discriminator steps, then ``g_steps``
generator steps, as the JAX estimator does; each step draws its noise,
``(batch, noise_dim)`` standard normal, from the estimator's own
``torch.Generator`` (seeded ``seed + 100``; JAX's keys give other bits).
:meth:`d_step` and :meth:`g_step` take the noise as an argument, so a
caller can feed the noise of its choice (a test, JAX's draws).

* **D step**: the fake batch is the generator's output under
  ``no_grad`` (detached, as JAX's ``stop_gradient``); the loss is
  ``d_loss(real_logits, fake_logits[, w])`` and only the discriminator's
  parameters move. A loss taking three arguments (found by
  ``inspect.signature``, as in JAX) gets the batch's mask weights ``w``,
  ones for a full batch; the default losses weight the real term by them
  (``_wmean``), which masks the rows that pad a short last batch.
* **G step**: ``g_loss(D(G(noise)))``, differentiated with respect to
  the generator's parameters alone; the discriminator runs in evaluation
  mode, so neither its parameters nor its state (BatchNorm statistics)
  change.

The modules run on ``cuda`` unless ``device="cpu"`` is given.
"""

from __future__ import annotations

import inspect
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ...common.context import resolve_device
from . import utils as learn_utils
from .optimizers.optimizers_impl import convert_optimizer


def _sigmoid_bce(logits, labels):
    """optax ``sigmoid_binary_cross_entropy``, elementwise."""
    return -labels * F.logsigmoid(logits) - (1.0 - labels) * F.logsigmoid(
        -logits)


def _wmean(per_row, w):
    """Mean over rows, weighted by ``w`` (None: every row counts)."""
    if w is None:
        return per_row.mean()
    flat = per_row.reshape(per_row.shape[0], -1).mean(-1)
    return (flat * w).sum() / w.sum().clamp_min(1e-8)


def gan_loss_fns(kind: str = "modified"):
    """``(g_loss, d_loss)``: ``"modified"`` is the non-saturating GAN loss,
    ``"wasserstein"`` the critic's."""
    if kind == "modified":
        def g_loss(fake_logits):
            return _sigmoid_bce(fake_logits,
                                torch.ones_like(fake_logits)).mean()

        def d_loss(real_logits, fake_logits, w=None):
            real = _sigmoid_bce(real_logits, torch.ones_like(real_logits))
            fake = _sigmoid_bce(fake_logits, torch.zeros_like(fake_logits))
            return _wmean(real, w) + fake.mean()
        return g_loss, d_loss
    if kind == "wasserstein":
        def g_loss(fake_logits):
            return -fake_logits.mean()

        def d_loss(real_logits, fake_logits, w=None):
            return fake_logits.mean() - _wmean(real_logits, w)
        return g_loss, d_loss
    raise ValueError(f"unknown gan loss {kind!r}")


class GANEstimator:
    """Parameters as the JAX estimator's: generator and discriminator
    modules, their losses and optimizers (anything ``convert_optimizer``
    takes), ``noise_dim``, ``d_steps``/``g_steps`` per batch, ``seed``;
    plus ``device``."""

    def __init__(self, generator_fn, discriminator_fn,
                 generator_loss_fn: Optional[Callable] = None,
                 discriminator_loss_fn: Optional[Callable] = None,
                 generator_optimizer="adam", discriminator_optimizer="adam",
                 noise_dim: int = 64, d_steps: int = 1, g_steps: int = 1,
                 seed: int = 0, model_dir: Optional[str] = None,
                 device=None):
        self.device = resolve_device(device)
        self.generator = generator_fn.to(self.device)
        self.discriminator = discriminator_fn.to(self.device)
        g_default, d_default = gan_loss_fns("modified")
        self.g_loss_fn = generator_loss_fn or g_default
        self.d_loss_fn = discriminator_loss_fn or d_default
        self._make_g_opt = convert_optimizer(generator_optimizer)
        self._make_d_opt = convert_optimizer(discriminator_optimizer)
        self.noise_dim = noise_dim
        self.d_steps = d_steps
        self.g_steps = g_steps
        self.seed = seed
        self.model_dir = model_dir
        self.g_opt: Optional[torch.optim.Optimizer] = None
        self.d_opt: Optional[torch.optim.Optimizer] = None
        self._takes_weights = len(inspect.signature(
            self.d_loss_fn).parameters) >= 3
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed + 100)
        self.step = 0

    def _build(self):
        """Size lazy widths (one zero noise row through G, its output
        through D) and make both optimizers."""
        noise = torch.zeros((1, self.noise_dim), device=self.device)
        with torch.no_grad():
            self.discriminator(self.generator(noise))
        self.g_opt = self._make_g_opt(list(self.generator.parameters()))
        self.d_opt = self._make_d_opt(list(self.discriminator.parameters()))

    def noise(self, batch_size: int) -> torch.Tensor:
        """A ``(batch_size, noise_dim)`` standard normal draw from the
        estimator's generator."""
        return torch.randn((batch_size, self.noise_dim),
                           generator=self._gen, device=self.device)

    def d_step(self, real: torch.Tensor, w: Optional[torch.Tensor],
               noise: torch.Tensor) -> torch.Tensor:
        """One discriminator update on ``real`` against ``G(noise)``;
        returns the loss (a device scalar)."""
        if self.d_opt is None:
            self._build()
        if w is None and self._takes_weights:
            w = torch.ones(real.shape[0], dtype=torch.float32,
                           device=real.device)
        self.generator.eval()
        with torch.no_grad():
            fake = self.generator(noise)
        self.discriminator.train()
        real_logits = self.discriminator(real)
        fake_logits = self.discriminator(fake)
        if self._takes_weights:
            loss = self.d_loss_fn(real_logits, fake_logits, w)
        else:
            loss = self.d_loss_fn(real_logits, fake_logits)
        params = list(self.discriminator.parameters())
        grads = torch.autograd.grad(loss, params)
        for p, g in zip(params, grads):
            p.grad = g
        self.d_opt.step()
        self.d_opt.zero_grad(set_to_none=True)
        return loss.detach()

    def g_step(self, noise: torch.Tensor) -> torch.Tensor:
        """One generator update through the (fixed) discriminator; returns
        the loss."""
        if self.g_opt is None:
            self._build()
        self.generator.train()
        self.discriminator.eval()
        loss = self.g_loss_fn(self.discriminator(self.generator(noise)))
        params = list(self.generator.parameters())
        grads = torch.autograd.grad(loss, params)
        for p, g in zip(params, grads):
            p.grad = g
        self.g_opt.step()
        self.g_opt.zero_grad(set_to_none=True)
        return loss.detach()

    def train(self, data, end_trigger=None, epochs: int = 1,
              batch_size: int = 32, verbose: bool = True
              ) -> List[Dict[str, float]]:
        """data: ``{'x': real_samples}``, an array or XShards. Returns one
        ``{"epoch", "g_loss", "d_loss", "time_s"}`` an epoch."""
        it = learn_utils.data_to_iterator(
            data if isinstance(data, dict) else {"x": data}, batch_size,
            shuffle=True, device=self.device)
        # one unshuffled batch drawn first, as the JAX estimator draws its
        # build sample: the shuffle's epoch counter advances with it, so
        # both estimators' epochs see the same batch order
        first = it.epoch(shuffle=False, prefetch=False)
        next(iter(first))
        getattr(first, "close", lambda: None)()
        if self.g_opt is None:
            self._build()
        stats = []
        for ep in range(epochs):
            t0 = time.time()
            g_losses, d_losses = [], []
            for batch in it.epoch():
                b = batch.to(self.device)
                real = b.x[0]
                for _ in range(self.d_steps):
                    d_losses.append(self.d_step(
                        real, b.w, self.noise(real.shape[0])))
                for _ in range(self.g_steps):
                    g_losses.append(self.g_step(self.noise(real.shape[0])))
                self.step += 1
            rec = {"epoch": ep + 1,
                   "g_loss": float(torch.stack(g_losses).mean().cpu()),
                   "d_loss": float(torch.stack(d_losses).mean().cpu()),
                   "time_s": round(time.time() - t0, 3)}
            stats.append(rec)
            if verbose:
                print(f"gan epoch {ep + 1}: {rec}")
        return stats

    def generate(self, num_samples: int = 16, seed: int = 0) -> np.ndarray:
        """``num_samples`` generated samples from noise drawn with
        ``seed``."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        noise = torch.randn((num_samples, self.noise_dim), generator=gen,
                            device=self.device)
        self.generator.eval()
        with torch.no_grad():
            return self.generator(noise).cpu().numpy()
