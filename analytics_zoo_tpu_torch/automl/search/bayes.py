"""Dependency-free Gaussian-process expected-improvement point picker (a
copy of ``analytics_zoo_tpu/automl/search/bayes.py``).

The reference's BayesRecipe routes its search space through Ray Tune's
``bayesopt`` searcher (the external ``bayes_opt`` package:
pyzoo/zoo/automl/search/ray_tune_search_engine.py:176, recipe
pyzoo/zoo/zouwu/config/recipe.py:568). Here the same role is ~120 lines of
numpy: a GP posterior with an RBF kernel over the unit hypercube and an
expected-improvement acquisition maximised over random candidates. It
plugs into TPUSearchEngine's ``search_alg="bayes"`` sequential loop.

Scope matches the reference's: continuous/integer axes (hp.uniform,
hp.loguniform, hp.randint and their q-variants) are modelled by the GP;
categorical axes keep random sampling (bayes_opt has the same
continuous-only limitation, which is why BayesRecipe expresses integer
params as ``*_float`` uniforms).
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np

from .. import hp as hp_dsl


def _norm_cdf(z: np.ndarray) -> np.ndarray:
    return 0.5 * (1.0 + np.vectorize(math.erf)(z / math.sqrt(2.0)))


def _norm_pdf(z: np.ndarray) -> np.ndarray:
    return np.exp(-0.5 * z * z) / math.sqrt(2.0 * math.pi)


class GPEIPicker:
    """GP posterior + EI acquisition over [0, 1]^d (minimisation)."""

    def __init__(self, dim: int, length_scale: float = 0.25,
                 noise: float = 1e-6):
        self.dim = dim
        self.length_scale = length_scale
        self.noise = noise
        self._x: List[np.ndarray] = []
        self._y: List[float] = []

    def observe(self, x: Sequence[float], y: float):
        if not math.isfinite(y):
            if not self._y:
                # failed FIRST trial: nothing to anchor a penalty on —
                # substituting any constant (e.g. 0) would become a fake
                # best for positive metrics and poison EI; skip it
                return
            # failed trial: score it at the worst observed value so the GP
            # steers away without poisoning the posterior with inf
            y = max(self._y)
        self._x.append(np.asarray(x, np.float64))
        self._y.append(float(y))

    def _kernel(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        d2 = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
        return np.exp(-0.5 * d2 / (self.length_scale ** 2))

    def suggest(self, rng: np.random.RandomState,
                n_candidates: int = 512) -> np.ndarray:
        """Return the unit-cube point with the best expected improvement."""
        cand = rng.rand(n_candidates, self.dim)
        if len(self._x) < 2:
            return cand[0]
        x = np.stack(self._x)
        y = np.asarray(self._y)
        mu_y, sd_y = float(y.mean()), float(y.std() + 1e-12)
        yn = (y - mu_y) / sd_y
        k = self._kernel(x, x) + self.noise * np.eye(len(x))
        try:
            chol = np.linalg.cholesky(k)
        except np.linalg.LinAlgError:
            chol = np.linalg.cholesky(k + 1e-4 * np.eye(len(x)))
        alpha = np.linalg.solve(chol.T, np.linalg.solve(chol, yn))
        kc = self._kernel(cand, x)                      # (n_cand, n_obs)
        mu = kc @ alpha
        v = np.linalg.solve(chol, kc.T)                 # (n_obs, n_cand)
        var = np.clip(1.0 - (v * v).sum(0), 1e-12, None)
        sigma = np.sqrt(var)
        best = yn.min()
        z = (best - mu) / sigma
        ei = sigma * (z * _norm_cdf(z) + _norm_pdf(z))
        return cand[int(np.argmax(ei))]


class SpaceCodec:
    """Maps a search space's GP-modelled axes onto the unit hypercube.

    Continuous/integer axes (_Uniform/_LogUniform/_RandInt) are encoded;
    every other axis (choice, grid, sample_from, statics) is left to the
    caller's per-trial random sampling, mirroring bayes_opt's
    continuous-only domain.
    """

    def __init__(self, space: dict):
        self.axes: List[Tuple[str, object]] = []
        for key, spec in space.items():
            if isinstance(spec, (hp_dsl._Uniform, hp_dsl._LogUniform,
                                 hp_dsl._RandInt)):
                self.axes.append((key, spec))

    @property
    def dim(self) -> int:
        return len(self.axes)

    def encode(self, config: dict) -> np.ndarray:
        out = np.zeros(len(self.axes))
        for i, (key, spec) in enumerate(self.axes):
            v = float(config[key])
            if isinstance(spec, hp_dsl._LogUniform):
                lo = math.log(spec.lower)
                hi = math.log(spec.upper)
                out[i] = (math.log(max(v, 1e-300)) - lo) / (hi - lo + 1e-12)
            else:
                out[i] = (v - spec.lower) / (spec.upper - spec.lower + 1e-12)
        return np.clip(out, 0.0, 1.0)

    def decode_into(self, unit: np.ndarray, config: dict) -> dict:
        for i, (key, spec) in enumerate(self.axes):
            u = float(np.clip(unit[i], 0.0, 1.0))
            if isinstance(spec, hp_dsl._LogUniform):
                lo = math.log(spec.lower)
                hi = math.log(spec.upper)
                v = math.exp(lo + u * (hi - lo))
            else:
                v = spec.lower + u * (spec.upper - spec.lower)
            if isinstance(spec, hp_dsl._RandInt):
                q = getattr(spec, "q", 1) or 1
                v = int(round(v / q) * q) if q != 1 else int(round(v))
                v = int(np.clip(v, spec.lower, spec.upper))
            elif getattr(spec, "q", None):
                # q-rounding can push past the declared bounds (e.g.
                # quniform(0, 11, 3) at u~1 rounds 11 -> 12); clip like
                # _Uniform.sample does
                v = float(np.clip(round(v / spec.q) * spec.q,
                                  spec.lower, spec.upper))
            config[key] = v
        return config
