"""Search-space DSL (a copy of ``analytics_zoo_tpu/automl/hp.py``): the
reference's ``zoo.orca.automl.hp`` surface (uniform, quniform, loguniform,
qloguniform, randn, qrandn, randint, qrandint, choice, sample_from,
grid_search) on numpy, so a seed resolves a space into the same configs
in both packages."""

from __future__ import annotations

import math
from typing import Any, Callable, List, Sequence

import numpy as np


class SampleSpec:
    def sample(self, rng: np.random.RandomState) -> Any:
        raise NotImplementedError

    def grid_values(self):
        return None


class _Uniform(SampleSpec):
    def __init__(self, lower, upper, q=None):
        self.lower, self.upper, self.q = lower, upper, q

    def sample(self, rng):
        v = rng.uniform(self.lower, self.upper)
        if self.q:
            v = round(v / self.q) * self.q
        return float(np.clip(v, self.lower, self.upper))


class _LogUniform(SampleSpec):
    def __init__(self, lower, upper, q=None, base=10):
        self.lower, self.upper, self.q, self.base = lower, upper, q, base

    def sample(self, rng):
        lo = math.log(self.lower, self.base)
        hi = math.log(self.upper, self.base)
        v = self.base ** rng.uniform(lo, hi)
        if self.q:
            v = round(v / self.q) * self.q
        return float(np.clip(v, self.lower, self.upper))


class _Randn(SampleSpec):
    def __init__(self, mean=0.0, std=1.0, q=None):
        self.mean, self.std, self.q = mean, std, q

    def sample(self, rng):
        v = rng.normal(self.mean, self.std)
        if self.q:
            v = round(v / self.q) * self.q
        return float(v)


class _RandInt(SampleSpec):
    def __init__(self, lower, upper, q=1):
        self.lower, self.upper, self.q = lower, upper, q

    def sample(self, rng):
        v = rng.randint(self.lower, self.upper + 1)
        if self.q and self.q != 1:
            v = int(round(v / self.q) * self.q)
        return int(np.clip(v, self.lower, self.upper))


class _Choice(SampleSpec):
    def __init__(self, categories: Sequence):
        self.categories = list(categories)

    def sample(self, rng):
        return self.categories[rng.randint(0, len(self.categories))]


class _SampleFrom(SampleSpec):
    def __init__(self, func: Callable):
        self.func = func

    def sample(self, rng):
        try:
            return self.func(rng)
        except TypeError:
            return self.func(None)


class GridSearch(SampleSpec):
    def __init__(self, values: Sequence):
        self.values = list(values)

    def sample(self, rng):
        return self.values[rng.randint(0, len(self.values))]

    def grid_values(self):
        return self.values


def uniform(lower, upper):
    return _Uniform(lower, upper)


def quniform(lower, upper, q):
    return _Uniform(lower, upper, q)


def loguniform(lower, upper, base=10):
    return _LogUniform(lower, upper, base=base)


def qloguniform(lower, upper, q, base=10):
    return _LogUniform(lower, upper, q=q, base=base)


def randn(mean=0.0, std=1.0):
    return _Randn(mean, std)


def qrandn(mean, std, q):
    return _Randn(mean, std, q)


def randint(lower, upper):
    return _RandInt(lower, upper)


def qrandint(lower, upper, q=1):
    return _RandInt(lower, upper, q)


def choice(categories):
    return _Choice(categories)


def sample_from(func):
    return _SampleFrom(func)


def grid_search(values):
    return GridSearch(values)


def sample_config(space: dict, rng: np.random.RandomState) -> dict:
    """Resolve a search space dict into one concrete config."""
    out = {}
    for k, v in space.items():
        if isinstance(v, SampleSpec):
            out[k] = v.sample(rng)
        elif isinstance(v, dict):
            out[k] = sample_config(v, rng)
        else:
            out[k] = v
    return out


def grid_configs(space: dict) -> List[dict]:
    """Expand all grid_search axes into the cartesian product; non-grid
    SampleSpecs stay as specs (to be sampled per trial)."""
    import itertools
    grid_keys = [k for k, v in space.items()
                 if isinstance(v, SampleSpec) and v.grid_values() is not None]
    if not grid_keys:
        return [dict(space)]
    value_lists = [space[k].grid_values() for k in grid_keys]
    configs = []
    for combo in itertools.product(*value_lists):
        cfg = dict(space)
        cfg.update(dict(zip(grid_keys, combo)))
        configs.append(cfg)
    return configs
