"""Search-space primitives + variant generation. Ported from
``ray_tpu/tune/search_space.py``: the same domains draw from the same
``random.Random`` stream, so a seed gives the JAX package's variants.

Role parity: python/ray/tune/search/sample.py (uniform/choice/... domains)
and search/basic_variant.py (BasicVariantGenerator: grid cross-product x
num_samples random draws).
"""

from __future__ import annotations

import itertools
import random
from typing import Any, Callable, Dict, List


class Domain:
    def sample(self, rng: random.Random) -> Any:
        raise NotImplementedError


class _Choice(Domain):
    def __init__(self, options):
        self.options = list(options)

    def sample(self, rng):
        return rng.choice(self.options)


class _Uniform(Domain):
    def __init__(self, low, high):
        self.low, self.high = low, high

    def sample(self, rng):
        return rng.uniform(self.low, self.high)


class _LogUniform(Domain):
    def __init__(self, low, high):
        import math
        self.low, self.high = low, high      # native bounds (clamping)
        self.lo, self.hi = math.log(low), math.log(high)  # warped

    def sample(self, rng):
        import math
        return math.exp(rng.uniform(self.lo, self.hi))


class _RandInt(Domain):
    def __init__(self, low, high):
        self.low, self.high = low, high

    def sample(self, rng):
        return rng.randrange(self.low, self.high)


class _RandN(Domain):
    def __init__(self, mean, sd):
        self.mean, self.sd = mean, sd

    def sample(self, rng):
        return rng.gauss(self.mean, self.sd)


class _SampleFrom(Domain):
    def __init__(self, fn: Callable):
        self.fn = fn

    def sample(self, rng):
        return self.fn(None)


class _Grid:
    def __init__(self, values):
        self.values = list(values)


def choice(options) -> Domain:
    return _Choice(options)


def uniform(low: float, high: float) -> Domain:
    return _Uniform(low, high)


def loguniform(low: float, high: float) -> Domain:
    return _LogUniform(low, high)


def randint(low: int, high: int) -> Domain:
    return _RandInt(low, high)


def randn(mean: float = 0.0, sd: float = 1.0) -> Domain:
    return _RandN(mean, sd)


def sample_from(fn: Callable) -> Domain:
    return _SampleFrom(fn)


def grid_search(values) -> dict:
    return {"grid_search": list(values)}


def generate_variants(param_space: Dict[str, Any], num_samples: int = 1,
                      seed: int = 0) -> List[Dict[str, Any]]:
    """Cross-product of grid axes x num_samples draws of stochastic axes
    (parity: BasicVariantGenerator semantics)."""
    rng = random.Random(seed)
    grid_keys: List[str] = []
    grid_vals: List[list] = []
    for k, v in param_space.items():
        if isinstance(v, dict) and set(v.keys()) == {"grid_search"}:
            grid_keys.append(k)
            grid_vals.append(v["grid_search"])
    combos = list(itertools.product(*grid_vals)) if grid_keys else [()]
    out = []
    for _ in range(num_samples):
        for combo in combos:
            cfg = {}
            for k, v in param_space.items():
                if k in grid_keys:
                    cfg[k] = combo[grid_keys.index(k)]
                elif isinstance(v, Domain):
                    cfg[k] = v.sample(rng)
                elif isinstance(v, dict) and "grid_search" not in v:
                    cfg[k] = generate_variants(v, 1, rng.randrange(1 << 30))[0]
                else:
                    cfg[k] = v
            out.append(cfg)
    return out
