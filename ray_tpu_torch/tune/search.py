"""Search algorithms: sequential config suggestion. Ported from
``ray_tpu/tune/search.py``: every searcher draws from the same ``random``
and numpy streams as the JAX one, so a seed gives the same suggestions.

Role parity: python/ray/tune/search/ — Searcher (searcher.py),
BasicVariantGenerator (basic_variant.py), and the external-searcher role
(hyperopt/optuna integrations) filled by a NATIVE TPE implementation
(tree-structured Parzen estimator, the algorithm HyperOpt's default uses):
no extra dependency, same adaptive behavior — after warmup it proposes
configs that maximize l(x)/g(x), the density ratio of good-trial vs
bad-trial parameter values.
"""

from __future__ import annotations

import math
import random
from typing import Any, Dict, List, Optional

import numpy as np

from ray_tpu_torch.tune import search_space as ss


class Searcher:
    """suggest() next config or None when exhausted; observe completions."""

    def __init__(self, metric: Optional[str] = None, mode: str = "max"):
        self.metric = metric
        self.mode = mode

    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        raise NotImplementedError

    def on_trial_complete(self, trial_id: str,
                          result: Optional[dict]) -> None:
        pass

    def register_suggestion(self, trial_id: str, config: dict) -> None:
        """Adopt an externally-recorded suggestion (experiment restore:
        the journal holds the config this searcher produced in a previous
        process; fold it in WITHOUT re-running suggest(), which would
        advance the rng differently — parity role: searcher save/restore,
        reference python/ray/tune/search/searcher.py)."""
        pass


class BasicVariantSearcher(Searcher):
    """Pre-generated grid x random variants (basic_variant.py role)."""

    def __init__(self, param_space: dict, num_samples: int, seed: int = 0,
                 **kw):
        super().__init__(**kw)
        self._variants = ss.generate_variants(param_space, num_samples, seed)
        self._i = 0

    def suggest(self, trial_id: str) -> Optional[dict]:
        if self._i >= len(self._variants):
            return None
        cfg = self._variants[self._i]
        self._i += 1
        return cfg

    def register_suggestion(self, trial_id: str, config: dict) -> None:
        self._i += 1  # the recorded config consumed this variant slot


class TPESearcher(Searcher):
    """Native tree-structured Parzen estimator over Domain params.

    Grid params are not supported (use BasicVariantSearcher); constants
    pass through. Numeric domains model good/bad observations with
    gaussian kernels in the domain's native (possibly log) space;
    categorical domains use smoothed good-trial frequencies.
    """

    def __init__(self, param_space: dict, num_samples: int,
                 metric: str, mode: str = "max", *, seed: int = 0,
                 n_initial: int = 8, gamma: float = 0.25,
                 n_candidates: int = 24):
        super().__init__(metric=metric, mode=mode)
        self.space = dict(param_space)
        for k, v in self.space.items():
            if isinstance(v, ss._Grid) or (
                    isinstance(v, dict) and "grid_search" in v):
                raise ValueError(
                    "TPESearcher does not take grid_search params; "
                    "use the default variant generator for grids")
        self.num_samples = num_samples
        self.n_initial = n_initial
        self.gamma = gamma
        self.n_candidates = n_candidates
        self._rng = random.Random(seed)
        self._np = np.random.default_rng(seed)
        self._suggested = 0
        self._pending: Dict[str, dict] = {}
        self._obs: List[tuple] = []   # (config, score)

    # -- domain helpers --------------------------------------------------
    @staticmethod
    def _warp(dom, x):
        return math.log(x) if isinstance(dom, ss._LogUniform) else float(x)

    @staticmethod
    def _unwarp(dom, u):
        if isinstance(dom, ss._LogUniform):
            return math.exp(u)
        if isinstance(dom, ss._RandInt):
            return int(round(u))
        return float(u)

    def _bounds(self, dom):
        """Bounds in WARPED space (log domains: _LogUniform.lo/hi are
        already log-space) — what _propose_numeric's kernels clip in."""
        if isinstance(dom, ss._LogUniform):
            return dom.lo, dom.hi
        if isinstance(dom, ss._Uniform):
            return dom.low, dom.high
        if isinstance(dom, ss._RandInt):
            return dom.low, dom.high - 1
        return None

    @staticmethod
    def _native_bounds(dom):
        """User-facing bounds, for post-unwarp clamping (exp(log(hi))
        can exceed hi by an ulp)."""
        if isinstance(dom, (ss._LogUniform, ss._Uniform)):
            return dom.low, dom.high
        if isinstance(dom, ss._RandInt):
            return dom.low, dom.high - 1
        return None

    def _propose_numeric(self, dom, good: List[float], bad: List[float]):
        lo, hi = self._bounds(dom)
        width = (hi - lo) or 1.0
        bw = max(width / max(len(good), 1) ** 0.5, width * 0.05)

        def density(xs, centers):
            if not centers:
                return np.full(len(xs), 1.0 / width)
            c = np.asarray(centers)[None, :]
            x = np.asarray(xs)[:, None]
            k = np.exp(-0.5 * ((x - c) / bw) ** 2) / (bw * math.sqrt(2 * math.pi))
            return k.mean(axis=1) + 1e-12

        # candidates drawn from the GOOD mixture (plus uniform exploration)
        cands = []
        for _ in range(self.n_candidates):
            if good and self._rng.random() < 0.8:
                cands.append(self._np.normal(self._rng.choice(good), bw))
            else:
                cands.append(self._rng.uniform(lo, hi))
        cands = np.clip(np.asarray(cands), lo, hi)
        score = density(cands, good) / density(cands, bad)
        return float(cands[int(np.argmax(score))])

    def _propose_choice(self, dom, good_vals: List[Any]):
        opts = dom.options
        counts = np.array([1.0 + sum(1 for g in good_vals if g == o)
                           for o in opts])
        return opts[int(self._np.choice(len(opts), p=counts / counts.sum()))]

    # -- Searcher API -----------------------------------------------------
    def suggest(self, trial_id: str) -> Optional[dict]:
        if self._suggested >= self.num_samples:
            return None
        self._suggested += 1
        cfg: Dict[str, Any] = {}
        warm = len(self._obs) >= self.n_initial
        if warm:
            ranked = sorted(self._obs, key=lambda t: -t[1])
            n_good = max(1, int(self.gamma * len(ranked)))
            good_cfgs = [c for c, _ in ranked[:n_good]]
            bad_cfgs = [c for c, _ in ranked[n_good:]]
        for k, v in self.space.items():
            if not isinstance(v, ss.Domain):
                cfg[k] = v
            elif not warm:
                cfg[k] = v.sample(self._rng)
            elif isinstance(v, ss._Choice):
                cfg[k] = self._propose_choice(
                    v, [c[k] for c in good_cfgs])
            elif self._bounds(v) is not None:
                u = self._propose_numeric(
                    v, [self._warp(v, c[k]) for c in good_cfgs],
                    [self._warp(v, c[k]) for c in bad_cfgs])
                lo, hi = self._native_bounds(v)
                # exp(log(hi)) can exceed hi by an ulp: clamp post-unwarp
                cfg[k] = min(max(self._unwarp(v, u), lo), hi)
            else:
                cfg[k] = v.sample(self._rng)
        self._pending[trial_id] = cfg
        return cfg

    def register_suggestion(self, trial_id: str, config: dict) -> None:
        self._suggested += 1
        self._pending[trial_id] = dict(config)

    def on_trial_complete(self, trial_id: str,
                          result: Optional[dict]) -> None:
        cfg = self._pending.pop(trial_id, None)
        if cfg is None or not result:
            return
        val = result.get(self.metric)
        if val is None:
            return
        score = float(val) if self.mode == "max" else -float(val)
        self._obs.append((cfg, score))


# ---------------------------------------------------------------------------
# Gaussian-process utilities (shared by GPSearcher and the PB2 scheduler)
# ---------------------------------------------------------------------------

def gp_posterior(X: np.ndarray, y: np.ndarray, Xq: np.ndarray,
                 length_scale: float = 0.2, noise: float = 1e-4):
    """RBF-kernel GP posterior (mean, variance) at query points. Inputs
    are expected normalized to [0,1]^d; y is standardized internally.
    Plain numpy — population sizes here are tens, not thousands."""
    y = np.asarray(y, np.float64)
    mu0, sd = y.mean(), y.std() or 1.0
    yn = (y - mu0) / sd

    def rbf(A, B):
        d2 = ((A[:, None, :] - B[None, :, :]) ** 2).sum(-1)
        return np.exp(-0.5 * d2 / length_scale ** 2)

    K = rbf(X, X) + noise * np.eye(len(X))
    Kq = rbf(Xq, X)
    sol = np.linalg.solve(K, yn)
    mean = Kq @ sol
    var = np.clip(1.0 + noise - (Kq * np.linalg.solve(K, Kq.T).T).sum(1),
                  1e-12, None)
    return mean * sd + mu0, var * sd * sd


class GPSearcher(Searcher):
    """Bayesian optimization over numeric Domains (parity role: the
    bayesopt/ax external searchers, search/bayesopt/): after warmup,
    propose the candidate maximizing GP-UCB in the warped unit cube.
    Categorical params fall back to good-frequency sampling (as TPE)."""

    def __init__(self, param_space: dict, num_samples: int, metric: str,
                 mode: str = "max", *, seed: int = 0, n_initial: int = 6,
                 ucb_kappa: float = 1.8, n_candidates: int = 256):
        super().__init__(metric=metric, mode=mode)
        self.space = dict(param_space)
        self.num_samples = num_samples
        self.n_initial = n_initial
        self.kappa = ucb_kappa
        self.n_candidates = n_candidates
        self._rng = random.Random(seed)
        self._np = np.random.default_rng(seed)
        self._suggested = 0
        self._pending: Dict[str, dict] = {}
        self._obs: List[tuple] = []      # (config, score)
        self._numeric = [k for k, v in self.space.items()
                         if isinstance(v, ss.Domain) and
                         not isinstance(v, ss._Choice)]

    def _warp01(self, k: str, v: float) -> float:
        dom = self.space[k]
        if isinstance(dom, ss._LogUniform):   # .lo/.hi are log-space
            return (math.log(v) - dom.lo) / ((dom.hi - dom.lo) or 1.0)
        if isinstance(dom, ss._Uniform):
            return (v - dom.low) / ((dom.high - dom.low) or 1.0)
        if isinstance(dom, ss._RandInt):
            return (v - dom.low) / ((dom.high - 1 - dom.low) or 1.0)
        return float(v)

    def _unwarp01(self, k: str, u: float):
        dom = self.space[k]
        if isinstance(dom, ss._LogUniform):
            return min(max(math.exp(dom.lo + u * (dom.hi - dom.lo)),
                           dom.low), dom.high)
        if isinstance(dom, ss._Uniform):
            return dom.low + u * (dom.high - dom.low)
        if isinstance(dom, ss._RandInt):
            return int(round(dom.low + u * (dom.high - 1 - dom.low)))
        return u

    def suggest(self, trial_id: str) -> Optional[dict]:
        if self._suggested >= self.num_samples:
            return None
        self._suggested += 1
        cfg: Dict[str, Any] = {}
        warm = len(self._obs) >= self.n_initial and self._numeric
        if warm:
            X = np.asarray([[self._warp01(k, c[k]) for k in self._numeric]
                            for c, _ in self._obs])
            y = np.asarray([s for _, s in self._obs])
            cands = self._np.uniform(
                0, 1, size=(self.n_candidates, len(self._numeric)))
            mu, var = gp_posterior(X, y, cands)
            best = cands[int(np.argmax(mu + self.kappa * np.sqrt(var)))]
        for k, v in self.space.items():
            if not isinstance(v, ss.Domain):
                cfg[k] = v
            elif isinstance(v, ss._Choice):
                if warm:
                    ranked = sorted(self._obs, key=lambda t: -t[1])
                    good = [c[k] for c, _ in
                            ranked[:max(1, len(ranked) // 4)]]
                    counts = np.array(
                        [1.0 + sum(1 for g in good if g == o)
                         for o in v.options])
                    cfg[k] = v.options[int(self._np.choice(
                        len(v.options), p=counts / counts.sum()))]
                else:
                    cfg[k] = v.sample(self._rng)
            elif warm and k in self._numeric:
                cfg[k] = self._unwarp01(
                    k, float(best[self._numeric.index(k)]))
            else:
                cfg[k] = v.sample(self._rng)
        self._pending[trial_id] = cfg
        return cfg

    def register_suggestion(self, trial_id: str, config: dict) -> None:
        self._suggested += 1
        self._pending[trial_id] = dict(config)

    def on_trial_complete(self, trial_id: str,
                          result: Optional[dict]) -> None:
        cfg = self._pending.pop(trial_id, None)
        if cfg is None or not result:
            return
        val = result.get(self.metric)
        if val is None:
            return
        score = float(val) if self.mode == "max" else -float(val)
        self._obs.append((cfg, score))


# ---------------------------------------------------------------------------
# Define-by-run searcher (optuna-style adapter)
# ---------------------------------------------------------------------------

class TrialHandle:
    """The object handed to a define-by-run space function (parity:
    optuna.Trial as consumed by OptunaSearch's define-by-run mode,
    reference tune/search/optuna/optuna_search.py). Each suggest_* call
    both DEFINES the parameter (name -> domain) and returns this trial's
    value for it."""

    def __init__(self, searcher: "DefineByRunSearcher", params: dict):
        self._searcher = searcher
        self.params = params

    def suggest_float(self, name: str, low: float, high: float,
                      *, log: bool = False) -> float:
        dom = ss.loguniform(low, high) if log else ss.uniform(low, high)
        return self._searcher._param(self, name, dom)

    def suggest_int(self, name: str, low: int, high: int) -> int:
        return int(self._searcher._param(
            self, name, ss.randint(low, high + 1)))

    def suggest_categorical(self, name: str, options: List[Any]) -> Any:
        return self._searcher._param(self, name, ss.choice(list(options)))


class DefineByRunSearcher(Searcher):
    """Search over a space declared BY RUNNING user code: the space
    function receives a TrialHandle, calls trial.suggest_*() for each
    parameter (possibly conditionally — branches may define different
    parameters), and returns extra fixed config (or None). Proposals per
    parameter use the TPE good/bad density ratio over whatever trials
    defined that parameter."""

    def __init__(self, space_fn: Callable, num_samples: int, metric: str,
                 mode: str = "max", *, seed: int = 0, n_initial: int = 8,
                 gamma: float = 0.25):
        super().__init__(metric=metric, mode=mode)
        self.space_fn = space_fn
        self.num_samples = num_samples
        self.n_initial = n_initial
        self.gamma = gamma
        self._rng = random.Random(seed)
        self._np = np.random.default_rng(seed)
        self._suggested = 0
        self._pending: Dict[str, dict] = {}
        self._obs: List[tuple] = []      # (params dict, score)
        # TPE machinery reused per-parameter
        self._tpe = TPESearcher({}, 0, metric=metric, mode=mode, seed=seed)

    def _param(self, handle: TrialHandle, name: str, dom) -> Any:
        if name in handle.params:
            return handle.params[name]
        warm = len(self._obs) >= self.n_initial
        relevant = [(p[name], s) for p, s in self._obs if name in p]
        if not warm or len(relevant) < 2:
            val = dom.sample(self._rng)
        elif isinstance(dom, ss._Choice):
            ranked = sorted(relevant, key=lambda t: -t[1])
            good = [v for v, _ in ranked[:max(1, int(self.gamma *
                                                     len(ranked)))]]
            val = self._tpe._propose_choice(dom, good)
        else:
            ranked = sorted(relevant, key=lambda t: -t[1])
            n_good = max(1, int(self.gamma * len(ranked)))
            goods = [self._tpe._warp(dom, v) for v, _ in ranked[:n_good]]
            bads = [self._tpe._warp(dom, v) for v, _ in ranked[n_good:]]
            val = self._tpe._unwarp(
                dom, self._tpe._propose_numeric(dom, goods, bads))
            lo, hi = self._tpe._native_bounds(dom)
            val = min(max(val, lo), hi)
        handle.params[name] = val
        return val

    def suggest(self, trial_id: str) -> Optional[dict]:
        if self._suggested >= self.num_samples:
            return None
        self._suggested += 1
        handle = TrialHandle(self, {})
        extra = self.space_fn(handle) or {}
        cfg = {**handle.params, **extra}
        self._pending[trial_id] = dict(handle.params)
        return cfg

    def register_suggestion(self, trial_id: str, config: dict) -> None:
        self._suggested += 1
        self._pending[trial_id] = dict(config)

    def on_trial_complete(self, trial_id: str,
                          result: Optional[dict]) -> None:
        params = self._pending.pop(trial_id, None)
        if params is None or not result:
            return
        val = result.get(self.metric)
        if val is None:
            return
        score = float(val) if self.mode == "max" else -float(val)
        self._obs.append((params, score))
