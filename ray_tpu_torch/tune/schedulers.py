"""Trial schedulers: decide continue/stop per reported result. Ported
from ``ray_tpu/tune/schedulers.py``: the same decisions over the same
reports.

Role parity: python/ray/tune/schedulers — FIFOScheduler, ASHA
(async_hyperband.py: rungs at grace_period * reduction_factor^k, cut the
bottom (1 - 1/rf) at each rung), MedianStoppingRule, and a
PopulationBasedTraining variant (pbt.py: exploit top quantile + explore by
mutation at perturbation intervals).
"""

from __future__ import annotations

import math
import random
from typing import Any, Callable, Dict, List, Optional

CONTINUE = "CONTINUE"
STOP = "STOP"


class TrialScheduler:
    def on_result(self, trial_id: str, iteration: int,
                  metrics: Dict[str, Any]) -> str:
        return CONTINUE

    def on_trial_complete(self, trial_id: str) -> None:
        pass


class FIFOScheduler(TrialScheduler):
    pass


class AsyncHyperBandScheduler(TrialScheduler):
    """ASHA: at each rung r (iteration = grace_period * rf^r), a trial
    continues only if it is in the top 1/rf of results recorded at that
    rung so far (async: no waiting for the full cohort)."""

    def __init__(self, metric: str = "score", mode: str = "max",
                 grace_period: int = 1, reduction_factor: int = 4,
                 max_t: int = 100):
        assert mode in ("max", "min")
        self.metric = metric
        self.mode = mode
        self.grace_period = grace_period
        self.rf = reduction_factor
        self.max_t = max_t
        self._rungs: Dict[int, List[float]] = {}
        r = grace_period
        while r < max_t:
            self._rungs[r] = []
            r *= reduction_factor

    def on_result(self, trial_id, iteration, metrics) -> str:
        value = metrics.get(self.metric)
        if value is None:
            return CONTINUE
        v = float(value) if self.mode == "max" else -float(value)
        if iteration >= self.max_t:
            return STOP
        rung = None
        for r in sorted(self._rungs, reverse=True):
            if iteration >= r:
                rung = r
                break
        if rung is None:
            return CONTINUE
        recorded = self._rungs[rung]
        recorded.append(v)
        if len(recorded) < self.rf:
            return CONTINUE  # not enough evidence yet
        cutoff_idx = max(0, math.ceil(len(recorded) / self.rf) - 1)
        cutoff = sorted(recorded, reverse=True)[cutoff_idx]
        return CONTINUE if v >= cutoff else STOP


class MedianStoppingRule(TrialScheduler):
    """Stop a trial whose best result is below the median of running
    averages at the same iteration (schedulers/median_stopping_rule.py)."""

    def __init__(self, metric: str = "score", mode: str = "max",
                 grace_period: int = 1, min_samples_required: int = 3):
        self.metric = metric
        self.mode = mode
        self.grace_period = grace_period
        self.min_samples = min_samples_required
        self._avgs: Dict[str, List[float]] = {}

    def on_result(self, trial_id, iteration, metrics) -> str:
        value = metrics.get(self.metric)
        if value is None:
            return CONTINUE
        v = float(value) if self.mode == "max" else -float(value)
        self._avgs.setdefault(trial_id, []).append(v)
        if iteration < self.grace_period or \
                len(self._avgs) < self.min_samples:
            return CONTINUE
        means = [sum(h) / len(h) for t, h in self._avgs.items()
                 if t != trial_id and h]
        if len(means) < self.min_samples - 1:
            return CONTINUE
        means.sort()
        median = means[len(means) // 2]
        mine = sum(self._avgs[trial_id]) / len(self._avgs[trial_id])
        return CONTINUE if mine >= median else STOP


class HyperBandScheduler(TrialScheduler):
    """HyperBand, asynchronous form (parity: schedulers/hyperband.py +
    hb_bohb.py bracketing): incoming trials round-robin across s_max+1
    brackets; bracket s starts culling only after grace_period * rf^s
    iterations (aggressive brackets cut early, conservative ones late),
    and within a bracket each rung keeps the top 1/rf of recorded
    results. This keeps HyperBand's exploration-vs-exploitation spread
    across brackets without the synchronous variant's pause/resume
    machinery (our report-driven control point decides continue/stop
    only, like ASHA's — the reference's async path does the same)."""

    def __init__(self, metric: str = "score", mode: str = "max",
                 grace_period: int = 1, reduction_factor: int = 3,
                 max_t: int = 81):
        assert mode in ("max", "min")
        self.metric = metric
        self.mode = mode
        self.max_t = max_t
        self.rf = reduction_factor
        s_max = 0
        t = grace_period
        while t * reduction_factor <= max_t:
            s_max += 1
            t *= reduction_factor
        # bracket s: ASHA with grace grace_period * rf^s
        self._brackets = [
            AsyncHyperBandScheduler(
                metric=metric, mode=mode,
                grace_period=grace_period * reduction_factor ** s,
                reduction_factor=reduction_factor, max_t=max_t)
            for s in range(s_max + 1)]
        self._assignment: Dict[str, int] = {}
        self._next = 0

    def _bracket_of(self, trial_id: str) -> "AsyncHyperBandScheduler":
        if trial_id not in self._assignment:
            self._assignment[trial_id] = self._next % len(self._brackets)
            self._next += 1
        return self._brackets[self._assignment[trial_id]]

    def on_result(self, trial_id, iteration, metrics) -> str:
        return self._bracket_of(trial_id).on_result(
            trial_id, iteration, metrics)

    def on_trial_complete(self, trial_id: str) -> None:
        self._bracket_of(trial_id).on_trial_complete(trial_id)


class PopulationBasedTraining(TrialScheduler):
    """PBT-lite: at each perturbation interval, bottom-quantile trials are
    told to EXPLOIT (load top-quantile config + checkpoint, with mutated
    hyperparameters). The controller applies the returned decision payload
    (schedulers/pbt.py role; in-place exploit rather than actor swap)."""

    def __init__(self, metric: str = "score", mode: str = "max",
                 perturbation_interval: int = 5,
                 hyperparam_mutations: Optional[Dict[str, Any]] = None,
                 quantile_fraction: float = 0.25, seed: int = 0):
        self.metric = metric
        self.mode = mode
        self.interval = perturbation_interval
        self.mutations = hyperparam_mutations or {}
        self.quantile = quantile_fraction
        self._rng = random.Random(seed)
        self._latest: Dict[str, float] = {}
        self._payload: Dict[str, dict] = {}   # trial -> exploit payload
        self._configs: Dict[str, dict] = {}
        self._checkpoints: Dict[str, Any] = {}

    def record_state(self, trial_id: str, config: dict, checkpoint) -> None:
        self._configs[trial_id] = dict(config)
        if checkpoint is not None:
            self._checkpoints[trial_id] = checkpoint

    def pop_exploit(self, trial_id: str) -> Optional[dict]:
        return self._payload.pop(trial_id, None)

    def _mutate(self, config: dict) -> dict:
        out = dict(config)
        for k, spec in self.mutations.items():
            if callable(spec):
                out[k] = spec()
            elif isinstance(spec, list):
                out[k] = self._rng.choice(spec)
            elif k in out and isinstance(out[k], (int, float)):
                out[k] = out[k] * self._rng.choice([0.8, 1.2])
        return out

    def on_result(self, trial_id, iteration, metrics) -> str:
        value = metrics.get(self.metric)
        if value is None:
            return CONTINUE
        v = float(value) if self.mode == "max" else -float(value)
        self._latest[trial_id] = v
        if iteration % self.interval != 0 or len(self._latest) < 4:
            return CONTINUE
        ranked = sorted(self._latest.items(), key=lambda kv: kv[1])
        k = max(1, int(len(ranked) * self.quantile))
        bottom = {t for t, _ in ranked[:k]}
        top = [t for t, _ in ranked[-k:]]
        if trial_id in bottom and top:
            src = self._rng.choice(top)
            if src in self._configs:
                self._payload[trial_id] = {
                    "config": self._mutate(self._configs[src]),
                    "checkpoint": self._checkpoints.get(src),
                }
        return CONTINUE


class PB2(PopulationBasedTraining):
    """Population-Based Bandits (parity: schedulers/pb2.py): exploit like
    PBT, but EXPLORE by a GP-bandit over the numeric hyperparameters —
    fit a Gaussian process on (config -> latest reward) across the
    population and pick the in-bounds candidate maximizing UCB, instead
    of multiplying by a random factor. Categorical/list mutations fall
    back to PBT-style choice."""

    def __init__(self, metric: str = "score", mode: str = "max",
                 perturbation_interval: int = 5,
                 hyperparam_bounds: Optional[Dict[str, tuple]] = None,
                 hyperparam_mutations: Optional[Dict[str, Any]] = None,
                 quantile_fraction: float = 0.25, seed: int = 0,
                 ucb_kappa: float = 1.5, n_candidates: int = 64):
        super().__init__(metric=metric, mode=mode,
                         perturbation_interval=perturbation_interval,
                         hyperparam_mutations=hyperparam_mutations,
                         quantile_fraction=quantile_fraction, seed=seed)
        self.bounds = dict(hyperparam_bounds or {})
        self.kappa = ucb_kappa
        self.n_candidates = n_candidates

    def _mutate(self, config: dict) -> dict:
        import numpy as np

        from ray_tpu_torch.tune.search import gp_posterior
        out = super()._mutate(config)   # lists/callables PBT-style
        keys = [k for k in self.bounds if k in config and
                isinstance(config.get(k), (int, float))]
        if not keys:
            return out
        # Observations: every trial's latest score at its current config.
        X, y = [], []
        for tid, score in self._latest.items():
            cfg = self._configs.get(tid)
            if cfg is None or not all(k in cfg for k in keys):
                continue
            X.append([self._norm(k, float(cfg[k])) for k in keys])
            y.append(score)
        rng = np.random.default_rng(self._rng.randrange(1 << 31))
        cands = rng.uniform(0.0, 1.0, size=(self.n_candidates, len(keys)))
        if len(X) >= 2:
            mu, var = gp_posterior(np.asarray(X), np.asarray(y), cands)
            best = int(np.argmax(mu + self.kappa * np.sqrt(var)))
        else:
            best = 0   # cold start: random in-bounds point
        for i, k in enumerate(keys):
            lo, hi = self.bounds[k]
            v = lo + float(cands[best, i]) * (hi - lo)
            out[k] = int(round(v)) if isinstance(config[k], int) else v
        return out

    def _norm(self, k: str, v: float) -> float:
        lo, hi = self.bounds[k]
        return (v - lo) / (hi - lo or 1.0)
