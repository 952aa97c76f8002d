"""Evolution Strategies (parity: rllib/algorithms/es/es.py — the OpenAI-ES
scheme): gradient-free search over policy parameters. Ported from
``ray_tpu/rl/algorithms/es.py``.

Each iteration broadcasts the CURRENT weights once; workers regenerate
their antithetic perturbations from a SEED (the reference's
shared-noise-table trick — only seeds and fitness scalars cross the wire,
never perturbed weight copies), evaluate an episode each way, and the
driver applies the rank-weighted update theta += alpha/(n*sigma) *
sum(F_i * eps_i).

The flat vector theta, the perturbations and the update are numpy on the
driver, line for line the JAX version's. The workers are actors of the
port's runtime; each runs its greedy forward on ``config.device`` (``None``
= the card), with the perturbed weights put there once an episode. theta's
layout is ``jax.tree.leaves``' order (dict keys sorted at every level,
lists in order), so a seed's perturbation lands on the same weights as in
the JAX package.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

import ray_tpu_torch as rt
from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.models.convert import rl_params_to_numpy
from ray_tpu_torch.rl.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rl.env import episode_stats_of, make_env
from ray_tpu_torch.rl.learner import seeded_init
from ray_tpu_torch.rl.module import make_module
from ray_tpu_torch.rl.rollout import place_params


class ESConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.num_perturbations = 16      # antithetic pairs per iteration
        self.sigma = 0.1                 # perturbation scale
        self.lr = 0.05
        self.episode_horizon = 200
        self.weight_decay = 0.005
        self.algo_class = ES


def _leaves(tree) -> list:
    """A tree's leaves in ``jax.tree.leaves``' order: dict keys sorted at
    every level, lists in order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _flatten(params) -> np.ndarray:
    return np.concatenate([np.asarray(x).ravel() for x in _leaves(params)])


def _unflatten(params_template, flat: np.ndarray):
    """``flat`` cut into a tree shaped as ``params_template`` (numpy leaves
    in its dtypes), the inverse of ``_flatten``."""
    off = 0

    def build(tree):
        nonlocal off
        if isinstance(tree, dict):
            return {k: build(tree[k]) for k in sorted(tree)}
        if isinstance(tree, (list, tuple)):
            return [build(v) for v in tree]
        leaf = np.asarray(tree)
        out = flat[off:off + leaf.size].reshape(leaf.shape).astype(
            leaf.dtype)
        off += leaf.size
        return out

    return build(params_template)


class ESWorker:
    """Actor: evaluates seed-derived antithetic perturbations, the policy's
    greedy forward on ``device`` (``None`` = the card)."""

    def __init__(self, env: Any, module_spec: dict, horizon: int,
                 sigma: float, seed: int = 0, device=None):
        self.device = resolve_device(device)
        self.env = make_env(env, num_envs=1, seed=seed)
        self.module = make_module(module_spec)
        self.horizon = horizon
        self.sigma = sigma
        self._template = rl_params_to_numpy(self.module.init(
            torch.Generator().manual_seed(0), "cpu"))
        self._dim = _flatten(self._template).size

    @torch.no_grad()
    def _episode_return(self, flat: np.ndarray) -> float:
        params = place_params(_unflatten(self._template, flat), self.module,
                              self.device)
        obs = self.env.vector_reset(seed=None)
        total = 0.0
        for _ in range(self.horizon):
            a = self.module.greedy_actions(params, obs).cpu().numpy()
            obs, rew, done, _ = self.env.vector_step(a)
            total += float(rew[0])
            if bool(done[0]):
                break
        return total

    def evaluate(self, flat_weights: np.ndarray,
                 seeds: List[int]) -> List[tuple]:
        """-> [(seed, F(theta+sigma*eps), F(theta-sigma*eps)), ...]."""
        out = []
        for s in seeds:
            eps = np.random.default_rng(s).standard_normal(
                self._dim).astype(np.float32)
            out.append((s,
                        self._episode_return(flat_weights + self.sigma * eps),
                        self._episode_return(flat_weights - self.sigma * eps)))
        return out

    def episode_stats(self) -> dict:
        return episode_stats_of(self.env)


class ES(Algorithm):
    def setup(self) -> None:
        cfg: ESConfig = self.config  # type: ignore[assignment]
        self.module = make_module(self.module_spec)
        params = rl_params_to_numpy(seeded_init(self.module.init, cfg.seed,
                                                "cpu"))
        self._template = params
        self.theta = _flatten(params)
        self._rng = np.random.default_rng(cfg.seed)
        worker_cls = rt.remote(ESWorker)
        self.workers = [
            worker_cls.options(num_cpus=1).remote(
                cfg.env, self.module_spec, cfg.episode_horizon, cfg.sigma,
                seed=cfg.seed + i + 1, device=self.device)
            for i in range(max(1, cfg.num_rollout_workers))]

    def training_step(self) -> Dict[str, Any]:
        cfg: ESConfig = self.config  # type: ignore[assignment]
        n = cfg.num_perturbations
        seeds = [int(s) for s in self._rng.integers(0, 1 << 31, n)]
        chunks = np.array_split(np.asarray(seeds), len(self.workers))
        futs = [w.evaluate.remote(self.theta, [int(x) for x in chunk])
                for w, chunk in zip(self.workers, chunks) if len(chunk)]
        results = [r for rs in rt.get(futs, timeout=600) for r in rs]
        # rank transform (centered): robust to reward scale
        pos = np.asarray([fp for _, fp, _ in results])
        neg = np.asarray([fn for _, _, fn in results])
        scores = pos - neg
        ranks = np.empty(len(scores))
        ranks[np.argsort(scores)] = np.arange(len(scores))
        weights = ranks / max(len(scores) - 1, 1) - 0.5
        grad = np.zeros_like(self.theta)
        for (seed, _fp, _fn), w in zip(results, weights):
            eps = np.random.default_rng(seed).standard_normal(
                self.theta.size).astype(np.float32)
            grad += w * eps
        grad /= len(results) * cfg.sigma
        self.theta = (1.0 - cfg.weight_decay) * self.theta + cfg.lr * grad
        self._timesteps_total += 2 * len(results) * cfg.episode_horizon
        return {
            "episode_reward_mean": float(np.mean((pos + neg) / 2.0)),
            "episode_reward_max": float(max(pos.max(), neg.max())),
            "info/grad_norm": float(np.linalg.norm(grad)),
        }

    def get_policy_params(self):
        """The policy's weights as a numpy tree in the JAX layout."""
        return _unflatten(self._template, self.theta)

    def get_state(self) -> dict:
        return {"theta": self.theta}

    def set_state(self, state: dict) -> None:
        self.theta = state["theta"]

    def stop(self) -> None:
        for w in self.workers:
            try:
                rt.kill(w)
            except Exception:
                pass
