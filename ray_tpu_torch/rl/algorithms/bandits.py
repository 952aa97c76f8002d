"""Contextual bandits: LinUCB and Linear Thompson Sampling.

Role parity: rllib/algorithms/bandit (bandit_torch_policy + the
LinUCB/LinTS exploration models): per-arm linear payoff models with
closed-form ridge updates — no gradient loop at all — and exploration by
upper confidence bound (LinUCB) or posterior sampling (LinTS).

Environment protocol (ContextualBanditEnv): ``context() -> ndarray`` and
``pull(arm) -> reward``. The driver keeps per-arm sufficient statistics
(A = I*lambda + sum x x^T, b = sum r x) — batched rank-1 updates in
numpy; a chip adds nothing at these sizes.

A copy of ``ray_tpu/rl/algorithms/bandits.py`` on the port's ``Algorithm``
(the port imports nothing of the JAX package). Like the JAX version,
``Bandit`` skips the base init: it runs on the host only, takes no device
and so never raises for want of a card.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

from ray_tpu_torch.rl.algorithm import Algorithm, AlgorithmConfig


class ContextualBanditEnv:
    """Protocol + a synthetic linear instance for tests."""

    def __init__(self, num_arms: int = 4, context_dim: int = 8,
                 noise: float = 0.1, seed: int = 0):
        rng = np.random.default_rng(seed)
        self.num_arms = num_arms
        self.context_dim = context_dim
        self.noise = noise
        self._rng = rng
        self.true_theta = rng.normal(size=(num_arms, context_dim))
        self.true_theta /= np.linalg.norm(self.true_theta, axis=1,
                                          keepdims=True)
        self._ctx: Optional[np.ndarray] = None

    def context(self) -> np.ndarray:
        self._ctx = self._rng.normal(size=self.context_dim)
        self._ctx /= np.linalg.norm(self._ctx)
        return self._ctx

    def pull(self, arm: int) -> float:
        r = float(self.true_theta[arm] @ self._ctx)
        return r + float(self._rng.normal(scale=self.noise))

    def best_reward(self) -> float:
        return float(max(self.true_theta[a] @ self._ctx
                         for a in range(self.num_arms)))


class BanditConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.exploration = "ucb"     # "ucb" (LinUCB) | "ts" (LinTS)
        self.alpha = 1.0             # UCB width / TS posterior scale
        self.ridge = 1.0
        self.steps_per_iter = 100
        self.env_fn = ContextualBanditEnv
        self.algo_class = Bandit


class Bandit(Algorithm):
    # Bandits have no gym probe / module spec: override the base init.
    def __init__(self, config: BanditConfig):
        self.config = config
        self.iteration = 0
        self._timesteps_total = 0
        self.setup()

    def setup(self) -> None:
        cfg: BanditConfig = self.config  # type: ignore[assignment]
        self.env = cfg.env_fn() if callable(cfg.env_fn) else cfg.env_fn
        d = self.env.context_dim
        k = self.env.num_arms
        self.A = np.stack([np.eye(d) * cfg.ridge for _ in range(k)])
        self.b = np.zeros((k, d))
        self._rng = np.random.default_rng(cfg.seed)
        self._regret_total = 0.0

    def _select(self, x: np.ndarray) -> int:
        cfg: BanditConfig = self.config  # type: ignore[assignment]
        scores = np.empty(self.env.num_arms)
        for a in range(self.env.num_arms):
            A_inv = np.linalg.inv(self.A[a])
            theta = A_inv @ self.b[a]
            if cfg.exploration == "ts":
                theta = self._rng.multivariate_normal(
                    theta, cfg.alpha ** 2 * A_inv)
                scores[a] = theta @ x
            else:
                scores[a] = theta @ x + cfg.alpha * np.sqrt(x @ A_inv @ x)
        return int(np.argmax(scores))

    def training_step(self) -> Dict[str, Any]:
        cfg: BanditConfig = self.config  # type: ignore[assignment]
        rewards, regrets = [], []
        for _ in range(cfg.steps_per_iter):
            x = self.env.context()
            arm = self._select(x)
            r = self.env.pull(arm)
            self.A[arm] += np.outer(x, x)
            self.b[arm] += r * x
            rewards.append(r)
            if hasattr(self.env, "best_reward"):
                regrets.append(self.env.best_reward() -
                               float(self.env.true_theta[arm] @ x))
        self._timesteps_total += cfg.steps_per_iter
        self._regret_total += float(np.sum(regrets)) if regrets else 0.0
        out = {"episode_reward_mean": float(np.mean(rewards))}
        if regrets:
            out["info/regret_per_step"] = float(np.mean(regrets))
            out["info/regret_total"] = self._regret_total
        return out

    def get_state(self) -> dict:
        return {"A": self.A, "b": self.b}

    def set_state(self, state: dict) -> None:
        self.A, self.b = state["A"], state["b"]

    def stop(self) -> None:
        pass
