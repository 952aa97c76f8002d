"""Environments: vectorized-first.

A copy of ``ray_tpu/rl/env.py`` (the port imports nothing of the JAX
package). Role parity: rllib/env — BaseEnv, VectorEnv, MultiAgentEnv, gym
wrappers. The native representation is a *vectorized* env stepping N
sub-envs as batched numpy on the host, so a policy forward is one batched
call on the device instead of N python loops.

One difference from the JAX file: there the base ``vector_reset`` and
``vector_step`` stubs sit inside ``episode_stats_of``, after its return, so
``VectorEnv`` never has them; here they are ``VectorEnv``'s. The concrete
envs override both, so nothing they compute changes.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np

from ray_tpu_torch.core import serialization
from ray_tpu_torch.core.api import in_process_runtime


class VectorEnv:
    """N synchronized sub-envs; auto-resets finished sub-envs."""

    num_envs: int
    observation_dim: int
    num_actions: int                # discrete; -1 => continuous
    action_dim: int = 1             # continuous action dims (Box envs)
    action_low = -1.0               # bounds: scalar or per-dim array [k]
    action_high = 1.0

    def vector_reset(self, seed: Optional[int] = None) -> np.ndarray:
        raise NotImplementedError

    def vector_step(self, actions: np.ndarray
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, Dict]:
        """-> (obs [N, D], rewards [N], dones [N], infos)."""
        raise NotImplementedError


def episode_stats_of(env) -> dict:
    """Shared reward-window stats for collectors (rollout_worker metrics
    role): mean over the last 100 completed episodes."""
    rets = getattr(env, "completed_returns", [])
    if not rets:
        return {"episode_reward_mean": float("nan"), "episodes": 0}
    return {"episode_reward_mean": float(np.mean(rets[-100:])),
            "episodes": len(rets)}


class CartPoleVectorEnv(VectorEnv):
    """Pure-numpy vectorized CartPole-v1 dynamics (classic control task;
    same physics constants as the standard benchmark), used for learning
    gates without per-env python object overhead."""

    GRAVITY = 9.8
    CART_MASS = 1.0
    POLE_MASS = 0.1
    TOTAL_MASS = CART_MASS + POLE_MASS
    LENGTH = 0.5
    POLEMASS_LENGTH = POLE_MASS * LENGTH
    FORCE_MAG = 10.0
    TAU = 0.02
    THETA_LIMIT = 12 * 2 * np.pi / 360
    X_LIMIT = 2.4
    MAX_STEPS = 500

    def __init__(self, num_envs: int = 16, seed: int = 0):
        self.num_envs = num_envs
        self.observation_dim = 4
        self.num_actions = 2
        self._rng = np.random.default_rng(seed)
        self._state = np.zeros((num_envs, 4), dtype=np.float64)
        self._steps = np.zeros(num_envs, dtype=np.int64)
        self.episode_returns = np.zeros(num_envs)
        self.completed_returns: list = []

    def _reset_indices(self, idx: np.ndarray) -> None:
        self._state[idx] = self._rng.uniform(-0.05, 0.05, (len(idx), 4))
        self._steps[idx] = 0
        self.episode_returns[idx] = 0.0

    def vector_reset(self, seed: Optional[int] = None) -> np.ndarray:
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._reset_indices(np.arange(self.num_envs))
        return self._state.astype(np.float32).copy()

    def vector_step(self, actions: np.ndarray):
        x, x_dot, theta, theta_dot = self._state.T
        force = np.where(actions == 1, self.FORCE_MAG, -self.FORCE_MAG)
        costheta, sintheta = np.cos(theta), np.sin(theta)
        temp = (force + self.POLEMASS_LENGTH * theta_dot ** 2 * sintheta) \
            / self.TOTAL_MASS
        thetaacc = (self.GRAVITY * sintheta - costheta * temp) / (
            self.LENGTH * (4.0 / 3.0 - self.POLE_MASS * costheta ** 2
                           / self.TOTAL_MASS))
        xacc = temp - self.POLEMASS_LENGTH * thetaacc * costheta \
            / self.TOTAL_MASS
        x = x + self.TAU * x_dot
        x_dot = x_dot + self.TAU * xacc
        theta = theta + self.TAU * theta_dot
        theta_dot = theta_dot + self.TAU * thetaacc
        self._state = np.stack([x, x_dot, theta, theta_dot], axis=1)
        self._steps += 1
        terminated = (np.abs(x) > self.X_LIMIT) | \
            (np.abs(theta) > self.THETA_LIMIT)
        truncated = self._steps >= self.MAX_STEPS
        dones = terminated | truncated
        rewards = np.ones(self.num_envs, dtype=np.float32)
        self.episode_returns += rewards
        if dones.any():
            self.completed_returns.extend(
                self.episode_returns[dones].tolist())
            self.completed_returns = self.completed_returns[-200:]
            self._reset_indices(np.nonzero(dones)[0])
        return (self._state.astype(np.float32).copy(), rewards,
                dones.astype(np.float32), {})


class GymVectorEnv(VectorEnv):
    """Wraps N gymnasium envs (parity: env/vector_env.py sync vectorization)."""

    def __init__(self, env_id: str, num_envs: int = 8, seed: int = 0,
                 **env_kwargs):
        import gymnasium as gym
        self.envs = [gym.make(env_id, **env_kwargs) for _ in range(num_envs)]
        self.num_envs = num_envs
        space = self.envs[0].observation_space
        self.observation_dim = int(np.prod(space.shape))
        act = self.envs[0].action_space
        self.num_actions = getattr(act, "n", -1)
        if self.num_actions < 0:  # Box space: keep PER-DIM bounds
            self.action_dim = int(np.prod(act.shape))
            self.action_low = np.asarray(act.low, np.float32).reshape(-1)
            self.action_high = np.asarray(act.high, np.float32).reshape(-1)
        self._seed = seed
        self.episode_returns = np.zeros(num_envs)
        self.completed_returns: list = []

    def vector_reset(self, seed: Optional[int] = None) -> np.ndarray:
        obs = [e.reset(seed=(seed or self._seed) + i)[0].reshape(-1)
               for i, e in enumerate(self.envs)]
        self.episode_returns[:] = 0
        return np.stack(obs).astype(np.float32)

    def vector_step(self, actions: np.ndarray):
        obs_out, rewards, dones = [], [], []
        for i, (e, a) in enumerate(zip(self.envs, actions)):
            obs, r, term, trunc, _ = e.step(
                int(a) if self.num_actions > 0 else a)
            self.episode_returns[i] += r
            done = term or trunc
            if done:
                self.completed_returns.append(self.episode_returns[i])
                self.completed_returns = self.completed_returns[-200:]
                self.episode_returns[i] = 0
                obs = e.reset()[0]
            obs_out.append(np.reshape(obs, -1))
            rewards.append(r)
            dones.append(float(done))
        return (np.stack(obs_out).astype(np.float32),
                np.array(rewards, dtype=np.float32),
                np.array(dones, dtype=np.float32), {})


class PendulumVectorEnv(VectorEnv):
    """Pure-numpy vectorized Pendulum-v1 dynamics (standard constants):
    the continuous-control learning gate (TD3/continuous-SAC), mirroring
    CartPoleVectorEnv's role for the discrete algos."""

    G = 10.0
    MASS = 1.0
    LENGTH = 1.0
    DT = 0.05
    MAX_SPEED = 8.0
    MAX_TORQUE = 2.0
    MAX_STEPS = 200

    def __init__(self, num_envs: int = 16, seed: int = 0):
        self.num_envs = num_envs
        self.observation_dim = 3          # (cos th, sin th, thdot)
        self.num_actions = -1
        self.action_dim = 1
        self.action_low = -self.MAX_TORQUE
        self.action_high = self.MAX_TORQUE
        self._rng = np.random.default_rng(seed)
        self._th = np.zeros(num_envs)
        self._thdot = np.zeros(num_envs)
        self._steps = np.zeros(num_envs, dtype=np.int64)
        self.episode_returns = np.zeros(num_envs)
        self.completed_returns: list = []

    def _obs(self) -> np.ndarray:
        return np.stack([np.cos(self._th), np.sin(self._th),
                         self._thdot], axis=-1).astype(np.float32)

    def _reset_indices(self, idx: np.ndarray) -> None:
        self._th[idx] = self._rng.uniform(-np.pi, np.pi, idx.shape)
        self._thdot[idx] = self._rng.uniform(-1.0, 1.0, idx.shape)
        self._steps[idx] = 0

    def vector_reset(self, seed=None) -> np.ndarray:
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._reset_indices(np.arange(self.num_envs))
        self.episode_returns[:] = 0
        return self._obs()

    def vector_step(self, actions: np.ndarray):
        u = np.clip(np.asarray(actions, dtype=np.float64).reshape(-1),
                    -self.MAX_TORQUE, self.MAX_TORQUE)
        th, thdot = self._th, self._thdot
        angle = ((th + np.pi) % (2 * np.pi)) - np.pi
        costs = angle ** 2 + 0.1 * thdot ** 2 + 0.001 * u ** 2
        newthdot = thdot + (3 * self.G / (2 * self.LENGTH) * np.sin(th)
                            + 3.0 / (self.MASS * self.LENGTH ** 2) * u
                            ) * self.DT
        newthdot = np.clip(newthdot, -self.MAX_SPEED, self.MAX_SPEED)
        self._th = th + newthdot * self.DT
        self._thdot = newthdot
        self._steps += 1
        rewards = (-costs).astype(np.float32)
        self.episode_returns += rewards
        dones = self._steps >= self.MAX_STEPS
        if dones.any():
            idx = np.nonzero(dones)[0]
            self.completed_returns.extend(self.episode_returns[idx].tolist())
            self.completed_returns = self.completed_returns[-200:]
            self.episode_returns[idx] = 0
            self._reset_indices(idx)
        return (self._obs(), rewards, dones.astype(np.float32), {})


class MultiAgentEnv:
    """Dict-keyed multi-agent protocol (parity: multi_agent_env.py:30).
    reset() -> {agent: obs}; step({agent: action}) ->
    ({agent: obs}, {agent: r}, {agent: done}, {"__all__": done}, infos)."""

    def reset(self) -> Dict[str, np.ndarray]:
        raise NotImplementedError

    def step(self, actions: Dict[str, Any]):
        raise NotImplementedError


def check_env_ships(env: Any) -> None:
    """On a runtime whose actors are worker processes, an env factory or
    class reaches them by import path: pickle it now, so that a lambda or
    a closure raises the pickler's ``TypeError`` ("define it at module
    level") in the driver, before any actor exists. The JAX package
    cloudpickles it (ROADMAP.md C); in-process any callable goes."""
    if not in_process_runtime():
        serialization.dumps(env)


def make_env(env: Any, num_envs: int, seed: int = 0) -> VectorEnv:
    if isinstance(env, VectorEnv):
        return env
    if callable(env):
        out = env(num_envs=num_envs, seed=seed)
        if not isinstance(out, VectorEnv):
            raise TypeError("env factory must return a VectorEnv")
        return out
    if env in ("CartPole-v1", "CartPole"):
        return CartPoleVectorEnv(num_envs=num_envs, seed=seed)
    if env in ("Pendulum-v1", "Pendulum"):
        return PendulumVectorEnv(num_envs=num_envs, seed=seed)
    if isinstance(env, str):
        return GymVectorEnv(env, num_envs=num_envs, seed=seed)
    raise TypeError(f"cannot build an env from {env!r}")
