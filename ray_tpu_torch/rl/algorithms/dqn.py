"""DQN (parity: rllib/algorithms/dqn — replay buffer + target network +
double-Q update; epsilon-greedy exploration on vectorized envs). Ported from
``ray_tpu/rl/algorithms/dqn.py``.

The collectors are actors of either port runtime, each stepping a vector
env on the host with its Q forward where ``sampler_placement`` puts it (the
learner's device in-process, the CPU in a cluster's worker processes);
their epsilon-greedy draws are the JAX collector's numpy ``default_rng``
draws, so given the same weights both stacks take the same actions. The
replay buffer and the TD step stay in the driver, on the config's
``device`` (``None`` = the card); each TD step moves one sampled minibatch
there.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

import ray_tpu_torch as rt
from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.models.convert import rl_params_to_numpy
from ray_tpu_torch.rl import sample_batch as sb
from ray_tpu_torch.rl.algorithm import (SAMPLER_CPUS, Algorithm,
                                        AlgorithmConfig, sampler_placement)
from ray_tpu_torch.rl.env import episode_stats_of, make_env
from ray_tpu_torch.rl.learner import (adam, batch_to_device, clone_tree,
                                      copy_tree_, seeded_init, trainable_)
from ray_tpu_torch.rl.module import make_module
from ray_tpu_torch.rl.replay_buffer import ReplayBuffer
from ray_tpu_torch.rl.rollout import place_params, use_threads, where
from ray_tpu_torch.rl.sample_batch import SampleBatch

# the columns of a transition, in the order the collectors emit them
TRANSITION = (sb.OBS, sb.ACTIONS, sb.REWARDS, sb.NEXT_OBS, sb.DONES)


def transitions(rows) -> SampleBatch:
    """{column: [per-step arrays]} -> one flat batch, steps in order."""
    return SampleBatch({k: np.concatenate(v) for k, v in rows.items()})


class DQNConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.buffer_capacity = 50_000
        self.learning_starts = 1000
        self.target_update_freq = 500   # env steps between target syncs
        self.epsilon_start = 1.0
        self.epsilon_end = 0.05
        self.epsilon_decay_steps = 10_000
        self.train_batch_size = 32
        self.updates_per_iter = 64
        self.gamma = 0.99
        self.lr = 5e-4
        self.algo_class = DQN


class DQNCollector:
    """Actor: epsilon-greedy stepping of a vector env, emitting
    (s, a, r, s', done) transitions."""

    def __init__(self, env: Any, module_spec: dict, num_envs: int,
                 seed: int = 0, device=None,
                 num_threads: Optional[int] = None):
        use_threads(num_threads)
        self.device = resolve_device(device)
        self.env = make_env(env, num_envs=num_envs, seed=seed)
        self.module = make_module(module_spec)
        self.obs = self.env.vector_reset(seed=seed)
        self._rng = np.random.default_rng(seed)
        self.params = None

    @torch.no_grad()
    def _q(self, obs) -> np.ndarray:
        return self.module.apply(self.params, obs)[0].cpu().numpy()

    def collect(self, params, steps: int, epsilon: float) -> SampleBatch:
        """``params``: a numpy tree in the JAX layout (what ``DQN`` and the
        JAX package's DQN send)."""
        self.params = place_params(params, self.module, self.device)
        N = self.env.num_envs
        rows = {k: [] for k in TRANSITION}
        for _ in range(steps):
            q = self._q(self.obs)
            greedy = q.argmax(axis=1)
            explore = self._rng.random(N) < epsilon
            random_a = self._rng.integers(0, q.shape[1], N)
            actions = np.where(explore, random_a, greedy)
            next_obs, rew, done, _ = self.env.vector_step(actions)
            rows[sb.OBS].append(self.obs.copy())
            rows[sb.ACTIONS].append(actions)
            rows[sb.REWARDS].append(rew)
            rows[sb.NEXT_OBS].append(next_obs.copy())
            rows[sb.DONES].append(done)
            self.obs = next_obs
        return transitions(rows)

    def episode_stats(self) -> dict:
        return episode_stats_of(self.env)

    def where(self) -> dict:
        return where(self.device)


class DQN(Algorithm):
    def setup(self) -> None:
        cfg: DQNConfig = self.config  # type: ignore[assignment]
        self.module = make_module(self.module_spec)
        self.params = seeded_init(self.module.init, cfg.seed, self.device)
        self.target_params = clone_tree(self.params)
        self.opt = adam(trainable_(self.params), cfg.lr)
        self.buffer = ReplayBuffer(cfg.buffer_capacity, seed=cfg.seed)
        self._epsilon_step = 0
        collector_cls = rt.remote(DQNCollector)
        self.collectors = [
            collector_cls.options(num_cpus=SAMPLER_CPUS).remote(
                cfg.env, self.module_spec, cfg.num_envs_per_worker,
                seed=cfg.seed + i + 1, **sampler_placement(self.device))
            for i in range(cfg.num_rollout_workers)]

    def td_step(self, batch) -> torch.Tensor:
        """One double-Q TD step with Adam on a minibatch of device tensors
        -> the loss as a 0-d tensor (no host sync)."""
        gamma = self.config.gamma
        q = self.module.apply(self.params, batch[sb.OBS])[0]
        rows = torch.arange(q.shape[0], device=q.device)
        qa = q[rows, batch[sb.ACTIONS].long()]
        with torch.no_grad():
            # double-Q: online net argmax, target net value
            a_star = torch.argmax(
                self.module.apply(self.params, batch[sb.NEXT_OBS])[0], dim=1)
            q_next = self.module.apply(self.target_params,
                                       batch[sb.NEXT_OBS])[0]
            target = batch[sb.REWARDS] + gamma * (1 - batch[sb.DONES]) * \
                q_next[rows, a_star]
        loss = torch.mean((qa - target) ** 2)
        self.opt.zero_grad(set_to_none=False)
        loss.backward()
        self.opt.step()
        return loss.detach()

    def _epsilon(self) -> float:
        cfg: DQNConfig = self.config  # type: ignore[assignment]
        frac = min(1.0, self._epsilon_step / cfg.epsilon_decay_steps)
        return cfg.epsilon_start + frac * (cfg.epsilon_end -
                                           cfg.epsilon_start)

    def training_step(self) -> Dict[str, Any]:
        cfg: DQNConfig = self.config  # type: ignore[assignment]
        weights = rl_params_to_numpy(self.params)
        eps = self._epsilon()
        batches = rt.get([c.collect.remote(weights,
                                           cfg.rollout_fragment_length, eps)
                          for c in self.collectors], timeout=600)
        for b in batches:
            self.buffer.add(b)
            self._timesteps_total += b.count
            self._epsilon_step += b.count
        loss = float("nan")
        if len(self.buffer) >= cfg.learning_starts:
            for _ in range(cfg.updates_per_iter):
                mb = self.buffer.sample(cfg.train_batch_size)
                loss = self.td_step(batch_to_device(mb, TRANSITION,
                                                    self.device))
            if self._timesteps_total % cfg.target_update_freq < \
                    cfg.rollout_fragment_length * cfg.num_rollout_workers \
                    * cfg.num_envs_per_worker:
                copy_tree_(self.target_params, self.params)
            loss = float(loss)
        ep = rt.get([c.episode_stats.remote() for c in self.collectors],
                    timeout=600)
        means = [s["episode_reward_mean"] for s in ep if s["episodes"] > 0]
        return {
            "episode_reward_mean": float(np.mean(means)) if means
            else float("nan"),
            "epsilon": eps,
            "info/td_loss": loss,
        }

    def get_state(self) -> dict:
        return {"params": rl_params_to_numpy(self.params),
                "target": rl_params_to_numpy(self.target_params)}

    def set_state(self, state: dict) -> None:
        copy_tree_(self.params, state["params"])
        copy_tree_(self.target_params, state["target"])

    def stop(self) -> None:
        for c in self.collectors:
            try:
                rt.kill(c)
            except Exception:
                pass
