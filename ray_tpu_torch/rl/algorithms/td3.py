"""TD3 — twin-delayed deterministic policy gradient (continuous control).
Ported from ``ray_tpu/rl/algorithms/td3.py``.

Role parity: rllib/algorithms/td3/td3.py (TD3Config/TD3: DDPG + twin Q +
delayed policy updates + target policy smoothing). One update on the
learner's device (``None`` = the card): the twin critics' Adam step first,
then, on every ``policy_delay``-th update only (a Python ``if`` on a host
counter, where the JAX learner has ``lax.cond``), the actor's Adam step
against the UPDATED ``q1`` and the polyak mix of the whole target tree.
Actions are tanh-squashed to the env bounds; exploration adds gaussian
noise on the host (numpy), as the JAX collector does.

Deliberate divergence: the JAX learner draws the target-policy noise with
``jax.random`` inside jit, which torch cannot reproduce. The port draws it
from its own ``torch.Generator`` on the learner's device, seeded
``seed + 17``: the same law (normal, times ``target_noise`` x scale,
clipped to +-``target_noise_clip`` x scale), other draws. At
``target_noise=0`` (DDPG's point) the two learners compute the same update.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

import ray_tpu_torch as rt
from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.models.convert import _map_rl, rl_params_to_numpy
from ray_tpu_torch.rl import sample_batch as sb
from ray_tpu_torch.rl.algorithm import (SAMPLER_CPUS, Algorithm,
                                        AlgorithmConfig, sampler_placement)
from ray_tpu_torch.rl.algorithms.dqn import TRANSITION, transitions
from ray_tpu_torch.rl.env import episode_stats_of, make_env
from ray_tpu_torch.rl.learner import (adam, batch_to_device, clone_tree,
                                      copy_tree_, host_tensor, polyak_,
                                      seeded_init, trainable_)
from ray_tpu_torch.rl.module import mlp_apply, mlp_init
from ray_tpu_torch.rl.replay_buffer import ReplayBuffer
from ray_tpu_torch.rl.rollout import use_threads, where
from ray_tpu_torch.rl.sample_batch import SampleBatch


class TD3Config(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.env = "Pendulum-v1"
        self.buffer_capacity = 100_000
        self.learning_starts = 1_000
        self.train_batch_size = 128
        self.updates_per_iter = 256
        self.rollout_fragment_length = 64
        self.gamma = 0.99
        self.tau = 0.005                # polyak target mix
        self.actor_lr = 1e-3
        self.critic_lr = 1e-3
        self.policy_delay = 2           # critic updates per actor update
        self.target_noise = 0.2         # target policy smoothing sigma
        self.target_noise_clip = 0.5
        self.exploration_noise = 0.1    # rollout gaussian sigma (action units)
        self.twin_q = True
        self.algo_class = TD3


class TD3Learner:
    """The TD3 update: twin critics every step, actor + targets every
    ``policy_delay``-th step, on one device (``None`` = the card)."""

    def __init__(self, module_spec: dict, *, actor_lr: float = 1e-3,
                 critic_lr: float = 1e-3, gamma: float = 0.99,
                 tau: float = 0.005, policy_delay: int = 2,
                 target_noise: float = 0.2, target_noise_clip: float = 0.5,
                 action_low: float = -1.0, action_high: float = 1.0,
                 hiddens=(64, 64), twin_q: bool = True, seed: int = 0,
                 device=None):
        self.device = resolve_device(device)
        obs_dim = module_spec["obs_dim"]
        act_dim = module_spec.get("action_dim", 1)
        if module_spec.get("num_actions", -1) > 0:
            raise ValueError("TD3 is continuous-only; use DQN/SAC for "
                             "discrete action spaces")
        self.scale = (action_high - action_low) / 2.0
        self.mid = (action_high + action_low) / 2.0
        self.low, self.high = action_low, action_high
        self.gamma, self.tau = gamma, tau
        self.policy_delay, self.twin_q = policy_delay, twin_q
        self.target_noise, self.target_noise_clip = \
            target_noise, target_noise_clip

        critic = (obs_dim + act_dim, *hiddens, 1)
        self.params = seeded_init(
            lambda gen, dev: {"actor": mlp_init(
                gen, (obs_dim, *hiddens, act_dim), dev),
                "q1": mlp_init(gen, critic, dev),
                "q2": mlp_init(gen, critic, dev)}, seed, self.device)
        self.target = clone_tree(self.params)
        self._actor_leaves = trainable_(self.params["actor"])
        self.opt_actor = adam(self._actor_leaves, actor_lr)
        self.opt_critic = adam(trainable_({"q1": self.params["q1"],
                                           "q2": self.params["q2"]}),
                               critic_lr)
        self.step_count = 0
        self.noise_generator = torch.Generator(
            device=self.device).manual_seed(seed + 17)

    def act(self, actor_params, obs):
        return torch.tanh(mlp_apply(actor_params, obs)) * self.scale + \
            self.mid

    @staticmethod
    def q_val(qp, obs, actions):
        if actions.ndim == 1:
            actions = actions[:, None]
        return mlp_apply(qp, torch.cat([obs, actions], dim=-1))[..., 0]

    def target_policy_noise(self, shape) -> torch.Tensor:
        """Clipped gaussian noise for the target action, from the learner's
        own generator."""
        noise = torch.empty(shape, device=self.device).normal_(
            generator=self.noise_generator) * (self.target_noise * self.scale)
        bound = self.target_noise_clip * self.scale
        return torch.clamp(noise, -bound, bound)

    def step(self, batch) -> Dict[str, torch.Tensor]:
        """One update on a minibatch of device tensors -> its stats as 0-d
        tensors (no host sync)."""
        obs, actions = batch[sb.OBS], batch[sb.ACTIONS]
        next_obs = batch[sb.NEXT_OBS]
        if actions.ndim == 1:
            actions = actions[:, None]
        p, target = self.params, self.target

        with torch.no_grad():
            # Target policy smoothing: clipped noise on the target action.
            a_next = torch.clamp(
                self.act(target["actor"], next_obs)
                + self.target_policy_noise(actions.shape),
                self.low, self.high)
            q_next = self.q_val(target["q1"], next_obs, a_next)
            if self.twin_q:
                q_next = torch.minimum(
                    q_next, self.q_val(target["q2"], next_obs, a_next))
            td_target = batch[sb.REWARDS] + self.gamma * (
                1.0 - batch[sb.DONES]) * q_next

        closs = torch.mean((self.q_val(p["q1"], obs, actions) - td_target)
                           ** 2)
        if self.twin_q:   # DDPG: a single critic, q2 left as it is
            closs = closs + torch.mean(
                (self.q_val(p["q2"], obs, actions) - td_target) ** 2)
        self.opt_critic.zero_grad(set_to_none=False)
        closs.backward()
        self.opt_critic.step()

        self.step_count += 1
        if self.step_count % self.policy_delay == 0:
            # against the critic just updated
            aloss = -torch.mean(self.q_val(p["q1"], obs,
                                           self.act(p["actor"], obs)))
            grads = torch.autograd.grad(aloss, self._actor_leaves)
            for leaf, g in zip(self._actor_leaves, grads):
                leaf.grad = g
            self.opt_actor.step()
            polyak_(target, p, self.tau)
        else:
            aloss = torch.zeros((), device=self.device)
        return {"critic_loss": closs.detach(), "actor_loss": aloss.detach()}

    def update(self, batch: SampleBatch) -> Dict[str, float]:
        info = self.step(batch_to_device(batch, TRANSITION, self.device))
        return {k: float(v) for k, v in info.items()}

    def get_weights(self):
        """The actor as numpy, in the JAX layout (what the collectors take)."""
        return rl_params_to_numpy(self.params["actor"])

    def state(self) -> dict:
        return {"params": rl_params_to_numpy(self.params),
                "target": rl_params_to_numpy(self.target)}

    def set_state(self, st: dict) -> None:
        copy_tree_(self.params, st["params"])
        copy_tree_(self.target, st["target"])


class TD3Collector:
    """Deterministic policy + gaussian exploration noise (reference's
    GaussianNoise exploration, rllib/utils/exploration): the actor forward
    on ``device``, the env and the noise on the host."""

    def __init__(self, env: Any, module_spec: dict, num_envs: int,
                 *, hiddens=(64, 64), noise: float = 0.1, seed: int = 0,
                 device=None, num_threads: Optional[int] = None):
        use_threads(num_threads)
        self.device = resolve_device(device)
        self.env = make_env(env, num_envs=num_envs, seed=seed)
        low, high = self.env.action_low, self.env.action_high
        self.scale, self.mid = (high - low) / 2.0, (high + low) / 2.0
        self.low, self.high = low, high
        self.noise = noise * self.scale
        self.obs = self.env.vector_reset(seed=seed)
        self._rng = np.random.default_rng(seed)

    @torch.no_grad()
    def _act(self, actor_params, obs) -> np.ndarray:
        x = torch.as_tensor(obs, device=self.device)
        return (torch.tanh(mlp_apply(actor_params, x)) * self.scale
                + self.mid).cpu().numpy()

    def collect(self, actor_params, steps: int,
                warmup: bool = False) -> SampleBatch:
        """``actor_params``: the actor as a numpy tree in the JAX layout."""
        if not warmup:
            actor_params = _map_rl(actor_params, lambda _, v: host_tensor(
                np.asarray(v, np.float32)).to(self.device))
        rows = {k: [] for k in TRANSITION}
        N = self.env.num_envs
        act_dim = getattr(self.env, "action_dim", 1)
        for _ in range(steps):
            if warmup:
                a = self._rng.uniform(self.low, self.high, (N, act_dim))
            else:
                a = self._act(actor_params, self.obs)
                a = a.reshape(N, act_dim)
                a = np.clip(a + self._rng.normal(0, self.noise, a.shape),
                            self.low, self.high)
            next_obs, rew, done, _ = self.env.vector_step(a)
            rows[sb.OBS].append(self.obs.copy())
            rows[sb.ACTIONS].append(a.astype(np.float32))
            rows[sb.REWARDS].append(rew)
            rows[sb.NEXT_OBS].append(next_obs.copy())
            rows[sb.DONES].append(done)
            self.obs = next_obs
        return transitions(rows)

    def episode_stats(self) -> dict:
        return episode_stats_of(self.env)

    def where(self) -> dict:
        return where(self.device)


class TD3(Algorithm):
    _default_config = TD3Config

    def setup(self) -> None:
        cfg: TD3Config = self.config  # type: ignore[assignment]
        probe = make_env(cfg.env, num_envs=1, seed=cfg.seed)
        self.learner = TD3Learner(
            self.module_spec, actor_lr=cfg.actor_lr, critic_lr=cfg.critic_lr,
            gamma=cfg.gamma, tau=cfg.tau, policy_delay=cfg.policy_delay,
            target_noise=cfg.target_noise,
            target_noise_clip=cfg.target_noise_clip,
            action_low=probe.action_low, action_high=probe.action_high,
            hiddens=tuple(cfg.model_hiddens), twin_q=cfg.twin_q,
            seed=cfg.seed, device=self.device)
        self.buffer = ReplayBuffer(cfg.buffer_capacity, seed=cfg.seed)
        collector_cls = rt.remote(TD3Collector)
        self.collectors = [
            collector_cls.options(num_cpus=SAMPLER_CPUS).remote(
                cfg.env, self.module_spec, cfg.num_envs_per_worker,
                hiddens=tuple(cfg.model_hiddens),
                noise=cfg.exploration_noise, seed=cfg.seed + i + 1,
                **sampler_placement(self.device))
            for i in range(cfg.num_rollout_workers)]

    def training_step(self) -> Dict[str, Any]:
        cfg: TD3Config = self.config  # type: ignore[assignment]
        warmup = self._timesteps_total < cfg.learning_starts
        weights = self.learner.get_weights()
        batches = rt.get([c.collect.remote(weights,
                                           cfg.rollout_fragment_length,
                                           warmup=warmup)
                          for c in self.collectors], timeout=600)
        for b in batches:
            self.buffer.add(b)
            self._timesteps_total += b.count
        info: Dict[str, float] = {}
        if self._timesteps_total >= cfg.learning_starts:
            for _ in range(cfg.updates_per_iter):
                info = self.learner.step(batch_to_device(
                    self.buffer.sample(cfg.train_batch_size), TRANSITION,
                    self.device))
            info = {k: float(v) for k, v in info.items()}
        stats = rt.get([c.episode_stats.remote() for c in self.collectors],
                       timeout=600)
        rewards = [s["episode_reward_mean"] for s in stats
                   if not np.isnan(s["episode_reward_mean"])]
        return {
            "episode_reward_mean": float(np.mean(rewards)) if rewards
            else float("nan"),
            "timesteps_total": self._timesteps_total,
            **info,
        }

    def get_state(self) -> dict:
        return {"learner": self.learner.state(),
                "timesteps_total": self._timesteps_total,
                "iteration": self.iteration}

    def set_state(self, state: dict) -> None:
        self.learner.set_state(state["learner"])
        self._timesteps_total = state["timesteps_total"]
        self.iteration = state["iteration"]

    def stop(self) -> None:
        for c in self.collectors:
            try:
                rt.kill(c)
            except Exception:
                pass


class DDPGConfig(TD3Config):
    """DDPG (parity: rllib/algorithms/ddpg) — TD3's degenerate point:
    single critic, no delay, no target smoothing."""

    def __init__(self):
        super().__init__()
        self.twin_q = False
        self.policy_delay = 1
        self.target_noise = 0.0
        self.target_noise_clip = 0.0
        self.algo_class = DDPG


class DDPG(TD3):
    _default_config = DDPGConfig
