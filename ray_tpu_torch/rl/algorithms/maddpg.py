"""MADDPG: multi-agent DDPG with centralized critics. Ported from
``ray_tpu/rl/algorithms/maddpg.py``.

Role parity: rllib/algorithms/maddpg/maddpg.py: each agent i owns a
deterministic actor mu_i(o_i) trained through a CENTRALIZED critic
Q_i(o_1..o_n, a_1..a_n) that sees every agent's observation and action
(centralized training, decentralized execution). Target networks +
Polyak averaging, Gaussian exploration noise, joint replay.

Continuous cooperative test env included (CoopSpreadEnv): agents emit
scalar actions and share -|a_i - target| penalties — coordination is
only learnable through the centralized critic.

The port's idiom: the actors, the critics and the update run on
``config.device`` (``None`` = the card); the env, the buffer, the
exploration noise and the buffer indices are the JAX version's numpy draws
on the host. An update is the JAX one in its order: the critics' Adam step
(targets from the target actors and critics), then the actors' Adam step
against the critics just updated, then the Polyak step over the new actors
and critics. During the actor delay the JAX update multiplies the actors'
Adam update by 0, so their Adam moments and step count still advance; the
port runs the actors' step too and then puts the actors' values back, bit
for bit.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List

import numpy as np
import torch

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.models.convert import rl_params_to_numpy
from ray_tpu_torch.rl.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rl.env import MultiAgentEnv
from ray_tpu_torch.rl.learner import (adam, clone_tree, copy_tree_, polyak_,
                                      seeded_init, trainable_)
from ray_tpu_torch.rl.module import mlp_apply, mlp_init


class CoopSpreadEnv(MultiAgentEnv):
    """Two agents, scalar actions in [-1, 1]. Each episode draws a target
    t; reward_i = -|a_i - t| - 0.5 * |a_0 - a_1| (hit the target AND
    agree). Observations: [t, agent_one_hot]. A copy of the JAX
    package's."""

    def __init__(self, horizon: int = 10, seed: int = 0):
        self._rng = np.random.default_rng(seed)
        self.horizon = horizon
        self._t = 0
        self.target = 0.0
        self.num_actions = -1     # continuous
        self.action_dim = 1

    def _obs(self):
        return {"agent_0": np.array([self.target, 1.0, 0.0], np.float32),
                "agent_1": np.array([self.target, 0.0, 1.0], np.float32)}

    def reset(self):
        self._t = 0
        self.target = float(self._rng.uniform(-0.8, 0.8))
        return self._obs()

    def step(self, actions):
        self._t += 1
        a0 = float(np.asarray(actions["agent_0"]).ravel()[0])
        a1 = float(np.asarray(actions["agent_1"]).ravel()[0])
        rew = {
            "agent_0": -abs(a0 - self.target) - 0.5 * abs(a0 - a1),
            "agent_1": -abs(a1 - self.target) - 0.5 * abs(a0 - a1),
        }
        done = self._t >= self.horizon
        return (self._obs(), rew, {a: done for a in rew},
                {"__all__": done}, {})


class MADDPGConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.env_fn: Callable[[], MultiAgentEnv] = CoopSpreadEnv
        self.hidden = 64
        self.buffer_capacity = 20_000
        self.train_batch_size = 64
        self.updates_per_iter = 64
        self.steps_per_iter = 200
        self.tau = 0.02              # Polyak
        self.noise_scale = 0.3
        self.gamma = 0.95
        self.actor_lr = 3e-4
        self.critic_lr = 1e-3
        self.actor_delay_iters = 2   # critic warms up before actors move
        self.algo_class = MADDPG


def _critic_in(obs, acts):   # [B,n,d], [B,n,adim] -> [B, joint]
    B = obs.shape[0]
    return torch.cat([obs.reshape(B, -1), acts.reshape(B, -1)], dim=1)


class MADDPG(Algorithm):
    def __init__(self, config: MADDPGConfig):
        # the base init assumes a VectorEnv; the device first: no card and
        # device=None raises here
        self.config = config
        self.device = resolve_device(config.device)
        self.iteration = 0
        self._timesteps_total = 0
        self.setup()

    def setup(self) -> None:
        cfg: MADDPGConfig = self.config  # type: ignore[assignment]
        self.env = cfg.env_fn()
        self._obs = self.env.reset()
        self.agents = sorted(self._obs)
        n = len(self.agents)
        obs_dim = int(np.asarray(self._obs[self.agents[0]]).size)
        adim = getattr(self.env, "action_dim", 1)
        joint = n * obs_dim + n * adim

        def init(gen, dev):
            actors = []
            for _ in range(n):
                p = mlp_init(gen, [obs_dim, cfg.hidden, cfg.hidden, adim],
                             dev)
                # Near-zero head (the standard DDPG trick): initial actions
                # sit at tanh's linear center instead of a saturated extreme
                # a random critic can strand them in.
                p[-1]["w"] = p[-1]["w"] * 0.01
                actors.append(p)
            critics = [mlp_init(gen, [joint, cfg.hidden, cfg.hidden, 1], dev)
                       for _ in range(n)]
            return {"actors": actors, "critics": critics}

        self.params = seeded_init(init, cfg.seed, self.device)
        self.target = clone_tree(self.params)
        self._actor_leaves = trainable_(self.params["actors"])
        self._critic_leaves = trainable_(self.params["critics"])
        self.aopt = adam(self._actor_leaves, cfg.actor_lr)
        self.copt = adam(self._critic_leaves, cfg.critic_lr)
        self._rng = np.random.default_rng(cfg.seed)
        self._buf: List[tuple] = []
        self.episode_returns: List[float] = []
        self._ep_return = 0.0
        self.n, self.obs_dim, self.adim = n, obs_dim, adim

    @torch.no_grad()
    def _act(self, actors, obs) -> np.ndarray:
        """obs [n, d] -> [n, adim] tanh-squashed actions on the host, one
        sync."""
        x = torch.as_tensor(np.asarray(obs, np.float32), device=self.device)
        return torch.stack([torch.tanh(mlp_apply(actors[i], x[i][None])[0])
                            for i in range(self.n)]).cpu().numpy()

    def update(self, batch, do_actor: float) -> Dict[str, torch.Tensor]:
        """One MADDPG update on a joint batch of device tensors ``(obs [B,n,
        d], acts [B,n,adim], rew [B,n], nobs, done [B])``; the actors keep
        their values when ``do_actor`` is 0 -> the losses as 0-d tensors
        (no host sync)."""
        cfg: MADDPGConfig = self.config  # type: ignore[assignment]
        obs, acts, rew, nobs, done = batch
        p, tgt, n = self.params, self.target, self.n

        with torch.no_grad():
            nacts = torch.stack([
                torch.tanh(mlp_apply(tgt["actors"][i], nobs[:, i]))
                for i in range(n)], dim=1)
            nin = _critic_in(nobs, nacts)
            ys = [rew[:, i] + cfg.gamma * (1 - done) *
                  mlp_apply(tgt["critics"][i], nin)[:, 0] for i in range(n)]
        cin = _critic_in(obs, acts)
        closs = 0.0
        for i in range(n):
            qi = mlp_apply(p["critics"][i], cin)[:, 0]
            closs = closs + torch.mean((qi - ys[i]) ** 2)
        grads = torch.autograd.grad(closs, self._critic_leaves)
        for leaf, g in zip(self._critic_leaves, grads):
            leaf.grad = g
        self.copt.step()

        # against the critics just updated; the other agents' actions come
        # from the buffer
        aloss = 0.0
        for i in range(n):
            pre = mlp_apply(p["actors"][i], obs[:, i])
            ai = torch.tanh(pre)
            joint_a = torch.stack([ai if j == i else acts[:, j]
                                   for j in range(n)], dim=1)
            aloss = aloss - torch.mean(mlp_apply(
                p["critics"][i], _critic_in(obs, joint_a))[:, 0])
            # pre-tanh penalty: keeps actions out of the saturated
            # zero-gradient region
            aloss = aloss + 1e-3 * torch.mean(pre ** 2)
        grads = torch.autograd.grad(aloss, self._actor_leaves)
        for leaf, g in zip(self._actor_leaves, grads):
            leaf.grad = g
        if do_actor:
            self.aopt.step()
        else:
            # actor delay: the Adam state advances, the actors stay
            held = [leaf.detach().clone() for leaf in self._actor_leaves]
            self.aopt.step()
            with torch.no_grad():
                for leaf, value in zip(self._actor_leaves, held):
                    leaf.copy_(value)
        polyak_(tgt, p, cfg.tau)
        return {"critic_loss": closs.detach(), "actor_loss": aloss.detach()}

    def _stack_obs(self, od) -> np.ndarray:
        return np.stack([np.asarray(od[a], np.float32)
                         for a in self.agents])

    def sample_batch(self, idx) -> tuple:
        """The buffer rows ``idx`` as the update's device tensors."""
        rows = [self._buf[i] for i in idx]
        batch = (np.stack([r[0] for r in rows]),
                 np.stack([r[1] for r in rows]),
                 np.stack([r[2] for r in rows]),
                 np.stack([r[3] for r in rows]),
                 np.asarray([r[4] for r in rows], np.float32))
        return tuple(torch.as_tensor(a).to(self.device) for a in batch)

    def training_step(self) -> Dict[str, Any]:
        cfg: MADDPGConfig = self.config  # type: ignore[assignment]
        for _ in range(cfg.steps_per_iter):
            o = self._stack_obs(self._obs)
            a = self._act(self.params["actors"], o)
            a = np.clip(a + self._rng.normal(
                scale=cfg.noise_scale, size=a.shape), -1.0, 1.0)
            action_dict = {ag: a[i] for i, ag in enumerate(self.agents)}
            nxt, rew, _dones, all_done, _ = self.env.step(action_dict)
            done = bool(all_done.get("__all__"))
            self._buf.append((
                o, a.astype(np.float32),
                np.asarray([rew[ag] for ag in self.agents], np.float32),
                self._stack_obs(nxt) if not done else o, done))
            if len(self._buf) > cfg.buffer_capacity:
                self._buf.pop(0)
            self._ep_return += float(np.mean(list(rew.values())))
            self._timesteps_total += 1
            if done:
                self.episode_returns.append(self._ep_return)
                self._ep_return = 0.0
                self._obs = self.env.reset()
            else:
                self._obs = nxt
        closs = aloss = float("nan")
        if len(self._buf) >= cfg.train_batch_size:
            for _ in range(cfg.updates_per_iter):
                idx = self._rng.integers(0, len(self._buf),
                                         cfg.train_batch_size)
                do_actor = float(self.iteration >= cfg.actor_delay_iters)
                info = self.update(self.sample_batch(idx), do_actor)
                closs, aloss = info["critic_loss"], info["actor_loss"]
            closs, aloss = float(closs), float(aloss)
        recent = self.episode_returns[-20:]
        return {
            "episode_reward_mean": float(np.mean(recent)) if recent
            else float("nan"),
            "info/critic_loss": closs,
            "info/actor_loss": aloss,
        }

    def get_state(self) -> dict:
        return {"params": rl_params_to_numpy(self.params),
                "target": rl_params_to_numpy(self.target)}

    def set_state(self, state: dict) -> None:
        copy_tree_(self.params, state["params"])
        copy_tree_(self.target, state["target"])
