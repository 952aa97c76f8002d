"""QMIX: cooperative multi-agent Q-learning with monotonic value mixing.
Ported from ``ray_tpu/rl/algorithms/qmix.py``.

Role parity: rllib/algorithms/qmix/qmix.py (+ qmix_policy.py mixer):
per-agent Q-networks (parameter-shared: one forward serves every agent)
feed a MIXING network whose weights are produced by hypernetworks
conditioned on the GLOBAL state, constrained non-negative (abs) so
argmax_a Q_tot decomposes into per-agent argmaxes (the IGM property).
Trained end-to-end on joint transitions with a target network.

Exercises the MultiAgentEnv protocol: the collector steps one env,
records per-STEP joint transitions (all agents' obs/actions, the TEAM
reward, the global state = concat of agent observations).

The port's idiom: the networks, the TD step and the greedy forward run on
``config.device`` (``None`` = the card); the env, the buffer and every
random draw (epsilon, the random actions, the buffer indices) are the JAX
version's numpy draws on the host, so given the same weights both stacks
take the same actions and sample the same rows. The initial weights come
from a host generator seeded ``seed`` (``rl/learner.py:seeded_init``).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List

import numpy as np
import torch

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.models.convert import rl_params_to_numpy
from ray_tpu_torch.rl.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rl.env import MultiAgentEnv
from ray_tpu_torch.rl.learner import (adam, clone_tree, copy_tree_,
                                      seeded_init, trainable_)
from ray_tpu_torch.rl.module import mlp_apply, mlp_init


class QMIXConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.env_fn: Callable[[], MultiAgentEnv] = None  # required
        self.mixing_embed_dim = 16
        self.hidden = 32
        self.buffer_capacity = 20_000
        self.train_batch_size = 64
        self.updates_per_iter = 64
        self.steps_per_iter = 256
        self.target_update_iters = 4
        self.epsilon_start = 1.0
        self.epsilon_end = 0.05
        self.epsilon_decay_steps = 3_000
        self.gamma = 0.99
        self.lr = 1e-3
        self.algo_class = QMIX


def _qmix_init(generator, obs_dim: int, num_actions: int, n_agents: int,
               state_dim: int, hidden: int, embed: int, device=None) -> dict:
    return {
        # shared per-agent Q net
        "q": mlp_init(generator, [obs_dim, hidden, hidden, num_actions],
                      device),
        # hypernetworks: state -> mixing weights (non-negative via abs)
        "hyper_w1": mlp_init(generator, [state_dim, embed * n_agents],
                             device),
        "hyper_b1": mlp_init(generator, [state_dim, embed], device),
        "hyper_w2": mlp_init(generator, [state_dim, embed], device),
        "hyper_b2": mlp_init(generator, [state_dim, hidden, 1], device),
    }


def _agent_qs(params, obs):  # obs: [B, n_agents, obs_dim]
    B, n, d = obs.shape
    q = mlp_apply(params["q"], obs.reshape(B * n, d))
    return q.reshape(B, n, -1)


def _mix(params, agent_q, state):
    """agent_q: [B, n] chosen per-agent Qs; state: [B, state_dim] ->
    Q_tot [B]. Monotonic: layer weights pass through abs()."""
    w1 = torch.abs(mlp_apply(params["hyper_w1"], state))   # [B, e*n]
    b1 = mlp_apply(params["hyper_b1"], state)              # [B, e]
    B, n = agent_q.shape
    e = b1.shape[1]
    w1 = w1.reshape(B, n, e)
    h = torch.einsum("bn,bne->be", agent_q, w1) + b1
    h = torch.where(h > 0, h, 0.01 * h)                    # leaky relu
    w2 = torch.abs(mlp_apply(params["hyper_w2"], state))   # [B, e]
    b2 = mlp_apply(params["hyper_b2"], state)              # [B, 1]
    return torch.einsum("be,be->b", h, w2) + b2[:, 0]


class QMIX(Algorithm):
    def __init__(self, config: QMIXConfig):
        # MultiAgentEnv world: no gym probe / module_spec (base init
        # assumes a VectorEnv). The device first: no card and device=None
        # raises here.
        self.config = config
        self.device = resolve_device(config.device)
        self.iteration = 0
        self._timesteps_total = 0
        self.setup()

    def setup(self) -> None:
        cfg: QMIXConfig = self.config  # type: ignore[assignment]
        if cfg.env_fn is None:
            raise ValueError("QMIXConfig.env_fn (MultiAgentEnv factory) "
                             "is required")
        self.env = cfg.env_fn()
        self._obs = self.env.reset()
        self.agents = sorted(self._obs)
        n = len(self.agents)
        obs_dim = int(np.asarray(self._obs[self.agents[0]]).size)
        self.n_actions = self.env.num_actions
        state_dim = obs_dim * n
        self.params = seeded_init(
            lambda gen, dev: _qmix_init(
                gen, obs_dim, self.n_actions, n, state_dim, cfg.hidden,
                cfg.mixing_embed_dim, dev), cfg.seed, self.device)
        self.target_params = clone_tree(self.params)
        self.opt = adam(trainable_(self.params), cfg.lr)
        self._rng = np.random.default_rng(cfg.seed)
        self._buf: List[tuple] = []
        self._ep_return = 0.0
        self.episode_returns: List[float] = []
        self._eps_step = 0

    def td_step(self, batch) -> torch.Tensor:
        """One TD step with Adam on a joint batch of device tensors ``(obs,
        acts, rew, nobs, done, state, nstate)`` -> the loss as a 0-d tensor
        (no host sync)."""
        obs, acts, rew, nobs, done, state, nstate = batch
        q = _agent_qs(self.params, obs)                         # [B,n,A]
        chosen = q.gather(2, acts[..., None].long())[..., 0]    # [B,n]
        q_tot = _mix(self.params, chosen, state)
        with torch.no_grad():
            q_next = _agent_qs(self.target_params, nobs).max(dim=2).values
            y = rew + self.config.gamma * (1.0 - done) * _mix(
                self.target_params, q_next, nstate)
        loss = torch.mean((q_tot - y) ** 2)
        self.opt.zero_grad(set_to_none=False)
        loss.backward()
        self.opt.step()
        return loss.detach()

    # -- joint-transition collection -------------------------------------
    def _epsilon(self) -> float:
        cfg: QMIXConfig = self.config  # type: ignore[assignment]
        frac = min(1.0, self._eps_step / cfg.epsilon_decay_steps)
        return cfg.epsilon_start + frac * (cfg.epsilon_end -
                                           cfg.epsilon_start)

    def _stack_obs(self, obs_dict) -> np.ndarray:
        return np.stack([np.asarray(obs_dict[a], np.float32)
                         for a in self.agents])

    @torch.no_grad()
    def _greedy(self, o: np.ndarray) -> np.ndarray:
        """[n, d] observations -> each agent's argmax action, one sync."""
        x = torch.as_tensor(o, device=self.device)[None]
        return _agent_qs(self.params, x)[0].argmax(dim=1).cpu().numpy()

    def _collect(self, steps: int) -> None:
        cfg: QMIXConfig = self.config  # type: ignore[assignment]
        eps = self._epsilon()
        for _ in range(steps):
            o = self._stack_obs(self._obs)           # [n, d]
            greedy = self._greedy(o)
            explore = self._rng.random(len(self.agents)) < eps
            rand = self._rng.integers(0, self.n_actions, len(self.agents))
            acts = np.where(explore, rand, greedy)
            action_dict = {a: int(acts[i])
                           for i, a in enumerate(self.agents)}
            nxt, rew, dones, all_done, _ = self.env.step(action_dict)
            team_r = float(sum(rew.values()))
            done = bool(all_done.get("__all__"))
            no = self._stack_obs(nxt) if not done else o
            self._buf.append((o, acts.astype(np.int32), team_r, no, done))
            if len(self._buf) > cfg.buffer_capacity:
                self._buf.pop(0)
            self._ep_return += team_r
            self._eps_step += 1
            self._timesteps_total += 1
            if done:
                self.episode_returns.append(self._ep_return)
                self._ep_return = 0.0
                self._obs = self.env.reset()
            else:
                self._obs = nxt

    def sample_batch(self, idx) -> tuple:
        """The buffer rows ``idx`` as the TD step's device tensors."""
        rows = [self._buf[i] for i in idx]
        obs = np.stack([r[0] for r in rows])        # [B,n,d]
        acts = np.stack([r[1] for r in rows])
        rew = np.asarray([r[2] for r in rows], np.float32)
        nobs = np.stack([r[3] for r in rows])
        done = np.asarray([r[4] for r in rows], np.float32)
        state = obs.reshape(len(rows), -1)
        nstate = nobs.reshape(len(rows), -1)
        return tuple(torch.as_tensor(a).to(self.device)
                     for a in (obs, acts, rew, nobs, done, state, nstate))

    def training_step(self) -> Dict[str, Any]:
        cfg: QMIXConfig = self.config  # type: ignore[assignment]
        self._collect(cfg.steps_per_iter)
        loss = float("nan")
        if len(self._buf) >= cfg.train_batch_size:
            for _ in range(cfg.updates_per_iter):
                idx = self._rng.integers(0, len(self._buf),
                                         cfg.train_batch_size)
                loss = self.td_step(self.sample_batch(idx))
            loss = float(loss)
        if self.iteration % cfg.target_update_iters == 0:
            copy_tree_(self.target_params, self.params)
        recent = self.episode_returns[-20:]
        return {
            "episode_reward_mean": float(np.mean(recent)) if recent
            else float("nan"),
            "epsilon": self._epsilon(),
            "info/td_loss": loss,
        }

    def get_state(self) -> dict:
        return {"params": rl_params_to_numpy(self.params),
                "target": rl_params_to_numpy(self.target_params)}

    def set_state(self, state: dict) -> None:
        copy_tree_(self.params, state["params"])
        copy_tree_(self.target_params, state["target"])
