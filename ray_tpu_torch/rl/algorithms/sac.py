"""SAC — soft actor-critic. Ported from ``ray_tpu/rl/algorithms/sac.py``.

Role parity: rllib/algorithms/sac/sac.py (SACConfig/SAC) — twin soft
Q-functions with target networks, entropy-regularized policy, automatic
temperature tuning. Discrete action spaces use the exact-expectation
variant (SAC-Discrete), as in the JAX package. The whole update (twin Q +
policy + alpha, one Adam over ``{pi, q1, q2, log_alpha}``, then the polyak
targets) is one step on the learner's device (``None`` = the card). The
gradient stops exactly where the JAX losses have ``stop_gradient``: the
whole Bellman target (the ``pi`` and ``alpha`` in it too), the Q values in
the policy loss, ``alpha`` in the policy loss and the entropy in the
temperature loss. The collector draws its actions as the JAX one does:
the softmax in numpy from the logits brought to the host, then
``rng.choice`` row by row.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.models.convert import rl_params_to_numpy
from ray_tpu_torch.rl import sample_batch as sb
from ray_tpu_torch.rl.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rl.algorithms.dqn import (TRANSITION, DQNCollector,
                                             transitions)
from ray_tpu_torch.rl.learner import (adam, batch_to_device, clone_tree,
                                      copy_tree_, polyak_, seeded_init,
                                      trainable_)
from ray_tpu_torch.rl.module import mlp_apply, mlp_init
from ray_tpu_torch.rl.replay_buffer import ReplayBuffer
from ray_tpu_torch.rl.sample_batch import SampleBatch


class SACConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.buffer_capacity = 50_000
        self.learning_starts = 500
        self.train_batch_size = 256
        # Off-policy: a high update:sample ratio is what makes SAC
        # sample-efficient (the JAX package's CartPole-gate tuning).
        self.updates_per_iter = 192
        self.rollout_fragment_length = 32
        self.gamma = 0.99
        # Polyak mix: at 192 updates/iter a 0.005 mix leaves the targets
        # lagging the online Q far enough that the bellman bootstrap stalls;
        # 0.03 tracks fast enough to clear the gate.
        self.tau = 0.03
        self.lr = 1e-3
        self.initial_alpha = 0.2
        self.autotune_alpha = True
        self.target_entropy_scale = 0.4   # × log|A|
        self.algo_class = SAC


class SACLearner:
    """The SAC-Discrete update (twin Q + policy + temperature, one step) on
    one device (``None`` = the card)."""

    def __init__(self, module_spec: dict, *, lr: float = 1e-3,
                 gamma: float = 0.99, tau: float = 0.03,
                 initial_alpha: float = 0.2, autotune_alpha: bool = True,
                 target_entropy_scale: float = 0.4, seed: int = 0,
                 device=None):
        self.device = resolve_device(device)
        obs_dim = module_spec["obs_dim"]
        self.num_actions = module_spec["num_actions"]
        hiddens = tuple(module_spec.get("hiddens", (64, 64)))
        if self.num_actions <= 0:
            raise NotImplementedError(
                "SACLearner currently covers discrete action spaces "
                "(SAC-Discrete); continuous support tracks the gaussian "
                "RLModule head")
        A = self.num_actions
        self.gamma, self.tau = gamma, tau
        self.autotune_alpha = autotune_alpha
        self.target_entropy = target_entropy_scale * float(np.log(A))
        sizes = (obs_dim, *hiddens, A)
        self.params = seeded_init(
            lambda gen, dev: {k: mlp_init(gen, sizes, dev)
                              for k in ("pi", "q1", "q2")}, seed, self.device)
        self.params["log_alpha"] = torch.tensor(float(np.log(initial_alpha)),
                                                device=self.device)
        self.target = clone_tree({"q1": self.params["q1"],
                                  "q2": self.params["q2"]})
        self.opt = adam(trainable_(self.params), lr)

    def losses(self, batch):
        """-> (total loss, stats) of one minibatch of device tensors."""
        p_ = self.params
        obs, acts = batch[sb.OBS], batch[sb.ACTIONS].long()
        rew, done = batch[sb.REWARDS], batch[sb.DONES]
        alpha = torch.exp(p_["log_alpha"])
        rows = torch.arange(obs.shape[0], device=obs.device)

        # -- twin-Q bellman target (exact expectation over pi(.|s')) -----
        with torch.no_grad():
            logp_n = torch.log_softmax(mlp_apply(p_["pi"],
                                                 batch[sb.NEXT_OBS]), -1)
            minq = torch.minimum(mlp_apply(self.target["q1"],
                                           batch[sb.NEXT_OBS]),
                                 mlp_apply(self.target["q2"],
                                           batch[sb.NEXT_OBS]))
            v_next = torch.sum(torch.exp(logp_n) * (minq - alpha * logp_n),
                               dim=-1)
            y = rew + self.gamma * (1.0 - done) * v_next

        q1_all = mlp_apply(p_["q1"], obs)
        q2_all = mlp_apply(p_["q2"], obs)
        q1, q2 = q1_all[rows, acts], q2_all[rows, acts]
        q_loss = ((q1 - y) ** 2).mean() + ((q2 - y) ** 2).mean()

        # -- policy: minimize E[pi (alpha logpi - minQ)] -------------------
        logp = torch.log_softmax(mlp_apply(p_["pi"], obs), -1)
        p = torch.exp(logp)
        minq_pi = torch.minimum(q1_all.detach(), q2_all.detach())
        pi_loss = torch.sum(p * (alpha.detach() * logp - minq_pi),
                            dim=-1).mean()
        entropy = -torch.sum(p * logp, dim=-1).mean()

        # -- temperature ------------------------------------------------
        total = q_loss + pi_loss
        if self.autotune_alpha:
            total = total - p_["log_alpha"] * (-entropy.detach()
                                               + self.target_entropy)
        return total, {"q_loss": q_loss, "policy_loss": pi_loss,
                       "alpha": alpha, "entropy": entropy,
                       "mean_q": q1.mean()}

    def step(self, batch) -> Dict[str, torch.Tensor]:
        """One update on a minibatch of device tensors -> its stats as 0-d
        tensors (no host sync)."""
        loss, stats = self.losses(batch)
        self.opt.zero_grad(set_to_none=False)
        loss.backward()
        self.opt.step()
        polyak_(self.target, {"q1": self.params["q1"],
                              "q2": self.params["q2"]}, self.tau)
        return {k: v.detach() for k, v in
                {**stats, "total_loss": loss}.items()}

    def update(self, batch: SampleBatch) -> Dict[str, float]:
        stats = self.step(batch_to_device(batch, TRANSITION, self.device))
        return {k: float(v) for k, v in stats.items()}

    def get_weights(self):
        """``{pi, q1, q2, log_alpha}`` as numpy, in the JAX layout."""
        return rl_params_to_numpy(self.params)

    def set_weights(self, params) -> bool:
        copy_tree_(self.params, params)
        return True

    def get_state(self) -> dict:
        return {"params": self.get_weights(),
                "target": rl_params_to_numpy(self.target)}

    def set_state(self, state: dict) -> None:
        copy_tree_(self.params, state["params"])
        copy_tree_(self.target, state["target"])


class _SACCollector(DQNCollector):
    """Boltzmann (softmax-policy) collector: samples a~pi(.|s) from the SAC
    policy tower on the learner's device — the DQN vector-env machinery
    with the policy logits in place of Q-values and temperature-1
    sampling."""

    def collect(self, params, steps: int,
                epsilon: float = 0.0) -> SampleBatch:
        """``params``: the learner's tree of tensors (its ``pi``)."""
        rows = {k: [] for k in TRANSITION}
        for _ in range(steps):
            with torch.no_grad():
                logits = mlp_apply(params["pi"], torch.as_tensor(
                    self.obs, device=self.device)).cpu().numpy()
            z = logits - logits.max(axis=1, keepdims=True)
            p = np.exp(z)
            p /= p.sum(axis=1, keepdims=True)
            actions = np.array([self._rng.choice(p.shape[1], p=row)
                                for row in p])
            next_obs, rew, done, _ = self.env.vector_step(actions)
            rows[sb.OBS].append(self.obs.copy())
            rows[sb.ACTIONS].append(actions)
            rows[sb.REWARDS].append(rew)
            rows[sb.NEXT_OBS].append(next_obs.copy())
            rows[sb.DONES].append(done)
            self.obs = next_obs
        return transitions(rows)


class SAC(Algorithm):
    _default_config = SACConfig

    def setup(self) -> None:
        cfg = self.config
        self.learner = SACLearner(
            self.module_spec, lr=cfg.lr, gamma=cfg.gamma, tau=cfg.tau,
            initial_alpha=cfg.initial_alpha,
            autotune_alpha=cfg.autotune_alpha,
            target_entropy_scale=cfg.target_entropy_scale, seed=cfg.seed,
            device=self.device)
        self.buffer = ReplayBuffer(cfg.buffer_capacity, seed=cfg.seed)
        # in the driver's thread, as the JAX package's SAC holds it
        self.collector = _SACCollector(
            cfg.env, self.module_spec, cfg.num_envs_per_worker,
            seed=cfg.seed, device=self.device)

    def training_step(self) -> Dict[str, Any]:
        cfg = self.config
        batch = self.collector.collect(self.learner.params,
                                       cfg.rollout_fragment_length)
        self.buffer.add(batch)
        self._timesteps_total += batch.count
        stats: Dict[str, Any] = {}
        if len(self.buffer) >= cfg.learning_starts:
            for _ in range(cfg.updates_per_iter):
                stats = self.learner.step(batch_to_device(
                    self.buffer.sample(cfg.train_batch_size), TRANSITION,
                    self.device))
            stats = {k: float(v) for k, v in stats.items()}
        ep = self.collector.episode_stats()
        stats["episode_reward_mean"] = (
            ep["episode_reward_mean"] if ep["episodes"] else 0.0)
        stats["num_env_steps_sampled"] = self._timesteps_total
        return stats

    def get_state(self) -> dict:
        return self.learner.get_state()

    def set_state(self, state: dict) -> None:
        self.learner.set_state(state)
