"""CQL — conservative Q-learning from offline data (discrete variant). Ported
from ``ray_tpu/rl/algorithms/cql.py``.

Role parity: rllib/algorithms/cql/cql.py (CQL = SAC/DQN + a conservative
regularizer keeping Q-values of out-of-dataset actions low, Kumar et al.
2020). Discrete form on a Q MLP:

    L = TD(double-Q with target net)  +  alpha * CQL(H)
    CQL(H) = E_s[ logsumexp_a Q(s, a) - Q(s, a_data) ]

One update a batch on the config's ``device`` (``None`` = the card): TD +
regularizer, Adam, then the polyak target; data streamed from the offline
JsonReader — no environment interaction during training; evaluation rolls
the greedy policy on the live env.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.models.convert import rl_params_to_numpy
from ray_tpu_torch.rl import sample_batch as sb
from ray_tpu_torch.rl.algorithms.dqn import TRANSITION
from ray_tpu_torch.rl.env import make_env
from ray_tpu_torch.rl.learner import (adam, batch_to_device, clone_tree,
                                      copy_tree_, polyak_, seeded_init,
                                      trainable_)
from ray_tpu_torch.rl.module import mlp_apply, mlp_init
from ray_tpu_torch.rl.offline import BCConfig, JsonReader, greedy_return


class CQLConfig(BCConfig):
    def __init__(self):
        super().__init__()
        self.gamma = 0.99
        self.alpha = 1.0              # conservatism weight
        self.tau = 0.005              # polyak target mix
        self.lr = 5e-4
        self.algo_class = CQL


class CQL:
    def __init__(self, config: CQLConfig):
        # before the dataset: no card and device=None raises here
        self.device = resolve_device(config.device)
        self.config = config
        self.reader = JsonReader(config.input_path, seed=config.seed)
        probe = make_env(config.env, num_envs=1, seed=config.seed)
        if probe.num_actions <= 0:
            raise ValueError("the discrete CQL variant needs a discrete "
                             "action space")
        self.num_actions = probe.num_actions
        sizes = (probe.observation_dim, *config.model_hiddens,
                 self.num_actions)
        self.params = seeded_init(
            lambda gen, dev: {"q": mlp_init(gen, sizes, dev)}, config.seed,
            self.device)
        self.target = clone_tree(self.params)
        self.opt = adam(trainable_(self.params), config.lr)
        self.iteration = 0

    def step(self, batch) -> Dict[str, torch.Tensor]:
        """One update on a minibatch of device tensors -> its stats as 0-d
        tensors (no host sync)."""
        cfg = self.config
        q = mlp_apply(self.params["q"], batch[sb.OBS])
        rows = torch.arange(q.shape[0], device=q.device)
        qa = q[rows, batch[sb.ACTIONS].long()]
        with torch.no_grad():
            # double-Q target: online argmax, target value
            a_star = torch.argmax(
                mlp_apply(self.params["q"], batch[sb.NEXT_OBS]), dim=1)
            q_next = mlp_apply(self.target["q"], batch[sb.NEXT_OBS])
            td_target = batch[sb.REWARDS] + cfg.gamma * (
                1 - batch[sb.DONES]) * q_next[rows, a_star]
        td_loss = torch.mean((qa - td_target) ** 2)
        # conservative penalty: push down unseen actions' Q
        cql_loss = torch.mean(torch.logsumexp(q, dim=1) - qa)
        total = td_loss + cfg.alpha * cql_loss
        self.opt.zero_grad(set_to_none=False)
        total.backward()
        self.opt.step()
        polyak_(self.target, self.params, cfg.tau)
        return {"td_loss": td_loss.detach(), "cql_loss": cql_loss.detach(),
                "mean_q": qa.detach().mean(), "total_loss": total.detach()}

    def train(self) -> Dict[str, Any]:
        stats: Dict[str, Any] = {}
        for _ in range(self.config.updates_per_iter):
            stats = self.step(batch_to_device(
                self.reader.sample(self.config.train_batch_size),
                TRANSITION, self.device))
        self.iteration += 1
        return {k: float(v) for k, v in stats.items()} | {
            "training_iteration": self.iteration}

    def get_weights(self):
        """``{"q": ...}`` as numpy, in the JAX layout."""
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

    @torch.no_grad()
    def _greedy(self, obs) -> np.ndarray:
        q = mlp_apply(self.params["q"], torch.as_tensor(obs,
                                                        device=self.device))
        return torch.argmax(q, dim=-1).cpu().numpy()

    def evaluate(self, num_episodes: int = 10) -> Dict[str, float]:
        return {"episode_reward_mean": greedy_return(
            self.config.env, self.config.seed, self._greedy, num_episodes)}
