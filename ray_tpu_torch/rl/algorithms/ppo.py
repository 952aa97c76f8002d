"""PPO (parity: rllib/algorithms/ppo — sync sample + clipped-surrogate
minibatch SGD). Ported from ``ray_tpu/rl/algorithms/ppo.py``: the rollout
workers and the learner run as actors of the port's in-process runtime, on
the config's ``device`` (``None`` = the card)."""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

import ray_tpu_torch as rt
from ray_tpu_torch.rl.algorithm import Algorithm, AlgorithmConfig, WorkerSet
from ray_tpu_torch.rl.learner import LearnerGroup, PPOLearner
from ray_tpu_torch.rl.sample_batch import SampleBatch


class PPOConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.clip_param = 0.2
        self.vf_clip_param = 10.0
        self.vf_loss_coeff = 0.5
        self.entropy_coeff = 0.0
        self.num_sgd_iter = 6
        self.sgd_minibatch_size = 128
        self.grad_clip = 0.5
        self.algo_class = PPO


class PPO(Algorithm):
    def setup(self) -> None:
        cfg: PPOConfig = self.config  # type: ignore[assignment]
        self.learner_group = LearnerGroup(
            PPOLearner,
            dict(module_spec=self.module_spec, lr=cfg.lr,
                 clip_param=cfg.clip_param, vf_clip_param=cfg.vf_clip_param,
                 vf_loss_coeff=cfg.vf_loss_coeff,
                 entropy_coeff=cfg.entropy_coeff,
                 num_sgd_iter=cfg.num_sgd_iter,
                 sgd_minibatch_size=cfg.sgd_minibatch_size,
                 grad_clip=cfg.grad_clip, seed=cfg.seed, device=self.device),
            remote=cfg.learner_remote, num_gpus=cfg.learner_num_gpus)
        self.workers = WorkerSet(cfg, self.module_spec, self.device)
        self._weights_ref = self.workers.sync_weights(
            self.learner_group.get_weights())

    def training_step(self) -> Dict[str, Any]:
        # 1. synchronous parallel sampling (rollout_ops role)
        batches = self.workers.sample(self._weights_ref)
        train_batch = SampleBatch.concat_samples(batches)
        self._timesteps_total += train_batch.count
        # 2. learner update (minibatch SGD epochs)
        stats = self.learner_group.update(train_batch)
        # 3. broadcast new weights through the object store
        self._weights_ref = self.workers.sync_weights(
            self.learner_group.get_weights())
        ep = self.workers.episode_stats()
        means = [s["episode_reward_mean"] for s in ep
                 if s["episodes"] > 0]
        return {
            "episode_reward_mean": float(np.mean(means)) if means
            else float("nan"),
            "episodes_total": int(sum(s["episodes"] for s in ep)),
            "num_env_steps_sampled": train_batch.count,
            **{f"info/{k}": v for k, v in stats.items()},
        }

    def get_state(self) -> dict:
        return {"weights": self.learner_group.get_weights()}

    def set_state(self, state: dict) -> None:
        if self.learner_group.remote:
            rt.get(self.learner_group.actor.set_weights.remote(
                state["weights"]))
        else:
            self.learner_group.local.set_weights(state["weights"])
        self._weights_ref = self.workers.sync_weights(state["weights"])

    def stop(self) -> None:
        self.workers.stop()
        self.learner_group.shutdown()
