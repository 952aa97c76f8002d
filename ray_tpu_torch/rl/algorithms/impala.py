"""IMPALA-style async actor-critic. Ported from
``ray_tpu/rl/algorithms/impala.py``.

Role parity: rllib/algorithms/impala (async sample RPCs feeding a learner,
impala.py:497-508 LearnerThread role). Sampling is decoupled: each rollout
worker always has one sample call in flight, on either port runtime; the
driver consumes whichever finishes first (``rt.wait``), updates with an
importance-weighted loss (clipped-rho correction for the policy lag), and
re-dispatches that worker with fresh weights. Batches are consumed in
arrival order, which the workers' threads or processes decide, so a run is
not deterministic. The learner runs on the config's ``device`` (``None`` =
the card), the workers where ``algorithm.sampler_placement`` puts them.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np

import ray_tpu_torch as rt
from ray_tpu_torch.rl.algorithm import Algorithm, AlgorithmConfig, WorkerSet
from ray_tpu_torch.rl.learner import LearnerGroup, PPOLearner


def async_training_step(inflight: Dict[Any, Any], target: int, update,
                        dispatch) -> Tuple[int, Dict[str, float]]:
    """Shared IMPALA/APPO async driver loop (LearnerThread role): consume
    whichever in-flight sample finishes first, update, re-dispatch that
    worker with fresh weights. ``dispatch(worker)`` must register the
    worker's next sample ref into ``inflight``."""
    count, stats = 0, {}
    while count < target:
        ready, _ = rt.wait(list(inflight), num_returns=1, timeout=600)
        if not ready:
            # Surface a real diagnosis instead of IndexError: every worker
            # stalled past the deadline (dead daemon, hung env, ...).
            raise TimeoutError(
                f"no rollout batch arrived within 600s from "
                f"{len(inflight)} in-flight rollout workers")
        ref = ready[0]
        worker = inflight.pop(ref)
        batch = rt.get(ref)
        count += batch.count
        stats = update(batch)
        dispatch(worker)
    return count, stats


def episode_result(workers: WorkerSet, count: int,
                   stats: Dict[str, float]) -> Dict[str, Any]:
    """IMPALA's and APPO's ``training_step`` result."""
    ep = workers.episode_stats()
    means = [s["episode_reward_mean"] for s in ep if s["episodes"] > 0]
    return {
        "episode_reward_mean": float(np.mean(means)) if means
        else float("nan"),
        "num_env_steps_sampled": count,
        **{f"info/{k}": v for k, v in stats.items()},
    }


class ImpalaConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.clip_rho = 1.0          # V-trace-style IS clip
        self.entropy_coeff = 0.01
        self.vf_loss_coeff = 0.5
        self.num_sgd_iter = 1        # IMPALA: single pass per batch
        self.sgd_minibatch_size = 512
        self.algo_class = Impala


class ImpalaLearner(PPOLearner):
    """Importance-weighted AC update: like the PPO learner but with a
    one-sided rho clip standing in for V-trace's truncated IS weights
    (sequence-level V-trace is APPO's learner)."""

    def __init__(self, module_spec: dict, *, clip_rho: float = 1.0,
                 **kwargs):
        kwargs.setdefault("clip_param", clip_rho)
        super().__init__(module_spec, **kwargs)


class Impala(Algorithm):
    def setup(self) -> None:
        cfg: ImpalaConfig = self.config  # type: ignore[assignment]
        self.learner_group = LearnerGroup(
            ImpalaLearner,
            dict(module_spec=self.module_spec, lr=cfg.lr,
                 clip_rho=cfg.clip_rho, vf_loss_coeff=cfg.vf_loss_coeff,
                 entropy_coeff=cfg.entropy_coeff,
                 num_sgd_iter=cfg.num_sgd_iter,
                 sgd_minibatch_size=cfg.sgd_minibatch_size, seed=cfg.seed,
                 device=self.device),
            remote=cfg.learner_remote, num_gpus=cfg.learner_num_gpus)
        self.workers = WorkerSet(cfg, self.module_spec, self.device)
        self._weights_ref = self.workers.sync_weights(
            self.learner_group.get_weights())
        # Pipeline: every worker keeps exactly one sample() in flight.
        self._inflight: Dict[Any, Any] = {}
        for w in self.workers.workers:
            self._inflight[w.sample.remote(self._weights_ref)] = w

    def training_step(self) -> Dict[str, Any]:
        def dispatch(worker):
            self._weights_ref = self.workers.sync_weights(
                self.learner_group.get_weights())
            self._inflight[worker.sample.remote(self._weights_ref)] = worker

        count, stats = async_training_step(
            self._inflight, self.config.train_batch_size,
            self.learner_group.update, dispatch)
        self._timesteps_total += count
        return episode_result(self.workers, count, stats)

    def get_state(self) -> dict:
        return {"weights": self.learner_group.get_weights()}

    def set_state(self, state: dict) -> None:
        self.learner_group.set_weights(state["weights"])
        self._weights_ref = self.workers.sync_weights(state["weights"])

    def stop(self) -> None:
        # killing a worker fails its in-flight sample, so nothing waits on it
        self.workers.stop()
        self._inflight.clear()
        self.learner_group.shutdown()
