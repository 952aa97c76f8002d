"""APPO — asynchronous PPO with V-trace off-policy correction. Ported from
``ray_tpu/rl/algorithms/appo.py``.

Role parity: rllib/algorithms/appo/appo.py (APPOConfig/APPO: IMPALA's
async sampling architecture + PPO's clipped surrogate, with V-trace
correcting the policy lag between sampler weights and learner weights).
The whole update — current-policy forward, sequence-level V-trace
(``rl/vtrace.py``), clipped surrogate, value + entropy, global-norm clip
and Adam — is one step per arriving worker batch on the learner's device;
the async loop is the driver's (``impala.async_training_step``).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ray_tpu_torch.rl import sample_batch as sb
from ray_tpu_torch.rl.algorithm import Algorithm, AlgorithmConfig, WorkerSet
from ray_tpu_torch.rl.algorithms.impala import (async_training_step,
                                                episode_result)
from ray_tpu_torch.rl.learner import ModuleLearner, host_tensor
from ray_tpu_torch.rl.sample_batch import SampleBatch
from ray_tpu_torch.rl.vtrace import vtrace_returns


class APPOConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.clip_param = 0.2
        self.vf_loss_coeff = 0.5
        self.entropy_coeff = 0.005
        self.rho_bar = 1.0            # V-trace rho truncation
        self.c_bar = 1.0              # V-trace c truncation
        self.grad_clip = 0.5
        self.algo_class = APPO


def appo_loss(module, params, batch, last_obs, *, clip_param: float,
              vf_loss_coeff: float, entropy_coeff: float, gamma: float,
              rho_bar: float, c_bar: float):
    """-> (total loss, stats) of one structured [T, N] batch (a dict of
    device tensors, flat rows in time-major order) whose rollouts end at
    ``last_obs`` [N, D]."""
    T, N = batch["rewards_tn"].shape
    logp, entropy, value = module.logp_entropy(params, batch[sb.OBS],
                                               batch[sb.ACTIONS])
    logp_tn = logp.reshape(T, N)
    value_tn = value.reshape(T, N)
    behavior_tn = batch[sb.ACTION_LOGP].reshape(T, N)
    # Bootstrap with the CURRENT value function so the tail target matches
    # the in-sequence values (no stale mix).
    bootstrap = module.apply(params, last_obs)[1]
    vs, pg_adv = vtrace_returns(
        behavior_tn, logp_tn, batch["rewards_tn"], value_tn,
        batch["dones_tn"], bootstrap, gamma=gamma, rho_bar=rho_bar,
        c_bar=c_bar)
    adv = pg_adv.reshape(-1)
    # jnp's std is the population std (ddof 0), not torch.std's default
    adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
    ratio = torch.exp(logp - batch[sb.ACTION_LOGP])
    surr = torch.minimum(
        ratio * adv, torch.clamp(ratio, 1 - clip_param, 1 + clip_param) * adv)
    pi_loss = -surr.mean()
    vf_loss = ((value_tn - vs) ** 2).mean()
    ent = entropy.mean()
    total = pi_loss + vf_loss_coeff * vf_loss - entropy_coeff * ent
    return total, {"policy_loss": pi_loss, "vf_loss": vf_loss,
                   "entropy": ent, "mean_rho": ratio.mean()}


class APPOLearner(ModuleLearner):
    """One V-trace + clipped-surrogate update per worker batch, on one device
    (``None`` = the card)."""

    def __init__(self, module_spec: dict, *, lr: float = 3e-4,
                 clip_param: float = 0.2, vf_loss_coeff: float = 0.5,
                 entropy_coeff: float = 0.005, gamma: float = 0.99,
                 rho_bar: float = 1.0, c_bar: float = 1.0,
                 grad_clip: float = 0.5, seed: int = 0, device=None):
        super().__init__(module_spec, lr=lr, grad_clip=grad_clip, seed=seed,
                         device=device)
        self.loss_kw = dict(clip_param=clip_param,
                            vf_loss_coeff=vf_loss_coeff,
                            entropy_coeff=entropy_coeff, gamma=gamma,
                            rho_bar=rho_bar, c_bar=c_bar)

    def step(self, feed, last_obs) -> Dict[str, torch.Tensor]:
        """One clipped Adam step on a structured batch of device tensors ->
        its stats as 0-d tensors (no host sync)."""
        return self.clipped_step(*appo_loss(self.module, self.params, feed,
                                            last_obs, **self.loss_kw))

    def update(self, batch: SampleBatch) -> Dict[str, float]:
        T, N = batch.rollout_shape
        # Only what the loss reads goes host->device (hot async loop).
        host = {
            sb.OBS: batch[sb.OBS], sb.ACTIONS: batch[sb.ACTIONS],
            sb.ACTION_LOGP: batch[sb.ACTION_LOGP],
            "rewards_tn": np.asarray(batch[sb.REWARDS]).reshape(T, N),
            "dones_tn": np.asarray(batch[sb.DONES]).reshape(T, N),
        }
        feed = {k: host_tensor(v).to(device=self.device, dtype=torch.float32)
                for k, v in host.items()}
        last_obs = host_tensor(batch.last_obs).to(device=self.device,
                                                  dtype=torch.float32)
        stats = self.step(feed, last_obs)
        return {k: float(v) for k, v in stats.items()}


class APPO(Algorithm):
    _default_config = APPOConfig

    def setup(self) -> None:
        cfg: APPOConfig = self.config  # type: ignore[assignment]
        self.learner = APPOLearner(
            self.module_spec, lr=cfg.lr, clip_param=cfg.clip_param,
            vf_loss_coeff=cfg.vf_loss_coeff,
            entropy_coeff=cfg.entropy_coeff, gamma=cfg.gamma,
            rho_bar=cfg.rho_bar, c_bar=cfg.c_bar, grad_clip=cfg.grad_clip,
            seed=cfg.seed, device=self.device)
        self.workers = WorkerSet(cfg, self.module_spec, self.device)
        self._weights_ref = self.workers.sync_weights(
            self.learner.get_weights())
        # Async pipeline (impala.py pattern): one STRUCTURED sample in
        # flight per worker; v-trace absorbs the weights lag.
        self._inflight: Dict[Any, Any] = {}
        for w in self.workers.workers:
            self._inflight[w.sample.remote(self._weights_ref,
                                           structured=True)] = w

    def training_step(self) -> Dict[str, Any]:
        def dispatch(worker):
            self._weights_ref = self.workers.sync_weights(
                self.learner.get_weights())
            self._inflight[worker.sample.remote(self._weights_ref,
                                                structured=True)] = worker

        count, stats = async_training_step(
            self._inflight, self.config.train_batch_size,
            self.learner.update, dispatch)
        self._timesteps_total += count
        return episode_result(self.workers, count, stats)

    def get_state(self) -> dict:
        return {"weights": self.learner.get_weights()}

    def set_state(self, state: dict) -> None:
        self.learner.set_weights(state["weights"])
        self._weights_ref = self.workers.sync_weights(state["weights"])

    def stop(self) -> None:
        # killing a worker fails its in-flight sample, so nothing waits on it
        self.workers.stop()
        self._inflight.clear()
