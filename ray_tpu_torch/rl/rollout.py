"""RolloutWorker: steps a vectorized env on the host with the policy on a
device. Ported from ``ray_tpu/rl/rollout.py``.

The inner loop is one batched policy forward per env step over the whole
vector env, with one host sync a step (actions, logp and value come back
together), and GAE computed vectorized over the [T, N] rollout on the host.
"""

from __future__ import annotations

import os
from typing import Any, Optional

import numpy as np
import torch

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.models.convert import _map_rl, rl_params_from_jax
from ray_tpu_torch.rl import sample_batch as sb
from ray_tpu_torch.rl.env import episode_stats_of, make_env
from ray_tpu_torch.rl.module import _first_leaf, make_module
from ray_tpu_torch.rl.sample_batch import SampleBatch


def compute_gae(rewards, values, dones, last_value, gamma: float,
                lam: float):
    """Vectorized GAE over [T, N] arrays -> (advantages, value_targets)."""
    T, N = rewards.shape
    adv = np.zeros((T, N), dtype=np.float32)
    lastgaelam = np.zeros(N, dtype=np.float32)
    for t in reversed(range(T)):
        nextvalue = last_value if t == T - 1 else values[t + 1]
        nonterminal = 1.0 - dones[t]
        delta = rewards[t] + gamma * nextvalue * nonterminal - values[t]
        lastgaelam = delta + gamma * lam * nonterminal * lastgaelam
        adv[t] = lastgaelam
    return adv, adv + values


def use_threads(num_threads: Optional[int]) -> None:
    """Set this process's torch intra-op threads, unless ``None``: a sampling
    actor in a worker process takes one a CPU it holds
    (``algorithm.sampler_placement``)."""
    if num_threads is not None:
        torch.set_num_threads(num_threads)


def where(device) -> dict:
    """Where a sampling actor runs: its process, the cards the process may
    see (``CUDA_VISIBLE_DEVICES``), whether it made a CUDA context, its
    device and torch's intra-op threads."""
    return {"pid": os.getpid(),
            "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
            "cuda_initialized": torch.cuda.is_initialized(),
            "device": str(device), "threads": torch.get_num_threads()}


def place_params(params, module, device: torch.device):
    """Weights for ``module`` on ``device``: a numpy tree in the JAX
    package's layout (what either stack's ``PPOLearner.get_weights``
    returns) goes through ``rl_params_from_jax``; a tree of the port's
    tensors is copied to the device."""
    if isinstance(_first_leaf(params), torch.Tensor):
        return _map_rl(params, lambda _, t: t.detach().to(device))
    return rl_params_from_jax(params, module, device=device)


class RolloutWorker:
    """One sampling worker: the env on the host, the policy forward on
    ``device`` (``None`` = the card; ``"cpu"`` as the JAX package's CPU
    rollout actors), with ``num_threads`` torch threads if given."""

    def __init__(self, env: Any, module_spec: dict, rollout_length: int,
                 num_envs: int, gamma: float, lam: float, seed: int = 0,
                 device=None, num_threads: Optional[int] = None):
        use_threads(num_threads)
        self.device = resolve_device(device)
        self.env = make_env(env, num_envs=num_envs, seed=seed)
        self.module = make_module(module_spec)
        self.rollout_length = rollout_length
        self.gamma = gamma
        self.lam = lam
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.obs = self.env.vector_reset(seed=seed)
        self.params = None

    def set_weights(self, params) -> bool:
        self.params = place_params(params, self.module, self.device)
        return True

    @torch.no_grad()
    def _policy(self, obs):
        """-> (actions, logp, value) as host numpy, in one device sync."""
        actions, logp, value = self.module.sample_actions(
            self.params, obs, self.generator)
        n = logp.shape[0]
        both = torch.cat([actions.reshape(n, -1).to(logp.dtype),
                          logp[:, None], value[:, None]], dim=1)
        both = both.cpu().numpy()
        actions = both[:, :-2].reshape(actions.shape)
        if self.module.num_actions > 0:
            actions = actions.astype(np.int32)
        return actions, both[:, -2], both[:, -1]

    def sample(self, params: Optional[Any] = None,
               structured: bool = False) -> SampleBatch:
        """Collect rollout_length * num_envs transitions with GAE.

        structured=True skips GAE and attaches the [T, N] layout and the
        final observation as batch attributes (the learner-side V-trace
        path computes its own targets from the behavior logps)."""
        if params is not None:
            self.set_weights(params)
        T, N = self.rollout_length, self.env.num_envs
        obs_buf = np.empty((T, N, self.env.observation_dim), np.float32)
        # Continuous modules with action_dim>1 emit [N, k] actions.
        act_dim = getattr(self.module, "action_dim", 1)
        act_shape = (T, N) if (self.module.num_actions > 0 or act_dim == 1) \
            else (T, N, act_dim)
        act_buf = np.empty(act_shape, np.float32)
        rew_buf = np.empty((T, N), np.float32)
        done_buf = np.empty((T, N), np.float32)
        logp_buf = np.empty((T, N), np.float32)
        val_buf = np.empty((T, N), np.float32)
        for t in range(T):
            actions, logp_buf[t], val_buf[t] = self._policy(self.obs)
            obs_buf[t] = self.obs
            act_buf[t] = actions
            self.obs, rew_buf[t], done_buf[t], _ = \
                self.env.vector_step(actions)
        flat = lambda x: x.reshape(T * N, *x.shape[2:])
        batch = SampleBatch({
            sb.OBS: flat(obs_buf), sb.ACTIONS: flat(act_buf),
            sb.REWARDS: flat(rew_buf), sb.DONES: flat(done_buf),
            sb.ACTION_LOGP: flat(logp_buf),
        })
        if structured:
            # The learner bootstraps with ITS OWN value function: ship the
            # final observation, not a stale behavior-policy value.
            batch.rollout_shape = (T, N)
            batch.last_obs = np.asarray(self.obs, np.float32)
            return batch
        with torch.no_grad():
            last_value = self.module.apply(self.params, self.obs)[1]
        adv, targets = compute_gae(rew_buf, val_buf, done_buf,
                                   last_value.cpu().numpy(),
                                   self.gamma, self.lam)
        batch[sb.VF_PREDS] = flat(val_buf)
        batch[sb.ADVANTAGES] = flat(adv)
        batch[sb.VALUE_TARGETS] = flat(targets)
        return batch

    def episode_stats(self) -> dict:
        return episode_stats_of(self.env)

    def ping(self) -> str:
        return "pong"

    def where(self) -> dict:
        return where(self.device)
