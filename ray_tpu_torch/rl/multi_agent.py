"""Multi-agent sampling: per-agent transitions through shared or mapped
policies. Ported from ``ray_tpu/rl/multi_agent.py``.

Role parity: rllib/env/multi_agent_env.py:30 (the dict-keyed protocol in
rl/env.MultiAgentEnv) + the multi-agent half of the sample collector
(rllib/evaluation/env_runner_v2.py): each step, every live agent's
(obs, action, reward, done) lands in the batch of the policy
``policy_mapping_fn`` assigns it to. Parameter sharing (all agents -> one
policy) is the default: one forward serves every agent in a single batched
call on the device.

Deliberate divergence: the JAX collector splits a ``jax.random`` key for
each policy's draw. The port draws from one ``torch.Generator`` on its
device, seeded ``seed``, as ``RolloutWorker`` does: the same law
(categorical by Gumbel-max, or gaussian), other numbers.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.rl import sample_batch as sb
from ray_tpu_torch.rl.env import MultiAgentEnv
from ray_tpu_torch.rl.rollout import place_params
from ray_tpu_torch.rl.sample_batch import SampleBatch

AGENT_ID = "agent_id"


class MultiAgentCollector:
    """Steps one MultiAgentEnv, batching all agents through each policy's
    forward once per step. The policies run on ``device`` (``None`` = the
    card); ``params`` maps each policy to a numpy tree in the JAX layout or
    to the port's tensors."""

    def __init__(self, env: MultiAgentEnv, modules: Dict[str, Any],
                 params: Dict[str, Any],
                 policy_mapping_fn: Optional[Callable[[str], str]] = None,
                 seed: int = 0, device=None):
        self.device = resolve_device(device)
        self.env = env
        self.modules = modules
        self.params: Dict[str, Any] = {}
        self.set_params(params)
        self.policy_mapping_fn = policy_mapping_fn or (
            lambda agent_id: next(iter(modules)))
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self._obs = env.reset()
        self.episode_returns: List[float] = []
        self._ep_return = 0.0

    def set_params(self, params: Dict[str, Any]) -> None:
        self.params.update({
            pid: place_params(p, self.modules[pid], self.device)
            for pid, p in params.items()})

    @torch.no_grad()
    def _sample(self, pid: str, obs: np.ndarray) -> np.ndarray:
        """One batched draw of policy ``pid`` -> its actions on the host, in
        one sync."""
        module = self.modules[pid]
        actions, _logp, _v = module.sample_actions(
            self.params[pid], obs, self.generator)
        actions = actions.cpu().numpy()
        return actions.astype(np.int32) if module.num_actions > 0 \
            else actions

    def collect(self, num_steps: int) -> Dict[str, SampleBatch]:
        """Run ``num_steps`` env steps; returns one SampleBatch per policy
        (rows carry AGENT_ID so callers can regroup)."""
        rows: Dict[str, Dict[str, list]] = {
            pid: {k: [] for k in (sb.OBS, sb.ACTIONS, sb.REWARDS,
                                  sb.NEXT_OBS, sb.DONES, AGENT_ID)}
            for pid in self.modules}
        for _ in range(num_steps):
            # group live agents by policy; ONE batched forward per policy
            by_policy: Dict[str, List[str]] = {}
            for agent in self._obs:
                by_policy.setdefault(
                    self.policy_mapping_fn(agent), []).append(agent)
            actions: Dict[str, Any] = {}
            for pid, agents in by_policy.items():
                obs = np.stack([np.asarray(self._obs[a], np.float32)
                                for a in agents])
                a = self._sample(pid, obs)
                for i, agent in enumerate(agents):
                    actions[agent] = a[i]
            nxt, rewards, dones, all_done, _infos = self.env.step(actions)
            for pid, agents in by_policy.items():
                r = rows[pid]
                for agent in agents:
                    if agent not in rewards:
                        continue
                    r[sb.OBS].append(np.asarray(self._obs[agent],
                                                np.float32))
                    r[sb.ACTIONS].append(actions[agent])
                    r[sb.REWARDS].append(rewards[agent])
                    r[sb.NEXT_OBS].append(np.asarray(
                        nxt.get(agent, self._obs[agent]), np.float32))
                    r[sb.DONES].append(bool(dones.get(agent, False)))
                    r[AGENT_ID].append(agent)
            self._ep_return += float(sum(rewards.values()))
            if all_done.get("__all__"):
                self.episode_returns.append(self._ep_return)
                self._ep_return = 0.0
                self._obs = self.env.reset()
            else:
                self._obs = nxt
        out = {}
        for pid, r in rows.items():
            if not r[sb.OBS]:
                continue
            out[pid] = SampleBatch({
                sb.OBS: np.stack(r[sb.OBS]),
                sb.ACTIONS: np.asarray(r[sb.ACTIONS]),
                sb.REWARDS: np.asarray(r[sb.REWARDS], np.float32),
                sb.NEXT_OBS: np.stack(r[sb.NEXT_OBS]),
                sb.DONES: np.asarray(r[sb.DONES], np.float32),
                AGENT_ID: np.asarray(r[AGENT_ID]),
            })
        return out


class TwoStepCoopEnv(MultiAgentEnv):
    """Tiny cooperative test env (the spirit of rllib's TwoStepGame):
    both agents see the phase; reward 1 each when their actions MATCH,
    0 otherwise; episodes last ``horizon`` steps. A copy of the JAX
    package's."""

    def __init__(self, horizon: int = 8, seed: int = 0):
        self.horizon = horizon
        self._t = 0
        self._rng = np.random.default_rng(seed)
        self.observation_dim = 2
        self.num_actions = 2

    def _obs(self):
        phase = self._t / max(self.horizon, 1)
        return {a: np.array([phase, 1.0], np.float32)
                for a in ("agent_0", "agent_1")}

    def reset(self):
        self._t = 0
        return self._obs()

    def step(self, actions):
        self._t += 1
        match = int(actions["agent_0"]) == int(actions["agent_1"])
        rew = {a: 1.0 if match else 0.0 for a in actions}
        done = self._t >= self.horizon
        dones = {a: done for a in actions}
        return self._obs(), rew, dones, {"__all__": done}, {}
