"""Offline RL IO: experience writers/readers + behavior cloning (BC) and
MARWIL. Ported from ``ray_tpu/rl/offline.py``.

Role parity: rllib/offline/json_writer.py (JsonWriter — SampleBatches to
newline-delimited JSON shards), rllib/offline/json_reader.py (JsonReader —
shards back to SampleBatches, shuffled sampling), and the BC and MARWIL
algorithms (rllib/algorithms/bc, rllib/algorithms/marwil) on the shared
RLModule policy tower. The IO is a copy of the JAX package's (pure Python
and numpy), so shards written by either stack read in the other. The
learners run on the config's ``device`` (``None`` = the card; set by
``.resources(device=...)``).
"""

from __future__ import annotations

import glob
import json
import os
from typing import Any, Dict, Iterator, List

import numpy as np
import torch

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.models.convert import rl_params_to_numpy
from ray_tpu_torch.rl import sample_batch as sb
from ray_tpu_torch.rl.env import make_env
from ray_tpu_torch.rl.learner import (adam, batch_to_device, copy_tree_,
                                      seeded_init, trainable_)
from ray_tpu_torch.rl.module import RLModule
from ray_tpu_torch.rl.sample_batch import SampleBatch


class JsonWriter:
    """Write SampleBatches as newline-delimited JSON shard files."""

    def __init__(self, path: str, max_rows_per_file: int = 5000):
        self.path = path
        os.makedirs(path, exist_ok=True)
        self.max_rows = max_rows_per_file
        self._shard = 0
        self._rows_in_shard = 0
        self._fh = None

    def _file(self):
        if self._fh is None or self._rows_in_shard >= self.max_rows:
            if self._fh is not None:
                self._fh.close()
            self._fh = open(os.path.join(
                self.path, f"experiences-{self._shard:05d}.json"), "w")
            self._shard += 1
            self._rows_in_shard = 0
        return self._fh

    def write(self, batch: SampleBatch) -> None:
        cols = {k: np.asarray(v) for k, v in batch.items()}
        n = batch.count
        for i in range(n):
            row = {k: cols[k][i].tolist() for k in cols}
            f = self._file()   # rotates shards at max_rows_per_file
            f.write(json.dumps(row) + "\n")
            self._rows_in_shard += 1
        if self._fh is not None:
            self._fh.flush()

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None


class JsonReader:
    """Read experience shards back as SampleBatches."""

    def __init__(self, path: str, shuffle: bool = True, seed: int = 0):
        if os.path.isdir(path):
            self.files = sorted(glob.glob(
                os.path.join(path, "*.json")))
        else:
            self.files = sorted(glob.glob(path))
        if not self.files:
            raise FileNotFoundError(f"no experience files under {path!r}")
        # Columnar in-memory layout: one numpy array per field (row dicts
        # cost ~10x in object overhead and a re-conversion per sample()).
        rows: List[dict] = []
        for fp in self.files:
            with open(fp) as f:
                for line in f:
                    line = line.strip()
                    if line:
                        rows.append(json.loads(line))
        if not rows:
            raise ValueError(f"experience files under {path!r} are empty")
        self._cols: Dict[str, np.ndarray] = {
            k: np.asarray([r[k] for r in rows]) for k in rows[0]}
        self._n = len(rows)
        self._rng = np.random.default_rng(seed)
        self._shuffle = shuffle

    def __len__(self) -> int:
        return self._n

    def _take(self, idx) -> SampleBatch:
        return SampleBatch({k: v[idx] for k, v in self._cols.items()})

    def read_all(self) -> SampleBatch:
        return SampleBatch(dict(self._cols))

    def sample(self, num_rows: int) -> SampleBatch:
        idx = self._rng.integers(0, self._n, num_rows) \
            if self._shuffle else np.arange(num_rows) % self._n
        return self._take(idx)

    def iter_batches(self, batch_size: int = 256) -> Iterator[SampleBatch]:
        order = self._rng.permutation(self._n) if self._shuffle \
            else np.arange(self._n)
        for start in range(0, self._n, batch_size):
            yield self._take(order[start:start + batch_size])


def collect_experiences(env: Any, path: str, num_steps: int = 2000,
                        num_envs: int = 8, seed: int = 0,
                        policy_fn=None) -> str:
    """Roll a (random or given) policy and persist the transitions — the
    dataset-generation half of the offline workflow (parity: `rllib train
    ... --output`). All on the host: ``policy_fn`` maps an observation
    batch to actions."""
    venv = make_env(env, num_envs=num_envs, seed=seed)
    if policy_fn is None and venv.num_actions <= 0:
        raise NotImplementedError(
            "random-policy collection covers discrete action spaces; pass "
            "policy_fn for continuous envs")
    rng = np.random.default_rng(seed)
    writer = JsonWriter(path)
    obs = venv.vector_reset(seed=seed)
    rows = {k: [] for k in (sb.OBS, sb.ACTIONS, sb.REWARDS, sb.NEXT_OBS,
                            sb.DONES)}
    steps = 0
    while steps < num_steps:
        if policy_fn is None:
            actions = rng.integers(0, venv.num_actions, venv.num_envs)
        else:
            actions = np.asarray(policy_fn(obs))
        nxt, rew, done, _ = venv.vector_step(actions)
        rows[sb.OBS].append(obs.copy())
        rows[sb.ACTIONS].append(actions)
        rows[sb.REWARDS].append(rew)
        rows[sb.NEXT_OBS].append(nxt.copy())
        rows[sb.DONES].append(done)
        obs = nxt
        steps += venv.num_envs
    writer.write(SampleBatch({
        k: np.concatenate(v) if np.asarray(v[0]).ndim > 1
        else np.concatenate([np.asarray(x).reshape(-1) for x in v])
        for k, v in rows.items()}))
    writer.close()
    return path


def greedy_return(env: Any, seed: int, act, num_episodes: int) -> float:
    """Mean return of ``num_episodes`` episodes of ``act`` (observations
    -> numpy actions) on 8 envs of ``env`` seeded ``seed + 1``."""
    venv = make_env(env, num_envs=8, seed=seed + 1)
    obs = venv.vector_reset(seed=seed + 1)
    while len(venv.completed_returns) < num_episodes:
        obs, _, _, _ = venv.vector_step(act(obs))
    return float(np.mean(venv.completed_returns[:num_episodes]))


class BCConfig:
    """Behavior-cloning config (parity: rllib/algorithms/bc/bc.py). The JAX
    package's has no ``AlgorithmConfig`` base; the port adds ``device`` and
    ``.resources(device=...)``."""

    def __init__(self):
        self.env = "CartPole-v1"     # for eval only
        self.input_path = ""
        self.lr = 1e-3
        self.train_batch_size = 256
        self.updates_per_iter = 50
        self.model_hiddens = (64, 64)
        self.seed = 0
        self.device = None           # None = the CUDA card
        self.algo_class = BC

    def offline_data(self, *, input_path: str) -> "BCConfig":
        self.input_path = input_path
        return self

    def training(self, **kw) -> "BCConfig":
        for k, v in kw.items():
            setattr(self, k, v)
        return self

    def resources(self, *, device=None) -> "BCConfig":
        """``device``: where the learner runs (``"cpu"``, ``"cuda"``); left
        unset, the card."""
        if device is not None:
            self.device = device
        return self

    def build(self):
        return self.algo_class(self)


class BC:
    """Supervised policy learning from offline experiences: maximize
    log pi(a_t | s_t) over the dataset on the shared RLModule."""

    # the dataset columns the loss reads
    COLUMNS = (sb.OBS, sb.ACTIONS)

    def __init__(self, config: BCConfig):
        # before the dataset: no card and device=None raises here
        self.device = resolve_device(config.device)
        self.config = config
        self.reader = JsonReader(config.input_path, seed=config.seed)
        probe = make_env(config.env, num_envs=1, seed=config.seed)
        self.module = RLModule(
            obs_dim=probe.observation_dim, num_actions=probe.num_actions,
            hiddens=tuple(config.model_hiddens))
        self.params = seeded_init(self.module.init, config.seed,
                                  self.device)
        self.opt = adam(trainable_(self.params), config.lr)
        self.iteration = 0

    def loss(self, batch):
        logp, entropy, _ = self.module.logp_entropy(
            self.params, batch[sb.OBS], batch[sb.ACTIONS])
        return -logp.mean(), {"bc_logp": logp.mean(),
                              "entropy": entropy.mean()}

    def step(self, batch) -> Dict[str, torch.Tensor]:
        """One Adam step on a minibatch of device tensors -> its stats as
        0-d tensors (no host sync)."""
        loss, stats = self.loss(batch)
        self.opt.zero_grad(set_to_none=False)
        loss.backward()
        self.opt.step()
        return {k: v.detach() for k, v in
                {**stats, "total_loss": loss}.items()}

    def train(self) -> Dict[str, Any]:
        stats: Dict[str, Any] = {}
        for _ in range(self.config.updates_per_iter):
            batch = self.reader.sample(self.config.train_batch_size)
            stats = self.step(batch_to_device(batch, self.COLUMNS,
                                              self.device))
        self.iteration += 1
        return {k: float(v) for k, v in stats.items()} | {
            "training_iteration": self.iteration}

    def get_weights(self):
        """The module's tree as numpy, in the JAX layout."""
        return rl_params_to_numpy(self.params)

    def set_weights(self, params) -> bool:
        copy_tree_(self.params, params)
        return True

    @torch.no_grad()
    def _greedy(self, obs) -> np.ndarray:
        return self.module.greedy_actions(self.params, obs).cpu().numpy()

    # (MARWIL below reuses this BC eval verbatim via inheritance.)
    def evaluate(self, num_episodes: int = 10) -> Dict[str, float]:
        """Greedy rollout of the cloned policy on the live env."""
        return {"episode_reward_mean": greedy_return(
            self.config.env, self.config.seed, self._greedy, num_episodes)}


class MARWILConfig(BCConfig):
    """MARWIL config (parity: rllib/algorithms/marwil/marwil.py)."""

    def __init__(self):
        super().__init__()
        self.beta = 1.0          # advantage temperature (0 => plain BC)
        self.vf_coeff = 1.0
        self.gamma = 0.99
        self.algo_class = MARWIL


class MARWIL(BC):
    """Monotonic advantage re-weighted imitation learning.

    Role parity: rllib/algorithms/marwil — BC where each transition's
    log-prob is weighted by exp(beta * A_norm); a value tower learns
    one-step TD targets from the offline transitions (the dataset is
    shuffled transitions, so the advantage is the one-step
    r + gamma*V(s') - V(s) rather than the trajectory Monte-Carlo form).
    beta=0 reduces exactly to BC. One update per batch.
    """

    COLUMNS = (sb.OBS, sb.ACTIONS, sb.REWARDS, sb.NEXT_OBS, sb.DONES)

    def loss(self, batch):
        cfg = self.config
        logp, entropy, value = self.module.logp_entropy(
            self.params, batch[sb.OBS], batch[sb.ACTIONS])
        with torch.no_grad():
            v_next = self.module.apply(self.params, batch[sb.NEXT_OBS])[1]
            td_target = batch[sb.REWARDS] + cfg.gamma * (
                1.0 - batch[sb.DONES]) * v_next
            adv = td_target - value
            # jnp's std is the population std (ddof 0)
            adv_norm = adv / (adv.std(correction=0) + 1e-8)
            weights = torch.exp(torch.clamp(cfg.beta * adv_norm, -10.0,
                                            10.0))
        pi_loss = -(weights * logp).mean()
        vf_loss = ((value - td_target) ** 2).mean()
        total = pi_loss + cfg.vf_coeff * vf_loss
        return total, {"policy_loss": pi_loss, "vf_loss": vf_loss,
                       "mean_weight": weights.mean(),
                       "entropy": entropy.mean()}
