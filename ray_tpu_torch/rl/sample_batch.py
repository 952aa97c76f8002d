"""SampleBatch: columnar trajectory container.

A copy of ``ray_tpu/rl/sample_batch.py`` (the port imports nothing of the
JAX package): a dict of parallel numpy arrays (obs, actions, rewards, dones,
logp, value targets, advantages) with concat/shuffle/minibatch helpers, kept
on the host. The port's learner moves a whole train batch to the device once
and indexes it there with the same permutation that ``shuffle`` draws.
"""

from __future__ import annotations

from typing import Dict, Iterator, List

import numpy as np

OBS = "obs"
ACTIONS = "actions"
REWARDS = "rewards"
DONES = "dones"
NEXT_OBS = "next_obs"
ACTION_LOGP = "action_logp"
VF_PREDS = "vf_preds"
ADVANTAGES = "advantages"
VALUE_TARGETS = "value_targets"


class SampleBatch(dict):
    @property
    def count(self) -> int:
        for v in self.values():
            return len(v)
        return 0

    @staticmethod
    def concat_samples(batches: List["SampleBatch"]) -> "SampleBatch":
        if not batches:
            return SampleBatch()
        keys = batches[0].keys()
        return SampleBatch({
            k: np.concatenate([np.asarray(b[k]) for b in batches])
            for k in keys})

    def shuffle(self, rng: np.random.Generator) -> "SampleBatch":
        idx = rng.permutation(self.count)
        return SampleBatch({k: np.asarray(v)[idx] for k, v in self.items()})

    def minibatches(self, size: int) -> Iterator["SampleBatch"]:
        n = self.count
        for start in range(0, n - size + 1, size):
            yield SampleBatch({k: np.asarray(v)[start:start + size]
                               for k, v in self.items()})

    def slice_rows(self, start: int, end: int) -> "SampleBatch":
        return SampleBatch({k: np.asarray(v)[start:end]
                            for k, v in self.items()})
