"""Push-based shuffle: pipelined map/merge with bounded fan-in. Ported from
``ray_tpu/data/shuffle.py``, with the same seeded draws.

Role parity: python/ray/data/_internal/push_based_shuffle.py — the naive
two-stage shuffle materializes M x R shard objects and runs R reduce tasks
with fan-in M (every map output alive at once; reduce can't start until
every map finished). Here map outputs are PUSHED into per-partition merge
rounds as soon as they complete: each merger folds at most ``merge_factor``
new shards into its running partial result, so

- merge work overlaps the map stage (pipelining),
- per-merge fan-in is bounded (no 1000-arg reduce task),
- intermediate shards become garbage as soon as their round merges
  (the refcounting GC frees them while the shuffle is still running).
"""

from __future__ import annotations

from collections import deque
from typing import Any, List, Optional

MERGE_FACTOR = 8   # shards folded per merge round


def _fold_task(prev, *blocks):
    """Fold new shards into the running partial result for one partition."""
    from ray_tpu_torch.data.block import BlockAccessor
    parts = ([prev] if prev is not None else []) + list(blocks)
    return BlockAccessor.concat([b for b in parts if b is not None])


def _finalize_task(seed, index, merged):
    from ray_tpu_torch.data.block import BlockAccessor
    if seed is None or merged is None:
        return merged
    import numpy as np
    acc = BlockAccessor(merged)
    rng = np.random.default_rng((seed, index, 1))
    return acc.take_indices(rng.permutation(acc.num_rows()))


def push_based_shuffle(refs: List[Any], submit, num_out: int,
                       seed: Optional[int],
                       merge_factor: int = MERGE_FACTOR) -> List[Any]:
    """Shuffle ``refs`` into ``num_out`` partitions (seeded = random
    shuffle, unseeded = repartition). Returns the final partition refs."""
    import ray_tpu_torch as rt

    from ray_tpu_torch.data.dataset import _remote_for, _split_task

    if not refs:
        return refs

    # -- map stage: split every block into num_out shards (goes through
    # _remote_for directly because `submit` has no num_returns channel;
    # fold/finalize tasks use `submit` so Dataset._submit customizations
    # apply to the bulk of the shuffle work)
    map_out = {}   # first-return ref (signal) -> (map index, shard refs)
    for i, r in enumerate(refs):
        out = _remote_for(_split_task, num_returns=num_out).remote(
            r, num_out, seed, i)
        shards = out if isinstance(out, list) else [out]
        map_out[shards[0]] = (i, shards)

    # -- push phase: fold completed maps' shards into per-partition
    # rounds. Folding follows MAP INDEX order (out-of-order completions
    # buffer until their prefix is ready), so a seeded shuffle stays
    # byte-deterministic while merge work still overlaps the map stage.
    partial: List[Optional[Any]] = [None] * num_out   # running merge result
    buffered: List[dict] = [dict() for _ in range(num_out)]  # idx -> shard
    next_idx = [0] * num_out
    unfinished = dict(map_out)  # signal ref -> (map index, shards)

    def fold_ready(force: bool = False) -> None:
        for j in range(num_out):
            while True:
                run: List[Any] = []
                while len(run) < merge_factor and \
                        (next_idx[j] + len(run)) in buffered[j]:
                    run.append(buffered[j][next_idx[j] + len(run)])
                if len(run) < merge_factor and not (force and run):
                    break
                for k in range(len(run)):
                    del buffered[j][next_idx[j] + k]
                next_idx[j] += len(run)
                partial[j] = submit(_fold_task, partial[j], *run)

    while unfinished:
        ready, _ = rt.wait(list(unfinished),
                           num_returns=min(4, len(unfinished)), timeout=10)
        for sig in ready:
            idx, shards = unfinished.pop(sig)
            for j, shard in enumerate(shards):
                buffered[j][idx] = shard
        fold_ready()
    fold_ready(force=True)

    # -- finalize: per-partition permutation (seeded shuffles only; an
    # unseeded repartition returns the folded partitions as-is)
    if seed is None:
        return list(partial)
    return [submit(_finalize_task, seed, j, partial[j])
            for j in range(num_out)]
