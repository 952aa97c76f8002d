"""Dataset: lazy, distributed, block-based data processing. Ported from
``ray_tpu/data/dataset.py``.

Role parity: python/ray/data/dataset.py:168 (Dataset over distributed
Blocks), _internal/plan.py (lazy logical plan), streaming_executor.py:45
(pipelined execution with bounded in-flight), push_based_shuffle.py
(map/reduce shuffle; here a hash/round-robin two-stage shuffle over tasks).

Blocks are dicts of numpy columns (``data/block.py``) living in the object
store as ObjectRefs; transforms are tasks (one per block) submitted through
the normal lease path, so data processing shares the scheduler with
everything else. It runs on either port runtime: the in-process one
(``init(local_mode=True)``) and the cluster one (``init(address=...)``).

``iter_batches`` is the per-host input pipeline: it streams block refs with
a bounded prefetch window and yields contiguous numpy batches;
``iter_torch_batches`` wraps them as host tensors, which the training loop
moves to its card. ``data/`` computes on the host and has no ``device=``.

Where the port differs from the JAX module (ROADMAP.md C): the JAX package
cloudpickles a user function (``map_batches``, ``map``, ``flat_map``,
``filter``) and its tasks load it. Here the task takes the function itself
as an argument. On the cluster runtime it goes to the workers by import
path, so it is pickled when ``map_batches()`` (or ``map``, ``flat_map``,
``filter``) is called: a lambda or a closure raises ``TypeError`` at the
user's line, not later when a lazy plan runs. On the in-process runtime
every callable works. The all-to-all stages are ``functools.partial``s of
module-level functions, so a plan pickles whole.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Dict, Iterator, List, Optional

import numpy as np

from ray_tpu_torch.data.block import (Block, BlockAccessor, block_from_rows,
                                      format_batch, normalize_batch_to_block)

_remote_cache: Dict[Any, Any] = {}
_cache_runtime: List[Any] = [None]   # the runtime the cached ones serve


def _remote_for(task_fn, **opts):
    """One RemoteFunction per transform fn and runtime, so the function is
    registered once per driver (hot path for per-block tasks). A runtime
    started after ``shutdown()`` gets fresh ones."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.core.api import _global_runtime
    runtime = _global_runtime()
    if _cache_runtime[0] is not runtime:
        _remote_cache.clear()
        _cache_runtime[0] = runtime
    key = (task_fn, tuple(sorted(opts.items())))
    rf = _remote_cache.get(key)
    if rf is None:
        rf = rt.remote(task_fn).options(num_cpus=1, **opts)
        _remote_cache[key] = rf
    return rf


def _checked(fn: Callable) -> Callable:
    """On the cluster runtime, pickle a user function now, so that one
    that cannot go to a worker by import path raises at the call."""
    from ray_tpu_torch.core import api
    from ray_tpu_torch.core.runtime_local import LocalRuntime
    runtime = api._runtime
    if runtime is not None and not isinstance(runtime, LocalRuntime):
        from ray_tpu_torch.core import serialization
        serialization.dumps(fn)
    return fn


# ---------------------------------------------------------------------------
# transform tasks (module-level: workers import them by name)
# ---------------------------------------------------------------------------

def _map_batches_task(block: Block, fn: Callable, batch_size: Optional[int],
                      batch_format: str) -> Block:
    acc = BlockAccessor(block)
    n = acc.num_rows()
    outs: List[Block] = []
    step = batch_size or max(1, n)
    for start in range(0, max(n, 1), step):
        sub = acc.slice(start, min(start + step, n)) if n else block
        out = fn(format_batch(sub, batch_format))
        outs.append(normalize_batch_to_block(out))
        if n == 0:
            break
    return BlockAccessor.concat(outs) if outs else block


def _map_rows_task(block: Block, fn: Callable, flat: bool) -> Block:
    rows_out: List[Any] = []
    for row in BlockAccessor(block).to_rows():
        r = fn(row)
        if flat:
            rows_out.extend(r)
        else:
            rows_out.append(r)
    return block_from_rows(rows_out)


def _filter_task(block: Block, fn: Callable) -> Block:
    acc = BlockAccessor(block)
    keep = np.array([bool(fn(r)) for r in acc.to_rows()], dtype=bool)
    return acc.take_indices(np.nonzero(keep)[0])


def _split_task(block: Block, n_out: int, seed: Optional[int],
                index: int) -> List[Block]:
    """Shuffle map stage: partition one block into n_out shards."""
    acc = BlockAccessor(block)
    n = acc.num_rows()
    if seed is None:
        idx = np.arange(n)
    else:
        rng = np.random.default_rng((seed, index))
        idx = rng.permutation(n)
    shards = np.array_split(idx, n_out)
    return [acc.take_indices(s) for s in shards]


def _slice_block_task(block: Block, start: int, stop: int) -> Block:
    return BlockAccessor(block).slice(start, stop)


def _merge_task(*blocks: Block) -> Block:
    return BlockAccessor.concat(list(blocks))


def _merge_shuffle_task(seed, index, *blocks: Block) -> Block:
    merged = BlockAccessor.concat(list(blocks))
    if seed is None:
        return merged
    acc = BlockAccessor(merged)
    rng = np.random.default_rng((seed, index, 1))
    return acc.take_indices(rng.permutation(acc.num_rows()))


def _sort_indices(keys: np.ndarray, descending: bool) -> np.ndarray:
    """A stable sort's order, as ``pyarrow.compute.sort_indices``: equal
    keys keep their order in either direction."""
    if not descending:
        return np.argsort(keys, kind="stable")
    n = len(keys)
    return (n - 1 - np.argsort(keys[::-1], kind="stable"))[::-1]


def _sort_block_task(block: Block, key: str, descending: bool) -> Block:
    acc = BlockAccessor(block)
    return acc.take_indices(_sort_indices(block[key], descending))


def _stable_hash(k: Any) -> int:
    """Process-stable partition hash: builtin hash() of str/bytes is
    randomized per interpreter (PYTHONHASHSEED), and blocks of one groupby
    are partitioned in different worker processes — an unstable hash would
    scatter equal keys across partitions and return duplicate groups."""
    import zlib
    if isinstance(k, bytes):
        return zlib.crc32(k)
    if isinstance(k, (int, np.integer)):
        return int(k) & 0xFFFFFFFF
    return zlib.crc32(str(k).encode("utf-8", "surrogatepass"))


def _groupby_partition_task(block: Block, key: str, n_out: int) -> List[Block]:
    acc = BlockAccessor(block)
    keys = acc.to_numpy([key])[key]
    hashes = np.array([_stable_hash(k) % n_out for k in keys])
    return [acc.take_indices(np.nonzero(hashes == i)[0])
            for i in range(n_out)]


def _aggregate(values: np.ndarray, starts: np.ndarray, how: str):
    """One aggregation over the runs of a key-sorted column that begin at
    ``starts``: pyarrow's ``hash_<how>`` output dtypes (sum keeps the
    integer or float kind at 64 bits, mean is float64, count int64)."""
    if how == "count":
        return np.diff(np.append(starts, len(values))).astype(np.int64)
    if how == "sum":
        kind = np.int64 if values.dtype.kind in "iub" else np.float64
        return np.add.reduceat(values.astype(kind), starts)
    if how == "mean":
        counts = np.diff(np.append(starts, len(values)))
        return np.add.reduceat(values.astype(np.float64), starts) / counts
    if how == "min":
        return np.minimum.reduceat(values, starts)
    if how == "max":
        return np.maximum.reduceat(values, starts)
    raise ValueError(f"unknown aggregation {how!r}")


def _groupby_agg_task(key: str, aggs: List[tuple], *blocks: Block) -> Block:
    """``Table.group_by(key).aggregate(aggs)``: the key column, then one
    ``<column>_<how>`` column per aggregation, groups in the order of
    their first row."""
    merged = BlockAccessor.concat(list(blocks))
    if BlockAccessor(merged).num_rows() == 0:
        return merged
    keys = merged[key]
    _, first, inverse = np.unique(keys, return_index=True,
                                  return_inverse=True)
    group = np.argsort(np.argsort(first))[inverse.reshape(-1)]
    rows = np.argsort(group, kind="stable")     # groups by first row
    starts = np.flatnonzero(np.r_[True, np.diff(group[rows]) != 0])
    out = {key: keys[rows][starts]}
    for col, how in aggs:
        out[f"{col}_{how}"] = _aggregate(merged[col][rows], starts, how)
    return out


# ---------------------------------------------------------------------------
# all-to-all stages (run in the driver; module-level so a plan pickles)
# ---------------------------------------------------------------------------

def _repartition(num_blocks: int, refs, submit):
    from ray_tpu_torch.data.shuffle import push_based_shuffle
    return push_based_shuffle(refs, submit, num_blocks, None)


def _random_shuffle(seed: int, refs, submit):
    from ray_tpu_torch.data.shuffle import push_based_shuffle
    return push_based_shuffle(refs, submit, max(1, len(refs)), seed)


def _sort(key: str, descending: bool, refs, submit):
    # per-block sort then a single merge task (K-way merge would be
    # the scaled version; blocks are modest here)
    sorted_refs = [submit(_sort_block_task, r, key, descending)
                   for r in refs]
    merged = submit(_merge_task, *sorted_refs)
    return [submit(_sort_block_task, merged, key, descending)]


# ---------------------------------------------------------------------------
# logical plan
# ---------------------------------------------------------------------------

class _Op:
    """Logical plan stage; lowered to a physical streaming operator
    (data/streaming.py) at execution time."""


class _OneToOneOp(_Op):
    """Per-block task stage (lowered to streaming.MapOp)."""

    def __init__(self, task_fn, *args, name: str = "map"):
        self.task_fn = task_fn
        self.args = args
        self.name = name


class _AllToAllOp(_Op):
    """Barrier stage — shuffle/repartition/sort (streaming.AllToAllOp)."""

    def __init__(self, fn: Callable, name: str = "all-to-all"):
        self.fn = fn
        self.name = name


class _LimitOp(_Op):
    def __init__(self, n: int):
        self.n = n


# ---------------------------------------------------------------------------
# Dataset
# ---------------------------------------------------------------------------

class Dataset:
    def __init__(self, source_refs: List[Any], ops: Optional[List[_Op]] = None):
        self._source_refs = source_refs
        self._ops = ops or []
        self._materialized: Optional[List[Any]] = None
        self._last_exec_ops = None   # physical ops of the last execution

    def __getstate__(self):
        # The last execution's operators (Dataset.stats()'s live view, with
        # its in-flight refs and functions) stay in this process: a
        # materialized Dataset pickles as its block refs.
        state = dict(self.__dict__)
        state["_last_exec_ops"] = None
        return state

    # -- plan building ---------------------------------------------------
    def _with_op(self, op: _Op) -> "Dataset":
        return Dataset(self._source_refs, self._ops + [op])

    def map_batches(self, fn: Callable, *, batch_size: Optional[int] = None,
                    batch_format: str = "numpy") -> "Dataset":
        return self._with_op(_OneToOneOp(
            _map_batches_task, _checked(fn), batch_size, batch_format,
            name="map_batches"))

    def map(self, fn: Callable) -> "Dataset":
        return self._with_op(_OneToOneOp(_map_rows_task, _checked(fn), False,
                                         name="map"))

    def flat_map(self, fn: Callable) -> "Dataset":
        return self._with_op(_OneToOneOp(_map_rows_task, _checked(fn), True,
                                         name="flat_map"))

    def filter(self, fn: Callable) -> "Dataset":
        return self._with_op(_OneToOneOp(_filter_task, _checked(fn),
                                         name="filter"))

    def limit(self, n: int) -> "Dataset":
        return self._with_op(_LimitOp(n))

    def repartition(self, num_blocks: int) -> "Dataset":
        return self._with_op(_AllToAllOp(
            functools.partial(_repartition, num_blocks),
            name=f"repartition[{num_blocks}]"))

    def random_shuffle(self, *, seed: Optional[int] = None) -> "Dataset":
        seed = seed if seed is not None else np.random.randint(1 << 31)
        return self._with_op(_AllToAllOp(
            functools.partial(_random_shuffle, seed), name="random_shuffle"))

    def sort(self, key: str, descending: bool = False) -> "Dataset":
        return self._with_op(_AllToAllOp(
            functools.partial(_sort, key, descending), name=f"sort[{key}]"))

    def union(self, other: "Dataset") -> "Dataset":
        return Dataset(self.materialize_refs() + other.materialize_refs())

    def groupby(self, key: str) -> "GroupedData":
        return GroupedData(self, key)

    # -- execution -------------------------------------------------------
    def _submit(self, task_fn, *args):
        return _remote_for(task_fn).remote(*args)

    def _physical_ops(self):
        from ray_tpu_torch.data import streaming
        phys = []
        for op in self._ops:
            if isinstance(op, _OneToOneOp):
                phys.append(streaming.MapOp(op.task_fn, *op.args,
                                            name=op.name))
            elif isinstance(op, _LimitOp):
                phys.append(streaming.LimitOp(op.n))
            elif isinstance(op, _AllToAllOp):
                phys.append(streaming.AllToAllOp(op.fn, name=op.name))
            else:
                raise TypeError(f"unknown logical op {op!r}")
        return phys

    def iter_block_refs(self) -> Iterator:
        """Streaming execution: every operator runs concurrently with
        bounded in-flight tasks and per-operator backpressure
        (data/streaming.py; parity: streaming_executor.py:45)."""
        if self._materialized is not None:
            return iter(self._materialized)
        from ray_tpu_torch.data.streaming import StreamingExecutor
        phys = self._physical_ops()
        self._last_exec_ops = phys   # live stats view (Dataset.stats())
        return StreamingExecutor(phys, list(self._source_refs),
                                 self._submit).run()

    def stats(self) -> str:
        """Per-operator execution summary for the most recent execution
        (parity: Dataset.stats(), reference _internal/stats.py). Executes
        the plan if it never ran."""
        from ray_tpu_torch.data.stats import DatasetStats
        if getattr(self, "_last_exec_ops", None) is None:
            self.materialize_refs()
        ops = getattr(self, "_last_exec_ops", None) or []
        return DatasetStats([op.stats for op in ops]).summary()

    def materialize_refs(self) -> List[Any]:
        if self._materialized is None:
            self._materialized = list(self.iter_block_refs())
            self._source_refs = self._materialized
            self._ops = []
        return self._materialized

    def materialize(self) -> "Dataset":
        self.materialize_refs()
        return self

    # -- consumption -----------------------------------------------------
    def iter_batches(self, *, batch_size: int = 256,
                     batch_format: str = "numpy",
                     prefetch_blocks: int = 2,
                     drop_last: bool = False) -> Iterator[Any]:
        import ray_tpu_torch as rt
        from collections import deque
        refs = self.iter_block_refs()
        window: deque = deque()
        carry: Optional[Block] = None

        def fill():
            while len(window) < prefetch_blocks + 1:
                try:
                    window.append(next(refs))
                except StopIteration:
                    return False
            return True

        exhausted = False
        while True:
            if not exhausted:
                exhausted = not fill()
            have = (BlockAccessor(carry).num_rows() if carry is not None
                    else 0)
            while window and have < batch_size:
                block = rt.get(window.popleft())
                carry = block if carry is None else \
                    BlockAccessor.concat([carry, block])
                have = BlockAccessor(carry).num_rows()
                if not exhausted:
                    exhausted = not fill()
            if carry is None or have == 0:
                return
            acc = BlockAccessor(carry)
            if have >= batch_size:
                yield format_batch(acc.slice(0, batch_size), batch_format)
                carry = acc.slice(batch_size, have) if have > batch_size \
                    else None
            elif not window:
                if not drop_last:
                    yield format_batch(carry, batch_format)
                return

    def iter_torch_batches(self, *, batch_size: int = 256,
                           prefetch_blocks: int = 2,
                           drop_last: bool = False,
                           dtypes=None) -> Iterator[Any]:
        """Batches as dicts of host torch tensors (parity:
        python/ray/data/iterator.py iter_torch_batches). Tensors are
        zero-copy views of the numpy batch where dtypes allow; a block read
        from the object store is read-only, and the tensor over it must not
        be written. The training loop moves each batch to its card."""
        import torch
        for batch in self.iter_batches(batch_size=batch_size,
                                       batch_format="numpy",
                                       prefetch_blocks=prefetch_blocks,
                                       drop_last=drop_last):
            out = {}
            for k, v in batch.items():
                t = torch.as_tensor(v)
                if dtypes is not None:
                    want = dtypes.get(k) if isinstance(dtypes, dict) \
                        else dtypes
                    if want is not None:
                        t = t.to(want)
                out[k] = t
            yield out

    def iter_rows(self) -> Iterator[dict]:
        import ray_tpu_torch as rt
        for ref in self.iter_block_refs():
            yield from BlockAccessor(rt.get(ref)).to_rows()

    def take(self, n: int = 20) -> List[dict]:
        out = []
        for row in self.iter_rows():
            out.append(row)
            if len(out) >= n:
                break
        return out

    def take_all(self) -> List[dict]:
        return list(self.iter_rows())

    def count(self) -> int:
        import ray_tpu_torch as rt
        return sum(BlockAccessor(rt.get(r)).num_rows()
                   for r in self.materialize_refs())

    def schema(self):
        import ray_tpu_torch as rt
        refs = self.materialize_refs()
        if not refs:
            return None
        return BlockAccessor(rt.get(refs[0])).schema()

    def num_blocks(self) -> int:
        return len(self.materialize_refs())

    def size_bytes(self) -> int:
        import ray_tpu_torch as rt
        return sum(BlockAccessor(rt.get(r)).size_bytes()
                   for r in self.materialize_refs())

    def to_pandas(self):
        import ray_tpu_torch as rt
        return BlockAccessor(BlockAccessor.concat(
            [rt.get(r) for r in self.materialize_refs()])).to_pandas()

    def split(self, n: int, *, equal: bool = False) -> List["Dataset"]:
        """Split into n datasets. ``equal=True`` gives every split EXACTLY
        ``total_rows // n`` rows (remainder dropped) — required when the
        splits feed a collective-per-step training gang, where uneven step
        counts deadlock the tail (parity: Dataset.split(equal=True), the
        mode get_dataset_shard relies on)."""
        refs = self.materialize_refs()
        if not equal:
            parts = np.array_split(np.arange(len(refs)), n)
            return [Dataset([refs[i] for i in idx]) for idx in parts]
        import ray_tpu_torch as rt
        counts = [BlockAccessor(rt.get(r)).num_rows() for r in refs]
        per = sum(counts) // n
        out: List[Dataset] = []
        block_i, offset = 0, 0   # cursor into (refs, row-within-block)
        for _ in range(n):
            need = per
            pieces: List[Any] = []
            while need > 0 and block_i < len(refs):
                avail = counts[block_i] - offset
                take = min(avail, need)
                if offset == 0 and take == counts[block_i]:
                    pieces.append(refs[block_i])       # whole block as-is
                else:
                    pieces.append(self._submit(
                        _slice_block_task, refs[block_i], offset,
                        offset + take))
                need -= take
                offset += take
                if offset >= counts[block_i]:
                    block_i += 1
                    offset = 0
            out.append(Dataset(pieces))
        return out

    def repeat(self, times: Optional[int] = None) -> "DatasetPipeline":
        return DatasetPipeline(self, times)

    def window(self, *, blocks_per_window: int = 2) -> "DatasetPipeline":
        return DatasetPipeline(self, 1, blocks_per_window)

    # -- writes ----------------------------------------------------------
    def write_parquet(self, path: str) -> None:
        from ray_tpu_torch.data.datasource import write_blocks
        write_blocks(self, path, "parquet")

    def write_csv(self, path: str) -> None:
        from ray_tpu_torch.data.datasource import write_blocks
        write_blocks(self, path, "csv")

    def write_json(self, path: str) -> None:
        from ray_tpu_torch.data.datasource import write_blocks
        write_blocks(self, path, "json")

    def __repr__(self):
        return (f"Dataset(num_source_blocks={len(self._source_refs)}, "
                f"pending_ops={len(self._ops)})")


def _simple_shuffle(refs: List[Any], submit, num_out: int,
                    seed: Optional[int]) -> List[Any]:
    """Naive two-stage shuffle: every reduce waits for every map and takes
    all M shards as one task's args. The baseline the push-based shuffle
    (data/shuffle.py) is compared with."""
    if not refs:
        return refs
    shard_refs = []
    for i, r in enumerate(refs):
        out = _remote_for(_split_task, num_returns=num_out).remote(
            r, num_out, seed, i)
        shard_refs.append(out if isinstance(out, list) else [out])
    merged = []
    for j in range(num_out):
        cols = [shard_refs[i][j] for i in range(len(refs))]
        merged.append(submit(_merge_shuffle_task, seed, j, *cols))
    return merged


class GroupedData:
    """Hash-partitioned groupby aggregations (parity:
    grouped_data.py over arrow group_by)."""

    def __init__(self, ds: Dataset, key: str):
        self.ds = ds
        self.key = key

    def _aggregate(self, aggs: List[tuple]) -> Dataset:
        refs = self.ds.materialize_refs()
        n_parts = max(1, min(len(refs), 8))
        part_refs = []
        for r in refs:
            out = _remote_for(_groupby_partition_task,
                              num_returns=n_parts).remote(r, self.key, n_parts)
            part_refs.append(out if isinstance(out, list) else [out])
        agg_refs = []
        for j in range(n_parts):
            cols = [part_refs[i][j] for i in range(len(refs))]
            agg_refs.append(_remote_for(_groupby_agg_task).remote(
                self.key, aggs, *cols))
        return Dataset(agg_refs)

    def count(self) -> Dataset:
        return self._aggregate([(self.key, "count")])

    def sum(self, col: str) -> Dataset:
        return self._aggregate([(col, "sum")])

    def mean(self, col: str) -> Dataset:
        return self._aggregate([(col, "mean")])

    def min(self, col: str) -> Dataset:
        return self._aggregate([(col, "min")])

    def max(self, col: str) -> Dataset:
        return self._aggregate([(col, "max")])


class DatasetPipeline:
    """Windowed/repeated pipelining (parity: dataset_pipeline.py)."""

    def __init__(self, ds: Dataset, times: Optional[int] = None,
                 blocks_per_window: Optional[int] = None):
        self.ds = ds
        self.times = times
        self.blocks_per_window = blocks_per_window

    def iter_batches(self, **kwargs) -> Iterator[Any]:
        epoch = 0
        while self.times is None or epoch < self.times:
            yield from self.ds.iter_batches(**kwargs)
            epoch += 1

    def iter_epochs(self) -> Iterator[Dataset]:
        epoch = 0
        while self.times is None or epoch < self.times:
            yield self.ds
            epoch += 1
