"""Ulysses (all-to-all) sequence parallelism, ported from
``ray_tpu/ops/ulysses.py``.

Instead of rotating kv around the ring, two all-to-alls re-shard the arrays
from sequence-sharded to head-sharded, ordinary full-sequence attention runs
locally on each rank's subset of heads, and a third shards back
(``collectives.alltoall``: ``all_to_all_single``, its gradient the
all-to-all back). Best when num_heads >= axis size. No kernel runs here:
``blockwise_attention`` and ``attention_reference``, as in the JAX body.
"""

from __future__ import annotations

from typing import Optional

from ray_tpu_torch.ops.attention import (_repeat_kv, attention_reference,
                                         blockwise_attention)
from ray_tpu_torch.parallel.collectives import alltoall, axis_size
from ray_tpu_torch.parallel.mesh import data_axes
from ray_tpu_torch.parallel.sharding import shard_map


def ulysses_attention_local(q, k, v, *, axis: str = "sp",
                            causal: bool = True,
                            scale: Optional[float] = None,
                            block_size: int = 1024):
    """q,k,v local chunks [B, S_local, H, D] with the sequence dim sharded
    over `axis` (inside ``axis_env``). H must be divisible by axis size."""
    n = axis_size(axis)
    h = q.shape[2]
    if h % n:
        raise ValueError(f"heads={h} not divisible by sp axis size {n}")
    k, v = _repeat_kv(k, v, h)   # GQA: replicate kv heads before the split

    def to_heads(x):   # [B, S/n, H, D] -> [B, S, H/n, D]
        return alltoall(x, axis, split_dim=2, concat_dim=1)

    qh, kh, vh = to_heads(q), to_heads(k), to_heads(v)
    if qh.shape[1] >= 4096:
        out = blockwise_attention(qh, kh, vh, causal=causal, scale=scale,
                                  block_size=block_size)
    else:
        out = attention_reference(qh, kh, vh, causal=causal, scale=scale)
    return alltoall(out, axis, split_dim=1, concat_dim=2)


def ulysses_attention(q, k, v, mesh, *, axis: str = "sp",
                      causal: bool = True, scale: Optional[float] = None,
                      batch_axes=data_axes()):
    """Ulysses attention over `mesh`; q,k,v global [B, S, H, D] (DTensors,
    or the same plain tensor on every rank). Returns a DTensor."""
    spec = (tuple(batch_axes), axis, None, None)

    def body(q, k, v):
        return ulysses_attention_local(q, k, v, axis=axis, causal=causal,
                                       scale=scale)
    return shard_map(body, mesh, (spec, spec, spec), spec)(q, k, v)
