"""Ring attention: sequence parallelism over a ring of ranks, ported from
``ray_tpu/ops/ring_attention.py``.

Each rank of the "sp" mesh axis holds a contiguous sequence chunk of q/k/v.
kv chunks rotate around the ring (``collectives.ring_permute``: one
``batch_isend_irecv`` a step, whose gradient goes back along the inverse
permutation) while each rank accumulates online-softmax partial results for
its local q chunk (``ops/attention.py:_block_step``). After axis_size steps
every q position has attended to the full sequence without any rank ever
holding the full kv. Causality uses global-position masks, so the same code
serves pure ring (causal=False) and blockwise-causal LM training. The
backward is autograd through the steps and the permutes.

``ring_attention_local`` is the body (inside ``axis_env``/``shard_map``);
``ring_attention`` wraps it for a mesh. No kernel runs here: the JAX body
reaches no Pallas kernel either.
"""

from __future__ import annotations

from typing import Optional

import torch

from ray_tpu_torch.ops.attention import NEG_INF, _block_step, _repeat_kv
from ray_tpu_torch.parallel.collectives import (axis_index, axis_size,
                                                ring_permute)
from ray_tpu_torch.parallel.mesh import data_axes
from ray_tpu_torch.parallel.sharding import shard_map


def ring_attention_local(q, k, v, *, axis: str = "sp", causal: bool = True,
                         scale: Optional[float] = None):
    """q,k,v: local chunks [B, S_local, H, D]; sequence dim sharded over
    `axis`. Returns the local output chunk [B, S_local, H, D]."""
    n = axis_size(axis)
    me = axis_index(axis)
    b, s, h, d = q.shape
    sk = k.shape[1]
    k, v = _repeat_kv(k, v, h)
    scale_ = scale if scale is not None else d ** -0.5
    dev = q.device
    q_pos = me * s + torch.arange(s, device=dev)
    acc = torch.zeros(b, s, h, d, dtype=torch.float32, device=dev)
    m = torch.full((b, h, s), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros(b, h, s, dtype=torch.float32, device=dev)
    for t in range(n):
        src = (me + t) % n      # global chunk index currently held
        bias = None
        if causal:
            k_pos = src * sk + torch.arange(sk, device=dev)
            bias = torch.where(q_pos[:, None] >= k_pos[None, :], 0.0,
                               NEG_INF)
        acc, m, l = _block_step(q, k, v, acc, m, l, bias, scale_)
        if t < n - 1:
            # chunk j -> rank j-1 (the JAX body's last, redundant rotation
            # is left out)
            k = ring_permute(k, axis, shift=-1)
            v = ring_permute(v, axis, shift=-1)
    l = torch.clamp(l, min=1e-30)
    out = acc / l.transpose(1, 2)[..., None]
    return out.to(q.dtype)


def ring_attention(q, k, v, mesh, *, axis: str = "sp", causal: bool = True,
                   scale: Optional[float] = None, batch_axes=data_axes()):
    """Ring attention over `mesh`. q,k,v: global [B, S, H, D] (DTensors, or
    the same plain tensor on every rank); batch sharded over `batch_axes`,
    seq over `axis`. Returns the global output as a DTensor."""
    spec = (tuple(batch_axes), axis, None, None)

    def body(q, k, v):
        return ring_attention_local(q, k, v, axis=axis, causal=causal,
                                    scale=scale)
    return shard_map(body, mesh, (spec, spec, spec), spec)(q, k, v)
