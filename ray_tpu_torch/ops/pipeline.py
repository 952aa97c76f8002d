"""Pipeline parallelism: GPipe-schedule microbatching over a mesh axis,
ported from ``ray_tpu/ops/pipeline.py``.

Each rank of the "pp" mesh axis holds one *stage* (a contiguous chunk of
layers). Activations hop stage-to-stage (``collectives.ring_permute``, one
``batch_isend_irecv`` a tick) while microbatches stream through; after
num_microbatches + num_stages - 1 ticks every microbatch has traversed every
stage, and a masked all-reduce hands the last stage's outputs to every rank.
Differentiable end to end: the permute's gradient runs the schedule
backward, and the all-reduce passes its cotangent through (JAX's transpose
of ``psum`` under ``shard_map(check_vma=False)``), so the stages' gradients
are the dense model's.

A rank computes only its active ticks; the JAX body computes every tick and
masks the idle ones to zero, which sends the same values.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from ray_tpu_torch.parallel.collectives import (allreduce_sum, axis_index,
                                                axis_size, ring_permute)
from ray_tpu_torch.parallel.mesh import data_axes, mesh_sizes
from ray_tpu_torch.parallel.sharding import shard_map


def pipeline_apply_local(stage_fn: Callable, stage_params: Any, x,
                         *, axis: str = "pp", num_microbatches: int):
    """GPipe loop body (inside ``axis_env``/``shard_map``).

    stage_fn(stage_params, act) -> act applies this rank's stage.
    x: [num_microbatches, mb, ...] full input, the same on every rank of
       `axis` (only rank 0 reads it).
    Returns [num_microbatches, mb, ...] outputs, the same on every rank
    (made on the last rank, summed over the axis under a mask)."""
    n = axis_size(axis)
    rank = axis_index(axis)
    m = num_microbatches
    # Every rank's backward must run every hop's permute, in the same order
    # as the other ranks. So each tick's y depends on its inbox (at weight
    # 0 where unused: an exact 0, activations are finite), which makes one
    # chain of all the hops, and the chain starts from the input and every
    # stage weight (at weight 0 too), so that a gradient asked of any of
    # them runs the whole chain back on every rank.
    inbox = x[0] * 0.0
    for p in _leaves(stage_params):
        inbox = inbox + p.reshape(-1)[:1].sum() * 0.0
    outs = [torch.zeros_like(x[0]) for _ in range(m)]
    for t in range(m + n - 1):
        mb_idx = t - rank         # microbatch this rank works on at tick t
        if 0 <= mb_idx < m:
            # stage 0 pulls from the input stream; others use the inbox
            y = stage_fn(stage_params, inbox) if rank else \
                stage_fn(stage_params, x[mb_idx]) + inbox * 0.0
            if rank == n - 1:
                outs[mb_idx] = y
        else:
            y = inbox * 0.0
        if t < m + n - 2:         # the JAX loop's last hop is unused
            inbox = ring_permute(y, axis)
    mask = 1.0 if rank == n - 1 else 0.0
    return allreduce_sum(torch.stack(outs) * mask + y * 0.0, axis)


def _leaves(tree):
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in _leaves(v)]
    return [tree]


def _rebuild(tree, leaves):
    if isinstance(tree, dict):
        return {k: _rebuild(v, leaves) for k, v in tree.items()}
    return next(leaves)


def pipeline_apply(stage_fn: Callable, stage_params: Any, x, mesh, *,
                   axis: str = "pp", num_microbatches: int = None,
                   params_stage_dim: int = 0, batch_axes=data_axes()):
    """The pipeline over `mesh`.

    stage_params: dict tree whose leaves have a leading stage dim of size
    mesh.shape[axis] (each rank takes its stage's slice). The JAX function
    takes the first slice of a rank's block, so with fewer ranks than
    stages it applies only some stages; here that raises.
    x: [num_microbatches, mb, ...] with mb sharded over batch_axes.
    Returns the outputs as a DTensor, the same on every rank of `axis`."""
    n = mesh_sizes(mesh)[axis]
    if num_microbatches is None:
        num_microbatches = x.shape[0]
    leaves = _leaves(stage_params)
    stages = {leaf.shape[params_stage_dim] for leaf in leaves}
    if stages != {n}:
        raise ValueError(f"stage params have {sorted(stages)} stages, the "
                         f"mesh's {axis!r} axis has {n} ranks: they must "
                         f"match (one stage a rank)")
    p_spec = (None,) * params_stage_dim + (axis,)
    x_spec = (None, tuple(batch_axes))    # [microbatch, mb, ...]

    def body(xx, *local):
        # strip the per-rank stage dim of 1 that the split leaves behind
        sp = _rebuild(stage_params, iter(a.select(params_stage_dim, 0)
                                         for a in local))
        return pipeline_apply_local(stage_fn, sp, xx, axis=axis,
                                    num_microbatches=num_microbatches)

    return shard_map(body, mesh, (x_spec,) + (p_spec,) * len(leaves),
                     x_spec)(x, *leaves)
