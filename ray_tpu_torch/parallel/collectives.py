"""In-program collectives on named mesh axes, ported from
``ray_tpu/parallel/collectives.py``.

The JAX functions run inside ``shard_map``, where mesh axes are visible by
name. Here the names resolve against the whole mesh of the enclosing
``axis_env(mesh)`` block (the wrappers in ``ops/`` enter one around their
local bodies) to that axis' group, size-1 axes included: the collective
then runs on a group of one rank. A tuple of axes is one axis over
their flattened group, ranks in row-major order of the tuple, as JAX
flattens it (``DeviceMesh._flatten``). Each function takes and returns the
rank's local tensor.

Gradients follow JAX's transposes under ``shard_map(check_vma=False)``:
``allreduce_sum`` passes the cotangent through unchanged (the reduced value
is the same on every rank and its loss is taken once), ``allgather`` and
``reducescatter`` are each other's transposes, ``alltoall`` transposes to
the all-to-all back, and ``ring_permute`` to the inverse permutation.
``allreduce_max``/``min`` are not differentiated.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Sequence, Union

import torch
import torch.distributed as dist

from ray_tpu_torch.util.broadcast_schedule import (  # noqa: F401 - re-export
    broadcast_rounds)

AxisName = Union[str, Sequence[str]]

_ENV: contextvars.ContextVar = contextvars.ContextVar("axis_env",
                                                      default=None)


@contextlib.contextmanager
def axis_env(mesh):
    """Within the block, axis names resolve against ``mesh``."""
    token = _ENV.set(mesh)
    try:
        yield mesh
    finally:
        _ENV.reset(token)


def _names(axis: AxisName):
    return (axis,) if isinstance(axis, str) else tuple(axis)


def _axis_mesh(axis: AxisName):
    """The 1-D mesh of ``axis`` (its flattened group for a tuple)."""
    mesh = _ENV.get()
    if mesh is None:
        raise RuntimeError("mesh-axis collectives run inside axis_env(mesh), "
                           "the port's shard_map body")
    root = mesh._get_root_mesh()     # names resolve on the whole mesh
    names = _names(axis)
    if len(names) == 1:
        return root[names[0]]
    return root[names]._flatten("_".join(names))


def axis_index(axis: AxisName) -> int:
    """This rank's index along ``axis`` (row-major over a tuple)."""
    return _axis_mesh(axis).get_local_rank()


def axis_size(axis: AxisName) -> int:
    return _axis_mesh(axis).size()


def axis_group(axis: AxisName):
    """The process group of ``axis`` (of the flattened tuple), for a
    collective of the caller's own."""
    return _axis_mesh(axis).get_group()


def _all_reduce(x, am, op):
    out = x.detach().clone().contiguous()
    dist.all_reduce(out, op=op, group=am.get_group())
    return out


# The autograd Functions take the axis' 1-D mesh (``am``), resolved when
# they are applied: their backward runs outside the axis_env block.

class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, am):
        return _all_reduce(x, am, dist.ReduceOp.SUM)

    @staticmethod
    def backward(ctx, g):
        return g, None


def allreduce_sum(x, axis: AxisName):
    return _AllReduceSum.apply(x, _axis_mesh(axis))


def allreduce_mean(x, axis: AxisName):
    return allreduce_sum(x, axis) / axis_size(axis)


def allreduce_max(x, axis: AxisName):
    return _all_reduce(x, _axis_mesh(axis), dist.ReduceOp.MAX)


def allreduce_min(x, axis: AxisName):
    return _all_reduce(x, _axis_mesh(axis), dist.ReduceOp.MIN)


def _gather(x, am, dim):
    src = x.movedim(dim, 0).contiguous()
    out = src.new_empty((am.size() * src.shape[0],) + src.shape[1:])
    dist.all_gather_into_tensor(out, src, group=am.get_group())
    return out.movedim(0, dim)


def _scatter(x, am, dim):
    n = am.size()
    src = x.movedim(dim, 0).contiguous()
    if src.shape[0] % n:
        raise ValueError(f"dim {dim} of size {src.shape[0]} does not split "
                         f"over {n} ranks")
    out = src.new_empty((src.shape[0] // n,) + src.shape[1:])
    dist.reduce_scatter_tensor(out, src, group=am.get_group())
    return out.movedim(0, dim)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, am, dim):
        ctx.am, ctx.dim = am, dim
        return _gather(x, am, dim)

    @staticmethod
    def backward(ctx, g):
        return _scatter(g, ctx.am, ctx.dim), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, am, dim):
        ctx.am, ctx.dim = am, dim
        return _scatter(x, am, dim)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.am, ctx.dim), None, None


def allgather(x, axis: AxisName, *, concat_dim: int = 0, tiled: bool = True):
    """Every rank's ``x`` joined along ``concat_dim`` in axis order
    (``tiled``), or stacked on a new dim there (``tiled=False``)."""
    if not tiled:
        x = x.unsqueeze(concat_dim)
    return _AllGather.apply(x, _axis_mesh(axis), concat_dim % x.dim())


def reducescatter(x, axis: AxisName, *, scatter_dim: int = 0):
    return _ReduceScatter.apply(x, _axis_mesh(axis), scatter_dim % x.dim())


def _all_to_all(x, am, split_dim, concat_dim):
    n = am.size()
    if x.shape[split_dim] % n:
        raise ValueError(f"dim {split_dim} of size {x.shape[split_dim]} does "
                         f"not split over {n} ranks")
    # [n, ...]: chunk j goes to rank j; received chunk j came from rank j
    src = x.unflatten(split_dim, (n, -1)).movedim(split_dim, 0).contiguous()
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=am.get_group())
    return out.movedim(0, concat_dim).flatten(concat_dim, concat_dim + 1)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, am, split_dim, concat_dim):
        ctx.args = (am, concat_dim, split_dim)
        return _all_to_all(x, am, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, *ctx.args), None, None, None


def alltoall(x, axis: AxisName, *, split_dim: int, concat_dim: int):
    """``lax.all_to_all(tiled=True)``: ``split_dim`` cut into one chunk a
    rank, chunk j sent to rank j, the received chunks joined along
    ``concat_dim`` in rank order."""
    return _AllToAll.apply(x, _axis_mesh(axis), split_dim % x.dim(),
                           concat_dim % x.dim())


def _permute(x, am, shift):
    """Send ``x`` to index (i + shift) mod n of the axis; receive from
    (i - shift) mod n. At n = 1 (or a shift of a whole turn) the identity,
    with nothing sent."""
    n, me = am.size(), am.get_local_rank()
    if shift % n == 0:
        return x.clone()
    ranks = am.mesh.flatten().tolist()
    src = x.contiguous()
    out = torch.empty_like(src)
    group = am.get_group()
    ops = [dist.P2POp(dist.isend, src, ranks[(me + shift) % n], group),
           dist.P2POp(dist.irecv, out, ranks[(me - shift) % n], group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class _Permute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, am, shift):
        ctx.am, ctx.shift = am, shift
        return _permute(x, am, shift)

    @staticmethod
    def backward(ctx, g):
        return _permute(g, ctx.am, -ctx.shift), None, None


def ring_permute(x, axis: str, *, shift: int = 1):
    """Send to (i+shift) mod n along `axis` — the neighbor hop used by ring
    attention and pipeline stages (``lax.ppermute`` with perm [(i, (i +
    shift) % n)]). Differentiable: the gradient goes back along the inverse
    permutation."""
    return _Permute.apply(x, _axis_mesh(axis), shift)


def broadcast_from(x, axis: str, *, root: int = 0):
    """Every member gets root's value (select-and-psum, as in JAX)."""
    masked = x if axis_index(axis) == root else torch.zeros_like(x)
    return allreduce_sum(masked, axis)
