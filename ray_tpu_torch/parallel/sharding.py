"""Logical-axis sharding rules, ported from ``ray_tpu/parallel/sharding.py``.

Model code names its array dimensions with *logical* axes ("batch", "seq",
"embed", "mlp", "heads", "kv", "vocab", "layers", "expert", "stage"); a
``LogicalRules`` table maps each logical axis to zero or more mesh axes.
``LogicalRules.spec`` gives the JAX ``PartitionSpec`` as a tuple (a mesh-axis
name, a tuple of names, or None per dim, trailing Nones dropped), and
``placements`` the same spec as DTensor placements: one ``Shard(dim)`` or
``Replicate()`` per mesh dim. A tensor dim over several mesh axes is split
over them in mesh order, the first the major one, as ``P(("dp", "fsdp"))``
is in JAX.

``shard_pytree``, ``batch_sharding`` and ``replicated`` place tensors with
``distribute_tensor`` (``jax.device_put`` with a ``NamedSharding``), and
``with_sharding`` is ``DTensor.redistribute`` (``with_sharding_constraint``).
Tensors are placed on ``active_mesh(mesh)`` (``parallel/mesh.py``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple, Union

import torch

from ray_tpu_torch.parallel.mesh import active_mesh, mesh_sizes

MeshAxes = Union[str, Tuple[str, ...], None]


class LogicalRules:
    """Ordered mapping logical axis -> mesh axis (or tuple of mesh axes)."""

    def __init__(self, rules: Dict[str, MeshAxes]):
        self._rules = dict(rules)

    def get(self, logical: Optional[str]) -> MeshAxes:
        if logical is None:
            return None
        return self._rules.get(logical)

    def extend(self, extra: Dict[str, MeshAxes]) -> "LogicalRules":
        new = dict(self._rules)
        new.update(extra)
        return LogicalRules(new)

    def spec(self, logical_axes: Sequence[Optional[str]],
             mesh=None) -> Tuple[MeshAxes, ...]:
        """The PartitionSpec (as a tuple) for an array whose dims carry these
        logical names. Mesh axes of size 1 (strategy off) are dropped so the
        same model code runs on any MeshSpec."""
        sizes = mesh_sizes(mesh) if mesh is not None else None
        out = []
        for ax in logical_axes:
            m = self.get(ax)
            if m is None:
                out.append(None)
                continue
            axes = (m,) if isinstance(m, str) else tuple(m)
            if sizes is not None:
                axes = tuple(a for a in axes if sizes.get(a, 1) > 1)
            if not axes:
                out.append(None)
            elif len(axes) == 1:
                out.append(axes[0])
            else:
                out.append(axes)
        while out and out[-1] is None:
            out.pop()
        return tuple(out)


# The canonical transformer ruleset. batch over (dp, fsdp); weights sharded
# on fsdp along their largest dim (ZeRO-3); tp splits heads/mlp/vocab;
# sp shards the sequence dim; ep shards experts.
DEFAULT_RULES = LogicalRules({
    "batch": ("dcn_dp", "dp", "fsdp"),
    "seq": "sp",
    "embed": "fsdp",
    "heads": "tp",
    "kv": None,
    "mlp": "tp",
    "vocab": "tp",
    "layers": None,
    "expert": "ep",
    "expert_mlp": "tp",
    "stage": "pp",
})


def spec_placements(mesh, spec: Sequence[MeshAxes]) -> list:
    """A PartitionSpec tuple -> one placement per dim of ``mesh``. A tensor
    dim over several mesh axes must name them in mesh order (DTensor splits
    over mesh dims left to right); each mesh axis may shard one dim."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        where = [names.index(a) for a in axes if a in names]
        if where != sorted(where):
            raise ValueError(f"mesh axes {axes} of dim {dim} are not in the "
                             f"mesh's order {tuple(names)}")
        for i in where:
            if out[i] != Replicate():
                raise ValueError(f"mesh axis {names[i]!r} shards two dims "
                                 f"of spec {spec}")
            out[i] = Shard(dim)
    return out


def placements(mesh, logical_axes: Sequence[Optional[str]],
               rules: LogicalRules = DEFAULT_RULES) -> list:
    """DTensor placements on ``mesh`` (one per mesh dim) for an array whose
    dims carry these logical names."""
    return spec_placements(mesh, rules.spec(logical_axes, mesh))


def logical_sharding(mesh, logical_axes: Sequence[Optional[str]],
                     rules: LogicalRules = DEFAULT_RULES):
    """(the active sub-mesh, its placements): the port's ``NamedSharding``."""
    sub = active_mesh(mesh)
    return sub, placements(sub, logical_axes, rules)


def replicated(mesh):
    """(the active sub-mesh, every dim ``Replicate()``)."""
    return logical_sharding(mesh, ())


def batch_sharding(mesh, ndim: int = 2, rules: LogicalRules = DEFAULT_RULES):
    """Sharding for a [batch, ...] array: batch dim over the data axes."""
    return logical_sharding(mesh, ["batch"] + [None] * (ndim - 1), rules)


def place(x: torch.Tensor, sharding):
    """``jax.device_put(x, sharding)``: a DTensor of ``x`` (the same global
    value on every rank) on the sharding's mesh, or ``x`` redistributed if
    it is already a DTensor."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    sub, pl = sharding
    if isinstance(x, DTensor):
        return x.redistribute(sub, pl)
    return distribute_tensor(x.to(sub.device_type), sub, pl)


def _map(fn, tree, axes_tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v, axes_tree[k]) for k, v in tree.items()}
    return fn(tree, axes_tree)


def shard_pytree(tree: Any, mesh, logical_axes_tree: Any,
                 rules: LogicalRules = DEFAULT_RULES) -> Any:
    """Place a dict tree of tensors with per-leaf logical axis names.
    ``logical_axes_tree`` mirrors ``tree``, each leaf a tuple of logical
    names (or None: replicated)."""
    return _map(lambda x, axes: place(x, pytree_sharding(mesh, axes, rules)),
                tree, logical_axes_tree)


def pytree_sharding(mesh, axes, rules: LogicalRules = DEFAULT_RULES):
    return logical_sharding(mesh, axes, rules) if axes is not None \
        else replicated(mesh)


def with_sharding(mesh, logical_axes: Sequence[Optional[str]], x,
                  rules: LogicalRules = DEFAULT_RULES):
    """``with_sharding_constraint``: ``x`` redistributed to the placements
    of these logical axes."""
    return place(x, logical_sharding(mesh, logical_axes, rules))


def pytree_shardings(tree: Any, mesh, logical_axes_tree: Any,
                     rules: LogicalRules = DEFAULT_RULES) -> Any:
    """Shardings (sub-mesh, placements) mirroring ``tree``."""
    return _map(lambda _, axes: pytree_sharding(mesh, axes, rules), tree,
                logical_axes_tree)


def shard_map(fn, mesh, in_specs, out_specs):
    """``jax.shard_map``: ``fn`` runs on each rank's local blocks of its
    arguments, which are split by ``in_specs`` (PartitionSpec tuples) over
    ``mesh``; its local results are joined by ``out_specs`` (one spec, or a
    list of specs for a tuple of results). Inside ``fn`` the collectives of
    ``parallel/collectives.py`` resolve axis names against ``mesh``. This is
    ``local_map`` on the active sub-mesh, which redistributes DTensor
    arguments to the specs' placements; a plain tensor argument is the same
    global value on every rank, and is split to its spec. Returns DTensors
    (the global results), differentiable."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    from ray_tpu_torch.parallel.collectives import axis_env
    sub = active_mesh(mesh)
    in_pl = tuple(spec_placements(sub, s) for s in in_specs)
    outs = out_specs if isinstance(out_specs, list) else [out_specs]
    out_pl = tuple(spec_placements(sub, s) for s in outs)
    # An argument's gradient over a mesh axis that it is replicated on:
    # where some spec names the axis, the ranks along it use their copies
    # differently, and the gradient is the sum of theirs (Partial); where
    # no spec names it, they all compute the same thing, and each holds
    # the whole gradient (Replicate). JAX infers the same from its specs.
    named = {a for spec in tuple(in_specs) + tuple(outs) for entry in spec
             if entry is not None
             for a in ((entry,) if isinstance(entry, str) else entry)}
    grad_pl = tuple([Partial() if p == Replicate() and name in named else p
                     for p, name in zip(pl, sub.mesh_dim_names)]
                    for pl in in_pl)

    def body(*local):
        with axis_env(mesh):
            return fn(*local)

    mapped = local_map(body, out_placements=out_pl if isinstance(
                           out_specs, list) else out_pl[0],
                       in_placements=in_pl, in_grad_placements=grad_pl,
                       device_mesh=sub, redistribute_inputs=True)

    def call(*args):
        return mapped(*(a if isinstance(a, DTensor) else place(a, (sub, pl))
                        for a, pl in zip(args, in_pl)))
    return call
