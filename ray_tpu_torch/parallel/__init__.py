"""Parallelism strategies, ported from ``ray_tpu/parallel``.

Every strategy is an axis of one ``DeviceMesh`` with the JAX package's axis
names:

    dp    data parallel          (batch sharded, gradients all-reduced)
    fsdp  sharded data parallel  (batch + params/optimizer sharded, ZeRO-3)
    tp    tensor parallel        (weight matrices sharded within a layer)
    pp    pipeline parallel      (layer stages; microbatched GPipe loop)
    sp    sequence/context par.  (ring attention / Ulysses)
    ep    expert parallel        (MoE experts sharded; not ported yet)

Shardings are logical-axis rules mapped onto mesh axes (``LogicalRules``),
applied as DTensor placements; DTensor's sharding propagation inserts the
collectives where XLA's GSPMD does in the JAX package.
"""

from ray_tpu_torch.parallel.mesh import (
    MeshSpec,
    build_mesh,
    local_mesh,
    mesh_shape_for,
)
from ray_tpu_torch.parallel.sharding import (
    LogicalRules,
    DEFAULT_RULES,
    logical_sharding,
    shard_pytree,
    with_sharding,
    batch_sharding,
    replicated,
)

__all__ = [
    "MeshSpec", "build_mesh", "local_mesh", "mesh_shape_for",
    "LogicalRules", "DEFAULT_RULES", "logical_sharding", "shard_pytree",
    "with_sharding", "batch_sharding", "replicated",
]
