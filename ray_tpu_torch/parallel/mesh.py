"""The device mesh, ported from ``ray_tpu/parallel/mesh.py``.

One ``torch.distributed.device_mesh.DeviceMesh`` with the JAX package's seven
named axes (``AXIS_ORDER``, size-1 axes included) is the substrate of every
parallelism strategy. A process group's rank r stands in for
``jax.devices()[r]``: ranks are laid row-major over ``AXIS_ORDER`` as JAX lays
its devices. ``MeshSpec``, ``mesh_shape_for``, ``data_axes`` and
``_snake_iter`` are copies of the JAX functions (the port imports nothing of
``ray_tpu``).

DTensor's sharding propagation enumerates each operator's strategies as a
product over the dims of the mesh it runs on, so planning over all seven
dims, most of them of size 1, costs far more than over the few that shard
anything. Arrays are placed on ``active_mesh(mesh)``, the sub-mesh of the
axes larger than 1, which holds the same ranks in the same order.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ray_tpu_torch._device import resolve_device

AXIS_ORDER = ("dcn_dp", "pp", "dp", "fsdp", "sp", "ep", "tp")
# tp innermost (per-layer, latency-bound collectives on the nearest ranks),
# pp outermost within a slice, dcn_dp outermost of all: the JAX package's
# order (ray_tpu/parallel/mesh.py:17).


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Axis sizes for the global device mesh. 1 = strategy off."""
    dp: int = 1
    fsdp: int = 1
    tp: int = 1
    pp: int = 1
    sp: int = 1
    ep: int = 1
    dcn_dp: int = 1

    @property
    def num_devices(self) -> int:
        return (self.dp * self.fsdp * self.tp * self.pp * self.sp *
                self.ep * self.dcn_dp)

    @property
    def devices_per_slice(self) -> int:
        return self.num_devices // self.dcn_dp

    def axis_sizes(self) -> Dict[str, int]:
        return {a: getattr(self, a) for a in AXIS_ORDER}

    def active_axes(self) -> Tuple[str, ...]:
        return tuple(a for a in AXIS_ORDER if getattr(self, a) > 1)

    @staticmethod
    def auto(num_devices: int, *, tp: int = 1, pp: int = 1, sp: int = 1,
             ep: int = 1, fsdp: Optional[int] = None,
             dcn_dp: int = 1) -> "MeshSpec":
        """Fill the remaining devices with (fsdp or dp) parallelism."""
        model = tp * pp * sp * ep * dcn_dp
        if num_devices % model:
            raise ValueError(
                f"tp*pp*sp*ep*dcn_dp={model} does not divide "
                f"num_devices={num_devices}")
        rest = num_devices // model
        if fsdp is None:
            return MeshSpec(dp=rest, tp=tp, pp=pp, sp=sp, ep=ep,
                            dcn_dp=dcn_dp)
        if rest % fsdp:
            raise ValueError(f"fsdp={fsdp} does not divide remainder {rest}")
        return MeshSpec(dp=rest // fsdp, fsdp=fsdp, tp=tp, pp=pp, sp=sp,
                        ep=ep, dcn_dp=dcn_dp)


def mesh_shape_for(spec: MeshSpec) -> Tuple[Tuple[str, int], ...]:
    return tuple((a, getattr(spec, a)) for a in AXIS_ORDER)


def _snake_iter(dims: Sequence[int]):
    """Yield every index of a grid of shape `dims` along a Hamiltonian path
    where consecutive indices differ by exactly 1 in exactly one dimension
    (generalized boustrophedon). dims[0] is the fastest-varying dimension."""
    ndim = len(dims)
    total = 1
    for s in dims:
        total *= s
    for n in range(total):
        digits = []
        rem = n
        for size in dims:
            digits.append(rem % size)
            rem //= size
        # a dimension's direction reverses whenever the combined position of
        # all more-significant dimensions has odd parity
        coord = [0] * ndim
        acc = 0
        for i in reversed(range(ndim)):
            c = digits[i] if acc % 2 == 0 else dims[i] - 1 - digits[i]
            coord[i] = c
            acc += c
        yield tuple(coord)


def _topology_ordered(devs: Sequence) -> Optional[List]:
    """Reorder devices that carry ``coords`` (and ``core_on_chip``) along a
    snake path over their grid, as the JAX function does for TPU chips.
    Returns None when coords are missing, duplicated or not a full box; the
    caller then keeps the given order. Process-group ranks carry no coords,
    so a CUDA mesh keeps the rank order (NVLink placement is the GPU
    topology module's, ROADMAP.md A.5)."""
    recs = []
    for d in devs:
        coords = getattr(d, "coords", None)
        if coords is None:
            return None
        try:
            c = tuple(int(x) for x in coords)
        except (TypeError, ValueError):
            return None
        recs.append((c, int(getattr(d, "core_on_chip", 0) or 0), d))
    if not recs:
        return None
    ndim = len(recs[0][0])
    if any(len(c) != ndim for c, _, _ in recs):
        return None
    dims = tuple(max(c[i] for c, _, _ in recs) + 1 for i in range(ndim))
    ncores = max(core for _, core, _ in recs) + 1
    grid = {}
    for c, core, d in recs:
        if (c, core) in grid:
            return None
        grid[(c, core)] = d
    expected = ncores
    for s in dims:
        expected *= s
    if len(grid) != expected:
        return None
    return [grid[(idx, core)] for idx in _snake_iter(dims)
            for core in range(ncores)]


def _start_one_rank_group(dev: torch.device) -> None:
    """The default process group of a one-rank world: NCCL on the card, gloo
    on the CPU, over an in-process store (no port, no file)."""
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index or 0)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            store=dist.HashStore(), rank=0, world_size=1)


def build_mesh(spec: MeshSpec, devices: Optional[Sequence] = None, *,
               topology_aware: bool = True, device=None):
    """A ``DeviceMesh`` with the spec's seven axes over the process group's
    ranks (``devices``: ranks, or objects with a ``rank``; default every rank
    of the world), on the card (``device=None``) or the CPU (``"cpu"``).

    Without a process group a one-rank spec starts one (NCCL on the card,
    gloo on the CPU); a larger spec needs the caller's group, whose ranks all
    call this with the same arguments. Ranks are laid row-major over
    ``AXIS_ORDER``; with ``topology_aware`` devices that carry ``coords`` are
    first put in snake order (``_topology_ordered``)."""
    from torch.distributed.device_mesh import DeviceMesh
    dev = resolve_device(device)
    if not dist.is_initialized():
        if spec.num_devices != 1:
            raise ValueError(f"MeshSpec needs {spec.num_devices} devices, "
                             f"have 1 (no process group: start one with "
                             f"torch.distributed.init_process_group)")
        _start_one_rank_group(dev)
    devs = list(devices) if devices is not None \
        else list(range(dist.get_world_size()))
    if spec.num_devices > len(devs):
        raise ValueError(
            f"MeshSpec needs {spec.num_devices} devices, have {len(devs)}")
    if spec.dcn_dp > 1:
        # ranks carry no slice index: split evenly, as the JAX function does
        # for virtual devices, each slice's block ordered on its own
        per = len(devs) // spec.dcn_dp
        groups = [devs[i * per:(i + 1) * per] for i in range(spec.dcn_dp)]
        ordered = []
        for g in groups:
            if len(g) < spec.devices_per_slice:
                raise ValueError(
                    f"dcn_dp={spec.dcn_dp} needs {spec.devices_per_slice} "
                    f"devices per slice, a slice has {len(g)}")
            og = _topology_ordered(g) if topology_aware else None
            ordered += list(og if og is not None else g)[
                :spec.devices_per_slice]
        devs = ordered
    else:
        og = _topology_ordered(devs) if topology_aware else None
        devs = list(og if og is not None else devs)[:spec.num_devices]
    shape = [getattr(spec, a) for a in AXIS_ORDER]
    ranks = np.array([int(getattr(d, "rank", d)) for d in devs],
                     dtype=np.int64)
    return DeviceMesh(dev.type, torch.from_numpy(ranks.reshape(shape)),
                      mesh_dim_names=AXIS_ORDER)


def local_mesh(**axis_sizes):
    """Convenience: build_mesh(MeshSpec(**axis_sizes)) over every rank."""
    device = axis_sizes.pop("device", None)
    return build_mesh(MeshSpec(**axis_sizes), device=device)


def mesh_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a mesh."""
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def active_mesh(mesh):
    """The sub-mesh of the axes larger than 1 (the same ranks in the same
    order), or the 1-D ``dp`` sub-mesh when every axis is 1: where DTensors
    live (module docstring)."""
    active = tuple(a for a, n in mesh_sizes(mesh).items() if n > 1)
    if mesh.ndim == 1 or active == tuple(mesh.mesh_dim_names):
        return mesh
    return mesh[active] if active else mesh["dp"]


def data_axes() -> Tuple[str, ...]:
    """Mesh axes a per-example batch dimension is sharded over."""
    return ("dcn_dp", "dp", "fsdp")


def best_dp_fsdp_split(num_devices: int, params_bytes: int,
                       hbm_bytes_per_chip: Optional[int] = None) -> MeshSpec:
    """Heuristic: use pure DP until replicated params+opt-state (~4x params
    for adam in f32 master) would not fit; then shard with fsdp.
    ``hbm_bytes_per_chip=None`` is the card's own memory
    (``torch.cuda.get_device_properties(0).total_memory``); the JAX
    default, 16 GiB, is a TPU v5e's."""
    if hbm_bytes_per_chip is None:
        resolve_device(None)
        hbm_bytes_per_chip = torch.cuda.get_device_properties(0).total_memory
    need = params_bytes * 4
    if need <= hbm_bytes_per_chip // 2:
        return MeshSpec(dp=num_devices)
    fsdp = 1
    while fsdp < num_devices and need // fsdp > hbm_bytes_per_chip // 2:
        fsdp *= 2
    return MeshSpec(dp=num_devices // fsdp, fsdp=fsdp)
