"""Port parity: the parallel layer. ``ray_tpu_torch.parallel`` (mesh,
logical-axis rules, placements, collectives) against ``ray_tpu.parallel``.

The JAX side runs on a 4-device sub-mesh of the conftest's 8 host devices,
``build_mesh(spec, devices=jax.devices()[:4])``. The port's side runs as
four gloo ranks, started once for the file by ``torch.multiprocessing``
(spawn) over a ``file://`` store under a temporary directory (no port to
clash on between xdist workers), each rank on one intra-op thread. The
world runs every case and writes each rank's results to ``.npz`` files,
which the tests hold to the JAX arrays: shards and layouts exactly, the
collectives within 1e-5 (float32 sums over 4 ranks in another order).
"""

import datetime
import fcntl
import logging
import os
import pickle

import numpy as np
import pytest
import torch
import torch.distributed as dist

from ray_tpu_torch.models import transformer as ttf
from ray_tpu_torch.parallel import mesh as tmesh
from ray_tpu_torch.parallel import sharding as tsharding

OP_TOL = 1e-5
WORLD = 4
# (MeshSpec kwargs, pp_stages of the model placed on it)
SPECS = [({"dp": 4}, 1), ({"dp": 2, "fsdp": 2}, 1), ({"fsdp": 2, "tp": 2}, 1),
         ({"pp": 2, "tp": 2}, 2), ({"dp": 2, "sp": 2}, 1)]
SPEC_IDS = ["dp4", "dp2-fsdp2", "fsdp2-tp2", "pp2-tp2", "dp2-sp2"]
# (axis, MeshSpec kwargs): one axis, and a tuple flattened as JAX does
COLLECTIVE_AXES = [("sp", {"sp": 4}), (("dp", "fsdp"), {"dp": 2, "fsdp": 2})]
COLLECTIVES = ["allreduce_sum", "allreduce_mean", "allreduce_max",
               "allreduce_min", "allgather0", "allgather1",
               "allgather_untiled", "reducescatter", "alltoall",
               "ring_permute", "ring_permute_back", "broadcast_from",
               "axis_index", "axis_size"]


def _cfg_kw(pp_stages):
    return dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, d_ff=64,
                max_seq=16, attn_impl="reference", pp_stages=pp_stages,
                num_microbatches=pp_stages)


# ---------------------------------------------------------------------------
# the gloo world (runs in the spawned ranks; imports no JAX)
# ---------------------------------------------------------------------------

def _rank_main(rank, root, body):
    torch.set_num_threads(1)
    logging.getLogger("torch.distributed.tensor").setLevel(logging.ERROR)
    dist.init_process_group("gloo", init_method=f"file://{root}/store",
                            rank=rank, world_size=WORLD,
                            timeout=datetime.timedelta(seconds=120))
    try:
        out = body(rank, root)
        np.savez(os.path.join(root, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


def _start_world(root, body):
    """The ranks run ``body`` while the caller goes on (the JAX side)."""
    import torch.multiprocessing as mp
    return mp.spawn(_rank_main, args=(str(root), body), nprocs=WORLD,
                    join=False)


def _join_world(ctx, root):
    while not ctx.join():
        pass
    return [dict(np.load(os.path.join(root, f"rank{r}.npz")))
            for r in range(WORLD)]


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _unflat(flat):
    tree = {}
    for path, v in flat.items():
        node = tree
        *keys, last = path.split("/")
        for k in keys:
            node = node.setdefault(k, {})
        node[last] = v
    return tree


def _collective_input(rank):
    """Rank ``rank``'s block [4, 6] of a seeded [16, 6] array."""
    x = np.random.default_rng(5).standard_normal((WORLD * 4, 6))
    return x.astype(np.float32)[rank * 4:(rank + 1) * 4]


def _port_collectives(x):
    from ray_tpu_torch.parallel import collectives as c

    def run(axis):
        return {
            "allreduce_sum": c.allreduce_sum(x, axis),
            "allreduce_mean": c.allreduce_mean(x, axis),
            "allreduce_max": c.allreduce_max(x, axis),
            "allreduce_min": c.allreduce_min(x, axis),
            "allgather0": c.allgather(x, axis, concat_dim=0),
            "allgather1": c.allgather(x, axis, concat_dim=1),
            "allgather_untiled": c.allgather(x, axis, tiled=False),
            "reducescatter": c.reducescatter(x, axis, scatter_dim=0),
            "alltoall": c.alltoall(x, axis, split_dim=0, concat_dim=1),
            "broadcast_from": c.broadcast_from(x, axis, root=1)
            if isinstance(axis, str) else c.allreduce_sum(x, axis),
            "axis_index": torch.full((1,), float(c.axis_index(axis))),
            "axis_size": torch.full((1,), float(c.axis_size(axis))),
            "ring_permute": c.ring_permute(x, axis)
            if isinstance(axis, str) else x,
            "ring_permute_back": c.ring_permute(x, axis, shift=-1)
            if isinstance(axis, str) else x,
        }
    return run


def _world_body(rank, root):
    from ray_tpu_torch.parallel import collectives as c
    inputs = dict(np.load(os.path.join(root, "inputs.npz")))
    out = {}
    for i, (spec_kw, pp) in enumerate(SPECS):
        mesh = tmesh.build_mesh(tmesh.MeshSpec(**spec_kw), device="cpu")
        out[f"layout{i}"] = mesh.mesh.numpy()
        cfg = ttf.TransformerConfig(dtype=torch.float32, **_cfg_kw(pp))
        params = _unflat({k[len(f"p{pp}/"):]: torch.from_numpy(v)
                          for k, v in inputs.items()
                          if k.startswith(f"p{pp}/")})
        placed = tsharding.shard_pytree(params, mesh,
                                        ttf.transformer_logical_axes(cfg))
        for path, leaf in _flat(placed).items():
            out[f"shard{i}/{path}"] = leaf.to_local().numpy()
    x = torch.from_numpy(_collective_input(rank))
    for j, (axis, spec_kw) in enumerate(COLLECTIVE_AXES):
        mesh = tmesh.build_mesh(tmesh.MeshSpec(**spec_kw), device="cpu")
        with c.axis_env(mesh):
            for name, value in _port_collectives(x)(axis).items():
                out[f"coll{j}/{name}"] = value.numpy()
    # the shard_map wrapper: local blocks in, the global result out
    mesh = tmesh.build_mesh(tmesh.MeshSpec(sp=4), device="cpu")
    full = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (WORLD * 4, 6)).astype(np.float32))
    summed = tsharding.shard_map(lambda a: c.allreduce_sum(a, "sp") * 2.0,
                                 mesh, (("sp",),), ())(full)
    out["shard_map"] = summed.full_tensor().numpy()
    return out


def _once(tmp_path_factory, name, compute):
    """``compute(directory)`` once for the whole run, its result shared by
    the xdist workers through a pickle under the run's temporary root (a
    file lock lets one compute while the others wait)."""
    base = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        base = base.parent
    path = base / f"{name}.pkl"
    with open(base / f"{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not path.exists():
            result = compute(tmp_path_factory.mktemp(name))
            with open(base / f"{name}.part", "wb") as f:
                pickle.dump(result, f)
            os.replace(base / f"{name}.part", path)
    with open(path, "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Every case of the file: the port's in one world of 4 gloo ranks
    (``"port"``, a dict a rank), and the JAX side's (``"jax"``)."""
    return _once(tmp_path_factory, "gloo_parallel", _compute)


def _compute(root):
    import jax
    inputs = {}
    for pp in (1, 2):
        inputs.update({f"p{pp}/{k}": np.array(v) for k, v in _flat(
            jax.tree.map(np.asarray, _jax_params(pp))).items()})
    np.savez(root / "inputs.npz", **inputs)
    ctx = _start_world(root, _world_body)
    want = {"layout": [_jax_layout(i) for i in range(len(SPECS))],
            "shards": [_jax_shards(i) for i in range(len(SPECS))],
            "coll": [_jax_collectives(j)
                     for j in range(len(COLLECTIVE_AXES))]}
    return {"port": _join_world(ctx, root), "jax": want}


def _jax_params(pp):
    import jax
    import jax.numpy as jnp
    from ray_tpu.models import transformer as jtf
    cfg = jtf.TransformerConfig(dtype=jnp.float32, **_cfg_kw(pp))
    return jtf.transformer_init(jax.random.PRNGKey(3), cfg)


def _jax_mesh(spec_kw):
    import jax
    from ray_tpu.parallel import MeshSpec, build_mesh
    return build_mesh(MeshSpec(**spec_kw), devices=jax.devices()[:WORLD])


# ---------------------------------------------------------------------------
# MeshSpec, its helpers and the rules (no world)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(num_devices=8, tp=2, sp=2),
                                dict(num_devices=8, fsdp=2),
                                dict(num_devices=16, tp=2, pp=2, fsdp=4),
                                dict(num_devices=4, dcn_dp=2)])
def test_mesh_spec_auto_matches_jax(kw):
    from ray_tpu.parallel import mesh as jmesh
    got, want = tmesh.MeshSpec.auto(**kw), jmesh.MeshSpec.auto(**kw)
    assert dataclasses_tuple(got) == dataclasses_tuple(want)
    assert got.num_devices == want.num_devices
    assert got.devices_per_slice == want.devices_per_slice
    assert got.axis_sizes() == want.axis_sizes()
    assert got.active_axes() == want.active_axes()
    assert tmesh.mesh_shape_for(got) == jmesh.mesh_shape_for(want)


def dataclasses_tuple(spec):
    return tuple(getattr(spec, a) for a in tmesh.AXIS_ORDER)


@pytest.mark.parametrize("kw", [dict(num_devices=6, tp=4),
                                dict(num_devices=8, tp=2, fsdp=3)])
def test_mesh_spec_auto_errors_match_jax(kw):
    from ray_tpu.parallel import mesh as jmesh
    with pytest.raises(ValueError) as want:
        jmesh.MeshSpec.auto(**kw)
    with pytest.raises(ValueError) as got:
        tmesh.MeshSpec.auto(**kw)
    assert str(got.value) == str(want.value)


def test_axis_order_and_data_axes_match_jax():
    from ray_tpu.parallel import mesh as jmesh
    assert tmesh.AXIS_ORDER == jmesh.AXIS_ORDER
    assert tmesh.data_axes() == jmesh.data_axes()


@pytest.mark.parametrize("dims", [(4,), (2, 3), (3, 2, 2), (2, 2, 2, 2)])
def test_snake_iter_matches_jax(dims):
    from ray_tpu.parallel import mesh as jmesh
    assert list(tmesh._snake_iter(dims)) == list(jmesh._snake_iter(dims))


def test_topology_order_matches_jax_and_keeps_ranks():
    from ray_tpu.parallel import mesh as jmesh

    class Chip:
        def __init__(self, coords, core=0):
            self.coords, self.core_on_chip = coords, core

    chips = [Chip((x, y, 0), c) for y in range(2) for x in range(2)
             for c in range(2)]
    want = jmesh._topology_ordered(chips)
    assert tmesh._topology_ordered(chips) == want and want is not None
    assert tmesh._topology_ordered([0, 1, 2, 3]) is None   # ranks


@pytest.mark.parametrize("n,params_bytes,hbm", [
    (8, 1 << 30, 16 << 30), (8, 4 << 30, 16 << 30), (8, 40 << 30, 16 << 30),
    (4, 40 << 30, 80 << 30)])
def test_best_dp_fsdp_split_matches_jax_at_a_stated_hbm(n, params_bytes,
                                                        hbm):
    from ray_tpu.parallel import mesh as jmesh
    got = tmesh.best_dp_fsdp_split(n, params_bytes, hbm)
    want = jmesh.best_dp_fsdp_split(n, params_bytes, hbm)
    assert dataclasses_tuple(got) == dataclasses_tuple(want)


def test_best_dp_fsdp_split_default_is_the_cards_memory(monkeypatch):
    # the JAX default (16 GiB) is a TPU's; the port's reads the card
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tmesh.best_dp_fsdp_split(8, 1 << 30)


def test_build_mesh_without_a_group_needs_one_device():
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="MeshSpec needs 4 devices, have 1"):
        tmesh.build_mesh(tmesh.MeshSpec(dp=4), device="cpu")


class _Sizes:
    """What ``LogicalRules.spec`` reads of a mesh: its axis names and
    shape."""

    def __init__(self, spec_kw):
        self.mesh_dim_names = tmesh.AXIS_ORDER
        self.mesh = torch.empty([spec_kw.get(a, 1) for a in tmesh.AXIS_ORDER])


@pytest.mark.parametrize("case", range(len(SPECS)), ids=SPEC_IDS)
def test_logical_rules_spec_matches_jax(case):
    from ray_tpu.models import transformer as jtf
    from ray_tpu.parallel import sharding as jsharding
    spec_kw, pp = SPECS[case]
    jmesh_ = _jax_mesh(spec_kw)
    import jax.numpy as jnp
    jaxes = jtf.transformer_logical_axes(
        jtf.TransformerConfig(dtype=jnp.float32, **_cfg_kw(pp)))
    taxes = ttf.transformer_logical_axes(
        ttf.TransformerConfig(dtype=torch.float32, **_cfg_kw(pp)))
    assert _flat(taxes) == _flat(jaxes)
    for path, axes in _flat(taxes).items():
        want = tuple(jsharding.DEFAULT_RULES.spec(axes, jmesh_))
        got = tsharding.DEFAULT_RULES.spec(axes, _Sizes(spec_kw))
        assert got == want, path


def test_logical_rules_get_extend_and_placements():
    from ray_tpu.parallel import sharding as jsharding
    for rules in (tsharding.DEFAULT_RULES,
                  tsharding.DEFAULT_RULES.extend({"kv": "tp"})):
        jrules = jsharding.DEFAULT_RULES.extend(
            {"kv": "tp"} if rules is not tsharding.DEFAULT_RULES else {})
        for name in ("batch", "seq", "embed", "kv", "vocab", "stage", None,
                     "unknown"):
            assert rules.get(name) == jrules.get(name)
    from torch.distributed.tensor import Replicate, Shard
    sizes = _Sizes({"dp": 2, "fsdp": 2, "tp": 2})
    got = tsharding.spec_placements(sizes, (("dp", "fsdp"), None, "tp"))
    want = [Replicate(), Replicate(), Shard(0), Shard(0), Replicate(),
            Replicate(), Shard(2)]
    assert got == want
    with pytest.raises(ValueError, match="mesh's order"):
        tsharding.spec_placements(sizes, (("fsdp", "dp"),))
    with pytest.raises(ValueError, match="shards two dims"):
        tsharding.spec_placements(sizes, ("tp", "tp"))


# ---------------------------------------------------------------------------
# the world's cases against JAX
# ---------------------------------------------------------------------------

def _jax_layout(case):
    return np.vectorize(lambda d: d.id)(_jax_mesh(SPECS[case][0]).devices)


def _jax_shards(case):
    """{leaf path: {device id: its shard}} of the JAX params placed by
    ``shard_pytree`` on the case's mesh."""
    import jax.numpy as jnp
    from ray_tpu.models import transformer as jtf
    from ray_tpu.parallel import sharding as jsharding
    spec_kw, pp = SPECS[case]
    cfg = jtf.TransformerConfig(dtype=jnp.float32, **_cfg_kw(pp))
    placed = jsharding.shard_pytree(_jax_params(pp), _jax_mesh(spec_kw),
                                    jtf.transformer_logical_axes(cfg))
    return {path: {s.device.id: np.asarray(s.data)
                   for s in leaf.addressable_shards}
            for path, leaf in _flat(placed).items()}


@pytest.mark.parametrize("case", range(len(SPECS)), ids=SPEC_IDS)
def test_mesh_rank_layout_matches_jax_device_ids(world, case):
    want = world["jax"]["layout"][case]
    for r in range(WORLD):
        np.testing.assert_array_equal(world["port"][r][f"layout{case}"],
                                      want)


@pytest.mark.parametrize("case", range(len(SPECS)), ids=SPEC_IDS)
def test_shard_pytree_local_shards_match_jax_shards(world, case):
    for path, shards in world["jax"]["shards"][case].items():
        for r in range(WORLD):
            got = world["port"][r][f"shard{case}/{path}"]
            np.testing.assert_array_equal(got, shards[r], err_msg=path)


def _jax_collectives(j):
    """Every collective of ``COLLECTIVE_AXES[j]`` through JAX's shard_map
    on the 4 host devices (computed once a file)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from ray_tpu.ops._compat import shard_map
    from ray_tpu.parallel import collectives as jc
    axis, spec_kw = COLLECTIVE_AXES[j]
    jm = _jax_mesh(spec_kw)
    x = np.concatenate([_collective_input(r) for r in range(WORLD)])
    fns = {
        "allreduce_sum": lambda a: jc.allreduce_sum(a, axis),
        "allreduce_mean": lambda a: jc.allreduce_mean(a, axis),
        "allreduce_max": lambda a: jc.allreduce_max(a, axis),
        "allreduce_min": lambda a: jc.allreduce_min(a, axis),
        "allgather0": lambda a: jc.allgather(a, axis, concat_dim=0),
        "allgather1": lambda a: jc.allgather(a, axis, concat_dim=1),
        "allgather_untiled": lambda a: jc.allgather(a, axis, tiled=False),
        "reducescatter": lambda a: jc.reducescatter(a, axis, scatter_dim=0),
        "alltoall": lambda a: jc.alltoall(a, axis, split_dim=0,
                                          concat_dim=1),
        "broadcast_from": (lambda a: jc.broadcast_from(a, axis, root=1))
        if isinstance(axis, str) else (lambda a: jc.allreduce_sum(a, axis)),
        "axis_index": lambda a: jnp.full((1,), jc.axis_index(axis),
                                         jnp.float32),
        "axis_size": lambda a: jnp.full((1,), jc.axis_size(axis),
                                        jnp.float32),
        "ring_permute": (lambda a: jc.ring_permute(a, axis))
        if isinstance(axis, str) else (lambda a: a),
        "ring_permute_back": (lambda a: jc.ring_permute(a, axis, shift=-1))
        if isinstance(axis, str) else (lambda a: a),
    }
    out = {}
    for name, fn in fns.items():
        out[name] = np.asarray(shard_map(
            fn, mesh=jm, in_specs=P(axis), out_specs=P(axis),
            check_vma=False)(x))
    del jax
    return out


@pytest.mark.parametrize("j", range(len(COLLECTIVE_AXES)),
                         ids=["sp", "dp-fsdp"])
@pytest.mark.parametrize("name", COLLECTIVES)
def test_collective_matches_shard_map(world, j, name):
    want = world["jax"]["coll"][j][name]
    got = np.concatenate([world["port"][r][f"coll{j}/{name}"]
                          for r in range(WORLD)])
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=OP_TOL, rtol=OP_TOL)


def test_shard_map_wrapper_returns_the_global_result(world):
    x = np.random.default_rng(5).standard_normal(
        (WORLD * 4, 6)).astype(np.float32)
    want = 2.0 * x.reshape(WORLD, 4, 6).sum(0)
    for r in range(WORLD):
        np.testing.assert_allclose(world["port"][r]["shard_map"], want,
                                   atol=OP_TOL, rtol=OP_TOL)


def test_broadcast_rounds_match_jax():
    from ray_tpu.parallel import collectives as jc
    from ray_tpu_torch.parallel import collectives as tc
    for n, fanout, root in ((0, 2, 0), (1, 2, 0), (7, 2, 3), (9, 3, 1),
                            (5, 0, 0)):
        assert tc.broadcast_rounds(n, fanout=fanout, root=root) == \
            jc.broadcast_rounds(n, fanout=fanout, root=root)


def test_collectives_need_an_axis_env():
    from ray_tpu_torch.parallel import collectives as tc
    with pytest.raises(RuntimeError, match="axis_env"):
        tc.allreduce_sum(torch.zeros(2), "sp")
