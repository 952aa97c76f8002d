"""Port parity: ring attention, Ulysses attention and the GPipe pipeline of
``ray_tpu_torch.ops`` against ``ray_tpu.ops`` on a 4-way mesh.

The JAX side runs on a 4-device sub-mesh of the conftest's 8 host devices;
the port's side as four gloo ranks, started once for the file by
``torch.multiprocessing`` (spawn) over a ``file://`` store under a
temporary directory, each rank on one intra-op thread. The inputs are
seeded numpy [B, S, H, D] arrays, the same global arrays on every rank.

Tolerances, f32: forward outputs 1e-5 (online-softmax sums over 4 chunks in
another order), and gradients of ``sum(out * w)`` for a seeded w 1e-5,
against the JAX functions' ``jax.grad`` (as tests/test_ops_attention.py
holds the JAX ring to its reference). The pipeline's forward and gradients
are held to JAX's pipeline and to the dense stack of the same stages.
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

from ray_tpu_torch.parallel import mesh as tmesh

TOL = 1e-5
WORLD = 4
# (name, attention, MeshSpec kwargs, causal, kv heads)
ATTN = [("ring-sp4-causal", "ring", {"sp": 4}, True, 4),
        ("ring-sp4", "ring", {"sp": 4}, False, 4),
        ("ring-dp2-sp2-causal", "ring", {"dp": 2, "sp": 2}, True, 4),
        ("ring-dp2-sp2", "ring", {"dp": 2, "sp": 2}, False, 4),
        ("ring-sp4-gqa", "ring", {"sp": 4}, True, 2),
        ("ulysses-sp4-causal", "ulysses", {"sp": 4}, True, 4),
        ("ulysses-sp4", "ulysses", {"sp": 4}, False, 4),
        ("ulysses-dp2-sp2-causal", "ulysses", {"dp": 2, "sp": 2}, True, 4),
        ("ulysses-dp2-sp2", "ulysses", {"dp": 2, "sp": 2}, False, 4),
        ("ulysses-sp4-gqa", "ulysses", {"sp": 4}, True, 2)]
GRADS = ["ring-sp4-causal", "ulysses-sp4-causal"]
B, S, H, D = 2, 64, 4, 16
PIPE_M, PIPE_MB, PIPE_W = 3, 4, 8    # microbatches, rows each, width


def _qkvw(kvh, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    return f(B, S, H, D), f(B, S, kvh, D), f(B, S, kvh, D), f(B, S, H, D)


def _pipe_inputs():
    rng = np.random.default_rng(7)
    return {"w": (0.4 * rng.standard_normal((WORLD, PIPE_W, PIPE_W)))
            .astype(np.float32),
            "b": (0.1 * rng.standard_normal((WORLD, PIPE_W))).astype(
                np.float32),
            "x": rng.standard_normal((PIPE_M, PIPE_MB, PIPE_W)).astype(
                np.float32),
            "g": rng.standard_normal((PIPE_M, PIPE_MB, PIPE_W)).astype(
                np.float32)}


def _stage(params, a, xp=torch):
    return xp.tanh(a @ params["w"] + params["b"])


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


def _world_body(rank, root):
    from ray_tpu_torch.ops import pipeline, ring_attention, ulysses_attention
    from ray_tpu_torch.parallel.sharding import place, replicated
    meshes = {}

    def mesh_of(spec_kw):
        key = tuple(sorted(spec_kw.items()))
        if key not in meshes:
            meshes[key] = tmesh.build_mesh(tmesh.MeshSpec(**spec_kw),
                                           device="cpu")
        return meshes[key]

    out = {}
    for name, impl, spec_kw, causal, kvh in ATTN:
        mesh = mesh_of(spec_kw)
        fn = ring_attention if impl == "ring" else ulysses_attention
        q, k, v, w = (place(torch.from_numpy(a), replicated(mesh))
                      .requires_grad_() for a in _qkvw(kvh))
        o = fn(q, k, v, mesh, causal=causal)
        out[f"{name}/out"] = o.full_tensor().detach().numpy()
        if name in GRADS:
            grads = torch.autograd.grad((o * w.detach()).sum(), (q, k, v))
            for part, g in zip("qkv", grads):
                out[f"{name}/d{part}"] = g.full_tensor().numpy()
    mesh = mesh_of({"pp": 4})
    from torch.distributed.tensor import Shard
    p = _pipe_inputs()
    stages = {n: place(torch.from_numpy(p[n]), (mesh["pp"], [Shard(0)]))
              .requires_grad_() for n in ("w", "b")}
    x = place(torch.from_numpy(p["x"]), replicated(mesh)).requires_grad_()
    y = pipeline.pipeline_apply(_stage, stages, x, mesh)
    g = place(torch.from_numpy(p["g"]), replicated(mesh))
    grads = torch.autograd.grad((y * g).sum(), (stages["w"], stages["b"], x))
    out["pipe/out"] = y.full_tensor().detach().numpy()
    for n, gr in zip(("dw", "db", "dx"), grads):
        out[f"pipe/{n}"] = gr.full_tensor().numpy()
    # stage params whose stage dim is not the pp axis' size are refused
    try:
        pipeline.pipeline_apply(_stage, {n: a[:2] for n, a in stages.items()},
                                x, mesh)
        out["pipe/refused"] = np.array(False)
    except ValueError as e:
        out["pipe/refused"] = np.array("must match" in str(e))
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
    return _once(tmp_path_factory, "gloo_seq", _compute)


def _compute(root):
    ctx = _start_world(root, _world_body)
    want = {"attn": {a[0]: _jax_attention(a[0]) for a in ATTN},
            "pipe": _jax_pipeline()}
    return {"port": _join_world(ctx, root), "jax": want}


# ---------------------------------------------------------------------------
# the JAX side
# ---------------------------------------------------------------------------

def _jax_mesh(spec_kw):
    import jax
    from ray_tpu.parallel import MeshSpec, build_mesh
    return build_mesh(MeshSpec(**spec_kw), devices=jax.devices()[:WORLD])


def _jax_attention(name):
    import jax
    from ray_tpu.ops import ring_attention, ulysses_attention
    _, impl, spec_kw, causal, kvh = next(a for a in ATTN if a[0] == name)
    mesh = _jax_mesh(spec_kw)
    fn = ring_attention if impl == "ring" else ulysses_attention
    q, k, v, w = _qkvw(kvh)

    def loss(q, k, v):
        return (fn(q, k, v, mesh, causal=causal) * w).sum()

    out = {"out": np.asarray(fn(q, k, v, mesh, causal=causal))}
    if name in GRADS:
        for part, g in zip("qkv", jax.grad(loss, argnums=(0, 1, 2))(q, k, v)):
            out[f"d{part}"] = np.asarray(g)
    return out


def _jax_pipeline():
    import jax
    import jax.numpy as jnp
    from ray_tpu.ops.pipeline import pipeline_apply
    mesh = _jax_mesh({"pp": 4})
    p = _pipe_inputs()

    def loss(w, b, x):
        y = pipeline_apply(lambda sp, a: _stage(sp, a, jnp), {"w": w, "b": b},
                           x, mesh, num_microbatches=PIPE_M)
        return (y * p["g"]).sum(), y

    (_, y), grads = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                       has_aux=True)(p["w"], p["b"], p["x"])
    return {"out": np.asarray(y),
            **{n: np.asarray(g) for n, g in zip(("dw", "db", "dx"), grads)}}


# ---------------------------------------------------------------------------
# the cases
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", [a[0] for a in ATTN])
def test_attention_forward_matches_jax(world, name):
    want = world["jax"]["attn"][name]["out"]
    for r in range(WORLD):
        np.testing.assert_allclose(world["port"][r][f"{name}/out"], want,
                                   atol=TOL, rtol=TOL)


@pytest.mark.parametrize("part", "qkv")
@pytest.mark.parametrize("name", GRADS)
def test_attention_gradients_match_jax(world, name, part):
    want = world["jax"]["attn"][name][f"d{part}"]
    for r in range(WORLD):
        np.testing.assert_allclose(world["port"][r][f"{name}/d{part}"], want,
                                   atol=TOL, rtol=TOL)


def test_ring_attention_matches_the_reference_attention(world):
    from ray_tpu_torch.ops import attention_reference
    q, k, v, _ = (torch.from_numpy(a) for a in _qkvw(4))
    want = attention_reference(q, k, v, causal=True).numpy()
    np.testing.assert_allclose(world["port"][0]["ring-sp4-causal/out"], want,
                               atol=TOL, rtol=TOL)


@pytest.mark.parametrize("key", ["out", "dw", "db", "dx"])
def test_pipeline_matches_jax(world, key):
    want = world["jax"]["pipe"][key]
    for r in range(WORLD):
        np.testing.assert_allclose(world["port"][r][f"pipe/{key}"], want,
                                   atol=TOL, rtol=TOL)


@pytest.mark.parametrize("key", ["out", "dw", "db", "dx"])
def test_pipeline_matches_the_dense_stack(world, key):
    """The stages' gradients are the dense model's: the final all-reduce
    passes its cotangent through once (not n times)."""
    p = {k: torch.from_numpy(v).requires_grad_()
         for k, v in _pipe_inputs().items()}
    a = p["x"]
    for i in range(WORLD):
        a = _stage({"w": p["w"][i], "b": p["b"][i]}, a)
    grads = torch.autograd.grad((a * p["g"]).sum(), (p["w"], p["b"], p["x"]))
    want = {"out": a, "dw": grads[0], "db": grads[1], "dx": grads[2]}[key]
    np.testing.assert_allclose(world["port"][0][f"pipe/{key}"],
                               want.detach().numpy(), atol=TOL, rtol=TOL)


def test_pipeline_refuses_a_stage_count_off_the_axis(world):
    assert all(bool(world["port"][r]["pipe/refused"]) for r in range(WORLD))


def test_ulysses_refuses_heads_off_the_axis():
    """The JAX ValueError, raised before any collective."""
    from ray_tpu_torch.ops.ulysses import ulysses_attention_local
    from ray_tpu_torch.parallel import collectives as c

    class Axis:
        def size(self):
            return 3

    class Mesh:
        def _get_root_mesh(self):
            return {"sp": Axis()}

    q = torch.zeros(1, 4, 4, 8)
    with c.axis_env(Mesh()):
        with pytest.raises(ValueError, match="heads=4 not divisible by sp "
                                             "axis size 3"):
            ulysses_attention_local(q, q, q)
