"""Port parity: the LM and the PPO learner on a mesh. ``transformer_loss``
with ``mesh=`` (pipeline stages, ring and Ulysses attention, a masked loss),
``make_lm_train_step(cfg, mesh)`` and ``PPOLearner(mesh=)`` of
ray_tpu_torch against the JAX package's on the same 4-way meshes.

The JAX side runs on a 4-device sub-mesh of the conftest's 8 host devices;
the port's side as four gloo ranks, started once for the file by
``torch.multiprocessing`` (spawn) over a ``file://`` store under a
temporary directory, each rank on one intra-op thread. Weights are the JAX
package's (``params_from_jax``, ``set_weights``); tokens, masks and the RL
batch are seeded numpy.

Tolerances, f32: losses of one forward 1e-5; the pipeline's gradients
against the dense model's 1e-5; along 3 AdamW steps (lr 1e-3) the losses
and gradient norms 1e-4 relative and every parameter 1e-4 absolute
(tests/test_models_train_step.py holds its meshes to 2e-3 at bf16); the PPO
learner's stats 1e-5 relative and its weights 2e-6 after 8 Adam steps, as
tests/test_torch_rl_learner.py holds the one-device learner.
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

from ray_tpu_torch.models import convert
from ray_tpu_torch.models import transformer as ttf
from ray_tpu_torch.parallel import mesh as tmesh

WORLD = 4
LOSS_TOL = 1e-5
STEP_TOL = 1e-4
B, S = 8, 16
CFG = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
           d_ff=64, max_seq=32, attn_impl="reference")
STEP_SPECS = {"dp4": {"dp": 4}, "dp2-fsdp2": {"dp": 2, "fsdp": 2},
              "fsdp2-tp2": {"fsdp": 2, "tp": 2}}
PP_SPECS = {"pp2-tp2": {"pp": 2, "tp": 2}, "pp2-dp2": {"pp": 2, "dp": 2}}
SP_CASES = {"ring-sp4": ("ring", {"sp": 4}),
            "ring-dp2-sp2": ("ring", {"dp": 2, "sp": 2}),
            "ulysses-sp4": ("ulysses", {"sp": 4}),
            "ulysses-dp2-sp2": ("ulysses", {"dp": 2, "sp": 2})}
# the kept share of each dp rank's rows: their mask counts differ, so a
# mean of per-rank means is not the global masked mean
KEEP = (1.0, 0.6, 0.25, 0.05)
RL_SPEC = {"obs_dim": 6, "num_actions": 3, "hiddens": (16, 8)}
RL_HYPER = dict(lr=1e-3, clip_param=0.2, vf_clip_param=2.0,
                vf_loss_coeff=0.5, entropy_coeff=0.01, grad_clip=0.5, seed=3,
                num_sgd_iter=2, sgd_minibatch_size=16)


def _tcfg(**kw):
    return ttf.TransformerConfig(dtype=torch.float32, **{**CFG, **kw})


def _jcfg(**kw):
    import jax.numpy as jnp
    from ray_tpu.models import transformer as jtf
    return jtf.TransformerConfig(dtype=jnp.float32, **{**CFG, **kw})


def _batch(mask=False):
    rng = np.random.default_rng(1)
    out = {"tokens": rng.integers(0, CFG["vocab_size"], (B, S))
           .astype(np.int32)}
    if mask:
        keep = np.repeat(np.array(KEEP), B // WORLD)[:, None]
        out["mask"] = (rng.random((B, S)) < keep).astype(np.float32)
    return out


def _rl_batch():
    from ray_tpu_torch.rl import SampleBatch
    from ray_tpu_torch.rl import sample_batch as sb
    rng = np.random.default_rng(2)
    count = 69
    f32 = lambda x: np.asarray(x, np.float32)
    vf_preds = rng.standard_normal(count) * 2.0
    return SampleBatch({
        sb.OBS: f32(rng.standard_normal((count, RL_SPEC["obs_dim"]))),
        sb.ACTIONS: f32(rng.integers(0, RL_SPEC["num_actions"], count)),
        sb.ACTION_LOGP: f32(np.log(1 / 3) + 0.3 * rng.standard_normal(count)),
        sb.ADVANTAGES: f32(rng.standard_normal(count) * 2 + 0.5),
        sb.VF_PREDS: f32(vf_preds),
        sb.VALUE_TARGETS: f32(vf_preds + rng.standard_normal(count) * 3),
        sb.REWARDS: f32(rng.standard_normal(count)),
        sb.DONES: f32(rng.random(count) < 0.1),
    })


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


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
        with open(os.path.join(root, "inputs.pkl"), "rb") as f:
            out = body(rank, pickle.load(f))
        with open(os.path.join(root, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def _start_world(root, body, inputs):
    """The ranks run ``body`` while the caller goes on (the JAX side)."""
    import torch.multiprocessing as mp
    with open(os.path.join(root, "inputs.pkl"), "wb") as f:
        pickle.dump(inputs, f)
    return mp.spawn(_rank_main, args=(str(root), body), nprocs=WORLD,
                    join=False)


def _join_world(ctx, root):
    while not ctx.join():
        pass
    out = []
    for r in range(WORLD):
        with open(os.path.join(root, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def _full(tree):
    return {k: v.detach().full_tensor().numpy()
            for k, v in _flat(tree).items()}


def _world_body(rank, inputs):
    from ray_tpu_torch.rl import PPOLearner, SampleBatch
    from ray_tpu_torch.train import make_lm_train_step
    meshes = {}

    def mesh_of(spec_kw):
        key = tuple(sorted(spec_kw.items()))
        if key not in meshes:
            meshes[key] = tmesh.build_mesh(tmesh.MeshSpec(**spec_kw),
                                           device="cpu")
        return meshes[key]

    def params(tree, cfg):
        return convert.params_from_jax(tree, cfg, device="cpu")

    out = {}
    cfg = _tcfg()
    for name, spec_kw in STEP_SPECS.items():
        init_fn, step_fn, place = make_lm_train_step(
            cfg, mesh_of(spec_kw), learning_rate=1e-3, device="cpu")
        state = init_fn(params(inputs[f"step/{name}"], cfg))
        batch = place(_batch(mask=name == "dp4"))
        metrics = []
        for _ in range(3):
            state, m = step_fn(state, batch)
            metrics.append((m["loss"].item(), m["grad_norm"].item(),
                            m["step"]))
        out[f"step/{name}/metrics"] = metrics
        out[f"step/{name}/params"] = _full(state.params)
    pcfg = _tcfg(pp_stages=2, num_microbatches=2)
    for name, spec_kw in PP_SPECS.items():
        mesh = mesh_of(spec_kw)
        from ray_tpu_torch.parallel.sharding import shard_pytree
        placed = shard_pytree(params(inputs["pp"], pcfg), mesh,
                              ttf.transformer_logical_axes(pcfg))
        leaves = list(_flat(placed).values())
        for leaf in leaves:
            leaf.requires_grad_(True)
        loss = ttf.transformer_loss(placed, _batch(), pcfg, mesh=mesh,
                                    device="cpu")
        grads = torch.autograd.grad(loss, leaves)
        out[f"pp/{name}/loss"] = loss.full_tensor().item()
        out[f"pp/{name}/grads"] = {k: g.full_tensor().numpy() for k, g in
                                   zip(_flat(placed), grads)}
    for name, (impl, spec_kw) in SP_CASES.items():
        scfg = _tcfg(attn_impl=impl)
        loss = ttf.transformer_loss(params(inputs["dense"], scfg), _batch(),
                                    scfg, mesh=mesh_of(spec_kw),
                                    device="cpu")
        out[f"sp/{name}/loss"] = loss.full_tensor().item()
    loss = ttf.transformer_loss(params(inputs["dense"], cfg),
                                _batch(mask=True), cfg,
                                mesh=mesh_of({"dp": 4}), device="cpu")
    out["masked/loss"] = loss.full_tensor().item()
    learner = PPOLearner(RL_SPEC, device="cpu", mesh=mesh_of({"dp": 4}),
                         **RL_HYPER)
    learner.set_weights(inputs["rl/weights"])
    batch = SampleBatch(inputs["rl/batch"])
    out["rl/stats"] = [learner.update(batch), learner.update(batch)]
    out["rl/weights"] = learner.get_weights()
    # the refusal: pipeline stages off the pp axis
    c = _tcfg(pp_stages=2, num_microbatches=2)
    p = ttf.transformer_init(torch.Generator().manual_seed(0), c,
                             device="cpu")
    try:
        ttf.transformer_apply(p, torch.zeros(4, 8, dtype=torch.long), c,
                              mesh=mesh_of({"dp": 4}), device="cpu")
    except ValueError as e:
        out["refused"] = (type(e).__name__, str(e))
    return out


def _jax_mesh(spec_kw):
    import jax
    from ray_tpu.parallel import MeshSpec, build_mesh
    return build_mesh(MeshSpec(**spec_kw), devices=jax.devices()[:WORLD])


def _np_tree(tree):
    import jax
    return jax.tree.map(np.array, tree)


def _jax_steps():
    """3 JAX train steps on each mesh -> (initial params, metrics, final
    params) by mesh name."""
    from ray_tpu.train import make_lm_train_step
    import jax
    out = {}
    for name, spec_kw in STEP_SPECS.items():
        mesh = _jax_mesh(spec_kw)
        init_fn, step_fn, place = make_lm_train_step(_jcfg(), mesh,
                                                     learning_rate=1e-3)
        state = init_fn(jax.random.PRNGKey(0))
        init = _np_tree(state.params)   # a copy: the step donates its state
        batch = place(_batch(mask=name == "dp4"))
        metrics = []
        for _ in range(3):
            state, m = step_fn(state, batch)
            metrics.append((float(m["loss"]), float(m["grad_norm"]),
                            int(m["step"])))
        out[name] = (init, metrics, _np_tree(state.params))
    return out


def _jax_pp_params():
    import jax
    from ray_tpu.models import transformer as jtf
    return _np_tree(jtf.transformer_init(
        jax.random.PRNGKey(3), _jcfg(pp_stages=2, num_microbatches=2)))


def _jax_dense_params():
    import jax
    from ray_tpu.models import transformer as jtf
    return _np_tree(jtf.transformer_init(jax.random.PRNGKey(4), _jcfg()))


def _jax_learner():
    from ray_tpu.rl import learner as jlearner
    return jlearner.PPOLearner(RL_SPEC, mesh=_jax_mesh({"dp": 4}),
                               **RL_HYPER)


def _rl_weights():
    """The JAX learner's init moved by a seeded draw (every bias starts
    at 0)."""
    import jax
    rng = np.random.default_rng(1)
    return jax.tree.map(
        lambda a: np.asarray(a) + 0.1 * rng.standard_normal(np.shape(a))
        .astype(np.float32), _jax_learner().get_weights())


def _rl_update(weights):
    """Two updates of the JAX learner on the dp=4 mesh from ``weights``
    -> (weights, their stats, the final weights)."""
    jl = _jax_learner()
    jl.set_weights(weights)
    batch = _rl_batch()
    stats = [jl.update(batch), jl.update(batch)]
    return weights, stats, _np_tree(jl.get_weights())


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
    return _once(tmp_path_factory, "gloo_train", _compute)


def _compute(root):
    import jax
    from ray_tpu.models import transformer as jtf
    pp, dense = _jax_pp_params(), _jax_dense_params()
    # the JAX steps' init_fn(PRNGKey(0)) places these values
    init = _np_tree(jtf.transformer_init(jax.random.PRNGKey(0), _jcfg()))
    weights = _rl_weights()
    inputs = {f"step/{name}": init for name in STEP_SPECS}
    inputs.update({"pp": pp, "dense": dense, "rl/weights": weights,
                   "rl/batch": dict(_rl_batch())})
    ctx = _start_world(root, _world_body, inputs)
    steps = _jax_steps()
    rl = _rl_update(weights)
    pcfg = _jcfg(pp_stages=2, num_microbatches=2)
    stage0 = {**pp, "layers": jax.tree.map(lambda a: a[0], pp["layers"])}
    want = {
        "steps": steps, "rl": rl,
        "pp": {name: _jax_loss(pp, pcfg, _batch(), spec_kw)
               for name, spec_kw in PP_SPECS.items()},
        "pp_on_dp4": _jax_loss(pp, pcfg, _batch(), {"dp": 4}),
        "stage0": _jax_loss(stage0, _jcfg(n_layers=1), _batch(), None),
        "sp": {name: _jax_loss(dense, _jcfg(attn_impl=impl), _batch(),
                               spec_kw)
               for name, (impl, spec_kw) in SP_CASES.items()},
        "dense": _jax_loss(dense, _jcfg(), _batch(), None),
        "masked": _jax_loss(dense, _jcfg(), _batch(mask=True), {"dp": 4}),
        "pp_params": pp, "dense_params": dense,
    }
    return {"port": _join_world(ctx, root), "jax": want}


# ---------------------------------------------------------------------------
# the cases
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(STEP_SPECS))
def test_train_steps_match_jax_on_the_same_mesh(world, name):
    _, want, _ = world["jax"]["steps"][name]
    for r in range(WORLD):
        got = world["port"][r][f"step/{name}/metrics"]
        assert [m[2] for m in got] == [m[2] for m in want] == [1, 2, 3]
        np.testing.assert_allclose([m[:2] for m in got],
                                   [m[:2] for m in want], rtol=STEP_TOL)
    assert want[-1][0] < want[0][0]


@pytest.mark.parametrize("name", sorted(STEP_SPECS))
def test_train_step_params_match_jax_on_the_same_mesh(world, name):
    _, _, want = world["jax"]["steps"][name]
    want = _flat(want)
    for r in range(WORLD):
        got = world["port"][r][f"step/{name}/params"]
        assert set(got) == set(want)
        for path, value in got.items():
            np.testing.assert_allclose(value, want[path], atol=STEP_TOL,
                                       err_msg=path)


def _jax_loss(params, cfg, batch, spec_kw):
    import jax
    from ray_tpu.models import transformer as jtf
    mesh = _jax_mesh(spec_kw) if spec_kw else None
    return float(jax.jit(lambda p, b: jtf.transformer_loss(
        p, b, cfg, mesh=mesh))(params, batch))


@pytest.mark.parametrize("name", sorted(PP_SPECS))
def test_pipeline_loss_matches_jax_and_the_dense_loss(world, name):
    want = world["jax"]["pp"][name]
    dense = _dense_of_pp(world)
    for r in range(WORLD):
        got = world["port"][r][f"pp/{name}/loss"]
        assert abs(got - want) <= LOSS_TOL
        assert abs(got - dense[0]) <= LOSS_TOL


def _dense_of_pp(world):
    """The port's one-device loss and gradients on the pp weights with the
    stages flattened into one stack [L, ...]."""
    cfg = _tcfg()
    tree = world["jax"]["pp_params"]
    flat = {**tree, "layers": {k: v for k, v in _unstack2(tree["layers"])}}
    params = convert.params_from_jax(flat, cfg, device="cpu")
    leaves = list(_flat(params).values())
    for leaf in leaves:
        leaf.requires_grad_(True)
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    loss = ttf.transformer_loss(params, batch, cfg, device="cpu")
    grads = torch.autograd.grad(loss, leaves)
    return loss.item(), dict(zip(_flat(params), grads))


def _unstack2(layers):
    for k, v in layers.items():
        yield k, (dict(_unstack2(v)) if isinstance(v, dict)
                  else v.reshape((-1,) + v.shape[2:]))


@pytest.mark.parametrize("name", sorted(PP_SPECS))
def test_pipeline_gradients_are_the_dense_gradients(world, name):
    _, dense = _dense_of_pp(world)
    for r in range(WORLD):
        got = world["port"][r][f"pp/{name}/grads"]
        assert set(got) == set(dense)
        for path, g in got.items():
            want = dense[path].numpy()
            np.testing.assert_allclose(g.reshape(want.shape), want,
                                       atol=LOSS_TOL, err_msg=path)


def test_jax_pipeline_on_a_pp_axis_of_1_applies_stage_0_only(world):
    """The divergence the port refuses (ROADMAP.md C): with pp_stages 2 on a
    mesh whose pp axis is 1, the JAX pipeline takes the first slice of the
    stage dim, so its loss is that of stage 0's layers alone."""
    got = world["jax"]["pp_on_dp4"]
    assert abs(got - world["jax"]["stage0"]) <= LOSS_TOL
    assert abs(got - _dense_of_pp(world)[0]) > 1e-3


def test_port_refuses_pipeline_stages_off_the_pp_axis(world):
    for r in range(WORLD):
        pp_type, pp_msg = world["port"][r]["refused"]
        assert pp_type == "ValueError" and "'pp' axis" in pp_msg


@pytest.mark.parametrize("name", sorted(SP_CASES))
def test_sequence_parallel_lm_loss_matches_jax(world, name):
    want, dense = world["jax"]["sp"][name], world["jax"]["dense"]
    for r in range(WORLD):
        got = world["port"][r][f"sp/{name}/loss"]
        assert abs(got - want) <= LOSS_TOL
        assert abs(got - dense) <= LOSS_TOL


def test_masked_loss_is_the_global_masked_mean(world):
    batch = _batch(mask=True)
    want = world["jax"]["masked"]
    cfg = _tcfg()
    params = convert.params_from_jax(world["jax"]["dense_params"], cfg,
                                     device="cpu")
    one = ttf.transformer_loss(params, {k: torch.from_numpy(v)
                                        for k, v in batch.items()}, cfg,
                               device="cpu").item()
    per_rank = np.mean([ttf.transformer_loss(
        params, {k: torch.from_numpy(v[2 * r:2 * r + 2])
                 for k, v in batch.items()}, cfg, device="cpu").item()
        for r in range(WORLD)])
    counts = batch["mask"][:, 1:].reshape(WORLD, -1).sum(1)
    assert len(set(counts.tolist())) == WORLD     # unequal counts
    assert abs(per_rank - one) > 1e-3             # a mean of means is off
    for r in range(WORLD):
        assert abs(world["port"][r]["masked/loss"] - want) <= LOSS_TOL
        assert abs(world["port"][r]["masked/loss"] - one) <= LOSS_TOL


def test_ppo_learner_update_on_dp4_matches_jax(world):
    import jax
    _, want_stats, want_weights = world["jax"]["rl"]
    for r in range(WORLD):
        got_stats = world["port"][r]["rl/stats"]
        for got, want in zip(got_stats, want_stats):
            assert set(got) == set(want)
            for k in want:
                np.testing.assert_allclose(got[k], float(want[k]),
                                           rtol=1e-5, atol=1e-7, err_msg=k)
        errors = [float(np.max(np.abs(a - b))) for a, b in zip(
            jax.tree.leaves(world["port"][r]["rl/weights"]),
            jax.tree.leaves(want_weights))]
        assert len(errors) == len(jax.tree.leaves(want_weights))
        assert max(errors) <= 2e-6, errors
