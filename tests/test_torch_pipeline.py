"""The port's MPMD pipeline training (``ray_tpu_torch.dag.schedule``,
``ray_tpu_torch.train.pipeline`` and the stage functions of
``ray_tpu_torch.models.transformer``) held to the JAX package's.

- *Schedules:* ``stage_programs``, ``validate_programs`` and
  ``bubble_bound`` give JAX's results op for op over the grid of
  ``tests/test_pipeline_train.py``.
- *Stage functions:* on JAX weights carried over by ``params_from_jax``,
  the partitions, each partition's forward and the last one's loss equal
  JAX's in f32 (``STAGE_TOL``).
- *Training against JAX:* the stage actors (``PipelineStageActor``) of a
  port ``PipelineTrainer`` on the CPU cluster, loaded with JAX's converted
  partitions, give the losses and updated parameters of the JAX
  single-process reference (full-batch SGD at lr 0.1, the reference of
  ``tests/test_pipeline_train.py:70-98``) for 1F1B, interleaved 1F1B and
  two DP replicas (``TRAIN_TOL``).
- *Counterparts* of the 14 test functions of ``tests/test_pipeline_train.py``,
  with the port's single-process trajectory from the same seeded weights as
  the reference where the JAX tests use JAX's.
  ``test_timeline_stage_lanes_and_microbatch_flows`` holds
  ``test_timeline_stage_lanes_and_flow_joins``'s assertions on the port
  without running the JAX program, which fails in whole runs of the JAX
  package's tests (ROADMAP.md C, "Not queued").

A module hygiene fixture checks that no compiled pipeline of the port is
alive and no channel segment of this module's cluster is left after a test.
Stage actors get their optimizer factory by import path, so ``sgd`` is a
module-level function; workers import this module by name, so it imports
no JAX at the top.
"""

import os
import time

import numpy as np
import pytest
import torch

import ray_tpu_torch as rt
from ray_tpu_torch import config
from ray_tpu_torch.cluster import fault_plane
from ray_tpu_torch.cluster.cluster_utils import Cluster
from ray_tpu_torch.core import api as core_api
from ray_tpu_torch.core.exceptions import TaskError
from ray_tpu_torch.dag import channel, compiled
from ray_tpu_torch.dag import schedule as ps
from ray_tpu_torch.models import transformer as ttf
from ray_tpu_torch.train.pipeline import (CompiledPipeline, PipelineTrainer,
                                          SleepStage)

# f32 on the CPU: the two stacks sum in other orders.
STAGE_TOL = 1e-5
TRAIN_TOL = 2e-5
# The counterparts' own tolerance against the single-process trajectory
# (tests/test_pipeline_train.py's).
REF_TOL = 2e-3

GRID = [(2, 4, 1), (3, 6, 1), (4, 8, 1), (2, 8, 2), (3, 9, 1)]


def sgd(leaves):
    """The JAX tests' ``optax.sgd(0.1)``."""
    return torch.optim.SGD(leaves, lr=0.1)


def _small_cfg(**kw):
    base = dict(vocab_size=64, d_model=32, n_layers=4, n_heads=4,
                max_seq=32, dtype=torch.float32, remat=False)
    base.update(kw)
    return ttf.TransformerConfig(**base)


def _batches(n, batch=8, seq=16, seed=0):
    rng = np.random.default_rng(seed)
    return [{"tokens": rng.integers(0, 64, size=(batch, seq))
             .astype(np.int32)} for _ in range(n)]


def _flat_layers(params, n_layers):
    out = dict(params)
    out["layers"] = ttf._map_tree(
        params["layers"], lambda a: a.reshape((n_layers,) + a.shape[2:]))
    return out


def _port_reference(batches, pp_stages, lr=0.1):
    """The port's single-process trajectory: the pipeline's seeded init
    (pp-stacked layers reshaped flat), full-batch loss and SGD."""
    from ray_tpu_torch.train.step import _leaves
    cfg = _small_cfg(pp_stages=pp_stages, num_microbatches=4)
    params = _flat_layers(ttf.transformer_init(
        torch.Generator().manual_seed(0), cfg, device="cpu"), 4)
    leaves = _leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    opt = torch.optim.SGD(leaves, lr=lr)
    out = []
    for b in batches:
        loss = ttf.transformer_loss(
            params, {"tokens": torch.from_numpy(b["tokens"])}, _small_cfg(),
            device="cpu")
        grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            for p, g in zip(leaves, grads):
                p.grad = g
            opt.step()
        out.append(loss.item())
    return out


def _jax_reference(batches, pp_stages, lr=0.1):
    """tests/test_pipeline_train.py's ``_reference_losses``, returning the
    initial pp-stacked params (numpy), the losses and the final flat params
    (numpy)."""
    import jax
    import jax.numpy as jnp
    import optax

    from ray_tpu.models.transformer import (TransformerConfig,
                                            transformer_init,
                                            transformer_loss)

    def cfg(**kw):
        return TransformerConfig(vocab_size=64, d_model=32, n_layers=4,
                                 n_heads=4, max_seq=32, dtype=jnp.float32,
                                 remat=False, **kw)

    params = transformer_init(jax.random.PRNGKey(0),
                              cfg(pp_stages=pp_stages, num_microbatches=4))
    init = jax.tree.map(np.asarray, params)
    flat = dict(params)
    flat["layers"] = jax.tree.map(lambda a: a.reshape((4,) + a.shape[2:]),
                                  params["layers"])
    tx = optax.sgd(lr)
    opt = tx.init(flat)
    vg = jax.jit(jax.value_and_grad(
        lambda p, b: transformer_loss(p, b, cfg())))
    losses = []
    for b in batches:
        loss, g = vg(flat, {"tokens": jnp.asarray(b["tokens"])})
        upd, opt = tx.update(g, opt, flat)
        flat = optax.apply_updates(flat, upd)
        losses.append(float(loss))
    return init, losses, jax.tree.map(np.asarray, flat)


# ---------------------------------------------------------------------------
# fixtures
# ---------------------------------------------------------------------------

_CLUSTER = []


@pytest.fixture(scope="module")
def cluster():
    c = Cluster(initialize_head=True, head_node_args={"num_cpus": 16})
    rt.shutdown()    # whatever runtime an earlier module left in this worker
    rt.init(address=c.address)
    _CLUSTER.append(c)
    yield c
    prefixes = [n.store_prefix for n in c.nodes]
    _CLUSTER.remove(c)
    rt.shutdown()
    c.shutdown()
    deadline = time.monotonic() + 10.0
    while _store_files(prefixes) and time.monotonic() < deadline:
        time.sleep(0.05)
    assert not _store_files(prefixes)


def _store_files(prefixes):
    return [f for f in os.listdir("/dev/shm")
            if any(f.startswith(p) for p in prefixes)]


@pytest.fixture(autouse=True)
def _pipeline_hygiene():
    yield
    assert not compiled._live_graphs, (
        f"test leaked live pipelines: {compiled._live_graphs}")
    prefixes = [n.store_prefix for c in _CLUSTER for n in c.nodes]
    deadline = time.monotonic() + 2.0
    leaked = channel.leaked_segments(prefixes)
    while leaked and time.monotonic() < deadline:
        time.sleep(0.05)
        leaked = channel.leaked_segments(prefixes)
    assert not leaked, f"test leaked channel shm segments: {leaked}"


# ---------------------------------------------------------------------------
# schedules against JAX's
# ---------------------------------------------------------------------------


def _cases():
    return [(kind, s, m, v) for kind in ps.SCHEDULES for s, m, v in GRID
            if v == 1 or kind == "interleaved_1f1b"]


@pytest.mark.parametrize("kind,s,m,v", _cases())
def test_stage_programs_equal_jax_op_for_op(kind, s, m, v):
    from ray_tpu.dag import schedule as jps
    got = ps.stage_programs(kind, num_stages=s, num_microbatches=m,
                            num_chunks=v)
    want = jps.stage_programs(kind, num_stages=s, num_microbatches=m,
                              num_chunks=v)
    assert [[tuple(op) for op in prog] for prog in got] == \
        [[tuple(op) for op in prog] for prog in want]
    ps.validate_programs(got, num_stages=s, num_microbatches=m,
                         num_chunks=v)
    assert ps.bubble_bound(m, s, v) == jps.bubble_bound(m, s, v)


def test_schedule_errors_equal_jax():
    """The same inputs are refused with the same class and message."""
    from ray_tpu.dag import schedule as jps
    bad = [lambda mod: mod.stage_programs("zigzag", 2, 4),
           lambda mod: mod.stage_programs("1f1b", 2, 4, num_chunks=2),
           lambda mod: mod.stage_programs("1f1b", 0, 4),
           lambda mod: mod.bubble_bound(0, 2),
           lambda mod: mod.validate_programs(
               mod.stage_programs("interleaved_1f1b", 2, 4, 2), 2, 4),
           lambda mod: mod.validate_programs(
               [list(reversed(p)) for p in mod.stage_programs("1f1b", 2, 4)],
               2, 4)]
    for fn in bad:
        errs = []
        for mod in (ps, jps):
            with pytest.raises(Exception) as e:
                fn(mod)
            errs.append((type(e.value).__name__, str(e.value)))
        assert errs[0] == errs[1]


# ---------------------------------------------------------------------------
# stage functions against JAX's
# ---------------------------------------------------------------------------


def test_stage_functions_equal_jax():
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import transformer as jtf
    from ray_tpu_torch.models.convert import params_from_jax
    jcfg = jtf.TransformerConfig(vocab_size=64, d_model=32, n_layers=4,
                                 n_heads=4, n_kv_heads=2, max_seq=32,
                                 dtype=jnp.float32, remat=False,
                                 pp_stages=2)
    tcfg = _small_cfg(n_kv_heads=2, pp_stages=2)
    jparams = jtf.transformer_init(jax.random.PRNGKey(3), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    tokens = np.random.default_rng(1).integers(0, 64, (2, 16)).astype(
        np.int32)
    positions = np.ascontiguousarray(np.broadcast_to(np.arange(16), (2, 16)))
    jparts = [jtf.transformer_partition_params(jparams, jcfg, p)
              for p in range(2)]
    tparts = [ttf.transformer_partition_params(tparams, tcfg, p)
              for p in range(2)]
    assert sorted(tparts[0]) == sorted(jparts[0]) == ["embed", "layers"]
    assert sorted(tparts[1]) == sorted(jparts[1]) == [
        "final_norm", "layers", "lm_head"]
    jx = jtf.transformer_stage_forward(jparts[0], jnp.asarray(tokens),
                                       jnp.asarray(positions), jcfg, part=0)
    tx = ttf.transformer_stage_forward(
        tparts[0], torch.from_numpy(tokens), torch.from_numpy(positions),
        tcfg, part=0, device="cpu")
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=STAGE_TOL)
    jloss = jtf.transformer_stage_loss(jparts[1], jx, jnp.asarray(tokens),
                                       jcfg)
    tloss = ttf.transformer_stage_loss(
        tparts[1], torch.from_numpy(np.asarray(jx)),
        torch.from_numpy(tokens), tcfg, device="cpu")
    assert abs(tloss.item() - float(jloss)) <= STAGE_TOL
    # the two partitions compose to the unpartitioned model's loss
    flat = _flat_layers(tparams, 4)
    whole = ttf.transformer_loss(flat, {"tokens": torch.from_numpy(tokens)},
                                 _small_cfg(n_kv_heads=2), device="cpu")
    assert abs(whole.item() - tloss.item()) <= STAGE_TOL


def test_partitioning_refuses_what_jax_refuses():
    params = ttf.transformer_init(torch.Generator().manual_seed(0),
                                  _small_cfg(pp_stages=2), device="cpu")
    with pytest.raises(ValueError, match="pp_stages >= 2"):
        ttf.transformer_partition_params(params, _small_cfg(), 0)
    with pytest.raises(ValueError, match="tied_embeddings=False"):
        ttf.transformer_partition_params(
            params, _small_cfg(pp_stages=2, tied_embeddings=True), 0)


# ---------------------------------------------------------------------------
# training against the JAX reference
# ---------------------------------------------------------------------------


def _load_jax_partitions(tr, init, pp):
    from ray_tpu_torch.models.convert import params_from_jax
    cfg = _small_cfg(pp_stages=pp)
    params = params_from_jax(init, cfg, device="cpu")
    parts = [ttf.transformer_partition_params(params, cfg, p)
             for p in range(pp)]
    rt.get([h.load_partition.remote(p, parts[p])
            for stages in tr._groups for a, h in enumerate(stages)
            for p in range(a, pp, tr.num_stages)], timeout=120)


@pytest.mark.parametrize("kw,pp", [
    (dict(schedule="1f1b"), 2),
    (dict(schedule="interleaved_1f1b", num_chunks=2), 4),
    (dict(num_microbatches=2, dp_replicas=2), 2)],
    ids=["1f1b", "interleaved_1f1b", "dp_replicas_2"])
def test_stage_actors_on_jax_partitions_follow_the_jax_reference(
        cluster, kw, pp):
    batches = _batches(3)
    init, want_losses, want_flat = _jax_reference(batches, pp)
    args = dict(num_stages=2, num_microbatches=4, tx_factory=sgd, seed=0,
                device="cpu")
    args.update(kw)
    tr = PipelineTrainer(_small_cfg(), **args).start()
    try:
        _load_jax_partitions(tr, init, pp)
        got = [tr.step(b)["loss"] for b in batches]
        parts = rt.get([h.get_partition.remote(p)
                        for a, h in enumerate(tr._groups[0])
                        for p in range(a, pp, tr.num_stages)], timeout=60)
        owners = [p for a in range(tr.num_stages)
                  for p in range(a, pp, tr.num_stages)]
    finally:
        tr.shutdown()
    np.testing.assert_allclose(got, want_losses, atol=TRAIN_TOL)
    lp = 4 // pp
    for p, part in zip(owners, parts):
        want_layers = {k: (v[p * lp:(p + 1) * lp] if not isinstance(v, dict)
                           else {kk: vv[p * lp:(p + 1) * lp]
                                 for kk, vv in v.items()})
                       for k, v in want_flat["layers"].items()}
        for key in part["layers"]:
            if isinstance(part["layers"][key], dict):
                for kk in part["layers"][key]:
                    np.testing.assert_allclose(
                        part["layers"][key][kk], want_layers[key][kk],
                        atol=TRAIN_TOL, err_msg=f"part {p} {key}/{kk}")
            else:
                np.testing.assert_allclose(
                    part["layers"][key], want_layers[key], atol=TRAIN_TOL,
                    err_msg=f"part {p} {key}")
        for key in ("embed", "final_norm", "lm_head"):
            if key in part:
                np.testing.assert_allclose(part[key], want_flat[key],
                                           atol=TRAIN_TOL,
                                           err_msg=f"part {p} {key}")


# ---------------------------------------------------------------------------
# counterparts of tests/test_pipeline_train.py
# ---------------------------------------------------------------------------

def test_gpipe_runs_all_forwards_before_backwards():
    progs = ps.stage_programs("gpipe", num_stages=2, num_microbatches=4)
    for prog in progs:
        kinds = [op.kind for op in prog]
        first_b = kinds.index("B")
        assert all(k == "F" for k in kinds[:first_b])
        assert all(k == "B" for k in kinds[first_b:])


def test_1f1b_steady_state_interleaves():
    progs = ps.stage_programs("1f1b", num_stages=2, num_microbatches=4)
    stage0 = [(op.kind, op.mb) for op in progs[0]]
    assert stage0 == [("F", 0), ("F", 1), ("B", 0), ("F", 2),
                      ("B", 1), ("F", 3), ("B", 2), ("B", 3)]
    last = [(op.kind, op.mb) for op in progs[1]]
    assert last == [("F", 0), ("B", 0), ("F", 1), ("B", 1),
                    ("F", 2), ("B", 2), ("F", 3), ("B", 3)]


def test_interleaved_assigns_chunks_round_robin():
    s, v, m = 2, 2, 4
    progs = ps.stage_programs("interleaved_1f1b", num_stages=s,
                              num_microbatches=m, num_chunks=v)
    for a, prog in enumerate(progs):
        parts = {op.part for op in prog}
        assert parts == {p for p in range(s * v)
                         if ps.partition_owner(p, s) == a}
        assert len(prog) == 2 * v * m


@pytest.mark.parametrize("kind,s,m,v", _cases())
def test_programs_validate_executable(kind, s, m, v):
    progs = ps.stage_programs(kind, num_stages=s, num_microbatches=m,
                              num_chunks=v)
    ps.validate_programs(progs, num_stages=s, num_microbatches=m,
                         num_chunks=v)


def test_validate_rejects_chunk_count_mismatch():
    progs = ps.stage_programs("interleaved_1f1b", num_stages=2,
                              num_microbatches=4, num_chunks=2)
    with pytest.raises(ValueError, match="partition outside"):
        ps.validate_programs(progs, num_stages=2, num_microbatches=4)


def test_bubble_bound_formula():
    assert ps.bubble_bound(4, 2) == pytest.approx(4 / 5)
    assert ps.bubble_bound(8, 4) == pytest.approx(8 / 11)
    assert ps.bubble_bound(8, 4, num_chunks=2) == pytest.approx(
        8 / (8 + 3 / 2))
    assert ps.bubble_bound(4, 2) < ps.bubble_bound(4, 2, num_chunks=2)


def test_unknown_schedule_rejected():
    with pytest.raises(ValueError, match="schedule"):
        ps.stage_programs("zigzag", num_stages=2, num_microbatches=4)


def test_1f1b_efficiency_meets_bound(cluster):
    """Measured steady-state pipeline efficiency reaches 80% of the
    bubble bound m/(m+s-1)."""
    s, m = 3, 6
    cls = rt.remote(SleepStage)
    actors = [cls.options(num_cpus=1).remote(0.01, 0.02) for _ in range(s)]
    rt.get([a.ping.remote() for a in actors], timeout=120)
    pipe = CompiledPipeline(actors, num_microbatches=m, schedule="1f1b")
    try:
        assert pipe.bound == pytest.approx(m / (m + s - 1))
        effs = []
        for t in range(4):
            r = pipe.step([b"x" * 64] * m)
            if t >= 1:            # step 0 has no prior collect: wall=None
                effs.append(r["efficiency"])
        assert all(e is not None for e in effs)
        assert min(effs) >= 0.8 * pipe.bound, \
            f"efficiency {effs} below 0.8 x bound {pipe.bound}"
    finally:
        pipe.teardown()
        for a in actors:
            rt.kill(a)


def test_gpipe_less_efficient_than_1f1b_bound(cluster):
    s, m = 2, 4
    cls = rt.remote(SleepStage)
    actors = [cls.options(num_cpus=1).remote(0.005, 0.01) for _ in range(s)]
    rt.get([a.ping.remote() for a in actors], timeout=120)
    pipe = CompiledPipeline(actors, num_microbatches=m, schedule="gpipe")
    try:
        for _ in range(3):
            r = pipe.step([b"x" * 16] * m)
        assert r["efficiency"] is not None and 0 < r["efficiency"] <= 1.05
    finally:
        pipe.teardown()
        for a in actors:
            rt.kill(a)


def _trained(batches, **kw):
    args = dict(num_stages=2, num_microbatches=4, schedule="1f1b",
                tx_factory=sgd, seed=0, device="cpu")
    args.update(kw)
    tr = PipelineTrainer(_small_cfg(), **args).start()
    try:
        return [tr.step(b)["loss"] for b in batches]
    finally:
        tr.shutdown()


def test_pipeline_loss_matches_reference(cluster):
    batches = _batches(3)
    np.testing.assert_allclose(_trained(batches), _port_reference(
        batches, pp_stages=2), atol=REF_TOL)


def test_interleaved_loss_matches_reference(cluster):
    batches = _batches(3)
    got = _trained(batches, schedule="interleaved_1f1b", num_chunks=2)
    np.testing.assert_allclose(got, _port_reference(batches, pp_stages=4),
                               atol=REF_TOL)


def test_dp_replicas_match_full_batch_reference(cluster):
    batches = _batches(3)
    got = _trained(batches, num_microbatches=2, dp_replicas=2)
    np.testing.assert_allclose(got, _port_reference(batches, pp_stages=2),
                               atol=REF_TOL)


@pytest.mark.chaos
def test_stage_crash_mid_schedule_fails_fast(cluster):
    """Inject a fault into one stage's resident loop mid-schedule: POISON
    propagates through every downstream ring, the in-flight step raises a
    clean error well under 10s, teardown leaks nothing and the actors
    still serve classic RPCs."""
    s, m = 3, 4
    # Stage 1 runs 9 ops per step (4 F + 4 B + the apply barrier): nth=11
    # lets step 0 complete, then fires mid-schedule of step 1. The plan
    # reaches the workers through their runtime_env.
    fault_plane.load_plan(
        [{"site": "cgraph.loop.crash", "action": "raise",
          "match": {"stage": 1}, "nth": 11, "times": 1}])
    renv = {"env_vars": {
        config._SYSTEM_CONFIG_ENV: config.serialized_overrides()}}
    cls = rt.remote(SleepStage)
    actors = [cls.options(num_cpus=1, runtime_env=renv).remote(0.005, 0.01)
              for _ in range(s)]
    try:
        rt.get([a.ping.remote() for a in actors], timeout=120)
        pipe = CompiledPipeline(actors, num_microbatches=m,
                                schedule="1f1b")
        try:
            pipe.step([b"x" * 32] * m)
            t0 = time.monotonic()
            with pytest.raises(TaskError, match="injected fault"):
                for _ in range(4):
                    pipe.step([b"x" * 32] * m, timeout=10.0)
            assert time.monotonic() - t0 < 10.0
        finally:
            pipe.teardown()
        assert rt.get([a.ping.remote() for a in actors],
                      timeout=30) == ["pong"] * s
    finally:
        fault_plane.clear_plan()
        for a in actors:
            rt.kill(a)


def test_timeline_stage_lanes_and_microbatch_flows(cluster):
    """``test_timeline_stage_lanes_and_flow_joins``'s assertions: the
    timeline grows one lane per pipeline stage and flow arrows ("s" at F on
    partition 0, "f" at B back on partition 0) joining each microbatch.
    The JAX test stops polling once it sees as many lanes as stages, the
    driver's lane included, so a stage whose events arrive later fails it;
    this one polls until every stage's lane is there."""
    s, m = 2, 4
    cls = rt.remote(SleepStage)
    actors = [cls.options(num_cpus=1).remote(0.002, 0.004)
              for _ in range(s)]
    rt.get([a.ping.remote() for a in actors], timeout=120)
    pipe = CompiledPipeline(actors, num_microbatches=m, schedule="1f1b")
    gid = pipe._gid.hex()[:8]
    try:
        for _ in range(2):
            pipe.step([b"x" * 16] * m)
        deadline = time.time() + 30
        joined, lanes = set(), set()
        while time.time() < deadline:
            evs = core_api.timeline()
            pevs = [e for e in evs if e.get("pid") == f"pipe-{gid}"]
            lanes = {e["tid"] for e in pevs if e["ph"] == "X"}
            flows = [e for e in pevs if e.get("cat") == "pipeline_flow"]
            ids_s = {e["id"] for e in flows if e["ph"] == "s"}
            ids_f = {e["id"] for e in flows if e["ph"] == "f"}
            joined = ids_s & ids_f
            # every stage's lane, not just as many lanes as stages: the
            # driver's own lane counts among them
            if len(joined) >= m and {f"stage{i}" for i in range(s)} <= lanes:
                break
            time.sleep(0.25)
        assert {f"stage{i}" for i in range(s)} <= lanes
        assert len(joined) >= m, f"flow joins incomplete: {joined}"
        assert all(fid.count(":") == 2 for fid in joined)
    finally:
        pipe.teardown()
        for a in actors:
            rt.kill(a)


# ---------------------------------------------------------------------------
# the port's own
# ---------------------------------------------------------------------------


def test_trainer_refuses_what_the_cluster_cannot_place(cluster):
    """Two replicas of two stages at half a card each need 2 GPUs; the CPU
    cluster has none: a clear error at start, not a wait."""
    tr = PipelineTrainer(_small_cfg(), num_stages=2, num_microbatches=2,
                         dp_replicas=2, num_gpus_per_stage=0.5,
                         tx_factory=sgd, device="cpu")
    t0 = time.monotonic()
    with pytest.raises(ValueError, match="need 2 GPU"):
        tr.start()
    assert time.monotonic() - t0 < 10.0
    assert not tr._groups


def test_trainer_checks_its_arguments_as_jax_does():
    with pytest.raises(ValueError, match="num_stages >= 2"):
        PipelineTrainer(_small_cfg(), num_stages=1, device="cpu")
    with pytest.raises(ValueError, match="tied_embeddings=False"):
        PipelineTrainer(_small_cfg(tied_embeddings=True), device="cpu")
    with pytest.raises(ValueError, match="interleaved_1f1b"):
        PipelineTrainer(_small_cfg(), num_chunks=2, device="cpu")
    with pytest.raises(ValueError, match="not divisible"):
        PipelineTrainer(_small_cfg(n_layers=3), device="cpu")
