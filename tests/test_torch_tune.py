"""``ray_tpu_torch.tune`` held to ``ray_tpu.tune``.

- Counterparts of ``tests/test_tune.py`` and ``tests/test_tune_breadth.py``
  on a port head (``rt.init(num_cpus=8)``, a head in this process, as the
  JAX ``init`` starts one). Trainables and define-by-run spaces are
  module-level: the port's pickler sends them to the trial workers by
  import path, where the JAX tests define them inside each test.
- Parity: the same seed gives the JAX package's variants and every
  searcher's suggestions bitwise; every scheduler makes the JAX scheduler's
  decisions (and PBT/PB2 exploit payloads) over one recorded stream of
  reports; a whole ``Tuner`` run of a deterministic trainable with
  ``max_concurrent_trials=1`` gives the JAX run's table of configs,
  iterations and stopped trials (the JAX run on its in-process runtime).
- ``resources_per_trial={"TPU": ...}`` raises naming ``"GPU"``.

This module is imported by the port's trial workers: it imports JAX only
inside functions.
"""

import os
import shutil

import numpy as np
import pytest

import ray_tpu_torch as rt
from ray_tpu_torch import tune
from ray_tpu_torch.air import session
from ray_tpu_torch.air.config import RunConfig
from ray_tpu_torch.tune.schedulers import CONTINUE, STOP
from ray_tpu_torch.tune.search import gp_posterior


@pytest.fixture(scope="module")
def head():
    rt.shutdown()
    rt.init(num_cpus=8)
    yield rt
    rt.shutdown()


# -- module-level trainables (sent to trial workers by import path) -------

def objective_x(config):
    return {"score": -(config["x"] - 3) ** 2}


def objective_lr(config):
    return {"val": config["lr"]}


def slope_curve(config):
    for i in range(20):
        # good trials improve fast; bad ones plateau low
        session.report({"score": config["slope"] * (i + 1)})


def objective_or_boom(config):
    if config["x"] == 1:
        raise ValueError("boom")
    return {"score": config["x"]}


def report_final(config):
    session.report({"final": config["lr"] * 10})


def square_x(config):
    return {"m": config["x"] ** 2}


def x_plus_fixed(config):
    return {"m": config["x"] + config["fixed"]}


def dbr_space(trial):
    trial.suggest_float("x", 0.0, 1.0)
    return {"fixed": 3}


def conditional_space(trial):
    kind = trial.suggest_categorical("kind", ["linear", "mlp"])
    if kind == "mlp":
        trial.suggest_int("width", 8, 64)
    trial.suggest_float("lr", 1e-4, 1e-1, log=True)


def pb2_trainable(config):
    lr = config["lr"]
    for it in range(1, 9):
        session.report({"m": lr * it})
    return {"m": lr * 8}


def float_i(config):
    return {"m": float(config["i"])}


def _curve(report, config):
    """Deterministic: a loss that falls with the iteration, lowest near
    lr 0.3."""
    for it in range(1, 9):
        report({"loss": (config["lr"] - 0.3) ** 2 + 1.0 / it
                + config["wd"], "it": it})


def port_curve(config):
    _curve(session.report, config)


def jax_curve(config):
    from ray_tpu.air import session as jax_session
    _curve(jax_session.report, config)


# -- tests/test_tune.py ---------------------------------------------------

def test_grid_search_best(head):
    grid = tune.Tuner(
        objective_x,
        param_space={"x": tune.grid_search([0, 1, 2, 3, 4])},
        tune_config=tune.TuneConfig(metric="score", mode="max"),
    ).fit()
    assert len(grid) == 5
    assert grid.get_best_result().config["x"] == 3


def test_random_search_space(head):
    grid = tune.Tuner(
        objective_lr,
        param_space={"lr": tune.loguniform(1e-4, 1e-1)},
        tune_config=tune.TuneConfig(metric="val", mode="min", num_samples=6),
    ).fit()
    assert len(grid) == 6
    for r in grid:
        assert 1e-4 <= r.metrics["val"] <= 1e-1


def test_reported_iterations_and_asha(head):
    grid = tune.Tuner(
        slope_curve,
        param_space={"slope": tune.grid_search([0.1, 0.2, 1.0, 2.0])},
        tune_config=tune.TuneConfig(
            metric="score", mode="max",
            scheduler=tune.ASHAScheduler(metric="score", mode="max",
                                         grace_period=2,
                                         reduction_factor=2, max_t=20)),
    ).fit()
    assert grid.get_best_result().config["slope"] == 2.0


def test_trial_error_isolated(head):
    grid = tune.Tuner(
        objective_or_boom,
        param_space={"x": tune.grid_search([0, 1, 2])},
        tune_config=tune.TuneConfig(metric="score", mode="max"),
    ).fit()
    assert len(grid.errors) == 1
    assert "boom" in str(grid.errors[0])
    assert grid.get_best_result().config["x"] == 2


def test_tuner_over_trainer(head):
    """``Tuner(trainer)`` goes through ``BaseTrainer.as_trainable`` (a
    ``functools.partial`` of a module-level function)."""
    from ray_tpu_torch.train import DataParallelTrainer, ScalingConfig
    trainer = DataParallelTrainer(
        report_final, train_loop_config={},
        scaling_config=ScalingConfig(num_workers=1, use_gpu=False))
    grid = tune.Tuner(
        trainer,
        param_space={"lr": tune.grid_search([0.1, 0.3])},
        tune_config=tune.TuneConfig(metric="final", mode="max",
                                    max_concurrent_trials=1,
                                    resources_per_trial={"CPU": 1}),
    ).fit()
    assert grid.get_best_result().metrics["final"] == pytest.approx(3.0)


# -- tests/test_tune_breadth.py -------------------------------------------

def test_gp_posterior_interpolates():
    from ray_tpu.tune.search import gp_posterior as jax_gp
    X = np.array([[0.0], [0.5], [1.0]])
    y = np.array([0.0, 1.0, 0.0])
    q = np.array([[0.5], [0.25]])
    mu, var = gp_posterior(X, y, q, length_scale=0.3)
    assert abs(mu[0] - 1.0) < 0.1          # near-interpolation at data
    assert var[1] > var[0]                 # more uncertainty off-data
    jmu, jvar = jax_gp(X, y, q, length_scale=0.3)
    assert np.array_equal(mu, jmu) and np.array_equal(var, jvar)


def test_gp_searcher_concentrates_near_optimum():
    space = {"x": tune.uniform(0.0, 1.0), "c": tune.choice(["a", "b"])}
    s = tune.GPSearcher(space, 40, metric="m", mode="min", seed=5,
                        n_initial=8)
    for i in range(40):
        cfg = s.suggest(f"t{i}")
        s.on_trial_complete(f"t{i}", {"m": (cfg["x"] - 0.7) ** 2})
    late = [c["x"] for c, _ in s._obs[-10:]]
    assert abs(np.median(late) - 0.7) < 0.2


def test_gp_searcher_in_tuner(head, tmp_path):
    s = tune.GPSearcher({"x": tune.uniform(-1.0, 1.0)}, 8, metric="m",
                        mode="min", seed=0, n_initial=3)
    grid = tune.Tuner(
        square_x,
        tune_config=tune.TuneConfig(metric="m", mode="min", search_alg=s,
                                    max_concurrent_trials=2),
        run_config=RunConfig(storage_path=str(tmp_path), name="gp"),
    ).fit()
    assert len(grid) == 8
    assert grid.get_best_result().metrics["m"] < 1.0


def test_define_by_run_conditional_space():
    s = tune.DefineByRunSearcher(conditional_space, 30, metric="m",
                                 mode="max", seed=2)
    seen_mlp = seen_linear = 0
    for i in range(30):
        cfg = s.suggest(f"t{i}")
        assert 1e-4 <= cfg["lr"] <= 1e-1
        if cfg["kind"] == "mlp":
            assert 8 <= cfg["width"] <= 64
            seen_mlp += 1
        else:
            assert "width" not in cfg
            seen_linear += 1
        s.on_trial_complete(f"t{i}", {"m": cfg["lr"]})
    assert seen_mlp and seen_linear


def test_define_by_run_in_tuner(head, tmp_path):
    s = tune.DefineByRunSearcher(dbr_space, 6, metric="m", mode="max",
                                 seed=1)
    grid = tune.Tuner(
        x_plus_fixed,
        tune_config=tune.TuneConfig(metric="m", mode="max", search_alg=s),
        run_config=RunConfig(storage_path=str(tmp_path), name="dbr"),
    ).fit()
    assert len(grid) == 6
    assert grid.get_best_result().metrics["m"] >= 3.0


def test_hyperband_brackets_spread_grace():
    hb = tune.HyperBandScheduler(metric="m", mode="max", grace_period=1,
                                 reduction_factor=3, max_t=27)
    assert len(hb._brackets) >= 3
    graces = sorted(b.grace_period for b in hb._brackets)
    assert graces[0] == 1 and graces[-1] >= 9
    ids = [f"t{i}" for i in range(6)]
    decisions = {}
    for it in (1, 3):
        for j, t in enumerate(ids):
            decisions[t] = hb.on_result(t, it, {"m": float(j)})
    aggressive = [t for t in ids if hb._assignment[t] == 0]
    assert decisions[ids[-1]] == CONTINUE
    assert any(decisions[t] == STOP for t in aggressive) or \
        len(aggressive) < 3  # tiny cohorts may lack rung evidence


def test_hyperband_stops_at_max_t():
    hb = tune.HyperBandScheduler(metric="m", mode="max", grace_period=1,
                                 reduction_factor=3, max_t=9)
    assert hb.on_result("t0", 9, {"m": 1.0}) == STOP


def test_pb2_explores_with_gp_in_bounds():
    pb2 = tune.PB2(metric="m", mode="max", perturbation_interval=1,
                   hyperparam_bounds={"lr": (0.0, 1.0)}, seed=3)
    for i in range(6):
        pb2.record_state(f"t{i}", {"lr": i / 5.0}, None)
        pb2.on_result(f"t{i}", 1, {"m": i / 5.0})
    decision = pb2.on_result("t0", 1, {"m": 0.0})
    assert decision == CONTINUE
    payload = pb2.pop_exploit("t0")
    assert payload is not None
    assert 0.0 <= payload["config"]["lr"] <= 1.0


def test_pb2_in_tuner_improves(head, tmp_path):
    pb2 = tune.PB2(metric="m", mode="max", perturbation_interval=2,
                   hyperparam_bounds={"lr": (0.1, 1.0)}, seed=0)
    grid = tune.Tuner(
        pb2_trainable,
        param_space={"lr": tune.uniform(0.1, 1.0)},
        tune_config=tune.TuneConfig(metric="m", mode="max", num_samples=4,
                                    scheduler=pb2),
        run_config=RunConfig(storage_path=str(tmp_path), name="pb2"),
    ).fit()
    assert len(grid) == 4
    assert grid.get_best_result().metrics["m"] > 0.8


def test_mock_uri_storage_sync_and_restore(head, tmp_path):
    """An experiment with a mock:// storage_path mirrors to the mock store
    and restores from the URI in a fresh Tuner (a driver on a new
    machine)."""
    from ray_tpu_torch.tune.syncer import _MockBackend, local_cache_dir
    _MockBackend.store.clear()
    uri_root = "mock://bucket/experiments"
    grid = tune.Tuner(
        float_i,
        param_space={"i": tune.grid_search([0, 1, 2])},
        tune_config=tune.TuneConfig(metric="m", mode="max"),
        run_config=RunConfig(storage_path=uri_root, name="cloudy"),
    ).fit()
    assert len(grid) == 3
    uri = f"{uri_root}/cloudy"
    assert _MockBackend.store.get(uri), "nothing synced up"
    assert any(k.endswith("tuner.pkl") for k in _MockBackend.store[uri])
    shutil.rmtree(local_cache_dir(uri), ignore_errors=True)
    assert tune.Tuner.can_restore(uri)
    grid2 = tune.Tuner.restore(uri, trainable=float_i).fit()
    assert len(grid2) == 3   # all trials loaded from storage, none re-run
    assert grid2.get_best_result().metrics["m"] == 2.0
    _MockBackend.store.clear()


def test_fsspec_file_scheme_roundtrip(head, tmp_path):
    """file:// URIs exercise the fsspec backend."""
    uri_root = f"file://{tmp_path}/store"
    grid = tune.Tuner(
        float_i,
        param_space={"i": tune.grid_search([0, 1])},
        tune_config=tune.TuneConfig(metric="m", mode="max"),
        run_config=RunConfig(storage_path=uri_root, name="fss"),
    ).fit()
    assert len(grid) == 2
    assert os.path.exists(f"{tmp_path}/store/fss/tuner.pkl")
    assert tune.Tuner.can_restore(f"{uri_root}/fss")


# -- the port against the JAX package ---------------------------------------

def _spaces(pkg):
    """Search spaces of every domain kind, nested and gridded, built from
    one package's ``tune``."""
    return [
        {"lr": pkg.loguniform(1e-4, 1e-1), "opt": pkg.choice(["a", "b", "c"]),
         "n": pkg.randint(1, 9), "noise": pkg.randn(0.5, 2.0),
         "const": 7},
        {"x": pkg.grid_search([1, 2, 3]), "y": pkg.uniform(-1.0, 1.0),
         "inner": {"z": pkg.choice([0.1, 0.2]), "w": pkg.uniform(0.0, 5.0)}},
    ]


@pytest.mark.parametrize("space", [0, 1])
@pytest.mark.parametrize("seed", [0, 7])
def test_generate_variants_match_jax(space, seed):
    from ray_tpu import tune as jtune
    from ray_tpu.tune.search_space import generate_variants as jgen

    from ray_tpu_torch.tune.search_space import generate_variants
    got = generate_variants(_spaces(tune)[space], num_samples=4, seed=seed)
    want = jgen(_spaces(jtune)[space], num_samples=4, seed=seed)
    assert got == want and len(got) == (4 if space == 0 else 12)


def _searchers(pkg):
    space = {"lr": pkg.loguniform(1e-4, 1e-1), "opt": pkg.choice(["a", "b"]),
             "n": pkg.randint(1, 9), "u": pkg.uniform(0.0, 1.0), "c": 3}
    return {
        "basic": lambda: pkg.BasicVariantSearcher(
            {**space, "g": pkg.grid_search([0, 1])}, num_samples=6, seed=4),
        "tpe": lambda: pkg.TPESearcher(space, 24, metric="m", mode="min",
                                       seed=4, n_initial=6),
        "gp": lambda: pkg.GPSearcher(space, 20, metric="m", mode="min",
                                     seed=4, n_initial=5),
        "define_by_run": lambda: pkg.DefineByRunSearcher(
            conditional_space, 24, metric="m", mode="max", seed=4,
            n_initial=6),
    }


def _drive_searcher(s):
    out = []
    for i in range(40):
        cfg = s.suggest(f"t{i:03d}")
        if cfg is None:
            break
        out.append(cfg)
        score = sum(float(v) for v in cfg.values()
                    if isinstance(v, (int, float)))
        s.on_trial_complete(f"t{i:03d}", {"m": (score - 1.3) ** 2})
    return out


@pytest.mark.parametrize("name", ["basic", "tpe", "gp", "define_by_run"])
def test_searchers_suggest_the_jax_configs(name):
    from ray_tpu import tune as jtune
    got = _drive_searcher(_searchers(tune)[name]())
    want = _drive_searcher(_searchers(jtune)[name]())
    assert len(got) > 10
    assert got == want
    assert [sorted(c) for c in got] == [sorted(c) for c in want]


def _report_stream():
    """8 trials x 12 iterations, round-robin, seeded."""
    rng = np.random.default_rng(21)
    base = rng.uniform(0.0, 1.0, 8)
    return [(f"t{t}", it, {"m": float(base[t] * it + rng.normal(0, 0.1))})
            for it in range(1, 13) for t in range(8)]


def _schedulers(pkg):
    return {
        "fifo": lambda: pkg.FIFOScheduler(),
        "asha": lambda: pkg.AsyncHyperBandScheduler(
            metric="m", mode="max", grace_period=1, reduction_factor=2,
            max_t=12),
        "median": lambda: pkg.MedianStoppingRule(
            metric="m", mode="min", grace_period=2, min_samples_required=3),
        "hyperband": lambda: pkg.HyperBandScheduler(
            metric="m", mode="max", grace_period=1, reduction_factor=3,
            max_t=9),
        "pbt": lambda: pkg.PopulationBasedTraining(
            metric="m", mode="max", perturbation_interval=3,
            hyperparam_mutations={"opt": ["a", "b", "c"]},
            quantile_fraction=0.25, seed=4),
        "pb2": lambda: pkg.PB2(
            metric="m", mode="max", perturbation_interval=3,
            hyperparam_bounds={"lr": (0.0, 1.0), "n": (1, 9)},
            hyperparam_mutations={"opt": ["a", "b", "c"]}, seed=4),
    }


def _decide(sched, stream):
    """Feed the stream as the trial board does (PBT state first); a stopped
    trial reports no more. Returns every decision and exploit payload."""
    out, stopped = [], set()
    for trial, it, metrics in stream:
        if trial in stopped:
            continue
        if hasattr(sched, "record_state"):
            k = int(trial[1:])
            sched.record_state(trial, {"lr": k / 8.0, "n": k + 1,
                                       "opt": "abc"[k % 3]}, f"ck-{trial}")
        decision = sched.on_result(trial, it, metrics)
        exploit = sched.pop_exploit(trial) \
            if hasattr(sched, "pop_exploit") else None
        out.append((trial, it, decision, exploit))
        if decision == STOP:
            stopped.add(trial)
            sched.on_trial_complete(trial)
    return out


@pytest.mark.parametrize("name", ["fifo", "asha", "median", "hyperband",
                                  "pbt", "pb2"])
def test_schedulers_decide_as_the_jax_schedulers(name):
    from ray_tpu import tune as jtune
    stream = _report_stream()
    got = _decide(_schedulers(tune)[name](), stream)
    want = _decide(_schedulers(jtune)[name](), stream)
    assert got == want
    if name in ("asha", "median", "hyperband"):
        assert any(d == STOP for _, _, d, _ in got)
    if name in ("pbt", "pb2"):
        assert any(e is not None for *_, e in got)


def _table(grid):
    """(trial id, config, iterations, stopped early, error) per trial."""
    rows = []
    for r in grid:
        it = r.metrics.get("it")
        rows.append((os.path.basename(r.path), r.config, it, it < 8,
                     r.error is not None))
    return sorted(rows, key=lambda row: row[0])


def _tuner_run(pkg, trainable, storage, searcher):
    search_alg = None
    if searcher == "tpe":
        search_alg = pkg.TPESearcher(
            {"lr": pkg.uniform(0.0, 1.0), "wd": pkg.choice([0.0, 0.1])}, 8,
            metric="loss", mode="min", seed=5, n_initial=4)
    cfg = pkg.TuneConfig(
        metric="loss", mode="min", num_samples=8, seed=5,
        max_concurrent_trials=1, search_alg=search_alg,
        scheduler=pkg.ASHAScheduler(metric="loss", mode="min",
                                    grace_period=1, reduction_factor=2,
                                    max_t=8))
    return pkg.Tuner(
        trainable,
        param_space={"lr": pkg.uniform(0.0, 1.0),
                     "wd": pkg.choice([0.0, 0.1])},
        tune_config=cfg,
        run_config=pkg.tuner.RunConfig(storage_path=str(storage),
                                       name="table")).fit()


@pytest.mark.parametrize("searcher", ["variants", "tpe"])
def test_tuner_run_gives_the_jax_table(head, tmp_path, searcher):
    """One trial at a time, ASHA over a deterministic trainable: the port on
    its head and the JAX package on its in-process runtime run the same
    trials, each the same iterations, the same ones stopped early."""
    import ray_tpu
    from ray_tpu import tune as jtune
    ray_tpu.shutdown()
    ray_tpu.init(local_mode=True, num_cpus=4)
    try:
        want = _table(_tuner_run(jtune, jax_curve, tmp_path / "jax",
                                 searcher))
    finally:
        ray_tpu.shutdown()
    got = _table(_tuner_run(tune, port_curve, tmp_path / "port", searcher))
    assert got == want
    assert len(got) == 8
    assert any(row[3] for row in got) and not all(row[3] for row in got)


def test_tpu_resources_are_refused_naming_gpu(head, tmp_path):
    with pytest.raises(ValueError, match="'GPU'"):
        tune.Tuner(
            float_i, param_space={"i": tune.grid_search([0])},
            tune_config=tune.TuneConfig(
                metric="m", resources_per_trial={"CPU": 1, "TPU": 1}),
            run_config=RunConfig(storage_path=str(tmp_path), name="tpu"),
        ).fit()
    assert not os.path.exists(tmp_path / "tpu")


def test_nested_trainable_raises_type_error_at_fit(head, tmp_path):
    """The port's pickler stores the trainable by import path: a lambda is
    refused at ``fit()``, before any trial runs."""
    with pytest.raises(TypeError, match="module level"):
        tune.Tuner(
            lambda cfg: {"m": 1.0},
            param_space={"i": tune.grid_search([0])},
            run_config=RunConfig(storage_path=str(tmp_path), name="lam"),
        ).fit()
