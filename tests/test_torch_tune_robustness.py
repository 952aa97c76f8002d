"""The port's Tuner under faults, held to ``tests/test_tune_robustness.py``
and ``tests/test_experiment_restore.py::test_tuner_restore_after_driver_death``.

- Trial workers that die (``os._exit``) are relaunched under
  ``FailureConfig.max_failures`` after the task-level retries, or recorded
  as failed trials; ``trial_timeout_s`` force-cancels a wedged trial.
- A pickled ``TPESearcher`` continues the same suggestion stream, and
  ``register_suggestion`` folds a journal-recorded config in.
- ``Tuner.restore`` uses the search-state snapshot, and restores an
  experiment whose driver was SIGKILLed, re-running only unfinished trials.

Each test gets a fresh port head (``rt.init(num_cpus=4)``), as the JAX
tests get a fresh ``ray_tpu.init(num_cpus=4)``. Trainables are
module-level and take their files from the config; this module is
imported by the trial workers, so it imports JAX only inside functions.
"""

import os
import pickle
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import pytest

import ray_tpu_torch as rt
from ray_tpu_torch import tune
from ray_tpu_torch.air.config import FailureConfig, RunConfig
from ray_tpu_torch.cluster.cluster_utils import Cluster
from ray_tpu_torch.tune.search import BasicVariantSearcher, TPESearcher
from ray_tpu_torch.tune.search_space import choice, uniform

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture
def rt4():
    rt.shutdown()
    rt.init(num_cpus=4)
    yield rt
    rt.shutdown()


def dies_four_times(config):
    if config["i"] == 1:
        with open(config["marker"], "a") as f:
            f.write("x")
        # Die hard through the original + 3 task-level retries; the 5th
        # attempt (trial-level relaunch) succeeds.
        if os.path.getsize(config["marker"]) <= 4:
            os._exit(1)
    return {"score": float(config["i"])}


def always_dies(config):
    if config["i"] == 1:
        os._exit(1)
    return {"score": float(config["i"])}


def wedges(config):
    if config["i"] == 1:
        time.sleep(600)
    return {"score": float(config["i"])}


def counted(config):
    with open(config["ran"], "a") as f:
        f.write("x")
    return {"m": (config["lr"] - 0.3) ** 2}


def fast_trainable(config):
    i = config["i"]
    with open(os.path.join(config["dir"], f"ran-{i}"), "a") as f:
        f.write("x")
    return {"score": float(i)}


def test_trial_worker_death_retried_under_failure_budget(rt4, tmp_path):
    marker = tmp_path / "attempts"
    grid = tune.Tuner(
        dies_four_times,
        param_space={"i": tune.grid_search([0, 1, 2]),
                     "marker": str(marker)},
        tune_config=tune.TuneConfig(metric="score", mode="max"),
        run_config=RunConfig(storage_path=str(tmp_path), name="fb",
                             failure_config=FailureConfig(max_failures=1)),
    ).fit()
    assert len(grid) == 3
    assert grid.get_best_result().metrics["score"] == 2.0
    scores = sorted(r.metrics.get("score") for r in grid if r.error is None)
    assert scores == [0.0, 1.0, 2.0]
    assert open(marker).read().count("x") == 5


def test_trial_failure_budget_exhausted_records_error(rt4, tmp_path):
    grid = tune.Tuner(
        always_dies,
        param_space={"i": tune.grid_search([0, 1, 2])},
        tune_config=tune.TuneConfig(metric="score", mode="max"),
        run_config=RunConfig(storage_path=str(tmp_path), name="fb0",
                             failure_config=FailureConfig(max_failures=0)),
    ).fit()
    assert len(grid) == 3
    assert len(grid.errors) == 1
    assert "trial worker died" in str(grid.errors[0])
    assert grid.get_best_result().metrics["score"] == 2.0


def test_trial_timeout_cancels_wedged_trial(rt4, tmp_path):
    t0 = time.monotonic()
    grid = tune.Tuner(
        wedges,
        param_space={"i": tune.grid_search([0, 1])},
        tune_config=tune.TuneConfig(metric="score", mode="max",
                                    trial_timeout_s=5.0),
        run_config=RunConfig(storage_path=str(tmp_path), name="ttl",
                             failure_config=FailureConfig(max_failures=0)),
    ).fit()
    assert time.monotonic() - t0 < 120
    assert len(grid) == 2
    assert len(grid.errors) == 1
    assert "trial_timeout_s" in repr(grid.errors[0])
    assert grid.get_best_result().metrics["score"] == 0.0


SPACE = {"lr": uniform(0.0, 1.0), "opt": choice(["a", "b", "c"])}


def _drive(searcher, n, start=0):
    out = []
    for i in range(start, start + n):
        cfg = searcher.suggest(f"t{i:03d}")
        out.append(cfg)
        searcher.on_trial_complete(
            f"t{i:03d}", {"m": (cfg["lr"] - 0.3) ** 2})
    return out


def test_tpe_snapshot_resumes_same_stream():
    """A pickled-and-restored TPESearcher continues the uninterrupted one's
    stream, which is the JAX searcher's for the same seed."""
    from ray_tpu.tune.search import TPESearcher as JaxTPE
    from ray_tpu.tune.search_space import choice as jchoice
    from ray_tpu.tune.search_space import uniform as juniform
    s_cont = TPESearcher(SPACE, 30, metric="m", mode="min", seed=7)
    s_snap = TPESearcher(SPACE, 30, metric="m", mode="min", seed=7)
    a = _drive(s_cont, 10)
    b = _drive(s_snap, 10)
    assert a == b
    restored = pickle.loads(pickle.dumps(s_snap))
    rest = _drive(restored, 10, start=10)
    assert _drive(s_cont, 10, start=10) == rest
    jax = JaxTPE({"lr": juniform(0.0, 1.0), "opt": jchoice(["a", "b", "c"])},
                 30, metric="m", mode="min", seed=7)
    assert _drive(jax, 20) == a + rest


def test_register_suggestion_reconciles_journal_ahead_of_snapshot():
    s = TPESearcher(SPACE, 10, metric="m", mode="min", seed=3)
    cfg = {"lr": 0.123, "opt": "b"}
    s.register_suggestion("t000", cfg)
    assert s._suggested == 1
    s.on_trial_complete("t000", {"m": 0.5})
    assert s._obs and s._obs[0][0] == cfg

    bv = BasicVariantSearcher({"x": choice([1, 2])}, num_samples=2, seed=0)
    first = bv.suggest("t0")
    bv2 = BasicVariantSearcher({"x": choice([1, 2])}, num_samples=2, seed=0)
    bv2.register_suggestion("t0", first)
    assert bv2.suggest("t1") == bv.suggest("t1")


def test_tuner_restore_uses_search_state_snapshot(rt4, tmp_path):
    ran = tmp_path / "count"
    searcher = TPESearcher({**SPACE, "ran": str(ran)}, 6, metric="m",
                           mode="min", seed=11)
    tuner = tune.Tuner(
        counted,
        tune_config=tune.TuneConfig(metric="m", mode="min",
                                    search_alg=searcher,
                                    max_concurrent_trials=1),
        run_config=RunConfig(storage_path=str(tmp_path), name="tpe"))
    tuner.fit()
    assert open(ran).read().count("x") == 6
    exp_dir = str(tmp_path / "tpe")
    assert os.path.exists(os.path.join(exp_dir, "search_state.pkl"))
    restored = tune.Tuner.restore(exp_dir, trainable=counted)
    grid = restored.fit()
    assert len(grid) == 6
    assert open(ran).read().count("x") == 6  # no re-runs
    snap = pickle.loads(open(os.path.join(exp_dir, "search_state.pkl"),
                             "rb").read())
    assert len(snap["searcher"]._obs) == 6


_DRIVER = """
import os
import signal
import time

import ray_tpu_torch as rt
from ray_tpu_torch import tune
from ray_tpu_torch.air.config import RunConfig


def trainable(config):
    i = config["i"]
    with open(os.path.join(config["dir"], f"ran-{i}"), "a") as f:
        f.write("x")
    if i >= 2:
        time.sleep(600)   # unfinished when the driver dies
    return {"score": float(i)}


if __name__ == "__main__":
    signal.alarm(300)   # never outlive the test that spawned it
    rt.init(num_cpus=4)
    tune.Tuner(
        trainable,
        param_space={"i": tune.grid_search([0, 1, 2, 3]),
                     "dir": os.environ["TUNE_DIR"]},
        tune_config=tune.TuneConfig(metric="score", mode="max",
                                    max_concurrent_trials=2),
        run_config=RunConfig(storage_path=os.environ["TUNE_DIR"],
                             name="exp"),
    ).fit()
"""


def test_tuner_restore_after_driver_death(tmp_path):
    """A driver (a port head in its process) SIGKILLed after two trials
    completed durably; a fresh driver on a port ``Cluster`` restores the
    experiment: completed trials ran exactly once, unfinished ones again."""
    exp_dir = tmp_path / "exp"
    script = tmp_path / "driver.py"
    script.write_text(textwrap.dedent(_DRIVER))
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    env["TUNE_DIR"] = str(tmp_path)
    with open(tmp_path / "driver.out", "wb") as log:
        driver = subprocess.Popen([sys.executable, str(script)], env=env,
                                  stdout=log, stderr=subprocess.STDOUT)
    try:
        deadline = time.time() + 120

        def done_count():
            return sum(os.path.exists(exp_dir / f"trial_{i:05d}"
                                      / "result.pkl") for i in range(4))

        while done_count() < 2 and time.time() < deadline:
            assert driver.poll() is None, \
                f"driver died early:\n{open(tmp_path / 'driver.out').read()}"
            time.sleep(0.25)
        assert done_count() >= 2
    finally:
        driver.kill()
        driver.wait()
    time.sleep(1.0)

    c = Cluster(initialize_head=True,
                head_node_args={"num_cpus": 4, "num_gpus": 0})
    rt.shutdown()
    rt.init(address=c.address)
    try:
        assert tune.Tuner.can_restore(str(exp_dir))
        tuner = tune.Tuner.restore(str(exp_dir), trainable=fast_trainable)
        grid = tuner.fit()
        assert len(grid) == 4
        assert grid.get_best_result().metrics["score"] == 3.0
        assert open(tmp_path / "ran-0").read() == "x"
        assert open(tmp_path / "ran-1").read() == "x"
        assert open(tmp_path / "ran-2").read().count("x") >= 2
        assert open(tmp_path / "ran-3").read().count("x") >= 2
    finally:
        rt.shutdown()
        c.shutdown()
