"""Port parity: offline RL (the JSON experience IO, ``collect_experiences``,
BC, MARWIL and CQL), ray_tpu_torch.rl against ray_tpu.rl on the CPU.

- The IO is a copy of the JAX package's: ``collect_experiences`` writes
  the same shard bytes, and shards written by either stack's
  ``JsonWriter`` read back the same columns through the other's
  ``JsonReader`` (sharded at ``max_rows_per_file``).
- Learners: from the same weights (the JAX init moved by a seeded draw),
  ``train()`` of 4 updates on both stacks samples the same rows (each
  reader's numpy ``default_rng(seed)``); every stat within 1e-5 relative
  (MARWIL's weighted ones 5e-5, justified at the check) and the
  parameters (and CQL's polyak target) within 2e-6 absolute, at f32 (the
  PPO learner's 8-step bound). MARWIL with beta 0 weights every row by
  exactly 1. The greedy evaluation of the same weights scores the same.
- The JAX package's gates on the CPU (``tests/test_rl_sac_offline.py``,
  ``tests/test_rl_ddpg_marwil.py:113``): a dataset of 4,000 steps of the
  pole-angle controller, then BC and MARWIL (150 updates an iteration, lr
  3e-3, 4 iterations) and CQL (200 updates, lr 5e-4, alpha 1, 5
  iterations) each evaluate to a mean reward >= 60, with CQL's
  ``cql_loss >= 0``.
"""

import os

import jax
import numpy as np
import pytest
import torch

from ray_tpu.rl import offline as joffline
from ray_tpu.rl.algorithms import CQLConfig as JCQLConfig
from ray_tpu_torch.rl import SampleBatch
from ray_tpu_torch.rl import offline as toffline
from ray_tpu_torch.rl import sample_batch as sb
from ray_tpu_torch.rl.algorithms import CQLConfig


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for these small ops (faster alone, and the suite
    runs in parallel processes: a thread a core in each oversubscribes the
    cores, and a CPU gate then runs 20x slower or more)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _controller(obs):
    """The JAX tests' "expert": a pole-angle controller (~100+ reward)."""
    return (obs[:, 2] + 0.5 * obs[:, 3] > 0).astype(int)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("expert"))
    toffline.collect_experiences("CartPole-v1", path, num_steps=4000, seed=0,
                                 policy_fn=_controller)
    return path


def test_collect_experiences_writes_the_jax_shards(tmp_path, dataset):
    jpath = str(tmp_path / "jax")
    joffline.collect_experiences("CartPole-v1", jpath, num_steps=4000,
                                 seed=0, policy_fn=_controller)
    names = sorted(os.listdir(jpath))
    assert names == sorted(os.listdir(dataset)) == ["experiences-00000.json"]
    for name in names:
        with open(os.path.join(jpath, name), "rb") as a, \
                open(os.path.join(dataset, name), "rb") as b:
            assert a.read() == b.read()
    # a random policy (discrete) draws the same actions in both stacks
    for mod, sub in ((joffline, "jr"), (toffline, "tr")):
        mod.collect_experiences("CartPole-v1", str(tmp_path / sub),
                                num_steps=64, seed=3)
    for name in os.listdir(tmp_path / "jr"):
        assert (tmp_path / "jr" / name).read_bytes() == \
            (tmp_path / "tr" / name).read_bytes()


def _batch(n=100):
    rng = np.random.default_rng(1)
    return SampleBatch({
        sb.OBS: rng.normal(size=(n, 4)).astype(np.float32),
        sb.ACTIONS: rng.integers(0, 2, n),
        sb.REWARDS: np.arange(n, dtype=np.float32),
        sb.NEXT_OBS: rng.normal(size=(n, 4)).astype(np.float32),
        sb.DONES: np.zeros(n),
    })


@pytest.mark.parametrize("direction", ["port_writes", "jax_writes"])
def test_json_shards_cross_the_stacks(tmp_path, direction):
    writer_mod, reader_mod = ((toffline, joffline) if direction ==
                              "port_writes" else (joffline, toffline))
    w = writer_mod.JsonWriter(str(tmp_path), max_rows_per_file=40)
    batch = _batch()
    w.write(batch)
    w.close()
    assert sorted(os.listdir(tmp_path)) == [
        f"experiences-0000{i}.json" for i in range(3)]    # 40 + 40 + 20
    got = reader_mod.JsonReader(str(tmp_path), shuffle=False).read_all()
    same = writer_mod.JsonReader(str(tmp_path), shuffle=False).read_all()
    for k in batch:
        np.testing.assert_allclose(got[k], batch[k], rtol=1e-7, err_msg=k)
        assert got[k].dtype == same[k].dtype
        np.testing.assert_array_equal(got[k], same[k])
    # seeded sampling and shuffled iteration draw the same rows
    rt, rj = (toffline.JsonReader(str(tmp_path), seed=5),
              joffline.JsonReader(str(tmp_path), seed=5))
    for a, b in ((rt.sample(32), rj.sample(32)),
                 *zip(rt.iter_batches(30), rj.iter_batches(30))):
        np.testing.assert_array_equal(a[sb.REWARDS], b[sb.REWARDS])


def _moved(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: np.asarray(a) + 0.1 * rng.standard_normal(
        np.shape(a)).astype(np.float32), jax.device_get(tree))


def _assert_stats(got, want, rtol):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], float(want[k]), rtol=rtol,
                                   atol=1e-7, err_msg=k)


def _max_error(got, want, leaves):
    got, want = jax.tree.leaves(got), jax.tree.leaves(jax.device_get(want))
    assert len(got) == len(want) == leaves
    return max(float(np.max(np.abs(np.asarray(a) - np.asarray(b))))
               for a, b in zip(got, want))


LEARNERS = {
    "bc": (joffline.BCConfig, toffline.BCConfig, {}),
    "marwil": (joffline.MARWILConfig, toffline.MARWILConfig,
               dict(beta=1.0, vf_coeff=0.5, gamma=0.95)),
    "marwil_beta0": (joffline.MARWILConfig, toffline.MARWILConfig,
                     dict(beta=0.0)),
    "cql": (JCQLConfig, CQLConfig, dict(alpha=0.7, tau=0.05)),
}


def _build(config_cls, dataset, extra, **device):
    config = (config_cls().offline_data(input_path=dataset)
              .training(updates_per_iter=4, train_batch_size=64, lr=3e-3,
                        model_hiddens=(16, 16), seed=2, **extra))
    if device:
        config = config.resources(**device)
    return config.build()


@pytest.mark.parametrize("name", sorted(LEARNERS))
def test_offline_learners_match_jax(name, dataset):
    jcls, tcls, extra = LEARNERS[name]
    jalgo = _build(jcls, dataset, extra)
    talgo = _build(tcls, dataset, extra, device="cpu")
    jalgo.params = _moved(jalgo.params, 1)
    if name == "cql":
        jalgo.target = _moved(jalgo.target, 2)
        talgo.set_state({"params": jalgo.params, "target": jalgo.target})
    else:
        talgo.set_weights(jalgo.params)
    leaves = 6 if name == "cql" else 12
    for _ in range(2):
        want, got = jalgo.train(), talgo.train()
        # MARWIL's weights exp(beta * A / std(A)) reach e^10: an f32 error
        # of a few ulps in an exponent near 10 is ~1e-5 of the weight
        _assert_stats(got, want, 5e-5 if name == "marwil" else 1e-5)
        assert _max_error(talgo.get_weights(), jalgo.params, leaves) <= 2e-6
    if name == "cql":
        assert _max_error(talgo.get_state()["target"], jalgo.target,
                          6) <= 2e-6
    if name == "marwil_beta0":
        assert got["mean_weight"] == 1.0
    assert talgo.evaluate(num_episodes=4) == jalgo.evaluate(num_episodes=4)


def test_bc_config_takes_the_device():
    c = toffline.BCConfig()
    assert c.device is None
    assert c.resources(device="cpu").device == "cpu"
    assert c.resources().device == "cpu"          # nothing given: unchanged
    want = set(vars(joffline.MARWILConfig())) | {"device"}
    assert set(vars(toffline.MARWILConfig())) == want


GATES = {
    "bc": (toffline.BCConfig, dict(updates_per_iter=150, lr=3e-3), 4),
    "marwil": (toffline.MARWILConfig,
               dict(updates_per_iter=150, lr=3e-3, beta=1.0), 4),
    "cql": (CQLConfig, dict(updates_per_iter=200, lr=5e-4, alpha=1.0), 5),
}


@pytest.mark.parametrize("name", sorted(GATES))
def test_offline_gates(name, dataset):
    config_cls, training, iters = GATES[name]
    algo = (config_cls().offline_data(input_path=dataset)
            .training(**training).resources(device="cpu")).build()
    for _ in range(iters):
        stats = algo.train()
    assert np.isfinite(stats["total_loss"])
    if name == "marwil":
        assert stats["mean_weight"] > 0 and stats["vf_loss"] < 1e4
    if name == "cql":
        assert stats["cql_loss"] >= 0    # logsumexp >= Q(a_data) pointwise
    ev = algo.evaluate(num_episodes=10)
    assert ev["episode_reward_mean"] >= 60, f"{name} policy too weak: {ev}"
