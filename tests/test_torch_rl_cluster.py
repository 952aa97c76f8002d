"""The port's RL drivers on its cluster runtime, held to the JAX package's
cluster tests and to its learners, on the CPU.

The drivers run on a module-scoped port ``Cluster`` (8 CPUs) connected with
``ray_tpu_torch.init(address=...)``: the rollout workers, the DQN/TD3
collectors and the ES workers are worker processes that sample on the CPU
with one torch thread (``algorithm.sampler_placement``), and a remote
learner is a worker process too. Every driver runs with
``.resources(device="cpu")``.

- Counterparts of the JAX drivers' cluster tests, each holding what the JAX
  test asserts: ``tests/test_rl.py:75`` (PPO's gate, >= 120 within 25
  iterations), ``:98`` (save/restore), ``:116`` (DQN), ``:129`` (IMPALA);
  ``tests/test_rl_appo_vtrace.py:57`` (a structured batch's attributes
  through the store) and ``:77`` (APPO's gate and checkpoint);
  ``tests/test_rl_td3_models.py:45`` (TD3's gate and checkpoint), ``:102``
  (the CNN smoke) and ``:163`` (2-dim continuous PPO);
  ``tests/test_rl_ddpg_marwil.py:90`` (A2C); ``tests/test_rl_breadth.py:64``
  (ES improves CartPole).
- Parity with the JAX package: the remote learner's update in a worker
  process against the JAX ``LearnerGroup``'s (stats 1e-5 relative, weights
  2e-6, as in ``tests/test_torch_rl_algorithm.py``), and ES's
  ``training_step`` on the cluster against the JAX ES in local mode (its
  result does not depend on the runtime; tolerance of
  ``tests/test_torch_rl_es_bandits.py``). A ``RolloutWorker`` in a worker
  process returns the in-process worker's ``SampleBatch`` bitwise from the
  same seed and the same JAX weights (the worker takes them through
  ``rl_params_from_jax``).
- The refusals: a lambda env factory raises ``TypeError`` at ``build()``,
  and a remote learner on the card without ``learner_num_gpus`` raises
  ``ValueError``, each before any actor exists.
- After every test no actor of the cluster is ALIVE, and ``stop()`` with a
  sample in flight (APPO, IMPALA) fails the in-flight refs as dead-actor
  errors and leaves no worker process of its actors.

Worker processes import this module by name (its env classes and factories
ship by import path), so it imports no JAX at the top: the JAX package is
imported inside the tests that use it.
"""

import os
import time

import numpy as np
import pytest
import torch

import ray_tpu_torch as rt
from ray_tpu_torch.cluster.cluster_utils import Cluster
from ray_tpu_torch.core import api as core_api
from ray_tpu_torch.models.convert import rl_params_to_numpy
from ray_tpu_torch.rl import RolloutWorker, SampleBatch, make_module
from ray_tpu_torch.rl import algorithm as talgorithm
from ray_tpu_torch.rl import learner as tlearner
from ray_tpu_torch.rl import sample_batch as sb
from ray_tpu_torch.rl.algorithms import (A2C, A2CConfig, APPOConfig,
                                         DQNConfig, ESConfig, ImpalaConfig,
                                         PPOConfig, TD3Config)
from ray_tpu_torch.rl.env import CartPoleVectorEnv, VectorEnv


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread in the driver (the suite runs in parallel
    processes: a thread a core in each oversubscribes the cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


_CLUSTER = []


@pytest.fixture(scope="module")
def cluster():
    rt.shutdown()    # whatever runtime an earlier module left in this worker
    c = Cluster(initialize_head=True, head_node_args={"num_cpus": 8})
    rt.init(address=c.address)
    _CLUSTER.append(c)
    yield c
    _CLUSTER.remove(c)
    rt.shutdown()
    c.shutdown()


def _alive(c, ids=None):
    """Hex ids of the cluster's ALIVE actors (of ``ids`` when given)."""
    return sorted(a["actor_id"] for a in c.conductor.rpc_list_actors()
                  if a["state"] == "ALIVE"
                  and (ids is None or a["actor_id"] in ids))


def _settled(probe, timeout=15.0):
    """``probe()`` once it is falsy, or its last value at the deadline."""
    deadline = time.monotonic() + timeout
    got = probe()
    while got and time.monotonic() < deadline:
        time.sleep(0.1)
        got = probe()
    return got


@pytest.fixture(autouse=True)
def _no_live_actor():
    """After each test no actor of the module's cluster is ALIVE: every
    driver's stop() ends its workers, collectors and learner."""
    yield
    if not _CLUSTER:
        return
    c = _CLUSTER[0]
    left = _settled(lambda: _alive(c))
    names = {a["actor_id"]: a["class_name"]
             for a in c.conductor.rpc_list_actors()}
    for hex_id in left:     # so that one leak does not fail the next test
        c.conductor.rpc_kill_actor(bytes.fromhex(hex_id))
    assert not left, f"actors left ALIVE: {[names[i] for i in left]}"


def _worker_pids(c):
    return {p for n in c.nodes for p in n.rpc_debug_state()["worker_pids"]}


def _cartpole(config, **rollouts):
    return (config.environment("CartPole-v1").rollouts(**rollouts)
            .resources(device="cpu"))


def _best(algo, iterations, gate):
    """Train until the best mean reward reaches ``gate`` -> (best, the
    rewards seen)."""
    best, rewards = -1e9, []
    for _ in range(iterations):
        r = algo.train()["episode_reward_mean"]
        rewards.append(round(r, 1))
        if not np.isnan(r):
            best = max(best, r)
        if best >= gate:
            break
    return best, rewards


def _bitwise(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb) > 0
    for x, y in zip(la, lb):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape
        assert x.tobytes() == y.tobytes()


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


# ---------------------------------------------------------------------------
# module-level envs (they reach the workers by import path)
# ---------------------------------------------------------------------------

class ImageToyEnv(VectorEnv):
    """CartPole's state painted into an 8x8 image (the CNN plumbing smoke
    of tests/test_rl_td3_models.py:102)."""

    def __init__(self, num_envs=4, seed=0):
        self.inner = CartPoleVectorEnv(num_envs=num_envs, seed=seed)
        self.num_envs = num_envs
        self.observation_dim = 64
        self.num_actions = 2

    def _paint(self, obs4):
        img = np.zeros((obs4.shape[0], 8, 8), np.float32)
        img[:, 0, :4] = obs4
        img[:, 1:, :] = obs4[:, 0:1, None]
        return img.reshape(obs4.shape[0], -1)

    def vector_reset(self, seed=None):
        return self._paint(self.inner.vector_reset(seed=seed))

    def vector_step(self, actions):
        obs, r, d, info = self.inner.vector_step(actions)
        self.completed_returns = self.inner.completed_returns
        return self._paint(obs), r, d, info


class TwoDimEnv(VectorEnv):
    """A 2-dim Box env (tests/test_rl_td3_models.py:163): the rollout
    buffer must carry [N, 2] actions."""

    def __init__(self, num_envs=4, seed=0):
        self.num_envs = num_envs
        self.observation_dim = 3
        self.num_actions = -1
        self.action_dim = 2
        self._rng = np.random.default_rng(seed)
        self._t = np.zeros(num_envs, np.int64)
        self.completed_returns = []

    def vector_reset(self, seed=None):
        self._t[:] = 0
        return self._rng.normal(size=(self.num_envs, 3)).astype(np.float32)

    def vector_step(self, actions):
        assert np.asarray(actions).shape == (self.num_envs, 2)
        self._t += 1
        done = (self._t % 20 == 0).astype(np.float32)
        r = -np.abs(np.asarray(actions)).sum(-1).astype(np.float32)
        if done.any():
            self.completed_returns.extend([-5.0] * int(done.sum()))
        return (self._rng.normal(size=(self.num_envs, 3)).astype(np.float32),
                r, done, {})


class SlowCartPole(CartPoleVectorEnv):
    """CartPole at 100 ms a step: a sample is in flight long enough for a
    stop() to land on it."""

    def vector_step(self, actions):
        time.sleep(0.1)
        return super().vector_step(actions)


def image_toy_env(num_envs, seed):
    """A module-level factory: what a lambda factory becomes here."""
    return ImageToyEnv(num_envs=num_envs, seed=seed)


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------

def test_sampler_placement_follows_the_runtime(cluster):
    """On the cluster a sampler takes the CPU and one thread whatever the
    learner's device; in-process it takes the learner's device. With no
    runtime yet, the rule is the cluster's (the head an implicit ``init()``
    starts), and the rule and the env check start none: building a driver
    that starts no actor (a DQN without collectors here; CQL, BC, MARWIL)
    leaves none behind."""
    for device in (torch.device("cuda"), torch.device("cpu"), "cuda:1"):
        assert talgorithm.sampler_placement(device) == \
            {"device": "cpu", "num_threads": 1}
    saved = core_api._runtime
    core_api._runtime = None
    try:
        assert talgorithm.sampler_placement(torch.device("cuda")) == \
            {"device": "cpu", "num_threads": 1}
        _cartpole(DQNConfig(), num_rollout_workers=0).build()
        assert core_api._runtime is None
        rt.init(local_mode=True)
        assert talgorithm.sampler_placement(torch.device("cuda")) == \
            {"device": torch.device("cuda"), "num_threads": None}
    finally:
        rt.shutdown()
        core_api._runtime = saved


def _tiny(name):
    if name == "ppo":
        return _cartpole(PPOConfig(), num_rollout_workers=2,
                         num_envs_per_worker=2, rollout_fragment_length=8)
    if name == "dqn":
        return _cartpole(DQNConfig(), num_rollout_workers=2,
                         num_envs_per_worker=2, rollout_fragment_length=8)
    if name == "td3":
        return (TD3Config().environment("Pendulum-v1")
                .rollouts(num_rollout_workers=2, num_envs_per_worker=2,
                          rollout_fragment_length=8)
                .resources(device="cpu"))
    cfg = _cartpole(ESConfig(), num_rollout_workers=2)
    cfg.num_perturbations, cfg.episode_horizon = 2, 10
    return cfg


def _samplers(algo):
    for attr in ("workers", "collectors"):
        got = getattr(algo, attr, None)
        if got is not None:
            return got.workers if hasattr(got, "workers") else got
    raise AssertionError("no sampler actors")


@pytest.mark.parametrize("name", ["ppo", "dqn", "td3", "es"])
def test_samplers_are_cpu_worker_processes(cluster, name):
    """The rollout workers, the collectors and the ES workers run in worker
    processes of their own that see no card, made no CUDA context, and
    sample on the CPU with one torch thread; one iteration trains."""
    algo = _tiny(name).build()
    try:
        infos = rt.get([w.where.remote() for w in _samplers(algo)],
                       timeout=120)
        result = algo.train()
    finally:
        algo.stop()
    pids = {i["pid"] for i in infos}
    assert len(pids) == 2 and os.getpid() not in pids
    assert pids <= _worker_pids(cluster)    # the daemon's workers
    for i in infos:
        assert (i["visible"], i["cuda_initialized"], i["device"],
                i["threads"]) == ("", False, "cpu", 1), i
    assert result["training_iteration"] == 1


# ---------------------------------------------------------------------------
# tests/test_rl.py
# ---------------------------------------------------------------------------

def test_ppo_learns_cartpole_on_the_cluster(cluster):
    """tests/test_rl.py:75: reward >= 120 within 25 iterations."""
    config = (_cartpole(PPOConfig(), num_rollout_workers=2,
                        num_envs_per_worker=16, rollout_fragment_length=64)
              .training(lr=3e-4, num_sgd_iter=8, sgd_minibatch_size=256,
                        entropy_coeff=0.01)
              .debugging(seed=0))
    algo = config.build()
    try:
        best, rewards = _best(algo, 25, 120)
    finally:
        algo.stop()
    assert best >= 120, f"PPO failed to learn CartPole: {rewards}"


@pytest.mark.parametrize("remote", [False, True], ids=["local", "remote"])
def test_algorithm_save_restore_on_the_cluster(cluster, tmp_path, remote):
    """tests/test_rl.py:98, with the learner in the driver and in a worker
    process: the restored algorithm has the iteration and the weights
    bitwise, and trains on."""
    config = (_cartpole(PPOConfig(), num_rollout_workers=1,
                        num_envs_per_worker=4, rollout_fragment_length=16)
              .resources(learner_remote=remote))
    algo = config.build()
    try:
        algo.train()
        ckpt = algo.save(str(tmp_path / "ck"))
        it, weights = algo.iteration, algo.get_state()["weights"]
    finally:
        algo.stop()
    algo2 = config.copy().build()
    try:
        algo2.restore(ckpt)
        assert algo2.iteration == it == 1
        _bitwise(algo2.get_state()["weights"], weights)
        assert algo2.train()["training_iteration"] == 2
    finally:
        algo2.stop()


def test_dqn_runs_on_the_cluster(cluster):
    """tests/test_rl.py:116: three iterations report epsilon."""
    config = _cartpole(DQNConfig(), num_rollout_workers=1,
                       num_envs_per_worker=8, rollout_fragment_length=32)
    config.learning_starts = 128
    algo = config.build()
    try:
        results = [algo.train() for _ in range(3)]
    finally:
        algo.stop()
    assert "epsilon" in results[-1]
    eps = [r["epsilon"] for r in results]
    assert eps == sorted(eps, reverse=True) and eps[-1] < eps[0]
    assert np.isfinite(results[-1]["info/td_loss"])


def test_impala_runs_on_the_cluster(cluster):
    """tests/test_rl.py:129: an iteration samples at least the batch."""
    config = _cartpole(ImpalaConfig(), num_rollout_workers=2,
                       num_envs_per_worker=8, rollout_fragment_length=32)
    config.train_batch_size = 512
    algo = config.build()
    try:
        result = algo.train()
    finally:
        algo.stop()
    assert result["num_env_steps_sampled"] >= 512
    assert all(np.isfinite(v) for k, v in result.items()
               if k.startswith("info/"))


# ---------------------------------------------------------------------------
# tests/test_rl_appo_vtrace.py, tests/test_rl_td3_models.py,
# tests/test_rl_ddpg_marwil.py, tests/test_rl_breadth.py
# ---------------------------------------------------------------------------

def test_structured_sample_roundtrip_on_the_cluster(cluster):
    """tests/test_rl_appo_vtrace.py:57: ``rollout_shape`` and ``last_obs``
    ride on the SampleBatch through the store, from a put and from a
    worker process's sample."""
    spec = {"obs_dim": 4, "num_actions": 2, "hiddens": (16,)}
    module = make_module(spec)
    params = module.init(torch.Generator().manual_seed(0), "cpu")
    w = RolloutWorker("CartPole-v1", spec, rollout_length=5, num_envs=3,
                      gamma=0.99, lam=0.95, device="cpu")
    batch = w.sample(params, structured=True)
    assert batch.rollout_shape == (5, 3)
    assert batch.last_obs.shape == (3, 4)
    back = rt.get(rt.put(batch))
    assert back.rollout_shape == (5, 3)
    assert np.allclose(back.last_obs, batch.last_obs)
    actor = rt.remote(RolloutWorker).options(num_cpus=1).remote(
        "CartPole-v1", spec, 5, 3, 0.99, 0.95, device="cpu", num_threads=1)
    try:
        remote = rt.get(actor.sample.remote(rl_params_to_numpy(params),
                                            structured=True), timeout=120)
    finally:
        rt.kill(actor)
    assert remote.rollout_shape == (5, 3)
    assert remote.last_obs.shape == (3, 4)


def test_appo_cartpole_gate_on_the_cluster(cluster, tmp_path):
    """tests/test_rl_appo_vtrace.py:77: >= 150 within 40 iterations, then a
    checkpoint that restores the learner's weights."""
    config = _cartpole(APPOConfig(), num_rollout_workers=2,
                       num_envs_per_worker=8, rollout_fragment_length=32)
    config.train_batch_size = 1024
    config.lr = 5e-4
    config.seed = 0
    algo = config.build()
    try:
        best, rewards = _best(algo, 40, 150)
        assert best >= 150, f"APPO failed to learn CartPole: {rewards}"
        ckpt = algo.save(str(tmp_path / "ck"))
        algo2 = config.copy().build()
        try:
            algo2.restore(ckpt)
            _bitwise(algo2.get_state()["weights"],
                     algo.get_state()["weights"])
        finally:
            algo2.stop()
    finally:
        algo.stop()


def test_td3_pendulum_gate_on_the_cluster(cluster, tmp_path):
    """tests/test_rl_td3_models.py:45: best >= -700 within 60 iterations
    (random ~ -1200), then a checkpoint that restores the learner."""
    config = (TD3Config().environment("Pendulum-v1")
              .rollouts(num_rollout_workers=1, num_envs_per_worker=8,
                        rollout_fragment_length=64)
              .resources(device="cpu"))
    config.seed = 0
    algo = config.build()
    try:
        best, rewards = _best(algo, 60, -250)
        assert best >= -700, f"TD3 failed to learn Pendulum: {rewards}"
        ckpt = algo.save(str(tmp_path / "ck"))
        algo2 = config.copy().build()
        try:
            algo2.restore(ckpt)
            _bitwise(algo2.learner.state()["params"],
                     algo.learner.state()["params"])
        finally:
            algo2.stop()
    finally:
        algo.stop()


@pytest.mark.parametrize("env", [ImageToyEnv, image_toy_env],
                         ids=["class", "factory"])
def test_conv_ppo_smoke_on_the_cluster(cluster, env):
    """tests/test_rl_td3_models.py:102's driver half: PPO with the CNN
    encoder on an image env, the env given as a module-level class or
    factory."""
    config = PPOConfig().environment(env).resources(device="cpu")
    config.num_rollout_workers = 1
    config.num_envs_per_worker = 4
    config.rollout_fragment_length = 16
    config.train_batch_size = 64
    config.model_encoder = "cnn"
    config.model_obs_shape = (8, 8, 1)
    config.model_filters = ((8, 3, 2), (16, 3, 2))
    config.model_hiddens = (32,)
    algo = config.build()
    try:
        for _ in range(2):
            result = algo.train()
    finally:
        algo.stop()
    assert np.isfinite(result.get("timesteps_total", 0))
    assert np.isfinite(result["info/total_loss"])


def test_ppo_multidim_continuous_smoke_on_the_cluster(cluster):
    """tests/test_rl_td3_models.py:163: [N, 2] actions through the worker
    process's rollout buffer."""
    config = PPOConfig().environment(TwoDimEnv).resources(device="cpu")
    config.num_rollout_workers = 1
    config.num_envs_per_worker = 4
    config.rollout_fragment_length = 20
    config.train_batch_size = 40
    config.sgd_minibatch_size = 20
    config.num_sgd_iter = 2
    algo = config.build()
    try:
        result = algo.train()
    finally:
        algo.stop()
    assert np.isfinite(result["info/total_loss"])


def test_a2c_reduction_and_learning_on_the_cluster(cluster):
    """tests/test_rl_ddpg_marwil.py:90: A2C is PPO at one pass, clip inert;
    best >= 40 within 35 iterations."""
    cfg = A2CConfig()
    assert cfg.num_sgd_iter == 1 and cfg.algo_class is A2C
    cfg = _cartpole(A2CConfig(), num_rollout_workers=1,
                    num_envs_per_worker=8, rollout_fragment_length=32)
    cfg.train_batch_size = 256
    algo = cfg.build()
    try:
        best, rewards = _best(algo, 35, 60)
    finally:
        algo.stop()
    assert best >= 40, f"A2C best reward {best}: {rewards}"


def test_es_improves_cartpole_on_the_cluster(cluster):
    """tests/test_rl_breadth.py:64: 2 workers, 12 perturbations, horizon
    200, seed 3; the last mean reward > max(40, first + 10)."""
    cfg = _cartpole(ESConfig(), num_rollout_workers=2)
    cfg.num_perturbations = 12
    cfg.episode_horizon = 200
    cfg.debugging(seed=3)
    algo = cfg.build()
    try:
        first = algo.train()["episode_reward_mean"]
        last = {}
        for _ in range(12):
            last = algo.train()
    finally:
        algo.stop()
    assert last["episode_reward_mean"] > max(40.0, first + 10.0), \
        (first, last)


# ---------------------------------------------------------------------------
# parity with the JAX package
# ---------------------------------------------------------------------------

SPEC = {"obs_dim": 6, "num_actions": 3, "hiddens": (16, 8)}
HYPER = dict(lr=1e-3, clip_param=0.2, vf_clip_param=2.0, vf_loss_coeff=0.5,
             entropy_coeff=0.01, grad_clip=0.5, seed=3, num_sgd_iter=2,
             sgd_minibatch_size=16)


def _batch(count, seed=2):
    """Logp near the policy's own (ratios inside and outside 1 ± clip),
    value targets near and far from vf_preds."""
    rng = np.random.default_rng(seed)
    obs = rng.standard_normal((count, SPEC["obs_dim"])).astype(np.float32)
    module = make_module(SPEC)
    params = module.init(torch.Generator().manual_seed(seed), device="cpu")
    actions, logp, value = module.sample_actions(
        params, obs, torch.Generator().manual_seed(seed))
    f32 = lambda x: np.asarray(x, np.float32)
    vf_preds = value.numpy() + rng.standard_normal(count) * 2.0
    return SampleBatch({
        sb.OBS: obs, sb.ACTIONS: f32(actions.numpy()),
        sb.ACTION_LOGP: f32(logp.numpy() + 0.3 * rng.standard_normal(count)),
        sb.ADVANTAGES: f32(rng.standard_normal(count) * 2 + 0.5),
        sb.VF_PREDS: f32(vf_preds),
        sb.VALUE_TARGETS: f32(vf_preds + rng.standard_normal(count) * 3),
    })


def test_remote_learner_update_matches_jax(cluster):
    """The learner in a worker process, from the JAX learner's weights on
    one seeded batch (2 epochs of 4 minibatches), twice: stats 1e-5
    relative, weights 2e-6 absolute, as the in-process learner."""
    import jax
    from ray_tpu.rl import learner as jlearner
    kwargs = dict(module_spec=SPEC, **HYPER)
    jg = jlearner.LearnerGroup(jlearner.PPOLearner, kwargs, remote=False)
    tg = tlearner.LearnerGroup(tlearner.PPOLearner,
                               {**kwargs, "device": "cpu"}, remote=True)
    try:
        tg.set_weights(jg.get_weights())
        batch = _batch(69)    # 4 minibatches of 16 an epoch; 5 rows dropped
        for _ in range(2):    # the second update draws the next permutations
            want, got = jg.update(batch), tg.update(batch)
            assert set(got) == set(want)
            for k in want:
                np.testing.assert_allclose(got[k], float(want[k]),
                                           rtol=1e-5, atol=1e-7, err_msg=k)
            got_w = jax.tree.leaves(tg.get_weights())
            want_w = jax.tree.leaves(jg.get_weights())
            assert len(got_w) == len(want_w) == 12
            errors = [float(np.max(np.abs(a - np.asarray(b))))
                      for a, b in zip(got_w, want_w)]
            assert max(errors) <= 2e-6, errors
        assert tg.actor.actor_id.hex() in _alive(cluster)
    finally:
        tg.shutdown()


def test_es_training_step_on_the_cluster_matches_jax(cluster):
    """One ES step on the cluster's worker processes against the JAX ES's
    (local mode: its result does not depend on the runtime) from the same
    theta: the episode rewards equal, theta within 1e-6."""
    import ray_tpu
    from ray_tpu.rl.algorithms import ESConfig as JESConfig
    configs = []
    for cls in (JESConfig, ESConfig):
        c = cls()
        c.env = "CartPole-v1"
        c.rollouts(num_rollout_workers=2)
        c.num_perturbations = 6
        c.episode_horizon = 120
        configs.append(c.debugging(seed=3))
    configs[1].resources(device="cpu")
    ray_tpu.shutdown()
    ray_tpu.init(local_mode=True, num_cpus=4)
    try:
        jalgo = configs[0].build()
        theta = jalgo.theta.copy()
        want = jalgo.train()
        jalgo.stop()
    finally:
        ray_tpu.shutdown()
    talgo = configs[1].build()
    try:
        talgo.set_state({"theta": theta.copy()})
        got = talgo.train()
    finally:
        talgo.stop()
    for k in ("episode_reward_mean", "episode_reward_max"):
        assert got[k] == want[k], k
    assert 0 < got["episode_reward_mean"] < 120
    assert np.max(np.abs(talgo.theta - jalgo.theta)) <= 1e-6
    assert np.max(np.abs(talgo.theta - theta)) > 1e-3   # it moved


@pytest.mark.parametrize("structured", [False, True],
                         ids=["gae", "structured"])
def test_worker_process_sample_equals_the_in_process_one(cluster,
                                                         structured):
    """A RolloutWorker in a worker process and one in this process, the
    same seed and the JAX weights (``rl_params_from_jax``): every column,
    and the structured batch's attributes, bitwise equal."""
    import jax
    from ray_tpu.rl.module import RLModule as JRLModule
    spec = {"obs_dim": 4, "num_actions": 2, "hiddens": (32, 32)}
    rng = np.random.default_rng(5)
    jparams = jax.tree.map(
        lambda a: np.asarray(a) + 0.3 * rng.standard_normal(
            np.shape(a)).astype(np.float32),
        jax.device_get(JRLModule(obs_dim=4, num_actions=2,
                                 hiddens=(32, 32)).init(
            jax.random.PRNGKey(0))))
    args = ("CartPole-v1", spec, 32, 8, 0.99, 0.95)
    local = RolloutWorker(*args, seed=11, device="cpu")
    actor = rt.remote(RolloutWorker).options(num_cpus=1).remote(
        *args, seed=11, device="cpu", num_threads=1)
    try:
        for _ in range(2):    # the second round continues the envs
            want = local.sample(jparams, structured=structured)
            got = rt.get(actor.sample.remote(jparams, structured=structured),
                         timeout=120)
            assert sorted(got) == sorted(want)
            for k in want:
                a, b = np.asarray(got[k]), np.asarray(want[k])
                assert a.dtype == b.dtype and a.shape == b.shape, k
                assert a.tobytes() == b.tobytes(), k
            if structured:
                assert got.rollout_shape == want.rollout_shape == (32, 8)
                assert got.last_obs.tobytes() == want.last_obs.tobytes()
        assert rt.get(actor.episode_stats.remote(), timeout=60) == \
            local.episode_stats()
    finally:
        rt.kill(actor)


# ---------------------------------------------------------------------------
# refusals and teardown
# ---------------------------------------------------------------------------

def test_lambda_env_factory_raises_at_build(cluster):
    before = _alive(cluster)
    config = (PPOConfig()
              .environment(lambda num_envs, seed: CartPoleVectorEnv(
                  num_envs=num_envs, seed=seed))
              .rollouts(num_rollout_workers=1)
              .resources(device="cpu", learner_remote=True))
    with pytest.raises(TypeError, match="define it at module level"):
        config.build()
    assert _alive(cluster) == before


@pytest.mark.parametrize("num_gpus", [0.0, 1.0])
def test_card_learner_without_a_lease_raises_at_build(cluster, monkeypatch,
                                                      num_gpus):
    """A remote learner on the card (``device`` left at the card, which the
    driver is made to see) must lease one: without ``learner_num_gpus``,
    or asking more cards than the cluster counts (none here), ``build()``
    raises ``ValueError`` naming it before any actor exists."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    before = _alive(cluster)
    config = (PPOConfig().environment("CartPole-v1")
              .rollouts(num_rollout_workers=1)
              .resources(learner_remote=True, learner_num_gpus=num_gpus))
    with pytest.raises(ValueError, match="learner_num_gpus"):
        config.build()
    assert _alive(cluster) == before


def _hosting(c, ids):
    """Pids of the cluster's worker processes that host one of ``ids``."""
    return {w.pid for n in c.nodes for w in list(n._workers.values())
            if w.actor_id is not None and w.actor_id.hex() in ids}


def _died_with_its_actor(ref) -> bool:
    try:
        rt.get(ref, timeout=60)
    except rt.ActorDiedError:
        return True
    except rt.TaskError as e:
        return isinstance(e.cause, rt.ActorDiedError)
    return False


@pytest.mark.parametrize("cls", [APPOConfig, ImpalaConfig],
                         ids=["appo", "impala"])
def test_stop_with_samples_in_flight_leaves_no_worker(cluster, cls):
    """stop() right after build(), whose first sample on every worker is in
    flight (a sample takes 1.6 s here; the kill lands while a worker starts
    or samples): the refs fail as dead-actor errors, which nothing waits
    on, no actor stays ALIVE, and no worker process hosts one of them (a
    killed actor's process exits, or goes back to the daemon's pool
    holding no actor)."""
    config = (cls().environment(SlowCartPole)
              .rollouts(num_rollout_workers=2, num_envs_per_worker=4,
                        rollout_fragment_length=16)
              .resources(device="cpu").debugging(seed=1))
    config.train_batch_size = 128
    algo = config.build()
    ids = {w.actor_id.hex() for w in algo.workers.workers}
    refs = list(algo._inflight)
    assert len(refs) == 2       # one sample a worker, in flight
    algo.stop()
    assert algo._inflight == {}
    assert [_died_with_its_actor(r) for r in refs] == [True, True]
    assert not _settled(lambda: _alive(cluster, ids))
    assert not _settled(lambda: _hosting(cluster, ids))
