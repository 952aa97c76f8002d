"""Port parity: the RL drivers (``AlgorithmConfig``, ``Algorithm``,
``WorkerSet``, ``LearnerGroup``, ``PPO``) of ray_tpu_torch against ray_tpu's,
on the CPU.

Each stack runs in its own in-process runtime, started and shut down here
(``ray_tpu.init(local_mode=True)`` and
``ray_tpu_torch.init(local_mode=True)``; never the conftest's
``local_rt``). The port's drivers run with
``.resources(device="cpu")``.

- The fluent chains set the same attributes, and ``module_spec`` and the
  build-time ``ValueError`` s are the JAX package's.
- ``LearnerGroup.update``, local and remote, from the JAX learner's initial
  weights on one seeded batch (2 epochs of 4 minibatches) matches the JAX
  ``LearnerGroup``: stats 1e-5 relative, parameters 2e-6 absolute at f32
  (``tests/test_torch_rl_learner.py``'s bound for the same update
  through ``PPOLearner`` alone).
- A checkpoint of either stack restores in the other with bitwise-equal
  weights and the same iteration, and trains on.
- ``train()`` returns the JAX package's keys.
- PPO's learning gate (``tests/test_rl.py``: 2 workers x 16 CartPole envs x
  64 steps, lr 3e-4, 8 epochs of minibatch 256, entropy 0.01, seed 0; best
  mean reward >= 120 within 25 iterations) through ``PPOConfig().build()``.
- The CNN plumbing smoke of ``tests/test_rl_td3_models.py`` through the
  port's drivers.
"""

import threading

import jax
import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu_torch
from ray_tpu.rl import algorithm as jalgorithm
from ray_tpu.rl import learner as jlearner
from ray_tpu.rl.algorithms import PPOConfig as JPPOConfig
from ray_tpu_torch.core.runtime_local import THREAD_PREFIX
from ray_tpu_torch.rl import algorithm as talgorithm
from ray_tpu_torch.rl import learner as tlearner
from ray_tpu_torch.rl import make_module, sample_batch as sb
from ray_tpu_torch.rl.algorithms import PPOConfig
from ray_tpu_torch.rl.env import CartPoleVectorEnv, VectorEnv
from ray_tpu_torch.rl.sample_batch import SampleBatch


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for these small ops (faster alone, and the suite
    runs in parallel processes: a thread a core in each oversubscribes the
    cores, and a CPU gate then runs 20x slower or more)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# the attributes that differ by design: the accelerator and the device
PORT_ONLY = {"learner_num_gpus", "device"}
JAX_ONLY = {"learner_num_tpus"}


@pytest.fixture
def runtimes():
    """Both packages' in-process runtimes, each started here."""
    ray_tpu.shutdown()
    ray_tpu_torch.shutdown()
    ray_tpu.init(local_mode=True, num_cpus=4)
    ray_tpu_torch.init(local_mode=True, num_cpus=4)
    yield
    ray_tpu_torch.shutdown()
    ray_tpu.shutdown()


@pytest.fixture
def trt():
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(local_mode=True, num_cpus=4)
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


def _attrs(config, drop):
    return {k: v for k, v in vars(config).items()
            if k not in drop | {"algo_class"}}


CHAINS = {
    "defaults": lambda c: c,
    "gate": lambda c: (c.environment("CartPole-v1")
                       .rollouts(num_rollout_workers=2, num_envs_per_worker=16,
                                 rollout_fragment_length=64)
                       .training(lr=3e-4, num_sgd_iter=8,
                                 sgd_minibatch_size=256, entropy_coeff=0.01,
                                 not_a_field=3)
                       .debugging(seed=0)),
    "cnn": lambda c: (c.environment("Pendulum-v1", render=False)
                      .training(model_encoder="cnn", model_obs_shape=(8, 8, 1),
                                model_filters=((8, 3, 2),), gamma=0.9)
                      .resources(learner_remote=True)),
}


@pytest.mark.parametrize("chain", sorted(CHAINS))
def test_fluent_chain_sets_the_jax_attributes(chain):
    got = CHAINS[chain](PPOConfig())
    want = CHAINS[chain](JPPOConfig())
    assert _attrs(got, PORT_ONLY) == _attrs(want, JAX_ONLY)
    assert got.learner_num_gpus == want.learner_num_tpus == 0.0
    assert got.device is None
    copied = got.copy()
    assert copied is not got and vars(copied) == vars(got)


def test_resources_set_the_port_fields():
    c = PPOConfig().resources(learner_remote=True, learner_num_gpus=1,
                              device="cpu")
    assert (c.learner_remote, c.learner_num_gpus, c.device) == \
        (True, 1, "cpu")
    c.resources()                      # nothing given: nothing changes
    assert (c.learner_remote, c.learner_num_gpus, c.device) == \
        (True, 1, "cpu")


class _JProbe(jalgorithm.Algorithm):
    def setup(self):
        pass


class _TProbe(talgorithm.Algorithm):
    def setup(self):
        pass


def _probe(probe_cls, config_cls, **fields):
    config = config_cls()
    for k, v in fields.items():
        setattr(config, k, v)
    if config_cls is PPOConfig:
        config.device = "cpu"
    try:
        return probe_cls(config).module_spec
    except ValueError as e:
        return f"ValueError: {e}"


SPEC_CASES = {
    "cartpole": dict(env="CartPole-v1", model_hiddens=[32, 16]),
    "pendulum": dict(env="Pendulum-v1"),
    "cnn": dict(model_encoder="cnn", model_obs_shape=[8, 8, 1],
                model_filters=[(8, 3, 2), (16, 3, 2)]),
    "cnn_without_obs_shape": dict(model_encoder="cnn"),
    "lstm": dict(model_encoder="lstm"),
}


@pytest.mark.parametrize("case", sorted(SPEC_CASES))
def test_module_spec_and_build_errors_match(case):
    got = _probe(_TProbe, PPOConfig, **SPEC_CASES[case])
    want = _probe(_JProbe, JPPOConfig, **SPEC_CASES[case])
    assert got == want
    assert isinstance(got, dict) == (
        case not in ("lstm", "cnn_without_obs_shape"))


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


def _set_port_weights(group, weights):
    if group.remote:
        assert ray_tpu_torch.get(group.actor.set_weights.remote(weights))
    else:
        group.local.set_weights(weights)


@pytest.mark.parametrize("remote", [False, True], ids=["local", "remote"])
def test_learner_group_update_matches_jax(runtimes, remote):
    kwargs = dict(module_spec=SPEC, **HYPER)
    jg = jlearner.LearnerGroup(jlearner.PPOLearner, kwargs, remote=remote)
    tg = tlearner.LearnerGroup(tlearner.PPOLearner,
                               {**kwargs, "device": "cpu"}, remote=remote)
    _set_port_weights(tg, jg.get_weights())
    batch = _batch(69)       # 4 minibatches of 16 an epoch; 5 rows dropped
    for _ in range(2):       # the second update draws the next permutations
        want, got = jg.update(batch), tg.update(batch)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], float(want[k]), rtol=1e-5,
                                       atol=1e-7, err_msg=k)
        got_w = jax.tree.leaves(tg.get_weights())
        want_w = jax.tree.leaves(jg.get_weights())
        assert len(got_w) == len(want_w) == 12      # 3 layers x 2 towers
        errors = [float(np.max(np.abs(a - np.asarray(b))))
                  for a, b in zip(got_w, want_w)]
        assert max(errors) <= 2e-6, errors
    assert isinstance(jax.tree.leaves(tg.get_weights())[0], np.ndarray)
    tg.shutdown()
    jg.shutdown()


def _small(config):
    return (config.environment("CartPole-v1")
            .rollouts(num_rollout_workers=1, num_envs_per_worker=4,
                      rollout_fragment_length=16)
            .debugging(seed=1))


def _weights_equal(a, b):
    la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
    assert len(la) == len(lb) > 0
    for x, y in zip(la, lb):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape
        assert x.tobytes() == y.tobytes()


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_checkpoint_restores_across_the_stacks(runtimes, tmp_path, direction):
    jax_algo = _small(JPPOConfig()).build()
    port_algo = _small(PPOConfig()).resources(device="cpu").build()
    src, dst = ((jax_algo, port_algo) if direction == "jax_to_port"
                else (port_algo, jax_algo))
    src.train()
    src.train()
    ckpt = src.save(str(tmp_path / "ck"))
    dst.restore(ckpt)
    assert dst.iteration == src.iteration == 2
    assert dst._timesteps_total == src._timesteps_total == 128
    _weights_equal(dst.get_state()["weights"], src.get_state()["weights"])
    result = dst.train()
    assert result["training_iteration"] == 3
    assert np.isfinite(result["info/total_loss"])
    jax_algo.stop()
    port_algo.stop()


def test_train_returns_the_jax_keys(runtimes):
    jax_algo = _small(JPPOConfig()).build()
    port_algo = _small(PPOConfig()).resources(device="cpu").build()
    want, got = jax_algo.train(), port_algo.train()
    assert sorted(got) == sorted(want)
    for k in ("num_env_steps_sampled", "timesteps_total",
              "training_iteration"):
        assert got[k] == want[k], k
    assert all(np.isfinite(v) for k, v in got.items() if k.startswith("info/"))
    jax_algo.stop()
    port_algo.stop()


def test_ppo_learns_cartpole_through_the_drivers(trt):
    """The JAX package's learning gate (tests/test_rl.py:75-96)."""
    config = (PPOConfig()
              .environment("CartPole-v1")
              .rollouts(num_rollout_workers=2, num_envs_per_worker=16,
                        rollout_fragment_length=64)
              .training(lr=3e-4, num_sgd_iter=8, sgd_minibatch_size=256,
                        entropy_coeff=0.01)
              .debugging(seed=0)
              .resources(device="cpu"))
    algo = config.build()
    best, rewards = 0.0, []
    for _ in range(25):
        result = algo.train()
        r = result["episode_reward_mean"]
        rewards.append(r)
        if not np.isnan(r):
            best = max(best, r)
        if best >= 120:
            break
    assert result["timesteps_total"] == 2048 * len(rewards)
    algo.stop()
    assert best >= 120, f"PPO failed to learn CartPole: {rewards}"


def test_remote_learner_trains_and_stop_leaves_no_thread(trt):
    algo = (_small(PPOConfig())
            .resources(learner_remote=True, learner_num_gpus=0,
                       device="cpu").build())
    for _ in range(3):
        result = algo.train()
        assert all(np.isfinite(v) for k, v in result.items()
                   if k.startswith("info/"))
    assert algo.learner_group.remote
    assert len(trt.core.api._runtime._actors) == 2    # a worker, the learner
    algo.stop()
    trt.shutdown()
    alive = [t.name for t in threading.enumerate()
             if t.name.startswith(THREAD_PREFIX) and t.is_alive()]
    assert alive == []


def test_build_without_a_card_raises_before_any_actor(trt, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    runtime = trt.core.api._runtime
    with pytest.raises(RuntimeError, match="CUDA"):
        PPOConfig().build()
    with pytest.raises(RuntimeError, match="CUDA"):
        PPOConfig().resources(learner_remote=True).build()
    with pytest.raises(RuntimeError, match="CUDA"):
        tlearner.LearnerGroup(tlearner.PPOLearner, {"module_spec": SPEC},
                              remote=True)
    assert runtime._actors == {}


class ImageToyEnv(VectorEnv):
    """CartPole state painted into an 8x8 image (plumbing smoke)."""

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


def test_ppo_cnn_smoke_through_the_drivers(trt):
    config = PPOConfig().environment(
        lambda num_envs, seed: ImageToyEnv(num_envs=num_envs, seed=seed))
    config.num_rollout_workers = 1
    config.num_envs_per_worker = 4
    config.rollout_fragment_length = 16
    config.train_batch_size = 64
    config.model_encoder = "cnn"
    config.model_obs_shape = (8, 8, 1)
    config.model_filters = ((8, 3, 2), (16, 3, 2))
    config.model_hiddens = (32,)
    config.device = "cpu"
    algo = config.build()
    assert algo.module_spec["encoder"] == "cnn"
    before = algo.get_state()["weights"]["conv"][0]["w"].copy()
    for _ in range(2):
        result = algo.train()
    assert np.isfinite(result.get("timesteps_total", 0))
    assert result["timesteps_total"] == 128
    assert np.abs(algo.get_state()["weights"]["conv"][0]["w"]
                  - before).max() > 0     # gradients reached the convs
    algo.stop()
