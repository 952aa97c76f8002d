"""Port parity: the async actor-critics (IMPALA, APPO) and A2C,
ray_tpu_torch.rl.algorithms against ray_tpu.rl.algorithms on the CPU.

APPO and IMPALA consume their workers' batches in arrival order, which the
worker threads decide: a driver's trajectory is not deterministic in either
stack, so their learners are held to the JAX learners here, and the drivers
to the JAX package's gates and checkpoints, not to its trajectories.

- ``APPOLearner.update``: 4 consecutive updates on seeded structured [T, N]
  batches (dones mid-rollout, behaviour logps off the policy's own so that
  rho and c clip) from the same weights: every stat 1e-5 relative, the
  parameters 2e-6 absolute at f32 (the bound of the PPO learner's 8-step
  update in ``tests/test_torch_rl_learner.py``; each Adam step moves a
  parameter by about lr = 1e-3). ``ImpalaLearner.update`` (PPO's with the
  clip at ``clip_rho``): 3 updates of 2 minibatches, same bounds.
- A checkpoint of either stack restores in the other with bitwise-equal
  weights (APPO, IMPALA).
- The JAX package's gates through ``XConfig().build().train()`` on the CPU:
  APPO >= 150 within 40 iterations (``tests/test_rl_appo_vtrace.py``),
  A2C >= 40 within 35 (``tests/test_rl_ddpg_marwil.py``), IMPALA's 512
  env steps an iteration (``tests/test_rl.py``).
- ``stop()`` with a sample in flight on every worker, then ``shutdown()``,
  leaves no runtime thread.
"""

import threading

import jax
import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu_torch
from ray_tpu.rl.algorithms import APPOConfig as JAPPOConfig
from ray_tpu.rl.algorithms import ImpalaConfig as JImpalaConfig
from ray_tpu.rl.algorithms import appo as jappo
from ray_tpu.rl.algorithms import impala as jimpala
from ray_tpu_torch.core.runtime_local import THREAD_PREFIX
from ray_tpu_torch.rl import SampleBatch, make_module
from ray_tpu_torch.rl import sample_batch as sb
from ray_tpu_torch.rl.algorithms import (A2C, A2CConfig, APPOConfig,
                                         ImpalaConfig)
from ray_tpu_torch.rl.algorithms import appo as tappo
from ray_tpu_torch.rl.algorithms import impala as timpala


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for these small ops (faster alone, and the suite
    runs in parallel processes: a thread a core in each oversubscribes the
    cores, and a CPU gate then runs 20x slower or more)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


SPEC = {"obs_dim": 5, "num_actions": 3, "hiddens": (16, 8)}


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


def _moved(weights, seed=1):
    """The init moved by a seeded draw (every bias starts at 0)."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: np.asarray(a) + 0.1 * rng.standard_normal(
        np.shape(a)).astype(np.float32), weights)


def _structured(T, N, seed):
    """A worker's structured batch: [T * N] rows in time-major order,
    behaviour logps 0.5 off the policy's own, dones mid-rollout."""
    rng = np.random.default_rng(seed)
    f32 = lambda x: np.asarray(x, np.float32)
    obs = f32(rng.standard_normal((T * N, SPEC["obs_dim"])))
    module = make_module(SPEC)
    params = module.init(torch.Generator().manual_seed(seed), device="cpu")
    actions, logp, _ = module.sample_actions(
        params, obs, torch.Generator().manual_seed(seed))
    batch = SampleBatch({
        sb.OBS: obs, sb.ACTIONS: f32(actions.numpy()),
        sb.REWARDS: f32(rng.standard_normal(T * N)),
        sb.DONES: f32(rng.random(T * N) < 0.1),
        sb.ACTION_LOGP: f32(logp.numpy() + 0.5 * rng.standard_normal(T * N)),
    })
    batch.rollout_shape = (T, N)
    batch.last_obs = f32(rng.standard_normal((N, SPEC["obs_dim"])))
    return batch


def _assert_stats(got, want):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], float(want[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)


def _max_leaf_error(got, want):
    got, want = jax.tree.leaves(got), jax.tree.leaves(want)
    assert len(got) == len(want) == 12       # 3 layers x 2 towers
    return max(float(np.max(np.abs(a - np.asarray(b))))
               for a, b in zip(got, want))


@pytest.mark.parametrize("rho_bar,c_bar", [(1.0, 1.0), (1.5, 0.8)])
def test_appo_learner_updates_match_jax(rho_bar, c_bar):
    hyper = dict(lr=1e-3, clip_param=0.2, vf_loss_coeff=0.5,
                 entropy_coeff=0.01, gamma=0.97, rho_bar=rho_bar,
                 c_bar=c_bar, grad_clip=0.5, seed=3)
    jl = jappo.APPOLearner(SPEC, **hyper)
    tl = tappo.APPOLearner(SPEC, device="cpu", **hyper)
    weights = _moved(jl.get_weights())
    jl.set_weights(weights)
    tl.set_weights(weights)
    for i in range(4):
        batch = _structured(T=12, N=4, seed=10 + i)
        want = jl.update(batch)
        got = tl.update(batch)
        _assert_stats(got, want)
        assert _max_leaf_error(tl.get_weights(), jl.get_weights()) <= 2e-6
    assert 0.5 < got["mean_rho"] < 2.0


def test_impala_learner_updates_match_jax():
    hyper = dict(lr=1e-3, clip_rho=1.0, vf_loss_coeff=0.5,
                 entropy_coeff=0.01, num_sgd_iter=1, sgd_minibatch_size=16,
                 seed=3)
    jl = jimpala.ImpalaLearner(module_spec=SPEC, **hyper)
    tl = timpala.ImpalaLearner(SPEC, device="cpu", **hyper)
    assert tl.loss_kw["clip_param"] == 1.0
    weights = _moved(jl.get_weights())
    jl.set_weights(weights)
    tl.set_weights(weights)
    rng = np.random.default_rng(5)
    for i in range(3):
        batch = _structured(T=8, N=4, seed=20 + i)
        vf = rng.standard_normal(batch.count).astype(np.float32)
        batch[sb.VF_PREDS] = vf
        batch[sb.ADVANTAGES] = rng.standard_normal(batch.count).astype(
            np.float32)
        batch[sb.VALUE_TARGETS] = vf + rng.standard_normal(
            batch.count).astype(np.float32)
        _assert_stats(tl.update(batch), jl.update(batch))
        assert _max_leaf_error(tl.get_weights(), jl.get_weights()) <= 2e-6


def _small(config):
    return (config.environment("CartPole-v1")
            .rollouts(num_rollout_workers=2, num_envs_per_worker=4,
                      rollout_fragment_length=16)
            .training(train_batch_size=128).debugging(seed=1))


def _bitwise(a, b):
    la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
    assert len(la) == len(lb) == 12
    for x, y in zip(la, lb):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype == np.float32 and x.shape == y.shape
        assert x.tobytes() == y.tobytes()


@pytest.mark.parametrize("algo", ["appo", "impala"])
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_checkpoint_restores_across_the_stacks(runtimes, tmp_path, algo,
                                               direction):
    jcls, tcls = {"appo": (JAPPOConfig, APPOConfig),
                  "impala": (JImpalaConfig, ImpalaConfig)}[algo]
    jax_algo = _small(jcls()).build()
    port_algo = _small(tcls()).resources(device="cpu").build()
    src, dst = ((jax_algo, port_algo) if direction == "jax_to_port"
                else (port_algo, jax_algo))
    for _ in range(2):
        src.train()
    ckpt = src.save(str(tmp_path / "ck"))
    dst.restore(ckpt)
    assert dst.iteration == src.iteration == 2
    assert dst._timesteps_total == src._timesteps_total >= 256
    _bitwise(dst.get_state()["weights"], src.get_state()["weights"])
    result = dst.train()
    assert result["training_iteration"] == 3
    assert np.isfinite(result["info/total_loss"])
    jax_algo.stop()
    port_algo.stop()


def test_train_returns_the_jax_keys(runtimes):
    for jcls, tcls in ((JAPPOConfig, APPOConfig),
                       (JImpalaConfig, ImpalaConfig)):
        jax_algo = _small(jcls()).build()
        port_algo = _small(tcls()).resources(device="cpu").build()
        want, got = jax_algo.train(), port_algo.train()
        assert sorted(got) == sorted(want)
        assert all(np.isfinite(v) for k, v in got.items()
                   if k.startswith("info/"))
        jax_algo.stop()
        port_algo.stop()


def test_appo_cartpole_gate(trt, tmp_path):
    """The JAX package's gate (tests/test_rl_appo_vtrace.py:77): 2 workers x
    8 envs x 32 steps, train batch 1024, lr 5e-4, seed 0; best mean reward
    >= 150 within 40 iterations; then a bitwise checkpoint round trip."""
    config = (APPOConfig().environment("CartPole-v1")
              .rollouts(num_rollout_workers=2, num_envs_per_worker=8,
                        rollout_fragment_length=32)
              .resources(device="cpu"))
    config.train_batch_size = 1024
    config.lr = 5e-4
    config.seed = 0
    algo = config.build()
    best, rewards = 0.0, []
    for _ in range(40):
        result = algo.train()
        r = result["episode_reward_mean"]
        rewards.append(round(r, 1))
        if not np.isnan(r):
            best = max(best, r)
        if best >= 150:
            break
    assert best >= 150, f"APPO failed to learn CartPole: {rewards}"
    ckpt = algo.save(str(tmp_path / "ck"))
    algo2 = config.copy().build()
    algo2.restore(ckpt)
    _bitwise(algo2.get_state()["weights"], algo.get_state()["weights"])
    algo.stop()
    algo2.stop()


def test_impala_runs(trt):
    """tests/test_rl.py:129's settings: every iteration samples at least
    the train batch, with finite stats."""
    config = (ImpalaConfig().environment("CartPole-v1")
              .rollouts(num_rollout_workers=2, num_envs_per_worker=8,
                        rollout_fragment_length=32)
              .resources(device="cpu"))
    config.train_batch_size = 512
    algo = config.build()
    for _ in range(3):
        result = algo.train()
        assert result["num_env_steps_sampled"] >= 512
        assert all(np.isfinite(v) for k, v in result.items()
                   if k.startswith("info/"))
    algo.stop()


def test_a2c_reduction_and_learning(trt):
    """A2C == PPO at (1 SGD pass over the whole batch, clip inert); the JAX
    gate (tests/test_rl_ddpg_marwil.py:90): >= 40 within 35 iterations."""
    cfg = A2CConfig()
    assert (cfg.num_sgd_iter, cfg.sgd_minibatch_size, cfg.clip_param) == \
        (1, 0, 10.0) and cfg.algo_class is A2C
    cfg = (A2CConfig().environment("CartPole-v1")
           .rollouts(num_rollout_workers=1, num_envs_per_worker=8,
                     rollout_fragment_length=32)
           .resources(device="cpu"))
    cfg.train_batch_size = 256
    algo = cfg.build()
    best = 0.0
    for _ in range(35):
        r = algo.train()["episode_reward_mean"]
        if not np.isnan(r):
            best = max(best, r)
        if best >= 60:
            break
    algo.stop()
    assert best >= 40, f"A2C best reward {best}"


@pytest.mark.parametrize("cls", [APPOConfig, ImpalaConfig],
                         ids=["appo", "impala"])
def test_stop_with_samples_in_flight_leaves_no_thread(trt, cls):
    algo = _small(cls()).resources(device="cpu").build()
    algo.train()
    assert len(algo._inflight) == 2       # one sample a worker, in flight
    algo.stop()
    assert algo._inflight == {}
    trt.shutdown()
    alive = [t.name for t in threading.enumerate()
             if t.name.startswith(THREAD_PREFIX) and t.is_alive()]
    assert alive == []


def test_async_step_raises_the_jax_timeout_text(monkeypatch):
    monkeypatch.setattr(ray_tpu_torch, "wait",
                        lambda refs, **kw: ([], list(refs)))
    with pytest.raises(TimeoutError) as got:
        timpala.async_training_step({"ref": "worker"}, 1, None, None)
    monkeypatch.setattr(ray_tpu, "wait",
                        lambda refs, **kw: ([], list(refs)))
    with pytest.raises(TimeoutError) as want:
        jimpala.async_training_step({"ref": "worker"}, 1, None, None)
    assert str(got.value) == str(want.value)
