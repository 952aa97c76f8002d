"""Port parity: ``RolloutWorker``, ray_tpu_torch.rl against ``ray_tpu.rl`` on
the CPU.

Sampling cannot match the JAX worker's draws (JAX's PRNG against a
``torch.Generator``), so a port sample is held to the JAX package on its own
observations and actions: its ``vf_preds`` and ``action_logp`` against the
JAX module's values and ``logp_entropy`` on the same weights (converted by
``rl_params_from_jax`` from the JAX module's init, moved off it by a seeded
draw), and its ``advantages`` and ``value_targets`` against the JAX
``compute_gae`` over those values, the sample's rewards and dones, and the
JAX value of the worker's last observation. CartPole (discrete) and Pendulum
(continuous, action_dim 1), 8 envs x 32 steps, so that episodes end inside
the window.

Tolerances: values and logp 1e-5 (f32, as the module tests); advantages and
targets 1e-4 (32 steps of a discounted sum of 1e-6 value differences, over
returns up to ~30 in magnitude).
"""

import jax
import numpy as np
import pytest
import torch

from ray_tpu.rl import module as jmod
from ray_tpu.rl import rollout as jroll
from ray_tpu.rl import sample_batch as jsb
from ray_tpu_torch.rl import RolloutWorker, make_module
from ray_tpu_torch.rl import sample_batch as sb


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for these small ops (faster alone, and the suite
    runs in parallel processes: a thread a core in each oversubscribes the
    cores, and a CPU gate then runs 20x slower or more)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


CASES = {
    "CartPole-v1": {"obs_dim": 4, "num_actions": 2, "hiddens": (16, 16)},
    "Pendulum-v1": {"obs_dim": 3, "num_actions": -1, "action_dim": 1,
                    "hiddens": (16, 16)},
}
T, N = 32, 8


def _jax_weights(spec, seed=0):
    rng = np.random.default_rng(seed)
    jm = jmod.make_module(spec)
    return jm, jax.tree.map(
        lambda a: np.asarray(a) + 0.1 * rng.standard_normal(np.shape(a))
        .astype(np.float32), jm.init(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("env", sorted(CASES))
def test_sample_holds_to_the_jax_module_and_gae(env):
    spec = CASES[env]
    jm, weights = _jax_weights(spec)
    worker = RolloutWorker(env, spec, T, N, gamma=0.99, lam=0.95, seed=4,
                           device="cpu")
    batch = worker.sample(weights)
    assert batch.count == T * N
    assert set(batch) == {sb.OBS, sb.ACTIONS, sb.REWARDS, sb.DONES,
                          sb.ACTION_LOGP, sb.VF_PREDS, sb.ADVANTAGES,
                          sb.VALUE_TARGETS}
    if env == "CartPole-v1":
        assert batch[sb.DONES].sum() > 0     # episodes end in the window
    logp, _, value = jm.logp_entropy(weights, batch[sb.OBS],
                                     batch[sb.ACTIONS])
    np.testing.assert_allclose(batch[sb.ACTION_LOGP], logp, rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(batch[sb.VF_PREDS], value, rtol=0, atol=1e-5)
    last_value = np.asarray(jm.apply(weights, worker.obs)[1])
    adv, targets = jroll.compute_gae(
        batch[sb.REWARDS].reshape(T, N), np.asarray(value).reshape(T, N),
        batch[sb.DONES].reshape(T, N), last_value, 0.99, 0.95)
    np.testing.assert_allclose(batch[sb.ADVANTAGES], adv.reshape(-1),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(batch[sb.VALUE_TARGETS], targets.reshape(-1),
                               rtol=0, atol=1e-4)


def test_sample_is_seeded_and_keeps_the_jax_columns():
    spec = CASES["CartPole-v1"]
    _, weights = _jax_weights(spec)
    a, b = (RolloutWorker("CartPole-v1", spec, 8, 4, 0.99, 0.95, seed=9,
                          device="cpu").sample(weights) for _ in range(2))
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
        assert a[k].dtype == np.float32
    assert a[sb.ACTIONS].shape == (32,)
    assert set(np.unique(a[sb.ACTIONS])) <= {0.0, 1.0}
    # the same column names as the JAX package
    assert {sb.OBS, sb.ACTIONS, sb.ADVANTAGES} == {jsb.OBS, jsb.ACTIONS,
                                                  jsb.ADVANTAGES}


def test_structured_sample_skips_gae():
    spec = CASES["Pendulum-v1"]
    _, weights = _jax_weights(spec)
    worker = RolloutWorker("Pendulum-v1", spec, 8, 4, 0.99, 0.95,
                           device="cpu")
    batch = worker.sample(weights, structured=True)
    assert batch.rollout_shape == (8, 4)
    np.testing.assert_array_equal(batch.last_obs, worker.obs)
    assert sb.ADVANTAGES not in batch and sb.VF_PREDS not in batch


def test_continuous_actions_of_several_dims_keep_their_shape():
    def env_fn(num_envs, seed):
        from ray_tpu_torch.rl.env import PendulumVectorEnv

        class Wide(PendulumVectorEnv):
            action_dim = 2

            def vector_step(self, actions):
                assert actions.shape == (self.num_envs, 2)
                return super().vector_step(actions[:, 0])
        return Wide(num_envs, seed)

    spec = {"obs_dim": 3, "num_actions": -1, "action_dim": 2,
            "hiddens": (8,)}
    worker = RolloutWorker(env_fn, spec, 4, 3, 0.99, 0.95, device="cpu")
    tm = make_module(spec)
    worker.set_weights(tm.init(torch.Generator().manual_seed(0),
                               device="cpu"))
    batch = worker.sample()
    assert batch[sb.ACTIONS].shape == (12, 2)
    logp, _, _ = tm.logp_entropy(worker.params, batch[sb.OBS],
                                 batch[sb.ACTIONS])
    np.testing.assert_allclose(batch[sb.ACTION_LOGP], logp.numpy(),
                               rtol=0, atol=1e-5)
    assert worker.ping() == "pong"
    assert set(worker.episode_stats()) == {"episode_reward_mean",
                                           "episodes"}
