"""Port parity: the off-policy algorithms (DQN, SAC, TD3, DDPG),
ray_tpu_torch.rl.algorithms against ray_tpu.rl.algorithms on the CPU.

Each stack runs in its own in-process runtime, started here
(``ray_tpu.init(local_mode=True)`` and ``ray_tpu_torch.init()``). The port
runs with ``device="cpu"``; both stacks compute in f32.

- Learners: 4 consecutive updates from the same weights (the JAX init,
  moved by a seeded draw) on seeded minibatches, through DQN's jitted TD
  step, ``SACLearner.update`` (temperature tuned and fixed) and
  ``TD3Learner.update`` at ``target_noise=0`` (TD3 with its actor step
  skipped on odd updates, and DDPG's point). Every stat 1e-5 relative and
  the parameters 2e-6 absolute (the PPO learner's 8-step bound; each Adam
  step moves a parameter by about lr).
- TD3's target-policy noise comes from the port's own generator (the JAX
  learner draws it inside jit): clipped to +-``target_noise_clip`` x scale,
  with the clipped normal's std.
- Drivers: DQN, SAC and TD3 (at ``target_noise=0``) are deterministic given
  their seeds (collectors gathered with ``get`` of a list, in order). From
  the JAX driver's initial state, 3 iterations sample the same actions and
  fill the same buffer (bitwise for the discrete ones), and end with
  parameters within 1e-5 and the last update's stats within 1e-4, relative
  or absolute (up to 72 Adam steps each: a 1e-6 difference of the
  parameters moves SAC's Q loss by ~1e-5 relative, seen, and its total
  loss, a sum of O(1) terms of both signs near 0.1, by 2e-5 absolute).
  TD3's actions are 2 tanh(actor) plus noise: after 24 Adam steps the two
  actors' parameters differ by up to 1e-5, which moves an action by up to
  ~2e-5 (seen), so its buffer is held to 1e-4; the warm-up's uniform
  actions are bitwise.
- Checkpoints cross the stacks both ways, bitwise (DQN, SAC, TD3).
- The JAX package's gates on the CPU: SAC >= 100 within 40 iterations
  (``tests/test_rl_sac_offline.py:46``), TD3 >= -700 within 60
  (``tests/test_rl_td3_models.py:45``; stopped at -700), DQN and DDPG
  3 iterations with finite losses (``tests/test_rl.py:116``).
"""

import math

import jax
import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu_torch
from ray_tpu.rl.algorithms import DQNConfig as JDQNConfig
from ray_tpu.rl.algorithms import SACConfig as JSACConfig
from ray_tpu.rl.algorithms import TD3Config as JTD3Config
from ray_tpu.rl.algorithms import sac as jsac
from ray_tpu.rl.algorithms import td3 as jtd3
from ray_tpu_torch.rl import SampleBatch
from ray_tpu_torch.rl import sample_batch as sb
from ray_tpu_torch.rl.algorithms import (DDPGConfig, DQNConfig, SACConfig,
                                         TD3Config)
from ray_tpu_torch.rl.algorithms import sac as tsac
from ray_tpu_torch.rl.algorithms import td3 as ttd3
from ray_tpu_torch.rl.algorithms.dqn import TRANSITION
from ray_tpu_torch.rl.learner import batch_to_device


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for these small ops (faster alone, and the suite
    runs in parallel processes: a thread a core in each oversubscribes the
    cores, and a CPU gate then runs 20x slower or more)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def runtimes():
    """Both packages' in-process runtimes, each started here."""
    ray_tpu.shutdown()
    ray_tpu_torch.shutdown()
    ray_tpu.init(local_mode=True, num_cpus=4)
    ray_tpu_torch.init(num_cpus=4)
    yield
    ray_tpu_torch.shutdown()
    ray_tpu.shutdown()


@pytest.fixture
def trt():
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=4)
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


def _moved(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: np.asarray(a) + 0.1 * rng.standard_normal(
        np.shape(a)).astype(np.float32), jax.device_get(tree))


def _discrete_batch(rng, n=48, obs_dim=4, num_actions=3):
    return SampleBatch({
        sb.OBS: rng.normal(size=(n, obs_dim)).astype(np.float32),
        sb.ACTIONS: rng.integers(0, num_actions, n),
        sb.REWARDS: rng.normal(size=n).astype(np.float32),
        sb.NEXT_OBS: rng.normal(size=(n, obs_dim)).astype(np.float32),
        sb.DONES: (rng.random(n) < 0.2).astype(np.float32),
    })


def _continuous_batch(rng, n=48):
    return SampleBatch({
        sb.OBS: rng.normal(size=(n, 3)).astype(np.float32),
        sb.ACTIONS: rng.uniform(-2, 2, (n, 1)).astype(np.float32),
        sb.REWARDS: rng.normal(size=n).astype(np.float32),
        sb.NEXT_OBS: rng.normal(size=(n, 3)).astype(np.float32),
        sb.DONES: (rng.random(n) < 0.2).astype(np.float32),
    })


def _assert_stats(got, want, rtol=1e-5, atol=1e-7):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], float(want[k]), rtol=rtol,
                                   atol=atol, err_msg=k)


def _max_error(got, want, leaves=None):
    got = jax.tree.leaves(got)
    want = jax.tree.leaves(jax.device_get(want))
    assert len(got) == len(want) and (leaves is None or len(got) == leaves)
    for a, b in zip(got, want):
        assert np.shape(a) == np.shape(b)
    return max(float(np.max(np.abs(np.asarray(a) - np.asarray(b))))
               for a, b in zip(got, want))


def _gate_config(config, **rollouts):
    return (config.environment("CartPole-v1").rollouts(**rollouts)
            .debugging(seed=0))


# ---------------------------------------------------------------------------
# learners
# ---------------------------------------------------------------------------

def test_dqn_td_steps_match_jax(runtimes):
    """DQN's jitted TD step (double-Q: online argmax, target value) against
    the port's, the target apart from the online net."""
    rollouts = dict(num_rollout_workers=1, num_envs_per_worker=2)
    jalgo = _gate_config(JDQNConfig(), **rollouts).build()
    talgo = _gate_config(DQNConfig(), **rollouts).resources(
        device="cpu").build()
    params = _moved(jalgo.params, 1)
    target = _moved(jalgo.params, 2)
    talgo.set_state({"params": params, "target": target})
    jp, jopt = params, jalgo.tx.init(params)
    rng = np.random.default_rng(0)
    for _ in range(4):
        batch = _discrete_batch(rng, num_actions=2)
        jp, jopt, want = jalgo._td_step(jp, target, jopt, dict(batch))
        got = talgo.td_step(batch_to_device(batch, TRANSITION, "cpu"))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
        assert _max_error(talgo.get_state()["params"], jp, 12) <= 2e-6
    # the step leaves the target alone
    assert _max_error(talgo.get_state()["target"], target) == 0.0
    jalgo.stop()
    talgo.stop()


@pytest.mark.parametrize("autotune", [True, False],
                         ids=["autotune", "fixed_alpha"])
def test_sac_learner_updates_match_jax(autotune):
    spec = {"obs_dim": 4, "num_actions": 3, "hiddens": (16, 16)}
    hyper = dict(lr=1e-3, gamma=0.97, tau=0.05, initial_alpha=0.3,
                 autotune_alpha=autotune, target_entropy_scale=0.6, seed=2)
    jl = jsac.SACLearner(spec, **hyper)
    tl = tsac.SACLearner(spec, device="cpu", **hyper)
    jl.params = _moved(jl.params, 1)
    jl.target = _moved(jl.target, 2)
    tl.set_state({"params": jl.params, "target": jl.target})
    log_alpha0 = float(jl.params["log_alpha"])
    rng = np.random.default_rng(3)
    for _ in range(4):
        batch = _discrete_batch(rng)
        _assert_stats(tl.update(batch), jl.update(batch))
        assert _max_error(tl.get_weights(), jl.params, 19) <= 2e-6
        assert _max_error(tl.get_state()["target"], jl.target, 12) <= 2e-6
    log_alpha = float(tl.params["log_alpha"].detach())
    assert (log_alpha == log_alpha0) == (not autotune)


@pytest.mark.parametrize("algo", ["td3", "ddpg"])
def test_td3_learner_updates_match_jax(algo):
    """TD3: the actor step skipped on updates 1 and 3 (policy_delay 2);
    DDPG: one critic, no delay. Both at target_noise=0, where the JAX and
    the port's noise draws are both exactly 0."""
    spec = {"obs_dim": 3, "num_actions": -1, "action_dim": 1}
    hyper = dict(actor_lr=1e-3, critic_lr=2e-3, gamma=0.97, tau=0.05,
                 target_noise=0.0, target_noise_clip=0.0, action_low=-2.0,
                 action_high=2.0, hiddens=(16, 16), seed=4)
    hyper.update(dict(policy_delay=2, twin_q=True) if algo == "td3"
                 else dict(policy_delay=1, twin_q=False))
    jl = jtd3.TD3Learner(spec, **hyper)
    tl = ttd3.TD3Learner(spec, device="cpu", **hyper)
    jl.set_state({"params": _moved(jl.params, 1),
                  "target": _moved(jl.target, 2)})
    tl.set_state(jl.state())
    rng = np.random.default_rng(5)
    q2 = tl.state()["params"]["q2"]
    for i in range(4):
        batch = _continuous_batch(rng)
        actor = tl.get_weights()
        got, want = tl.update(batch), jl.update(batch)
        _assert_stats(got, want)
        for key in ("params", "target"):
            assert _max_error(tl.state()[key], jl.state()[key], 18) <= 2e-6
        skipped = algo == "td3" and i % 2 == 0
        assert (got["actor_loss"] == 0.0) == skipped
        assert (_max_error(tl.get_weights(), actor) == 0.0) == skipped
    if algo == "ddpg":           # one critic: q2 never moves
        assert _max_error(tl.state()["params"]["q2"], q2) == 0.0


def test_td3_target_noise_is_clipped_gaussian():
    """scale 2 (Pendulum's bounds +-2): sigma 0.2 x 2 = 0.4, clipped at
    0.5 x 2 = 1.0 = 2.5 sigma. 200k draws: the clipped share and the std
    within 4 standard errors of the clipped normal's."""
    tl = ttd3.TD3Learner({"obs_dim": 3, "num_actions": -1},
                         target_noise=0.2, target_noise_clip=0.5,
                         action_low=-2.0, action_high=2.0, seed=0,
                         device="cpu")
    n, sigma, bound = 200_000, 0.4, 1.0
    x = tl.target_policy_noise((n, 1)).numpy().ravel().astype(np.float64)
    assert np.abs(x).max() == bound
    a = bound / sigma
    p_clip = math.erfc(a / math.sqrt(2))            # P(|Z| > a)
    share = float(np.mean(np.abs(x) == bound))
    assert abs(share - p_clip) < 4 * math.sqrt(p_clip / n)
    phi = math.exp(-a * a / 2) / math.sqrt(2 * math.pi)
    var = sigma ** 2 * ((1 - p_clip) - 2 * a * phi) + bound ** 2 * p_clip
    assert abs(x.std() - math.sqrt(var)) < 4 * math.sqrt(var / (2 * n))
    assert abs(x.mean()) < 4 * math.sqrt(var / n)
    # seeded seed + 17: the same draws from a fresh learner of the seed
    again = ttd3.TD3Learner({"obs_dim": 3, "num_actions": -1}, seed=0,
                            target_noise=0.2, target_noise_clip=0.5,
                            action_low=-2.0, action_high=2.0, device="cpu")
    np.testing.assert_array_equal(
        again.target_policy_noise((n, 1)).numpy().ravel(), x)


# ---------------------------------------------------------------------------
# drivers against the JAX drivers
# ---------------------------------------------------------------------------

def _same_buffers(tb, jb, atol=0.0):
    assert len(tb) == len(jb) > 0 and sorted(tb._cols) == sorted(jb._cols)
    for k in jb._cols:
        got, want = tb._cols[k][:len(tb)], jb._cols[k][:len(jb)]
        assert got.dtype == want.dtype, k
        if atol and k in (sb.OBS, sb.NEXT_OBS, sb.ACTIONS, sb.REWARDS):
            np.testing.assert_allclose(got, want, rtol=0, atol=atol,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(got, want, err_msg=k)


def test_dqn_driver_matches_jax(runtimes):
    def config(c):
        c = _gate_config(c, num_rollout_workers=2, num_envs_per_worker=4,
                         rollout_fragment_length=32)
        return c.training(learning_starts=256, updates_per_iter=16,
                          epsilon_decay_steps=512, target_update_freq=512)
    jalgo = config(JDQNConfig()).build()
    talgo = config(DQNConfig()).resources(device="cpu").build()
    talgo.set_state(jalgo.get_state())
    for _ in range(3):
        want, got = jalgo.train(), talgo.train()
        assert got["epsilon"] == want["epsilon"]
        np.testing.assert_allclose(got["info/td_loss"],
                                   want["info/td_loss"], rtol=1e-4)
    assert want["epsilon"] < 0.1      # the greedy branch was taken
    _same_buffers(talgo.buffer, jalgo.buffer)
    for key in ("params", "target"):
        assert _max_error(talgo.get_state()[key],
                          jalgo.get_state()[key]) <= 1e-5
    jalgo.stop()
    talgo.stop()


def test_sac_driver_matches_jax(runtimes):
    def config(c):
        c = _gate_config(c, num_envs_per_worker=4,
                         rollout_fragment_length=32)
        return c.training(learning_starts=128, updates_per_iter=24,
                          train_batch_size=64)
    jalgo = config(JSACConfig()).build()
    talgo = config(SACConfig()).resources(device="cpu").build()
    talgo.set_state(jax.device_get(jalgo.get_state()))
    for _ in range(3):
        want, got = jalgo.train(), talgo.train()
        keys = ("q_loss", "policy_loss", "alpha", "entropy", "mean_q",
                "total_loss")
        _assert_stats({k: got[k] for k in keys}, {k: want[k] for k in keys},
                      rtol=1e-4, atol=1e-4)
        assert got["num_env_steps_sampled"] == want["num_env_steps_sampled"]
    _same_buffers(talgo.buffer, jalgo.buffer)
    for key in ("params", "target"):
        assert _max_error(talgo.get_state()[key],
                          jalgo.get_state()[key]) <= 1e-5


def test_td3_driver_matches_jax(runtimes):
    """Two warm-up iterations of uniform actions, then the actor's actions
    plus numpy noise; at target_noise=0 the updates match."""
    def config(c):
        c = c.environment("Pendulum-v1").rollouts(
            num_rollout_workers=1, num_envs_per_worker=8,
            rollout_fragment_length=32).debugging(seed=0)
        return c.training(learning_starts=512, updates_per_iter=24,
                          target_noise=0.0, target_noise_clip=0.0)
    jalgo = config(JTD3Config()).build()
    talgo = config(TD3Config()).resources(device="cpu").build()
    talgo.set_state(jalgo.get_state())
    for _ in range(3):
        want, got = jalgo.train(), talgo.train()
    _assert_stats({k: got[k] for k in ("critic_loss", "actor_loss")},
                  {k: want[k] for k in ("critic_loss", "actor_loss")},
                  rtol=1e-4, atol=1e-4)
    assert got["timesteps_total"] == want["timesteps_total"] == 768
    warm = 512                      # the two warm-up iterations' rows
    np.testing.assert_array_equal(talgo.buffer._cols[sb.ACTIONS][:warm],
                                  jalgo.buffer._cols[sb.ACTIONS][:warm])
    _same_buffers(talgo.buffer, jalgo.buffer, atol=1e-4)
    for key in ("params", "target"):
        assert _max_error(talgo.get_state()["learner"][key],
                          jalgo.get_state()["learner"][key]) <= 1e-5
    talgo.stop()


# ---------------------------------------------------------------------------
# checkpoints and gates
# ---------------------------------------------------------------------------

def _bitwise(a, b):
    la, lb = jax.tree.leaves(a), jax.tree.leaves(jax.device_get(b))
    assert len(la) == len(lb) > 0
    for x, y in zip(la, lb):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape
        assert x.tobytes() == y.tobytes()


CKPT = {
    "dqn": (JDQNConfig, DQNConfig, lambda a: a.get_state()),
    "sac": (JSACConfig, SACConfig, lambda a: a.get_state()),
    "td3": (JTD3Config, TD3Config, lambda a: a.get_state()["learner"]),
}


@pytest.mark.parametrize("algo", sorted(CKPT))
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_checkpoint_restores_across_the_stacks(runtimes, tmp_path, algo,
                                               direction):
    jcls, tcls, state = CKPT[algo]

    def config(c):
        if algo != "td3":
            c = c.environment("CartPole-v1")
        return (c.rollouts(num_rollout_workers=1, num_envs_per_worker=4,
                           rollout_fragment_length=16)
                .training(learning_starts=64, updates_per_iter=4,
                          train_batch_size=32).debugging(seed=1))
    jax_algo = config(jcls()).build()
    port_algo = config(tcls()).resources(device="cpu").build()
    src, dst = ((jax_algo, port_algo) if direction == "jax_to_port"
                else (port_algo, jax_algo))
    for _ in range(2):
        src.train()
    ckpt = src.save(str(tmp_path / "ck"))
    dst.restore(ckpt)
    assert dst.iteration == src.iteration == 2
    _bitwise(state(dst), state(src))
    dst.train()
    for a in (jax_algo, port_algo):
        a.stop()


def test_sac_cartpole_gate(trt, tmp_path):
    """tests/test_rl_sac_offline.py:46: SACConfig's defaults, 8 envs x 32
    steps, seed 0; best mean reward >= 100 within 40 iterations."""
    config = (SACConfig().environment("CartPole-v1")
              .rollouts(num_envs_per_worker=8, rollout_fragment_length=32)
              .resources(device="cpu"))
    config.seed = 0
    algo = config.build()
    best, rewards = 0.0, []
    for _ in range(40):
        r = algo.train().get("episode_reward_mean", 0.0) or 0.0
        rewards.append(round(r, 1))
        best = max(best, r)
        if best >= 100:
            break
    assert best >= 100, f"SAC failed to learn CartPole: {rewards}"
    ckpt = algo.save(str(tmp_path / "ck"))
    algo2 = config.copy().build()
    algo2.restore(ckpt)
    _bitwise(algo2.get_state(), algo.get_state())


def test_td3_pendulum_gate(trt):
    """tests/test_rl_td3_models.py:45: 1 worker x 8 envs x 64 steps, seed
    0; best mean reward >= -700 within 60 iterations (random ~ -1200)."""
    config = (TD3Config().environment("Pendulum-v1")
              .rollouts(num_rollout_workers=1, num_envs_per_worker=8,
                        rollout_fragment_length=64)
              .resources(device="cpu"))
    config.seed = 0
    algo = config.build()
    best, rewards = -1e9, []
    for _ in range(60):
        r = algo.train()["episode_reward_mean"]
        rewards.append(round(r, 1))
        if not np.isnan(r):
            best = max(best, r)
        if best >= -700:
            break
    algo.stop()
    assert best >= -700, f"TD3 failed to learn Pendulum: {rewards}"
    print(f"TD3 gate at iteration {len(rewards)}: {rewards}")


@pytest.mark.parametrize("algo", ["dqn", "ddpg"])
def test_dqn_and_ddpg_run(trt, algo):
    """tests/test_rl.py:116's DQN settings; DDPG on Pendulum alike."""
    if algo == "dqn":
        config = DQNConfig().environment("CartPole-v1")
        config.learning_starts = 128
    else:
        config = DDPGConfig().environment("Pendulum-v1")
        config.learning_starts = 256
        config.updates_per_iter = 32
    config = config.rollouts(num_rollout_workers=1, num_envs_per_worker=8,
                             rollout_fragment_length=32).resources(
        device="cpu")
    algo_ = config.build()
    results = [algo_.train() for _ in range(3)]
    algo_.stop()
    if algo == "dqn":
        eps = [r["epsilon"] for r in results]
        assert eps == sorted(eps, reverse=True) and eps[-1] < eps[0]
        assert np.isfinite(results[-1]["info/td_loss"])
    else:
        assert np.isfinite(results[-1]["critic_loss"])
        assert np.isfinite(results[-1]["actor_loss"])
