"""Port parity: ES and the contextual bandits, ray_tpu_torch.rl.algorithms
against ray_tpu.rl.algorithms on the CPU (the port with ``device="cpu"``).

Each stack runs in its own in-process runtime, started here
(``ray_tpu.init(local_mode=True)`` and ``ray_tpu_torch.init()``).

- ES: theta is the policy's leaves in ``jax.tree.leaves``' order (dict
  keys sorted at every level, so ``b`` before ``w`` and ``pi`` before
  ``vf``). ``_flatten`` of weights carried over from JAX equals JAX's
  bitwise, and ``_unflatten`` inverts it. One ``training_step`` from JAX's
  theta with the same seed: the numpy perturbations land on the same
  weights, the greedy CartPole episodes (f32 forwards within ~1e-6 of each
  other, argmax of two logits) return the same fitness, and theta agrees
  within 1e-6. The gate (``tests/test_rl_breadth.py:64``): above max(40,
  first + 10) after 12 more iterations with 2 workers, seed 3; ``stop()``
  then leaves no runtime thread after ``shutdown()``.
- Bandits (numpy on the host, as in JAX): UCB and TS regret halves and ends
  below 0.1 (``:107``), and the per-iteration ``info/regret_per_step``
  sequence equals JAX's exactly (the same numpy draws and arithmetic).
"""

import threading

import jax
import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu_torch
from ray_tpu.rl.algorithms import Bandit as JBandit
from ray_tpu.rl.algorithms import BanditConfig as JBanditConfig
from ray_tpu.rl.algorithms import ContextualBanditEnv as JContextualBanditEnv
from ray_tpu.rl.algorithms import ESConfig as JESConfig
from ray_tpu.rl.algorithms import es as jes
from ray_tpu.rl.module import RLModule as JRLModule
from ray_tpu_torch.core.runtime_local import THREAD_PREFIX
from ray_tpu_torch.models.convert import (rl_params_from_jax,
                                          rl_params_to_numpy)
from ray_tpu_torch.rl import RLModule
from ray_tpu_torch.rl.algorithms import (ES, Bandit, BanditConfig,
                                         ContextualBanditEnv, ESConfig)
from ray_tpu_torch.rl.algorithms import es as tes
from ray_tpu_torch.rl.learner import _named_leaves


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


def _es_configs(seed=3, perturbations=6, horizon=120, workers=2):
    configs = []
    for cls in (JESConfig, ESConfig):
        c = cls()
        c.env = "CartPole-v1"
        c.rollouts(num_rollout_workers=workers)
        c.num_perturbations = perturbations
        c.episode_horizon = horizon
        configs.append(c.debugging(seed=seed))
    configs[1].resources(device="cpu")
    return configs


def _runtime_threads():
    return [t.name for t in threading.enumerate()
            if t.name.startswith(THREAD_PREFIX) and t.is_alive()]


# ---------------------------------------------------------------------------
# ES
# ---------------------------------------------------------------------------

def test_es_flatten_matches_jax_bitwise():
    jmod = JRLModule(obs_dim=4, num_actions=2, hiddens=(8, 6))
    rng = np.random.default_rng(0)
    jparams = jax.tree.map(lambda a: np.asarray(a) + rng.standard_normal(
        np.shape(a)).astype(np.float32), jax.device_get(
            jmod.init(jax.random.PRNGKey(0))))
    module = RLModule(obs_dim=4, num_actions=2, hiddens=(8, 6))
    tparams = rl_params_to_numpy(rl_params_from_jax(jparams, module, "cpu"))
    # the port's own init builds {"pi", "vf"} of {"w", "b"}: a walk in
    # insertion order would give another layout than JAX's
    own = rl_params_to_numpy(module.init(torch.Generator().manual_seed(1),
                                         "cpu"))
    assert list(own["pi"][0]) == ["w", "b"]
    assert tes._flatten(own).tobytes() == jes._flatten(own).tobytes()
    flat = tes._flatten(tparams)
    want = jes._flatten(jparams)
    assert flat.dtype == want.dtype == np.float32
    assert flat.tobytes() == want.tobytes()
    # the first leaf is pi's first bias, then its first weight
    np.testing.assert_array_equal(flat[:8], jparams["pi"][0]["b"])
    # _unflatten inverts it, leaf by path, in the template's dtypes
    back = tes._unflatten(tparams, flat)
    got, ref = _named_leaves(back), _named_leaves(tparams)
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype
        assert got[k].tobytes() == ref[k].tobytes(), k
    assert tes._flatten(back).tobytes() == flat.tobytes()


def test_es_training_step_matches_jax(runtimes):
    jcfg, tcfg = _es_configs()
    jalgo, talgo = jcfg.build(), tcfg.build()
    theta = jalgo.theta.copy()
    talgo.set_state({"theta": theta.copy()})
    want, got = jalgo.train(), talgo.train()
    for k in ("episode_reward_mean", "episode_reward_max"):
        assert got[k] == want[k], k
    assert 0 < got["episode_reward_mean"] < 120
    assert np.max(np.abs(talgo.theta - jalgo.theta)) <= 1e-6
    assert np.max(np.abs(talgo.theta - theta)) > 1e-3   # it moved
    # the policy's weights come back in the JAX layout
    jp, tp = jalgo.get_policy_params(), talgo.get_policy_params()
    assert sorted(_named_leaves(tp)) == sorted(_named_leaves(jp))
    jalgo.stop()
    talgo.stop()


def test_es_improves_cartpole(trt):
    _, cfg = _es_configs(perturbations=12, horizon=200)
    algo = cfg.build()
    assert isinstance(algo, ES)
    first = algo.train()["episode_reward_mean"]
    last = {}
    for _ in range(12):
        last = algo.train()
    assert last["episode_reward_mean"] > max(40.0, first + 10.0), \
        (first, last)
    state = algo.get_state()
    algo.set_state(state)
    assert algo.get_state()["theta"].tobytes() == state["theta"].tobytes()
    algo.stop()
    trt.shutdown()
    assert not _runtime_threads()


# ---------------------------------------------------------------------------
# bandits
# ---------------------------------------------------------------------------

def _bandit(cls, config_cls, env_cls, exploration):
    cfg = config_cls()
    cfg.exploration = exploration
    cfg.env_fn = lambda: env_cls(num_arms=4, context_dim=8, noise=0.05,
                                 seed=4)
    cfg.debugging(seed=4)
    return cls(cfg)


@pytest.mark.parametrize("exploration", ["ucb", "ts"])
def test_bandit_regret_shrinks(exploration):
    algo = _bandit(Bandit, BanditConfig, ContextualBanditEnv, exploration)
    first = algo.train()["info/regret_per_step"]
    for _ in range(8):
        last = algo.train()
    assert last["info/regret_per_step"] < first * 0.5, (first, last)
    assert last["info/regret_per_step"] < 0.1


@pytest.mark.parametrize("exploration", ["ucb", "ts"])
def test_bandit_regret_sequence_equals_jax(exploration):
    jalgo = _bandit(JBandit, JBanditConfig, JContextualBanditEnv,
                    exploration)
    talgo = _bandit(Bandit, BanditConfig, ContextualBanditEnv, exploration)
    for _ in range(9):
        want, got = jalgo.train(), talgo.train()
        for k in ("info/regret_per_step", "info/regret_total",
                  "episode_reward_mean", "timesteps_total"):
            assert got[k] == want[k], k
    for k in ("A", "b"):
        assert talgo.get_state()[k].tobytes() == \
            jalgo.get_state()[k].tobytes()
