"""Port parity: V-trace and the replay buffers, ray_tpu_torch.rl against
ray_tpu.rl on the CPU.

- ``vtrace_returns`` against the JAX function and against the numpy
  reference (``vtrace_reference``, the port's own copy and the JAX
  package's) on seeded [T, N] inputs with dones mid-sequence, rho_bar and
  c_bar below and above 1, T up to 50: within 1e-5 (f32 against f32 and
  float64; the recurrence sums at most 50 terms, each damped by gamma).
  The on-policy case reduces to discounted returns
  (``tests/test_rl_appo_vtrace.py``'s check).
- The port's buffers are copies of the JAX buffers: given the same seed
  and the same adds (across wrap-around), both return identical samples,
  ``weights`` and ``batch_indexes``, and after ``update_priorities`` too.
- A structured batch's ``rollout_shape`` and ``last_obs`` survive the port
  runtime's ``put`` and ``get``.
"""

import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu.rl import replay_buffer as jbuf
from ray_tpu.rl import vtrace as jvtrace
from ray_tpu_torch.rl import RolloutWorker, SampleBatch
from ray_tpu_torch.rl import replay_buffer as tbuf
from ray_tpu_torch.rl import sample_batch as sb
from ray_tpu_torch.rl import vtrace as tvtrace


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for these small ops (faster alone, and the suite
    runs in parallel processes: a thread a core in each oversubscribes the
    cores, and a CPU gate then runs 20x slower or more)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(T, N, seed):
    rng = np.random.default_rng(seed)
    behavior = rng.normal(-1.0, 0.4, (T, N))
    target = behavior + rng.normal(0, 0.5, (T, N))   # off-policy lag
    return (behavior, target, rng.normal(size=(T, N)),
            rng.normal(size=(T, N)),
            (rng.random((T, N)) < 0.1).astype(np.float64),
            rng.normal(size=N))


def _port(inputs, **kw):
    vs, adv = tvtrace.vtrace_returns(
        *(torch.from_numpy(x.astype(np.float32)) for x in inputs), **kw)
    assert not vs.requires_grad and not adv.requires_grad
    return vs.numpy(), adv.numpy()


CASES = {  # (T, N, gamma, rho_bar, c_bar)
    "T17_unit_clips": (17, 5, 0.97, 1.0, 1.0),
    "T32_rho_above_c": (32, 8, 0.99, 1.5, 0.8),
    "T50_tight_clips": (50, 10, 0.99, 0.7, 0.5),
    "T1": (1, 3, 0.9, 1.0, 1.0),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_vtrace_matches_jax_and_the_reference(case):
    T, N, gamma, rho_bar, c_bar = CASES[case]
    inputs = _inputs(T, N, seed=T)
    assert T == 1 or inputs[4].any()          # dones mid-sequence
    kw = dict(gamma=gamma, rho_bar=rho_bar, c_bar=c_bar)
    got = _port(inputs, **kw)
    want_jax = jvtrace.vtrace_returns(
        *(x.astype(np.float32) for x in inputs), **kw)
    want_ref = jvtrace.vtrace_reference(*inputs, **kw)
    assert np.array_equal(tvtrace.vtrace_reference(*inputs, **kw)[0],
                          want_ref[0])
    for g, wj, wr in zip(got, want_jax, want_ref):
        assert g.shape == (T, N)
        np.testing.assert_allclose(g, np.asarray(wj), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(g, wr, rtol=1e-5, atol=1e-5)


def test_vtrace_on_policy_reduces_to_returns():
    """With pi == mu and no truncation binding, vs_t is the discounted
    return with the bootstrapped tail."""
    T, N, gamma = 8, 3, 0.9
    rng = np.random.default_rng(1)
    logp = rng.normal(size=(T, N))
    rewards = rng.normal(size=(T, N))
    values = rng.normal(size=(T, N))
    bootstrap = rng.normal(size=N)
    vs, _ = _port((logp, logp, rewards, values, np.zeros((T, N)),
                   bootstrap), gamma=gamma)
    expect = np.zeros((T, N))
    acc = bootstrap.copy()
    for t in reversed(range(T)):
        acc = rewards[t] + gamma * acc
        expect[t] = acc
    np.testing.assert_allclose(vs, expect, rtol=1e-5)


def _transitions(rng, n, start):
    return SampleBatch({
        sb.OBS: rng.normal(size=(n, 3)).astype(np.float32),
        sb.ACTIONS: rng.integers(0, 4, n),
        sb.REWARDS: np.arange(start, start + n, dtype=np.float32),
        sb.DONES: (rng.random(n) < 0.2).astype(np.float32),
    })


def _same_batches(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("capacity", [64, 100])
def test_replay_buffer_samples_equal_the_jax_buffer(capacity):
    """Adds of 30 rows wrap a 64-row ring twice; the FIFO overwrite and
    every sample match."""
    port, ref = tbuf.ReplayBuffer(capacity, seed=7), \
        jbuf.ReplayBuffer(capacity, seed=7)
    rng = np.random.default_rng(0)
    for i in range(6):
        batch = _transitions(rng, 30, 30 * i)
        port.add(batch)
        ref.add(batch)
        assert len(port) == len(ref) == min(capacity, 30 * (i + 1))
        _same_batches(port.sample(16), ref.sample(16))
    _same_batches(SampleBatch(port._cols), SampleBatch(ref._cols))
    assert port._next == ref._next


def test_prioritized_buffer_equals_the_jax_buffer():
    port = tbuf.PrioritizedReplayBuffer(50, alpha=0.7, beta=0.5, seed=3)
    ref = jbuf.PrioritizedReplayBuffer(50, alpha=0.7, beta=0.5, seed=3)
    rng = np.random.default_rng(1)
    for i in range(5):                      # 5 x 20 rows wrap the 50 rows
        batch = _transitions(rng, 20, 20 * i)
        port.add(batch)
        ref.add(batch)
        got, want = port.sample(24), ref.sample(24)
        _same_batches(got, want)
        assert got["weights"].dtype == np.float32
        # the learner's new priorities, larger than the running max
        prio = rng.normal(size=24) * (i + 1)
        port.update_priorities(got["batch_indexes"], prio)
        ref.update_priorities(want["batch_indexes"], prio)
        np.testing.assert_array_equal(port._prio, ref._prio)
        assert port._max_prio == ref._max_prio
    _same_batches(port.sample(40), ref.sample(40))


def test_structured_batch_survives_put_and_get():
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=2)
    try:
        w = RolloutWorker("CartPole-v1",
                          {"obs_dim": 4, "num_actions": 2, "hiddens": (16,)},
                          rollout_length=5, num_envs=3, gamma=0.99, lam=0.95,
                          device="cpu")
        params = w.module.init(torch.Generator().manual_seed(0),
                               device="cpu")
        batch = w.sample(params, structured=True)
        assert batch.rollout_shape == (5, 3)
        assert batch.last_obs.shape == (3, 4)
        back = ray_tpu_torch.get(ray_tpu_torch.put(batch))
        assert back.rollout_shape == (5, 3)
        np.testing.assert_array_equal(back.last_obs, batch.last_obs)
        _same_batches(back, batch)
    finally:
        ray_tpu_torch.shutdown()
