"""Port parity: ``PPOLearner``, ray_tpu_torch.rl against
``ray_tpu.rl.learner.PPOLearner`` on the CPU, and PPO learning CartPole.

Both learners start from the same weights (the JAX learner's init, moved
off it by a seeded draw, into the port through ``set_weights``) and a fresh
Adam state; the train batch is seeded numpy with ratios both inside and
outside the clip range and value errors both inside and outside
``vf_clip_param``. One SGD step goes through the JAX learner's own jitted
``_sgd``; a whole ``update`` runs 2 epochs of 4 minibatches (69 rows at
minibatch 16: the remainder of 5 is dropped) through each learner's own
numpy ``default_rng(seed)``.

Tolerances, at f32: the loss and every stat 1e-5 relative; the updated
parameters 1e-6 absolute after one step (each moves by about lr = 1e-3,
Adam's first step being ~lr · sign(g)) and 2e-6 after the 8 steps of an
update. f32 was enough: no parameter's gradient sat near Adam's eps, where
its first step would flip with the rounding.

Regressions for two traps: advantages are normalised with the population
std (jnp's ``std``, ddof 0), which a 6-row minibatch tells from torch's
unbiased default; and optax's global-norm clip scales by ``max_norm / norm``
exactly, which a gradient of norm 2e-4 clipped to 1e-4 tells from
``clip_grad_norm_``'s ``max_norm / (norm + 1e-6)``.

The learning test is PPO's own gate (``tests/test_rl.py``): 2 workers x 16
CartPole envs x 64 steps, hiddens (64, 64), lr 3e-4, 8 epochs of minibatch
256, entropy 0.01, seed 0; best mean reward >= 120 within 25 iterations,
with the workers and the learner in-process in ``PPO.training_step``'s
order.
"""

import jax
import numpy as np
import optax
import pytest
import torch

from ray_tpu.rl import learner as jlearner
from ray_tpu_torch.rl import (PPOLearner, RolloutWorker, SampleBatch,
                              make_module)
from ray_tpu_torch.rl import learner as tlearner
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


SPECS = {
    "mlp": {"obs_dim": 6, "num_actions": 3, "hiddens": (16, 8)},
    "mlp_gauss3": {"obs_dim": 6, "num_actions": -1, "action_dim": 3,
                   "hiddens": (16, 8)},
    "cnn": {"encoder": "cnn", "obs_dim": 12 * 10 * 3, "num_actions": 4,
            "obs_shape": (12, 10, 3), "filters": ((4, 3, 2), (6, 3, 1)),
            "hiddens": (16,)},
}
HYPER = dict(lr=1e-3, clip_param=0.2, vf_clip_param=2.0, vf_loss_coeff=0.5,
             entropy_coeff=0.01, grad_clip=0.5, seed=3)


def _pair(name, **kw):
    """(JAX learner, port learner) holding the same weights."""
    hyper = {**HYPER, **kw}
    jl = jlearner.PPOLearner(SPECS[name], **hyper)
    rng = np.random.default_rng(1)
    weights = jax.tree.map(
        lambda a: np.asarray(a) + 0.1 * rng.standard_normal(np.shape(a))
        .astype(np.float32), jl.get_weights())
    jl.set_weights(weights)
    tl = PPOLearner(SPECS[name], device="cpu", **hyper)
    tl.set_weights(weights)
    return jl, tl


def _batch(name, count, seed=2):
    """A train batch whose logp sit near the policy's own (ratios inside
    and outside 1 ± clip) and whose value targets sit near and far from
    vf_preds (errors inside and outside vf_clip_param)."""
    spec = SPECS[name]
    rng = np.random.default_rng(seed)
    obs = rng.standard_normal((count, spec["obs_dim"])).astype(np.float32)
    module = make_module(spec)
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
        sb.REWARDS: f32(rng.standard_normal(count)),
        sb.DONES: f32(rng.random(count) < 0.1),
    })


def _leaf_errors(port_weights, jax_weights):
    return [float(np.max(np.abs(a - np.asarray(b)))) for a, b in
            zip(jax.tree.leaves(port_weights), jax.tree.leaves(jax_weights))]


def _assert_stats(got, want):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], float(want[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)


@pytest.mark.parametrize("name", sorted(SPECS))
def test_one_sgd_step_matches_jax(name):
    jl, tl = _pair(name)
    batch = _batch(name, 32)
    params, _, want = jl._sgd(jl.params, jl.tx.init(jl.params),
                              dict(batch))
    got = tl.sgd_step({k: torch.from_numpy(batch[k])
                       for k in tlearner.LOSS_COLUMNS})
    _assert_stats({k: float(v) for k, v in got.items()}, want)
    errors = _leaf_errors(tl.get_weights(), jax.device_get(params))
    assert len(errors) == len(jax.tree.leaves(params))
    assert max(errors) <= 1e-6, errors


@pytest.mark.parametrize("name", ["mlp", "cnn"])
def test_update_of_two_epochs_matches_jax(name):
    jl, tl = _pair(name, num_sgd_iter=2, sgd_minibatch_size=16)
    batch = _batch(name, 69)
    want = jl.update(batch)
    got = tl.update(batch)
    _assert_stats(got, want)
    errors = _leaf_errors(tl.get_weights(), jl.get_weights())
    assert max(errors) <= 2e-6, errors
    # the second update draws the next permutations of the same rng
    _assert_stats(tl.update(batch), jl.update(batch))


def test_advantages_use_the_population_std():
    jl, tl = _pair("mlp")
    batch = _batch("mlp", 6)
    _, _, want = jl._sgd(jl.params, jl.tx.init(jl.params), dict(batch))
    cols = {k: torch.from_numpy(batch[k]) for k in tlearner.LOSS_COLUMNS}
    with torch.no_grad():
        _, got = tlearner.ppo_loss(tl.module, tl.params, cols, **{
            k: HYPER[k] for k in ("clip_param", "vf_clip_param",
                                  "vf_loss_coeff", "entropy_coeff")})
    np.testing.assert_allclose(got["policy_loss"].item(),
                               float(want["policy_loss"]), rtol=1e-5)
    # the unbiased std would miss by far more than that tolerance
    with torch.no_grad():
        logp, _, _ = tl.module.logp_entropy(tl.params, cols[sb.OBS],
                                            cols[sb.ACTIONS])
    adv = cols[sb.ADVANTAGES]
    adv = (adv - adv.mean()) / (adv.std() + 1e-8)
    ratio = torch.exp(logp - cols[sb.ACTION_LOGP])
    unbiased = -torch.minimum(ratio * adv,
                              torch.clamp(ratio, 0.8, 1.2) * adv).mean()
    assert abs(float(unbiased) - float(want["policy_loss"])) > \
        1e-2 * abs(float(want["policy_loss"]))


def test_global_norm_clip_is_optax_not_clip_grad_norm():
    rng = np.random.default_rng(4)
    leaves = [rng.standard_normal(s).astype(np.float32) for s in
              ((5, 3), (3,), (7,))]
    for norm, max_norm in ((2e-4, 1e-4), (0.3, 0.5), (4.0, 0.5)):
        scaled = [a * np.float32(norm / np.sqrt(sum((b ** 2).sum()
                                                    for b in leaves)))
                  for a in leaves]
        tx = optax.clip_by_global_norm(max_norm)
        want, _ = tx.update(scaled, tx.init(scaled))
        grads = [torch.from_numpy(a.copy()) for a in scaled]
        got_norm = tlearner.clip_by_global_norm_(grads, max_norm)
        assert abs(float(got_norm) - norm) <= 1e-6 * norm
        for g, w in zip(grads, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                       rtol=1e-6, atol=0)
        if norm < max_norm:
            for g, a in zip(grads, scaled):
                np.testing.assert_array_equal(g.numpy(), a)
    # torch's clip_grad_norm_ misses optax by 1e-6 / norm relative: 5e-3 here
    ps = [torch.nn.Parameter(torch.zeros(a.shape)) for a in leaves]
    scaled = [a * np.float32(2e-4 / np.sqrt(sum((b ** 2).sum()
                                                for b in leaves)))
              for a in leaves]
    for p, a in zip(ps, scaled):
        p.grad = torch.from_numpy(a.copy())
    torch.nn.utils.clip_grad_norm_(ps, 1e-4)
    tx = optax.clip_by_global_norm(1e-4)
    want, _ = tx.update(scaled, tx.init(scaled))
    rel = max(float(np.max(np.abs(p.grad.numpy() - np.asarray(w))
                           / np.abs(np.asarray(w)))) for p, w in
              zip(ps, want))
    assert rel > 1e-3


def test_weights_cross_between_the_stacks():
    jl, tl = _pair("cnn")
    tl.update(_batch("cnn", 40))
    jl.set_weights(tl.get_weights())
    obs = _batch("cnn", 4)[sb.OBS]
    want_logits, want_value = jl.module.apply(jl.params, obs)
    got_logits, got_value = tl.module.apply(tl.params, obs)
    np.testing.assert_allclose(got_logits.detach().numpy(), want_logits,
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(got_value.detach().numpy(), want_value,
                               rtol=0, atol=1e-5)
    # get_weights is numpy on the host, in the JAX layout (HWIO kernels)
    w = tl.get_weights()
    assert isinstance(w["conv"][0]["w"], np.ndarray)
    assert w["conv"][0]["w"].shape == (3, 3, 3, 4)


def test_empty_batch_and_oversized_minibatch():
    _, tl = _pair("mlp", sgd_minibatch_size=1000, num_sgd_iter=1)
    assert tl.update(SampleBatch()) == {}
    before = tl.get_weights()
    stats = tl.update(_batch("mlp", 20))     # clamps to one minibatch of 20
    assert set(stats) == {"policy_loss", "vf_loss", "entropy", "kl",
                          "total_loss"}
    assert all(isinstance(v, float) for v in stats.values())
    assert max(_leaf_errors(tl.get_weights(), before)) > 0


def test_ppo_learns_cartpole_on_the_cpu():
    """The JAX package's learning gate, with the port's workers and learner
    in-process."""
    spec = {"obs_dim": 4, "num_actions": 2, "hiddens": (64, 64)}
    learner = PPOLearner(spec, lr=3e-4, num_sgd_iter=8,
                         sgd_minibatch_size=256, entropy_coeff=0.01,
                         seed=0, device="cpu")
    workers = [RolloutWorker("CartPole-v1", spec, 64, 16, 0.99, 0.95,
                             seed=1000 * (i + 1), device="cpu")
               for i in range(2)]
    weights, best, rewards = learner.get_weights(), 0.0, []
    for _ in range(25):
        batch = SampleBatch.concat_samples([w.sample(weights)
                                            for w in workers])
        learner.update(batch)
        weights = learner.get_weights()
        means = [s["episode_reward_mean"] for s in
                 (w.episode_stats() for w in workers) if s["episodes"] > 0]
        r = float(np.mean(means)) if means else float("nan")
        rewards.append(r)
        if not np.isnan(r):
            best = max(best, r)
        if best >= 120:
            break
    assert best >= 120, f"PPO failed to learn CartPole: {rewards}"


def test_seeded_init_draws_on_the_host():
    """The learners draw their initial weights from a CPU generator and move
    the tree to their device, so a seed gives the same weights on every
    device, as a JAX PRNGKey does on every backend."""
    calls = []

    def init(gen, dev):
        calls.append((gen.device, dev))
        return {"pi": [{"w": torch.empty(3, 2).normal_(generator=gen)}]}

    moved = tlearner.seeded_init(init, 5, "meta")
    assert calls == [(torch.device("cpu"), "cpu")]
    assert moved["pi"][0]["w"].device.type == "meta"
    want = torch.empty(3, 2).normal_(generator=torch.Generator().manual_seed(5))
    assert torch.equal(tlearner.seeded_init(init, 5, "cpu")["pi"][0]["w"],
                       want)
