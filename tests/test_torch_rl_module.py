"""Port parity: the RL module catalog, the envs and GAE, ray_tpu_torch.rl
against ``ray_tpu.rl`` on the CPU.

Weights come from the JAX module's own ``init``, with every leaf moved by a
seeded numpy draw (the init zeroes every bias, which would hide a bias
wrongly applied), through ``rl_params_from_jax``; observations, states,
dones and actions are seeded numpy. Small sizes: MLP towers (16, 8); a CNN
on 12x10x3 frames (not square, and more than one channel and position after
the convolutions, so that a transposed or NCHW flatten shows); an LSTM of 8
over 7 steps; a GTrXL of 2 blocks, 4 heads, width 16 and memory 3 over 6
steps (longer than the memory, so that its shift shows).

Tolerances: forwards, final states and ``logp_entropy`` within 1e-5 at f32,
absolute below magnitude 1 and relative above (the same products summed in
another order; GTrXL's 2 blocks and the LSTM's 7 steps stay well inside);
the envs and ``compute_gae`` exactly equal (the same numpy code); sampled
actions' frequencies within 4 sigma of softmax(logits) over 20,000 draws,
and the gaussian's sample mean within 4 standard errors of its mean (its
sample std within 4 of the std's).
"""

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ray_tpu.rl import env as jenv
from ray_tpu.rl import module as jmod
from ray_tpu.rl import rollout as jroll
from ray_tpu_torch.rl import env as tenv
from ray_tpu_torch.rl import module as tmod
from ray_tpu_torch.rl import rollout as troll
from ray_tpu_torch.rl import rl_params_from_jax

TOL = 1e-5

SPECS = {
    "mlp": {"obs_dim": 6, "num_actions": 3, "hiddens": (16, 8)},
    "mlp_gauss1": {"obs_dim": 6, "num_actions": -1, "hiddens": (16, 8)},
    "mlp_gauss3": {"obs_dim": 6, "num_actions": -1, "action_dim": 3,
                   "hiddens": (16, 8)},
    "cnn": {"encoder": "cnn", "obs_dim": 12 * 10 * 3, "num_actions": 4,
            "obs_shape": (12, 10, 3), "filters": ((4, 3, 2), (6, 3, 1)),
            "hiddens": (16,)},
    "lstm": {"encoder": "lstm", "obs_dim": 5, "num_actions": 3,
             "hidden_size": 8},
    "gtrxl": {"encoder": "gtrxl", "obs_dim": 5, "num_actions": 3,
              "hidden_size": 16, "num_layers": 2, "num_heads": 4,
              "memory_len": 3},
}
FLAT = ("mlp", "mlp_gauss1", "mlp_gauss3", "cnn")
SEQ = ("lstm", "gtrxl")


def jax_params(name, seed=0):
    """(JAX module, its params as numpy with every leaf moved off its
    init, port module, port params on the CPU)."""
    jm = jmod.make_module(SPECS[name])
    rng = np.random.default_rng(seed)
    params = jax.tree.map(
        lambda a: np.asarray(a) + 0.1 * rng.standard_normal(np.shape(a))
        .astype(np.float32), jm.init(jax.random.PRNGKey(seed)))
    tm = tmod.make_module(SPECS[name])
    return jm, params, tm, rl_params_from_jax(params, tm, device="cpu")


def _obs(name, batch, seed=1):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((batch, SPECS[name]["obs_dim"])) \
        .astype(np.float32)


def _err(got, want):
    """Largest |got - want| / max(1, |want|): absolute below 1, relative
    above (a logp of -81 holds 8e-6 in one f32 ulp)."""
    want = np.asarray(want)
    diff = np.abs(np.asarray(got.detach()) - want)
    return float(np.max(diff / np.maximum(1.0, np.abs(want))))


@pytest.mark.parametrize("name", FLAT)
def test_apply_matches_jax(name):
    jm, params, tm, tp = jax_params(name)
    obs = _obs(name, 5)
    jl, jv = jm.apply(params, obs)
    tl, tv = tm.apply(tp, obs)
    assert tl.shape == jl.shape and tv.shape == jv.shape
    assert _err(tl, jl) <= TOL and _err(tv, jv) <= TOL


@pytest.mark.parametrize("name", FLAT)
def test_logp_entropy_and_greedy_match_jax(name):
    jm, params, tm, tp = jax_params(name)
    obs = _obs(name, 5)
    rng = np.random.default_rng(2)
    if jm.num_actions > 0:
        actions = rng.integers(0, jm.num_actions, 5).astype(np.float32)
    else:
        shape = (5,) if jm.action_dim == 1 else (5, jm.action_dim)
        actions = rng.standard_normal(shape).astype(np.float32)
    want = jm.logp_entropy(params, obs, actions)
    got = tm.logp_entropy(tp, obs, actions)
    for g, w in zip(got, want):
        assert g.shape == w.shape and _err(g, w) <= TOL
    jg = np.asarray(jm.greedy_actions(params, obs))
    tg = tm.greedy_actions(tp, obs).numpy()
    if jm.num_actions > 0:
        np.testing.assert_array_equal(tg, jg)
    else:
        assert tg.shape == jg.shape and _err(torch.from_numpy(tg), jg) <= TOL


def _seq_inputs(name, T, B, seed=3):
    rng = np.random.default_rng(seed)
    obs = rng.standard_normal((T, B, SPECS[name]["obs_dim"])) \
        .astype(np.float32)
    dones = (rng.random((T, B)) < 0.3).astype(np.float32)
    dones[1, 0] = 1.0               # env 0 resets before step 2
    jm = jmod.make_module(SPECS[name])
    if name == "lstm":
        state = tuple(rng.standard_normal((B, jm.hidden_size))
                      .astype(np.float32) for _ in range(2))
    else:
        state = rng.standard_normal((jm.layers, B, jm.mem, jm.h)) \
            .astype(np.float32)
    return obs, dones, state


def _to_torch(state):
    if isinstance(state, tuple):
        return tuple(torch.from_numpy(s) for s in state)
    return torch.from_numpy(state)


@pytest.mark.parametrize("with_dones", [False, True],
                         ids=["no_dones", "dones"])
@pytest.mark.parametrize("name", SEQ)
def test_apply_seq_matches_jax(name, with_dones):
    jm, params, tm, tp = jax_params(name)
    obs, dones, state = _seq_inputs(name, T=7 if name == "lstm" else 6, B=4)
    d = dones if with_dones else None
    jl, jv, js = jm.apply_seq(params, obs, state, d)
    tl, tv, ts = tm.apply_seq(tp, obs, _to_torch(state), d)
    assert tl.shape == jl.shape and tv.shape == jv.shape
    assert _err(tl, jl) <= TOL and _err(tv, jv) <= TOL
    for g, w in zip(jax.tree.leaves(ts), jax.tree.leaves(js)):
        assert g.shape == w.shape and _err(g, w) <= TOL


@pytest.mark.parametrize("name", SEQ)
def test_dones_reset_the_state_before_the_next_step(name):
    """A done at t makes step t + 1 start from the zero state: its outputs
    equal a fresh sequence's first step from the initial state."""
    _, _, tm, tp = jax_params(name)
    obs, _, state = _seq_inputs(name, T=3, B=2)
    dones = np.zeros((3, 2), np.float32)
    dones[0, 1] = 1.0
    logits, _, _ = tm.apply_seq(tp, obs, _to_torch(state), dones)
    fresh, _, _ = tm.apply_seq(tp, obs[1:2, 1:], tm.initial_state(
        1, device="cpu"))
    assert _err(logits[1, 1:], fresh[0].numpy()) <= TOL
    # and env 0, never done, kept its state
    state0 = _to_torch(state)
    state0 = state0[:, :1] if name == "gtrxl" else tuple(
        t[:1] for t in state0)
    kept, _, _ = tm.apply_seq(tp, obs[:2, :1], state0)
    assert _err(logits[1, :1], kept[1].numpy()) <= TOL


def test_cnn_flattens_in_nhwc_order():
    """The features that the heads see are the JAX module's NHWC flatten of
    the conv output; an NCHW flatten of the same values differs."""
    jm, params, tm, tp = jax_params("cnn")
    obs = _obs("cnn", 3)
    want = np.asarray(jm._encode(params, obs))
    got = tm._features(tp, obs)
    assert _err(got, want) <= TOL
    x = torch.from_numpy(obs).reshape(3, 12, 10, 3).permute(0, 3, 1, 2)
    for layer, (_, _, s) in zip(tp["conv"], tm.filters):
        x = torch.relu(F.conv2d(x, layer["w"], layer["b"], stride=s))
    nchw = x.reshape(3, -1)
    assert x.shape[1] > 1 and x.shape[2] * x.shape[3] > 1
    assert _err(nchw, want) > 100 * TOL


def test_converter_transposes_conv_kernels_and_raises_on_misfit():
    jm, params, tm, tp = jax_params("cnn")
    w = params["conv"][0]["w"]                      # HWIO
    np.testing.assert_array_equal(tp["conv"][0]["w"].numpy(),
                                  np.transpose(w, (3, 2, 0, 1)))
    other = tmod.make_module({**SPECS["cnn"], "hiddens": (8,)})
    with pytest.raises(ValueError, match="pi/0/w"):
        rl_params_from_jax(params, other, device="cpu")
    with pytest.raises(ValueError, match="missing"):
        rl_params_from_jax({"pi": params["pi"]}, tm, device="cpu")


def test_port_init_follows_the_jax_distributions():
    """Shapes and keys as the JAX tree; He-normal MLP and conv weights, zero
    biases, sqrt(1/hidden) LSTM weights, gate bias 2.0."""
    for name in SPECS:
        jm = jmod.make_module(SPECS[name])
        tm = tmod.make_module(SPECS[name])
        want = rl_params_from_jax(jax.tree.map(np.asarray, jm.init(
            jax.random.PRNGKey(0))), tm, device="cpu")
        tp = tm.init(torch.Generator().manual_seed(0), device="cpu")
        shapes = lambda tree: jax.tree.map(lambda t: tuple(t.shape), tree)
        assert shapes(tp) == shapes(want)
    big = tmod.make_module({"encoder": "gtrxl", "obs_dim": 64,
                            "num_actions": 2, "hidden_size": 128})
    tp = big.init(torch.Generator().manual_seed(0), device="cpu")
    assert abs(tp["embed"][0]["w"].std().item() - (2 / 64) ** 0.5) < 0.01
    assert abs(tp["blocks"][0]["wq"].std().item() - (1 / 128) ** 0.5) < 0.005
    assert torch.all(tp["blocks"][0]["gate_ff"]["bg"] == 2.0)
    assert torch.all(tp["embed"][0]["b"] == 0.0)
    lstm = tmod.lstm_init(torch.Generator().manual_seed(0), 64, 128,
                          device="cpu")
    assert abs(lstm["wh"].std().item() - (1 / 128) ** 0.5) < 0.005


def test_sample_actions_logp_is_logp_of_its_actions():
    for name in ("mlp", "mlp_gauss1", "mlp_gauss3", "cnn"):
        _, _, tm, tp = jax_params(name)
        obs = _obs(name, 64)
        gen = torch.Generator().manual_seed(5)
        actions, logp, value = tm.sample_actions(tp, obs, gen)
        want_logp, _, want_value = tm.logp_entropy(tp, obs, actions)
        assert _err(logp, want_logp.numpy()) <= TOL
        assert _err(value, want_value.numpy()) <= TOL


def test_categorical_draws_follow_softmax():
    n = 20_000
    _, _, tm, tp = jax_params("mlp")
    obs = np.repeat(_obs("mlp", 1), n, axis=0)
    actions, _, _ = tm.sample_actions(tp, obs,
                                      torch.Generator().manual_seed(6))
    p = torch.softmax(tm.apply(tp, obs[:1])[0][0], -1).numpy()
    freq = np.bincount(actions.numpy(), minlength=3) / n
    sigma = np.sqrt(p * (1 - p) / n)
    assert np.all(np.abs(freq - p) <= 4 * sigma), (freq, p)


def test_gaussian_draws_follow_mean_and_std():
    n = 20_000
    _, _, tm, tp = jax_params("mlp_gauss3")
    obs = np.repeat(_obs("mlp_gauss3", 1), n, axis=0)
    actions, _, _ = tm.sample_actions(tp, obs,
                                      torch.Generator().manual_seed(7))
    mean, log_std = tm._mean_logstd(tm.apply(tp, obs[:1])[0][0])
    std = log_std.exp()
    got_mean = actions.mean(0)
    assert torch.all((got_mean - mean).abs() <= 4 * std / n ** 0.5)
    assert torch.all((actions.std(0) / std - 1).abs() <= 4 / (2 * n) ** 0.5)


@pytest.mark.parametrize("env", ["CartPole-v1", "Pendulum-v1"])
def test_envs_step_as_the_jax_package(env):
    je = jenv.make_env(env, num_envs=8, seed=11)
    te = tenv.make_env(env, num_envs=8, seed=11)
    np.testing.assert_array_equal(te.vector_reset(seed=11),
                                  je.vector_reset(seed=11))
    rng = np.random.default_rng(12)
    for _ in range(300):
        if je.num_actions > 0:
            a = rng.integers(0, 2, 8).astype(np.int32)
        else:
            a = rng.uniform(-3, 3, 8).astype(np.float32)
        got, want = te.vector_step(a), je.vector_step(a)
        for g, w in zip(got[:3], want[:3]):
            np.testing.assert_array_equal(g, w)
    assert te.completed_returns == je.completed_returns
    assert len(te.completed_returns) > 0
    assert tenv.episode_stats_of(te) == jenv.episode_stats_of(je)


def test_vector_env_base_has_its_stubs():
    with pytest.raises(NotImplementedError):
        tenv.VectorEnv().vector_reset()
    with pytest.raises(NotImplementedError):
        tenv.VectorEnv().vector_step(np.zeros(1))
    with pytest.raises(TypeError):
        tenv.make_env(lambda num_envs, seed: object(), num_envs=1)


def test_compute_gae_equals_the_jax_package():
    rng = np.random.default_rng(13)
    T, N = 17, 5
    rewards = rng.standard_normal((T, N)).astype(np.float32)
    values = rng.standard_normal((T, N)).astype(np.float32)
    dones = (rng.random((T, N)) < 0.2).astype(np.float32)
    last = rng.standard_normal(N).astype(np.float32)
    got = troll.compute_gae(rewards, values, dones, last, 0.99, 0.95)
    want = jroll.compute_gae(rewards, values, dones, last, 0.99, 0.95)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
