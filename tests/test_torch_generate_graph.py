"""The port's decode loop as one device program, held to the JAX package on
the CPU.

On the card ``generate`` replays one CUDA graph of ``_step`` a token; on the
CPU it runs the same ``_step`` eagerly. Small float32 models (2-3 layers,
narrow widths) from the JAX ``transformer_init`` through ``params_from_jax``,
prompts from numpy seeds. Tolerances:

- ``decode_step`` with the position a 0-dim tensor against the JAX
  ``decode_step``: logits and the whole cache within 2e-4, as in
  ``tests/test_torch_generate.py`` (a few layers of float32 sums in another
  order).
- The step function run eagerly: greedy tokens equal to the JAX
  ``generate``'s, and tokens and cache bitwise equal to the port's eager
  loop (``_generate_eager``): the same operations on the same values.
- Sampling: the same seed gives the same tokens, bitwise.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import transformer as jtf
from ray_tpu_torch.models import convert
from ray_tpu_torch.models import transformer as ttf

# the packages export a function named `generate`, which hides the module
jgen = importlib.import_module("ray_tpu.models.generate")
tgen = importlib.import_module("ray_tpu_torch.models.generate")

TOL = 2e-4
VOCAB = 97

CONFIGS = {
    "dense-gqa": dict(n_layers=3, n_heads=4, n_kv_heads=2),
    "moe": dict(n_layers=2, n_heads=4, n_kv_heads=2, num_experts=4,
                expert_top_k=2),
}


def _setup(name, seed=0):
    base = dict(vocab_size=VOCAB, d_model=64, max_seq=64,
                attn_impl="reference", **CONFIGS[name])
    jcfg = jtf.TransformerConfig(dtype=jnp.float32, **base)
    tcfg = ttf.TransformerConfig(dtype=torch.float32, **base)
    jp = jtf.transformer_init(jax.random.PRNGKey(seed), jcfg)
    tp = convert.params_from_jax(jax.tree.map(np.array, jp), tcfg,
                                 device="cpu")
    return jcfg, tcfg, jp, tp


def _prompt(b, s, seed):
    return np.random.default_rng(seed).integers(0, VOCAB, (b, s)).astype(
        np.int32)


def _loop(tp, prompt, tcfg, n, temperature=0.0, top_k=None, seed=0):
    """generate's loop on the CPU: (tokens, cache)."""
    cfg = tgen._inference_cfg(tcfg)
    with torch.inference_mode():
        return tgen._generate_loop(tgen._cast_params(tp, cfg.dtype),
                                   torch.from_numpy(prompt), cfg, n,
                                   temperature, top_k, seed,
                                   torch.device("cpu"))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_decode_step_with_tensor_pos_matches_jax(name):
    jcfg, tcfg, jp, tp = _setup(name)
    prompt = _prompt(2, 7, seed=4)
    _, jcache = jgen.prefill(jp, jnp.asarray(prompt), jcfg, max_len=12)
    _, tcache = tgen.prefill(tp, torch.from_numpy(prompt), tcfg,
                             max_len=12, device="cpu")
    token = np.array([5, 11], np.int32)
    for pos in (7, 8, 9):
        want, jcache = jgen.decode_step(jp, jnp.asarray(token), pos, jcache,
                                        jcfg)
        got, tcache = tgen.decode_step(
            tp, torch.from_numpy(token), torch.tensor(pos), tcache, tcfg,
            device="cpu")
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                                   rtol=TOL)
        for part in ("k", "v"):
            np.testing.assert_allclose(tcache[part].numpy(),
                                       np.asarray(jcache[part]), atol=TOL,
                                       rtol=TOL)
        token = np.asarray(want).argmax(-1).astype(np.int32)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_tensor_and_int_positions_give_the_same_step(name):
    _, tcfg, _, tp = _setup(name)
    prompt = torch.from_numpy(_prompt(3, 5, seed=2))
    token = torch.tensor([1, 2, 3])
    out = []
    for pos in (5, torch.tensor(5, dtype=torch.int32)):
        _, cache = tgen.prefill(tp, prompt, tcfg, max_len=8, device="cpu")
        logits, cache = tgen.decode_step(tp, token, pos, cache, tcfg,
                                         device="cpu")
        out.append((logits, cache))
    (a, ca), (b, cb) = out
    assert torch.equal(a, b)
    assert torch.equal(ca["k"], cb["k"]) and torch.equal(ca["v"], cb["v"])


@pytest.mark.parametrize("name,b,s", [("dense-gqa", 2, 7), ("moe", 3, 5)])
def test_step_function_gives_jax_greedy_tokens_and_the_eager_loop(name, b,
                                                                   s):
    jcfg, tcfg, jp, tp = _setup(name, seed=1)
    prompt = _prompt(b, s, seed=5)
    n = 16
    want = jgen.generate(jp, jnp.asarray(prompt), jcfg, max_new_tokens=n,
                         temperature=0.0)
    tokens, cache = _loop(tp, prompt, tcfg, n)
    assert tokens.shape == (b, n) and tokens.dtype == torch.int64
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(want))
    eager, eager_cache = tgen._generate_eager(
        tp, torch.from_numpy(prompt), tcfg, max_new_tokens=n, device="cpu")
    assert torch.equal(tokens, eager)
    for part in ("k", "v"):
        assert torch.equal(cache[part], eager_cache[part])
    assert torch.equal(tgen.generate(tp, torch.from_numpy(prompt), tcfg,
                                     max_new_tokens=n, device="cpu"), tokens)


@pytest.mark.parametrize("n", [1, 2, 5])
def test_short_generations_match_the_eager_loop(n):
    _, tcfg, _, tp = _setup("dense-gqa")
    prompt = _prompt(2, 4, seed=6)
    tokens, _ = _loop(tp, prompt, tcfg, n)
    eager, _ = tgen._generate_eager(tp, torch.from_numpy(prompt), tcfg,
                                    max_new_tokens=n, device="cpu")
    assert tokens.shape == (2, n)
    assert torch.equal(tokens, eager)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_sampled_run_with_a_fixed_seed_repeats_itself(name):
    _, tcfg, _, tp = _setup(name)
    prompt = torch.from_numpy(_prompt(3, 5, seed=7))
    kw = dict(max_new_tokens=12, temperature=0.9, top_k=30, device="cpu")
    a = tgen.generate(tp, prompt, tcfg, seed=13, **kw)
    b = tgen.generate(tp, prompt, tcfg, seed=13, **kw)
    assert a.shape == (3, 12)
    assert torch.equal(a, b)
    assert bool(((a >= 0) & (a < VOCAB)).all())
    # the step function draws from the generator as the eager loop does
    eager, _ = tgen._generate_eager(tp, prompt, tcfg, seed=13, **kw)
    assert torch.equal(a, eager)
    other = tgen.generate(tp, prompt, tcfg, seed=14, **kw)
    assert not torch.equal(a, other)


def test_cpu_generate_runs_the_step_function_and_no_graph(monkeypatch):
    """On the CPU generate calls ``_step`` once a decode step and never
    captures a graph or runs the eager loop."""
    _, tcfg, _, tp = _setup("dense-gqa")
    calls = []
    step = tgen._step

    def counted(*args, **kw):
        calls.append(1)
        return step(*args, **kw)

    def refused(*args, **kw):
        raise AssertionError("generate left its step function")

    monkeypatch.setattr(tgen, "_step", counted)
    monkeypatch.setattr(tgen, "_decode_graph", refused)
    monkeypatch.setattr(tgen, "_generate_eager", refused)
    captures, replays = tgen.graph_captures, tgen.graph_replays
    out = tgen.generate(tp, torch.from_numpy(_prompt(2, 6, seed=8)), tcfg,
                        max_new_tokens=9, device="cpu")
    assert out.shape == (2, 9)
    assert len(calls) == 8
    assert (tgen.graph_captures, tgen.graph_replays) == (captures, replays)


def test_step_advances_the_state_in_place():
    """``_step`` reads and writes only its static tensors: the same objects
    hold the next token, the advanced position and the next column."""
    _, tcfg, _, tp = _setup("dense-gqa")
    cfg = tgen._inference_cfg(tcfg)
    with torch.inference_mode():
        state, gen = tgen._start(tp, torch.from_numpy(_prompt(2, 6, seed=9)),
                                 cfg, 4, 0.0, None, 0, torch.device("cpu"))
        held = {k: state[k] for k in ("token", "pos", "col", "out")}
        for i in range(3):
            tgen._step(tp, cfg, state, gen, 0.0, None)
            assert all(state[k] is v for k, v in held.items())
            assert int(state["pos"]) == 7 + i and int(state["col"]) == 2 + i
            assert torch.equal(state["out"][:, 1 + i], state["token"])


def test_bf16_step_function_matches_the_eager_loop():
    _, tcfg, _, tp = _setup("moe")
    cfg16 = dataclasses.replace(tcfg, dtype=torch.bfloat16)
    prompt = _prompt(2, 5, seed=10)
    tokens, cache = _loop(tp, prompt, cfg16, 6)
    eager, eager_cache = tgen._generate_eager(
        tp, torch.from_numpy(prompt), cfg16, max_new_tokens=6, device="cpu")
    assert torch.equal(tokens, eager)
    assert torch.equal(cache["k"], eager_cache["k"])
