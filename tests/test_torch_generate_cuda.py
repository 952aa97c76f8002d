"""The decode graph on the card. Every test is marked ``cuda`` and skips
without a CUDA card. The file imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_generate_cuda.py

Small LMs (2 layers, 2 heads of 64, which the flash kernel takes; dense and
4 experts top-2) from seeded weights drawn on the host, TF32 off. On the
card ``generate`` replays one CUDA graph a decode step; the eager loop
(``_generate_eager``, one eager ``decode_step`` a token) is the plain
version it is held to:

- greedy tokens equal, bitwise, at bf16 and f32; the caches within 1e-5
  at f32 and 2e-2 at bf16 (the same kernels on the same values; the
  tolerance covers a cuBLAS algorithm that differs between streams);
- sampled tokens equal for the same seed (a replay advances the registered
  generator as the eager step does);
- no step reads a device value on the host; memory is flat over 20 calls
  of varying batch, prompt and length; a capture succeeds while another
  thread runs CUDA work.
"""

import dataclasses
import gc
import importlib
import threading

import numpy as np
import pytest
import torch

from ray_tpu_torch.models import TransformerConfig, transformer_init
from ray_tpu_torch.ops import flash

tgen = importlib.import_module("ray_tpu_torch.models.generate")

CFG = TransformerConfig(vocab_size=256, d_model=128, n_layers=2, n_heads=2,
                        n_kv_heads=2, d_ff=256, max_seq=128,
                        attn_impl="auto", dtype=torch.float32)
MODELS = {"dense": {}, "moe": {"num_experts": 4, "expert_top_k": 2}}
CACHE_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = saved


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


def _model(name, dtype=torch.float32, seed=0):
    cfg = dataclasses.replace(CFG, dtype=dtype, **MODELS[name])
    host = transformer_init(torch.Generator().manual_seed(seed), cfg,
                            device="cpu")
    return cfg, _to(host, "cuda")


def _prompt(b, s, seed):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, CFG.vocab_size, (b, s))).cuda()


def _graph_run(params, prompt, cfg, n, **kw):
    """generate's loop on the card: (tokens, cache)."""
    icfg = tgen._inference_cfg(cfg)
    with torch.inference_mode():
        return tgen._generate_loop(
            tgen._cast_params(params, icfg.dtype), prompt, icfg, n,
            kw.get("temperature", 0.0), kw.get("top_k"), kw.get("seed", 0),
            torch.device("cuda"))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_graph_greedy_tokens_equal_the_eager_loop(card, name, dtype):
    cfg, params = _model(name, dtype)
    prompt = _prompt(4, 24, seed=1)
    n = 32
    flash.launches = 0
    captures, replays = tgen.graph_captures, tgen.graph_replays
    tokens = tgen.generate(params, prompt, cfg, max_new_tokens=n)
    assert flash.launches == cfg.n_layers
    assert tgen.graph_captures == captures + 1
    assert tgen.graph_replays == replays + n - 1
    eager, eager_cache = tgen._generate_eager(params, prompt, cfg,
                                              max_new_tokens=n)
    assert tokens.shape == (4, n)
    assert torch.equal(tokens, eager)
    again, cache = _graph_run(params, prompt, cfg, n)
    assert torch.equal(again, tokens)
    for part in ("k", "v"):
        diff = (cache[part].float() - eager_cache[part].float()).abs().max()
        assert diff.item() <= CACHE_TOL[dtype]


@pytest.mark.cuda
def test_generate_on_the_card_reaches_the_graph_not_the_eager_loop(
        card, monkeypatch):
    cfg, params = _model("dense")

    def refused(*args, **kw):
        raise AssertionError("generate ran the eager loop on the card")

    monkeypatch.setattr(tgen, "_generate_eager", refused)
    steps = []
    step = tgen._step
    monkeypatch.setattr(tgen, "_step",
                        lambda *a, **kw: (steps.append(1), step(*a, **kw)))
    replays = tgen.graph_replays
    out = tgen.generate(params, _prompt(2, 16, seed=2), cfg,
                        max_new_tokens=20)
    assert out.shape == (2, 20)
    assert tgen.graph_replays == replays + 19
    # the step function ran twice on the host: the warm-up and the capture
    assert len(steps) == 2
    assert tgen.last_capture_s > 0


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(MODELS))
def test_sampled_tokens_equal_the_eager_loop(card, name):
    cfg, params = _model(name, torch.bfloat16)
    prompt = _prompt(3, 20, seed=3)
    kw = dict(max_new_tokens=24, temperature=0.8, top_k=40, seed=7)
    a = tgen.generate(params, prompt, cfg, **kw)
    b = tgen.generate(params, prompt, cfg, **kw)
    eager, _ = tgen._generate_eager(params, prompt, cfg, **kw)
    assert torch.equal(a, b)
    assert torch.equal(a, eager)
    other = tgen.generate(params, prompt, cfg, **{**kw, "seed": 8})
    assert not torch.equal(a, other)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(MODELS))
@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_a_decode_step_reads_nothing_back_to_the_host(card, name,
                                                      temperature):
    cfg, params = _model(name, torch.bfloat16)
    icfg = tgen._inference_cfg(cfg)
    with torch.inference_mode():
        p = tgen._cast_params(params, icfg.dtype)
        state, gen = tgen._start(p, _prompt(2, 16, seed=4), icfg, 4,
                                 temperature, 20, 0, torch.device("cuda"))
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            tgen._step(p, icfg, state, gen, temperature, 20)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    assert int(state["pos"]) == 17


@pytest.mark.cuda
def test_memory_is_flat_over_calls_of_varying_shapes(card):
    cfg, params = _model("dense", torch.bfloat16)
    rng = np.random.default_rng(5)
    tgen.generate(params, _prompt(1, 8, seed=0), cfg, max_new_tokens=4)
    gc.collect()
    torch.cuda.synchronize()
    start = torch.cuda.memory_allocated()
    for i in range(20):
        b, s = int(rng.integers(1, 9)), int(rng.integers(4, 64))
        out = tgen.generate(params, _prompt(b, s, seed=i), cfg,
                            max_new_tokens=int(rng.integers(2, 40)))
        assert out.shape[0] == b
        del out
    gc.collect()
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() == start


@pytest.mark.cuda
def test_capture_while_another_thread_runs_cuda_work(card):
    cfg, params = _model("moe", torch.bfloat16)
    prompt = _prompt(4, 16, seed=6)
    want = tgen.generate(params, prompt, cfg, max_new_tokens=16)
    stop, errors, rounds = threading.Event(), [], []

    def busy():
        try:
            x = torch.randn(512, 512, device="cuda")
            while not stop.is_set():
                y = torch.relu(x @ x.T)          # fresh allocations too
                rounds.append(float(y.mean()))   # a read back each round
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    thread = threading.Thread(target=busy)
    thread.start()
    try:
        while not rounds and thread.is_alive():
            pass
        captures = tgen.graph_captures
        got = [tgen.generate(params, prompt, cfg, max_new_tokens=16)
               for _ in range(4)]
    finally:
        stop.set()
        thread.join()
    assert not errors
    assert tgen.graph_captures == captures + 4
    for tokens in got:
        assert torch.equal(tokens, want)
