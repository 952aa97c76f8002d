"""Serve on the card. Every test is marked ``cuda`` and skips without a
CUDA card. The file imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_serve_cuda.py

A small f32 LM deployment (2 heads of 64, which the flash kernel takes) on
the card answers concurrent HTTP requests with the greedy tokens of the
same deployment on the CPU, from the same seeded weights (drawn on the host,
TF32 off), and the flash-forward kernel launches once per layer per
``generate`` call the deployment made.
"""

import concurrent.futures
import json
import urllib.request

import numpy as np
import pytest
import torch

import ray_tpu_torch as rt
from ray_tpu_torch import serve
from ray_tpu_torch.models import TransformerConfig, transformer_init
from ray_tpu_torch.ops import flash

CFG = TransformerConfig(vocab_size=256, d_model=128, n_layers=2, n_heads=2,
                        n_kv_heads=2, d_ff=256, max_seq=64, attn_impl="auto",
                        dtype=torch.float32)
NEW_TOKENS = 8


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


@serve.deployment(num_replicas=1, route_prefix="/generate")
class LMServer:
    def __init__(self, device):
        from ray_tpu_torch.models import generate
        host = transformer_init(torch.Generator().manual_seed(0), CFG,
                                device="cpu")
        self.device = device
        self.params = _to(host, "cuda" if device is None else device)
        self.generate = generate
        self.calls = 0

    @serve.batch(max_batch_size=4, batch_wait_timeout_s=1.0)
    def generate_batch(self, prompts):
        self.calls += 1
        out = self.generate(self.params, torch.tensor(prompts), CFG,
                            max_new_tokens=NEW_TOKENS, device=self.device)
        return out.tolist()

    def __call__(self, prompt=None):
        return {"tokens": self.generate_batch(prompt)}

    def generate_calls(self):
        return self.calls


def _serve(device, prompts):
    """(HTTP answers, generate calls, flash launches) of one deployment."""
    rt.init(local_mode=True)
    try:
        handle = serve.run(LMServer.bind(device), http_host="127.0.0.1")
        url = f"http://127.0.0.1:{handle.http_port}/generate"

        def post(prompt):
            req = urllib.request.Request(
                url, data=json.dumps({"prompt": prompt}).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=60) as r:
                return r.code, json.loads(r.read())

        flash.launches = 0
        with concurrent.futures.ThreadPoolExecutor(len(prompts)) as pool:
            answers = list(pool.map(post, prompts))
        launches = flash.launches
        calls = rt.get(handle.options("generate_calls").remote(),
                       timeout=60)
        return answers, calls, launches
    finally:
        serve.shutdown()
        rt.shutdown()


@pytest.mark.cuda
def test_http_lm_on_the_card_answers_the_cpu_tokens(card):
    prompts = np.random.default_rng(3).integers(
        0, CFG.vocab_size, (4, 16)).tolist()
    card_answers, card_calls, card_launches = _serve(None, prompts)
    cpu_answers, cpu_calls, cpu_launches = _serve("cpu", prompts)
    assert [code for code, _ in card_answers] == [200] * 4
    assert card_answers == cpu_answers
    assert card_calls >= 1 and card_launches == CFG.n_layers * card_calls
    assert cpu_launches == 0   # the plain path on the CPU


@pytest.mark.cuda
def test_http_lm_handle_path_on_the_card(card):
    """The handle path (no HTTP) reaches the same batch method."""
    prompt = np.random.default_rng(4).integers(
        0, CFG.vocab_size, 16).tolist()
    outs = []
    for device in (None, "cpu"):
        rt.init(local_mode=True)
        try:
            handle = serve.run(LMServer.bind(device))
            outs.append(rt.get(handle.options("generate_batch")
                               .remote(prompt), timeout=60))
        finally:
            serve.shutdown()
            rt.shutdown()
    assert outs[0] == outs[1] and len(outs[0]) == NEW_TOKENS
