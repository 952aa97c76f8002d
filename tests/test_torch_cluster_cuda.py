"""The port's cluster runtime on the card. Every test is marked ``cuda`` and
skips without a CUDA card. The file imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_cluster_cuda.py

A ``cluster_utils.Cluster`` head counts the host's cards as ``"GPU"``; a
task that leases no GPU sees no card (``CUDA_VISIBLE_DEVICES=""``), an
actor with ``num_gpus=1`` sees one; and the flash forward kernel, launched
in that actor's worker process, matches its plain version there within
``chip_smoke.py`` phase 2's bf16 tolerance. Two ``num_gpus=0.5`` actors
share the one card, and a small f32 ``PipelineTrainer`` whose two stage
actors share it gives the losses of the same trainer on the CPU within
``PIPE_TOL``, with flash launches in the stage workers. Worker processes
import this module by name, so its remote functions and classes (and the
stages' optimizer factory) are module-level.
"""

import os

import pytest
import torch

import ray_tpu_torch as rt
from ray_tpu_torch.cluster.cluster_utils import Cluster

pytestmark = pytest.mark.cuda

# chip_smoke.py's TOL[torch.bfloat16]: O and LSE of the bf16 forward
TOL_OUT, TOL_LSE = 2e-2, 1e-3
# A small f32 pipeline, card (the kernels, cuBLAS) against the CPU (the
# plain versions): f32 sums in another order, over 3 SGD steps.
PIPE_TOL = 1e-4


def sgd(leaves):
    return torch.optim.SGD(leaves, lr=0.1)


def card_view():
    return (os.environ.get("CUDA_VISIBLE_DEVICES"),
            torch.cuda.is_available(),
            torch.cuda.device_count() if torch.cuda.is_available() else 0)


class KernelActor:
    def view(self):
        return card_view()

    def flash_against_plain(self):
        from ray_tpu_torch.ops import flash
        gen = torch.Generator(device="cuda").manual_seed(7)
        q, k, v = (torch.randn(2, 300, 8, 128, generator=gen,
                               device="cuda").to(torch.bfloat16)
                   for _ in range(3))
        flash.launches = 0
        out, lse = flash.flash_fwd(q, k, v, causal=True)
        launched = flash.launches
        pout, plse = flash.flash_fwd_plain(q, k, v, causal=True)
        torch.cuda.synchronize()
        return ((out.float() - pout.float()).abs().max().item(),
                (lse - plse).abs().max().item(), launched)


@pytest.fixture(scope="module")
def cluster():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    c = Cluster(initialize_head=True, head_node_args={"num_cpus": 2})
    rt.init(address=c.address)
    yield c
    rt.shutdown()
    c.shutdown()


def test_head_counts_the_cards(cluster):
    assert rt.cluster_resources().get("GPU") == float(
        torch.cuda.device_count())


def test_plain_task_sees_no_card_and_gpu_actor_one(cluster):
    assert rt.get(rt.remote(card_view).remote(), timeout=300) == \
        ("", False, 0)
    a = rt.remote(num_gpus=1)(KernelActor).remote()
    try:
        assert rt.get(a.view.remote(), timeout=300) == ("0", True, 1)
    finally:
        rt.kill(a)


def test_flash_forward_in_the_worker_matches_plain(cluster):
    a = rt.remote(num_gpus=1)(KernelActor).remote()
    try:
        o_err, l_err, launched = rt.get(a.flash_against_plain.remote(),
                                        timeout=600)
    finally:
        rt.kill(a)
    assert launched == 1
    assert o_err <= TOL_OUT and l_err <= TOL_LSE


def test_half_card_actors_share_the_card(cluster):
    pair = [rt.remote(num_gpus=0.5)(KernelActor).remote() for _ in range(2)]
    try:
        views = rt.get([a.view.remote() for a in pair], timeout=300)
    finally:
        for a in pair:
            rt.kill(a)
    assert views == [("0", True, 1)] * 2


def test_small_pipeline_on_the_card_matches_the_cpu(cluster):
    """The same partitions (drawn on the host) loaded into the stage
    actors of a card trainer and of a CPU trainer."""
    import dataclasses

    import numpy as np

    from ray_tpu_torch.models import TransformerConfig, transformer_init
    from ray_tpu_torch.models.transformer import transformer_partition_params
    from ray_tpu_torch.train.pipeline import PipelineTrainer
    # head_dim 64: a width the kernels take
    cfg = TransformerConfig(vocab_size=128, d_model=128, n_layers=4,
                            n_heads=2, max_seq=64, dtype=torch.float32,
                            remat=True)
    pp_cfg = dataclasses.replace(cfg, pp_stages=2)
    params = transformer_init(torch.Generator().manual_seed(0), pp_cfg,
                              device="cpu")
    parts = [transformer_partition_params(params, pp_cfg, p)
             for p in range(2)]
    rng = np.random.default_rng(0)
    batches = [{"tokens": rng.integers(0, 128, (8, 64))} for _ in range(3)]
    losses = {}
    for device in (None, "cpu"):
        tr = PipelineTrainer(cfg, num_stages=2, num_microbatches=4,
                             tx_factory=sgd, seed=0, device=device).start()
        try:
            stages = tr._groups[0]
            rt.get([h.load_partition.remote(p, parts[p])
                    for p, h in enumerate(stages)], timeout=300)
            rt.get([h.device_stats.remote(reset=True) for h in stages],
                   timeout=120)
            losses[device] = [tr.step(b)["loss"] for b in batches]
            stats = rt.get([h.device_stats.remote() for h in stages],
                           timeout=120)
        finally:
            tr.shutdown()
        if device is None:
            launches = [sum(st["launches"][i] for st in stats)
                        for i in range(4)]
    # 3 steps x 4 microbatches: each backward kernel once a layer
    assert launches[1:] == [3 * 4 * 4] * 3 and launches[0] > 0
    np.testing.assert_allclose(losses[None], losses["cpu"], atol=PIPE_TOL)
