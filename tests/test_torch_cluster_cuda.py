"""The port's cluster runtime on the card. Every test is marked ``cuda`` and
skips without a CUDA card. The file imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_cluster_cuda.py

A ``cluster_utils.Cluster`` head counts the host's cards as ``"GPU"``; a
task that leases no GPU sees no card (``CUDA_VISIBLE_DEVICES=""``), an
actor with ``num_gpus=1`` sees one; and the flash forward kernel, launched
in that actor's worker process, matches its plain version there within
``chip_smoke.py`` phase 2's bf16 tolerance. Worker processes import this
module by name, so its remote functions and classes are module-level.
"""

import os

import pytest
import torch

import ray_tpu_torch as rt
from ray_tpu_torch.cluster.cluster_utils import Cluster

pytestmark = pytest.mark.cuda

# chip_smoke.py's TOL[torch.bfloat16]: O and LSE of the bf16 forward
TOL_OUT, TOL_LSE = 2e-2, 1e-3


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
