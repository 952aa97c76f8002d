"""The port's autoscaler (``ray_tpu_torch/autoscaler/``), held to the JAX
package's (``ray_tpu/autoscaler/``).

- ``fit_demand`` on the same type and demand dicts through both packages,
  with ``"GPU"`` shapes and infeasible demand (JAX:
  ``tests/test_autoscaler_chaos.py:25``).
- The counterparts of the JAX scale-up, idle scale-down and zombie-sweep
  tests (``:41``, ``:65``, ``:86``) on a port ``Cluster``.
- A fake node type that names ``"GPU"``: the autoscaler launches it for a
  ``num_gpus=1`` task, whose lease gets card index 0 in its worker's
  ``CUDA_VISIBLE_DEVICES``; the idle node is terminated and drained from
  the cluster view.

The remote functions are module-level (the port ships them by import
path); this module imports JAX only inside functions, since the port's
workers import it by name.
"""

import os
import time

import pytest

import ray_tpu_torch as rt
from ray_tpu_torch.autoscaler import (FakeNodeProvider, NodeProvider,
                                      StandardAutoscaler, fit_demand)
from ray_tpu_torch.cluster.cluster_utils import Cluster

TYPES = {"cpu4": {"resources": {"CPU": 4}, "max_workers": 5},
         "gpu1": {"resources": {"CPU": 8, "GPU": 1}, "max_workers": 2},
         "gpu8": {"resources": {"CPU": 32, "GPU": 8}, "max_workers": 1}}

FIT_CASES = {
    # the JAX test's three, with the GPU types in place of its TPU type
    "cpu_demand_past_free": ([{"CPU": 2}] * 3, [{"CPU": 2}], TYPES, None),
    "gpu_only_on_gpu_type": ([{"GPU": 1}], [{"CPU": 2}], TYPES, None),
    "infeasible_dropped": ([{"GPU": 100}], [], TYPES, None),
    # GPU shapes: packing onto a launched node, the per-type cap, spill to
    # the next type, and free capacity that absorbs demand
    "gpu_cap_spills_to_next_type": ([{"GPU": 1}] * 3, [{"CPU": 2}], TYPES,
                                    None),
    "mixed_shapes": ([{"CPU": 3}, {"CPU": 2, "GPU": 1}, {"GPU": 0.5},
                      {"GPU": 0.5}, {"CPU": 1}], [{"CPU": 1, "GPU": 0.5}],
                     TYPES, None),
    "caps_from_caller": ([{"CPU": 4}] * 4 + [{"GPU": 1}] * 2, [],
                         TYPES, {"cpu4": 1, "gpu1": 0}),
    "free_gpu_absorbs": ([{"GPU": 1}, {"CPU": 6}], [{"CPU": 8, "GPU": 1}],
                         TYPES, None),
    "nothing_pending": ([], [{"CPU": 2}], TYPES, None),
}


@pytest.mark.parametrize("case", sorted(FIT_CASES))
def test_fit_demand_equals_the_jax_package(case):
    from ray_tpu.autoscaler import fit_demand as jax_fit_demand
    demand, avail, types, caps = FIT_CASES[case]
    want = jax_fit_demand(demand, avail, types, max_per_type=caps)
    assert fit_demand(demand, avail, types, max_per_type=caps) == want


def test_fit_demand_values_of_the_jax_test():
    """The JAX test's expectations, on the port (a TPU shape there is a
    GPU shape here)."""
    assert fit_demand([{"CPU": 2}] * 3, [{"CPU": 2}], TYPES) == {"cpu4": 1}
    assert fit_demand([{"GPU": 1}], [{"CPU": 2}], TYPES) == {"gpu1": 1}
    assert fit_demand([{"GPU": 100}], [], TYPES) == {}
    assert fit_demand([{"GPU": 1}] * 3, [{"CPU": 2}], TYPES) == \
        {"gpu1": 2, "gpu8": 1}


def hold(t):
    time.sleep(t)
    return 1


def card_env():
    return os.environ.get("CUDA_VISIBLE_DEVICES"), os.getpid()


@pytest.fixture(scope="module")
def cluster():
    rt.shutdown()
    c = Cluster(initialize_head=True, head_node_args={"num_cpus": 2,
                                                      "num_gpus": 0})
    rt.init(address=c.address)
    yield c
    rt.shutdown()
    c.shutdown()


def _alive_nodes():
    return [n for n in rt.nodes() if n["Alive"]]


def _terminate_all(provider):
    for pid, _ in provider.non_terminated_nodes():
        provider.terminate_node(pid)


def test_autoscaler_scales_up_for_demand(cluster):
    types = {"cpu2": {"resources": {"CPU": 2}, "max_workers": 4}}
    provider = FakeNodeProvider(cluster.address, types)
    scaler = StandardAutoscaler(cluster.address, provider, types,
                                idle_timeout_s=60, update_interval_s=0.25)
    scaler.start()
    try:
        # the head has 2 CPUs; 4 concurrent 2-CPU tasks need more nodes
        task = rt.remote(num_cpus=2)(hold)
        refs = [task.remote(2) for _ in range(4)]
        assert rt.get(refs, timeout=120) == [1, 1, 1, 1]
        assert len(provider.non_terminated_nodes()) >= 1  # scaled up
    finally:
        scaler.stop()
        _terminate_all(provider)


def test_autoscaler_scales_down_idle(cluster):
    types = {"cpu2": {"resources": {"CPU": 2}, "max_workers": 4}}
    provider = FakeNodeProvider(cluster.address, types)
    before = len(_alive_nodes())
    provider.create_node("cpu2")
    deadline = time.time() + 15
    while len(_alive_nodes()) < before + 1 and time.time() < deadline:
        time.sleep(0.2)
    assert len(_alive_nodes()) == before + 1
    scaler = StandardAutoscaler(cluster.address, provider, types,
                                idle_timeout_s=1.0, update_interval_s=0.25)
    scaler.start()
    try:
        deadline = time.time() + 30
        while provider.non_terminated_nodes() and time.time() < deadline:
            time.sleep(0.5)
        assert not provider.non_terminated_nodes()  # idle node reclaimed
        # drained at termination: the cluster view drops it at once
        assert len(_alive_nodes()) == before
    finally:
        scaler.stop()
        _terminate_all(provider)


class ZombieProvider(NodeProvider):
    def __init__(self):
        self.nodes = {"zombie-1": "cpu2"}
        self.terminated = []

    def create_node(self, node_type):
        raise AssertionError("no demand in this test")

    def terminate_node(self, pid):
        self.terminated.append(pid)
        self.nodes.pop(pid, None)

    def non_terminated_nodes(self):
        return list(self.nodes.items())

    def node_id_map(self):
        # A mapping-capable provider (zombie-1 has no cluster node to
        # map). Providers returning {} opt out of termination.
        return {b"some-other-cluster-node": "other-pid"}


def test_autoscaler_terminates_zombie_provider(cluster):
    """A provider node that never registers a cluster node is terminated
    after the zombie grace period; a provider that cannot map node ids
    never is."""
    types = {"cpu2": {"resources": {"CPU": 2}, "max_workers": 4}}
    provider = ZombieProvider()
    scaler = StandardAutoscaler(cluster.address, provider, types,
                                idle_timeout_s=60, zombie_grace_s=0.5)
    scaler.update()                      # seeds the zombie clock
    assert not provider.terminated      # inside the grace window
    time.sleep(0.7)
    scaler.update()
    assert provider.terminated == ["zombie-1"]

    blind = ZombieProvider()
    blind.node_id_map = lambda: {}
    scaler2 = StandardAutoscaler(cluster.address, blind, types,
                                 idle_timeout_s=60, zombie_grace_s=0.1)
    scaler2.update()
    time.sleep(0.3)
    scaler2.update()
    assert blind.terminated == []


def test_gpu_node_type_is_launched_for_a_card_task_and_leases_card_0(
        cluster):
    """The head has no card: a ``num_gpus=1`` task is infeasible there, the
    autoscaler launches the fake ``{"GPU": 1}`` type for it, the task's
    worker sees ``CUDA_VISIBLE_DEVICES`` "0", and once idle the node is
    terminated and the cluster counts no card again."""
    assert rt.cluster_resources().get("GPU", 0.0) == 0.0
    types = {"gpu_worker": {"resources": {"CPU": 1, "GPU": 1},
                            "max_workers": 1}}
    provider = FakeNodeProvider(cluster.address, types)
    scaler = StandardAutoscaler(cluster.address, provider, types,
                                idle_timeout_s=1.0, update_interval_s=0.25)
    scaler.start()
    try:
        visible, pid = rt.get(rt.remote(num_gpus=1)(card_env).remote(),
                              timeout=120)
        assert visible == "0" and pid != os.getpid()
        launched = [t for _, t in provider.non_terminated_nodes()]
        assert launched == ["gpu_worker"]
        cpu_visible, _ = rt.get(rt.remote(card_env).remote(), timeout=60)
        assert cpu_visible == ""        # a plain task sees no card
        deadline = time.time() + 60
        while provider.non_terminated_nodes() and time.time() < deadline:
            time.sleep(0.25)
        assert not provider.non_terminated_nodes()
        assert rt.cluster_resources().get("GPU", 0.0) == 0.0
    finally:
        scaler.stop()
        _terminate_all(provider)
