"""The port's placement groups (``ray_tpu_torch.util.placement_group``,
``scheduling_strategies``) and host collective (``util.collective``) on
its cluster runtime, held to the JAX package's on a JAX ``Cluster``.

The programs are the counterparts of the five tests of
``tests/test_placement_groups.py``, plus every operation of the host
collective (allreduce SUM and MAX, allgather, reducescatter, broadcast,
send/recv, barrier) on the same seeded numpy inputs. Each program takes a
package name and returns plain values; the JAX programs run once per test
run on a two-node JAX ``Cluster`` (``_once``: the xdist workers share one
pickle), each test runs its program on this module's two-node port cluster
and compares: values must be equal (the reductions run in numpy on the
same inputs in both). Then the port's own rules: a torch tensor goes to
the host and comes back numpy, bfloat16 is refused, ``"SLICE"`` and the
in-process runtime are refused, and a bundle's card reaches its worker.

The actor class and functions here are module-level: the port's workers
import this module by name (so it imports no JAX at the top), the JAX
workers get them by value (cloudpickle's pickle-by-value, registered for
the JAX run only).
"""

import fcntl
import importlib
import os
import pickle
import time

import numpy as np
import pytest

import ray_tpu_torch as rt
from ray_tpu_torch.cluster.cluster_utils import Cluster
from ray_tpu_torch.util import collective
from ray_tpu_torch.util.placement_group import (placement_group,
                                                placement_group_table,
                                                remove_placement_group)
from ray_tpu_torch.util.scheduling_strategies import (
    PlacementGroupSchedulingStrategy)

NODE_CPUS = 4

# ---------------------------------------------------------------------------
# plain functions and classes, wrapped by each package's ``remote``
# ---------------------------------------------------------------------------


def node_of(pkg):
    return str(importlib.import_module(pkg).get_runtime_context().node_id)


def visible_cards():
    return os.environ.get("CUDA_VISIBLE_DEVICES")


class Rank:
    def __init__(self, pkg):
        self.pkg = pkg

    def _c(self):
        return importlib.import_module(f"{self.pkg}.util.collective")

    def ping(self):
        return "pong"

    def init_group(self, world_size, rank, backend, name):
        self._c().init_collective_group(world_size, rank, backend, name)
        return True

    def do_allreduce(self, group="g1"):
        c = self._c()
        return c.allreduce(np.ones(4) * (c.get_rank(group) + 1),
                           group_name=group)

    def do_broadcast(self, group="g1"):
        c = self._c()
        return c.broadcast(np.arange(3) if c.get_rank(group) == 0 else
                           np.zeros(3), src_rank=0, group_name=group)

    def every_op(self, group, tensor=False):
        """Each operation on this rank's seeded inputs; with ``tensor``,
        the inputs are CPU torch tensors."""
        c = self._c()
        rank, world = c.get_rank(group), c.get_collective_group_size(group)
        x = np.random.default_rng(rank).normal(size=(6,)).astype(np.float32)
        if tensor:
            import torch
            x = torch.from_numpy(x)
        out = {
            "sum": c.allreduce(x, group_name=group, op="SUM"),
            "max": c.allreduce(x, group_name=group, op="MAX"),
            "gather": c.allgather(x, group_name=group),
            "scatter": c.reducescatter(x, group_name=group, op="SUM"),
            "bcast": c.broadcast(x, src_rank=world - 1, group_name=group),
        }
        c.barrier(group_name=group)
        # last: send and recv advance the sequence of their two ranks only
        if rank == 0:
            c.send(x * 2, 1, group_name=group)
        elif rank == 1:
            out["recv"] = c.recv(0, group_name=group)
        return {k: _typed(v) for k, v in out.items()}


def _typed(v):
    """A result -> (type name, dtype, values), or a list of them."""
    if isinstance(v, list):
        return [_typed(x) for x in v]
    return (type(v).__name__, str(v.dtype), v.tolist())


# ---------------------------------------------------------------------------
# the programs
# ---------------------------------------------------------------------------


def _pg(pkg):
    return importlib.import_module(f"{pkg}.util.placement_group")


def _strategy(pkg):
    return importlib.import_module(
        f"{pkg}.util.scheduling_strategies").PlacementGroupSchedulingStrategy


def prog_pg_create_ready_remove(rtm, pkg):
    pg = _pg(pkg).placement_group([{"CPU": 1}, {"CPU": 1}], strategy="PACK")
    pg.ready(timeout=20)
    listed = [row["state"] for row in _pg(pkg).placement_group_table()
              if row["pg_id"] == pg.id.hex()]
    _pg(pkg).remove_placement_group(pg)
    return listed


def prog_pg_strict_spread_two_nodes(rtm, pkg):
    pg = _pg(pkg).placement_group([{"CPU": 1}, {"CPU": 1}],
                                  strategy="STRICT_SPREAD")
    pg.ready(timeout=20)
    f = rtm.remote(num_cpus=1)(node_of)
    nodes = [rtm.get(f.options(scheduling_strategy=_strategy(pkg)(
        pg, placement_group_bundle_index=i)).remote(pkg), timeout=60)
        for i in (0, 1)]
    _pg(pkg).remove_placement_group(pg)
    return nodes[0] != nodes[1]   # the bundles are on distinct nodes


def prog_pg_infeasible_strict_pack_times_out(rtm, pkg):
    # 9 CPUs cannot STRICT_PACK onto 4-CPU nodes
    pg = _pg(pkg).placement_group([{"CPU": 9}], strategy="STRICT_PACK")
    ready = pg.wait(timeout_seconds=2)
    _pg(pkg).remove_placement_group(pg)
    return ready


def prog_actor_in_placement_group(rtm, pkg):
    pg = _pg(pkg).placement_group([{"CPU": 2}], strategy="PACK")
    pg.ready(timeout=20)
    a = rtm.remote(Rank).options(scheduling_strategy=_strategy(pkg)(
        pg, placement_group_bundle_index=0)).remote(pkg)
    out = rtm.get(a.ping.remote(), timeout=60)
    rtm.kill(a)
    _pg(pkg).remove_placement_group(pg)
    return out


def prog_collective_group(rtm, pkg, group="g1"):
    actors = [rtm.remote(Rank).remote(pkg) for _ in range(3)]
    c = importlib.import_module(f"{pkg}.util.collective")
    c.create_collective_group(actors, 3, [0, 1, 2], group_name=group)
    reduced = rtm.get([a.do_allreduce.remote(group) for a in actors],
                      timeout=60)
    bcast = rtm.get([a.do_broadcast.remote(group) for a in actors],
                    timeout=60)
    for a in actors:
        rtm.kill(a)
    return [_typed(x) for x in reduced + bcast]


def prog_every_collective_op(rtm, pkg):
    actors = [rtm.remote(Rank).remote(pkg) for _ in range(3)]
    c = importlib.import_module(f"{pkg}.util.collective")
    c.create_collective_group(actors, 3, [0, 1, 2], group_name="ops")
    out = rtm.get([a.every_op.remote("ops") for a in actors], timeout=60)
    for a in actors:
        rtm.kill(a)
    return out


PROGRAMS = {name[len("prog_"):]: fn for name, fn in sorted(globals().items())
            if name.startswith("prog_")}


# ---------------------------------------------------------------------------
# running them
# ---------------------------------------------------------------------------


def _jax_run():
    import sys

    import cloudpickle

    import ray_tpu
    from ray_tpu.cluster.cluster_utils import Cluster as JaxCluster
    from ray_tpu.core import api
    from ray_tpu.core.runtime_cluster import ClusterRuntime
    module = sys.modules[__name__]
    cloudpickle.register_pickle_by_value(module)
    c = JaxCluster(initialize_head=True,
                   head_node_args={"num_cpus": NODE_CPUS})
    out = {}
    try:
        c.add_node(num_cpus=NODE_CPUS)
        c.wait_for_nodes(2)
        api._runtime = ClusterRuntime(address=c.address)
        try:
            for name, prog in PROGRAMS.items():
                try:
                    out[name] = ("value", prog(ray_tpu, "ray_tpu"))
                except Exception as e:  # noqa: BLE001
                    out[name] = ("raised", type(e).__name__, str(e)[:300])
        finally:
            api._runtime.shutdown()
            api._runtime = None
    finally:
        c.shutdown()
        cloudpickle.unregister_pickle_by_value(module)
    return out


def _once(tmp_path_factory, name, compute):
    """``compute()`` once for the whole run, its result shared by the xdist
    workers through a pickle under the run's temporary root (a file lock
    lets one compute while the others wait)."""
    base = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        base = base.parent
    path = base / f"{name}.pkl"
    with open(base / f"{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not path.exists():
            result = compute()
            with open(base / f"{name}.part", "wb") as f:
                pickle.dump(result, f)
            os.replace(base / f"{name}.part", path)
    with open(path, "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    return _once(tmp_path_factory, "torch_collective_jax", _jax_run)


@pytest.fixture(scope="module")
def cluster(jax_runs):
    c = Cluster(initialize_head=True, head_node_args={"num_cpus": NODE_CPUS})
    c.add_node(num_cpus=NODE_CPUS)
    c.wait_for_nodes(2)
    rt.shutdown()    # whatever runtime an earlier module left in this worker
    rt.init(address=c.address)
    prefixes = {n.store_prefix for n in c.nodes}
    yield c
    rt.shutdown()
    c.shutdown()
    deadline = time.monotonic() + 10.0
    while _store_files(prefixes) and time.monotonic() < deadline:
        time.sleep(0.05)
    assert not _store_files(prefixes)


def _store_files(prefixes):
    return [f for f in os.listdir("/dev/shm")
            if any(f.startswith(p) for p in prefixes)]


@pytest.mark.parametrize("program", sorted(PROGRAMS))
def test_program_gives_the_jax_cluster_result(cluster, jax_runs, program):
    want = jax_runs[program]
    assert want[0] == "value", f"the JAX cluster raised: {want}"
    got = PROGRAMS[program](rt, "ray_tpu_torch")
    assert got == want[1]


# ---------------------------------------------------------------------------
# tests/test_placement_groups.py, with its assertions, on the port
# ---------------------------------------------------------------------------


def test_pg_create_ready_remove(cluster):
    pg = placement_group([{"CPU": 1}, {"CPU": 1}], strategy="PACK")
    pg.ready(timeout=20)
    table = placement_group_table()
    assert any(row["pg_id"] == pg.id.hex() and row["state"] == "CREATED"
               for row in table)
    remove_placement_group(pg)
    assert all(row["pg_id"] != pg.id.hex() for row in placement_group_table())


def test_pg_strict_spread_two_nodes(cluster):
    assert prog_pg_strict_spread_two_nodes(rt, "ray_tpu_torch") is True


def test_pg_infeasible_strict_pack_times_out(cluster):
    assert prog_pg_infeasible_strict_pack_times_out(rt, "ray_tpu_torch") \
        is False


def test_actor_in_placement_group(cluster):
    pg = placement_group([{"CPU": 2}], strategy="PACK")
    pg.ready(timeout=20)
    a = rt.remote(Rank).options(
        scheduling_strategy=PlacementGroupSchedulingStrategy(
            pg, placement_group_bundle_index=0)).remote("ray_tpu_torch")
    assert rt.get(a.ping.remote(), timeout=60) == "pong"
    rt.kill(a)
    remove_placement_group(pg)


def test_collective_group(cluster):
    # the KV keeps a group's last rounds under its name: another name than
    # the program's run on this cluster
    got = prog_collective_group(rt, "ray_tpu_torch", group="g2")
    for o in got[:3]:
        assert o == ("ndarray", "float64", [6.0] * 4)  # 1+2+3
    for o in got[3:]:
        assert o == ("ndarray", "int64", [0, 1, 2])


# ---------------------------------------------------------------------------
# the port's own rules
# ---------------------------------------------------------------------------


def test_torch_tensors_go_to_the_host_and_come_back_numpy(cluster,
                                                         jax_runs):
    """The same operations with CPU torch tensors as inputs give the JAX
    package's numpy results (a CUDA tensor takes the same path after its
    copy to the host)."""
    actors = [rt.remote(Rank).remote("ray_tpu_torch") for _ in range(3)]
    collective.create_collective_group(actors, 3, [0, 1, 2],
                                       group_name="tensors")
    got = rt.get([a.every_op.remote("tensors", tensor=True)
                  for a in actors], timeout=60)
    for a in actors:
        rt.kill(a)
    assert got == jax_runs["every_collective_op"][1]


def test_bfloat16_is_refused():
    import torch
    with pytest.raises(TypeError, match="bfloat16"):
        collective._host(torch.zeros(2, dtype=torch.bfloat16))
    assert collective._host(torch.ones(2)).dtype == np.float32


def test_slice_strategy_is_refused(cluster):
    with pytest.raises(ValueError, match="slice"):
        placement_group([{"CPU": 1}], strategy="SLICE")
    with pytest.raises(ValueError, match="Invalid strategy"):
        placement_group([{"CPU": 1}], strategy="RANDOM")


def test_a_bundle_card_reaches_its_worker(cluster):
    """A bundle that holds a card (faked on the CPU) gives the task placed
    in it that card under CUDA_VISIBLE_DEVICES."""
    node = cluster.add_node(num_cpus=1, num_gpus=1)
    cluster.wait_for_nodes(3)
    try:
        pg = placement_group([{"CPU": 1, "GPU": 1}], strategy="PACK")
        pg.ready(timeout=20)
        f = rt.remote(num_cpus=1, num_gpus=1)(visible_cards)
        got = rt.get(f.options(scheduling_strategy=(
            PlacementGroupSchedulingStrategy(
                pg, placement_group_bundle_index=0))).remote(), timeout=60)
        remove_placement_group(pg)
        assert got == "0"
    finally:
        cluster.remove_node(node, graceful=True)


def test_placement_groups_and_collectives_need_the_cluster_runtime():
    from ray_tpu_torch.core import api as core_api
    saved, core_api._runtime = core_api._runtime, None
    rt.init(num_cpus=2)
    try:
        with pytest.raises(ValueError, match=r"init\(address"):
            placement_group([{"CPU": 1}])
        with pytest.raises(RuntimeError, match=r"init\(address"):
            collective.init_collective_group(1, 0, group_name="local")
    finally:
        rt.shutdown()
        collective.destroy_collective_group("local")
        core_api._runtime = saved
