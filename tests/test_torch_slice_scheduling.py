"""NVLink-domain gang placement in the port (``SLICE`` placement groups,
``SliceSchedulingStrategy``, ``ScalingConfig(topology=)``), held to the JAX
package's TPU-slice placement.

- *Ported tests:* ``tests/test_slice_scheduling.py``'s six and
  ``tests/test_elastic_multislice.py::test_training_moves_to_surviving_slice``,
  on fake domains: hosts that ``Cluster.add_node(gpu_domain=...)`` gives the
  membership ``gpu/topology.py:detect_domain`` would report, and fake cards
  (``num_gpus``). A JAX v4-8 slice is 2 hosts of 4 chips; its counterpart
  here is an h100-16 domain, 2 hosts of 8 cards, and a bundle of a host's
  chips becomes a bundle of a host's cards.
- *Placement parity:* the same layout of fake domains and the same sequence
  of placement-group requests go to a JAX conductor (fake ``tpu_slice``)
  and to the port's (fake ``gpu_domain``), straight through the conductor's
  RPCs, with a bundle a host. The hosts chosen (by domain and rank) and the
  requests left pending must be equal.
- *The port's rule past JAX's:* a domain's hosts are filled in order, each
  up to its share of the domain's cards, so 16 one-card ranks of an h100-16
  gang take host 0's 8 cards, then host 1's.

Module-level functions here are imported by the port's workers by name, so
this module imports JAX only inside functions.
"""

import threading
import time

import pytest

import ray_tpu_torch as rt
from ray_tpu_torch.cluster.cluster_utils import Cluster
from ray_tpu_torch.cluster.protocol import get_client
from ray_tpu_torch.util.placement_group import (placement_group,
                                                remove_placement_group)
from ray_tpu_torch.util.scheduling_strategies import SliceSchedulingStrategy

DOMAIN = "h100-16"          # 2 hosts of 8 cards: the v4-8 of these tests
CARDS = 8


def _domain(domain_id, worker_id, num_hosts=2, at=DOMAIN, gen="h100",
            per_host=CARDS):
    return {"slice_id": domain_id, "accelerator_type": at,
            "generation": gen, "worker_id": worker_id,
            "num_hosts": num_hosts, "gpus_per_host": per_host}


@pytest.fixture()
def domain_cluster():
    """Head (driver, CPU-only) + two complete 2-host h100-16 domains."""
    rt.shutdown()
    c = Cluster(initialize_head=True, head_node_args={"num_cpus": 1})
    node_by_domain = {}
    for did in ("domainA", "domainB"):
        node_by_domain[did] = [
            c.add_node(num_cpus=4, num_gpus=CARDS,
                       gpu_domain=_domain(did, i)) for i in range(2)]
    c.wait_for_nodes(5)
    runtime = rt.init(address=c.address)
    yield c, runtime, node_by_domain
    rt.shutdown()
    c.shutdown()


def _domain_of(node_by_domain, node_id):
    for did, nodes in node_by_domain.items():
        if any(n.node_id == node_id for n in nodes):
            return did
    return None


def test_conductor_slice_view(domain_cluster):
    c, _, _ = domain_cluster
    slices = get_client(c.address).call("get_slices")
    assert {s["slice_id"] for s in slices} == {"domainA", "domainB"}
    for s in slices:
        assert s["complete"] and s["registered_hosts"] == 2
        assert s["accelerator_type"] == DOMAIN
        assert s["gpus_per_host"] == CARDS
    # the typed resource beside the generic count (gpu_resources' role)
    node = next(n for n in get_client(c.address).call("get_nodes")
                if n.get("gpu_domain"))
    assert node["resources_total"]["GPU-h100"] == CARDS


def test_slice_pg_lands_on_one_slice_rank_ordered(domain_cluster):
    _, runtime, node_by_domain = domain_cluster
    pg = placement_group([{"GPU": CARDS}, {"GPU": CARDS}], strategy="SLICE",
                         slice_topology=DOMAIN)
    pg.ready(timeout=30)
    info = runtime.pg_ready(pg.id.binary())
    dids = {_domain_of(node_by_domain, n) for n in info["bundle_nodes"]}
    assert len(dids) == 1, f"gang spans domains: {dids}"
    assert info["slice_id"] in ("domainA", "domainB")
    # bundle i -> the domain's rank-i host (worker_id order)
    chosen = node_by_domain[dids.pop()]
    assert info["bundle_nodes"] == [n.node_id for n in chosen]
    remove_placement_group(pg)


def test_slice_pg_fills_the_domain_host_by_host(domain_cluster):
    """16 one-card ranks: host 0's 8 cards, then host 1's; a 17th card is
    more than any domain holds, so that gang stays pending."""
    _, runtime, node_by_domain = domain_cluster
    pg = placement_group([{"GPU": 1}] * 16, strategy="SLICE",
                         slice_topology=DOMAIN)
    pg.ready(timeout=30)
    info = runtime.pg_ready(pg.id.binary())
    hosts = node_by_domain[info["slice_id"]]
    assert info["bundle_nodes"] == [hosts[0].node_id] * 8 + \
        [hosts[1].node_id] * 8
    too_big = placement_group([{"GPU": 1}] * 17, strategy="SLICE")
    assert not too_big.wait(timeout_seconds=1.5)
    assert runtime.pg_ready(too_big.id.binary())["state"] == "PENDING"
    for p in (pg, too_big):
        remove_placement_group(p)


def test_slice_pg_queues_until_slice_frees(domain_cluster):
    _, runtime, _ = domain_cluster
    pgs = [placement_group([{"GPU": CARDS}, {"GPU": CARDS}],
                           strategy="SLICE") for _ in range(2)]
    for pg in pgs:
        pg.ready(timeout=30)
    infos = [runtime.pg_ready(pg.id.binary()) for pg in pgs]
    assert {i["slice_id"] for i in infos} == {"domainA", "domainB"}
    # Both domains full: a third gang must queue, not spread across them.
    pg3 = placement_group([{"GPU": CARDS}, {"GPU": CARDS}], strategy="SLICE")
    assert not pg3.wait(timeout_seconds=2.0)
    assert runtime.pg_ready(pg3.id.binary())["state"] == "PENDING"
    # Freeing one domain unblocks it.
    remove_placement_group(pgs[0])
    pg3.ready(timeout=30)
    assert runtime.pg_ready(pg3.id.binary())["state"] == "CREATED"
    for pg in (pgs[1], pg3):
        remove_placement_group(pg)


def test_slice_pg_refuses_infeasible_topology(domain_cluster):
    _, runtime, _ = domain_cluster
    # No gb200-72 domain exists; the request must stay PENDING (refused),
    # never satisfied by packing onto h100 hosts.
    pg = placement_group([{"GPU": 4}], strategy="SLICE",
                         slice_topology="gb200-72")
    assert not pg.wait(timeout_seconds=2.0)
    assert runtime.pg_ready(pg.id.binary())["state"] == "PENDING"
    remove_placement_group(pg)
    # Likewise a gang larger than any one domain (3 host-sized bundles).
    pg = placement_group([{"GPU": CARDS}] * 3, strategy="SLICE",
                         slice_topology=DOMAIN)
    assert not pg.wait(timeout_seconds=2.0)
    assert runtime.pg_ready(pg.id.binary())["state"] == "PENDING"
    remove_placement_group(pg)


def occupy(t):
    time.sleep(t)
    return 1


def answer():
    return 42


def test_slice_scheduling_strategy_task(domain_cluster):
    _, _, node_by_domain = domain_cluster
    domain_node_ids = {n.node_id.hex() for nodes in node_by_domain.values()
                       for n in nodes}
    # Identify placement via the conductor's resource bookkeeping: run
    # tasks and check they consumed GPU on domain hosts only.
    f = rt.remote(num_gpus=1, scheduling_strategy=SliceSchedulingStrategy(
        topology=DOMAIN))(occupy)
    refs = [f.remote(1.0) for _ in range(4)]
    deadline = time.time() + 20
    used_on_domain = False
    while time.time() < deadline:
        for n in rt.nodes():
            if n["NodeID"] in domain_node_ids:
                total = n["Resources"].get("GPU", 0.0)
                avail = n["Available"].get("GPU", total)
                if avail < total:
                    used_on_domain = True
        if used_on_domain:
            break
        time.sleep(0.1)
    assert rt.get(refs, timeout=60) == [1] * 4
    assert used_on_domain


def test_slice_strategy_no_matching_slice_queues():
    """With no domains registered at all, a domain-strategy task waits (and
    completes once a matching domain joins)."""
    rt.shutdown()
    c = Cluster(initialize_head=True, head_node_args={"num_cpus": 1})
    rt.init(address=c.address)
    try:
        f = rt.remote(num_gpus=1, scheduling_strategy=SliceSchedulingStrategy(
            topology=DOMAIN))(answer)
        ref = f.remote()
        ready, _ = rt.wait([ref], timeout=1.5)
        assert not ready  # queued: no domain to run on
        for i in range(2):
            c.add_node(num_cpus=4, num_gpus=CARDS,
                       gpu_domain=_domain("late", i))
        assert rt.get(ref, timeout=60) == 42
    finally:
        rt.shutdown()
        c.shutdown()


# ---------------------------------------------------------------------------
# test_elastic_multislice.py::test_training_moves_to_surviving_slice
# ---------------------------------------------------------------------------


def ckpt_loop(config):
    from ray_tpu_torch.air import session
    from ray_tpu_torch.air.checkpoint import Checkpoint

    start = 0
    ck = session.get_checkpoint()
    if ck is not None:
        start = ck.to_dict()["step"] + 1
    for step in range(start, config["steps"]):
        time.sleep(config.get("step_time", 0.05))
        session.report(
            {"step": step, "world_size": session.get_world_size()},
            checkpoint=Checkpoint.from_dict({"step": step}))


def test_training_moves_to_surviving_slice(tmp_path):
    """SLICE-placed gang (2-host h100-16 domains, a rank a host's cards):
    killing one host of the ACTIVE domain breaks it; the re-formed gang
    lands on the other complete domain and resumes from the checkpoint."""
    from ray_tpu_torch.air import (FailureConfig, RunConfig, ScalingConfig)
    from ray_tpu_torch.train import DataParallelTrainer
    rt.shutdown()
    c = Cluster(initialize_head=True, head_node_args={"num_cpus": 2},
                health_timeout_s=2.0)
    hosts = {}
    for did in ("s1", "s2"):
        hosts[did] = [
            c.add_node(num_cpus=2, num_gpus=CARDS,
                       gpu_domain=_domain(did, w)) for w in range(2)]
    rt.init(address=c.address)
    try:
        scaling = ScalingConfig(cpus_per_worker=1.0,
                                gpus_per_worker=float(CARDS),
                                topology=DOMAIN)
        assert scaling.num_workers == 2
        trainer = DataParallelTrainer(
            ckpt_loop,
            train_loop_config={"steps": 30, "step_time": 0.1},
            scaling_config=scaling,
            run_config=RunConfig(
                storage_path=str(tmp_path),
                failure_config=FailureConfig(max_failures=3, elastic=True)))
        victim = {}

        def chaos():
            cli = get_client(c.address)
            time.sleep(2.0)
            # kill one host of whichever domain the gang landed on
            pgs = cli.call("list_placement_groups")
            active = {pg["slice_id"] for pg in pgs if pg["slice_id"]}
            for did, nodes in hosts.items():
                if did in active:
                    victim["slice"] = did
                    c.remove_node(nodes[0])
                    break
            # watch for the re-formed gang's placement
            deadline = time.monotonic() + 60
            while time.monotonic() < deadline:
                pgs = cli.call("list_placement_groups")
                placed = {pg["slice_id"] for pg in pgs
                          if pg["slice_id"] and pg["state"] == "CREATED"}
                if placed and victim.get("slice") not in placed:
                    victim["migrated_to"] = sorted(placed)
                    return
                time.sleep(0.25)

        threading.Thread(target=chaos, daemon=True).start()
        result = trainer.fit()
        assert result.error is None, f"training failed: {result.error}"
        assert result.metrics["step"] == 29
        assert result.metrics["world_size"] == 2
        assert "slice" in victim, "chaos thread never found the active domain"
        assert victim.get("migrated_to"), (
            "gang never re-placed on the surviving domain")
        assert victim["slice"] not in victim["migrated_to"]
    finally:
        rt.shutdown()
        c.shutdown()


# ---------------------------------------------------------------------------
# placement parity with the JAX conductor
# ---------------------------------------------------------------------------

# (domain, hosts registered, hosts in the domain, type index); the JAX run
# uses TPU types of the same host counts, the port GPU domain types.
LAYOUT = [("A", 2, 2, 0), ("B", 2, 2, 0), ("C", 4, 4, 1), ("D", 1, 2, 0),
          ("E", 2, 2, 2)]
JAX_TYPES = [("v4-8", "v4", 4), ("v4-16", "v4", 4), ("v5e-16", "v5e", 8)]
PORT_TYPES = [("h100-16", "h100", 8), ("h100-32", "h100", 8),
              ("h200-16", "h200", 8)]
# (label, hosts' worth of bundles, type index or None for any domain,
# seconds to wait for it to place before the next request); "-X" removes
# request X. A conductor sees a commit's resources at the hosts' next
# heartbeat, so each request settles before the next is sent: the
# placements then follow from the sequence alone.
REQUESTS = [("p1", 2, 0, 10), ("p2", 2, 0, 10), ("p3", 2, 0, 2),
            ("p4", 4, 1, 10), ("p5", 3, 0, 2), ("p6", 2, 1, 2),
            ("-p1", None, None, 10), ("p7", 1, None, 10), ("p8", 4, None, 2)]


def _placement_run(pkg):
    """Each request's state and chosen (domain, rank) hosts on ``pkg``'s
    conductor, with no driver: the conductor's own RPCs, as a runtime's
    ``placement_group`` sends them."""
    import importlib
    cu = importlib.import_module(f"{pkg}.cluster.cluster_utils")
    ids = importlib.import_module(f"{pkg}.core.ids")
    types = JAX_TYPES if pkg == "ray_tpu" else PORT_TYPES
    c = cu.Cluster(initialize_head=False)
    try:
        label_of = {}
        for did, registered, num_hosts, t in LAYOUT:
            at, gen, per = types[t]
            for w in range(registered):
                member = {"slice_id": did, "accelerator_type": at,
                          "generation": gen, "worker_id": w,
                          "num_hosts": num_hosts}
                if pkg == "ray_tpu":
                    node = c.add_node(num_cpus=1, num_tpus=per,
                                      tpu_slice=member)
                else:
                    node = c.add_node(num_cpus=1, num_gpus=per,
                                      gpu_domain={**member,
                                                  "gpus_per_host": per})
                label_of[node.node_id] = f"{did}{w}"
        c.wait_for_nodes(len(label_of))
        cli = get_client(c.address)
        key = "TPU" if pkg == "ray_tpu" else "GPU"
        pg_ids, out = {}, []
        for label, n, t, wait in REQUESTS:
            if label.startswith("-"):
                cli.call("remove_placement_group", pg_id=pg_ids[label[1:]])
                # the queued gang that the freed domain fits takes it
                cli.call("pg_ready", pg_id=pg_ids["p3"], timeout=wait)
                continue
            pg_id = ids.PlacementGroupID.from_random().binary()
            pg_ids[label] = pg_id
            per = types[t or 0][2]
            cli.call("create_placement_group", pg_id=pg_id,
                     bundles=[{key: float(per)}] * n, strategy="SLICE",
                     slice_topology="" if t is None else types[t][0])
            cli.call("pg_ready", pg_id=pg_id, timeout=wait)
            time.sleep(1.0)   # the hosts' heartbeats report the commit
        for label, _, _, _ in REQUESTS:
            if label.startswith("-"):
                continue
            info = cli.call("pg_ready", pg_id=pg_ids[label], timeout=0.0)
            out.append((label, info["state"], info.get("slice_id"),
                        [label_of.get(n)
                         for n in info.get("bundle_nodes", [])]))
        return out
    finally:
        c.shutdown()


def test_slice_placement_matches_the_jax_conductor():
    want = _placement_run("ray_tpu")
    got = _placement_run("ray_tpu_torch")
    assert got == want
    # what the sequence exercises: rank-ordered gangs, a full layout
    # queueing, a freed domain taken by the queued gang, an incomplete
    # domain never used, a gang larger than any domain left pending, and
    # a half-used domain refusing a gang of its size
    assert want == [
        ("p1", "UNKNOWN", None, []),
        ("p2", "CREATED", "B", ["B0", "B1"]),
        ("p3", "CREATED", "A", ["A0", "A1"]),
        ("p4", "CREATED", "C", ["C0", "C1", "C2", "C3"]),
        ("p5", "PENDING", None, [None] * 3),
        ("p6", "PENDING", None, [None] * 2),
        ("p7", "CREATED", "E", ["E0"]),
        ("p8", "PENDING", None, [None] * 4)]


def test_placement_group_records_survive_a_snapshot():
    """``slice_topology`` and ``slice_id`` persist on the PG record, as the
    JAX conductor's do."""
    from ray_tpu_torch.cluster.conductor import Conductor
    rt.shutdown()
    c = Cluster(initialize_head=False)
    try:
        for w in range(2):
            c.add_node(num_cpus=1, num_gpus=CARDS,
                       gpu_domain=_domain("snap", w))
        c.wait_for_nodes(2)
        from ray_tpu_torch.core.ids import PlacementGroupID
        pg_id = PlacementGroupID.from_random().binary()
        cli = get_client(c.address)
        cli.call("create_placement_group", pg_id=pg_id,
                 bundles=[{"GPU": CARDS}] * 2, strategy="SLICE",
                 slice_topology=DOMAIN)
        assert cli.call("pg_ready", pg_id=pg_id, timeout=10)["slice_id"] \
            == "snap"
        with c.conductor._lock:
            snap = c.conductor._durable_state()
        rec = next(r for r in snap["pgs"] if r["pg_id"] == pg_id)
        assert (rec["slice_topology"], rec["slice_id"]) == (DOMAIN, "snap")
        fresh = Conductor.__new__(Conductor)
        fresh._nodes, fresh._actors, fresh._named_actors = {}, {}, {}
        fresh._pgs, fresh._kv, fresh._functions = {}, {}, {}
        fresh._apply_snapshot(snap)
        back = fresh._pgs[pg_id]
        assert (back.slice_topology, back.slice_id, back.state) == \
            (DOMAIN, "snap", "CREATED")
    finally:
        c.shutdown()


# ---------------------------------------------------------------------------
# domains as detected: hosts started alike, and the PG record's slice_id
# ---------------------------------------------------------------------------


def _hgx_topo(n=CARDS):
    """``nvidia-smi topo -m`` of an HGX board: every pair of cards on NV18."""
    header = "\t" + "\t".join(f"GPU{i}" for i in range(n)) + "\tCPU Affinity"
    rows = [f"GPU{i}\t" + "\t".join(" X " if j == i else "NV18"
                                   for j in range(n)) + "\t0-55"
            for i in range(n)]
    return "\n".join([header, *rows]) + "\n"


def _slice_pg(cli, bundles, topology="", wait=10.0):
    from ray_tpu_torch.core.ids import PlacementGroupID
    pg_id = PlacementGroupID.from_random().binary()
    cli.call("create_placement_group", pg_id=pg_id, bundles=bundles,
             strategy="SLICE", slice_topology=topology)
    return pg_id, cli.call("pg_ready", pg_id=pg_id, timeout=wait)


def test_hosts_started_alike_are_separate_domains():
    """Two HGX hosts started with no launcher read the same topology text.
    Each is a domain of its own (named after its cards), so a gang of one
    host's cards never spans them: with one card busy on the first host, an
    8-card gang takes the second host whole, and the next 8-card gang
    waits rather than take 7 cards here and 1 there."""
    from ray_tpu_torch.gpu import topology
    rt.shutdown()
    c = Cluster(initialize_head=False)
    try:
        for h in range(2):
            uuids = [f"GPU-{h:08x}-0000-4000-8000-{i:012x}"
                     for i in range(CARDS)]
            dom = topology.domain_from_probe(
                ["NVIDIA H100 80GB HBM3"] * CARDS, _hgx_topo(), "", env={},
                uuids=uuids)
            c.add_node(num_cpus=1, num_gpus=CARDS, gpu_domain=dom)
        c.wait_for_nodes(2)
        cli = get_client(c.address)
        slices = cli.call("get_slices")
        assert len(slices) == 2
        assert all(s["complete"] and s["registered_hosts"] == 1
                   and s["accelerator_type"] == "h100-8" for s in slices)
        _, one = _slice_pg(cli, [{"GPU": 1.0}], "h100-8")
        assert one["state"] == "CREATED"
        time.sleep(1.0)   # the hosts' heartbeats report the commit
        _, gang = _slice_pg(cli, [{"GPU": 1.0}] * CARDS, "h100-8")
        assert gang["state"] == "CREATED"
        assert len(set(gang["bundle_nodes"])) == 1
        assert gang["bundle_nodes"][0] != one["bundle_nodes"][0]
        assert gang["slice_id"] != one["slice_id"]
        time.sleep(1.0)
        _, wide = _slice_pg(cli, [{"GPU": 1.0}] * CARDS, wait=2.0)
        assert (wide["state"], wide["slice_id"]) == ("PENDING", None)
    finally:
        c.shutdown()


def test_hosts_that_clash_on_a_domain_are_no_domain():
    """Two hosts that report one domain name, each as its rank 0 of a
    one-host domain, do not make a domain: the view marks it incomplete
    and a gang on it waits."""
    rt.shutdown()
    c = Cluster(initialize_head=False)
    try:
        for _ in range(2):
            c.add_node(num_cpus=1, num_gpus=CARDS, gpu_domain=_domain(
                "local-h100-8", 0, num_hosts=1, at="h100-8"))
        c.wait_for_nodes(2)
        cli = get_client(c.address)
        (view,) = cli.call("get_slices")
        assert (view["registered_hosts"], view["complete"]) == (2, False)
        _, gang = _slice_pg(cli, [{"GPU": 1.0}] * CARDS, wait=2.0)
        assert (gang["state"], gang["slice_id"]) == ("PENDING", None)
    finally:
        c.shutdown()


def test_slice_id_is_set_only_when_the_gang_is_placed(monkeypatch):
    """A domain whose hosts refuse the prepare leaves the gang PENDING with
    no domain on its record; once they grant it, the record names it."""
    from ray_tpu_torch.cluster import conductor as conductor_mod
    rt.shutdown()
    c = Cluster(initialize_head=False)
    real = conductor_mod.get_client

    class RefusingPrepare:
        def __init__(self, address):
            self._client = real(address)

        def call(self, method, **kw):
            if method == "prepare_bundle":
                return False
            return self._client.call(method, **kw)

    try:
        for w in range(2):
            c.add_node(num_cpus=1, num_gpus=CARDS,
                       gpu_domain=_domain("refusing", w))
        c.wait_for_nodes(2)
        cli = get_client(c.address)
        monkeypatch.setattr(conductor_mod, "get_client", RefusingPrepare)
        pg_id, info = _slice_pg(cli, [{"GPU": CARDS}] * 2, DOMAIN, wait=1.5)
        assert (info["state"], info["slice_id"]) == ("PENDING", None)
        (listed,) = [p for p in cli.call("list_placement_groups")
                     if p["pg_id"] == pg_id.hex()]
        assert (listed["state"], listed["slice_id"]) == ("PENDING", None)
        monkeypatch.undo()
        info = cli.call("pg_ready", pg_id=pg_id, timeout=10)
        assert (info["state"], info["slice_id"]) == ("CREATED", "refusing")
    finally:
        monkeypatch.undo()
        c.shutdown()
