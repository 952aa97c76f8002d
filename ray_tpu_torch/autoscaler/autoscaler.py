"""Autoscaler core: demand bin-packing + provider reconciliation. Ported
from ``ray_tpu/autoscaler/autoscaler.py``.

Where the port differs: a node type is a resource shape with ``"GPU"``
where the JAX package's has ``"TPU"`` (and a TPU ``topology``, which the
port has no use for). ``FakeNodeProvider`` starts the port's
``NodeDaemon``, so a fake node whose type names ``"GPU"`` hands its GPU
leases card indices and ``CUDA_VISIBLE_DEVICES`` as any GPU node of the
port does (``cluster/node_daemon.py``); and ``terminate_node`` drains the node at the conductor before it stops the
daemon, so the cluster view drops the node at once, where the JAX provider
leaves that to the conductor's health check.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple


class NodeProvider:
    """Cloud abstraction (parity: autoscaler/node_provider.py)."""

    def create_node(self, node_type: str) -> str:
        """Launch one node of ``node_type``; returns provider node id."""
        raise NotImplementedError

    def terminate_node(self, provider_id: str) -> None:
        raise NotImplementedError

    def non_terminated_nodes(self) -> List[Tuple[str, str]]:
        """-> [(provider_id, node_type)]."""
        raise NotImplementedError

    def node_id_map(self) -> Dict[bytes, str]:
        """cluster node_id -> provider_id, for scale-down. Providers that
        cannot map (yet) return {} and opt out of termination."""
        return {}

    def can_map(self, provider_id: str) -> bool:
        """Whether node_id_map COULD ever map a cluster node to this
        provider node. The zombie sweep must skip nodes the provider is
        structurally blind to (e.g. a head/CPU VM in a GPU-only mapping) —
        'unmapped' only means 'dead or never joined' for mappable ones."""
        return True


class FakeNodeProvider(NodeProvider):
    """In-process provider: "launching a node" starts a NodeDaemon thread
    against the conductor (parity: _private/fake_multi_node)."""

    def __init__(self, conductor_address: str,
                 node_types: Dict[str, Dict[str, float]]):
        self.conductor_address = conductor_address
        self.node_types = node_types
        self._nodes: Dict[str, tuple] = {}   # provider_id -> (daemon, type)
        self._counter = 0
        self._lock = threading.Lock()

    def create_node(self, node_type: str) -> str:
        from ray_tpu_torch.cluster.node_daemon import NodeDaemon
        resources = dict(self.node_types[node_type]["resources"])
        daemon = NodeDaemon(self.conductor_address, resources=resources,
                            object_store_bytes=64 << 20)
        with self._lock:
            self._counter += 1
            pid = f"fake-{node_type}-{self._counter}"
            self._nodes[pid] = (daemon, node_type)
        return pid

    def terminate_node(self, provider_id: str) -> None:
        with self._lock:
            entry = self._nodes.pop(provider_id, None)
        if entry:
            # Drain first, as Cluster.remove_node(graceful=True) does: the
            # cluster view drops the node now, not at its health timeout.
            from ray_tpu_torch.cluster.protocol import get_client
            try:
                get_client(self.conductor_address).call(
                    "drain_node", node_id=entry[0].node_id)
            except Exception:
                pass
            entry[0].stop()

    def non_terminated_nodes(self) -> List[Tuple[str, str]]:
        with self._lock:
            return [(pid, t) for pid, (d, t) in self._nodes.items()]

    def daemon_node_id(self, provider_id: str) -> Optional[bytes]:
        entry = self._nodes.get(provider_id)
        return entry[0].node_id if entry else None

    def node_id_map(self) -> Dict[bytes, str]:
        with self._lock:
            return {d.node_id: pid for pid, (d, t) in self._nodes.items()}


def _fits(avail: Dict[str, float], shape: Dict[str, float]) -> bool:
    return all(avail.get(k, 0.0) + 1e-9 >= v for k, v in shape.items()
               if v > 0)


def _take(avail: Dict[str, float], shape: Dict[str, float]) -> None:
    for k, v in shape.items():
        avail[k] = avail.get(k, 0.0) - v


def fit_demand(demand: List[Dict[str, float]],
               node_avail: List[Dict[str, float]],
               node_types: Dict[str, dict],
               max_per_type: Optional[Dict[str, int]] = None
               ) -> Dict[str, int]:
    """Bin-pack pending demand onto existing capacity; whatever is left
    maps to new nodes by type (parity: resource_demand_scheduler.py:101
    get_nodes_to_launch)."""
    avail = [dict(a) for a in node_avail]
    unmet: List[Dict[str, float]] = []
    for shape in demand:
        placed = False
        for a in avail:
            if _fits(a, shape):
                _take(a, shape)
                placed = True
                break
        if not placed:
            unmet.append(shape)
    to_launch: Dict[str, int] = {}
    virtual: List[Dict[str, float]] = []
    for shape in unmet:
        placed = False
        for v in virtual:
            if _fits(v, shape):
                _take(v, shape)
                placed = True
                break
        if placed:
            continue
        for tname, tcfg in node_types.items():
            res = tcfg["resources"]
            cap = (max_per_type or {}).get(
                tname, tcfg.get("max_workers", 10))
            if to_launch.get(tname, 0) >= cap:
                continue
            if _fits(dict(res), shape):
                to_launch[tname] = to_launch.get(tname, 0) + 1
                fresh = dict(res)
                _take(fresh, shape)
                virtual.append(fresh)
                break
        # unplaceable on any type -> dropped (infeasible demand)
    return to_launch


class StandardAutoscaler:
    """Reconcile loop (parity: autoscaler.py:172 StandardAutoscaler.update):
    read load from the conductor, launch nodes for unmet demand, terminate
    nodes idle past the timeout."""

    def __init__(self, conductor_address: str, provider: NodeProvider,
                 node_types: Dict[str, dict],
                 idle_timeout_s: float = 30.0,
                 update_interval_s: float = 1.0,
                 max_workers: int = 20,
                 zombie_grace_s: float = 600.0,
                 min_per_type: Optional[Dict[str, int]] = None):
        from ray_tpu_torch.cluster.protocol import get_client
        self.conductor = get_client(conductor_address)
        self.provider = provider
        self.node_types = node_types
        self.idle_timeout_s = idle_timeout_s
        self.update_interval_s = update_interval_s
        self.max_workers = max_workers
        # Reconciled per-type floor (cluster-launcher min_workers): the
        # loop replenishes below-floor types and idle-termination never
        # drops a type below it.
        self.min_per_type = dict(min_per_type or {})
        # How long a provider node may run with ZERO registered cluster
        # nodes before it is terminated (covers boot time; after that it's
        # a cost leak — a dead VM or a broken startup script). The default
        # must exceed worst-case provisioning+boot, or scale-up churns:
        # launch → terminate-at-grace → relaunch.
        self.zombie_grace_s = zombie_grace_s
        self._idle_since: Dict[bytes, float] = {}
        self._zombie_since: Dict[str, float] = {}
        self._stopped = False
        self._thread: Optional[threading.Thread] = None

    def update(self) -> Dict[str, int]:
        """One reconcile pass; returns what was launched."""
        load = self.conductor.call("cluster_load")
        workers = self.provider.non_terminated_nodes()
        launched: Dict[str, int] = {}
        # Replenish the per-type floor first (a zombie sweep or crash may
        # have dropped below it).
        if self.min_per_type:
            have: Dict[str, int] = {}
            for _, t in workers:
                have[t] = have.get(t, 0) + 1
            for tname, floor in self.min_per_type.items():
                for _ in range(max(0, floor - have.get(tname, 0))):
                    if len(workers) + sum(launched.values()) >= \
                            self.max_workers:
                        break
                    self.provider.create_node(tname)
                    launched[tname] = launched.get(tname, 0) + 1
        if len(workers) + sum(launched.values()) < self.max_workers:
            # per-type caps are cluster-wide: subtract what already runs
            # AND what the replenish loop above just launched (those nodes
            # aren't in non_terminated_nodes() yet; ignoring them lets one
            # reconcile pass overshoot max_workers / per-type caps).
            existing: Dict[str, int] = dict(launched)
            for _, t in workers:
                existing[t] = existing.get(t, 0) + 1
            caps = {t: max(0, cfg.get("max_workers", 10) -
                           existing.get(t, 0))
                    for t, cfg in self.node_types.items()}
            to_launch = fit_demand(
                load["demand"],
                [n["resources_available"] for n in load["nodes"]],
                self.node_types, max_per_type=caps)
            for tname, count in to_launch.items():
                for _ in range(count):
                    if len(workers) + sum(launched.values()) >= \
                            self.max_workers:
                        break
                    self.provider.create_node(tname)
                    launched[tname] = launched.get(tname, 0) + 1
        # scale down: terminate provider nodes idle past the timeout.
        # Termination is per PROVIDER node: one provider id may map several
        # cluster nodes, and it may only be deleted when EVERY one of them
        # has been idle past the timeout.
        now = time.monotonic()
        by_node_id = self.provider.node_id_map()
        per_provider: Dict[str, List[bytes]] = {}
        for n in load["nodes"]:
            nid = n["node_id"]
            if n["is_head"] or nid not in by_node_id:
                continue
            per_provider.setdefault(by_node_id[nid], []).append(nid)
            idle = n["resources_available"] == n["resources_total"] and \
                not load["demand"]
            if idle:
                self._idle_since.setdefault(nid, now)
            else:
                self._idle_since.pop(nid, None)
        type_of = dict(workers)
        remaining: Dict[str, int] = {}
        for _, t in workers:
            remaining[t] = remaining.get(t, 0) + 1
        for provider_id, nids in per_provider.items():
            if all(nid in self._idle_since and
                   now - self._idle_since[nid] > self.idle_timeout_s
                   for nid in nids):
                t = type_of.get(provider_id, "")
                if remaining.get(t, 0) <= self.min_per_type.get(t, 0):
                    continue  # never drop below the floor
                remaining[t] = remaining.get(t, 0) - 1
                self.provider.terminate_node(provider_id)
                for nid in nids:
                    self._idle_since.pop(nid, None)
        # Prune idle tracking for nodes that vanished from the cluster
        # view (died / deregistered) so stale entries don't accumulate.
        live_nids = {n["node_id"] for n in load["nodes"]}
        for nid in list(self._idle_since):
            if nid not in live_nids:
                self._idle_since.pop(nid, None)
        # Zombie providers: a non-terminated provider node with NO
        # registered cluster node (it died, or its startup never joined).
        # Scale-down above only examines providers with live cluster
        # nodes, so without this sweep such a VM would never be terminated
        # — a pure cost leak. "Registered" is judged from the provider's
        # own node_id_map over ALL live nodes (head included —
        # per_provider excludes it); a provider whose map is empty cannot
        # distinguish booting from dead and opts out of termination
        # entirely (NodeProvider.node_id_map contract).
        if by_node_id:
            registered = {by_node_id[nid] for nid in live_nids
                          if nid in by_node_id}
            for pid, _t in workers:
                if pid in registered:
                    self._zombie_since.pop(pid, None)
                elif not self.provider.can_map(pid):
                    # The provider can never map this node: unmapped is NOT
                    # a death signal for it — terminating would kill a live
                    # VM.
                    self._zombie_since.pop(pid, None)
                elif now - self._zombie_since.setdefault(pid, now) > \
                        self.zombie_grace_s:
                    self.provider.terminate_node(pid)
                    self._zombie_since.pop(pid, None)
        alive_pids = {pid for pid, _t in workers}
        for pid in list(self._zombie_since):
            if pid not in alive_pids:
                self._zombie_since.pop(pid, None)
        return launched

    def start(self) -> None:
        def loop():
            while not self._stopped:
                try:
                    self.update()
                except Exception:
                    pass
                time.sleep(self.update_interval_s)
        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="autoscaler")
        self._thread.start()

    def stop(self) -> None:
        self._stopped = True
