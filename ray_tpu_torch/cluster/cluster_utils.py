"""In-process multi-node test cluster.

Role parity: python/ray/cluster_utils.py:99 (Cluster, add_node:165,
remove_node:238) — the reference's standard way to test distributed
behavior (spillback, node death, transfer) without real machines: one
conductor plus N node daemons in this process, workers as real
subprocesses, each node with its own shm object store.

Ported from ``ray_tpu/cluster/cluster_utils.py``: ``add_node`` takes
``num_gpus`` where the JAX module takes ``num_tpus``. Left at None, the
head counts this host's cards (``gpu.topology.local_gpu_count``) and
another node gets none; a number fakes that many cards on the node.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from ray_tpu_torch.cluster.conductor import Conductor
from ray_tpu_torch.cluster.node_daemon import NodeDaemon
from ray_tpu_torch.cluster.protocol import get_client


class Cluster:
    def __init__(self, initialize_head: bool = True,
                 head_node_args: Optional[dict] = None,
                 health_timeout_s: float = 3.0,
                 host: str = "127.0.0.1"):
        self.conductor = Conductor(host=host,
                                   health_timeout_s=health_timeout_s)
        self.address = self.conductor.address
        self.nodes: List[NodeDaemon] = []
        if initialize_head:
            # The auto-created head inherits the CLUSTER host unless the
            # caller overrides it (a conductor on a LAN IP with its head
            # node quietly on 127.0.0.1 would be unreachable remotely).
            self.add_node(is_head=True,
                          **{"host": host, **(head_node_args or {})})

    def add_node(self, num_cpus: float = 4.0,
                 num_gpus: Optional[float] = None,
                 resources: Optional[Dict[str, float]] = None,
                 object_store_bytes: int = 256 << 20,
                 is_head: bool = False,
                 gpu_domain: Optional[dict] = None,
                 host: str = "127.0.0.1") -> NodeDaemon:
        """``gpu_domain`` injects fake NVLink-domain membership (slice_id,
        accelerator_type, generation, worker_id, num_hosts, gpus_per_host),
        the test analog of a GPU host's ``gpu.topology.detect_domain()``, as
        the JAX ``tpu_slice`` fakes a TPU host's slice."""
        total = {"CPU": float(num_cpus)}
        if num_gpus is None and is_head:
            from ray_tpu_torch.gpu.topology import local_gpu_count
            num_gpus = local_gpu_count()
        if num_gpus:
            total["GPU"] = float(num_gpus)
        total.update(resources or {})
        node = NodeDaemon(self.address, resources=total, host=host,
                          object_store_bytes=object_store_bytes,
                          is_head=is_head, gpu_domain=gpu_domain)
        self.nodes.append(node)
        return node

    def remove_node(self, node: NodeDaemon, graceful: bool = False) -> None:
        """Kill a node (workers included). graceful=True tells the conductor
        first; False simulates a crash (health check finds out)."""
        if graceful:
            try:
                get_client(self.address).call("drain_node",
                                              node_id=node.node_id)
            except Exception:
                pass
        node.stop()
        if node in self.nodes:
            self.nodes.remove(node)

    def wait_for_nodes(self, count: int, timeout: float = 10.0) -> None:
        import time
        deadline = time.monotonic() + timeout
        cli = get_client(self.address)
        while time.monotonic() < deadline:
            alive = [n for n in cli.call("get_nodes") if n["alive"]]
            if len(alive) >= count:
                return
            time.sleep(0.05)
        raise TimeoutError(f"cluster never reached {count} nodes")

    def shutdown(self) -> None:
        for node in list(self.nodes):
            node.stop()
        self.nodes.clear()
        self.conductor.stop()
