"""Host-level collective groups for actors. Ported from
``ray_tpu/util/collective.py``.

Role parity: python/ray/util/collective/collective.py:120-640: declare a
collective group over N actors, then call allreduce/allgather/
reducescatter/broadcast/send/recv/barrier by group name. The reference
backs this with NCCL or gloo; the port's device data plane is
``torch.distributed`` (``parallel/collectives.py``, the trainer's NCCL or
gloo group), so this module covers the reference's CPU role: host values
between actors, met through the conductor's KV (the role the GCS internal
KV plays for NCCL's unique-id exchange, nccl_util.py).

A fan-in/fan-out over the cluster KV: rank 0 reduces and publishes, peers
long-poll. O(N) per op; fine for control-plane-sized payloads (a weight
broadcast rides the object store instead, ``train/weight_sync.py``).

Where the port differs from the JAX module: a torch tensor, on the card or
the CPU, is copied to the host as numpy before it is published, and every
result is numpy, as in the JAX package. A bfloat16 tensor raises
``TypeError`` (numpy has no bfloat16). The group meets through the
conductor, so it needs the cluster runtime (``init(address=...)``).
"""

from __future__ import annotations

import pickle
import threading
from typing import Any, Dict, List

import numpy as np

_NS = "collective"
_groups: Dict[str, "_Group"] = {}
_lock = threading.Lock()


def _host(value) -> np.ndarray:
    """``value`` as a host numpy array; a tensor leaves the card first."""
    if type(value).__module__.split(".")[0] == "torch":
        t = value.detach()
        if str(t.dtype) == "torch.bfloat16":
            raise TypeError("the host collective moves numpy values and "
                            "numpy has no bfloat16: cast the tensor first")
        return t.cpu().numpy()
    return np.asarray(value)


class _Group:
    def __init__(self, world_size: int, rank: int, group_name: str):
        self.world_size = world_size
        self.rank = rank
        self.name = group_name
        self.seq = 0

    def _kv(self):
        from ray_tpu_torch.core.api import _global_runtime
        conductor = getattr(_global_runtime(), "conductor", None)
        if conductor is None:
            raise RuntimeError(
                "the host collective meets through the conductor's KV: "
                "start the cluster runtime with "
                "ray_tpu_torch.init(address=...)")
        return conductor

    def _put(self, key: str, value: Any) -> None:
        self._kv().call("kv_put", ns=_NS, key=key.encode(),
                        value=pickle.dumps(value, protocol=5))

    def _get(self, key: str, timeout: float = 300.0) -> Any:
        blob = self._kv().call("kv_get", ns=_NS, key=key.encode(),
                               wait_timeout=timeout)
        if blob is None:
            raise TimeoutError(f"collective op timed out on key {key}")
        return pickle.loads(blob)

    def _del(self, key: str) -> None:
        self._kv().call("kv_del", ns=_NS, key=key.encode())

    # -- ops -----------------------------------------------------------
    def _fan_in_out(self, payload: Any, reduce_fn) -> Any:
        """All ranks publish; rank 0 reduces and publishes the result."""
        s = self.seq
        self.seq += 1
        base = f"{self.name}/{s}"
        self._put(f"{base}/in/{self.rank}", payload)
        if self.rank == 0:
            parts = [self._get(f"{base}/in/{r}")
                     for r in range(self.world_size)]
            out = reduce_fn(parts)
            self._put(f"{base}/out", out)
        result = self._get(f"{base}/out")
        # rank 0 lazily GCs the keys of two rounds back
        if self.rank == 0 and s >= 2:
            old = f"{self.name}/{s - 2}"
            for r in range(self.world_size):
                self._del(f"{old}/in/{r}")
            self._del(f"{old}/out")
        return result

    def allreduce(self, tensor, op: str = "SUM"):
        def red(parts):
            acc = np.asarray(parts[0]).copy()
            for p in parts[1:]:
                p = np.asarray(p)
                if op == "SUM" or op == "MEAN":
                    acc = acc + p
                elif op == "MAX":
                    acc = np.maximum(acc, p)
                elif op == "MIN":
                    acc = np.minimum(acc, p)
                elif op == "PRODUCT":
                    acc = acc * p
                else:
                    raise ValueError(f"unknown reduce op {op!r}")
            if op == "MEAN":
                acc = acc / len(parts)
            return acc
        return self._fan_in_out(_host(tensor), red)

    def allgather(self, tensor) -> List[np.ndarray]:
        return self._fan_in_out(_host(tensor),
                                lambda parts: [np.asarray(p) for p in parts])

    def reducescatter(self, tensor, op: str = "SUM") -> np.ndarray:
        summed = self.allreduce(tensor, op=op)
        chunks = np.array_split(summed, self.world_size)
        return chunks[self.rank]

    def broadcast(self, tensor, src_rank: int = 0) -> np.ndarray:
        s = self.seq
        self.seq += 1
        base = f"{self.name}/{s}"
        if self.rank == src_rank:
            self._put(f"{base}/out", _host(tensor))
        return self._get(f"{base}/out")

    def barrier(self) -> None:
        self.allreduce(np.zeros(1))

    def send(self, tensor, dst_rank: int) -> None:
        s = self.seq
        self.seq += 1
        self._put(f"{self.name}/p2p/{s}/{self.rank}->{dst_rank}",
                  _host(tensor))

    def recv(self, src_rank: int) -> np.ndarray:
        s = self.seq
        self.seq += 1
        key = f"{self.name}/p2p/{s}/{src_rank}->{self.rank}"
        out = self._get(key)
        self._del(key)
        return out


def init_collective_group(world_size: int, rank: int,
                          backend: str = "shm",
                          group_name: str = "default") -> None:
    """Called inside each participating actor (parity: collective.py:120)."""
    if not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} out of range for world {world_size}")
    with _lock:
        if group_name in _groups:
            raise RuntimeError(f"group {group_name!r} already initialized")
        _groups[group_name] = _Group(world_size, rank, group_name)
    # rendezvous barrier so all ranks exist before the first op
    _groups[group_name].barrier()


def create_collective_group(actors: List[Any], world_size: int,
                            ranks: List[int], backend: str = "shm",
                            group_name: str = "default"):
    """Declare a group externally over actor handles (collective.py:151).
    Each actor must expose an ``init_group(world_size, rank, backend, name)``
    method (convention used by the reference's examples)."""
    import ray_tpu_torch as rt
    refs = [a.init_group.remote(world_size, r, backend, group_name)
            for a, r in zip(actors, ranks)]
    rt.get(refs)


def _group(group_name: str) -> _Group:
    g = _groups.get(group_name)
    if g is None:
        raise RuntimeError(
            f"collective group {group_name!r} is not initialized in this "
            "process; call init_collective_group() first")
    return g


def allreduce(tensor, group_name: str = "default", op: str = "SUM"):
    return _group(group_name).allreduce(tensor, op=op)


def allgather(tensor, group_name: str = "default"):
    return _group(group_name).allgather(tensor)


def reducescatter(tensor, group_name: str = "default", op: str = "SUM"):
    return _group(group_name).reducescatter(tensor, op=op)


def broadcast(tensor, src_rank: int = 0, group_name: str = "default"):
    return _group(group_name).broadcast(tensor, src_rank=src_rank)


def barrier(group_name: str = "default") -> None:
    _group(group_name).barrier()


def send(tensor, dst_rank: int, group_name: str = "default") -> None:
    _group(group_name).send(tensor, dst_rank)


def recv(src_rank: int, group_name: str = "default"):
    return _group(group_name).recv(src_rank)


def destroy_collective_group(group_name: str = "default") -> None:
    with _lock:
        _groups.pop(group_name, None)


def get_rank(group_name: str = "default") -> int:
    return _group(group_name).rank


def get_collective_group_size(group_name: str = "default") -> int:
    return _group(group_name).world_size
