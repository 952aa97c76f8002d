"""BackendExecutor: orchestrates the training gang. Ported from
``ray_tpu/train/backend_executor.py``.

Role parity: python/ray/train/_internal/backend_executor.py:43: start the
WorkerGroup, run the backend's on_start (rendezvous), start the user loop
on every worker, then pump reports until all ranks finish.

Where the port differs from the JAX module:

- ``TorchBackend`` is the framework backend (the reference's
  _TorchBackend, train/torch/config.py:155): every rank calls
  ``torch.distributed.init_process_group`` against a TCP store on rank 0's
  host, at every world size, so a one-rank loop sees the same
  ``torch.distributed`` API as a gang. ``backend=None`` picks ``"nccl"``
  when the gang's workers hold cards and ``"gloo"`` otherwise. The JAX
  package's ``JaxBackend`` (``jax.distributed.initialize``) is not carried
  over.
- NCCL puts one rank on one card. An NCCL gang of more than one rank whose
  ranks do not hold as many distinct cards raises ``ValueError`` before
  any rank calls ``init_process_group`` (which would hang or fail inside
  NCCL).
- The rendezvous helpers are module-level functions: the port sends
  callables to worker processes by import path (ROADMAP.md C).
- A ``ValueError`` while the gang forms is a configuration error and is
  raised as it is; any other failure is a ``TrainingFailedError``, which
  the trainer's ``FailureConfig`` may retry.
"""

from __future__ import annotations

import socket
import time
from typing import Any, Callable, Dict, List, Optional

from ray_tpu_torch.air.checkpoint import Checkpoint
from ray_tpu_torch.train.worker_group import WorkerGroup


class Backend:
    def on_start(self, worker_group: WorkerGroup) -> None:
        pass

    def on_shutdown(self, worker_group: WorkerGroup) -> None:
        pass


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _node_ip() -> str:
    try:
        return socket.gethostbyname(socket.gethostname())
    except OSError:
        return "127.0.0.1"


def _visible_card():
    """(host, ``CUDA_VISIBLE_DEVICES``) of this worker: which card its
    lease gave it, without touching CUDA."""
    import os
    return socket.gethostname(), os.environ.get("CUDA_VISIBLE_DEVICES")


def _init_torch_distributed(master_addr: str, master_port: int,
                            world_size: int, rank: int,
                            backend: str = "gloo") -> bool:
    """Join the gang's process group; False when this process already has
    one (a one-rank gang on the in-process runtime), which the gang then
    uses and leaves in place."""
    import datetime

    import torch
    import torch.distributed as dist
    if dist.is_initialized():
        return False
    if backend == "nccl":
        torch.cuda.set_device(0)     # the leased card
    dist.init_process_group(
        backend, init_method=f"tcp://{master_addr}:{master_port}",
        rank=rank, world_size=world_size,
        timeout=datetime.timedelta(seconds=120))
    return True


def _destroy_torch_distributed() -> bool:
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()
    return True


class TorchBackend(Backend):
    """torch.distributed rendezvous over the gang (parity:
    train/torch/config.py:113 _TorchBackend.on_start)."""

    def __init__(self, backend: Optional[str] = None):
        self.backend_name = backend

    def resolved(self, worker_group: WorkerGroup) -> str:
        if self.backend_name is not None:
            return self.backend_name
        gpus = worker_group.resources_per_worker.get("GPU", 0.0)
        return "nccl" if gpus > 0 else "gloo"

    def on_start(self, worker_group: WorkerGroup) -> None:
        import ray_tpu_torch as rt
        backend = self.resolved(worker_group)
        world = worker_group.num_workers
        if backend == "nccl" and world > 1:
            cards = worker_group.execute(_visible_card)
            distinct = {c for c in cards if c[1]}
            if len(distinct) < world:
                raise ValueError(
                    f"an NCCL gang of {world} ranks needs {world} distinct "
                    f"cards, one a rank; its workers hold {len(distinct)} "
                    f"(host, CUDA_VISIBLE_DEVICES: {cards}). Give each "
                    f"worker a whole card (gpus_per_worker >= 1) on a "
                    f"cluster with {world} of them, or use gloo")
        ip = worker_group.execute_single(0, _node_ip)
        port = worker_group.execute_single(0, _free_port)
        refs = [w.execute.remote(_init_torch_distributed, ip, port, world,
                                 rank, backend)
                for rank, w in enumerate(worker_group.workers)]
        worker_group.owns_process_group = rt.get(refs, timeout=180)

    def on_shutdown(self, worker_group: WorkerGroup) -> None:
        owned = worker_group.owns_process_group
        try:
            import ray_tpu_torch as rt
            rt.get([w.execute.remote(_destroy_torch_distributed)
                    for w, own in zip(worker_group.workers, owned) if own],
                   timeout=30)
        except Exception:
            pass  # workers may already be gone


class TrainingFailedError(RuntimeError):
    pass


class BackendExecutor:
    def __init__(self, backend: Backend, num_workers: int,
                 resources_per_worker: dict,
                 placement_strategy: str = "PACK"):
        self.backend = backend
        self.num_workers = num_workers
        self.resources_per_worker = resources_per_worker
        self.placement_strategy = placement_strategy
        self.worker_group: Optional[WorkerGroup] = None

    def start(self, ready_timeout: float = 120.0) -> None:
        try:
            self.worker_group = WorkerGroup(
                self.num_workers, self.resources_per_worker,
                self.placement_strategy, ready_timeout=ready_timeout)
            self.backend.on_start(self.worker_group)
        except ValueError:
            raise                 # a configuration error: no retry helps
        except Exception as e:  # noqa: BLE001 - retryable via FailureConfig
            raise TrainingFailedError(f"gang formation failed: {e!r}") from e

    def run(self, train_loop: Callable, config: dict,
            on_report: Callable[[dict], Any],
            trial_dir: str = "",
            checkpoint: Optional[Checkpoint] = None,
            datasets: Optional[Dict[str, Any]] = None) -> List[dict]:
        """Start the loop on all ranks and pump synchronized reports.

        ``on_report`` receives the merged report each round (rank-0 metrics
        + rank-0 checkpoint); returning "stop" requests cooperative stop.
        Returns the full merged report history.
        """
        import ray_tpu_torch as rt
        wg = self.worker_group
        # Per-rank dataset shards (session.get_dataset_shard): each named
        # Dataset splits into world_size EQUAL-row pieces — collective-per-
        # step loops need the same step count on every rank or the gang
        # deadlocks on the uneven tail (Dataset.split(equal=True) parity).
        # The splits hold their blocks' refs until this returns.
        shards_by_rank: List[Optional[dict]] = [None] * len(wg.workers)
        if datasets:
            per_name = {name: ds.split(len(wg.workers), equal=True)
                        for name, ds in datasets.items()}
            shards_by_rank = [
                {name: splits[rank] for name, splits in per_name.items()}
                for rank in range(len(wg.workers))]
        try:
            rt.get([w.start_training.remote(train_loop, config, trial_dir,
                                            checkpoint,
                                            dataset_shards=shards_by_rank[i])
                    for i, w in enumerate(wg.workers)], timeout=600)
        except Exception as e:  # noqa: BLE001 - gang infra failure
            raise TrainingFailedError(f"gang start failed: {e!r}") from e
        history: List[dict] = []
        index = 0
        finished = False
        while not finished:
            # One synchronized round: wait for report[index] on every rank
            # (session.report is a barrier in the reference's semantics).
            round_reports: List[Optional[dict]] = [None] * len(wg.workers)
            pending = set(range(len(wg.workers)))
            while pending:
                # Poll the whole round concurrently under ONE shared
                # deadline: submit every rank's long-poll up front, then
                # collect. A rank still training answers "pending" within
                # its 30 s long-poll, re-arming the next wave's deadline;
                # only a rank that cannot answer at all eats the window.
                wave = {rank: wg.workers[rank].next_report.remote(index, 30.0)
                        for rank in sorted(pending)}
                wave_deadline = time.monotonic() + 120.0
                for rank, ref in wave.items():
                    try:
                        r = rt.get(ref, timeout=max(
                            5.0, wave_deadline - time.monotonic()))
                    except TrainingFailedError:
                        raise
                    except Exception as e:  # noqa: BLE001 - rank died
                        # A dead rank (node loss, OOM kill) fails the whole
                        # gang: an SPMD program cannot continue minus one
                        # process; the trainer re-forms the gang (possibly
                        # smaller, FailureConfig.elastic) from the last
                        # checkpoint.
                        raise TrainingFailedError(
                            f"rank {rank} failed: {e!r}") from e
                    if r["status"] == "report":
                        round_reports[rank] = r
                        pending.discard(rank)
                    elif r["status"] == "finished":
                        round_reports[rank] = None
                        pending.discard(rank)
                        finished = True
                    elif r["status"] == "error":
                        raise TrainingFailedError(r["traceback"])
                    # "pending": poll again
            if all(r is None for r in round_reports):
                break
            rank0 = round_reports[0]
            if rank0 is not None:
                merged = {"metrics": rank0["metrics"],
                          "checkpoint": rank0["checkpoint"],
                          "iteration": rank0["iteration"]}
                history.append(merged)
                if on_report(merged) == "stop":
                    for w in wg.workers:
                        w.request_stop.remote()
                    finished = True
            index += 1
        return history

    def shutdown(self) -> None:
        if self.worker_group is not None:
            self.backend.on_shutdown(self.worker_group)
            self.worker_group.shutdown()
            self.worker_group = None
