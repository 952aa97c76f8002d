"""WorkerGroup: the gang of train-worker actors. Ported from
``ray_tpu/train/worker_group.py``.

Role parity: python/ray/train/_internal/worker_group.py:92 (WorkerGroup)
and :17 (RayTrainWorker): N actors, one per rank, placed in one placement
group; ``execute`` fans a module-level function out to all workers;
``start_training`` runs the user loop in a thread per worker with an
active session.

Where the port differs from the JAX module:

- A worker takes its cards from its bundle (``num_gpus``): the node daemon
  leases it whole cards under ``CUDA_VISIBLE_DEVICES``, so the worker's
  card is ``cuda:0`` (``torch_utils.get_device``). There is no ``SLICE``
  gang: the port has no slice placement.
- The in-process runtime (``init()``) runs actors as threads of one
  process, which holds one ``torch.distributed`` group: a gang of more
  than one rank raises ``ValueError`` that names ``init(address=...)``; a
  one-rank gang runs there without a placement group.
- ``execute`` and the loop go to worker processes by import path
  (ROADMAP.md C), so they are module-level functions, not lambdas.
"""

from __future__ import annotations

import threading
import traceback
from typing import Any, Callable, Dict, List, Optional


class RayTrainWorker:
    """Actor hosting one rank of the training gang."""

    def __init__(self, world_rank: int, world_size: int, local_rank: int,
                 device: str = "cpu"):
        self.world_rank = world_rank
        self.world_size = world_size
        self.local_rank = local_rank
        self.device = device
        self._session = None
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[dict] = None
        self._done = threading.Event()

    def execute(self, fn: Callable, *args, **kwargs):
        return fn(*args, **kwargs)

    def start_training(self, loop_fn: Callable, config: dict,
                       trial_dir: str = "", checkpoint=None,
                       dataset_shards=None) -> bool:
        from ray_tpu_torch.air import session as session_mod
        sess = session_mod._Session(
            self.world_rank, self.world_size, self.local_rank,
            trial_dir=trial_dir, config=config, checkpoint=checkpoint,
            device=self.device, dataset_shards=dataset_shards)
        self._session = sess
        self._done.clear()
        self._error = None

        def run():
            session_mod._set_session(sess)
            try:
                if _accepts_config(loop_fn):
                    loop_fn(config)
                else:
                    loop_fn()
            except StopIteration:
                pass
            except BaseException:  # noqa: BLE001 - shipped to the driver
                self._error = {"traceback": traceback.format_exc()}
            finally:
                session_mod._set_session(None)
                with sess.report_event:
                    self._done.set()
                    sess.report_event.notify_all()

        self._thread = threading.Thread(target=run, daemon=True,
                                        name=f"train-rank{self.world_rank}")
        self._thread.start()
        return True

    def next_report(self, index: int, timeout: float = 10.0):
        """Block until report[index] exists (or the loop finished)."""
        sess = self._session
        if sess is None:
            return {"status": "no_session"}
        import time
        deadline = time.monotonic() + timeout
        with sess.report_event:
            while len(sess.reports) <= index:
                if self._done.is_set():
                    if self._error:
                        return {"status": "error", **self._error}
                    return {"status": "finished"}
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return {"status": "pending"}
                sess.report_event.wait(remaining)
            r = sess.reports[index]
            return {"status": "report", "metrics": r["metrics"],
                    "checkpoint": r["checkpoint"],
                    "iteration": r["iteration"]}

    def request_stop(self) -> bool:
        if self._session is not None:
            self._session.stop_requested = True
        return True


def _identity(x):
    return x


def _accepts_config(fn: Callable) -> bool:
    import inspect
    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):
        return False
    return len(sig.parameters) >= 1


def in_process_runtime() -> bool:
    """Whether the API's runtime is the in-process one (``init()``)."""
    from ray_tpu_torch.core.api import _global_runtime
    from ray_tpu_torch.core.runtime_local import LocalRuntime
    return isinstance(_global_runtime(), LocalRuntime)


def check_gang_runtime(num_workers: int) -> None:
    """A gang of more than one rank needs worker processes."""
    if num_workers > 1 and in_process_runtime():
        raise ValueError(
            f"a gang of {num_workers} ranks needs the cluster runtime "
            f"(ray_tpu_torch.init(address=...)): the in-process runtime "
            f"runs every rank in this one process, which holds one "
            f"torch.distributed group")


class WorkerGroup:
    """Driver-side handle over the gang (parity: worker_group.py:92)."""

    def __init__(self, num_workers: int, resources_per_worker: Dict[str, float],
                 placement_strategy: str = "PACK",
                 ready_timeout: float = 120.0):
        import ray_tpu_torch as rt
        from ray_tpu_torch.util.placement_group import placement_group
        from ray_tpu_torch.util.scheduling_strategies import (
            PlacementGroupSchedulingStrategy)
        check_gang_runtime(num_workers)
        self.num_workers = num_workers
        self.resources_per_worker = dict(resources_per_worker)
        gpus = float(resources_per_worker.get("GPU", 0.0))
        device = "cuda:0" if gpus > 0 else "cpu"
        self.workers = []
        self.pg = None
        # which ranks started the gang's process group (the backend sets
        # it; a rank that found its process's group leaves it in place)
        self.owns_process_group: List[bool] = []
        try:
            if not in_process_runtime():
                bundles = [dict(resources_per_worker)
                           for _ in range(num_workers)]
                self.pg = placement_group(bundles, strategy=placement_strategy)
                self.pg.ready(timeout=ready_timeout)
            cls = rt.remote(RayTrainWorker)
            for rank in range(num_workers):
                strategy = None if self.pg is None else \
                    PlacementGroupSchedulingStrategy(
                        self.pg, placement_group_bundle_index=rank)
                w = cls.options(
                    num_cpus=resources_per_worker.get("CPU", 1.0),
                    num_gpus=gpus,
                    resources={k: v for k, v in resources_per_worker.items()
                               if k not in ("CPU", "GPU")},
                    scheduling_strategy=strategy,
                ).remote(rank, num_workers, rank, device)
                self.workers.append(w)
        except BaseException:  # noqa: BLE001 - tear down the half-formed gang, then re-raise
            # half-formed gang: kill any actors already created AND release
            # the PG, so a retry plans against clean capacity (zombie ranks
            # would double-book the bundles the conductor just returned)
            self.shutdown()
            raise

    def execute(self, fn: Callable, *args, **kwargs) -> List[Any]:
        import ray_tpu_torch as rt
        return rt.get([w.execute.remote(fn, *args, **kwargs)
                       for w in self.workers], timeout=600)

    def broadcast_weights(self, params: Any,
                          apply_fn: Optional[Callable] = None) -> List[Any]:
        """Ship one weight payload to every rank through the object plane:
        ONE put, and a broadcast tree pre-places the object on each
        distinct worker node; every rank then resolves it from its local
        store. ``apply_fn(params)`` (module-level) runs on each rank with
        the resolved value (default: return it)."""
        import ray_tpu_torch as rt
        from ray_tpu_torch.train import weight_sync
        ref = weight_sync.broadcast_to_actors(params, self.workers)
        fn = _identity if apply_fn is None else apply_fn
        futs = [w.execute.remote(fn, ref) for w in self.workers]
        return rt.get(futs, timeout=600)

    def execute_single(self, rank: int, fn: Callable, *args, **kwargs) -> Any:
        import ray_tpu_torch as rt
        return rt.get(self.workers[rank].execute.remote(fn, *args, **kwargs),
                      timeout=600)

    def shutdown(self) -> None:
        import ray_tpu_torch as rt
        from ray_tpu_torch.util.placement_group import remove_placement_group
        for w in self.workers:
            try:
                rt.kill(w)
            except Exception:
                pass
        if self.pg is not None:
            try:
                remove_placement_group(self.pg)
            except Exception:
                pass
