"""Trainers: BaseTrainer, DataParallelTrainer and TorchTrainer. Ported from
``ray_tpu/train/trainer.py``.

Role parity: python/ray/train/base_trainer.py:554 (BaseTrainer.fit),
data_parallel_trainer.py:56 (DataParallelTrainer -> BackendExecutor ->
WorkerGroup), torch/torch_trainer.py:15 (the framework trainer). fit()
drives the BackendExecutor directly, as in the JAX package.

Where the port differs from the JAX module:

- ``TorchTrainer`` is the framework trainer, the role the JAX package's
  ``JaxTrainer`` plays: ``TorchBackend`` starts an NCCL group over GPU
  workers (each on its leased card) or a gloo group over CPU workers, and
  the loop builds its step on ``torch_utils.get_device()``. No
  ``JaxTrainer`` is carried over.
- ``ScalingConfig(use_gpu=None)`` means one card a worker. ``fit()`` raises
  ``RuntimeError`` at once when the cluster counts fewer cards than the
  gang asks for (on the in-process runtime: when this process sees no
  card), rather than waiting on the placement timeout.
- The trainer runs on the cluster runtime (``init(address=...)``). On the
  in-process runtime a gang of more than one rank raises ``ValueError``
  (``worker_group.check_gang_runtime``); a one-rank gang runs on both.
- The loop goes to the workers by import path, and ``trainer.pkl`` (which
  ``restore`` reads) is written with the port's pickler: a lambda or nested
  loop raises ``TypeError`` at ``fit()`` (ROADMAP.md C).
- ``datasets=`` takes ``ray_tpu_torch.data`` Datasets, split into
  equal-row shards, one a rank (``session.get_dataset_shard``), as in the
  JAX package.
"""

from __future__ import annotations

import functools
import os
import tempfile
from typing import Any, Callable, Optional

from ray_tpu_torch.air.checkpoint import Checkpoint
from ray_tpu_torch.air.config import FailureConfig, RunConfig, ScalingConfig
from ray_tpu_torch.air.result import Result
from ray_tpu_torch.train.backend_executor import (Backend, BackendExecutor,
                                                  TorchBackend,
                                                  TrainingFailedError)
from ray_tpu_torch.train.worker_group import (check_gang_runtime,
                                              in_process_runtime)

_CKPT_MARKER = "_COMPLETE"


def _find_restorable_checkpoint(trial_dir: str) -> Optional[str]:
    """Newest COMPLETE persisted checkpoint, surviving a crash at any
    point of _persist_checkpoint's swap: prefer checkpoint_latest, then
    .tmp (newer but unswapped: complete iff marked), then .old."""
    final = os.path.join(trial_dir, "checkpoint_latest")
    for cand in (final, final + ".tmp", final + ".old"):
        if os.path.isdir(cand) and \
                os.path.exists(os.path.join(cand, _CKPT_MARKER)):
            return cand
    # Pre-marker layouts (or externally written dirs): accept a bare
    # checkpoint_latest rather than silently restarting from scratch.
    if os.path.isdir(final):
        return final
    return None


def _run_trainable(trainer: "BaseTrainer", config: dict) -> Result:
    import copy
    t = copy.copy(trainer)
    merged = dict(getattr(t, "train_loop_config", None) or {})
    merged.update(config)
    t.train_loop_config = merged
    return t.fit()


class BaseTrainer:
    def __init__(self, *, scaling_config: Optional[ScalingConfig] = None,
                 run_config: Optional[RunConfig] = None,
                 resume_from_checkpoint: Optional[Checkpoint] = None):
        self.scaling_config = scaling_config or ScalingConfig()
        self.run_config = run_config or RunConfig()
        self.resume_from_checkpoint = resume_from_checkpoint

    def fit(self) -> Result:
        raise NotImplementedError

    @classmethod
    def restore(cls, path: str) -> "BaseTrainer":
        """Rebuild a trainer from a previous run's trial dir and resume
        from its latest persisted checkpoint (parity:
        base_trainer.py:567-579 BaseTrainer.restore: resume after the
        DRIVER died, where the in-fit restart only survives a worker's
        death)."""
        from ray_tpu_torch.core import serialization
        spec_path = os.path.join(path, "trainer.pkl")
        if not os.path.exists(spec_path):
            raise FileNotFoundError(
                f"no trainer state found under {path!r} (trainer.pkl "
                "missing: was fit() ever started here?)")
        with open(spec_path, "rb") as f:
            trainer = serialization.loads(f.read())
        ckpt_dir = _find_restorable_checkpoint(path)
        if ckpt_dir is not None:
            trainer.resume_from_checkpoint = Checkpoint.from_directory(
                ckpt_dir)
        return trainer

    @staticmethod
    def can_restore(path: str) -> bool:
        return os.path.exists(os.path.join(path, "trainer.pkl"))

    def _save_spec(self, trial_dir: str) -> None:
        """Persist this trainer's construction so restore() can rebuild it
        in a fresh process (written once, before training starts)."""
        from ray_tpu_torch.core import serialization
        spec_path = os.path.join(trial_dir, "trainer.pkl")
        if not os.path.exists(spec_path):
            blob = serialization.dumps(self)   # a lambda loop raises here
            tmp = spec_path + ".tmp"
            with open(tmp, "wb") as f:
                f.write(blob)
            os.replace(tmp, spec_path)

    @staticmethod
    def _persist_checkpoint(trial_dir: str, ckpt: Checkpoint) -> None:
        """Write the latest checkpoint under the trial dir so a dead
        driver can resume from disk, not just from memory. Directory swaps
        cannot be single-rename-atomic; every intermediate state is
        covered by a COMPLETE marker + the restore fallback chain
        (_find_restorable_checkpoint): .tmp carries the marker only once
        fully written, .old keeps the previous complete checkpoint until
        the new one is in place."""
        final = os.path.join(trial_dir, "checkpoint_latest")
        tmp, old = final + ".tmp", final + ".old"
        import shutil
        shutil.rmtree(tmp, ignore_errors=True)
        ckpt.to_directory(tmp)
        with open(os.path.join(tmp, _CKPT_MARKER), "w") as f:
            f.write("1")
        shutil.rmtree(old, ignore_errors=True)
        if os.path.isdir(final):
            os.replace(final, old)
        os.replace(tmp, final)
        shutil.rmtree(old, ignore_errors=True)

    def as_trainable(self) -> Callable[[dict], Result]:
        """A Tune-compatible trainable over this trainer (parity:
        base_trainer.py:666 as_trainable): a ``functools.partial`` of a
        module-level function, so it pickles by import path."""
        return functools.partial(_run_trainable, self)


class DataParallelTrainer(BaseTrainer):
    """N identical workers running one loop (parity:
    data_parallel_trainer.py:56)."""

    _backend_cls: Callable[[], Backend] = Backend

    def __init__(self, train_loop_per_worker: Callable, *,
                 train_loop_config: Optional[dict] = None,
                 scaling_config: Optional[ScalingConfig] = None,
                 run_config: Optional[RunConfig] = None,
                 resume_from_checkpoint: Optional[Checkpoint] = None,
                 backend: Optional[Backend] = None,
                 datasets: Optional[dict] = None):
        super().__init__(scaling_config=scaling_config, run_config=run_config,
                         resume_from_checkpoint=resume_from_checkpoint)
        self.train_loop_per_worker = train_loop_per_worker
        self.train_loop_config = train_loop_config or {}
        self.backend = backend or self._backend_cls()
        # name -> ray_tpu_torch.data.Dataset, split per-rank at fit() and
        # exposed in workers via session.get_dataset_shard.
        self.datasets = datasets or {}

    def _check_cards(self) -> None:
        """Raise now when the gang cannot have its cards."""
        import ray_tpu_torch as rt
        sc = self.scaling_config
        per_worker = sc.worker_resources().get("GPU", 0.0)
        if not per_worker:
            return
        hint = ("ray_tpu_torch runs a ScalingConfig with use_gpu=None on "
                "CUDA cards, one a worker; pass ScalingConfig(use_gpu="
                "False) for CPU workers")
        if in_process_runtime():
            import torch
            if not torch.cuda.is_available():
                raise RuntimeError(f"no CUDA card in this process: {hint}")
            return
        have = rt.cluster_resources().get("GPU", 0.0)
        if have + 1e-9 < per_worker * sc.num_workers:
            raise RuntimeError(
                f"the gang asks for {per_worker * sc.num_workers} GPUs and "
                f"the cluster counts {have} CUDA cards: {hint}")

    def fit(self) -> Result:
        num_workers = self.scaling_config.num_workers
        check_gang_runtime(num_workers)
        self._check_cards()
        cfg = self.run_config
        trial_dir = os.path.join(
            cfg.storage_path or tempfile.gettempdir(),
            cfg.name or "rtpt_train")
        os.makedirs(trial_dir, exist_ok=True)
        self._save_spec(trial_dir)
        stop = cfg.stop or {}
        failure = cfg.failure_config or FailureConfig()
        attempts = 0
        while True:
            executor = BackendExecutor(
                self.backend, num_workers,
                self.scaling_config.worker_resources(),
                self.scaling_config.placement_strategy,
                slice_topology=self.scaling_config.topology)
            state = {"last_metrics": {}, "last_checkpoint":
                     self.resume_from_checkpoint, "history": []}

            def on_report(merged):
                state["last_metrics"] = merged["metrics"]
                state["history"].append(merged["metrics"])
                if merged["checkpoint"] is not None:
                    state["last_checkpoint"] = merged["checkpoint"]
                    try:
                        self._persist_checkpoint(trial_dir,
                                                 merged["checkpoint"])
                    except Exception:
                        pass  # persistence is best-effort; in-memory
                        # state still drives this fit()'s own restarts
                for key, bound in stop.items():
                    if key == "training_iteration":
                        if merged["iteration"] >= bound:
                            return "stop"
                    elif merged["metrics"].get(key) is not None and \
                            merged["metrics"][key] >= bound:
                        return "stop"
                return None

            try:
                # First formation waits the full window (nodes may still be
                # joining). On an elastic RESTART capacity just shrank, and
                # the worker count was planned from a membership view that
                # can lag the failure: an infeasible gang should fail fast
                # and re-plan against the settled cluster, not park on the
                # placement timeout.
                executor.start(ready_timeout=15.0 if attempts else 120.0)
                executor.run(self.train_loop_per_worker,
                             self.train_loop_config, on_report,
                             trial_dir=trial_dir,
                             checkpoint=state["last_checkpoint"],
                             datasets=self.datasets)
                return Result(metrics=state["last_metrics"],
                              checkpoint=state["last_checkpoint"],
                              metrics_history=state["history"],
                              config=dict(self.train_loop_config),
                              path=trial_dir)
            except TrainingFailedError as e:
                attempts += 1
                if failure.max_failures != -1 and \
                        attempts > failure.max_failures:
                    return Result(metrics=state["last_metrics"],
                                  checkpoint=state["last_checkpoint"],
                                  metrics_history=state["history"],
                                  error=e,
                                  config=dict(self.train_loop_config),
                                  path=trial_dir)
                # restart from the last checkpoint: a lost rank kills the
                # SPMD program; recovery re-forms the gang and restores
                self.resume_from_checkpoint = state["last_checkpoint"]
                if failure.elastic:
                    # re-plan the gang against the SURVIVING cluster: a
                    # smaller world resumes from the last checkpoint now
                    # instead of parking on a lost host
                    num_workers = self._feasible_workers(
                        num_workers, failure.min_workers)
            finally:
                executor.shutdown()

    def _feasible_workers(self, want: int, floor: int,
                          settle_timeout: float = 30.0) -> int:
        """How many workers the LIVE cluster can host right now. Waits
        briefly for membership to settle (the dead node's health timeout)
        whenever even ``floor`` workers don't fit yet."""
        import math
        import time as _time

        import ray_tpu_torch as rt
        from ray_tpu_torch.cluster.protocol import get_client
        res = self.scaling_config.worker_resources()
        deadline = _time.monotonic() + settle_timeout
        while True:
            slots = 0
            assessable = False
            try:
                for n in rt.nodes():
                    if not n["Alive"] or ":" not in str(n.get("address", "")):
                        continue  # in-process runtime: nothing to re-plan
                    assessable = True
                    # The conductor's health view lags a crash by its
                    # timeout; a direct daemon ping settles liveness NOW (a
                    # dead daemon refuses at once; timeout=1.0 bounds the
                    # connect too).
                    try:
                        get_client(n["address"], timeout=1.0).call(
                            "ping", _timeout=1.0)
                    except Exception:
                        continue
                    cap = min((n["Resources"].get(k, 0.0) / v
                               for k, v in res.items() if v > 0),
                              default=0.0)
                    slots += int(math.floor(cap))
            except Exception:
                slots = 0
            if not assessable:
                return want
            if slots >= floor or _time.monotonic() >= deadline:
                return max(floor, min(want, slots))
            _time.sleep(0.5)


class TorchTrainer(DataParallelTrainer):
    """The framework trainer (parity: torch/torch_trainer.py:15; the role
    of the JAX package's JaxTrainer): a ``torch.distributed`` group spans
    the workers, NCCL over cards or gloo over CPU workers;
    ``train.torch_utils`` gives the device, DDP and per-rank sharding."""

    def __init__(self, train_loop_per_worker: Callable, **kwargs: Any):
        super().__init__(train_loop_per_worker, backend=TorchBackend(),
                         **kwargs)
