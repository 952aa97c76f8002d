"""Training session facade, valid inside a train worker's loop. Ported from
``ray_tpu/air/session.py``.

Role parity: python/ray/air/session.py:43 (report) backed by
train/_internal/session.py:63/:322: ``report(metrics, checkpoint=...)`` is
the one channel from the user loop to the trainer: metrics stream to the
driver, rank-0 checkpoints persist. Plus rank/world introspection.

Where the port differs from the JAX module: the session also holds the
worker's device (``"cuda:0"``, the card its lease gave it, or ``"cpu"``),
which ``train.torch_utils.get_device`` returns.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Optional

from ray_tpu_torch.air.checkpoint import Checkpoint

_local = threading.local()


class _Session:
    def __init__(self, world_rank: int, world_size: int, local_rank: int,
                 trial_dir: str = "", config: Optional[dict] = None,
                 checkpoint: Optional[Checkpoint] = None,
                 device: str = "cpu",
                 dataset_shards: Optional[Dict[str, Any]] = None):
        self.world_rank = world_rank
        self.world_size = world_size
        self.local_rank = local_rank
        self.trial_dir = trial_dir
        self.config = config or {}
        self.loaded_checkpoint = checkpoint
        self.device = device
        self.dataset_shards = dataset_shards or {}
        self.reports = []           # consumed by the worker actor
        self.report_event = threading.Condition()
        self.iteration = 0
        self.stop_requested = False

    def report(self, metrics: Dict[str, Any],
               checkpoint: Optional[Checkpoint] = None) -> None:
        self.iteration += 1
        with self.report_event:
            self.reports.append({"metrics": dict(metrics),
                                 "checkpoint": checkpoint,
                                 "iteration": self.iteration})
            self.report_event.notify_all()
        if self.stop_requested:
            raise StopIteration("trial stop requested")


def _set_session(s: Optional[_Session]) -> None:
    _local.session = s


def _get_session() -> Optional[_Session]:
    return getattr(_local, "session", None)


def _require_session() -> _Session:
    s = _get_session()
    if s is None:
        raise RuntimeError(
            "No training session active: session.* APIs are only valid "
            "inside a train_loop_per_worker function.")
    return s


def report(metrics: Dict[str, Any],
           checkpoint: Optional[Checkpoint] = None) -> None:
    _require_session().report(metrics, checkpoint=checkpoint)


def get_checkpoint() -> Optional[Checkpoint]:
    return _require_session().loaded_checkpoint


def get_dataset_shard(name: str = "train"):
    """This worker's split of the Dataset the trainer was given via
    ``datasets={name: ds}`` (parity: air/session.py get_dataset_shard —
    the data->train integration point). Iterate it with iter_batches /
    iter_torch_batches inside the loop."""
    shards = _require_session().dataset_shards
    if name not in shards:
        raise KeyError(
            f"no dataset {name!r} was passed to the trainer "
            f"(have: {sorted(shards)})")
    return shards[name]


def get_world_rank() -> int:
    return _require_session().world_rank


def get_world_size() -> int:
    return _require_session().world_size


def get_local_rank() -> int:
    return _require_session().local_rank


def get_trial_dir() -> str:
    return _require_session().trial_dir


def get_config() -> Dict[str, Any]:
    return _require_session().config
