"""Run-level dataclass configs. Ported from ``ray_tpu/air/config.py``.

Role parity: python/ray/air/config.py: ScalingConfig (:84), FailureConfig
(:512), CheckpointConfig (:571), RunConfig (:699).

Where the port differs from the JAX module, in ``ScalingConfig``:

- The accelerator is the card: ``use_gpu`` and ``gpus_per_worker`` take the
  place of ``use_tpu`` and ``tpus_per_worker``, and ``worker_resources()``
  asks for ``"GPU"`` where the JAX package asks for ``"TPU"``.
- ``use_gpu=None`` (the default) means one card a worker, the port's device
  rule (``device=None`` is the card); ``use_gpu=False`` asks for CPU
  workers, as the CPU tests do. A gang that cannot have its cards raises at
  ``fit()`` (``train/trainer.py``).
- ``topology`` names a TPU ICI slice in the JAX package and raises
  ``ValueError`` here: the port has no slice placement.
- ``as_placement_group_factory`` returns a module-level callable (a
  ``functools.partial`` of ``placement_group``), which pickles by import
  path, where the JAX package returns a lambda.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Any, Dict, Optional


@dataclass
class ScalingConfig:
    num_workers: int = 1                      # one worker actor per rank
    use_gpu: Optional[bool] = None            # None: one card a worker
    gpus_per_worker: float = 0.0              # cards a worker (0: one)
    cpus_per_worker: float = 1.0
    resources_per_worker: Dict[str, float] = field(default_factory=dict)
    topology: str = ""                        # refused: no slice placement
    placement_strategy: str = "PACK"
    # Parallelism axes for the step (dp=-1 -> infer remainder).
    mesh: Dict[str, int] = field(default_factory=dict)

    def __post_init__(self):
        if self.topology:
            raise ValueError(
                f"topology={self.topology!r} names a TPU ICI slice; the "
                f"port has no slice placement (give num_workers and "
                f"gpus_per_worker instead)")
        if self.use_gpu is False and self.gpus_per_worker:
            raise ValueError(
                f"use_gpu=False with gpus_per_worker="
                f"{self.gpus_per_worker}: a CPU worker holds no card")

    def worker_resources(self) -> Dict[str, float]:
        res = {"CPU": float(self.cpus_per_worker)}
        if self.use_gpu is not False:
            res["GPU"] = float(self.gpus_per_worker or 1.0)
        res.update(self.resources_per_worker)
        return res

    def as_placement_group_factory(self):
        """One bundle per worker (parity: air/config.py
        as_placement_group_factory -> PlacementGroupFactory)."""
        from ray_tpu_torch.util.placement_group import placement_group
        bundles = [self.worker_resources() for _ in range(self.num_workers)]
        return functools.partial(placement_group, bundles,
                                 strategy=self.placement_strategy)


@dataclass
class FailureConfig:
    max_failures: int = 0          # trial restarts on failure; -1 = infinite
    # Elastic recovery: on gang failure, re-plan the worker count against
    # the SURVIVING cluster; a smaller gang resumes from the last
    # checkpoint instead of waiting for the lost host.
    elastic: bool = False
    min_workers: int = 1           # floor for elastic shrink
    fail_fast: bool = False


@dataclass
class CheckpointConfig:
    num_to_keep: Optional[int] = None
    checkpoint_score_attribute: Optional[str] = None
    checkpoint_score_order: str = "max"
    checkpoint_frequency: int = 0
    checkpoint_at_end: bool = False


@dataclass
class RunConfig:
    name: Optional[str] = None
    storage_path: Optional[str] = None        # local dir for results
    failure_config: Optional[FailureConfig] = None
    checkpoint_config: Optional[CheckpointConfig] = None
    stop: Optional[Dict[str, Any]] = None     # e.g. {"training_iteration": 10}
    verbose: int = 1
