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
- ``topology`` names an NVLink domain type (``"h100-8"``,
  ``gpu/topology.py:DomainSpec``) where the JAX package names a TPU ICI
  slice (``"v4-8"``), and the gang is placed with strategy ``SLICE`` on
  the hosts of one domain. The JAX gang is one process a slice host, each
  reserving the host's chips; the port's is one NCCL rank a card. So
  ``num_workers`` defaults to the domain's cards over ``gpus_per_worker``
  (one card a worker unless given), and a ``num_workers`` whose cards do
  not cover the domain raises ``ValueError``, as the JAX package's raises
  for a count other than the slice's hosts.
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
    topology: str = ""                        # NVLink domain, e.g. "h100-8"
    placement_strategy: str = "PACK"
    # Parallelism axes for the step (dp=-1 -> infer remainder).
    mesh: Dict[str, int] = field(default_factory=dict)

    def __post_init__(self):
        if self.topology:
            # topology="h100-8" makes the config domain-native: one worker
            # a card (or a gpus_per_worker share), gang-placed with strategy
            # SLICE on the hosts of one NVLink domain.
            from ray_tpu_torch.gpu.topology import DomainSpec
            spec = DomainSpec.parse(self.topology)
            if self.use_gpu is False:
                raise ValueError(
                    f"topology {self.topology!r} is a domain of cards; "
                    f"use_gpu=False asks for CPU workers")
            per = float(self.gpus_per_worker or 1.0)
            workers = spec.num_gpus / per
            if workers != int(workers) or per > spec.gpus_per_host:
                raise ValueError(
                    f"topology {self.topology!r} has {spec.num_gpus} cards, "
                    f"{spec.gpus_per_host} a host; gpus_per_worker={per} "
                    f"does not divide them into whole ranks on one host each")
            if self.num_workers <= 1:
                self.num_workers = int(workers)
            elif self.num_workers != int(workers):
                raise ValueError(
                    f"topology {self.topology!r} has {spec.num_gpus} cards "
                    f"but num_workers={self.num_workers} at "
                    f"{per} a worker; one NCCL rank per card share of the "
                    f"domain is required for the gang")
            self.gpus_per_worker = per
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
        as_placement_group_factory -> PlacementGroupFactory). With a
        topology, the PG is domain-granular (strategy SLICE)."""
        from ray_tpu_torch.util.placement_group import placement_group
        bundles = [self.worker_resources() for _ in range(self.num_workers)]
        if self.topology:
            return functools.partial(placement_group, bundles,
                                     strategy="SLICE",
                                     slice_topology=self.topology)
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
