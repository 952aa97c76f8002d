"""Shared ML plumbing of the trainer (parity: python/ray/air: config.py:84,
checkpoint.py, the session facade). Ported from ``ray_tpu/air``."""

from ray_tpu_torch.air.config import (CheckpointConfig, FailureConfig,
                                      RunConfig, ScalingConfig)
from ray_tpu_torch.air.checkpoint import Checkpoint
from ray_tpu_torch.air.result import Result
from ray_tpu_torch.air import session

__all__ = ["ScalingConfig", "RunConfig", "CheckpointConfig", "FailureConfig",
           "Checkpoint", "Result", "session"]
