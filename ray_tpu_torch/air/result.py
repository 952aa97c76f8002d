"""Result of a training run (parity: python/ray/air/result.py). Ported from
``ray_tpu/air/result.py``."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from ray_tpu_torch.air.checkpoint import Checkpoint


@dataclass
class Result:
    metrics: Dict[str, Any] = field(default_factory=dict)
    checkpoint: Optional[Checkpoint] = None
    error: Optional[BaseException] = None
    metrics_history: List[Dict[str, Any]] = field(default_factory=list)
    config: Dict[str, Any] = field(default_factory=dict)
    path: Optional[str] = None

    @property
    def best_checkpoint(self) -> Optional[Checkpoint]:
        return self.checkpoint
