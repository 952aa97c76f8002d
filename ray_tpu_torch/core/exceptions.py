"""Public exception hierarchy. Ported from ``ray_tpu/core/exceptions.py``.

Role parity: python/ray/exceptions.py — errors raised inside remote tasks are
captured, serialized, and re-raised at the ``get()`` site wrapped in
``TaskError``; dead actors raise ``ActorDiedError``; lost objects raise
``ObjectLostError``.
"""

from __future__ import annotations

import traceback


class RayTpuError(Exception):
    """Base class for all framework errors."""


class TaskError(RayTpuError):
    """A remote task raised an exception; re-raised at the get() site."""

    def __init__(self, cause: BaseException, task_desc: str = "",
                 formatted_tb: str = ""):
        self.cause = cause
        self.task_desc = task_desc
        self.formatted_tb = formatted_tb
        super().__init__(str(cause))

    @classmethod
    def from_exception(cls, exc: BaseException, task_desc: str = ""):
        return cls(exc, task_desc, traceback.format_exc())

    def __str__(self):
        head = f"Task {self.task_desc} failed: {self.cause!r}"
        if self.formatted_tb:
            return head + "\n--- remote traceback ---\n" + self.formatted_tb
        return head


class ActorError(RayTpuError):
    pass


class ActorDiedError(ActorError):
    def __init__(self, actor_desc: str = "", reason: str = ""):
        self.actor_desc = actor_desc
        self.reason = reason
        super().__init__(f"Actor {actor_desc} died: {reason}")


class ObjectLostError(RayTpuError):
    def __init__(self, object_id_hex: str = "", reason: str = ""):
        super().__init__(f"Object {object_id_hex} lost: {reason}")


class RuntimeEnvSetupError(RayTpuError):
    """Materializing a task/actor's runtime_env failed (bad pip spec,
    missing wheels, ...). Deterministic — the task fails instead of
    retrying forever (parity: ray.exceptions.RuntimeEnvSetupError)."""


class GetTimeoutError(RayTpuError, TimeoutError):
    pass


class WorkerCrashedError(RayTpuError):
    pass


class TaskCancelledError(RayTpuError):
    pass


class PlacementGroupUnschedulableError(RayTpuError):
    pass
