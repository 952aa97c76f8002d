"""joblib parallel backend over ray_tpu_torch tasks.

Role parity: python/ray/util/joblib (register_ray + RayBackend) — lets
scikit-learn-style ``joblib.Parallel(...)`` fan work out over the cluster by
selecting ``parallel_backend("ray_tpu_torch")``. Each joblib batch becomes
one task; results stream back through ObjectRefs. Ported from
``ray_tpu/util/joblib_backend.py``.

Where the port differs: the backend is registered as ``"ray_tpu_torch"``
(the JAX one as ``"ray_tpu"``), so both can be registered in one process;
joblib is imported by ``register_ray_tpu_torch()`` (and by the backend
class's first use), never when this module is imported; and the batch
task and the backend class live at module level, so the port's runtime
can ship a joblib batch (which holds its backend) by import path.
"""

from __future__ import annotations

from typing import Any, Callable

BACKEND_NAME = "ray_tpu_torch"
_backend_cls = None
_batch_task = None


def _joblib_batch(f):
    return f()


def _unwrap(exc: BaseException) -> BaseException:
    """Surface the ORIGINAL exception class to joblib callers (a sklearn
    user catching ValueError must not get our TaskError)."""
    from ray_tpu_torch.core.exceptions import TaskError
    return exc.cause if isinstance(exc, TaskError) else exc


class _Result:
    def __init__(self, fut):
        self._fut = fut

    def get(self, timeout=None):
        from ray_tpu_torch.core.exceptions import TaskError
        try:
            return self._fut.result(timeout=timeout)
        except TaskError as e:
            raise _unwrap(e) from e


def _joblib():
    try:
        from joblib._parallel_backends import MultiprocessingBackend
        from joblib.parallel import register_parallel_backend
    except ImportError as e:
        raise ImportError(
            "the ray_tpu_torch joblib backend needs the joblib package, "
            "which is not installed") from e
    return MultiprocessingBackend, register_parallel_backend


def _ensure_init():
    import ray_tpu_torch
    if not ray_tpu_torch.is_initialized():
        ray_tpu_torch.init(ignore_reinit_error=True)
    return ray_tpu_torch


def _backend_class():
    """The backend class, built once joblib is importable."""
    global _backend_cls
    if _backend_cls is not None:
        return _backend_cls
    MultiprocessingBackend, _ = _joblib()

    class RayTpuTorchBackend(MultiprocessingBackend):
        """Batches execute as ray_tpu_torch tasks; the MultiprocessingBackend
        base supplies joblib's batching/auto-batch-size machinery (the
        reference's RayBackend subclasses it for the same reason) — but
        configure() must NOT build the base's local MemmappingPool (it
        would fork cluster-CPU-count idle processes on the driver)."""

        supports_timeout = True

        def configure(self, n_jobs=1, parallel=None, prefer=None,
                      require=None, **kwargs):
            n_jobs = self.effective_n_jobs(n_jobs)
            self.parallel = parallel
            return n_jobs

        def terminate(self):
            pass  # no local pool to tear down

        def effective_n_jobs(self, n_jobs: int) -> int:
            rt = _ensure_init()
            eager = int(rt.cluster_resources().get("CPU", 1))
            if n_jobs == -1:
                return max(1, eager)
            return max(1, n_jobs)

        def apply_async(self, func: Callable[[], Any], callback=None):
            global _batch_task
            rt = _ensure_init()
            from ray_tpu_torch.core.api import _ref_future
            if _batch_task is None:
                _batch_task = rt.remote(_joblib_batch)
            fut = _ref_future(_batch_task.remote(func))
            if callback is not None:
                # joblib's completion callback must fire on error too (it
                # doubles as error_callback in the pool protocol) or the
                # dispatcher stalls waiting for the batch.
                fut.add_done_callback(
                    lambda f: callback(_unwrap(f.exception())
                                       if f.exception() else f.result()))
            return _Result(fut)

        def submit(self, func, callback=None):
            # joblib >= 1.5 entry point; older versions route through
            # apply_async directly.
            return self.apply_async(func, callback)

    # By import path: this module's attribute (``__getattr__`` below).
    RayTpuTorchBackend.__qualname__ = "RayTpuTorchBackend"
    RayTpuTorchBackend.__module__ = __name__
    _backend_cls = RayTpuTorchBackend
    return _backend_cls


def register_ray_tpu_torch() -> None:
    """Register the "ray_tpu_torch" joblib backend (parity: register_ray()).

    Usage:
        import joblib
        from ray_tpu_torch.util.joblib_backend import register_ray_tpu_torch
        register_ray_tpu_torch()
        with joblib.parallel_backend("ray_tpu_torch"):
            Parallel(n_jobs=8)(delayed(f)(x) for x in xs)
    """
    _, register_parallel_backend = _joblib()
    register_parallel_backend(BACKEND_NAME, _backend_class())


def __getattr__(name):
    if name == "RayTpuTorchBackend":
        return _backend_class()
    raise AttributeError(name)
