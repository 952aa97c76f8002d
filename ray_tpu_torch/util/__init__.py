"""Utility layer of the port (parity: python/ray/util/): placement groups,
scheduling strategies, the actor pool, the distributed queue, the
multiprocessing pool and the joblib backend, beside the lock-order
sanitizer, the event ring, metrics, tracing spans and the stack sampler
that the cluster runtime calls. ``ActorPool`` and ``Queue`` load with their
modules on first use: the cluster's workers import this package and stay
light."""

_EXPORTS = {"ActorPool": "actor_pool", "Queue": "queue"}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        import importlib
        module = importlib.import_module(f"{__name__}.{_EXPORTS[name]}")
        return getattr(module, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
