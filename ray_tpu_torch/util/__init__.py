"""Utility layer of the port: the lock-order sanitizer, the event ring,
metrics, tracing spans and the stack sampler that the cluster runtime
calls (parity: python/ray/util/). Placement groups, the actor pool and the
distributed queue are still to port (ROADMAP.md A.5)."""
