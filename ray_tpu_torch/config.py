"""Runtime configuration flag registry. Ported from ``ray_tpu/config.py``.

Every flag is declared once with a type and default; ``RT_<NAME>`` env vars
override; ``init(_system_config={...})`` overrides both for the session.
Only the flags that the port's runtime reads are declared, each under the
JAX package's name, type and default. Propagating overrides to spawned
processes waits for the cluster runtime.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Callable, Dict

_ENV_PREFIX = "RT_"


@dataclass
class _Flag:
    name: str
    type: Callable[[Any], Any]
    default: Any
    doc: str


_REGISTRY: Dict[str, _Flag] = {}
_overrides: Dict[str, Any] = {}
# Bumped on every override change: hot paths cache a flag's resolved value
# against this generation instead of re-reading os.environ on each call.
generation = 0


def _parse_bool(v: Any) -> bool:
    if isinstance(v, bool):
        return v
    return str(v).strip().lower() in ("1", "true", "yes", "on")


def define(name: str, type_: Callable, default: Any, doc: str = "") -> None:
    if type_ is bool:
        type_ = _parse_bool
    _REGISTRY[name] = _Flag(name, type_, default, doc)


def get(name: str) -> Any:
    flag = _REGISTRY[name]
    if name in _overrides:
        return _overrides[name]
    env = os.environ.get(_ENV_PREFIX + name.upper())
    if env is not None:
        return flag.type(env)
    return flag.default


def set_system_config(cfg: Dict[str, Any]) -> None:
    """Apply a session-level override dict (validated against the registry)."""
    global generation
    for k, v in cfg.items():
        if k not in _REGISTRY:
            raise ValueError(f"Unknown system config flag: {k!r}")
        _overrides[k] = _REGISTRY[k].type(v)
    generation += 1


def set_override(name: str, value: Any) -> None:
    """Set one override. Bumps the generation so cached flag reads observe
    the change."""
    global generation
    if name not in _REGISTRY:
        raise ValueError(f"Unknown system config flag: {name!r}")
    _overrides[name] = _REGISTRY[name].type(value)
    generation += 1


def clear_override(name: str) -> None:
    global generation
    _overrides.pop(name, None)
    generation += 1


# --------------------------------------------------------------------------
# Flag definitions (the JAX package's, for the modules the port copies).
# --------------------------------------------------------------------------

define("array_zero_copy_enabled", bool, True,
       "Serialize top-level numpy arrays and torch tensors as a tiny RTAR "
       "header plus the raw buffer instead of pickling the payload. Off = "
       "the classic pickle-5 path.")
define("worker_pool_max_size", int, 8,
       "Max concurrent leased workers per node (the in-process runtime's "
       "task thread pool).")

# Serve ingress (serve/http_proxy.py admission control + serve/api.py
# handle routing + serve/controller.py drain)
define("serve_max_queued_requests", int, 200,
       "Per-deployment proxy-side queue budget: requests waiting for an "
       "ongoing slot past this depth are shed with 503 + Retry-After "
       "instead of queueing unboundedly (parity: serve "
       "max_queued_requests proxy backpressure).")
define("serve_max_ongoing_requests", int, 8,
       "Per-replica in-flight request cap (parity: serve "
       "max_ongoing_requests). The handle routes only to replicas under "
       "the cap and the proxy bounds dispatched work to "
       "replicas x cap; deployments override with "
       "@serve.deployment(max_ongoing_requests=N).")
define("serve_request_timeout_s", float, 30.0,
       "End-to-end deadline for one ingress request (queue wait + replica "
       "call). Expiry answers 504 and cancels the in-flight call instead "
       "of leaking it (parity: RAY_SERVE_REQUEST_PROCESSING_TIMEOUT_S).")
define("serve_drain_timeout_s", float, 10.0,
       "Graceful-drain window on scale-down/delete: a DRAINING replica "
       "leaves the routing table immediately (generation bump) and gets "
       "this long to finish in-flight requests before the kill (parity: "
       "serve graceful_shutdown_timeout_s).")
