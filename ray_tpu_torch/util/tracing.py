"""OTel-style spans for the task path.

Role parity: python/ray/util/tracing/tracing_helper.py — the reference
wraps remote-call submission and worker-side execution in OpenTelemetry
spans and propagates the trace context inside the task spec. Same shape
here without the otel dependency: spans are plain dicts
{trace_id, span_id, parent_id, name, start, end, attrs}, the context
rides the task dict ("trace_ctx"), and finished spans buffer locally
until flushed to the conductor's span ring (state.list_spans / the
dashboard read them; export to a real OTLP collector is a sink swap).

Enabled via the `tracing_enabled` flag (env RAY_TPU_TRACING_ENABLED=1 or
init(_system_config={"tracing_enabled": True})). Off = zero overhead on
the hot path beyond one flag read.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from typing import Any, Dict, List, Optional

_buffer: List[dict] = []
_lock = threading.Lock()
_enabled_gen: Optional[int] = None
_enabled_v = False

# Span/trace id minting: a per-process entropy nonce + counter. uuid4()
# draws urandom per call — 10-20us on entropy-starved hosts, which at
# thousands of traced submits/s dominated the whole tracing tax — while
# the nonce keeps ids unique across processes at f-string cost.
_nonce = os.urandom(12).hex()           # 24 hex chars
_ids = itertools.count()


def _span_id() -> str:
    return f"{_nonce[:8]}{next(_ids) & 0xFFFFFFFF:08x}"


def _trace_id() -> str:
    return f"{_nonce}{next(_ids) & 0xFFFFFFFF:08x}"


def enabled() -> bool:
    # Cached against the config generation: this flag read sits on every
    # task submission (config.get walks os.environ — measurable at
    # thousands of submits/s).
    global _enabled_gen, _enabled_v
    from ray_tpu_torch import config
    if _enabled_gen != config.generation:
        _enabled_v = bool(config.get("tracing_enabled"))
        _enabled_gen = config.generation
    return _enabled_v


def new_context(parent: Optional[dict] = None) -> dict:
    """A fresh span context; child of ``parent`` when given."""
    if parent:
        return {"trace_id": parent.get("trace_id") or _trace_id(),
                "span_id": _span_id(),
                "parent_id": parent.get("span_id")}
    return {"trace_id": _trace_id(), "span_id": _span_id(),
            "parent_id": None}


def record(name: str, start: float, end: float, ctx: dict,
           attrs: Optional[Dict[str, Any]] = None) -> None:
    with _lock:
        _buffer.append({
            "name": name, "start": start, "end": end,
            "trace_id": ctx["trace_id"], "span_id": ctx["span_id"],
            "parent_id": ctx.get("parent_id"),
            "attrs": dict(attrs or {}),
        })
        if len(_buffer) > 65536:
            del _buffer[:len(_buffer) - 65536]


@contextlib.contextmanager
def span(name: str, parent: Optional[dict] = None,
         attrs: Optional[Dict[str, Any]] = None):
    """Context manager: times the body, records on exit, yields the span
    context for propagation (stick it in the task dict)."""
    if not enabled():
        yield None
        return
    ctx = new_context(parent)
    start = time.time()
    error = None
    try:
        yield ctx
    except BaseException as e:  # noqa: BLE001 - annotated and re-raised
        error = repr(e)
        raise
    finally:
        a = dict(attrs or {})
        if error:
            a["error"] = error
        record(name, start, time.time(), ctx, a)


def drain() -> List[dict]:
    with _lock:
        out, _buffer[:] = list(_buffer), []
    return out


def flush(conductor_client) -> None:
    """Ship buffered spans to the conductor ring; re-buffers on failure."""
    spans = drain()
    if not spans:
        return
    try:
        conductor_client.call("push_spans", spans=spans)
    except Exception:
        with _lock:
            _buffer[:0] = spans  # retry on the next flush
