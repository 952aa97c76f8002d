"""Lock-order sanitizer for the named control-plane locks.

Role parity: the reference leans on clang's thread-safety annotations
(``GUARDED_BY``/``ACQUIRED_AFTER``) and TSAN suites to keep its C++
control plane deadlock-free. Python has neither, so this module gives
the coarse per-plane locks (conductor state, daemon state, object plane,
serve controller) a runtime sanitizer instead:

- every ``NamedLock`` acquisition records a per-thread held-lock stack
  (``threading.local``) and, per process, the acquisition-order edges
  between named locks ("held A, then took B");
- a new edge runs a DFS over the edge graph — a path back to the source
  is a lock-order cycle, i.e. a potential deadlock, reported once per
  cycle signature as a ``lock.cycle`` flight-recorder event and counted
  in ``rt_lock_cycles_total``;
- releasing a lock held longer than ``lockcheck_hold_s`` reports
  ``lock.long_hold`` / ``rt_lock_long_holds_total`` (a long hold on a
  control-plane lock is the precursor to every "conductor froze"
  incident r07/r13 chased).

Disabled cost (the default): ``acquire``/``release`` do one cached
generation compare — the fault_plane pattern — and delegate straight to
the wrapped ``threading.Lock``. The sanitizer arms process-wide via the
``lockcheck_enabled`` config flag; tests/conftest.py flips it for the
conductor/daemon/serve-heavy modules and asserts ``cycles()`` stays
empty.

``NamedLock`` deliberately implements only ``acquire``/``release`` (not
``_release_save``/``_acquire_restore``/``_is_owned``), so
``threading.Condition(NamedLock(...))`` uses its portable fallback path
and every ``cv.wait()`` release/reacquire passes through the sanitizer.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Set, Tuple

from ray_tpu_torch import config

_enabled_gen: Optional[int] = None
_enabled_v = False
_hold_s = 0.0

# acquisition-order edges: held lock name -> names acquired while held
_graph_lock = threading.Lock()
_edges: Dict[str, Set[str]] = {}
_cycles: List[Tuple[str, ...]] = []
_cycle_sigs: Set[Tuple[str, ...]] = set()
_long_holds: List[Tuple[str, float]] = []

_tls = threading.local()


def _enabled() -> bool:
    global _enabled_gen, _enabled_v, _hold_s
    if _enabled_gen != config.generation:
        _enabled_v = bool(config.get("lockcheck_enabled"))
        _hold_s = float(config.get("lockcheck_hold_s"))
        _enabled_gen = config.generation
    return _enabled_v


def _held_stack() -> List[Tuple[str, float]]:
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    return stack


def _find_cycle(src: str, dst: str) -> Optional[Tuple[str, ...]]:
    """Path dst ->* src in the edge graph (new edge src->dst closes it)."""
    path = [dst]
    seen = {dst}

    def dfs(node: str) -> bool:
        for nxt in _edges.get(node, ()):
            if nxt == src:
                path.append(src)
                return True
            if nxt not in seen:
                seen.add(nxt)
                path.append(nxt)
                if dfs(nxt):
                    return True
                path.pop()
        return False

    return tuple([src] + path) if dfs(dst) else None


def _report_cycle(cycle: Tuple[str, ...]) -> None:
    # Canonical signature: rotate so the lexicographically-smallest name
    # leads — A->B->A and B->A->B are the same cycle.
    body = cycle[:-1]
    i = body.index(min(body))
    sig = body[i:] + body[:i]
    if sig in _cycle_sigs:
        return
    _cycle_sigs.add(sig)
    _cycles.append(cycle)
    try:
        from ray_tpu_torch.util import events
        events.emit("lock.cycle", ident=cycle[0],
                    attrs={"cycle": "->".join(cycle)})
    except Exception:
        pass


def _note_acquired(name: str) -> None:
    stack = _held_stack()
    if stack:
        holder = stack[-1][0]
        if holder != name:
            with _graph_lock:
                targets = _edges.setdefault(holder, set())
                if name not in targets:
                    targets.add(name)
                    cycle = _find_cycle(holder, name)
                    if cycle:
                        _report_cycle(cycle)
    stack.append((name, time.monotonic()))


def _note_released(name: str) -> None:
    stack = _held_stack()
    for i in range(len(stack) - 1, -1, -1):
        if stack[i][0] == name:
            _, t0 = stack.pop(i)
            held = time.monotonic() - t0
            if _hold_s > 0 and held > _hold_s:
                with _graph_lock:
                    _long_holds.append((name, held))
                try:
                    from ray_tpu_torch.util import events
                    events.emit("lock.long_hold", ident=name, value=held)
                except Exception:
                    pass
            return
    # Acquired while the sanitizer was off, released after it armed (or
    # vice versa): nothing to unwind.


class NamedLock:
    """A ``threading.Lock`` with a name and an optional order sanitizer.

    Drop-in for the control-plane ``self._lock`` attributes, including
    as the underlying lock of a ``threading.Condition``.
    """

    __slots__ = ("name", "_inner")

    def __init__(self, name: str,
                 inner: Optional[threading.Lock] = None):
        self.name = name
        self._inner = inner if inner is not None else threading.Lock()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        got = self._inner.acquire(blocking, timeout)
        if got and _enabled():
            _note_acquired(self.name)
        return got

    def release(self) -> None:
        if _enabled():
            _note_released(self.name)
        self._inner.release()

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:
        return f"<NamedLock {self.name} {self._inner!r}>"


def named_lock(name: str) -> NamedLock:
    """The way planes mint their coarse state locks."""
    return NamedLock(name)


def cycles() -> List[Tuple[str, ...]]:
    """Lock-order cycles seen in this process (test assertions)."""
    with _graph_lock:
        return list(_cycles)


def long_holds() -> List[Tuple[str, float]]:
    with _graph_lock:
        return list(_long_holds)


def edges() -> Dict[str, Set[str]]:
    with _graph_lock:
        return {k: set(v) for k, v in _edges.items()}


def reset() -> None:
    """Forget the edge graph and findings (between tests)."""
    with _graph_lock:
        _edges.clear()
        _cycles.clear()
        _cycle_sigs.clear()
        _long_holds.clear()
