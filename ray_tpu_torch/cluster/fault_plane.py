"""Deterministic, seeded fault-injection plane.

Role parity: the reference's chaos hooks (RAY_testing_asio_delay_us,
ray_config_def.h:762, plus the kill-raylet/kill-gcs helpers its
test_chaos/test_failure suites script by hand). Here the hooks are
first-class: every plane exposes named fault points —

    fault_plane.fire("rpc.server.dispatch", method=method)

— and a config-driven PLAN decides which points fire, when, and how.
The plan is a JSON list of rules in the ``fault_plan`` flag, so it
propagates to spawned daemons and workers like any other system-config
override (RT_SYSTEM_CONFIG_JSON), letting one test script faults deep
inside child processes.

Rule shape (all keys optional except ``site``)::

    {"site": "rpc.server.reply",      # exact name or fnmatch pattern
     "match": {"method": "fetch_chunk"},  # equality filters on fire() ctx
     "action": "delay",               # delay|raise|drop_reply|sever|crash
     "delay_s": 0.2,                  # for delay
     "exc": "ConnectionLost",         # for raise (exception class name)
     "nth": 3,                        # fire on the 3rd matching hit only
     "every": 2,                      # or: fire every 2nd matching hit
     "prob": 0.1, "seed": 7,          # or: seeded per-hit probability
     "times": 1}                      # max firings (default: unlimited)

Scheduling is deterministic: nth/every count matching hits per rule in
this process; probability rules draw from ``random.Random`` seeded with
``seed ^ crc32(site)`` (falling back to the ``fault_seed`` flag), so the
same plan + same hit sequence reproduces the same faults. Chaos tests
print their seed so a failure replays exactly.

Action contract at a fault point:

- ``delay``  — handled here (sleep), fire() returns None.
- ``raise``  — raises the named exception from fire().
- ``crash``  — ``os._exit(exit_code)`` (default 17): a hard process kill
  with no atexit/finally, the closest stand-in for SIGKILL/preemption.
- ``drop_reply`` / ``sever`` — returned as a string; only call sites
  that can honor them (server reply path, client socket paths) check
  the return value, everywhere else they are ignored.

Disabled cost: fire() compares one cached generation int and does one
dict lookup, then returns — no config re-resolution, no allocation —
so fault points stay free on the hot RPC/dispatch paths when no plan
is loaded. The legacy ``testing_rpc_delay_us`` flag is subsumed: it is
compiled into delay rules on the ``rpc.server.dispatch`` site.

Object-tiering sites (spill/restore/evict, r12): ``object.spill.write``
fires before the daemon writes a cold primary through the spill backend
(raise = the write fails, the shm copy stays); ``object.spill.restore``
fires before a plane restores from a spill URL and before a daemon
serves a chunk from its spill file (delay models slow backends, raise
drives the restore-failure -> remove_spilled -> reconstruction path);
``object.evict`` fires before the shm copy of a spilled object is
dropped (raise keeps dual copies — safe, the durable copy already
exists).

Serve ingress sites (r14): ``serve.proxy.admit`` fires in the HTTP
proxy before a request is admitted (raise = shed with 503, the
admission-rejection chaos knob); ``serve.replica.call`` fires inside
the replica before user code runs (crash kills the replica mid-request
— the headline chaos-SLO scenario; the handle retries the call on
another replica); ``serve.replica.drain`` fires when the controller
marks a replica DRAINING (raise degrades the graceful drain to an
immediate kill). Replacement replicas re-arm per-process hit counters,
so ``nth``-scheduled kills recur across respawns.
"""

from __future__ import annotations

import fnmatch
import json
import os
import random
import threading
import time
import zlib
from typing import Any, Dict, List, Optional

from ray_tpu_torch import config


# Canonical fault-site registry: every ``fire("…")`` literal in the tree
# must be listed here (enforced by rtcheck's fault-sites checker, both
# directions), ``load_plan`` validates rule sites against it, and the
# ``ray_tpu_torch fault-sites`` CLI prints it. The one-line doc says where the
# site sits and what a fired rule models.
SITES: Dict[str, str] = {
    "rpc.server.dispatch": "server, before a handler runs (delay models "
                           "a slow/overloaded server; subsumes "
                           "testing_rpc_delay_us)",
    "rpc.server.reply": "server, before the reply frame is written "
                        "(drop_reply models a reply lost on the wire)",
    "rpc.client.send": "client, before a request frame is written "
                       "(sever cuts the connection mid-send)",
    "rpc.client.recv": "client, while waiting for a reply frame "
                       "(raise ConnectionLost models a dead peer)",
    "conductor.journal.append": "conductor, before a journal record is "
                                "appended (raise models journal-disk "
                                "failure)",
    "conductor.actor.schedule": "conductor, before an actor placement "
                                "decision commits",
    "conductor.location.add": "conductor, before an object location is "
                              "recorded in the directory",
    "daemon.worker.spawn": "daemon, before a worker process is forked "
                           "(raise models spawn failure / OOM-killer)",
    "daemon.lease.grant": "daemon, before a worker lease is granted",
    "daemon.chunk.serve": "daemon, before a pull chunk is served from "
                          "the local store",
    "object.pull": "object plane, at pull start (raise fails the pull "
                   "before any source is tried)",
    "object.pull.window": "object plane, per pull window grant (delay "
                          "models a saturated pull budget)",
    "object.pull.chunk": "object plane, per fetched chunk (raise drives "
                         "the source-failover path)",
    "object.push.chunk": "push manager, per pushed chunk (raise models "
                         "a failed push leg)",
    "object.spill.write": "daemon, before a cold primary is written to "
                          "the spill backend (raise keeps the shm copy)",
    "object.spill.restore": "plane/daemon, before a spilled object is "
                            "restored or served from its spill file "
                            "(raise drives reconstruction)",
    "object.evict": "daemon, before the shm copy of a spilled object is "
                    "dropped (raise keeps dual copies)",
    "worker.task.exec": "worker, before user task code runs (crash "
                        "models mid-task preemption)",
    "worker.actor.exec": "worker, before an actor method body runs",
    "task.return.seal": "worker, before a task return is sealed into "
                        "the store",
    "task.reply.inline": "worker, before an inline (small) return rides "
                         "the reply frame",
    "cgraph.channel.write": "compiled graph, before a shm channel slot "
                            "write",
    "cgraph.loop.crash": "compiled graph, inside the per-actor exec "
                         "loop (crash kills the pinned worker)",
    "serve.proxy.admit": "HTTP proxy, before a request is admitted "
                         "(raise sheds with 503)",
    "serve.replica.call": "replica, before user handler code runs "
                          "(crash is the chaos-SLO headline scenario)",
    "serve.replica.drain": "controller, when a replica is marked "
                           "DRAINING (raise degrades to immediate kill)",
    "object.array.export": "serialization, before an array buffer is "
                           "exported zero-copy (raise falls back to the "
                           "classic pickle path)",
    "object.collective.bcast": "object plane, per broadcast tree leg "
                               "(sever cuts that member's connection; "
                               "the member re-stripes onto the classic "
                               "pull path)",
}


class FaultInjected(Exception):
    """Default exception raised by a ``raise`` action."""


def _exc_class(name: str):
    if name in ("ConnectionLost", "RpcError"):
        from ray_tpu_torch.cluster import protocol
        return getattr(protocol, name)
    return {
        "OSError": OSError,
        "ConnectionError": ConnectionError,
        "ConnectionResetError": ConnectionResetError,
        "BrokenPipeError": BrokenPipeError,
        "TimeoutError": TimeoutError,
        "RuntimeError": RuntimeError,
    }.get(name, FaultInjected)


class _Rule:
    __slots__ = ("site", "match", "action", "delay_s", "exc", "nth",
                 "every", "prob", "times", "rng", "hits", "fired", "key")

    def __init__(self, spec: Dict[str, Any], index: int, base_seed: int):
        self.site = spec["site"]
        self.match = spec.get("match") or {}
        self.action = spec.get("action", "raise")
        self.delay_s = float(spec.get("delay_s", 0.0))
        self.exc = spec.get("exc", "FaultInjected")
        self.nth = spec.get("nth")
        self.every = spec.get("every")
        self.prob = spec.get("prob")
        self.times = spec.get("times")
        seed = spec.get("seed", base_seed)
        self.rng = random.Random(
            int(seed) ^ zlib.crc32(self.site.encode()) ^ index)
        self.hits = 0
        self.fired = 0
        # Identity that survives plan recompiles (a config generation bump
        # from an unrelated set_override must not reset nth-hit counters).
        self.key = (index, json.dumps(spec, sort_keys=True))

    def adopt(self, prev: "_Rule") -> None:
        self.hits, self.fired, self.rng = prev.hits, prev.fired, prev.rng

    def should_fire(self, ctx: Dict[str, Any]) -> bool:
        for k, v in self.match.items():
            if ctx.get(k) != v:
                return False
        self.hits += 1
        if self.times is not None and self.fired >= self.times:
            return False
        if self.nth is not None:
            hit = self.hits == int(self.nth)
        elif self.every is not None:
            hit = self.hits % int(self.every) == 0
        elif self.prob is not None:
            hit = self.rng.random() < float(self.prob)
        else:
            hit = True
        if hit:
            self.fired += 1
        return hit


class _Compiled:
    __slots__ = ("gen", "exact", "patterns", "legacy")

    def __init__(self, gen: int):
        self.gen = gen
        self.exact: Dict[str, List[_Rule]] = {}
        self.patterns: List[_Rule] = []
        self.legacy: Optional[str] = None  # testing_rpc_delay_us spec


_compiled = _Compiled(-1)
_lock = threading.Lock()
_stats: Dict[str, int] = {}


def _recompile() -> _Compiled:
    global _compiled
    with _lock:
        if _compiled.gen == config.generation:
            return _compiled
        prev = {}
        for rules in list(_compiled.exact.values()) + [_compiled.patterns]:
            for r in rules:
                prev[r.key] = r
        new = _Compiled(config.generation)
        blob = config.get("fault_plan")
        base_seed = int(config.get("fault_seed"))
        specs = json.loads(blob) if blob else []
        for i, spec in enumerate(specs):
            rule = _Rule(spec, i, base_seed)
            if rule.key in prev:
                rule.adopt(prev[rule.key])
            if any(c in rule.site for c in "*?["):
                new.patterns.append(rule)
            else:
                new.exact.setdefault(rule.site, []).append(rule)
        legacy = config.get("testing_rpc_delay_us")
        new.legacy = str(legacy) if legacy else None
        _compiled = new
        return new


def _legacy_delay(spec: str, method: str) -> None:
    # testing_rpc_delay_us compatibility: "<us>" or "<method>:<us>,..."
    if ":" in spec:
        for part in spec.split(","):
            name, _, us = part.partition(":")
            if name == method and us.isdigit():
                time.sleep(int(us) / 1e6)
                return
    elif spec.isdigit() and int(spec):
        time.sleep(int(spec) / 1e6)


def fire(site: str, **ctx: Any) -> Optional[str]:
    """Evaluate one fault point. Returns None (possibly after sleeping),
    returns "drop_reply"/"sever" for the call site to honor, raises the
    rule's exception, or never returns (crash)."""
    c = _compiled
    if c.gen != config.generation:
        c = _recompile()
    rules = c.exact.get(site)
    if rules is None and not c.patterns and c.legacy is None:
        return None  # disabled fast path
    if c.legacy is not None and site == "rpc.server.dispatch":
        _legacy_delay(c.legacy, ctx.get("method", ""))
    out: Optional[str] = None
    matched = list(rules) if rules else []
    for r in c.patterns:
        if fnmatch.fnmatch(site, r.site):
            matched.append(r)
    for r in matched:
        with _lock:
            hit = r.should_fire(ctx)
        if not hit:
            continue
        _stats[site] = _stats.get(site, 0) + 1
        try:
            # Lazy import: fault_plane loads before the util package in
            # some spawn paths, and a fired rule is far off any hot path.
            from ray_tpu_torch.util import events as _events
            _events.emit("fault.fired", site, attrs={"action": r.action})
        except Exception:
            pass
        if r.action == "delay":
            time.sleep(r.delay_s)
        elif r.action == "raise":
            raise _exc_class(r.exc)(
                f"injected fault at {site} ({ctx or {}})")
        elif r.action == "crash":
            os._exit(17)
        elif r.action in ("drop_reply", "sever"):
            out = r.action
    return out


def load_plan(rules: List[Dict[str, Any]], seed: int = 0) -> None:
    """Install a plan for this process AND (via config propagation) every
    daemon/worker spawned afterwards. Rule sites must name a registered
    fault point (exact match against ``SITES``, or an fnmatch pattern
    matching at least one) — a typo'd site would otherwise arm a plan
    that silently never fires. The ``unit.`` prefix is reserved for
    tests that exercise the schedule machinery against synthetic
    ``fire()`` calls."""
    for spec in rules:
        site = spec.get("site", "")
        if site.startswith("unit."):
            continue
        if any(c in site for c in "*?["):
            if not any(fnmatch.fnmatch(s, site) for s in SITES):
                raise ValueError(
                    f"fault_plan pattern {site!r} matches no registered "
                    f"site (see fault_plane.SITES)")
        elif site not in SITES:
            raise ValueError(
                f"fault_plan site {site!r} is not registered in "
                f"fault_plane.SITES")
    config.set_override("fault_plan", json.dumps(rules))
    config.set_override("fault_seed", int(seed))


def clear_plan() -> None:
    config.clear_override("fault_plan")
    config.clear_override("fault_seed")
    reset()


def reset() -> None:
    """Forget hit counters and stats (plan rules re-arm)."""
    global _compiled
    with _lock:
        _compiled = _Compiled(-1)
        _stats.clear()


def stats() -> Dict[str, int]:
    """Fired-count per site in this process (test assertions)."""
    with _lock:
        return dict(_stats)
