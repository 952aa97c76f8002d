"""The driver of an MPMD pipeline over compiled-graph channels
(``CompiledPipeline``) and a synthetic stage for schedule and transport
benchmarks (``SleepStage``). Ported from ``ray_tpu/train/pipeline.py``;
``ray_tpu_torch.train.pipeline`` re-exports both beside its stage actor and
trainer.

Nothing here imports torch: ``SleepStage`` workers and a driver of a
pipeline over them (the control plane's microbenchmarks) load none.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Dict, List, Optional, Sequence

from ray_tpu_torch.dag import schedule as pipesched
from ray_tpu_torch.dag.channel import (FLAG_POISON, RpcChannelWriter,
                                       ShmChannelReader, ShmChannelWriter,
                                       make_channel_id)
from ray_tpu_torch.dag.compiled import (_decode_value, _encode_value, _events,
                                        _live_graphs, _read_slot, _write_slot)


def _runtime():
    from ray_tpu_torch.core.api import _global_runtime
    return _global_runtime()


class SleepStage:
    """Synthetic stage for schedule/transport benchmarks and tests: op
    cost is a pure sleep, so stages overlap even on a single-core host
    and measured efficiency isolates the SCHEDULE + channel overhead
    from the compute."""

    def __init__(self, fwd_s: float = 0.0, bwd_s: float = 0.0):
        self.fwd_s = float(fwd_s)
        self.bwd_s = float(bwd_s)

    def ping(self) -> str:
        return "pong"

    def pipe_forward(self, part, mb, *vals):
        if self.fwd_s:
            time.sleep(self.fwd_s)
        return vals[0] if vals else mb

    def pipe_backward(self, part, mb, *vals):
        if self.bwd_s:
            time.sleep(self.bwd_s)
        return vals[0] if vals else mb

    def pipe_apply(self):
        return {}

    pipe_report = pipe_apply


# ---------------------------------------------------------------------------
# the compiled pipeline (driver side)
# ---------------------------------------------------------------------------

class CompiledPipeline:
    """A static microbatch schedule compiled onto cgraph channels.

    Model-agnostic: ``actors[a]`` hosts partitions ``{p : p % s == a}``
    and must expose ``forward_method(part, mb, *chan_vals)``,
    ``backward_method(part, mb, *chan_vals)`` and a zero-arg
    ``apply_method`` (the per-step done barrier). The driver feeds
    microbatch inputs to partition 0 (and targets to the last partition
    when ``feed_targets``), and reads one done payload per actor per
    step — which doubles as the efficiency probe (each stage reports its
    measured busy seconds)."""

    def __init__(self, actors: Sequence[Any], *, num_microbatches: int,
                 num_partitions: Optional[int] = None,
                 schedule: str = "1f1b",
                 forward_method: str = "pipe_forward",
                 backward_method: str = "pipe_backward",
                 apply_method: str = "pipe_apply",
                 feed_targets: bool = False,
                 channel_slots: Optional[int] = None,
                 slot_bytes: Optional[int] = None,
                 max_in_flight_steps: Optional[int] = None,
                 submit_timeout: float = 60.0):
        from ray_tpu_torch import config
        rt = _runtime()
        if not hasattr(rt, "_actor_resolver"):
            raise RuntimeError(
                "CompiledPipeline requires cluster mode (resident stage "
                "loops live on actor workers; local mode has none)")
        s = len(actors)
        if s < 2:
            raise ValueError("a pipeline needs at least 2 stage actors")
        P = int(num_partitions or s)
        if P % s:
            raise ValueError(f"num_partitions {P} not a multiple of "
                             f"num_stages {s}")
        self._rt = rt
        self._gid = os.urandom(16)
        self.actors = list(actors)
        self.num_stages = s
        self.num_partitions = P
        self.num_chunks = P // s
        self.num_microbatches = int(num_microbatches)
        self.schedule = schedule
        self.feed_targets = bool(feed_targets)
        self._methods = (forward_method, backward_method, apply_method)
        self._slot_bytes = int(slot_bytes or config.get("pipeline_slot_bytes")
                               or config.get("cgraph_slot_bytes"))
        auto_slots = max(2, min(self.num_microbatches, P + 1))
        self._chan_slots = int(channel_slots or
                               config.get("pipeline_stage_channel_slots")
                               or auto_slots)
        self.max_in_flight_steps = int(
            max_in_flight_steps or config.get("pipeline_max_in_flight_steps"))
        self._submit_timeout = float(submit_timeout)
        self.bound = pipesched.bubble_bound(self.num_microbatches, s,
                                            self.num_chunks)
        self._lock = threading.RLock()
        self._next_step = 0
        self._read_step = 0
        self._results: Dict[int, dict] = {}
        self._poison_error: Optional[BaseException] = None
        self._torn_down = False
        self._installed: List[dict] = []       # per-actor {address, ...}
        self._done_readers: List[ShmChannelReader] = []
        self._feed_writers: List[Any] = []     # [input, targets?]
        self._actor_descs: List[dict] = []     # worker-owned rings (backstop)
        self._last_collect_t: Optional[float] = None
        try:
            self._build()
        except BaseException:  # noqa: BLE001 - cleanup then re-raise
            self._cleanup(best_effort=True)
            raise
        _live_graphs.add(self)

    # -- compilation -----------------------------------------------------

    def _build(self) -> None:
        rt = self._rt
        s, P, m = self.num_stages, self.num_partitions, self.num_microbatches
        fwd_m, bwd_m, apply_m = self._methods
        programs = pipesched.stage_programs(self.schedule, s, m,
                                            self.num_chunks)
        pipesched.validate_programs(programs, s, m, self.num_chunks)

        # Resolve stage placements (worker address + node daemon).
        daemons = {n["node_id"]: n["address"]
                   for n in rt.conductor.call("get_nodes")}
        places = []
        for h in self.actors:
            aid = h._rt_actor_id.binary()
            info = rt._actor_resolver.resolve(
                aid, timeout=self._submit_timeout) or {}
            if info.get("state") != "ALIVE":
                raise RuntimeError(
                    f"stage actor {aid.hex()} not ALIVE at compile time "
                    f"(state={info.get('state')!r})")
            if info["node_id"] not in daemons:
                raise RuntimeError(
                    f"no daemon known for node {info['node_id'].hex()}")
            places.append({"address": info["address"],
                           "node_id": info["node_id"],
                           "daemon": daemons[info["node_id"]]})

        def desc(owner: dict, nslots: int) -> dict:
            return {"id": make_channel_id(), "node_id": owner["node_id"],
                    "daemon": owner["daemon"], "nslots": nslots,
                    "slot_bytes": self._slot_bytes}

        owner = lambda p: places[pipesched.partition_owner(p, s)]
        driver = {"node_id": rt.node_id, "daemon": rt.daemon_address}
        n = self._chan_slots
        input_desc = desc(owner(0), n)
        targets_desc = desc(owner(P - 1), n) if self.feed_targets else None
        act_desc = {p: desc(owner(p), n) for p in range(1, P)}
        grad_desc = {p: desc(owner(p), n) for p in range(P - 1)}
        done_desc = [desc(driver, self.max_in_flight_steps)
                     for _ in range(s)]

        # Per-actor plans. Readers index into the actor's in_channels.
        plans = []
        for a, prog in enumerate(programs):
            in_channels: List[dict] = []
            index: Dict[bytes, int] = {}

            def rd(d: dict) -> int:
                i = index.get(d["id"])
                if i is None:
                    i = index[d["id"]] = len(in_channels)
                    in_channels.append(d)
                    self._actor_descs.append(d)
                return i

            ops: List[dict] = []
            for op in prog:
                p, mb = op.part, op.mb
                if op.kind == "F":
                    reads = [[rd(input_desc if p == 0 else act_desc[p]),
                              m, mb]]
                    if p == P - 1 and self.feed_targets:
                        reads.append([rd(targets_desc), m, mb])
                    writes = ([[act_desc[p + 1], m, mb]] if p < P - 1
                              else [])
                    method = fwd_m
                else:
                    reads = ([[rd(grad_desc[p]), m, mb]] if p < P - 1
                             else [])
                    writes = [[grad_desc[p - 1], m, mb]] if p > 0 else []
                    method = bwd_m
                flow = ("s" if (op.kind, p) == ("F", 0) else
                        "f" if (op.kind, p) == ("B", 0) else "t")
                ops.append({"method": method, "const": [p, mb],
                            "reads": reads, "writes": writes,
                            "ev": {"stage": a, "part": p, "mb": mb,
                                   "kind": op.kind, "flow": flow}})
            # Per-step done barrier: every actor ends its program with the
            # apply/report op writing its done ring (stride 1).
            ops.append({"method": apply_m, "const": [], "reads": [],
                        "writes": [[done_desc[a], 1, 0]], "ev": None,
                        "done": True})
            plans.append({"mode": "schedule", "stage": a,
                          "microbatches": m, "slot_bytes": self._slot_bytes,
                          "nslots": n, "in_channels": in_channels,
                          "ops": ops})

        # Driver-owned done rings exist before any loop can write them.
        for d in done_desc:
            self._done_readers.append(
                ShmChannelReader(rt.store, d["id"], d["nslots"],
                                 d["slot_bytes"]))

        from ray_tpu_torch.cluster.protocol import get_client
        for a, plan in enumerate(plans):
            resp = get_client(places[a]["address"]).call(
                "install_cgraph_loop", graph_id=self._gid, plan=plan,
                _timeout=self._submit_timeout)
            if not resp or not resp.get("ok"):
                raise RuntimeError(
                    f"pipeline loop install failed on stage {a}: {resp!r}")
            self._installed.append(places[a])

        def feed_writer(d: dict):
            if d["node_id"] == rt.node_id:
                return ShmChannelWriter(rt.store, d["id"])
            return RpcChannelWriter(d["id"], d["daemon"])

        self._feed_writers.append(feed_writer(input_desc))
        if targets_desc is not None:
            self._feed_writers.append(feed_writer(targets_desc))
        self._last_part_actor = pipesched.partition_owner(P - 1, s)

    # -- execution -------------------------------------------------------

    def _check_alive_locked(self) -> None:
        if self._torn_down:
            raise RuntimeError("pipeline was torn down")
        if self._poison_error is not None:
            raise RuntimeError(
                "pipeline is poisoned by a prior failure "
                f"({self._poison_error!r}); teardown() and rebuild") \
                from self._poison_error

    def submit(self, microbatches: Sequence[Any],
               targets: Optional[Sequence[Any]] = None,
               timeout: Optional[float] = None) -> int:
        """Feed one training step's microbatch stream; returns the step
        index. Blocks when ``max_in_flight_steps`` are outstanding."""
        m = self.num_microbatches
        if len(microbatches) != m:
            raise ValueError(f"expected {m} microbatches, "
                             f"got {len(microbatches)}")
        if self.feed_targets and (targets is None or len(targets) != m):
            raise ValueError(f"expected {m} target microbatches")
        deadline = time.monotonic() + (timeout or self._submit_timeout)
        with self._lock:
            self._check_alive_locked()
            while self._next_step - self._read_step >= \
                    self.max_in_flight_steps:
                self._collect_locked(self._read_step,
                                     deadline - time.monotonic())
            step = self._next_step
            self._next_step += 1
            try:
                feeds = ([microbatches, targets] if self.feed_targets
                         else [microbatches])
                for w, vals in zip(self._feed_writers, feeds):
                    for mb in range(m):
                        blob, flags = _encode_value(
                            vals[mb], self._slot_bytes, self._rt.plane)
                        _write_slot(w, step * m + mb, blob, flags,
                                    timeout=max(0.05, deadline -
                                                time.monotonic()),
                                    role="driver")
            except BaseException as e:  # noqa: BLE001 - poison the pipeline then re-raise
                if self._poison_error is None:
                    self._poison_error = e
                raise
        return step

    def _collect_locked(self, step: int, timeout: float) -> dict:
        """Drain every actor's done ring for ``step``: readiness-polling
        so poison from ANY stage surfaces immediately even while another
        stage is still wedged mid-schedule."""
        from ray_tpu_torch.core.exceptions import GetTimeoutError
        if step in self._results:
            return self._results.pop(step)
        deadline = time.monotonic() + timeout
        payloads: List[Optional[dict]] = [None] * len(self._done_readers)
        remaining = set(range(len(self._done_readers)))
        while remaining:
            progressed = False
            for i in sorted(remaining):
                if not self._done_readers[i].ready(step):
                    continue
                blob, flags = _read_slot(self._done_readers[i], step, 1.0)
                if flags & FLAG_POISON:
                    err = _decode_value(blob, flags & ~FLAG_POISON,
                                        self._rt.plane)
                    if not isinstance(err, BaseException):
                        err = RuntimeError(f"pipeline poisoned: {err!r}")
                    self._poison_error = err
                    raise err
                payloads[i] = _decode_value(blob, flags, self._rt.plane)
                remaining.discard(i)
                progressed = True
            if not remaining:
                break
            if time.monotonic() > deadline:
                raise GetTimeoutError(
                    f"pipeline step {step} done barrier not reached within "
                    f"{timeout:.1f}s (stages pending: {sorted(remaining)})")
            if not progressed:
                time.sleep(0.0005)
        self._read_step = max(self._read_step, step + 1)

        now = time.perf_counter()
        wall = (now - self._last_collect_t
                if self._last_collect_t is not None else None)
        self._last_collect_t = now
        busy = [float(p.get("busy_s", 0.0)) for p in payloads if p]
        eff = (sum(busy) / (self.num_stages * wall)
               if wall and wall > 0 else None)
        merged = dict(payloads[self._last_part_actor] or {})
        for key in ("busy_s", "codec_s", "stage"):
            merged.pop(key, None)
        merged["stages"] = payloads
        merged["wall_s"] = wall
        merged["busy_s"] = busy
        merged["codec_s"] = [float(p.get("codec_s", 0.0))
                             for p in payloads if p]
        merged["efficiency"] = eff
        merged["bound"] = self.bound
        _events().emit("pipeline.step", self._gid.hex()[:16],
                       value=float(wall or 0.0),
                       attrs={"step": step, "stages": self.num_stages,
                              "microbatches": self.num_microbatches,
                              "schedule": self.schedule,
                              "efficiency": eff})
        return merged

    def collect(self, step: Optional[int] = None,
                timeout: Optional[float] = None) -> dict:
        from ray_tpu_torch import config
        with self._lock:
            self._check_alive_locked()
            if step is None:
                step = self._read_step
            if step >= self._next_step:
                raise ValueError(f"step {step} was never submitted")
            return self._collect_locked(
                step, timeout or config.get("pipeline_step_timeout_s"))

    def step(self, microbatches: Sequence[Any],
             targets: Optional[Sequence[Any]] = None,
             timeout: Optional[float] = None) -> dict:
        t = self.submit(microbatches, targets, timeout=timeout)
        return self.collect(t, timeout=timeout)

    # -- teardown --------------------------------------------------------

    def teardown(self) -> None:
        """Uninstall the stage loops, delete every ring segment, restore
        classic actor task service. Idempotent."""
        with self._lock:
            if self._torn_down:
                return
            self._torn_down = True
        self._cleanup(best_effort=True)
        _live_graphs.discard(self)

    def _cleanup(self, best_effort: bool = False) -> None:
        from ray_tpu_torch.cluster.protocol import get_client
        for place in self._installed:
            try:
                get_client(place["address"]).call(
                    "teardown_cgraph_loop", graph_id=self._gid,
                    _timeout=20.0)
            except Exception:
                if not best_effort:
                    raise
        for w in self._feed_writers:
            try:
                w.close()
            except Exception:
                pass
        for r in self._done_readers:
            try:
                r.close()
            except Exception:
                pass
        # Backstop: a CRASHED worker cannot delete the rings it owns; its
        # node daemon still can (idempotent for rings already gone).
        for d in self._actor_descs:
            try:
                get_client(d["daemon"]).call("delete_object", oid=d["id"],
                                             _timeout=5.0)
            except Exception:
                pass
        self._installed = []
        self._feed_writers = []
        self._done_readers = []
        self._actor_descs = []

    def __repr__(self):
        return (f"CompiledPipeline({self._gid.hex()[:8]}, "
                f"stages={self.num_stages}x{self.num_chunks}, "
                f"m={self.num_microbatches}, schedule={self.schedule!r})")
