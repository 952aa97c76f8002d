"""MPMD pipeline-parallel training compiled onto cgraph channels. Ported from
``ray_tpu/train/pipeline.py``.

Role parity: the MPMD 1F1B executor of "Scaling Deep Learning Training
with MPMD Pipeline Parallelism" (PAPERS.md), built from the pieces the
port already has — transformer layer partitions (models/transformer.py
``transformer_stage_forward`` over ``_stage_apply``), static per-actor
schedules (dag/schedule.py), and the compiled-graph transport
(dag/channel.py rings same-host, pipelined-RPC forwarder cross-host,
object-store spill for oversized tensors). Contrast with ops/pipeline.py,
which is the SPMD pipeline inside one program: here every stage is its own
actor process running a resident ``ScheduledWorkerLoop``, so steady state
costs channel slot writes — never task RPCs — and stage compute overlaps
neighbor transfer.

Three layers:

- ``PipelineStageActor`` — hosts one or more layer partitions on its
  device; forward / recompute-backward / loss per partition, accumulates
  grads across microbatches, applies the optimizer in-loop
  (``pipe_apply``) or on driver command (``pipe_report`` +
  ``apply_external`` when DP replicas average grads first).
- ``CompiledPipeline`` — model-agnostic driver: mints the channel
  topology (input/targets feeds, activation + gradient edges, per-actor
  done rings), compiles the schedule into per-actor op programs, installs
  the loops, and paces training steps through the rings with poison-
  aware collection and bubble-bound efficiency accounting.
- ``PipelineTrainer`` — the user-facing trainer: partitions a
  TransformerConfig model, optionally replicates the whole pipeline
  ``dp_replicas`` times (grad averaging between steps), and exposes
  ``step()`` / ``train()``.

Where the JAX package jits a ``jax.vjp`` of the partition, a stage here
replays the partition's forward under autograd in the backward op and
takes the grads of its parameters and its input with ``gy``: the same
recompute-in-backward trade. The optimizer is a ``torch.optim`` optimizer
per partition, made by ``tx_factory(leaves)`` (a module-level callable: the
port sends callables by import path); the default is AdamW in optax's
``adamw(lr, weight_decay=0.01)`` setting. Activations and gradients cross
the stage boundary through the host: the channel's encoding copies a CUDA
tensor to the host, and the stage moves what arrives to its card.

Failure semantics match compiled graphs: a stage exception (or injected
``cgraph.loop.crash``) poisons every out channel at its next-unwritten
slot, downstream loops forward and unwind, and the driver's collect
raises the original error fast instead of waiting out the step deadline.
``teardown()`` uninstalls loops, deletes every ring segment (with a
daemon-side backstop for rings owned by a dead worker), and returns the
actors to classic task service.
"""

from __future__ import annotations

import dataclasses
import functools
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.dag import schedule as pipesched
from ray_tpu_torch.dag.channel import (FLAG_POISON, RpcChannelWriter,
                                       ShmChannelReader, ShmChannelWriter,
                                       make_channel_id)
from ray_tpu_torch.dag.compiled import (_decode_value, _encode_value, _events,
                                        _live_graphs, _read_slot, _write_slot)


def _runtime():
    from ray_tpu_torch.core.api import _global_runtime
    return _global_runtime()


def _flatten(tree, prefix: str = "") -> List[tuple]:
    """[(path, leaf)] of a dict tree, in its key order."""
    if isinstance(tree, dict):
        return [item for k, v in tree.items()
                for item in _flatten(v, f"{prefix}{k}/")]
    return [(prefix[:-1], tree)]


def _unflatten(items) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for path, leaf in items:
        *keys, last = path.split("/")
        node = out
        for k in keys:
            node = node.setdefault(k, {})
        node[last] = leaf
    return out


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


# ---------------------------------------------------------------------------
# stage actors
# ---------------------------------------------------------------------------

class PipelineStageActor:
    """Hosts the layer partitions assigned to one pipeline stage.

    The backward recomputes: the forward stashes only its INPUT per
    microbatch (on the device), and the backward replays the partition
    under autograd, trading FLOPs for stash memory exactly like remat
    inside the layers. ``device=None`` is the card this actor's worker
    leased; ``"cpu"`` runs the plain path."""

    def __init__(self, cfg, owned_parts: Sequence[int], tx_factory=None,
                 device=None):
        self.cfg = cfg
        self.owned = sorted(int(p) for p in owned_parts)
        self._tx_factory = tx_factory or _default_tx_factory
        self.device = resolve_device(device)
        self._params: Dict[int, List[tuple]] = {}   # part -> [(path, leaf)]
        self._opt: Dict[int, torch.optim.Optimizer] = {}
        self._grads: Dict[int, List[torch.Tensor]] = {}
        self._stash: Dict[tuple, Any] = {}
        self._loss_sum = 0.0
        self._loss_n = 0

    # -- setup (classic task service) ------------------------------------

    def ping(self) -> str:
        return "pong"

    def load_partition(self, part: int, params) -> int:
        """``params``: the partition's tree (``transformer_partition_params``)
        of numpy arrays or tensors; copied to this actor's device in the
        config's param dtype."""
        part = int(part)
        items = []
        for path, leaf in _flatten(params):
            t = leaf if torch.is_tensor(leaf) else \
                torch.from_numpy(np.array(leaf))
            t = t.detach().to(self.device, self.cfg.param_dtype,
                              copy=True).requires_grad_(True)
            items.append((path, t))
        self._params[part] = items
        self._opt[part] = self._tx_factory([t for _, t in items])
        return part

    def get_partition(self, part: int) -> Dict[str, Any]:
        """The partition's current parameters as a tree of numpy arrays."""
        return _unflatten((p, _host(t)) for p, t in self._params[int(part)])

    def device_stats(self, reset: bool = False) -> Dict[str, Any]:
        """This process's flash-kernel launch counts (forward, dK/dV, dQ, Δ)
        and the card's peak allocated bytes since the last reset; with
        ``reset`` both start again from 0."""
        from ray_tpu_torch.ops import flash
        out = {"launches": (flash.launches, flash.bwd_dkv_launches,
                            flash.bwd_dq_launches,
                            flash.bwd_delta_launches),
               "peak_bytes": (torch.cuda.max_memory_allocated(self.device)
                              if self.device.type == "cuda" else 0)}
        if reset:
            flash.launches = flash.bwd_dkv_launches = 0
            flash.bwd_dq_launches = flash.bwd_delta_launches = 0
            if self.device.type == "cuda":
                torch.cuda.reset_peak_memory_stats(self.device)
        return out

    # -- per-partition compute -------------------------------------------

    def _tree(self, part: int) -> Dict[str, Any]:
        return _unflatten(self._params[part])

    def _leaves(self, part: int) -> List[torch.Tensor]:
        return [t for _, t in self._params[part]]

    def _fwd(self, part: int, x):
        from ray_tpu_torch.models.transformer import transformer_stage_forward
        b, s = x.shape[:2]
        positions = torch.arange(s, device=self.device).expand(b, s)
        return transformer_stage_forward(self._tree(part), x, positions,
                                         self.cfg, part=part,
                                         device=self.device)

    def _to_device(self, v) -> torch.Tensor:
        t = v if torch.is_tensor(v) else torch.from_numpy(np.array(v))
        return t.to(self.device)

    def _done(self, value=None):
        """An op's result, once the device has finished the op's work: the
        loop's busy time (the efficiency probe) then counts device time, and
        the channel's copy to the host does not wait inside the codec."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return value

    def _accumulate(self, part: int, grads) -> None:
        acc = self._grads.get(part)
        if acc is None:
            self._grads[part] = list(grads)
        else:
            for a, g in zip(acc, grads):
                a.add_(g)

    # -- schedule ops (called by the resident loop) ----------------------

    def pipe_forward(self, part: int, mb: int, *vals):
        part = int(part)
        if part == self.cfg.pp_stages - 1:
            # Last partition: forward is a stash (activations + targets);
            # loss + grads happen in one pass at backward.
            x, tokens = vals
            self._stash[(part, mb)] = (self._to_device(x),
                                       self._to_device(tokens))
            return None
        x = self._to_device(vals[0])
        with torch.no_grad():
            y = self._fwd(part, x)
        self._stash[(part, mb)] = x
        return self._done(y)

    def pipe_backward(self, part: int, mb: int, *vals):
        from ray_tpu_torch.models.transformer import transformer_stage_loss
        part = int(part)
        leaves = self._leaves(part)
        if part == self.cfg.pp_stages - 1:
            x, tokens = self._stash.pop((part, mb))
            x = x.detach().requires_grad_(True)
            loss = transformer_stage_loss(self._tree(part), x, tokens,
                                          self.cfg, device=self.device)
            *gp, gx = torch.autograd.grad(loss, leaves + [x])
            self._loss_sum += float(loss.detach())
            self._loss_n += 1
            self._accumulate(part, gp)
            return self._done(gx)
        gy = self._to_device(vals[0])
        x = self._stash.pop((part, mb))
        if part == 0:
            y = self._fwd(part, x)
            self._accumulate(part, torch.autograd.grad(y, leaves, gy))
            return self._done()
        x = x.detach().requires_grad_(True)
        y = self._fwd(part, x)
        *gp, gx = torch.autograd.grad(y, leaves + [x], gy)
        self._accumulate(part, gp)
        return self._done(gx)

    def _mean_grads(self, part: int) -> List[torch.Tensor]:
        m = max(1, int(self.cfg.num_microbatches))
        return [g / m for g in self._grads[part]]

    def _metrics(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        if self._loss_n:
            out["loss"] = self._loss_sum / self._loss_n
            self._loss_sum = 0.0
            self._loss_n = 0
        return out

    def _apply(self, part: int, grads) -> None:
        leaves = self._leaves(part)
        with torch.no_grad():
            for p, g in zip(leaves, grads):
                p.grad = g
            self._opt[part].step()
            for p in leaves:
                p.grad = None

    def pipe_apply(self) -> Dict[str, Any]:
        """End-of-step op (single-replica mode): optimizer-apply every
        owned partition on the accumulated microbatch-mean grads."""
        for part in self.owned:
            if part in self._grads:
                self._apply(part, self._mean_grads(part))
        self._grads.clear()
        return self._done(self._metrics())

    def pipe_report(self) -> Dict[str, Any]:
        """End-of-step op (DP-replica mode): keep grads for the driver's
        cross-replica average, report loss only."""
        return self._metrics()

    # -- DP grad exchange (classic task service, between steps) ----------

    def get_grads(self) -> Dict[int, Any]:
        """Each owned partition's microbatch-mean grads as a tree of numpy
        arrays (the partition's tree)."""
        return {part: _unflatten(
                    (path, _host(g)) for (path, _), g in
                    zip(self._params[part], self._mean_grads(part)))
                for part in self.owned if part in self._grads}

    def apply_external(self, avg_grads: Dict[int, Any]) -> None:
        for part, tree in avg_grads.items():
            part = int(part)
            self._apply(part, [self._to_device(g).to(self.cfg.param_dtype)
                               for _, g in _flatten(tree)])
        self._grads.clear()


def _adamw_factory(learning_rate: float, leaves, weight_decay: float = 0.01):
    """optax.adamw(learning_rate, weight_decay=0.01): b1 0.9, b2 0.999, eps
    1e-8 outside the square root (train/step.py)."""
    return torch.optim.AdamW(leaves, lr=learning_rate, betas=(0.9, 0.999),
                             eps=1e-8, weight_decay=weight_decay)


_default_tx_factory = functools.partial(_adamw_factory, 1e-3)


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


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------

class PipelineTrainer:
    """MPMD pipeline-parallel LM trainer: DP replicas of a PP pipeline.

    ``num_stages`` actors each host ``num_chunks`` layer partitions
    (``cfg.pp_stages`` must equal their product; it is set for you when
    left at 1). With ``dp_replicas > 1`` the whole pipeline is cloned;
    each step the driver averages the replicas' microbatch-mean grads
    over classic task RPCs and broadcasts one optimizer apply — the
    schedule then ends in ``pipe_report`` instead of the in-loop
    ``pipe_apply``.

    ``device=None`` trains on the card: the driver draws the weights there
    from ``seed``, and each stage actor leases ``num_gpus_per_stage`` of a
    card (default ``1 / num_stages``, so one pipeline shares one card) and
    runs on it. ``device="cpu"`` runs everything on the host and leases no
    GPU. ``tx_factory(leaves)`` returns a ``torch.optim`` optimizer for a
    partition's parameters; it must be defined at module level (a
    ``functools.partial`` of a module-level function is fine)."""

    def __init__(self, config, *, num_stages: int = 2,
                 num_microbatches: int = 4, schedule: str = "1f1b",
                 num_chunks: int = 1, dp_replicas: int = 1,
                 learning_rate: float = 1e-3,
                 tx_factory: Optional[Callable[[list], Any]] = None,
                 seed: int = 0, num_cpus_per_stage: float = 1.0,
                 num_gpus_per_stage: Optional[float] = None,
                 channel_slots: Optional[int] = None,
                 max_in_flight_steps: Optional[int] = None,
                 device=None):
        self.device = resolve_device(device)
        if num_stages < 2:
            raise ValueError("PipelineTrainer needs num_stages >= 2")
        P = num_stages * num_chunks
        if config.pp_stages == 1:
            config = dataclasses.replace(config, pp_stages=P)
        if config.pp_stages != P:
            raise ValueError(f"cfg.pp_stages={config.pp_stages} != "
                             f"num_stages*num_chunks={P}")
        if config.n_layers % P:
            raise ValueError(f"n_layers={config.n_layers} not divisible "
                             f"by {P} partitions")
        if config.tied_embeddings:
            raise ValueError("MPMD pipeline requires tied_embeddings=False")
        if num_chunks > 1 and schedule != "interleaved_1f1b":
            raise ValueError("num_chunks > 1 requires the "
                             "interleaved_1f1b schedule")
        self.config = dataclasses.replace(
            config, num_microbatches=num_microbatches)
        self.num_stages = num_stages
        self.num_chunks = num_chunks
        self.num_microbatches = num_microbatches
        self.schedule = schedule
        self.dp_replicas = int(dp_replicas)
        self.seed = seed
        self._tx_factory = tx_factory or functools.partial(
            _adamw_factory, learning_rate)
        self._num_cpus = num_cpus_per_stage
        if num_gpus_per_stage is None:
            num_gpus_per_stage = (1.0 / num_stages
                                  if self.device.type == "cuda" else 0.0)
        if self.device.type == "cuda" and num_gpus_per_stage <= 0:
            raise ValueError("a stage on the card needs num_gpus_per_stage "
                             "> 0 (its worker sees no card without a lease)")
        self._num_gpus = float(num_gpus_per_stage)
        self._channel_slots = channel_slots
        self._max_in_flight = max_in_flight_steps
        self._groups: List[List[Any]] = []    # [replica][stage] handles
        self._pipes: List[CompiledPipeline] = []
        self._step = 0
        self.last_metrics: Optional[dict] = None

    # -- lifecycle -------------------------------------------------------

    def _check_fits(self, rt) -> None:
        """Refuse up front what the cluster can never place (stage actors
        would otherwise wait for resources that do not exist)."""
        have = rt.cluster_resources()
        n = self.dp_replicas * self.num_stages
        for key, each in (("CPU", self._num_cpus), ("GPU", self._num_gpus)):
            need = n * each
            if need > have.get(key, 0.0) + 1e-9:
                raise ValueError(
                    f"{self.dp_replicas} replica(s) x {self.num_stages} "
                    f"stages need {need:g} {key} ({each:g} each); the "
                    f"cluster has {have.get(key, 0.0):g}")

    def start(self) -> "PipelineTrainer":
        import ray_tpu_torch as rt
        from ray_tpu_torch.models.transformer import (
            transformer_init, transformer_partition_params)
        if self._pipes:
            return self
        self._check_fits(rt)
        cfg = self.config
        P = cfg.pp_stages
        dev = self.device
        params = transformer_init(
            torch.Generator(device=dev).manual_seed(self.seed), cfg,
            device=dev)
        # Into the store once, by reference to every replica: a partition
        # of a large model exceeds what one task message may carry.
        part_refs = [
            rt.put(_unflatten((k, _host(t)) for k, t in _flatten(
                transformer_partition_params(params, cfg, p))))
            for p in range(P)]
        del params
        if dev.type == "cuda":
            # the driver drew the weights only to ship them
            torch.cuda.empty_cache()
        actor_cls = rt.remote(PipelineStageActor)
        stage_device = "cpu" if dev.type == "cpu" else None
        apply_m = "pipe_apply" if self.dp_replicas == 1 else "pipe_report"
        for _ in range(self.dp_replicas):
            stages = []
            for a in range(self.num_stages):
                owned = list(range(a, P, self.num_stages))
                stages.append(actor_cls.options(
                    num_cpus=self._num_cpus, num_gpus=self._num_gpus).remote(
                        cfg, owned, self._tx_factory, stage_device))
            self._groups.append(stages)
            rt.get([h.load_partition.remote(p, part_refs[p])
                    for a, h in enumerate(stages)
                    for p in range(a, P, self.num_stages)])
            self._pipes.append(CompiledPipeline(
                stages, num_microbatches=self.num_microbatches,
                num_partitions=P, schedule=self.schedule,
                apply_method=apply_m, feed_targets=True,
                channel_slots=self._channel_slots,
                max_in_flight_steps=self._max_in_flight))
        return self

    def shutdown(self) -> None:
        import ray_tpu_torch as rt
        for pipe in self._pipes:
            try:
                pipe.teardown()
            except Exception:
                pass
        for stages in self._groups:
            for h in stages:
                try:
                    rt.kill(h)
                except Exception:
                    pass
        self._pipes = []
        self._groups = []

    # -- training --------------------------------------------------------

    def _split(self, tokens) -> List[List[Any]]:
        tokens = np.asarray(tokens)
        R, m = self.dp_replicas, self.num_microbatches
        if tokens.shape[0] % (R * m):
            raise ValueError(
                f"batch size {tokens.shape[0]} not divisible by "
                f"dp_replicas*num_microbatches = {R * m}")
        shards = np.split(tokens, R, axis=0)
        return [[np.ascontiguousarray(x) for x in np.split(s, m, axis=0)]
                for s in shards]

    def step(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        """One pipelined training step over ``batch["tokens"]`` [B, S]
        (B divisible by dp_replicas * num_microbatches)."""
        if not self._pipes:
            self.start()
        tokens = batch["tokens"]
        if torch.is_tensor(tokens):
            tokens = tokens.cpu().numpy()
        per_replica = self._split(tokens)
        steps = [pipe.submit(mbs, mbs)
                 for pipe, mbs in zip(self._pipes, per_replica)]
        results = [pipe.collect(t)
                   for pipe, t in zip(self._pipes, steps)]
        if self.dp_replicas > 1:
            self._dp_sync()
        losses = [r.get("loss") for r in results if r.get("loss") is not None]
        metrics = {
            "step": self._step,
            "loss": float(sum(losses) / len(losses)) if losses else None,
            "efficiency": results[0].get("efficiency"),
            "bound": results[0].get("bound"),
            "wall_s": results[0].get("wall_s"),
            "busy_s": results[0].get("busy_s"),
            "codec_s": results[0].get("codec_s"),
        }
        self._step += 1
        self.last_metrics = metrics
        return metrics

    def _dp_sync(self) -> None:
        """Average microbatch-mean grads across replicas per stage, then
        broadcast one optimizer apply (classic task RPCs: the resident
        loops are quiescent between the done barrier and the next
        submit)."""
        import ray_tpu_torch as rt
        for a in range(self.num_stages):
            grads = rt.get([g[a].get_grads.remote() for g in self._groups])
            avg: Dict[int, Any] = {}
            for part in grads[0]:
                flat = [_flatten(g[part]) for g in grads]
                avg[part] = _unflatten(
                    (path, np.mean(np.stack([f[i][1] for f in flat]), axis=0))
                    for i, (path, _) in enumerate(flat[0]))
            rt.get([g[a].apply_external.remote(avg) for g in self._groups])

    def train(self, batches: Sequence[Dict[str, Any]]) -> List[dict]:
        self.start()
        return [self.step(b) for b in batches]
