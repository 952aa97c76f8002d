"""Compiled execution graphs: static DAG plans over persistent channels.
Ported from ``ray_tpu/dag/compiled.py``, on the port's cluster runtime.

Role parity: python/ray/dag/compiled_dag_node.py — ``experimental_compile``
walks a bound actor-method graph ONCE, places/reuses the actors, and
installs a resident execution loop on each participating worker. The loop
blocks on the step's input channel(s), runs the bound method on the live
actor instance, and writes the result into its output channel(s): steady-
state execution costs a channel slot write, never a task spec, conductor
op, or owner round trip. ``execute(x)`` writes the input channel and
returns a ``CompiledGraphRef`` (get/wait-compatible); up to
``max_in_flight`` executions pipeline through the rings before the driver
must consume a result.

Failure semantics: a worker exception (or an injected ``cgraph.*`` fault)
is serialized as a TaskError and written downstream as a POISONED slot.
Poison forwards hop by hop, each loop unwinds after forwarding, the
driver's pending get() raises the original error, the graph marks itself
poisoned, and every later execute() raises until ``teardown()`` — which
uninstalls the loops, deletes the channel segments, and returns the
actors to normal ``.remote()`` task service.

Values cross a channel as the port's serialization writes them: a
top-level tensor or array of a numpy dtype as an RTAR blob (FLAG_ARRAY), a
CUDA tensor after its copy to the host, a bf16 tensor by pickle. A value
larger than a slot spills to the store (FLAG_SPILL) once, however many
channels read it. When one channel reads it, its reader deletes the object
once it has read it; an object that several channels read (FLAG_SHARED) is
left to the store's spill to disk, as the JAX package leaves every spilled
value.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Dict, List, Optional

from ray_tpu_torch.core.ids import ObjectID
from ray_tpu_torch.core.refs import ChannelResolvedRef
from ray_tpu_torch.dag.channel import (FLAG_ARRAY, FLAG_POISON, FLAG_SHARED,
                                       FLAG_SPILL, ChannelError, ChannelTimeout,
                                       RpcChannelWriter, ShmChannelReader,
                                       ShmChannelWriter, make_channel_id)
from ray_tpu_torch.dag.nodes import (ClassMethodNode, ClassNode, DAGNode,
                                     FunctionNode, InputNode,
                                     MultiOutputNode)

# Live compiled graphs in this process (teardown deregisters) — the
# conftest teardown-hygiene gate asserts this drains after each test.
_live_graphs: "set[CompiledGraph]" = set()


def _events():
    from ray_tpu_torch.util import events
    return events


def _fault_plane():
    from ray_tpu_torch.cluster import fault_plane
    return fault_plane


# ---------------------------------------------------------------------------
# value <-> slot payload codec (shared by driver and worker loops)
# ---------------------------------------------------------------------------

def _encode_value(value: Any, slot_bytes: int, plane,
                  readers: int = 1) -> tuple:
    """Serialize ``value`` for a channel slot. Array values that fit the
    slot travel as RTAR segment lists (FLAG_ARRAY) — header + raw buffer,
    no pickle, one copy into the ring. Oversized payloads spill to the
    object store and ride the slot as a 20-byte ObjectID marker; with more
    than one of ``readers`` the object is marked FLAG_SHARED."""
    from ray_tpu_torch.core import serialization
    total, segments, refs = serialization.serialize_segments(value)
    if total <= slot_bytes:
        if serialization.is_array_blob(segments[0]):
            return segments, FLAG_ARRAY
        if len(segments) == 1:
            return segments[0], 0
        return segments, 0
    oid = ObjectID.from_random()
    plane.put_segments(oid, total, segments, refs)
    return oid.binary(), FLAG_SPILL | (FLAG_SHARED if readers > 1 else 0)


def _decode_value(blob, flags: int, plane, timeout: float = 30.0) -> Any:
    from ray_tpu_torch.core import serialization
    if flags & FLAG_SPILL:
        oid = ObjectID(bytes(blob))
        value = plane.get_value(oid, timeout=timeout)
        if not flags & FLAG_SHARED:
            # This reader is the object's only one. The store defers the
            # delete while a zero-copy view of it is alive.
            try:
                plane.store.delete(plane._key(oid))
            except Exception:
                pass
        return value
    # FLAG_ARRAY needs no special casing: deserialize dispatches on the
    # RTAR magic and rebuilds the ndarray straight from the blob bytes
    # (the slot copy-out already happened in ring.read — see channel.py).
    return serialization.deserialize(memoryview(blob))


def _encode_error(err) -> bytes:
    from ray_tpu_torch.core import serialization
    return serialization.serialize(err)[0]


def _write_slot(writer, seq: int, blob, flags: int,
                timeout: Optional[float], stop=None, role: str = "") -> None:
    """One channel write, instrumented: fires the ``cgraph.channel.write``
    fault site (honoring "sever" — the cross-host pipe is killed so the
    write and everything behind it fails fast) and emits the
    ``cgraph.slot.write`` flight-recorder event."""
    act = _fault_plane().fire("cgraph.channel.write",
                              channel=writer.chan_id.hex(), seq=seq,
                              role=role)
    if act == "sever":
        # Kill the transport (every pipelined in-flight write on the same
        # socket fails fast too), then fail THIS write deterministically —
        # racing the reconnect would let the triggering write slip through.
        if isinstance(writer, RpcChannelWriter):
            writer.sever()
        raise ChannelError(
            f"channel {writer.chan_id.hex()[:8]} severed (fault injection)")
    t0 = time.perf_counter()
    writer.write(seq, blob, flags, timeout=timeout, stop=stop)
    nbytes = (sum(memoryview(b).nbytes for b in blob)
              if isinstance(blob, (list, tuple))
              else memoryview(blob).nbytes)
    _events().emit("cgraph.slot.write", writer.chan_id.hex()[:16],
                   value=time.perf_counter() - t0,
                   attrs={"bytes": nbytes})


def _read_slot(reader, seq: int, timeout: Optional[float],
               stop=None) -> tuple:
    t0 = time.perf_counter()
    blob, flags = reader.read(seq, timeout=timeout, stop=stop)
    _events().emit("cgraph.slot.wait", reader.chan_id.hex()[:16],
                   value=time.perf_counter() - t0)
    return blob, flags


# ---------------------------------------------------------------------------
# driver side
# ---------------------------------------------------------------------------

class CompiledGraphRef(ChannelResolvedRef):
    """Handle to one compiled execution's result. get()/wait() compatible
    (core/api.py dispatches through _resolve/_is_ready). Results are
    consumed destructively: a second get() of the same ref raises."""

    __slots__ = ("_graph", "_seq")

    def __init__(self, graph: "CompiledGraph", seq: int):
        ChannelResolvedRef.__init__(self, ObjectID(
            b"CGRF" + graph._nonce + seq.to_bytes(8, "little")))
        self._graph = graph
        self._seq = seq

    def _resolve(self, timeout: Optional[float] = None):
        return self._graph._get_result(self._seq, timeout)

    def _is_ready(self) -> bool:
        return self._graph._probe(self._seq)

    def get(self, timeout: Optional[float] = None):
        return self._resolve(timeout)

    def __repr__(self):
        return (f"CompiledGraphRef(graph={self._graph._gid.hex()[:8]}, "
                f"seq={self._seq})")


class _ActorPlan:
    """Per-actor slice of the compiled plan (one resident loop each)."""

    def __init__(self, actor_id: bytes):
        self.actor_id = actor_id
        self.handle = None
        self.address = ""          # worker RPC address
        self.node_id = b""
        self.steps: List[dict] = []
        self.in_channels: List[dict] = []
        self.node_to_step: Dict[int, int] = {}    # id(node) -> step idx
        self.chan_index: Dict[bytes, int] = {}    # chan id -> in_channels idx


class CompiledGraph:
    """A compiled static plan. Build via dag.experimental_compile()."""

    def __init__(self, root: DAGNode, max_in_flight: int = 8,
                 submit_timeout: float = 60.0):
        if max_in_flight < 1:
            raise ValueError("max_in_flight must be >= 1")
        from ray_tpu_torch import config
        from ray_tpu_torch.core.api import _global_runtime
        rt = _global_runtime()
        if not hasattr(rt, "_actor_resolver"):
            raise RuntimeError(
                "experimental_compile requires cluster mode (resident "
                "loops live on actor workers; local mode has none)")
        self._rt = rt
        self._gid = os.urandom(16)
        self._nonce = os.urandom(8)
        self.max_in_flight = int(max_in_flight)
        self._submit_timeout = float(submit_timeout)
        self._slot_bytes = int(config.get("cgraph_slot_bytes"))
        # RLock: pump failures surface while the cv is held (execute's
        # window wait, _get_result, _probe) and re-enter via _poison().
        self._lock = threading.RLock()
        self._cv = threading.Condition(self._lock)
        self._next_seq = 0
        self._read_seq = 0
        self._inflight = 0
        self._results: Dict[int, Any] = {}
        self._retrieved: set = set()
        self._poison_error: Optional[BaseException] = None
        self._torn_down = False
        self._installed: List[_ActorPlan] = []
        self._out_readers: List[tuple] = []      # (reader, leaf list-index)
        self._input_writers: List = []
        self._input_descs: List[dict] = []
        self._multi_output = isinstance(root, MultiOutputNode)
        try:
            self._compile(root)
        except BaseException:  # noqa: BLE001 - cleanup then re-raise
            self._cleanup(best_effort=True)
            raise
        _live_graphs.add(self)

    # -- compilation -----------------------------------------------------

    def _compile(self, root: DAGNode) -> None:
        leaves = (list(root._bound_args) if self._multi_output else [root])
        for leaf in leaves:
            if not isinstance(leaf, ClassMethodNode):
                raise TypeError(
                    "compiled graphs require ClassMethodNode leaves "
                    f"(actor method chains), got {type(leaf).__name__}")

        # Walk: collect method nodes (topo order), the input node, and the
        # participating class nodes.
        topo: List[ClassMethodNode] = []
        seen: set = set()
        input_nodes: set = set()

        def visit(n: DAGNode):
            if id(n) in seen:
                return
            seen.add(id(n))
            if isinstance(n, FunctionNode):
                raise TypeError(
                    "compiled graphs support actor method nodes only; "
                    "FunctionNode tasks have no resident worker to host a "
                    "loop (use the classic dag.execute() path)")
            if isinstance(n, InputNode):
                input_nodes.add(n)
                return
            for c in n._children():
                visit(c)
            if isinstance(n, ClassMethodNode):
                topo.append(n)

        for leaf in leaves:
            visit(leaf)
        if len(input_nodes) > 1:
            raise ValueError("compiled graphs accept at most one InputNode")
        if not input_nodes:
            raise ValueError(
                "compiled graphs require an InputNode: execute() paces the "
                "resident loops through the input channel")

        # Place/reuse actors: ClassNode construction memoizes on the node,
        # so an already-bound actor is reused, a fresh one is created now.
        actor_memo: Dict[int, Any] = {}
        plans: Dict[bytes, _ActorPlan] = {}
        node_actor: Dict[int, bytes] = {}
        for m in topo:
            handle = m._class_node._execute_memo(actor_memo, None)
            aid = handle._rt_actor_id.binary()
            node_actor[id(m)] = aid
            plan = plans.get(aid)
            if plan is None:
                plan = plans[aid] = _ActorPlan(aid)
                plan.handle = handle
        if not plans:
            raise ValueError("compiled graph has no actor method nodes")

        # Resolve placements (worker address + node) for every actor.
        daemons = {n["node_id"]: n["address"]
                   for n in self._rt.conductor.call("get_nodes")}
        for plan in plans.values():
            info = self._rt._actor_resolver.resolve(
                plan.actor_id, timeout=self._submit_timeout) or {}
            if info.get("state") != "ALIVE":
                raise RuntimeError(
                    f"actor {plan.actor_id.hex()} not ALIVE at compile "
                    f"time (state={info.get('state')!r})")
            plan.address = info["address"]
            plan.node_id = info["node_id"]
            if plan.node_id not in daemons:
                raise RuntimeError(
                    f"no daemon known for node {plan.node_id.hex()}")

        def chan_desc(chan_id: bytes, reader_node: bytes,
                      reader_daemon: str) -> dict:
            return {"id": chan_id, "node_id": reader_node,
                    "daemon": reader_daemon, "nslots": self.max_in_flight,
                    "slot_bytes": self._slot_bytes}

        # Wire edges. Channels are owned by their consumer: actor-read
        # rings are created by the worker at loop install; driver-read
        # (leaf) rings are created here, before any loop starts.
        def consumer_chan(plan: _ActorPlan, key: bytes,
                          desc_factory) -> int:
            """Dedup: one ring per (producer, consumer-actor) edge even if
            several steps of the actor consume the same value."""
            idx = plan.chan_index.get(key)
            if idx is None:
                desc = desc_factory()
                idx = len(plan.in_channels)
                plan.in_channels.append(desc)
                plan.chan_index[key] = idx
            return idx

        daemon_of = lambda nid: daemons[nid]

        for m in topo:
            aid = node_actor[id(m)]
            plan = plans[aid]

            def argspec(v):
                if isinstance(v, InputNode):
                    idx = consumer_chan(
                        plan, b"__input__", lambda: chan_desc(
                            make_channel_id(), plan.node_id,
                            daemon_of(plan.node_id)))
                    return ["chan", idx]
                if isinstance(v, ClassMethodNode):
                    src_aid = node_actor[id(v)]
                    if src_aid == aid:
                        return ["local", plan.node_to_step[id(v)]]
                    idx = consumer_chan(
                        plan, id(v).to_bytes(8, "little") + b"__dep__",
                        lambda: chan_desc(make_channel_id(), plan.node_id,
                                          daemon_of(plan.node_id)))
                    # Remember the producer's write target.
                    src_plan = plans[src_aid]
                    step = src_plan.steps[src_plan.node_to_step[id(v)]]
                    desc = plan.in_channels[idx]
                    if desc["id"] not in [d["id"] for d in step["outs"]]:
                        step["outs"].append(desc)
                    return ["chan", idx]
                if isinstance(v, ClassNode):
                    h = v._execute_memo(actor_memo, None)
                    from ray_tpu_torch.core import serialization
                    return ["const", serialization.dumps(h)]
                if isinstance(v, DAGNode):
                    raise TypeError(
                        f"unsupported node type in compiled graph: "
                        f"{type(v).__name__}")
                from ray_tpu_torch.core import serialization
                return ["const", serialization.dumps(v)]

            step = {"method": m._method,
                    "args": [argspec(a) for a in m._bound_args],
                    "kwargs": {k: argspec(v)
                               for k, v in m._bound_kwargs.items()},
                    "outs": []}
            plan.node_to_step[id(m)] = len(plan.steps)
            plan.steps.append(step)

        # Driver-read leaf channels (one per UNIQUE leaf node; a node
        # listed twice in a MultiOutputNode shares its ring).
        leaf_chan: Dict[int, dict] = {}
        self._leaf_slots: List[int] = []   # output position -> reader idx
        for leaf in leaves:
            if id(leaf) not in leaf_chan:
                desc = chan_desc(make_channel_id(), self._rt.node_id,
                                 self._rt.daemon_address)
                leaf_chan[id(leaf)] = desc
                aid = node_actor[id(leaf)]
                lp = plans[aid]
                lp.steps[lp.node_to_step[id(leaf)]]["outs"].append(desc)
                reader = ShmChannelReader(self._rt.store, desc["id"],
                                          self.max_in_flight,
                                          self._slot_bytes)
                self._out_readers.append((reader, desc))
                leaf_chan[id(leaf)]["_reader_idx"] = \
                    len(self._out_readers) - 1
            self._leaf_slots.append(leaf_chan[id(leaf)]["_reader_idx"])
        for d in leaf_chan.values():
            d.pop("_reader_idx", None)

        # Install the resident loops (this creates each actor's read
        # rings), then attach the driver's input writers.
        from ray_tpu_torch.cluster.protocol import get_client
        for plan in plans.values():
            resp = get_client(plan.address).call(
                "install_cgraph_loop", graph_id=self._gid,
                plan={"steps": plan.steps,
                      "in_channels": plan.in_channels,
                      "nslots": self.max_in_flight,
                      "slot_bytes": self._slot_bytes},
                _timeout=self._submit_timeout)
            if not resp or not resp.get("ok"):
                raise RuntimeError(
                    f"loop install failed on actor "
                    f"{plan.actor_id.hex()}: {resp!r}")
            self._installed.append(plan)

        for plan in plans.values():
            idx = plan.chan_index.get(b"__input__")
            if idx is None:
                continue
            desc = plan.in_channels[idx]
            self._input_descs.append(desc)
            if desc["node_id"] == self._rt.node_id:
                self._input_writers.append(
                    ShmChannelWriter(self._rt.store, desc["id"]))
            else:
                self._input_writers.append(
                    RpcChannelWriter(desc["id"], desc["daemon"]))

    # -- execution -------------------------------------------------------

    def _check_alive_locked(self) -> None:
        if self._torn_down:
            raise RuntimeError("compiled graph was torn down")
        if self._poison_error is not None:
            raise RuntimeError(
                "compiled graph is poisoned by a prior failure "
                f"({self._poison_error!r}); teardown() and recompile")

    def execute(self, input_value: Any = None,
                timeout: Optional[float] = None) -> CompiledGraphRef:
        """Submit one execution; returns a get/wait-compatible ref. Blocks
        (up to ``timeout``) while ``max_in_flight`` executions are already
        outstanding."""
        from ray_tpu_torch import config
        from ray_tpu_torch.core.exceptions import GetTimeoutError
        if timeout is None:
            timeout = config.get("cgraph_submit_timeout_s")
        deadline = time.monotonic() + timeout
        with self._cv:
            self._check_alive_locked()
            while self._inflight >= self.max_in_flight:
                # Drain any leaf results already sitting in the rings —
                # a pipelined caller that executes faster than it gets
                # should not stall while completed slots are waiting.
                try:
                    self._pump_locked(until_seq=None, deadline=None)
                except BaseException as e:  # noqa: BLE001 - poison the graph then re-raise
                    self._poison(e)
                    raise
                if self._inflight < self.max_in_flight:
                    break
                left = deadline - time.monotonic()
                if left <= 0:
                    raise GetTimeoutError(
                        f"execute() timed out: {self.max_in_flight} "
                        "executions already in flight (get() results to "
                        "free slots)")
                self._cv.wait(min(left, 0.05))
                self._check_alive_locked()
            seq = self._next_seq
            self._next_seq += 1
            self._inflight += 1
        try:
            blob, flags = _encode_value(input_value, self._slot_bytes,
                                        self._rt.plane,
                                        readers=len(self._input_writers))
            for w in self._input_writers:
                _write_slot(w, seq, blob, flags,
                            timeout=max(0.05, deadline - time.monotonic()),
                            role="driver")
        except BaseException as e:  # noqa: BLE001 - poison the graph then re-raise
            self._poison(e)
            raise
        _events().emit("cgraph.execute", self._gid.hex()[:16],
                       value=float(seq))
        return CompiledGraphRef(self, seq)

    def _poison(self, err: BaseException) -> None:
        with self._cv:
            if self._poison_error is None:
                self._poison_error = err
            self._cv.notify_all()

    def _pump_locked(self, until_seq: Optional[int],
                     deadline: Optional[float]) -> None:
        """Advance _read_seq by draining the leaf rings in order. With
        ``until_seq=None`` only consumes executions that are fully ready
        (non-blocking); otherwise blocks (to ``deadline``) until
        ``until_seq`` has been read."""
        while self._read_seq < self._next_seq:
            seq = self._read_seq
            if until_seq is None or seq > until_seq:
                if not all(r.ready(seq) for r, _d in self._out_readers):
                    return
            vals = []
            poison = None
            for r, _d in self._out_readers:
                left = (None if deadline is None
                        else max(0.0, deadline - time.monotonic()))
                blob, flags = _read_slot(r, seq, left)
                if flags & FLAG_POISON:
                    poison = _decode_value(blob, flags & ~FLAG_POISON,
                                           self._rt.plane)
                    vals.append(poison)
                else:
                    vals.append(_decode_value(blob, flags, self._rt.plane))
            self._results[seq] = vals
            self._read_seq += 1
            self._inflight -= 1
            self._cv.notify_all()
            if poison is not None:
                raise poison if isinstance(poison, BaseException) \
                    else RuntimeError(str(poison))
            if until_seq is not None and self._read_seq > until_seq:
                return

    def _get_result(self, seq: int, timeout: Optional[float]):
        from ray_tpu_torch.core.exceptions import GetTimeoutError
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        with self._cv:
            if seq in self._retrieved and seq not in self._results:
                raise ValueError(
                    f"compiled-graph result {seq} was already retrieved "
                    "(channel results are consumed destructively)")
            if seq not in self._results:
                if self._torn_down:
                    raise RuntimeError("compiled graph was torn down")
                if self._poison_error is not None:
                    raise self._wrap_poison()
                try:
                    self._pump_locked(until_seq=seq, deadline=deadline)
                except ChannelTimeout:
                    raise GetTimeoutError(
                        f"compiled-graph result {seq} not ready within "
                        f"{timeout}s") from None
                except BaseException as e:  # noqa: BLE001 - poison the graph then re-raise
                    self._poison(e)
                    raise
            vals = self._results.pop(seq)
            self._retrieved.add(seq)
        # vals is indexed by leaf READER; _leaf_slots maps each output
        # position back to its reader (duplicated leaves share a ring).
        if self._multi_output:
            return [self._materialize(vals[i]) for i in self._leaf_slots]
        return self._materialize(vals[self._leaf_slots[0]])

    def _materialize(self, v):
        if isinstance(v, BaseException):
            raise v
        return v

    def _wrap_poison(self) -> BaseException:
        err = self._poison_error
        if isinstance(err, BaseException):
            return err
        return RuntimeError(f"compiled graph poisoned: {err!r}")

    def _probe(self, seq: int) -> bool:
        with self._cv:
            if seq in self._results or seq in self._retrieved:
                return True
            if self._poison_error is not None or self._torn_down:
                return True   # "ready" in the sense that get() won't block
            try:
                self._pump_locked(until_seq=None, deadline=None)
            except BaseException as e:  # noqa: BLE001 - poison the graph; get() surfaces it
                self._poison(e)
                return True
            return seq in self._results

    # -- teardown --------------------------------------------------------

    def teardown(self) -> None:
        """Uninstall the resident loops, delete every channel segment, and
        return the actors to normal task service. Idempotent."""
        with self._cv:
            if self._torn_down:
                return
            self._torn_down = True
            self._cv.notify_all()
        self._cleanup(best_effort=True)
        _live_graphs.discard(self)

    def _cleanup(self, best_effort: bool = False) -> None:
        from ray_tpu_torch.cluster.protocol import get_client
        for plan in self._installed:
            try:
                get_client(plan.address).call(
                    "teardown_cgraph_loop", graph_id=self._gid,
                    _timeout=20.0)
            except Exception:
                if not best_effort:
                    raise
        for w in self._input_writers:
            try:
                w.close()
            except Exception:
                pass
        for r, _d in self._out_readers:
            try:
                r.close()
            except Exception:
                pass
        self._installed = []
        self._input_writers = []
        self._out_readers = []

    def __repr__(self):
        return (f"CompiledGraph({self._gid.hex()[:8]}, "
                f"actors={len(self._installed)}, "
                f"max_in_flight={self.max_in_flight})")


def compile_dag(root: DAGNode, max_in_flight: int = 8,
                submit_timeout: float = 60.0) -> CompiledGraph:
    return CompiledGraph(root, max_in_flight=max_in_flight,
                         submit_timeout=submit_timeout)


def compile_actor_method(handle, method: str, const_args: tuple = (),
                         max_in_flight: int = 8) -> CompiledGraph:
    """Compile a single bound method of an EXISTING actor into a one-step
    plan (serve's replica fast path): the resident loop calls
    ``actor.<method>(*const_args, x)`` with x fed by execute(x)."""
    cn = ClassNode(None, (), {})
    cn._actor_handle = handle
    node = ClassMethodNode(cn, method, (*const_args, InputNode()), {})
    return compile_dag(node, max_in_flight=max_in_flight)


# ---------------------------------------------------------------------------
# worker side: the resident execution loops
# ---------------------------------------------------------------------------

class _WorkerLoopBase:
    """Channel plumbing shared by the resident loops: owns the actor's
    input rings (consumer-side creation at install), lazily attaches
    output writers (same-host shm or cross-host daemon forwarder), and
    dispatches method calls onto the live actor instance."""

    def __init__(self, svc, graph_id: bytes, plan: dict):
        self.svc = svc
        self.graph_id = graph_id
        self.plan = plan
        self.stop_ev = threading.Event()
        self.dead = False            # loop unwound (poison/crash)
        self.seq = 0
        self._readers = [
            ShmChannelReader(svc.store, d["id"], d["nslots"],
                             d["slot_bytes"])
            for d in plan["in_channels"]]
        self._writers: Dict[bytes, Any] = {}
        self.thread = threading.Thread(
            target=self._run, daemon=True,
            name=f"cgraph-loop-{graph_id.hex()[:8]}")

    def start(self) -> None:
        self.thread.start()

    def _run(self) -> None:   # pragma: no cover — subclass responsibility
        raise NotImplementedError

    def _writer_for(self, desc: dict):
        w = self._writers.get(desc["id"])
        if w is None:
            if desc["node_id"] == self.svc.node_id:
                w = ShmChannelWriter(self.svc.store, desc["id"])
            else:
                w = RpcChannelWriter(desc["id"], desc["daemon"])
            self._writers[desc["id"]] = w
        return w

    def _write_out(self, desc: dict, seq: int, blob, flags: int) -> None:
        from ray_tpu_torch import config
        _write_slot(self._writer_for(desc), seq, blob, flags,
                    timeout=config.get("cgraph_write_timeout_s"),
                    stop=self.stop_ev, role="worker")

    def _call_method(self, method: str, args, kwargs):
        import inspect
        result = getattr(self.svc.actor_instance, method)(*args, **kwargs)
        if inspect.isawaitable(result):
            import asyncio
            if self.svc.actor_loop is not None:
                result = asyncio.run_coroutine_threadsafe(
                    result, self.svc.actor_loop).result()
            else:
                loop = asyncio.new_event_loop()
                try:
                    result = loop.run_until_complete(result)
                finally:
                    loop.close()
        return result

    # -- teardown --------------------------------------------------------

    def stop(self, join_timeout: float = 5.0) -> None:
        self.stop_ev.set()
        if self.thread.is_alive():
            self.thread.join(join_timeout)
        for r in self._readers:
            try:
                r.close()
            except Exception:
                pass
        for w in self._writers.values():
            try:
                w.close()
            except Exception:
                pass
        self._readers = []
        self._writers = {}


class CGraphWorkerLoop(_WorkerLoopBase):
    """Resident loop hosted on an actor worker (installed via the
    ``install_cgraph_loop`` RPC): runs the actor's compiled DAG steps once
    per execution sequence number."""

    def __init__(self, svc, graph_id: bytes, plan: dict):
        super().__init__(svc, graph_id, plan)
        # Pre-decode the constant args once (not per execution).
        self._steps = []
        for st in plan["steps"]:
            self._steps.append({
                "method": st["method"],
                "args": [self._prep(spec) for spec in st["args"]],
                "kwargs": {k: self._prep(v)
                           for k, v in st["kwargs"].items()},
                "outs": st["outs"],
            })

    @staticmethod
    def _prep(spec):
        if spec[0] == "const":
            from ray_tpu_torch.core import serialization
            return ("const", serialization.loads(spec[1]))
        return tuple(spec)

    def _poison_outs(self, seq: int, blob: bytes) -> None:
        """Every downstream ring gets the poison for this seq (rings stay
        aligned; consumers unwind in turn)."""
        for st in self._steps:
            for desc in st["outs"]:
                try:
                    self._write_out(desc, seq, blob, FLAG_POISON)
                except Exception:
                    pass   # downstream gone too; driver times out instead

    # -- the loop --------------------------------------------------------

    def _run(self) -> None:
        from ray_tpu_torch.core.exceptions import TaskError
        while not self.stop_ev.is_set():
            seq = self.seq
            try:
                # Fault point: resident-loop death. A "crash" rule here
                # kills the worker mid-graph (the driver's get() deadline
                # is then the only unwind path); "raise" poisons cleanly.
                _fault_plane().fire("cgraph.loop.crash",
                                    graph=self.graph_id.hex(), seq=seq)
                chan_vals: List[Any] = []
                poison_blob = None
                for r in self._readers:
                    blob, flags = _read_slot(r, seq, None,
                                             stop=self.stop_ev)
                    if flags & FLAG_POISON:
                        poison_blob = blob
                        chan_vals.append(None)
                    else:
                        chan_vals.append(_decode_value(
                            blob, flags, self.svc.plane))
                if poison_blob is not None:
                    # Forward upstream poison and unwind.
                    self._poison_outs(seq, poison_blob)
                    self.dead = True
                    return
                local: List[Any] = []
                for st in self._steps:
                    args = [self._arg(spec, chan_vals, local)
                            for spec in st["args"]]
                    kwargs = {k: self._arg(v, chan_vals, local)
                              for k, v in st["kwargs"].items()}
                    result = self._call_method(st["method"], args, kwargs)
                    local.append(result)
                    if st["outs"]:
                        blob, flags = _encode_value(
                            result, self.plan["slot_bytes"], self.svc.plane,
                            readers=len(st["outs"]))
                    for desc in st["outs"]:
                        self._write_out(desc, seq, blob, flags)
                self.seq = seq + 1
            except ChannelError:
                if self.stop_ev.is_set():
                    return
                # A ring disappeared or a write severed: nothing left to
                # forward on — unwind. The driver observes via its own
                # deadline (and the fault-plane event trail).
                self.dead = True
                return
            except BaseException as e:   # noqa: BLE001 — delivered as poison
                if self.stop_ev.is_set():
                    return
                err = e if isinstance(e, TaskError) else \
                    TaskError.from_exception(
                        e, f"{self.svc.actor_class_name} [compiled graph]")
                try:
                    self._poison_outs(seq, _encode_error(err))
                except Exception:
                    pass
                self.dead = True
                return

    @staticmethod
    def _arg(spec, chan_vals, local):
        kind = spec[0]
        if kind == "const":
            return spec[1]
        if kind == "chan":
            return chan_vals[spec[1]]
        if kind == "local":
            return local[spec[1]]
        raise ValueError(f"bad argspec {spec!r}")

    def debug_state(self) -> dict:
        return {"graph_id": self.graph_id.hex(), "seq": self.seq,
                "dead": self.dead, "steps": len(self._steps),
                "in_channels": len(self.plan.get("in_channels", ())),
                "alive": self.thread.is_alive()}


class ScheduledWorkerLoop(_WorkerLoopBase):
    """Schedule-mode resident loop (``plan["mode"] == "schedule"``): runs
    a static per-actor pipeline program (dag/schedule.py) once per
    TRAINING STEP instead of one DAG pass per execution seq.

    Channel slot sequences follow ``seq = step * stride + offset``
    (stride = num_microbatches, offset = the microbatch index for
    activation/gradient channels; stride 1 for the per-step done/metrics
    channel), so a ring carries a step's whole microbatch stream in order
    while neighbor stages overlap compute with transfer. Because the
    schedule keeps per-channel read order equal to write order, writes
    are DENSE per channel — the running write count is always the next
    seq, which is where poison must land to reach a blocked (or future)
    reader on failure."""

    def __init__(self, svc, graph_id: bytes, plan: dict):
        super().__init__(svc, graph_id, plan)
        self._ops: List[dict] = plan["ops"]
        self._wcount: Dict[bytes, int] = {}        # chan id -> writes done
        self._out_descs: Dict[bytes, dict] = {}
        for op in self._ops:
            for desc, _stride, _off in op["writes"]:
                self._out_descs.setdefault(desc["id"], desc)

    def _write_seq_out(self, desc: dict, seq: int, blob, flags: int) -> None:
        self._write_out(desc, seq, blob, flags)
        self._wcount[desc["id"]] = seq + 1

    def _poison_all(self, blob) -> None:
        """Write POISON at every out channel's next-unwritten seq. Unlike
        the DAG loop there is no single aligned seq: each channel advanced
        a different distance into the step. Short per-write timeout: a
        ring that is FULL has a live, catching-up reader (it will meet
        the poison later or hit the driver deadline); a dead reader's
        ring never drains."""
        blob = bytes(blob)
        for desc in self._out_descs.values():
            try:
                w = self._writer_for(desc)
                _write_slot(w, self._wcount.get(desc["id"], 0), blob,
                            FLAG_POISON, timeout=2.0, stop=None,
                            role="worker")
            except Exception:
                pass

    # -- the loop --------------------------------------------------------

    def _run(self) -> None:
        from ray_tpu_torch.core.exceptions import TaskError
        while not self.stop_ev.is_set():
            step = self.seq
            # busy: inside the stage's methods; codec: encoding and decoding
            # channel values (copies to and from the host, pickling, spills
            # through the store), the transport's share of the step
            busy_s = codec_s = 0.0
            try:
                for opi, op in enumerate(self._ops):
                    # Same fault point as the DAG loop: "crash" kills the
                    # stage worker mid-schedule, "raise" poisons cleanly.
                    _fault_plane().fire("cgraph.loop.crash",
                                        graph=self.graph_id.hex(),
                                        seq=step, op=opi,
                                        stage=self.plan.get("stage"))
                    vals: List[Any] = []
                    poison_blob = None
                    for ci, rstride, roff in op["reads"]:
                        blob, flags = _read_slot(
                            self._readers[ci], step * rstride + roff,
                            None, stop=self.stop_ev)
                        t1 = time.perf_counter()
                        if flags & FLAG_POISON:
                            poison_blob = blob
                            break
                        vals.append(_decode_value(blob, flags,
                                                  self.svc.plane))
                        codec_s += time.perf_counter() - t1
                    if poison_blob is not None:
                        self._poison_all(poison_blob)
                        self.dead = True
                        return
                    t0 = time.perf_counter()
                    result = self._call_method(
                        op["method"], [*op.get("const", ()), *vals], {})
                    dur = time.perf_counter() - t0
                    busy_s += dur
                    ev = op.get("ev")
                    if ev is not None:
                        _events().emit("pipeline.stage.op",
                                       self.graph_id.hex()[:16], value=dur,
                                       attrs={**ev, "step": step})
                    if op.get("done"):
                        # The per-step barrier payload carries the stage's
                        # measured busy time (the driver derives pipeline
                        # efficiency from it against the bubble bound).
                        merged = dict(result) if isinstance(result, dict) \
                            else {}
                        merged["busy_s"] = busy_s
                        merged["codec_s"] = codec_s
                        merged["stage"] = self.plan.get("stage")
                        result = merged
                    t1 = time.perf_counter()
                    if op["writes"]:
                        blob, flags = _encode_value(
                            result, self.plan["slot_bytes"], self.svc.plane,
                            readers=len(op["writes"]))
                    codec_s += time.perf_counter() - t1
                    for desc, wstride, woff in op["writes"]:
                        self._write_seq_out(desc, step * wstride + woff,
                                            blob, flags)
                self.seq = step + 1
            except ChannelError as e:
                if self.stop_ev.is_set():
                    return
                # Unlike the DAG loop, downstream stages and the driver
                # are generally still reachable — poison them so the
                # pipeline fails fast instead of by step deadline.
                err = TaskError.from_exception(
                    e, f"{self.svc.actor_class_name} [pipeline stage]")
                self._poison_all(_encode_error(err))
                self.dead = True
                return
            except BaseException as e:   # noqa: BLE001 — delivered as poison
                if self.stop_ev.is_set():
                    return
                err = e if isinstance(e, TaskError) else \
                    TaskError.from_exception(
                        e, f"{self.svc.actor_class_name} [pipeline stage]")
                self._poison_all(_encode_error(err))
                self.dead = True
                return

    def debug_state(self) -> dict:
        return {"graph_id": self.graph_id.hex(), "mode": "schedule",
                "step": self.seq, "ops": len(self._ops),
                "stage": self.plan.get("stage"), "dead": self.dead,
                "in_channels": len(self.plan.get("in_channels", ())),
                "alive": self.thread.is_alive()}
