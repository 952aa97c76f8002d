"""Streaming operator executor: the operator-graph engine behind Dataset.
Ported from ``ray_tpu/data/streaming.py``.

Role parity: python/ray/data/_internal/execution/streaming_executor.py:45
(and interfaces/op_runtime.py): each operator owns an input queue, a bounded
set of in-flight tasks, and an output buffer; a driver loop moves completed
blocks downstream and submits new work subject to BACKPRESSURE (an operator
stops submitting while its downstream buffer is full). Every operator
runs concurrently: blocks complete out of order via wait() and flow as soon
as they're ready, so a slow map in the middle doesn't idle the rest of the
pipeline.

The pump polls ``wait(timeout=0)`` from its own thread, on either port
runtime: the in-process one (tasks on its thread pool) or the cluster one.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Any, Callable, Iterator, List, Optional

_DEFAULT_INFLIGHT = 8      # per-operator concurrent tasks
_DEFAULT_BUFFER = 16       # per-operator output buffer (backpressure bound)


class PhysicalOp:
    """Base physical operator: consumes input refs, produces output refs."""

    name = "op"

    def __init__(self):
        from ray_tpu_torch.data.stats import OpStats
        self.inq: deque = deque()
        self.outq: deque = deque()
        self.inflight: dict = {}          # ref -> list-of-downstream refs
        self.input_done = False
        self.finished = False
        self.stats = OpStats(self.name)
        # blocks this op emitted that its consumer has not taken yet: the
        # executor points the last op at its consumer's queue, so that a
        # consumer that stops pulling stops the plan
        self.held_downstream: Callable[[], int] = lambda: 0

    # -- hooks ------------------------------------------------------------
    def poke(self, executor: "StreamingExecutor") -> None:
        """Submit new work / finalize, respecting backpressure."""
        raise NotImplementedError

    def on_task_done(self, ref) -> List[Any]:
        """A submitted task's output ref became ready; return refs to emit."""
        self.inflight.pop(ref, None)
        return [ref]

    def backpressured(self) -> bool:
        return len(self.outq) + self.held_downstream() >= _DEFAULT_BUFFER

    def idle(self) -> bool:
        return not self.inq and not self.inflight

    def waitable_refs(self) -> List[Any]:
        return list(self.inflight.keys())


class MapOp(PhysicalOp):
    """One task per block (map_batches/map/filter/flat_map).

    Tasks COMPLETE out of order (that's the pipelining), but outputs EMIT
    in input order: consumers like take()/iter_rows see deterministic row
    order while upstream/downstream operators still overlap."""

    def __init__(self, task_fn, *args, name: str = "map"):
        super().__init__()
        self.task_fn = task_fn
        self.args = args
        self.name = name
        self.stats.name = name
        self._seq_in = 0
        self._next_out = 0
        self._ready: dict = {}      # seq -> output ref

    def backpressured(self) -> bool:
        # blocks done out of order wait in _ready for an earlier one: they
        # count, or a slow first block lets the op run the whole plan
        return (len(self.outq) + len(self._ready) + self.held_downstream()
                >= _DEFAULT_BUFFER)

    def poke(self, executor) -> None:
        while (self.inq and len(self.inflight) < _DEFAULT_INFLIGHT and
               not self.backpressured()):
            ref = self.inq.popleft()
            t0 = self.stats.on_submit()
            out = executor.submit(self.task_fn, ref, *self.args)
            self.inflight[out] = (self._seq_in, t0)
            self._seq_in += 1
        if self.input_done and self.idle() and not self._ready:
            self.finished = True

    def on_task_done(self, ref) -> List[Any]:
        seq, t0 = self.inflight.pop(ref)
        self.stats.on_done(t0)
        self._ready[seq] = ref
        out = []
        while self._next_out in self._ready:
            out.append(self._ready.pop(self._next_out))
            self._next_out += 1
        return out


class AllToAllOp(PhysicalOp):
    """Barrier operator (shuffle/sort/repartition): buffers every input,
    then runs its planning fn once. Its own subtasks still overlap — the
    fn returns refs that complete asynchronously."""

    def __init__(self, fn: Callable, name: str = "all-to-all"):
        super().__init__()
        self.fn = fn
        self.name = name
        self.stats.name = name
        self._collected: List[Any] = []
        self._launched = False

    def poke(self, executor) -> None:
        while self.inq:
            self._collected.append(self.inq.popleft())
        if self.input_done and not self._launched:
            self._launched = True
            t0 = self.stats.on_submit()
            n = 0
            for ref in self.fn(self._collected, executor.submit):
                self.outq.append(ref)
                n += 1
            self.stats.on_done(t0, n_blocks=n)
            self.finished = True


class LimitOp(PhysicalOp):
    """Row-limit: passes refs through until n rows were emitted. Row counts
    require block materialization, so this op fetches block sizes on the
    driver (same as the reference's limit, which inspects metadata)."""

    def __init__(self, n: int):
        super().__init__()
        self.n = n
        self.remaining = n
        self.name = f"limit[{n}]"
        self.stats.name = self.name

    def poke(self, executor) -> None:
        import ray_tpu_torch as rt
        from ray_tpu_torch.data.block import BlockAccessor
        while self.inq and not self.backpressured():
            if self.remaining <= 0:
                self.inq.clear()
                break
            ref = self.inq.popleft()
            t0 = self.stats.on_submit()
            block = rt.get(ref)
            rows = BlockAccessor(block).num_rows()
            if rows <= self.remaining:
                self.remaining -= rows
                self.outq.append(ref)
            else:
                self.outq.append(rt.put(
                    BlockAccessor(block).slice(0, self.remaining)))
                self.remaining = 0
            self.stats.on_done(t0)
        if self.remaining <= 0 or (self.input_done and self.idle()):
            self.finished = True


class StreamingExecutor:
    """Drives an operator chain; yields final refs as they become ready."""

    def __init__(self, ops: List[PhysicalOp], source_refs: List[Any],
                 submit: Callable):
        self.ops = ops
        self.submit = submit
        self._source = deque(source_refs)
        self._out: "deque" = deque()
        self._done = threading.Event()
        self._cancel = threading.Event()   # consumer abandoned the iterator
        self._error: Optional[BaseException] = None
        self._ready = threading.Condition()
        if ops:
            ops[-1].held_downstream = lambda: len(self._out)

    def _pump_once(self) -> bool:
        """One scheduling round. Returns True if anything moved."""
        import ray_tpu_torch as rt

        moved = False
        # feed the first operator from the source (itself backpressured)
        first = self.ops[0] if self.ops else None
        if first is not None:
            while self._source and len(first.inq) < _DEFAULT_BUFFER:
                first.inq.append(self._source.popleft())
                moved = True
            if not self._source:
                first.input_done = True

        # poll in-flight tasks of every op (out-of-order completion)
        for i, op in enumerate(self.ops):
            if op.inflight:
                ready, _ = rt.wait(list(op.inflight.keys()),
                                   num_returns=len(op.inflight), timeout=0)
                for ref in ready:
                    for out in op.on_task_done(ref):
                        op.outq.append(out)
                    moved = True
            # flow outputs downstream (or to the executor output)
            sink = self.ops[i + 1].inq if i + 1 < len(self.ops) else None
            while op.outq:
                if sink is not None:
                    if len(sink) >= _DEFAULT_BUFFER:
                        break  # backpressure: downstream input full
                    sink.append(op.outq.popleft())
                else:
                    with self._ready:
                        if len(self._out) >= 2 * _DEFAULT_BUFFER:
                            break  # backpressure: consumer lagging
                        self._out.append(op.outq.popleft())
                        self._ready.notify()
                moved = True
            # propagate end-of-input
            if op.finished and i + 1 < len(self.ops) and \
                    not op.outq and not self.ops[i + 1].input_done:
                self.ops[i + 1].input_done = True
                moved = True
            op.poke(self)
        return moved

    def _run(self) -> None:
        import ray_tpu_torch as rt
        try:
            if not self.ops:
                with self._ready:
                    self._out.extend(self._source)
                    self._source.clear()
                return
            while not (self.ops[-1].finished and not self.ops[-1].outq):
                if self._cancel.is_set():
                    return  # consumer walked away: stop submitting work
                if self._pump_once():
                    continue
                # nothing moved: park on in-flight work instead of spinning
                pending = [r for op in self.ops for r in op.waitable_refs()]
                if pending:
                    rt.wait(pending, num_returns=1, timeout=5)
                elif all(op.finished for op in self.ops):
                    break
                else:
                    self._cancel.wait(0.05)  # output-full stall: re-check
        except BaseException as e:  # noqa: BLE001 - surfaced to consumer
            self._error = e
        finally:
            with self._ready:
                self._done.set()
                self._ready.notify_all()

    def run(self) -> Iterator[Any]:
        t = threading.Thread(target=self._run, daemon=True,
                             name="data-streaming-executor")
        t.start()
        try:
            while True:
                with self._ready:
                    while not self._out and not self._done.is_set():
                        self._ready.wait(1.0)
                    if self._out:
                        ref = self._out.popleft()
                    else:
                        if self._error is not None:
                            raise self._error
                        return
                yield ref
        finally:
            # consumer finished or abandoned (take(n) breaking early):
            # stop the pump so the rest of the plan isn't executed eagerly
            self._cancel.set()
