"""Durable DAG executor: static DAGs, dynamic continuations, events.
Ported from ``ray_tpu/workflow/execution.py``, on the port's ``dag/nodes.py``.

Each DAG node becomes a *step* with a deterministic step-id (the node's
position in a post-order walk + function name). Before running a step the
executor checks storage; a hit short-circuits the whole subtree (parity:
workflow_state_from_storage.py recovery semantics). Results persist as
pickle blobs behind the pluggable storage interface (storage.py; parity:
workflow_storage.py).

Dynamic workflows (parity: workflow_executor.py continuation handling):
a step may return ``workflow.continuation(sub_dag)`` — the sub-DAG
replaces the step, executing durably with step-ids namespaced under the
parent, and its result becomes the step's checkpointed result. Recursion
through continuations expresses loops/recursion the static DAG cannot.

Events (parity: python/ray/workflow event system): ``workflow.event(n)``
is a step that completes only once ``workflow.send_event(workflow_id, n,
payload)`` delivers a payload through storage — so a resumed workflow
sees an already-delivered event without re-waiting.

Where the port differs: ``run`` stores the DAG and its input with the
port's own pickler (``core/serialization.dumps``), which ships functions by
import path, where the JAX module uses cloudpickle. So every step function
must be defined at module level in a file that the resuming process can
import; a lambda or nested step raises the pickler's ``TypeError`` ("define
it at module level") at ``run``, before anything is stored. Checkpoints go
through the same pickler, so a CUDA tensor a step returns is stored as a
host tensor that a process without a card can load.
"""

from __future__ import annotations

import pickle
import threading
import time
from typing import Any, Dict, List, Optional

from ray_tpu_torch.dag.nodes import DAGNode, FunctionNode, InputNode
from ray_tpu_torch.workflow.storage import get_storage, set_storage  # noqa: F401


def _dumps(value: Any) -> bytes:
    from ray_tpu_torch.core.serialization import dumps
    return dumps(value)


class Continuation:
    """Wrapper a step returns to hand control to a sub-DAG."""

    def __init__(self, dag: DAGNode, input_value: Any = None):
        if not isinstance(dag, DAGNode):
            raise TypeError("continuation() takes a bound DAG node "
                            "(fn.bind(...))")
        self.dag = dag
        self.input_value = input_value


def continuation(dag: DAGNode, input_value: Any = None) -> Continuation:
    return Continuation(dag, input_value)


def _step_key(workflow_id: str, step_id: str) -> str:
    return f"{workflow_id}/steps/{step_id}.pkl"


def _assign_step_ids(dag: DAGNode, prefix: str = "") -> Dict[int, str]:
    """Deterministic ids: post-order index + callable name."""
    order: List[DAGNode] = []
    seen = set()

    def walk(node: DAGNode):
        if id(node) in seen:
            return
        seen.add(id(node))
        for child in node._children():
            walk(child)
        order.append(node)

    walk(dag)
    ids = {}
    for i, node in enumerate(order):
        name = ""
        if isinstance(node, FunctionNode):
            name = getattr(node._remote_fn, "__name__", "fn")
        elif isinstance(node, InputNode):
            name = "input"
        ids[id(node)] = f"{prefix}{i:04d}_{name}"
    return ids


def _checkpoint(workflow_id: str, step_id: str, value: Any) -> None:
    get_storage().put_bytes(_step_key(workflow_id, step_id), _dumps(value))


def _execute_durable(node: DAGNode, workflow_id: str,
                     step_ids: Dict[int, str], memo: Dict[int, Any],
                     input_value) -> Any:
    import ray_tpu_torch as rt

    store = get_storage()
    key = id(node)
    if key in memo:
        return memo[key]
    step_id = step_ids[key]
    skey = _step_key(workflow_id, step_id)
    if store.exists(skey):
        out = pickle.loads(store.get_bytes(skey))
        memo[key] = out
        return out
    if isinstance(node, InputNode):
        out = input_value
    else:
        def rv(v):
            return _execute_durable(v, workflow_id, step_ids, memo,
                                    input_value) if isinstance(v, DAGNode) \
                else v
        args = tuple(rv(a) for a in node._bound_args)
        kwargs = {k: rv(v) for k, v in node._bound_kwargs.items()}
        if isinstance(node, FunctionNode):
            out = rt.get(node._remote_fn.remote(*args, **kwargs))
        else:
            raise TypeError(
                f"workflow DAGs support function nodes and InputNode; got "
                f"{type(node).__name__} (actor nodes are not durable)")
        if isinstance(out, Continuation):
            # Dynamic workflow: the sub-DAG replaces this step. Its own
            # steps checkpoint under a namespaced prefix, so resume
            # re-enters the continuation and skips its finished parts.
            # Placeholders (workflow.event() inside the continuation) get
            # THIS workflow's id — without it the event step polls a key
            # under the placeholder repr and hangs forever.
            sub_dag = _inject_workflow_id(out.dag, workflow_id)
            sub_ids = _assign_step_ids(sub_dag, prefix=f"{step_id}.c/")
            out = _execute_durable(sub_dag, workflow_id, sub_ids, {},
                                   out.input_value)
    _checkpoint(workflow_id, step_id, out)
    memo[key] = out
    return out


# ---------------------------------------------------------------------------
# events


def _event_key(workflow_id: str, name: str) -> str:
    return f"{workflow_id}/events/{name}.pkl"


def send_event(workflow_id: str, name: str, payload: Any = None) -> None:
    """Deliver an external event through storage; the waiting step (and
    any resumed re-run) observes it durably."""
    get_storage().put_bytes(_event_key(workflow_id, name), _dumps(payload))


def _wait_event_fn(workflow_id: str, name: str, timeout_s: Optional[float],
                   poll_s: float, storage_url: str):
    # Runs in a WORKER: the driver's storage selection doesn't exist
    # here, so the step carries the URL.
    from ray_tpu_torch.workflow.storage import storage_for
    store = storage_for(storage_url)
    k = _event_key(workflow_id, name)
    deadline = None if timeout_s is None else time.monotonic() + timeout_s
    while True:
        if store.exists(k):
            return pickle.loads(store.get_bytes(k))
        if deadline is not None and time.monotonic() >= deadline:
            raise TimeoutError(
                f"workflow event {name!r} not delivered in {timeout_s}s")
        time.sleep(poll_s)


def event(name: str, *, timeout_s: Optional[float] = None,
          poll_s: float = 0.2) -> DAGNode:
    """A DAG step that completes when ``send_event(workflow_id, name)``
    delivers a payload; evaluates to that payload. The workflow id is
    injected at run() time."""
    import ray_tpu_torch as rt

    from ray_tpu_torch.workflow.storage import get_storage_url
    fn = rt.remote(_wait_event_fn).options(num_cpus=0.01)
    return fn.bind(_WorkflowIdPlaceholder(), name, timeout_s, poll_s,
                   get_storage_url())


class _WorkflowIdPlaceholder:
    """Replaced with the actual workflow id when run() walks the DAG."""


def _inject_workflow_id(dag: DAGNode, workflow_id: str) -> DAGNode:
    """Return a COPY of ``dag`` with every _WorkflowIdPlaceholder replaced.
    Non-destructive: the caller's DAG keeps its placeholders, so the same
    DAG object can be run again under a different workflow_id, and a
    continuation's sub-DAG (built once inside user code) can be injected
    at every incarnation. Shared nodes stay shared in the copy (memo), so
    step identity by ``id(node)`` still dedupes diamonds."""
    import copy
    memo: Dict[int, DAGNode] = {}

    def sub(v):
        if isinstance(v, _WorkflowIdPlaceholder):
            return workflow_id
        if isinstance(v, DAGNode):
            return walk(v)
        return v

    def walk(node: DAGNode) -> DAGNode:
        got = memo.get(id(node))
        if got is not None:
            return got
        clone = copy.copy(node)
        memo[id(node)] = clone
        clone._bound_args = tuple(sub(a) for a in node._bound_args)
        clone._bound_kwargs = {k: sub(v)
                               for k, v in node._bound_kwargs.items()}
        return clone

    return walk(dag)


# ---------------------------------------------------------------------------
# workflow lifecycle


def _set_status(workflow_id: str, status: str, dag_blob: Optional[bytes],
                input_blob: Optional[bytes] = None) -> None:
    store = get_storage()
    store.put_bytes(f"{workflow_id}/status", status.encode())
    if dag_blob is not None:
        store.put_bytes(f"{workflow_id}/dag.pkl", dag_blob)
    if input_blob is not None:
        store.put_bytes(f"{workflow_id}/input.pkl", input_blob)


def run(dag: DAGNode, *, workflow_id: Optional[str] = None,
        input_value: Any = None) -> Any:
    """Execute a DAG durably; returns the final result."""
    import uuid
    workflow_id = workflow_id or f"wf-{uuid.uuid4().hex[:8]}"
    # Persist the PRE-injection DAG (placeholders intact): resume() re-runs
    # it under its stored id, and the user's object stays reusable under a
    # different workflow_id. Pickling first: a step the resuming process
    # could not import raises here, before anything is stored.
    _set_status(workflow_id, "RUNNING", _dumps(dag), _dumps(input_value))
    dag = _inject_workflow_id(dag, workflow_id)
    step_ids = _assign_step_ids(dag)
    try:
        out = _execute_durable(dag, workflow_id, step_ids, {}, input_value)
    except BaseException:  # noqa: BLE001 - durably mark FAILED, then re-raise
        _set_status(workflow_id, "FAILED", None)
        raise
    get_storage().put_bytes(f"{workflow_id}/output.pkl", _dumps(out))
    _set_status(workflow_id, "SUCCESSFUL", None)
    return out


def run_async(dag: DAGNode, *, workflow_id: Optional[str] = None,
              input_value: Any = None):
    """Returns a concurrent.futures.Future of run()."""
    from concurrent.futures import Future
    fut: Future = Future()

    def go():
        try:
            fut.set_result(run(dag, workflow_id=workflow_id,
                               input_value=input_value))
        except BaseException as e:  # noqa: BLE001
            fut.set_exception(e)

    threading.Thread(target=go, daemon=True, name="workflow-run-async").start()
    return fut


def resume(workflow_id: str) -> Any:
    """Re-run a stored workflow; completed steps are read from storage."""
    store = get_storage()
    dag = pickle.loads(store.get_bytes(f"{workflow_id}/dag.pkl"))
    input_value = None
    if store.exists(f"{workflow_id}/input.pkl"):
        input_value = pickle.loads(store.get_bytes(f"{workflow_id}/input.pkl"))
    return run(dag, workflow_id=workflow_id, input_value=input_value)


def get_output(workflow_id: str) -> Any:
    return pickle.loads(get_storage().get_bytes(f"{workflow_id}/output.pkl"))


def get_status(workflow_id: str) -> str:
    store = get_storage()
    if not store.exists(f"{workflow_id}/status"):
        return "NOT_FOUND"
    return store.get_bytes(f"{workflow_id}/status").decode().strip()


def list_all() -> List[tuple]:
    store = get_storage()
    return [(wf, get_status(wf)) for wf in store.list_prefix("")]


def delete(workflow_id: str) -> None:
    get_storage().delete_prefix(workflow_id)
