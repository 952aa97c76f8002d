"""Durable workflows in the port (``ray_tpu_torch/workflow/``), held to the
JAX package's (``ray_tpu/workflow/``).

- The counterparts of ``tests/test_workflow_depth.py`` (all six: dynamic
  continuations, their checkpoints across a resume, events, an event's
  durability and timeout, ``mock://`` storage) and of
  ``tests/test_dag_workflow_util.py:81`` (durable resume) and ``:115``
  (failure, then resume), each on a head that ``init()`` starts in this
  process, as the JAX tests' ``init(num_cpus=4)`` does.
- The same DAGs run by both packages (the JAX one on its in-process
  runtime) give equal outputs and equal step keys in storage.
- A lambda step raises ``TypeError`` at ``run``, before anything is
  stored.

Step functions are module-level: the port stores a workflow's DAG with its
own pickler, by import path, and its workers import this module by name (so
it imports JAX only inside functions).
"""

import importlib
import os
import threading
import time

import pytest

import ray_tpu_torch
from ray_tpu_torch import workflow
from ray_tpu_torch.workflow import storage as wf_storage


@pytest.fixture()
def rt(tmp_path):
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=4)
    workflow.set_storage(str(tmp_path / "wf"))
    yield ray_tpu_torch
    wf_storage.reset_storage()
    ray_tpu_torch.shutdown()


@ray_tpu_torch.remote
def fact(n, acc):
    if n <= 1:
        return acc
    return workflow.continuation(fact.bind(n - 1, acc * n))


@ray_tpu_torch.remote
def outer(marker):
    return workflow.continuation(chain.bind("a", marker))


@ray_tpu_torch.remote
def chain(tag, marker):
    return workflow.continuation(leaf.bind(tag, marker))


@ray_tpu_torch.remote
def leaf(tag, marker):
    with open(marker, "a") as f:
        f.write(tag)
    return tag * 2


@ray_tpu_torch.remote
def combine(payload, tag):
    return f"{tag}:{payload}"


@ray_tpu_torch.remote
def echo(payload):
    return payload


@ray_tpu_torch.remote
def double(x):
    return x * 2


@ray_tpu_torch.remote
def add(a, b):
    return a + b


@ray_tpu_torch.remote
def record(x, marker):
    with open(marker, "a") as f:
        f.write("r")
    return x * 2


@ray_tpu_torch.remote
def final(x):
    return x + 1


@ray_tpu_torch.remote
def stage1(x):
    return x + 1


@ray_tpu_torch.remote
def maybe_fail(x, flag):
    if not os.path.exists(flag):
        raise RuntimeError("transient failure")
    return x * 10


def test_dynamic_continuation_recursion(rt):
    """Factorial via continuations: each step returns a sub-DAG — the
    loop shape a static DAG cannot express."""
    out = workflow.run(fact.bind(5, 1), workflow_id="wf-fact")
    assert out == 120
    assert workflow.get_status("wf-fact") == "SUCCESSFUL"
    assert workflow.get_output("wf-fact") == 120


def test_continuation_steps_checkpoint_and_resume(rt, tmp_path):
    """Steps inside a continuation checkpoint individually: a resume
    re-runs none of them."""
    marker = str(tmp_path / "runs")
    assert workflow.run(outer.bind(marker), workflow_id="wf-cont") == "aa"
    assert open(marker).read() == "a"
    assert workflow.resume("wf-cont") == "aa"
    assert open(marker).read() == "a"


def test_event_blocks_until_sent(rt):
    dag = combine.bind(workflow.event("go", timeout_s=30.0), "got")
    fut = workflow.run_async(dag, workflow_id="wf-ev")
    time.sleep(0.5)
    assert not fut.done()            # still waiting on the event
    workflow.send_event("wf-ev", "go", payload="green")
    assert fut.result(timeout=60) == "got:green"


def test_event_is_durable_across_resume(rt):
    """A delivered event persists: resume does not re-wait."""
    workflow.send_event("wf-ev2", "ready", payload=7)
    dag = echo.bind(workflow.event("ready", timeout_s=5.0))
    assert workflow.run(dag, workflow_id="wf-ev2") == 7
    assert workflow.resume("wf-ev2") == 7


def test_event_timeout(rt):
    dag = echo.bind(workflow.event("never", timeout_s=1.0, poll_s=0.05))
    with pytest.raises(Exception) as ei:
        workflow.run(dag, workflow_id="wf-ev3")
    assert "not delivered" in str(ei.value)
    assert workflow.get_status("wf-ev3") == "FAILED"


def test_mock_uri_storage_backend(rt):
    """Workflows run against mock:// cloud storage end to end."""
    from ray_tpu_torch.tune.syncer import _MockBackend
    _MockBackend.store.clear()
    workflow.set_storage("mock://bucket/workflows")
    try:
        dag = add.bind(double.bind(3), double.bind(4))
        assert workflow.run(dag, workflow_id="wf-cloud") == 14
        assert workflow.get_status("wf-cloud") == "SUCCESSFUL"
        assert workflow.get_output("wf-cloud") == 14
        assert ("wf-cloud", "SUCCESSFUL") in workflow.list_all()
        # blobs actually live in the mock cloud
        assert any("wf-cloud" in uri for uri in _MockBackend.store)
        workflow.delete("wf-cloud")
        assert workflow.get_status("wf-cloud") == "NOT_FOUND"
    finally:
        wf_storage.reset_storage()


def test_workflow_durable_resume(rt, tmp_path):
    from ray_tpu_torch.dag import InputNode
    workflow.set_storage(str(tmp_path))
    marker = str(tmp_path / "exec_count")
    with InputNode() as inp:
        dag = final.bind(record.bind(inp, marker))
    assert workflow.run(dag, workflow_id="wf-test", input_value=21) == 43
    assert workflow.get_status("wf-test") == "SUCCESSFUL"
    assert workflow.get_output("wf-test") == 43
    # resume skips completed steps: record must NOT run again
    assert workflow.resume("wf-test") == 43
    assert open(marker).read() == "r"
    assert ("wf-test", "SUCCESSFUL") in workflow.list_all()
    workflow.delete("wf-test")
    assert workflow.get_status("wf-test") == "NOT_FOUND"


def test_workflow_failure_then_resume(rt, tmp_path):
    from ray_tpu_torch.dag import InputNode
    workflow.set_storage(str(tmp_path))
    flag = str(tmp_path / "ok")
    with InputNode() as inp:
        dag = maybe_fail.bind(stage1.bind(inp), flag)
    with pytest.raises(ray_tpu_torch.TaskError):
        workflow.run(dag, workflow_id="wf-fail", input_value=4)
    assert workflow.get_status("wf-fail") == "FAILED"
    open(flag, "w").close()
    assert workflow.resume("wf-fail") == 50
    assert workflow.get_status("wf-fail") == "SUCCESSFUL"


def test_lambda_step_raises_type_error_at_run(rt):
    dag = ray_tpu_torch.remote(lambda x: x + 1).bind(1)
    with pytest.raises(TypeError, match="define it at module level"):
        workflow.run(dag, workflow_id="wf-lambda")
    assert workflow.get_status("wf-lambda") == "NOT_FOUND"
    assert workflow.list_all() == []


# ---------------------------------------------------------------------------
# the same DAGs through both packages
#
# Plain module-level functions; each package wraps them in its own remote.
# A continuation step finds its package's remote and workflow by name.


def p_scale(x, k):
    return x * k


def p_sum(*xs, bias=0):
    return sum(xs) + bias


def p_fact(pkg, n, acc):
    if n <= 1:
        return acc
    mod = importlib.import_module(pkg)
    wf = importlib.import_module(f"{pkg}.workflow")
    return wf.continuation(mod.remote(p_fact).bind(pkg, n - 1, acc * n))


def _dags(pkg):
    mod = importlib.import_module(pkg)
    InputNode = importlib.import_module(f"{pkg}.dag").InputNode
    scale, total = mod.remote(p_scale), mod.remote(p_sum)
    factorial = mod.remote(p_fact)
    with InputNode() as inp:
        shared = scale.bind(inp, 3)
        diamond = total.bind(shared, scale.bind(shared, 2), bias=inp)
    chain = total.bind(scale.bind(scale.bind(2, 5), 7), 1)
    return {"diamond": (diamond, 4), "chain": (chain, None),
            "continuation": (factorial.bind(pkg, 6, 1), None)}


def _run_all(pkg, root):
    """Each DAG through ``pkg``'s workflow: its output, resume's output and
    every storage key under its id (continuation keys included)."""
    wf = importlib.import_module(f"{pkg}.workflow")
    storage = importlib.import_module(f"{pkg}.workflow.storage")
    wf.set_storage(root)
    out = {}
    try:
        for name, (dag, inp) in _dags(pkg).items():
            got = wf.run(dag, workflow_id=f"wf-{name}", input_value=inp)
            keys = sorted(os.path.relpath(os.path.join(d, f), root)
                          for d, _, files in os.walk(
                              os.path.join(root, f"wf-{name}"))
                          for f in files)
            out[name] = (got, wf.resume(f"wf-{name}"), keys,
                         wf.get_status(f"wf-{name}"))
    finally:
        storage.reset_storage()
    return out


@pytest.fixture(scope="module")
def both_packages(tmp_path_factory):
    import ray_tpu
    ray_tpu.shutdown()
    ray_tpu.init(local_mode=True, num_cpus=4)
    try:
        jax_out = _run_all("ray_tpu", str(tmp_path_factory.mktemp("jaxwf")))
    finally:
        ray_tpu.shutdown()
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=4)
    try:
        port_out = _run_all("ray_tpu_torch",
                            str(tmp_path_factory.mktemp("portwf")))
    finally:
        ray_tpu_torch.shutdown()
    return jax_out, port_out


@pytest.mark.parametrize("name", ["diamond", "chain", "continuation"])
def test_same_dag_gives_equal_outputs_and_step_keys(both_packages, name):
    jax_out, port_out = both_packages
    assert port_out[name] == jax_out[name]
    got, resumed, keys, status = port_out[name]
    assert got == resumed and status == "SUCCESSFUL"
    assert any("/steps/" in k for k in keys)


def test_the_jax_values_of_the_shared_dags(both_packages):
    jax_out, _ = both_packages
    assert jax_out["diamond"][0] == 12 + 24 + 4
    assert jax_out["chain"][0] == 71
    assert jax_out["continuation"][0] == 720
    assert "wf-continuation/steps/0000_p_fact.c/0000_p_fact.c/0000_p_fact.pkl" \
        in jax_out["continuation"][2]
