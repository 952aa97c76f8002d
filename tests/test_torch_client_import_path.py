"""The client proxy's ``import_path`` targets (``rpc_cp_task`` and
``rpc_cp_actor_create`` with ``import_path="pkg.module:attr"``), the port's
proxy held to the JAX package's.

A thin client that sends no function blob, as the JAX package's C++ worker
API does (``native/cppapi``), drives each proxy over its RPC wire from
Python: connect, a task and an actor created by import path, the actor's
calls, ``cp_get`` of every result, and two bad paths (no colon, a missing
attribute). Its values and replies go back as plain pickles whose
ObjectRef and ActorHandle markers it keeps as tuples. The JAX run happens
once a test run on a JAX ``Cluster`` (``_once``), then the port's on a head
started by ``ray_tpu_torch.init()`` in this process; their transcripts must
be equal.

The targets are module-level here. The proxy imports this module by name;
the port's workers import it by name too (so it imports no JAX at the top),
the JAX workers get the targets by value (cloudpickle's pickle-by-value,
registered for the JAX run only).
"""

import asyncio
import fcntl
import importlib
import os
import pickle
import sys

import pytest

import ray_tpu_torch


def square(x):
    return x * x


class Accumulator:
    def __init__(self, start):
        self.total = start

    def add(self, k):
        self.total += k
        return self.total

    def _hidden(self):
        return "not a method of the handle"


class AsyncEcho:
    async def echo(self, x):
        await asyncio.sleep(0)
        return ("echo", x)


def _marker(pid):
    """A thin client keeps markers as the tuples they are."""
    return tuple(pid)


def _drive(pkg, address):
    """The wire conversation; returns what a thin client sees."""
    protocol = importlib.import_module(f"{pkg}.cluster.protocol")
    common = importlib.import_module(f"{pkg}.client.common")
    cli = protocol.get_client(address)
    mod = __name__

    def args(*a):
        return pickle.dumps((list(a), {}))

    def values(sess, refs_blob):
        refs = common.loads(refs_blob, _marker)
        resp = cli.call("cp_get", session=sess, oids=[r[1] for r in refs],
                        timeout=60)
        assert resp["ok"], resp.get("error")
        return [common.loads(b, _marker) for b in resp["values"]]

    sess = cli.call("cp_connect", meta={"client": "thin"})["session"]
    out = {}
    t = cli.call("cp_task", session=sess, desc=None, blob=None,
                 args_blob=args(7), import_path=f"{mod}:square")
    out["task"] = values(sess, t["refs"])
    a = cli.call("cp_actor_create", session=sess, desc=None, blob=None,
                 args_blob=args(100), import_path=f"{mod}:Accumulator")
    handle = common.loads(a["actor"], _marker)
    out["actor_marker"] = (handle[0], handle[3], handle[4])
    got = []
    for k in (1, 2, 3):
        r = cli.call("cp_actor_task", session=sess, actor_id=handle[1],
                     method_name="add", args_blob=args(k))
        got += values(sess, r["refs"])
    out["actor_calls"] = got
    e = cli.call("cp_actor_create", session=sess, desc=None, blob=None,
                 args_blob=args(), import_path=f"{mod}:AsyncEcho")
    echo = common.loads(e["actor"], _marker)
    out["async_marker"] = (echo[3], echo[4])
    r = cli.call("cp_actor_task", session=sess, actor_id=echo[1],
                 method_name="echo", args_blob=args("hi"))
    out["async_call"] = values(sess, r["refs"])
    bad = {}
    for label, path in (("no_colon", f"{mod}.square"),
                        ("missing_attr", f"{mod}:missing"),
                        ("missing_module", "no_such_module_xyz:f")):
        rt_ = cli.call("cp_task", session=sess, desc=None, blob=None,
                       args_blob=args(1), import_path=path)
        ra = cli.call("cp_actor_create", session=sess, desc=None, blob=None,
                      args_blob=args(), import_path=path)
        bad[label] = (rt_["ok"], rt_["error"], ra["ok"], ra["error"],
                      type(pickle.loads(rt_["exc"])).__name__)
    out["bad"] = bad
    for h in (handle, echo):
        cli.call("cp_actor_kill", session=sess, actor_id=h[1])
    cli.call("cp_disconnect", session=sess)
    return out


def _jax_run(tmp):
    import cloudpickle

    import ray_tpu
    from ray_tpu.client.server import ClientProxy
    from ray_tpu.cluster.cluster_utils import Cluster
    module = sys.modules[__name__]
    cloudpickle.register_pickle_by_value(module)
    ray_tpu.shutdown()
    c = Cluster(initialize_head=True, head_node_args={"num_cpus": 4})
    try:
        proxy = ClientProxy(ray_tpu.init(address=c.address))
        try:
            return _drive("ray_tpu", proxy.address)
        finally:
            proxy.stop()
            ray_tpu.shutdown()
    finally:
        c.shutdown()
        cloudpickle.unregister_pickle_by_value(module)


def _once(tmp_path_factory, name, compute):
    """``compute(tmp)`` once for the whole run, shared by the xdist workers
    through a pickle under the run's temporary root."""
    base = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        base = base.parent
    path = base / f"{name}.pkl"
    with open(base / f"{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not path.exists():
            tmp = base / f"{name}.tmp"
            tmp.mkdir(exist_ok=True)
            result = compute(tmp)
            with open(base / f"{name}.part", "wb") as f:
                pickle.dump(result, f)
            os.replace(base / f"{name}.part", path)
    with open(path, "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    return _once(tmp_path_factory, "torch_client_import_path_jax", _jax_run)


@pytest.fixture(scope="module")
def port_run(jax_run):
    """The port's head and proxy, once the JAX cluster is down."""
    from ray_tpu_torch.client.server import ClientProxy
    ray_tpu_torch.shutdown()
    rt = ray_tpu_torch.init(num_cpus=4)
    p = ClientProxy(rt)
    try:
        yield _drive("ray_tpu_torch", p.address)
    finally:
        p.stop()
        ray_tpu_torch.shutdown()


def test_import_path_task_and_actors_match_jax(jax_run, port_run):
    want = {k: v for k, v in jax_run.items() if k != "bad"}
    assert want == {
        "task": [49],
        "actor_marker": ("actor", {"add": {}}, False),
        "actor_calls": [101, 103, 106],
        "async_marker": ({"echo": {}}, True),
        "async_call": [("echo", "hi")]}
    assert {k: v for k, v in port_run.items() if k != "bad"} == want


def test_bad_import_path_fails_as_in_jax(jax_run, port_run):
    want = jax_run["bad"]
    assert want["no_colon"][0] is False and want["no_colon"][2] is False
    assert "must be 'module:attr'" in want["no_colon"][1]
    assert want["missing_attr"][1].startswith("AttributeError")
    assert want["missing_module"][4] == "ModuleNotFoundError"
    assert port_run["bad"] == want
