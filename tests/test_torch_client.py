"""The port's client proxy and ``init("client://...")`` against the JAX
package's (``tests/test_client_proxy.py``'s four cases).

Each client script body runs as a file in a fresh process, once against a
JAX proxy (a ``ray_tpu`` ``Cluster`` and ``ClientProxy``, run once per test
run and shut down first: ``_once``) and once against the port's (a head
started by ``ray_tpu_torch.init()`` in this process and its
``ClientProxy``). The printed lines must be equal. The submission dedupe
runs the same RPC sequence on both proxies, and the session release counts
each proxy's sessions after its client leaves.

The port's clients ship functions and classes by import path (ROADMAP.md C),
so a body defines them at module level and does its work under
``if __name__ == "__main__":``; a lambda, or a function of a ``python -c``
body, raises the pickler's ``TypeError`` in the client. This module imports
JAX only inside functions: the port's workers import it by name.
"""

import fcntl
import os
import pickle
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import pytest

import ray_tpu_torch

REPO = Path(__file__).resolve().parents[1]

_SCRIPT = """
import sys
import {pkg} as pkg
{body}

if __name__ == "__main__":
    pkg.init(address="client://" + sys.argv[1])
    main()
    pkg.shutdown()
"""

BODIES = {
    "put_get_task_actor": """
@pkg.remote
def add(a, b):
    return a + b


@pkg.remote
class Counter:
    def __init__(self, start):
        self.n = start

    def incr(self, k=1):
        self.n += k
        return self.n


def main():
    ref = pkg.put({"x": 41})
    print("GOT", pkg.get(ref)["x"])
    print("SUM", pkg.get(add.remote(2, 3)))
    # ref args pass through the boundary as markers
    print("REFARG", pkg.get(add.remote(pkg.put(10), 5)))
    c = Counter.remote(100)
    c.incr.remote()
    print("COUNT", pkg.get(c.incr.remote(5)))
    ready, rest = pkg.wait([add.remote(1, 1)], timeout=30)
    print("WAIT", len(ready), len(rest))
    print("NODES", len(pkg.nodes()) >= 1)
    print("RES", pkg.cluster_resources().get("CPU", 0) >= 1)
    pkg.kill(c)
""",
    "exception_and_named_actor": """
@pkg.remote
def boom():
    raise ValueError("kapow")


@pkg.remote
class Registry:
    def __init__(self):
        self.d = {}

    def put(self, k, v):
        self.d[k] = v

    def get(self, k):
        return self.d[k]


def main():
    try:
        pkg.get(boom.remote())
        print("NOERROR")
    except Exception as e:
        print("ERR", "kapow" in str(e))
    r = Registry.options(name="reg").remote()
    pkg.get(r.put.remote("a", 7))
    again = pkg.get_actor("reg")
    print("NAMED", pkg.get(again.get.remote("a")))
    pkg.kill(r)
""",
    "session_release": """
import gc
import time


def main():
    refs = [pkg.put(i) for i in range(20)]
    print("VALUES", pkg.get(refs) == list(range(20)))
    del refs
    gc.collect()
    time.sleep(0.6)   # let the batched release flush
""",
}


def _run_client(pkg, address, body, tmp):
    script = Path(tmp) / f"client_{pkg}_{abs(hash(body)) % 10**8}.py"
    script.write_text(_SCRIPT.format(pkg=pkg, body=textwrap.dedent(body)))
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    env.setdefault("JAX_PLATFORMS", "cpu")
    out = subprocess.run([sys.executable, str(script), address], env=env,
                         capture_output=True, text=True, timeout=120,
                         cwd=str(tmp))
    assert out.returncode == 0, f"client failed:\n{out.stdout}\n{out.stderr}"
    return out.stdout.splitlines()


# ---------------------------------------------------------------------------
# the submission dedupe, the same RPC sequence on either proxy
# ---------------------------------------------------------------------------


def bump(path):
    with open(path, "a") as f:
        f.write("x")
    return "done"


class DedupeCounter:
    def __init__(self):
        self.n = 0

    def incr(self):
        self.n += 1
        return self.n


def _descriptors(pkg):
    """(desc, blob) of ``bump`` and of ``DedupeCounter`` for ``pkg``'s
    proxy: the JAX descriptor carries its cloudpickle, the port's client
    pickles by import path."""
    if pkg == "ray_tpu":
        from ray_tpu.core.task_spec import FunctionDescriptor
        return (FunctionDescriptor.for_callable(bump),
                FunctionDescriptor.for_callable(DedupeCounter))
    from ray_tpu_torch.core import serialization
    from ray_tpu_torch.core.task_spec import FunctionDescriptor
    return tuple((FunctionDescriptor.for_callable(x), serialization.dumps(x))
                 for x in (bump, DedupeCounter))


def _dedupe(pkg, proxy, marker):
    import importlib
    api = importlib.import_module(pkg)
    common = importlib.import_module(f"{pkg}.client.common")
    (desc, blob), (cdesc, cblob) = _descriptors(pkg)
    sess = proxy.rpc_cp_connect()["session"]
    s = proxy._session(sess)
    args_blob = common.dumps(([marker], {}), common.marker_for)
    r1 = proxy.rpc_cp_task(sess, desc, blob, args_blob,
                           submission_id="sub-1")
    r2 = proxy.rpc_cp_task(sess, desc, blob, args_blob,
                           submission_id="sub-1")
    seen = {"task_ok": r1["ok"], "task_replayed": r2 is r1}
    seen["task_value"] = api.get(proxy._dec(s, r1["refs"])[0], timeout=30)
    time.sleep(0.3)
    with open(marker) as f:
        seen["ran"] = f.read()
    no_args = common.dumps(([], {}), common.marker_for)
    a1 = proxy.rpc_cp_actor_create(sess, cdesc, cblob, no_args,
                                   methods={"incr": {}},
                                   submission_id="act-1")
    a2 = proxy.rpc_cp_actor_create(sess, cdesc, cblob, no_args,
                                   methods={"incr": {}},
                                   submission_id="act-1")
    seen.update(actor_ok=a1["ok"], actor_replayed=a2 is a1)
    handle = proxy._dec(s, a1["actor"])
    aid = handle._rt_actor_id.binary()
    t1 = proxy.rpc_cp_actor_task(sess, aid, "incr", no_args,
                                 submission_id="call-1")
    t2 = proxy.rpc_cp_actor_task(sess, aid, "incr", no_args,
                                 submission_id="call-1")
    seen["call_replayed"] = t1["ok"] and t2 is t1
    seen["first"] = api.get(proxy._dec(s, t1["refs"])[0], timeout=30)
    t3 = proxy.rpc_cp_actor_task(sess, aid, "incr", no_args,
                                 submission_id="call-2")
    seen["fresh"] = api.get(proxy._dec(s, t3["refs"])[0], timeout=30)
    api.kill(handle)
    proxy.rpc_cp_disconnect(sess)
    return seen


def _sessions_after_release(pkg, proxy, tmp):
    lines = _run_client(pkg, proxy.address, BODIES["session_release"], tmp)
    deadline = time.time() + 10
    while time.time() < deadline and proxy._sessions:
        time.sleep(0.1)
    return lines, len(proxy._sessions)


def _cases(pkg, proxy, tmp):
    out = {name: _run_client(pkg, proxy.address, body, tmp)
           for name, body in BODIES.items() if name != "session_release"}
    out["session_release"] = _sessions_after_release(pkg, proxy, tmp)
    out["dedupe"] = _dedupe(pkg, proxy, str(Path(tmp) / f"ran-{pkg}"))
    return out


def _jax_cases(tmp):
    """The JAX run; its workers get this module's ``bump`` and
    ``DedupeCounter`` by value (cloudpickle), as they cannot import it."""
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
            return _cases("ray_tpu", proxy, tmp)
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
def jax_runs(tmp_path_factory):
    return _once(tmp_path_factory, "torch_client_jax", _jax_cases)


@pytest.fixture(scope="module")
def proxy(jax_runs):
    """The port's head and proxy, once the JAX cluster is down."""
    from ray_tpu_torch.client.server import ClientProxy
    ray_tpu_torch.shutdown()
    rt = ray_tpu_torch.init(num_cpus=4)
    p = ClientProxy(rt)
    yield p
    p.stop()
    ray_tpu_torch.shutdown()


@pytest.fixture(scope="module")
def port_runs(proxy, tmp_path_factory):
    return _cases("ray_tpu_torch", proxy, tmp_path_factory.mktemp("client"))


def test_client_put_get_task_actor(jax_runs, port_runs):
    want = jax_runs["put_get_task_actor"]
    assert want == ["GOT 41", "SUM 5", "REFARG 15", "COUNT 106", "WAIT 1 0",
                    "NODES True", "RES True"]
    assert port_runs["put_get_task_actor"] == want


def test_client_exception_and_named_actor(jax_runs, port_runs):
    want = jax_runs["exception_and_named_actor"]
    assert want == ["ERR True", "NAMED 7"]
    assert port_runs["exception_and_named_actor"] == want


def test_client_submission_dedupe(jax_runs, port_runs):
    """A resent cp_task / cp_actor_create / cp_actor_task with the same
    submission_id returns the cached reply and does not run twice."""
    want = jax_runs["dedupe"]
    assert want == {"task_ok": True, "task_replayed": True,
                    "task_value": "done", "ran": "x", "actor_ok": True,
                    "actor_replayed": True, "call_replayed": True,
                    "first": 1, "fresh": 2}
    assert port_runs["dedupe"] == want


def test_client_session_release(jax_runs, port_runs):
    """After the client disconnects, no session (and none of its pins) is
    left on the proxy."""
    want = jax_runs["session_release"]
    assert want == (["VALUES True"], 0)
    assert port_runs["session_release"] == want


def test_client_cannot_ship_a_lambda_or_a_dash_c_function(proxy, tmp_path):
    """A lambda raises the pickler's TypeError in the client, before any
    RPC, and the client goes on; so does a function of a ``-c`` body."""
    lines = _run_client("ray_tpu_torch", proxy.address, """
def main():
    try:
        pkg.remote(lambda x: x).remote(1)
        print("SHIPPED")
    except TypeError as e:
        print("TYPEERROR", "define it at module level" in str(e))
    print("AFTER", pkg.get(pkg.put(3)))
""", tmp_path)
    assert lines == ["TYPEERROR True", "AFTER 3"]
    body = textwrap.dedent(f"""
        import ray_tpu_torch as rt
        rt.init(address="client://{proxy.address}")

        @rt.remote
        def f():
            return 1

        try:
            f.remote()
        except TypeError as e:
            print("TYPEERROR", "define it at module level" in str(e))
        rt.shutdown()
    """)
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-c", body], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.split() == ["TYPEERROR", "True"]
