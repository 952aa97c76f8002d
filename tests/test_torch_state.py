"""The port's state API, timeline, metrics exposition and dashboard against
the JAX package's: ``tests/test_state_and_metrics.py``'s four cases,
``tests/test_observability.py::test_profile_worker_via_state_api`` and
``::test_dashboard_spans_and_profile_endpoints``, and
``tests/test_dashboard_preprocessors.py::test_dashboard_endpoints``.

One workload runs on each package's head, started by ``init(num_cpus=4,
_system_config={"tracing_enabled": True})`` in this process (the JAX run
once per test run, ``_once``, and shut down before the port's): the same
tasks, actors, job, placement group and metrics, read back through
``state``, ``timeline``, ``prometheus_text`` and a ``Dashboard``. Each case
records what the JAX test asserts on, the keys of the JSON rows and the
counts; the port's record must equal the JAX one. This module imports JAX
only inside functions: the port's workers import it by name.
"""

import fcntl
import importlib
import json
import os
import pickle
import sys
import time
import urllib.request

import pytest


def task_for_state():
    return 1


class ActorForState:
    def ping(self):
        return "pong"


def traced():
    return 2


def dash_task():
    return 1


class Marker:
    def ping(self):
        return 1


class Spinner:
    def pid(self):
        return os.getpid()

    def spin(self, seconds):
        end = time.time() + seconds
        n = 0
        while time.time() < end:
            n += sum(i for i in range(500))
        return n


def _keys(rows):
    return sorted({k for r in rows for k in r})


def _get(url):
    with urllib.request.urlopen(url, timeout=30) as r:
        return r.status, r.read()


def case_state_lists(pkg, api, tmp):
    state = importlib.import_module(f"{pkg}.state")
    a = api.remote(ActorForState).remote()
    api.get([api.remote(task_for_state).remote(), a.ping.remote()],
            timeout=60)
    time.sleep(1.5)  # task-event flush period
    nodes, actors = state.list_nodes(), state.list_actors()
    tasks, summary = state.list_tasks(), state.summarize_tasks()
    objects = state.list_objects()
    api.kill(a)
    return {
        "nodes": (len(nodes), nodes[0]["state"], _keys(nodes)),
        "actor": (sum("ActorForState" in x["class_name"] for x in actors),
                  _keys(actors)),
        "task": (any("task_for_state" in t["name"] for t in tasks),
                 _keys(tasks)),
        "summary": (any("task_for_state" in n for n in summary),
                    _keys(summary.values())),
        "objects": (len(objects), "node_id" in objects[0])}


def case_timeline_dump(pkg, api, tmp):
    api.get(api.remote(traced).remote(), timeout=30)
    time.sleep(1.5)
    out = os.path.join(tmp, f"timeline-{pkg}.json")
    api.timeline(out)
    with open(out) as f:
        events = json.load(f)
    return {"list": isinstance(events, list) and len(events) >= 1,
            "ts_dur": all("ts" in e and "dur" in e for e in events)}


def case_metrics_registry_and_prometheus(pkg, api, tmp):
    metrics = importlib.import_module(f"{pkg}.util.metrics")
    c = metrics.Counter("test_requests_total", "requests",
                        tag_keys=("route",))
    c.inc(3, tags={"route": "/a"})
    metrics.Gauge("test_queue_depth", "depth").set(7)
    h = metrics.Histogram("test_latency_s", "latency",
                          boundaries=[0.1, 1.0])
    h.observe(0.05)
    h.observe(2.0)
    text = metrics.prometheus_text()
    return {"counter": "test_requests_total" in text,
            "tag": 'route="/a"' in text,
            "gauge": "test_queue_depth 7" in text,
            "histogram": "test_latency_s_bucket" in text}


def case_placement_group_listing(pkg, api, tmp):
    state = importlib.import_module(f"{pkg}.state")
    util = importlib.import_module(f"{pkg}.util.placement_group")
    pg = util.placement_group([{"CPU": 1}], strategy="PACK", name="statepg")
    pg.ready(timeout=20)
    pgs = state.list_placement_groups()
    util.remove_placement_group(pg)
    # a row names its gang's slice: a TPU slice in JAX, an NVLink domain in
    # the port
    return {"listed": sum(p["name"] == "statepg" for p in pgs),
            "keys": _keys(pgs)}


def case_profile_worker_via_state_api(pkg, api, tmp):
    state = importlib.import_module(f"{pkg}.state")
    s = api.remote(Spinner).remote()
    pid = api.get(s.pid.remote(), timeout=60)
    fut = s.spin.remote(4.0)
    dump = state.profile_worker(pid, duration_s=1.0, interval_s=0.005)
    api.get(fut, timeout=60)
    try:
        state.profile_worker(99_999_999)
        bad = None
    except ValueError:
        bad = "ValueError"
    api.kill(s)
    return {"dump": bool(dump.strip()), "spin": "spin" in dump,
            "bad_pid": bad}


def case_dashboard_spans_and_profile_endpoints(pkg, api, tmp):
    dashboard = importlib.import_module(f"{pkg}.dashboard")
    api.get(api.remote(dash_task).remote(), timeout=60)
    rt = importlib.import_module(f"{pkg}.core.api")._global_runtime()
    dash = dashboard.Dashboard(rt.conductor_address, port=0)
    try:
        _, body = _get(f"http://{dash.host}:{dash.port}/api/spans")
        _, prof = _get(f"http://{dash.host}:{dash.port}/api/profile/"
                       f"99999999?duration=0.1")
    finally:
        dash.stop()
    return {"spans": b"task.execute" in body or b"task.submit" in body,
            "profile": prof.decode()}


def case_dashboard_endpoints(pkg, api, tmp):
    dashboard = importlib.import_module(f"{pkg}.dashboard")
    js = importlib.import_module(f"{pkg}.job_submission")
    rt = importlib.import_module(f"{pkg}.core.api")._global_runtime()
    dash = dashboard.Dashboard(rt.conductor_address)
    out = {}
    try:
        m = api.remote(Marker).options(name="dash-marker").remote()
        out["marker"] = api.get(m.ping.remote(), timeout=60)
        job = js.JobSubmissionClient(rt.conductor_address)
        sid = job.submit_job(
            entrypoint=f"{sys.executable} -c \"print('dash job')\"")
        job.wait_until_finish(sid, timeout=60)
        status, body = _get(dash.url + "/")
        out["page"] = (status, f"{pkg} cluster".encode() in body)
        cl = json.loads(_get(dash.url + "/api/cluster")[1])
        out["cluster"] = (cl["total"].get("CPU"), sorted(cl))
        nodes = json.loads(_get(dash.url + "/api/nodes")[1])
        out["nodes"] = (sum(n["state"] == "ALIVE" for n in nodes),
                        _keys(nodes))
        actors = json.loads(_get(dash.url + "/api/actors")[1])
        out["actors"] = (sum(a.get("name") == "dash-marker" for a in actors),
                         _keys(actors))
        jobs = json.loads(_get(dash.url + "/api/jobs")[1])
        out["jobs"] = (sum(j["submission_id"] == sid
                           and j["status"] == "SUCCEEDED" for j in jobs),
                       _keys(jobs))
        objects = json.loads(_get(dash.url + "/api/objects")[1])
        out["objects"] = len(objects)
        out["metrics"] = _get(dash.url + "/metrics")[0]
        api.kill(m)
    finally:
        dash.stop()
    return out


CASES = {name[len("case_"):]: fn for name, fn in globals().items()
         if name.startswith("case_")}


def _run_all(pkg, tmp):
    api = importlib.import_module(pkg)
    config = importlib.import_module(f"{pkg}.config")
    api.shutdown()
    api.init(num_cpus=4, _system_config={"tracing_enabled": True})
    try:
        return {name: fn(pkg, api, tmp) for name, fn in CASES.items()}
    finally:
        api.shutdown()
        config.clear_override("tracing_enabled")


def _jax_run(tmp):
    import cloudpickle
    module = sys.modules[__name__]
    cloudpickle.register_pickle_by_value(module)
    try:
        return _run_all("ray_tpu", tmp)
    finally:
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
            result = compute(str(tmp))
            with open(base / f"{name}.part", "wb") as f:
                pickle.dump(result, f)
            os.replace(base / f"{name}.part", path)
    with open(path, "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    want = _once(tmp_path_factory, "torch_state_jax", _jax_run)
    return want, _run_all("ray_tpu_torch", str(tmp_path_factory.mktemp("st")))


@pytest.mark.parametrize("case", sorted(CASES))
def test_state_case_gives_the_jax_result(runs, case):
    want, got = runs
    assert got[case] == want[case]


def test_the_jax_results_meet_the_jax_tests(runs):
    """The JAX run passes its own tests' assertions, so equality above
    holds the port to them."""
    want, _ = runs
    assert want["state_lists"]["nodes"][:2] == (1, "ALIVE")
    assert want["state_lists"]["actor"][0] == 1
    assert want["state_lists"]["task"][0] and want["state_lists"]["summary"][0]
    assert want["state_lists"]["objects"] == (1, True)
    assert want["timeline_dump"] == {"list": True, "ts_dur": True}
    assert all(want["metrics_registry_and_prometheus"].values())
    assert want["placement_group_listing"]["listed"] == 1
    assert want["profile_worker_via_state_api"] == {
        "dump": True, "spin": True, "bad_pid": "ValueError"}
    assert want["dashboard_spans_and_profile_endpoints"]["spans"]
    dash = want["dashboard_endpoints"]
    assert dash["marker"] == 1 and dash["page"] == (200, True)
    assert dash["cluster"][0] == 4.0
    assert dash["nodes"][0] == 1 and dash["actors"][0] == 1
    assert dash["jobs"][0] == 1 and dash["objects"] == 1
    assert dash["metrics"] == 200
