"""The port's job submission, log streaming and job events against the JAX
package's (``tests/test_jobs_and_logs.py``'s five cases and
``tests/test_cluster_events.py::test_job_events``).

Each case is a program over a package and its cluster's address that
returns what the JAX test asserts on (statuses, whether the logs hold the
printed lines, whether the event carries the job's id). It runs first on a
JAX ``Cluster`` (once per test run, ``_once``, shut down before the port's),
then on one port ``Cluster`` shared by this module; the results must be
equal, and equal to the JAX test's expectations. Entrypoints are short
``python -c`` scripts, as in the JAX tests. This module imports JAX only
inside functions: the port's workers import it by name.
"""

import fcntl
import importlib
import os
import pickle
import sys
import time

import pytest


def chatty():
    print("WORKER-SAYS-banana", flush=True)
    return 1


def _client(pkg, address):
    js = importlib.import_module(f"{pkg}.job_submission")
    return js, js.JobSubmissionClient(address)


def case_submit_status_logs(pkg, address):
    js, client = _client(pkg, address)
    sid = client.submit_job(
        entrypoint=f"{sys.executable} -c \"print('hello from job'); "
                   f"print('line two')\"")
    first = client.get_job_status(sid)
    status = client.wait_until_finish(sid, timeout=60)
    logs = client.get_job_logs(sid)
    return {"first_status_known": first in (js.JobStatus.PENDING,
                                            js.JobStatus.RUNNING,
                                            js.JobStatus.SUCCEEDED),
            "status": status,
            "logs": "hello from job" in logs and "line two" in logs,
            "listed": any(j.submission_id == sid
                          for j in client.list_jobs()),
            "info_status": client.get_job_info(sid).status}


def case_failure_reported(pkg, address):
    js, client = _client(pkg, address)
    sid = client.submit_job(
        entrypoint=f"{sys.executable} -c \"import sys; "
                   f"print('about to fail'); sys.exit(3)\"")
    return {"status": client.wait_until_finish(sid, timeout=60),
            "message": "code 3" in client.get_job_info(sid).message,
            "logs": "about to fail" in client.get_job_logs(sid)}


def case_stop(pkg, address):
    js, client = _client(pkg, address)
    sid = client.submit_job(
        entrypoint=f"{sys.executable} -c \"import time; time.sleep(60)\"")
    deadline = time.monotonic() + 30
    while (client.get_job_status(sid) != js.JobStatus.RUNNING
           and time.monotonic() < deadline):
        time.sleep(0.1)
    running = client.get_job_status(sid) == js.JobStatus.RUNNING
    return {"running": running, "stopped": client.stop_job(sid),
            "status": client.wait_until_finish(sid, timeout=30)}


def case_tail_follow(pkg, address):
    js, client = _client(pkg, address)
    sid = client.submit_job(
        entrypoint=f"{sys.executable} -u -c \"import time\n"
                   f"for i in range(5):\n"
                   f"    print('tick', i, flush=True)\n"
                   f"    time.sleep(0.1)\"")
    text = "".join(client.tail_job_logs(sid))
    return {"ticks": all(f"tick {i}" in text for i in range(5)),
            "status": client.get_job_status(sid)}


def case_worker_logs_reach_conductor_channel(pkg, address):
    """Daemons tail worker stdout and publish to the conductor's log
    channel (the stream drivers subscribe to)."""
    api = importlib.import_module(pkg)
    get_client = importlib.import_module(
        f"{pkg}.cluster.protocol").get_client
    api.init(address=address)
    try:
        value = api.get(api.remote(chatty).remote(), timeout=60)
        cli = get_client(address)
        deadline = time.monotonic() + 15
        seen, seq = False, 0
        while time.monotonic() < deadline and not seen:
            resp = cli.call("poll_logs", after_seq=seq, timeout=1.0)
            seq = resp["seq"]
            seen = any("WORKER-SAYS-banana" in ln.get("line", "")
                       for ln in resp["lines"])
        return {"value": value, "seen": seen}
    finally:
        api.shutdown()


def case_job_events(pkg, address):
    js, client = _client(pkg, address)
    get_client = importlib.import_module(
        f"{pkg}.cluster.protocol").get_client

    def events():
        return [e for e in get_client(address).call("list_events")
                if e["event_type"] == "JOB_SUCCEEDED"
                and e["metadata"].get("submission_id") == sid]

    sid = client.submit_job(
        entrypoint=f"{sys.executable} -c \"print('evt')\"")
    client.wait_until_finish(sid, timeout=60)
    deadline = time.time() + 10
    while time.time() < deadline and not events():
        time.sleep(0.2)
    evs = events()
    return {"event": bool(evs), "source": bool(evs) and
            evs[0]["source"].startswith("daemon-")}


CASES = {name[len("case_"):]: fn for name, fn in globals().items()
         if name.startswith("case_")}

WANT = {
    "submit_status_logs": {"first_status_known": True, "status": "SUCCEEDED",
                           "logs": True, "listed": True,
                           "info_status": "SUCCEEDED"},
    "failure_reported": {"status": "FAILED", "message": True, "logs": True},
    "stop": {"running": True, "stopped": True, "status": "STOPPED"},
    "tail_follow": {"ticks": True, "status": "SUCCEEDED"},
    "worker_logs_reach_conductor_channel": {"value": 1, "seen": True},
    "job_events": {"event": True, "source": True},
}


def _run_all(pkg):
    cu = importlib.import_module(f"{pkg}.cluster.cluster_utils")
    c = cu.Cluster(initialize_head=True, head_node_args={"num_cpus": 4})
    try:
        return {name: fn(pkg, c.address) for name, fn in CASES.items()}
    finally:
        c.shutdown()


def _jax_run():
    import cloudpickle

    import ray_tpu
    module = sys.modules[__name__]
    cloudpickle.register_pickle_by_value(module)
    ray_tpu.shutdown()
    try:
        return _run_all("ray_tpu")
    finally:
        cloudpickle.unregister_pickle_by_value(module)


def _once(tmp_path_factory, name, compute):
    """``compute()`` once for the whole run, shared by the xdist workers
    through a pickle under the run's temporary root."""
    base = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        base = base.parent
    path = base / f"{name}.pkl"
    with open(base / f"{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not path.exists():
            result = compute()
            with open(base / f"{name}.part", "wb") as f:
                pickle.dump(result, f)
            os.replace(base / f"{name}.part", path)
    with open(path, "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    want = _once(tmp_path_factory, "torch_jobs_jax", _jax_run)
    import ray_tpu_torch
    ray_tpu_torch.shutdown()
    return want, _run_all("ray_tpu_torch")


@pytest.mark.parametrize("case", sorted(CASES))
def test_job_case_gives_the_jax_result(runs, case):
    want, got = runs
    assert want[case] == WANT[case], f"the JAX cluster gave {want[case]}"
    assert got[case] == want[case]
