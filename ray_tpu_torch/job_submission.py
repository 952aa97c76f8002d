"""Job submission: run an entrypoint script on the cluster, track it, and
stream its logs. Ported from ``ray_tpu/job_submission.py``.

Role parity: dashboard/modules/job/job_manager.py:507 (JobManager.submit_job
— spawn the entrypoint as a head-node subprocess, monitor it, persist a job
record) and python/ray/dashboard/modules/job/sdk.py (JobSubmissionClient).
The job table lives in the conductor KV (namespace ``_jobs``), so records
survive conductor failover along with the rest of the durable state;
execution + log capture happen on the head node's daemon
(cluster/node_daemon.py rpc_start_job / rpc_job_log).

The entrypoint runs with ``RAY_TPU_TORCH_ADDRESS`` set to the conductor's
address; a job connects with ``init(address=os.environ[
"RAY_TPU_TORCH_ADDRESS"])``, as ``init()`` reads no such variable.
"""

from __future__ import annotations

import pickle
import time
import uuid
from typing import Any, Dict, Iterator, List, Optional

from ray_tpu_torch.cluster.protocol import get_client

JOBS_NS = "_jobs"


class JobStatus:
    PENDING = "PENDING"
    RUNNING = "RUNNING"
    SUCCEEDED = "SUCCEEDED"
    FAILED = "FAILED"
    STOPPED = "STOPPED"

    TERMINAL = (SUCCEEDED, FAILED, STOPPED)


class JobDetails:
    def __init__(self, rec: dict):
        self.submission_id = rec["submission_id"]
        self.entrypoint = rec["entrypoint"]
        self.status = rec["status"]
        self.message = rec.get("message", "")
        self.start_time = rec.get("start_time")
        self.end_time = rec.get("end_time")
        self.metadata = rec.get("metadata") or {}
        self.driver_node_id = rec.get("node_id")

    def __repr__(self):
        return (f"JobDetails(submission_id={self.submission_id!r}, "
                f"status={self.status})")


class JobSubmissionClient:
    """Submit/inspect/stop jobs against a running cluster."""

    def __init__(self, address: str):
        self._address = address
        self._conductor = get_client(address)

    # -- helpers --------------------------------------------------------
    def _head_daemon(self) -> dict:
        nodes = [n for n in self._conductor.call("get_nodes") if n["alive"]]
        heads = [n for n in nodes if n.get("is_head")]
        if not heads and not nodes:
            raise RuntimeError("no live nodes to run the job on")
        return (heads or nodes)[0]

    def _record(self, submission_id: str) -> dict:
        blob = self._conductor.call("kv_get", ns=JOBS_NS,
                                    key=submission_id.encode())
        if blob is None:
            raise ValueError(f"no job with submission_id {submission_id!r}")
        return pickle.loads(blob)

    # -- API (sdk.py parity surface) ------------------------------------
    def submit_job(self, *, entrypoint: str,
                   submission_id: Optional[str] = None,
                   runtime_env: Optional[dict] = None,
                   metadata: Optional[Dict[str, str]] = None) -> str:
        submission_id = submission_id or f"rtpt-job-{uuid.uuid4().hex[:10]}"
        if runtime_env is not None:
            from ray_tpu_torch.runtime_env import validate_runtime_env
            runtime_env = validate_runtime_env(runtime_env)
        node = self._head_daemon()
        rec = {
            "submission_id": submission_id,
            "entrypoint": entrypoint,
            "status": JobStatus.PENDING,
            "submit_time": time.time(),
            "metadata": metadata or {},
            "runtime_env": runtime_env,
            "node_id": node["node_id"].hex(),
        }
        self._conductor.call("kv_put", ns=JOBS_NS,
                             key=submission_id.encode(),
                             value=pickle.dumps(rec), overwrite=False)
        # Retry transient dispatch failures against a fresh node pick: the
        # chosen daemon may be a not-yet-health-timed-out corpse or
        # briefly unreachable on a loaded host. The job record is already
        # durable in KV and the daemon dedupes start_job by id, so
        # at-least-once dispatch is safe. The record's node_id follows
        # the node that ACTUALLY took the job (log lookups key on it).
        deadline = time.time() + 30.0
        while True:
            try:
                get_client(node["address"]).call(
                    "start_job", submission_id=submission_id,
                    entrypoint=entrypoint, runtime_env=runtime_env,
                    conductor_address=self._address)
                break
            except (ConnectionError, OSError):
                if time.time() >= deadline:
                    raise
                time.sleep(0.5)
                node = self._head_daemon()
        if node["node_id"].hex() != rec["node_id"]:
            # Re-read first: the daemon may have already bumped status.
            cur = self._record(submission_id)
            cur["node_id"] = node["node_id"].hex()
            self._conductor.call("kv_put", ns=JOBS_NS,
                                 key=submission_id.encode(),
                                 value=pickle.dumps(cur), overwrite=True)
        return submission_id

    def get_job_status(self, submission_id: str) -> str:
        return self._record(submission_id)["status"]

    def get_job_info(self, submission_id: str) -> JobDetails:
        return JobDetails(self._record(submission_id))

    def list_jobs(self) -> List[JobDetails]:
        out = []
        for key in self._conductor.call("kv_keys", ns=JOBS_NS):
            blob = self._conductor.call("kv_get", ns=JOBS_NS, key=key)
            if blob is not None:
                out.append(JobDetails(pickle.loads(blob)))
        return sorted(out, key=lambda j: j.submission_id)

    def stop_job(self, submission_id: str) -> bool:
        rec = self._record(submission_id)
        node_hex = rec.get("node_id")
        for n in self._conductor.call("get_nodes"):
            if n["node_id"].hex() == node_hex and n["alive"]:
                return get_client(n["address"]).call(
                    "stop_job", submission_id=submission_id)
        return False

    def delete_job(self, submission_id: str) -> bool:
        rec = self._record(submission_id)
        if rec["status"] not in JobStatus.TERMINAL:
            raise RuntimeError("cannot delete a non-terminal job")
        return self._conductor.call("kv_del", ns=JOBS_NS,
                                    key=submission_id.encode())

    def get_job_logs(self, submission_id: str) -> str:
        rec = self._record(submission_id)
        node_hex = rec.get("node_id")
        for n in self._conductor.call("get_nodes"):
            if n["node_id"].hex() == node_hex and n["alive"]:
                data = get_client(n["address"]).call(
                    "job_log", submission_id=submission_id, offset=0,
                    max_bytes=16 << 20)
                return data["data"].decode(errors="replace")
        return ""

    def tail_job_logs(self, submission_id: str,
                      poll_s: float = 0.2) -> Iterator[str]:
        """Yield new log chunks until the job reaches a terminal state."""
        rec = self._record(submission_id)
        node_hex = rec.get("node_id")
        daemon = None
        for n in self._conductor.call("get_nodes"):
            if n["node_id"].hex() == node_hex and n["alive"]:
                daemon = get_client(n["address"])
        if daemon is None:
            return
        offset = 0
        while True:
            data = daemon.call("job_log", submission_id=submission_id,
                               offset=offset, max_bytes=1 << 20)
            if data["data"]:
                offset = data["next_offset"]
                yield data["data"].decode(errors="replace")
            else:
                status = self.get_job_status(submission_id)
                if status in JobStatus.TERMINAL:
                    return
                time.sleep(poll_s)

    def wait_until_finish(self, submission_id: str,
                          timeout: float = 300.0) -> str:
        deadline = time.monotonic() + timeout
        status = None
        while time.monotonic() < deadline:
            status = self.get_job_status(submission_id)
            if status in JobStatus.TERMINAL:
                return status
            time.sleep(0.2)
        raise TimeoutError(
            f"job {submission_id} still {status} after {timeout}s")
