"""Node daemon: per-node runtime (raylet equivalent).

Role parity: src/ray/raylet/node_manager.h:115 — grants worker leases
(node_manager.cc:1847 HandleRequestWorkerLease) with queueing and spillback,
runs the worker pool (worker_pool.h:156: spawn, startup-token handshake,
idle cache), reserves placement-group bundles via 2PC prepare/commit
(placement_group_resource_manager.h), serves node-to-node object transfer
in chunks (object_manager.h:117 push/pull path), and reports worker/actor
death to the conductor.

One daemon per node. It owns the node's shm object store (shmstored) the
way the raylet colocates plasma (plasma/store_runner.cc).

Where the port differs from ``ray_tpu/cluster/node_daemon.py``: the
accelerator is ``"GPU"``. The daemon hands each lease or actor that asks
for GPUs card indices of its own and starts its worker with
``CUDA_VISIBLE_DEVICES`` set to them (a share below one card goes to a
card whose free share still holds it, a partly used one first; a request
of whole cards takes only untouched ones); every other worker, and the
zygote, runs with ``CUDA_VISIBLE_DEVICES=""``, which is in their
environment before anything touches CUDA. Workers are pooled under their
environment key plus their card indices, so a worker whose CUDA is
initialised only ever serves leases on the same cards, and GPU workers
are spawned, never forked from the zygote. In place of the JAX daemon's
TPU slice (``tpu_slice``, ``detect_slice``), a node with cards reports its
NVLink domain (``gpu_domain``, ``gpu/topology.py:detect_domain``) at
registration, for the conductor's ``SLICE`` gang placement.
"""

from __future__ import annotations

import os
import pickle
import signal
import subprocess
import sys
import tempfile
import threading
import time
import uuid
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch import config
from ray_tpu_torch.cluster import fault_plane, object_client
from ray_tpu_torch.cluster.protocol import RpcServer, get_client
from ray_tpu_torch.util import events as _events
from ray_tpu_torch.util import lockcheck

CHUNK_SIZE = 8 << 20  # object transfer chunk (reference uses 5MiB chunks)


class _DaemonStopping(RuntimeError):
    """Raised by spawn paths once stop() begins tearing the session down;
    callers treat it as 'no worker available', never as a crash."""


class _ForkedProc:
    """Popen-compatible handle over a zygote-forked worker. The child's
    PARENT is the zygote (which SIG_IGNs SIGCHLD so the kernel reaps —
    no zombie pins the pid), so liveness is tracked through a pidfd: the
    fd references THIS process, so a recycled pid can never masquerade as
    the live worker. Falls back to signal-0 probing where pidfd is
    unavailable."""

    def __init__(self, pid: int):
        self.pid = pid
        self.returncode: Optional[int] = None
        self._pidfd = -1
        try:
            self._pidfd = os.pidfd_open(pid)
        except ProcessLookupError:
            # Already exited and kernel-reaped (the zygote SIG_IGNs
            # SIGCHLD, so the pid frees immediately). Falling back to
            # kill(pid, 0) here would let a RECYCLED pid make this dead
            # worker look alive indefinitely — record death now.
            self.returncode = 1
        except Exception:
            # pidfd unsupported (ENOSYS etc): signal-0 probing is the only
            # liveness signal available.
            pass

    def poll(self) -> Optional[int]:
        if self.returncode is not None:
            return self.returncode
        try:
            if self._pidfd >= 0:
                signal.pidfd_send_signal(self._pidfd, 0)
            else:
                os.kill(self.pid, 0)
            return None
        except ProcessLookupError:
            # Exit status unobservable (the kernel reaped the child);
            # report generic nonzero.
            self.returncode = 1
            if self._pidfd >= 0:
                os.close(self._pidfd)
                self._pidfd = -1
            return 1
        except PermissionError:
            return None

    def kill(self) -> None:
        try:
            if self._pidfd >= 0:
                signal.pidfd_send_signal(self._pidfd, signal.SIGKILL)
            else:
                os.kill(self.pid, signal.SIGKILL)
        except (ProcessLookupError, PermissionError, OSError):
            pass

    # Popen-interface stubs used by supervisors.
    def wait(self, timeout: Optional[float] = None) -> int:
        deadline = None if timeout is None else time.monotonic() + timeout
        while self.poll() is None:
            if deadline is not None and time.monotonic() >= deadline:
                raise subprocess.TimeoutExpired("forked-worker", timeout)
            time.sleep(0.02)
        return 1

    def terminate(self) -> None:
        try:
            if self._pidfd >= 0:
                signal.pidfd_send_signal(self._pidfd, signal.SIGTERM)
            else:
                os.kill(self.pid, signal.SIGTERM)
        except (ProcessLookupError, PermissionError, OSError):
            pass

    def __del__(self):
        if self._pidfd >= 0:
            try:
                os.close(self._pidfd)
            except Exception:
                # OSError, or AttributeError/TypeError during interpreter
                # shutdown (the os module may already be torn down).
                pass
            self._pidfd = -1


class _Worker:
    def __init__(self, proc, token: str, env_key: str):
        self.proc = proc
        self.token = token
        self.env_key = env_key
        self.started_at = time.monotonic()
        self.worker_id: Optional[bytes] = None
        self.address: Optional[str] = None
        self.pid = proc.pid
        self.registered = threading.Event()
        self.lease_id: Optional[str] = None
        self.actor_id: Optional[bytes] = None
        self.resources: Dict[str, float] = {}
        self.pg: Optional[Tuple[bytes, int]] = None
        self.actor_incarnation: int = -1
        self.idle_since: Optional[float] = None  # set while pooled idle
        self.gpu_ids: Tuple[int, ...] = ()  # cards this lease/actor took


_GPU_KEY = "|gpu="


def _gpu_env_key(env_key: str, gpu_ids: Tuple[int, ...]) -> str:
    """Pool key of a worker that sees exactly ``gpu_ids``."""
    if not gpu_ids:
        return env_key
    return env_key + _GPU_KEY + ",".join(str(i) for i in gpu_ids)


def _gpu_ids_of_key(key: str) -> Optional[Tuple[int, ...]]:
    """Card indices a pool key names, or None for a worker without."""
    if _GPU_KEY not in key:
        return None
    return tuple(int(i) for i in key.rsplit(_GPU_KEY, 1)[1].split(","))


class NodeDaemon:
    def __init__(self, conductor_address: str,
                 resources: Optional[Dict[str, float]] = None,
                 host: str = "127.0.0.1",
                 object_store_bytes: Optional[int] = None,
                 is_head: bool = False,
                 session_dir: Optional[str] = None,
                 env_vars: Optional[Dict[str, str]] = None,
                 gpu_domain: Optional[dict] = None):
        from ray_tpu_torch.core.ids import NodeID
        self.node_id = NodeID.from_random().binary()
        self.conductor_address = conductor_address
        self.is_head = is_head
        self._env_vars = dict(env_vars or {})
        if resources is None:
            import multiprocessing
            resources = {"CPU": float(multiprocessing.cpu_count())}
        resources = dict(resources)
        # Domain membership: advertised to the conductor so SLICE placement
        # groups land on the hosts of one NVLink domain.
        if gpu_domain is None and resources.get("GPU", 0) > 0:
            try:
                from ray_tpu_torch.gpu.topology import detect_domain
                gpu_domain = detect_domain()
            except Exception:
                gpu_domain = None
        self.gpu_domain = gpu_domain
        if gpu_domain is not None:
            # Typed per-generation resource next to the generic GPU count
            # (lets tasks target a generation, gpu_resources() role). Added
            # before total/_avail split so it is actually leasable.
            gen_key = f"GPU-{gpu_domain['generation']}"
            resources.setdefault(gen_key, resources.get("GPU", 0.0))
        self.total_resources = dict(resources)
        self._avail = dict(resources)
        # The free share of each card (1.0: untouched).
        self._gpu_share: List[float] = [
            1.0] * int(resources.get("GPU", 0.0))
        self._lock = lockcheck.named_lock("daemon.state")
        self._cv = threading.Condition(self._lock)
        self._owns_session_dir = session_dir is None
        self.session_dir = session_dir or tempfile.mkdtemp(prefix="rtpt-session-")
        os.makedirs(self.session_dir, exist_ok=True)
        # Hygiene: claim this session (so the sweep knows it's live) and
        # reclaim whatever dead sessions left behind before allocating shm.
        from ray_tpu_torch.cluster import hygiene
        hygiene.write_pidfile(self.session_dir)
        try:
            hygiene.sweep_stale()
        except Exception:
            pass  # best-effort; never block startup
        # --- object store (one shmstored per node) ---
        self.store_prefix = f"rtpt-{self.node_id.hex()[:8]}-"
        self.store_socket = os.path.join(
            self.session_dir, f"store-{self.node_id.hex()[:8]}.sock")
        spill_dir = os.path.join(self.session_dir, "spill")
        os.makedirs(spill_dir, exist_ok=True)
        if object_store_bytes is None:
            object_store_bytes = int(
                config.get("object_store_memory_mb")) << 20
        self.store_proc = object_client.start_store(
            self.store_socket, object_store_bytes, self.store_prefix,
            spill_dir=spill_dir)
        self.store = object_client.ShmClient(self.store_socket,
                                             self.store_prefix)
        # Daemon-owned ObjectPlane for r16 broadcast legs (pull_object
        # RPC); built lazily — most daemons never serve one.
        self._bcast_plane = None
        self._bcast_plane_lock = threading.Lock()
        # --- workers ---
        self._workers: Dict[str, _Worker] = {}     # token -> worker
        self._idle: Dict[str, deque] = {}          # env_key -> tokens
        self._leases: Dict[str, _Worker] = {}      # lease_id -> worker
        self._bundles: Dict[Tuple[bytes, int], Dict[str, float]] = {}
        self._bundle_state: Dict[Tuple[bytes, int], str] = {}  # PREPARED|COMMITTED
        self._bundle_used: Dict[Tuple[bytes, int], Dict[str, float]] = {}
        self._pending_demand: List[Dict[str, float]] = []
        self._pending_death_reports: List[dict] = []
        self._prestarting = 0
        # Worker zygote (fork server): started lazily on the first
        # default-env spawn; None until then, False after a failed start
        # (permanent fallback to subprocess spawn).
        self._zygote_proc = None
        self._zygote_socket = os.path.join(
            self.session_dir, f"zygote-{self.node_id.hex()[:8]}.sock")
        self._zygote_lock = threading.Lock()
        self._infeasible_recent: Dict[tuple, float] = {}
        self._actor_start_pool = None
        self._stopped = False
        self._jobs: Dict[str, dict] = {}   # submission_id -> {proc, log, ...}
        # In-progress sender-initiated pushes (push_manager.h receive side).
        self._push_partial: Dict[bytes, dict] = {}
        self._push_lock = threading.Lock()
        # Compiled-graph channel forwarder: attached shm writers for rings
        # whose reader lives on this node (rpc_channel_write).
        self._chan_writers: Dict[bytes, Any] = {}
        self._chan_lock = threading.Lock()
        # Chunk-serve load counters, piggybacked on object_info so pullers
        # spread a broadcast across the least-loaded holders.
        self._serve_lock = threading.Lock()
        self._serving_chunks = 0   # fetch_chunk handlers in flight
        self._served_chunks = 0    # cumulative chunks served
        # Chunk-serve view cache: oid -> [pinned view, last_use]. A 100MB
        # pull fetches ~13 chunks; re-running get_pinned per chunk costs a
        # store round trip + a fresh 100MB mmap + its page-fault storm
        # each time. Entries idle >5s are dropped by the reap loop (the
        # pin releases once the last reply frame holding a slice is GC'd).
        self._serve_views: Dict[bytes, list] = {}
        # Remote pins taken by same-host shm-direct pulls: oid -> [count,
        # last_touch]. Reaped after 60s so a crashed puller can't block
        # deletion/recycling of the segment forever.
        self._remote_pins: Dict[bytes, list] = {}
        self.server = RpcServer(self, host=host)
        self.address = self.server.address
        reg = get_client(conductor_address).call(
            "register_node", node_id=self.node_id, address=self.address,
            resources=self.total_resources, store_socket=self.store_socket,
            is_head=is_head, gpu_domain=self.gpu_domain)
        self._conductor_epoch = (reg or {}).get("epoch")
        # Flight recorder: the daemon ships its ring delta piggybacked on
        # the heartbeat (no second periodic conductor connection). In head
        # mode the driver's _finish_init upgrades this same process with a
        # background flusher.
        _events.configure(self.node_id, conductor_address,
                          start_flusher=False)
        self._hb_thread = threading.Thread(target=self._heartbeat_loop,
                                           daemon=True, name="daemon-hb")
        self._hb_thread.start()
        self._reap_thread = threading.Thread(target=self._reap_loop,
                                             daemon=True, name="daemon-reap")
        self._reap_thread.start()
        self._prestart_thread = threading.Thread(
            target=self._prestart_loop, daemon=True, name="daemon-prestart")
        self._prestart_thread.start()
        # Pre-warm the fork server so the first worker/actor burst doesn't
        # pay its ~0.3s import boot inline.
        threading.Thread(target=self._ensure_zygote, daemon=True,
                         name="zygote-warm").start()
        self._log_thread = threading.Thread(target=self._log_monitor_loop,
                                            daemon=True, name="daemon-logs")
        self._log_thread.start()
        # OOM protection (memory_monitor.h:52 + worker_killing_policy.h:34)
        self._oom_monitor = None
        self._last_oom_kill = 0.0
        threshold = config.get("memory_usage_threshold")
        if threshold > 0:
            from ray_tpu_torch.cluster import memory_monitor as mm
            self._oom_monitor = mm.MemoryMonitor(
                threshold, self._on_memory_pressure,
                usage_fn=mm.system_memory_usage_fraction,
                period_s=config.get("memory_monitor_refresh_ms") / 1000.0)
        # --- coordinated spill manager (local_object_manager.h role) ---
        # Watches store stats at the memory-monitor cadence; past the
        # spill threshold it writes cold unreferenced primaries through
        # the spill backend, reports URLs to the conductor (so the copy
        # survives this node), then evicts the shm copy.
        self._spill_backend = None
        self._spilled: Dict[bytes, tuple] = {}   # oid -> (url, size)
        self._spill_lock = threading.Lock()      # registry
        self._spill_write_lock = threading.Lock()  # one spiller at a time
        self._num_spilled = 0
        self._num_restored_serves = 0
        self._spill_thread = None
        if config.get("object_store_spill_threshold") > 0:
            from ray_tpu_torch.cluster.spill import SpillBackend
            root = config.get("object_spill_dir") or os.path.join(
                self.session_dir, "spill-coord")
            try:
                self._spill_backend = SpillBackend(root)
            except Exception:
                self._spill_backend = None  # bad root: spilling disabled
            if self._spill_backend is not None:
                self._spill_thread = threading.Thread(
                    target=self._spill_loop, daemon=True,
                    name="daemon-spill")
                self._spill_thread.start()

    def _on_memory_pressure(self, usage: float) -> None:
        """Kill one worker per pressure event (rate-limited): retriable
        task workers first, newest first — the submitter's existing
        fault-tolerance path retries the killed lease's tasks, which is
        the whole point (die-with-retry beats the OS OOM killer taking
        the daemon down)."""
        from ray_tpu_torch.cluster.memory_monitor import (WorkerKillingPolicy,
                                                    process_rss_bytes)
        now = time.monotonic()
        if now - self._last_oom_kill < 1.0:
            return
        with self._lock:
            candidates = [
                {"pid": w.pid, "worker": w,
                 "retriable": w.actor_id is None,
                 "started_at": w.started_at}
                for w in self._workers.values()
                if w.lease_id is not None or w.actor_id is not None]
        victim = WorkerKillingPolicy.pick(candidates)
        if victim is None:
            return
        self._last_oom_kill = now
        w = victim["worker"]
        try:
            get_client(self.conductor_address).call("push_logs", lines=[{
                "node": self.node_id.hex()[:8], "worker": "daemon",
                "line": f"OOM monitor: usage {usage:.2f} >= threshold; "
                        f"killing worker pid={w.pid} "
                        f"(rss={process_rss_bytes(w.pid) >> 20}MB, "
                        f"retriable={victim['retriable']})"}])
        except Exception:
            pass
        try:
            get_client(self.conductor_address).call(
                "report_event", severity="WARNING",
                source=f"daemon-{self.node_id.hex()[:8]}",
                event_type="OOM_WORKER_KILLED",
                message=f"memory usage {usage:.2f} over threshold; killed "
                        f"worker pid={w.pid} "
                        f"(retriable={victim['retriable']})",
                metadata={"pid": w.pid, "usage": usage,
                          "retriable": victim["retriable"]})
        except Exception:
            pass
        self._kill_worker(w)  # reaper reports lease/actor death

    # ------------------------------------------------------------------
    # coordinated spilling (parity: local_object_manager.h:61 — the
    # raylet component that spills primary copies past a usage threshold
    # and reports URLs so restores survive this node's death)
    # ------------------------------------------------------------------
    def _spill_loop(self) -> None:
        while not self._stopped:
            time.sleep(config.get("memory_monitor_refresh_ms") / 1000.0)
            try:
                self._maybe_spill()
            except Exception:
                pass  # store restarting / shutdown race: next tick retries

    def _maybe_spill(self) -> int:
        threshold = config.get("object_store_spill_threshold")
        if threshold <= 0 or self._spill_backend is None or self._stopped:
            return 0
        st = self.store.stats()
        cap = st.get("capacity", 0) or 1
        used = st.get("used", 0)
        if used / cap < threshold:
            return 0
        # Spill back down to the threshold in one pass (the high/low
        # watermark collapsed: the threshold is both trigger and target).
        return self._spill_bytes(max(int(used - threshold * cap), 1))

    def _spill_bytes(self, want: int) -> int:
        """Spill cold unreferenced sealed primaries until ~``want`` shm
        bytes are freed. Write-through ordering: backend write + conductor
        URL report happen BEFORE the shm copy is evicted, so there is
        never a moment with zero durable copies. Returns bytes freed."""
        if self._spill_backend is None:
            return 0
        freed = 0
        with self._spill_write_lock:
            try:
                cands = self.store.spill_candidates(want)
            except Exception:
                return 0
            for oid, size in cands:
                if freed >= want or self._stopped:
                    break
                with self._spill_lock:
                    have_copy = oid in self._spilled
                if not have_copy:
                    view = self.store.get(oid, timeout=0.0)
                    if view is None:
                        continue  # deleted since the candidate scan
                    try:
                        fault_plane.fire("object.spill.write", oid=oid,
                                         size=size)
                        url = self._spill_backend.write(oid, view)
                    except Exception:
                        self.store.release(oid)
                        continue  # backend write failed: keep shm copy
                    self.store.release(oid)
                    with self._spill_lock:
                        self._spilled[oid] = (url, size)
                        self._num_spilled += 1
                    _events.emit("object.spill.write", oid.hex(),
                                 value=float(size))
                    try:
                        get_client(self.conductor_address).call(
                            "add_spilled", oid=oid, url=url, size=size)
                    except Exception:
                        pass  # re-advertised by the heartbeat epoch replay
                # Durable copy exists: drop the shm copy. A refusal
                # (re-pinned since the scan) is fine — dual copies are
                # legal, the spill copy just waits for the next pass.
                try:
                    fault_plane.fire("object.evict", oid=oid)
                except Exception:
                    continue
                got = self.store.evict(oid)
                if got:
                    freed += got
                    _events.emit("object.evict", oid.hex(),
                                 value=float(got))
        return freed

    def rpc_spill_request(self, want_bytes: int) -> dict:
        """Put-side backpressure (spill-then-admit): an ObjectPlane whose
        create hit ST_OOM asks for room instead of failing the put."""
        if self._spill_backend is None:
            return {"freed": 0}
        return {"freed": self._spill_bytes(max(int(want_bytes), 1))}

    def _drop_spilled(self, oid: bytes) -> None:
        """Forget + delete this node's spill copy (object freed)."""
        with self._spill_lock:
            ent = self._spilled.pop(oid, None)
        if ent is not None:
            from ray_tpu_torch.cluster import spill as _spill
            _spill.delete_url(ent[0])

    def _read_spilled_chunk(self, oid: bytes, offset: int,
                            size: int) -> Optional[bytes]:
        """Serve a chunk of an object this daemon spilled straight from
        the spill file — no shm re-inflation (a remote pull of a cold
        object must not evict warm objects on THIS node to make room)."""
        with self._spill_lock:
            ent = self._spilled.get(oid)
        if ent is None:
            return None
        from ray_tpu_torch.cluster import spill as _spill
        fault_plane.fire("object.spill.restore", oid=oid, offset=offset)
        path = _spill.local_path(ent[0])
        try:
            if path is not None:
                with open(path, "rb") as f:
                    f.seek(offset)
                    data = f.read(size)
            else:
                data = _spill.read_url(ent[0])[offset:offset + size]
        except Exception:
            return None
        with self._spill_lock:
            self._num_restored_serves += 1
        return data

    # ------------------------------------------------------------------
    # heartbeat / membership
    # ------------------------------------------------------------------
    def _heartbeat_loop(self) -> None:
        cli = get_client(self.conductor_address)
        while not self._stopped:
            with self._lock:
                avail = dict(self._avail)
                demand = [dict(d) for d in self._pending_demand]
            try:
                resp = cli.call("heartbeat", node_id=self.node_id,
                                resources_available=avail,
                                pending_demand=demand,
                                events=_events.heartbeat_payload())
            except Exception:
                time.sleep(float(config.get("health_check_period_s")))
                continue
            epoch = resp.get("epoch")
            if resp.get("reregister") or (
                    epoch is not None and epoch != self._conductor_epoch):
                # Conductor restarted (new epoch) or lost us: re-register
                # and re-advertise this node's volatile state — its store
                # inventory (the object directory does not persist;
                # persistence.py docstring).
                try:
                    reg = cli.call(
                        "register_node", node_id=self.node_id,
                        address=self.address,
                        resources=self.total_resources,
                        store_socket=self.store_socket,
                        is_head=self.is_head, gpu_domain=self.gpu_domain)
                    oids = self.store.list_objects()
                    if oids:
                        cli.call("add_object_locations", oids=oids,
                                 node_id=self.node_id)
                    # Spill URLs are volatile conductor state too: replay
                    # them so restores survive a conductor failover.
                    with self._spill_lock:
                        spilled = dict(self._spilled)
                    for soid, (url, size) in spilled.items():
                        cli.call("add_spilled", oid=soid, url=url,
                                 size=size)
                    # Commit the epoch only once the WHOLE re-advertisement
                    # landed — a half-failed attempt must re-run next beat.
                    self._conductor_epoch = reg.get("epoch", epoch)
                except Exception:
                    pass
            self._flush_pending_death_reports(cli)
            time.sleep(float(config.get("health_check_period_s")))

    def _flush_pending_death_reports(self, cli) -> None:
        """Actor-death reports that failed (conductor downtime) retry on
        every heartbeat: with a persistent conductor a lost report would
        otherwise leave a journal-restored actor ALIVE at a dead address
        forever."""
        with self._lock:
            pending, self._pending_death_reports = \
                self._pending_death_reports, []
        for report in pending:
            try:
                cli.call("report_actor_death", **report)
            except Exception:
                with self._lock:
                    self._pending_death_reports.append(report)

    # ------------------------------------------------------------------
    # worker pool (parity: worker_pool.h:156)
    # ------------------------------------------------------------------
    def _env_key_of(self, runtime_env: Optional[dict]) -> str:
        from ray_tpu_torch.runtime_env import env_fingerprint
        return env_fingerprint(runtime_env)

    def _worker_base_env(self) -> Dict[str, str]:
        """Env shared by every default-env worker (and the zygote).

        Workers must not grab a card they were not leased: plain task
        workers (and the zygote they fork from) see none, through
        ``CUDA_VISIBLE_DEVICES=""`` set before anything touches CUDA; a
        GPU lease's worker gets its card indices in ``_spawn_worker``.
        Workers import the driver's modules by path, so they start with
        this process's ``sys.path``."""
        env = dict(os.environ)
        env.update(self._env_vars)
        # Ship live system-config overrides (worker_main.load_from_env
        # applies them): a chaos plan or flag flip set before the spawn
        # reaches every child worker, not just in-process planes.
        env.update(config.propagation_env())
        env["CUDA_VISIBLE_DEVICES"] = ""
        paths = [p for p in sys.path if p]
        prev = env.get("PYTHONPATH", "")
        if prev:
            paths.extend(p for p in prev.split(os.pathsep)
                         if p and p not in paths)
        env["PYTHONPATH"] = os.pathsep.join(paths)
        return env

    def _visible_gpu(self, idx: int) -> str:
        """The CUDA ordinal or UUID that card index ``idx`` names for a
        child, through this daemon's own ``CUDA_VISIBLE_DEVICES``."""
        own = self._env_vars.get("CUDA_VISIBLE_DEVICES",
                                 os.environ.get("CUDA_VISIBLE_DEVICES"))
        if own:
            ids = [x.strip() for x in own.split(",") if x.strip()]
            if idx < len(ids):
                return ids[idx]
        return str(idx)

    def _pick_gpus(self, resources: Dict[str, float]
                   ) -> Optional[Tuple[int, ...]]:
        """The cards ``_take_gpus`` would give ``resources`` now, or None
        when none fit. Caller holds self._lock. A share below one card goes
        to the partly used card with the least share left that still holds
        it, else to the lowest untouched card; whole cards are untouched
        ones only."""
        n = float(resources.get("GPU", 0.0))
        if n <= 0:
            return ()
        share = self._gpu_share
        if n < 1:
            fits = [(s >= 1.0 - 1e-9, s, i) for i, s in enumerate(share)
                    if s + 1e-9 >= n]
            return (min(fits)[2],) if fits else None
        k = int(n + 1 - 1e-9)
        whole = [i for i, s in enumerate(share) if s >= 1.0 - 1e-9]
        return tuple(whole[:k]) if len(whole) >= k else None

    def _take_gpus(self, resources: Dict[str, float]) -> Tuple[int, ...]:
        """Card indices for a lease or actor whose resources were just
        taken, their shares taken with them. Caller holds self._lock."""
        ids = self._pick_gpus(resources)
        if ids is None:
            raise RuntimeError(
                f"{resources.get('GPU')} GPU granted with no card to hold "
                f"it (free shares {self._gpu_share})")
        n = float(resources.get("GPU", 0.0))
        for i in ids:
            self._gpu_share[i] = (self._gpu_share[i] - n if n < 1 else 0.0)
        return ids

    def _give_gpus(self, resources: Dict[str, float],
                   ids: Tuple[int, ...]) -> None:
        """Return what ``_take_gpus`` took. Caller holds self._lock."""
        n = float(resources.get("GPU", 0.0))
        for i in ids:
            self._gpu_share[i] = (min(1.0, self._gpu_share[i] + n) if n < 1
                                  else 1.0)

    def _ensure_zygote(self):
        """Start (once) the fork server for default-env workers. Returns
        the zygote Popen, or None when unavailable (fallback: subprocess
        spawn). The zygote pays the ~0.25s worker-import cost once; each
        subsequent worker is a fork (~15ms) — the difference between 3/s
        and 25+/s actor creation on one host."""
        with self._zygote_lock:
            if self._zygote_proc is False:
                return None
            if self._zygote_proc is not None:
                if self._zygote_proc.poll() is None:
                    return self._zygote_proc
                self._zygote_proc = None  # died; restart below
            try:
                proc = subprocess.Popen(
                    [sys.executable, "-m", "ray_tpu_torch.cluster.worker_zygote",
                     "--socket", self._zygote_socket],
                    env=self._worker_base_env(),
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True)
                # Bounded handshake: a zygote hung in its pre-imports must
                # not wedge every _spawn_worker behind _zygote_lock — time
                # out, kill it, and fall back to subprocess spawn forever.
                import select
                ready, _, _ = select.select([proc.stdout], [], [], 60.0)
                line = proc.stdout.readline() if ready else ""
                if not line.startswith("ZYGOTE_READY"):
                    proc.kill()
                    self._zygote_proc = False
                    return None
                self._zygote_proc = proc
                return proc
            except Exception:
                self._zygote_proc = False
                return None

    def _fork_worker(self, argv: List[str], env: Dict[str, str],
                     log_path: str) -> Optional[_ForkedProc]:
        if self._ensure_zygote() is None:
            return None
        import json
        import socket as _socket
        try:
            s = _socket.socket(_socket.AF_UNIX, _socket.SOCK_STREAM)
            s.settimeout(10.0)
            s.connect(self._zygote_socket)
            # Only the DELTA env rides the request (the zygote already runs
            # under _worker_base_env); sending a full environ would mostly
            # be noise but is harmless — the child applies it wholesale.
            s.sendall(json.dumps({"argv": argv, "env": env, "cwd": None,
                                  "log": log_path}).encode() + b"\n")
            data = b""
            while not data.endswith(b"\n"):
                chunk = s.recv(4096)
                if not chunk:
                    return None
                data += chunk
            s.close()
            return _ForkedProc(json.loads(data)["pid"])
        except Exception:
            return None

    def _spawn_worker(self, env_key: str,
                      runtime_env: Optional[dict]) -> _Worker:
        if self._stopped:
            # Teardown fence: stop() is about to (or already did) rmtree the
            # session dir; spawning into it would die on the log-file open
            # with an unhandled FileNotFoundError in the start thread.
            raise _DaemonStopping("node daemon is stopping")
        fault_plane.fire("daemon.worker.spawn", env_key=env_key)
        token = uuid.uuid4().hex
        if env_key == "" and not runtime_env:
            # Default-env workers fork from the zygote when possible.
            argv = ["--conductor", self.conductor_address,
                    "--daemon", self.address,
                    "--store-socket", self.store_socket,
                    "--store-prefix", self.store_prefix,
                    "--node-id", self.node_id.hex(),
                    "--token", token]
            log_path = os.path.join(self.session_dir,
                                    f"worker-{token[:8]}.out")
            # Delta env over the zygote's baseline: overrides set AFTER the
            # zygote started (a freshly loaded fault plan) still reach the
            # forked child.
            proc = self._fork_worker(argv, config.propagation_env(),
                                     log_path)
            if proc is not None:
                w = _Worker(proc, token, env_key)
                with self._lock:
                    self._workers[token] = w
                return w
        env = self._worker_base_env()
        gpu_ids = _gpu_ids_of_key(env_key)
        if gpu_ids is not None:
            env["CUDA_VISIBLE_DEVICES"] = ",".join(
                self._visible_gpu(i) for i in gpu_ids)
        if runtime_env and runtime_env.get("env_vars"):
            env.update({str(k): str(v)
                        for k, v in runtime_env["env_vars"].items()})
        if runtime_env and runtime_env.get("py_modules"):
            # content-addressed unpack once per module version, then
            # PYTHONPATH (runtime-env agent role, _private/runtime_env/)
            from ray_tpu_torch.runtime_env import unpack_py_modules
            extra = unpack_py_modules(
                runtime_env["py_modules"],
                os.path.join(self.session_dir, "py_modules"))
            if extra:
                prev = env.get("PYTHONPATH", "")
                env["PYTHONPATH"] = (extra + os.pathsep + prev) if prev \
                    else extra
        cwd = None
        if runtime_env and runtime_env.get("working_dir"):
            cwd = runtime_env["working_dir"]
        py_exe = sys.executable
        if runtime_env and runtime_env.get("pip"):
            # venv per pip-spec hash (runtime-env agent role); the worker
            # runs on the venv interpreter so its installs are importable.
            from ray_tpu_torch.runtime_env import ensure_pip_env
            py_exe = ensure_pip_env(runtime_env["pip"], self.session_dir)
            # ray_tpu_torch itself rides PYTHONPATH into the venv interpreter.
            repo_root = os.path.dirname(os.path.dirname(os.path.dirname(
                os.path.abspath(__file__))))
            prev = env.get("PYTHONPATH", "")
            if repo_root not in prev.split(os.pathsep):
                env["PYTHONPATH"] = (repo_root + os.pathsep + prev) if prev \
                    else repo_root
        try:
            out = open(os.path.join(
                self.session_dir, f"worker-{token[:8]}.out"), "wb")
        except FileNotFoundError:
            # Session dir vanished between the _stopped check and the open:
            # teardown won the race; refuse to spawn into a dead session.
            raise _DaemonStopping("session dir removed (daemon stopping)")
        proc = subprocess.Popen(
            [py_exe, "-m", "ray_tpu_torch.cluster.worker_main",
             "--conductor", self.conductor_address,
             "--daemon", self.address,
             "--store-socket", self.store_socket,
             "--store-prefix", self.store_prefix,
             "--node-id", self.node_id.hex(),
             "--token", token],
            env=env, cwd=cwd,
            stdout=out,
            stderr=subprocess.STDOUT)
        w = _Worker(proc, token, env_key)
        with self._lock:
            self._workers[token] = w
        return w

    def rpc_register_worker(self, token: str, worker_id: bytes,
                            address: str, pid: int) -> dict:
        with self._cv:
            w = self._workers.get(token)
            if w is None:
                return {"ok": False}
            w.worker_id = worker_id
            w.address = address
            w.registered.set()
            self._cv.notify_all()
        return {"ok": True, "node_id": self.node_id}

    def _checkout_worker(self, env_key: str, runtime_env: Optional[dict],
                         timeout: float = 30.0,
                         idle_only: bool = False) -> Optional[_Worker]:
        if runtime_env and runtime_env.get("pip"):
            # Materialize the venv BEFORE the spawn deadline starts: first
            # builds can take longer than the checkout budget, and the
            # cached hit on the spawn path below is then instant.
            from ray_tpu_torch.runtime_env import ensure_pip_env
            ensure_pip_env(runtime_env["pip"], self.session_dir)
        while True:
            with self._lock:
                q = self._idle.get(env_key)
                w = None
                while q:
                    token = q.popleft()
                    cand = self._workers.get(token)
                    if cand is not None and cand.proc.poll() is None:
                        w = cand
                        w.idle_since = None
                        break
            if w is None:
                break
            # poll() can lag a dying process (a worker that just os._exit'd
            # may not be reaped yet); a ping confirms the RPC server is
            # actually accepting before we hand the lease out.
            try:
                get_client(w.address).call("ping", _timeout=2.0)
                return w
            except Exception:
                from ray_tpu_torch.cluster.protocol import drop_client
                drop_client(w.address)
                self._kill_worker(w)
        if idle_only:
            # Multi-grant extras: only instant (pooled/recycled) workers
            # qualify — a spawn would serialize ~200ms boots inside one
            # lease RPC and blow the caller's timeout.
            return None
        # No reusable idle worker: spawn, and keep respawning within the
        # deadline if a fresh worker dies before registering (under a chaos
        # kill storm every starting process is a target; one attempt per
        # lease would livelock the whole submitter).
        deadline = time.monotonic() + timeout
        while True:
            try:
                w = self._spawn_worker(env_key, runtime_env)
            except _DaemonStopping:
                return None
            while True:
                if w.registered.wait(0.05):
                    return w
                if w.proc.poll() is not None:
                    break  # died pre-registration; respawn below
                if time.monotonic() >= deadline:
                    try:
                        w.proc.kill()
                    except OSError:
                        pass
                    with self._lock:
                        self._workers.pop(w.token, None)
                    return None
            with self._lock:
                self._workers.pop(w.token, None)
            if time.monotonic() >= deadline:
                return None

    def _checkin_worker(self, w: _Worker, cap: Optional[int] = None) -> bool:
        """Return ``w`` to the idle pool; True if pooled, False if killed.
        ``cap`` overrides worker_pool_max_size (actor recycling pools far
        deeper than the spawn-side task cap)."""
        if cap is None:
            cap = config.get("worker_pool_max_size")
        with self._lock:
            if self._stopped or w.proc.poll() is not None:
                self._workers.pop(w.token, None)
                return False
            w.lease_id = None
            w.resources = {}
            w.gpu_ids = ()
            w.pg = None
            pool = self._idle.setdefault(w.env_key, deque())
            if len(pool) < cap:
                w.idle_since = time.monotonic()
                pool.append(w.token)
                return True
        self._kill_worker(w)
        return False

    def _kill_worker(self, w: _Worker) -> None:
        with self._lock:
            self._workers.pop(w.token, None)
        try:
            w.proc.kill()
        except OSError:
            pass

    def _prestart_loop(self) -> None:
        """Prestart workers against lease backlog (parity:
        node_manager.cc:1869 PrestartWorkers): while lease requests queue
        on resources/spawns, warm spare workers concurrently so grants
        don't serialize behind one-at-a-time process startup."""
        while not self._stopped:
            time.sleep(0.25)
            with self._lock:
                # Only FEASIBLE demand is backlog (infeasible shapes sit in
                # _pending_demand for the autoscaler; warming workers for
                # them would idle forever), and only the default-env pool
                # is prestartable (runtime-env workers need the lease's
                # env; the reference prestarts default workers the same
                # way) — so compare against _idle[""] alone.
                backlog = sum(
                    1 for d in self._pending_demand
                    if all(self.total_resources.get(k, 0.0) + 1e-9 >= v
                           for k, v in d.items()))
                idle = len(self._idle.get("", ()))
                cap = min(config.get("worker_pool_max_size"),
                          int(self.total_resources.get("CPU", 0)) or 1)
                # worker_pool_min_size keeps a warm floor of default-env
                # workers independent of backlog (boot-time prestart).
                floor = int(config.get("worker_pool_min_size"))
                want = min(max(backlog, floor) - idle - self._prestarting,
                           cap - len(self._workers))
                if want > 0:
                    self._prestarting += want
            for _ in range(max(0, want)):
                threading.Thread(target=self._prestart_one, daemon=True,
                                 name="worker-prestart").start()

    def _prestart_one(self) -> None:
        try:
            w = self._spawn_worker("", None)
            if w.registered.wait(15.0) and w.proc.poll() is None:
                with self._lock:
                    w.idle_since = time.monotonic()
                    self._idle.setdefault("", deque()).append(w.token)
                with self._cv:
                    self._cv.notify_all()
            else:
                self._kill_worker(w)
        except Exception:
            pass
        finally:
            with self._lock:
                self._prestarting -= 1

    def _reap_loop(self) -> None:
        """Detect dead workers: fail their leases / report actor death."""
        while not self._stopped:
            time.sleep(0.2)
            # Abandoned partial pushes (sender died mid-stream) are dropped
            # so a fresh push or pull can recreate the entry.
            with self._push_lock:
                now = time.monotonic()
                stale = [(o, st) for o, st in self._push_partial.items()
                         if now - st["ts"] > 30.0]
                for oid, _ in stale:
                    self._push_partial.pop(oid, None)
            for oid, st in stale:  # store I/O outside the push-dict lock
                try:
                    with st["lock"]:   # never close under a mid-flight
                        if st["buf"] is not None:  # chunk write
                            st["buf"].close()
                    self.store.delete(oid)
                except Exception:
                    pass
            # Idle chunk-serve views: dropping the entry lets the pinned
            # mapping GC (the finalize queues the store release), so the
            # object becomes deletable/evictable again.
            with self._serve_lock:
                now = time.monotonic()
                for oid in [o for o, e in self._serve_views.items()
                            if now - e[1] > 5.0]:
                    self._serve_views.pop(oid, None)
                leaked = [o for o, e in self._remote_pins.items()
                          if now - e[1] > 60.0]
                for oid in leaked:
                    self._remote_pins.pop(oid, None)
            for oid in leaked:  # puller died mid shm-direct copy
                try:
                    self.store.release(oid)
                except Exception:
                    pass
            # Idle-pool reaping: pooled workers idle past
            # worker_idle_timeout_s are killed oldest-first, keeping the
            # worker_pool_min_size warm floor in the default-env pool.
            idle_timeout = float(config.get("worker_idle_timeout_s"))
            expired: List[_Worker] = []
            if idle_timeout > 0:
                floor = int(config.get("worker_pool_min_size"))
                with self._lock:
                    now = time.monotonic()
                    for env_key, q in self._idle.items():
                        keep = floor if env_key == "" else 0
                        while len(q) > keep:
                            w = self._workers.get(q[0])
                            if w is None:
                                q.popleft()
                                continue
                            if w.idle_since is not None and \
                                    now - w.idle_since > idle_timeout:
                                q.popleft()
                                expired.append(w)
                            else:
                                break  # leftmost is the longest-idle
            for w in expired:
                self._kill_worker(w)
            dead: List[_Worker] = []
            with self._lock:
                for w in list(self._workers.values()):
                    if w.proc.poll() is not None:
                        dead.append(w)
                        self._workers.pop(w.token, None)
                        for q in self._idle.values():
                            try:
                                q.remove(w.token)
                            except ValueError:
                                pass
            for w in dead:
                exit_code = w.proc.returncode
                # Reap the dead worker's metrics snapshot: its KV entry is
                # keyed (node, pid) and nothing will ever refresh it again
                # (stale snapshots otherwise pollute /metrics forever).
                try:
                    get_client(self.conductor_address).call(
                        "kv_del", ns="metrics",
                        key=f"proc-{self.node_id.hex()}-{w.pid}".encode())
                except Exception:
                    pass
                if w.lease_id is not None:
                    self._release_lease_resources(w)
                if w.actor_id is not None:
                    report = {
                        "actor_id": w.actor_id,
                        "reason": f"worker process died (exit {exit_code})",
                        "incarnation": w.actor_incarnation,
                    }
                    # Free the crashed actor's reservation BEFORE reporting
                    # the death: the conductor reacts by rescheduling the
                    # restart incarnation, which on a full node can only
                    # place if the dead incarnation's resources are back in
                    # the pool (a leak here starved every restart for the
                    # whole 30s placement window, then failed the actor).
                    self._release_actor_resources(w)
                    try:
                        get_client(self.conductor_address).call(
                            "report_actor_death", **report)
                    except Exception:
                        # conductor down: the heartbeat loop re-delivers
                        with self._lock:
                            self._pending_death_reports.append(report)

    # ------------------------------------------------------------------
    # leases (parity: HandleRequestWorkerLease node_manager.cc:1847)
    # ------------------------------------------------------------------
    def _resource_pool_for(self, strategy: Any):
        """Returns (get_avail, take, give) closures for node or bundle pool."""
        if isinstance(strategy, dict) and strategy.get("type") == "pg":
            key = (strategy["pg_id"], max(0, strategy.get("bundle_index", 0)))
            def avail():
                reserved = self._bundles.get(key, {})
                used = self._bundle_used.setdefault(key, {})
                return {k: reserved.get(k, 0.0) - used.get(k, 0.0)
                        for k in reserved}
            def take(res):
                used = self._bundle_used.setdefault(key, {})
                for k, v in res.items():
                    used[k] = used.get(k, 0.0) + v
            def give(res):
                used = self._bundle_used.setdefault(key, {})
                for k, v in res.items():
                    used[k] = used.get(k, 0.0) - v
            return avail, take, give
        def avail():
            return self._avail
        def take(res):
            for k, v in res.items():
                self._avail[k] = self._avail.get(k, 0.0) - v
        def give(res):
            for k, v in res.items():
                self._avail[k] = self._avail.get(k, 0.0) + v
        return avail, take, give

    def rpc_request_lease(self, resources: Dict[str, float],
                          runtime_env: Optional[dict] = None,
                          strategy: Any = None,
                          wait_timeout: float = 5.0,
                          idle_only: bool = False) -> dict:
        """Grant a worker lease, queue until resources free (bounded wait),
        or reply infeasible so the caller spills to another node."""
        fault_plane.fire("daemon.lease.grant", idle_only=idle_only)
        resources = {k: v for k, v in resources.items() if v > 0}
        avail_fn, take, _ = self._resource_pool_for(strategy)
        deadline = time.monotonic() + wait_timeout
        demand_entry = dict(resources)
        with self._cv:
            # Infeasible on this node entirely -> immediate spillback hint.
            if not isinstance(strategy, dict) or strategy.get("type") != "pg":
                if any(self.total_resources.get(k, 0.0) + 1e-9 < v
                       for k, v in resources.items()):
                    # Register infeasible-here demand for the autoscaler,
                    # deduped per shape: spillback probes repeat every few
                    # hundred ms and must not stack into phantom demand.
                    shape_key = tuple(sorted(resources.items()))
                    now = time.monotonic()
                    if now - self._infeasible_recent.get(shape_key, 0) > 1.0:
                        self._infeasible_recent[shape_key] = now
                        self._pending_demand.append(demand_entry)
                        threading.Timer(1.0, self._drop_demand,
                                        (demand_entry,)).start()
                    return {"granted": False, "infeasible": True}
            self._pending_demand.append(demand_entry)
            try:
                while True:
                    a = avail_fn()
                    if all(a.get(k, 0.0) + 1e-9 >= v
                           for k, v in resources.items()) \
                            and self._pick_gpus(resources) is not None:
                        take(resources)
                        gpu_ids = self._take_gpus(resources)
                        break
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        return {"granted": False, "infeasible": False}
                    self._cv.wait(min(remaining, 0.5))
            finally:
                try:
                    self._pending_demand.remove(demand_entry)
                except ValueError:
                    pass
        env_key = _gpu_env_key(self._env_key_of(runtime_env), gpu_ids)
        from ray_tpu_torch.core.exceptions import RuntimeEnvSetupError
        try:
            w = self._checkout_worker(env_key, runtime_env, timeout=10.0,
                                      idle_only=idle_only)
        except RuntimeEnvSetupError as e:
            self._give_back(strategy, resources, gpu_ids)
            return {"granted": False, "env_error": str(e)}
        if w is None:
            self._give_back(strategy, resources, gpu_ids)
            return {"granted": False, "infeasible": False}
        lease_id = uuid.uuid4().hex
        with self._lock:
            w.lease_id = lease_id
            w.resources = resources
            w.gpu_ids = gpu_ids
            if isinstance(strategy, dict) and strategy.get("type") == "pg":
                w.pg = (strategy["pg_id"], max(0, strategy.get("bundle_index", 0)))
            self._leases[lease_id] = w
        return {"granted": True, "lease_id": lease_id,
                "worker_address": w.address, "worker_pid": w.pid,
                "node_id": self.node_id}

    def rpc_request_leases(self, resources: Dict[str, float],
                           count: int = 1,
                           runtime_env: Optional[dict] = None,
                           strategy: Any = None,
                           wait_timeout: float = 5.0) -> dict:
        """Multi-grant lease request: one round-trip for up to ``count``
        leases of the same shape. The first grant may wait the full
        ``wait_timeout``; extras come only from immediately free resources
        plus already-warm (pooled/recycled) workers, so the reply never
        serializes fresh process boots inside one RPC."""
        first = self.rpc_request_lease(resources, runtime_env, strategy,
                                       wait_timeout)
        if not first.get("granted"):
            return dict(first, leases=[])
        leases = [first]
        for _ in range(max(0, count - 1)):
            extra = self.rpc_request_lease(resources, runtime_env, strategy,
                                           wait_timeout=0.0, idle_only=True)
            if not extra.get("granted"):
                break
            leases.append(extra)
        return {"granted": True, "leases": leases, "node_id": self.node_id}

    def _give_back(self, strategy: Any,
                   resources: Dict[str, float],
                   gpu_ids: Tuple[int, ...] = ()) -> None:
        with self._cv:
            _, _, give = self._resource_pool_for(strategy)
            give(resources)
            self._give_gpus(resources, gpu_ids)
            self._cv.notify_all()

    def _drop_demand(self, entry: Dict[str, float]) -> None:
        with self._lock:
            try:
                self._pending_demand.remove(entry)
            except ValueError:
                pass

    def _release_lease_resources(self, w: _Worker) -> None:
        with self._cv:
            if w.lease_id is None:
                return
            self._leases.pop(w.lease_id, None)
            if w.pg is not None:
                used = self._bundle_used.setdefault(w.pg, {})
                for k, v in w.resources.items():
                    used[k] = used.get(k, 0.0) - v
            else:
                for k, v in w.resources.items():
                    self._avail[k] = self._avail.get(k, 0.0) + v
            self._give_gpus(w.resources, w.gpu_ids)
            w.lease_id = None
            w.resources = {}
            w.gpu_ids = ()
            w.pg = None
            self._cv.notify_all()

    def rpc_return_lease(self, lease_id: str) -> None:
        with self._lock:
            w = self._leases.get(lease_id)
        if w is None:
            return
        self._release_lease_resources(w)
        self._checkin_worker(w)

    # ------------------------------------------------------------------
    # actors (conductor -> daemon -> dedicated worker)
    # ------------------------------------------------------------------
    def rpc_start_actor(self, actor_id: bytes, spec: dict,
                        incarnation: int) -> dict:
        return self.rpc_start_actors([{"actor_id": actor_id, "spec": spec,
                                       "incarnation": incarnation}])

    def rpc_start_actors(self, items: List[dict]) -> dict:
        """Wave bring-up: members run on a BOUNDED pool instead of one
        thread per request — N unbounded concurrent fork+boots thrash a
        small host (measured: a 40-actor wave boots slower in aggregate
        than 8-at-a-time). An actor whose resources aren't immediately
        free detaches to its own waiting thread so it cannot plug a pool
        slot for up to its 30s resource deadline."""
        pool = self._actor_pool()
        for item in items:
            pool.submit(self._start_actor_pooled, item["actor_id"],
                        item["spec"], item["incarnation"])
        return {"ok": True, "count": len(items)}

    def _actor_pool(self):
        with self._lock:
            if self._stopped:
                raise _DaemonStopping("node daemon is stopping")
            if self._actor_start_pool is None:
                from concurrent.futures import ThreadPoolExecutor
                self._actor_start_pool = ThreadPoolExecutor(
                    max_workers=max(1, config.get("actor_start_pool_size")),
                    thread_name_prefix="start-actor")
            return self._actor_start_pool

    def _start_actor_pooled(self, actor_id: bytes, spec: dict,
                            incarnation: int) -> None:
        try:
            resources, strategy = self._actor_resources(spec)
            _, take, _ = self._resource_pool_for(strategy)
            with self._cv:
                a = self._resource_pool_for(strategy)[0]()
                ready = all(a.get(k, 0.0) + 1e-9 >= v
                            for k, v in resources.items()) \
                    and self._pick_gpus(resources) is not None
                if ready:
                    take(resources)
                    gpu_ids = self._take_gpus(resources)
            if ready:
                self._start_actor(actor_id, spec, incarnation,
                                  reserved=gpu_ids)
            else:
                threading.Thread(
                    target=self._start_actor, daemon=True,
                    args=(actor_id, spec, incarnation),
                    name=f"start-actor-{actor_id.hex()[:8]}").start()
        except Exception:
            pass  # per-actor failures are reported inside _start_actor

    @staticmethod
    def _actor_resources(spec: dict):
        opts = spec["opts"]
        resources = {k: v for k, v in
                     opts.get("resources_req", {"CPU": 1.0}).items() if v > 0}
        return resources, opts.get("scheduling_strategy")

    def _start_actor(self, actor_id: bytes, spec: dict, incarnation: int,
                     reserved: Optional[Tuple[int, ...]] = None) -> None:
        """Start an actor's worker. ``reserved`` is the card ids of an
        actor whose resources (and card shares) the caller already took;
        None waits here for them."""
        import pickle
        opts = spec["opts"]
        resources, strategy = self._actor_resources(spec)
        avail_fn, take, _ = self._resource_pool_for(strategy)
        cli = get_client(self.conductor_address)
        deadline = time.monotonic() + 30.0
        gpu_ids = reserved
        if reserved is None:
            timed_out = False
            with self._cv:
                while True:
                    a = avail_fn()
                    if all(a.get(k, 0.0) + 1e-9 >= v
                           for k, v in resources.items()) \
                            and self._pick_gpus(resources) is not None:
                        take(resources)
                        gpu_ids = self._take_gpus(resources)
                        break
                    if time.monotonic() >= deadline:
                        timed_out = True
                        break
                    self._cv.wait(0.5)
            if timed_out:
                # The failure report is a conductor RPC (with reconnect
                # retries) — it must run OUTSIDE the daemon state lock or
                # a slow conductor freezes every lease/heartbeat path.
                try:
                    cli.call("actor_creation_failed",
                             actor_id=actor_id,
                             incarnation=incarnation,
                             error_blob=pickle.dumps(RuntimeError(
                                 "insufficient resources for actor")))
                except Exception:
                    pass
                return
        from ray_tpu_torch.core.exceptions import RuntimeEnvSetupError
        try:
            w = self._checkout_worker(
                _gpu_env_key(self._env_key_of(opts.get("runtime_env")),
                             gpu_ids),
                opts.get("runtime_env"))
        except RuntimeEnvSetupError as e:
            # Deterministic env failure: free the reservation and fail the
            # actor's creation (callers holding refs see the error instead
            # of a forever-PENDING actor).
            self._give_back(strategy, resources, gpu_ids)
            try:
                cli.call("actor_creation_failed", actor_id=actor_id,
                         incarnation=incarnation,
                         error_blob=pickle.dumps(e))
            except Exception:
                pass
            return
        if w is None:
            self._give_back(strategy, resources, gpu_ids)
            try:
                cli.call("actor_creation_failed", actor_id=actor_id,
                         incarnation=incarnation,
                         error_blob=pickle.dumps(RuntimeError(
                             "failed to start a worker process")))
            except Exception:
                pass
            return
        with self._lock:
            w.actor_id = actor_id
            w.actor_incarnation = incarnation
            w.resources = resources
            w.gpu_ids = gpu_ids
            if isinstance(strategy, dict) and strategy.get("type") == "pg":
                w.pg = (strategy["pg_id"], max(0, strategy.get("bundle_index", 0)))
        try:
            resp = get_client(w.address).call(
                "create_actor", actor_id=actor_id, spec=spec,
                incarnation=incarnation)
        except Exception as e:
            self._release_actor_resources(w)
            self._kill_worker(w)
            # Infrastructure failure (worker process died under us) — this
            # consumes the restart FSM rather than permanently killing the
            # actor; only a user __init__ exception is terminal.
            try:
                cli.call("report_actor_death", actor_id=actor_id,
                         reason=f"actor worker unreachable during "
                                f"creation: {e}",
                         incarnation=incarnation)
            except Exception:
                pass
            return
        if not resp.get("ok"):
            # __init__ raised; the worker already reported the error to the
            # conductor — free the reservation and recycle the process.
            self._release_actor_resources(w)
            self._kill_worker(w)

    def _release_actor_resources(self, w: _Worker) -> None:
        with self._cv:
            if w.actor_id is None:
                return
            if w.pg is not None:
                used = self._bundle_used.setdefault(w.pg, {})
                for k, v in w.resources.items():
                    used[k] = used.get(k, 0.0) - v
            else:
                for k, v in w.resources.items():
                    self._avail[k] = self._avail.get(k, 0.0) + v
            self._give_gpus(w.resources, w.gpu_ids)
            w.actor_id = None
            w.resources = {}
            w.gpu_ids = ()
            self._cv.notify_all()

    def rpc_actor_exited(self, actor_id: bytes,
                         recycle: bool = False) -> dict:
        """Worker notifies a clean actor kill; free resources, then either
        RECYCLE the process into the idle pool or kill it. The worker only
        offers recycle=True after fully resetting its actor state, and
        os._exit()s unless we answer recycled=True. Recycling is what makes
        repeated actor waves cheap: the next creation checks out a warm
        process instead of paying fork + interpreter boot (~200ms, the
        dominant cost of a wave on a small host)."""
        with self._lock:
            target = None
            for w in self._workers.values():
                if w.actor_id == actor_id:
                    target = w
                    break
        if target is None:
            return {"recycled": False}
        self._release_actor_resources(target)
        if (recycle and target.env_key == ""
                and config.get("actor_worker_recycle")):
            cap = max(config.get("worker_pool_max_size"),
                      config.get("actor_recycle_pool_cap"))
            if self._checkin_worker(target, cap=cap):
                with self._cv:
                    self._cv.notify_all()
                return {"recycled": True}
            return {"recycled": False}
        self._kill_worker(target)
        return {"recycled": False}

    # ------------------------------------------------------------------
    # placement-group bundles (2PC; parity placement_group_resource_manager.h)
    # ------------------------------------------------------------------
    def rpc_prepare_bundle(self, pg_id: bytes, bundle_index: int,
                           resources: Dict[str, float]) -> bool:
        key = (pg_id, bundle_index)
        with self._cv:
            if key in self._bundles:
                return True  # idempotent retry
            if any(self._avail.get(k, 0.0) + 1e-9 < v
                   for k, v in resources.items()):
                return False
            for k, v in resources.items():
                self._avail[k] = self._avail.get(k, 0.0) - v
            self._bundles[key] = dict(resources)
            self._bundle_state[key] = "PREPARED"
            return True

    def rpc_commit_bundle(self, pg_id: bytes, bundle_index: int) -> bool:
        with self._lock:
            key = (pg_id, bundle_index)
            if key not in self._bundles:
                return False
            self._bundle_state[key] = "COMMITTED"
            return True

    def rpc_return_bundle(self, pg_id: bytes, bundle_index: int) -> None:
        key = (pg_id, bundle_index)
        with self._cv:
            res = self._bundles.pop(key, None)
            self._bundle_state.pop(key, None)
            self._bundle_used.pop(key, None)
            if res:
                for k, v in res.items():
                    self._avail[k] = self._avail.get(k, 0.0) + v
            self._cv.notify_all()
        # Kill workers still running in this bundle.
        victims = []
        with self._lock:
            for w in self._workers.values():
                if w.pg == key:
                    victims.append(w)
        for w in victims:
            if w.actor_id is not None:
                try:
                    get_client(self.conductor_address).call(
                        "report_actor_death", actor_id=w.actor_id,
                        reason="placement group removed",
                        incarnation=w.actor_incarnation)
                except Exception:
                    pass
            self._kill_worker(w)

    # ------------------------------------------------------------------
    # object transfer (parity: object_manager.h:117 chunked push/pull)
    # ------------------------------------------------------------------
    def rpc_object_info(self, oid: bytes) -> dict:
        view = self.store.get(oid, timeout=0.0)
        if view is None:
            with self._spill_lock:
                ent = self._spilled.get(oid)
            if ent is not None:
                # Spilled here: fetch_chunk serves from the spill file.
                # No shm_path — same-host pullers must take the chunk
                # path too (there is no segment to map).
                return {"found": True, "size": ent[1],
                        "transfers": self._serving_chunks,
                        "served": self._served_chunks,
                        "spilled": True}
            return {"found": False, "size": 0}
        size = view.nbytes
        self.store.release(oid)
        # transfers/served: this daemon's chunk-serve load, so pullers pick
        # the least-loaded holder (object_manager location-spread role).
        # shm_path: same-host pullers copy the segment directly instead of
        # streaming chunks (object_pull_shm_direct).
        return {"found": True, "size": size,
                "transfers": self._serving_chunks,
                "served": self._served_chunks,
                "shm_path": self.store._shm_path(oid)}

    def rpc_pull_object(self, oid: bytes,
                        sources: Optional[list] = None) -> dict:
        """Pull one object into this node's store NOW (r16 broadcast leg:
        the driver coordinates a tree of these, each member pulling from
        the holder the schedule assigned via ``sources``). Falls back to
        a directory locate when no sources are given or the assigned
        source cannot serve. Reuses the plane's full windowed-pull
        machinery — shm-direct same-host copies, striping, failover and
        its fault sites all apply to a broadcast leg."""
        plane = self._pull_plane()
        if self.store.contains(oid):
            return {"ok": True, "outcome": "local"}
        outcome = "error"
        if sources:
            nodes = [{"node_id": s.get("node_id"), "address": s["address"]}
                     for s in sources]
            outcome = plane._pull_from(oid, nodes)
            if outcome == "ok":
                return {"ok": True, "outcome": "ok"}
        try:
            loc = get_client(self.conductor_address).call(
                "locate_object", oid=oid, timeout=2.0)
        except Exception:  # noqa: BLE001
            return {"ok": False, "outcome": outcome}
        nodes = [n for n in loc.get("nodes", ())
                 if n["node_id"] != self.node_id]
        if nodes:
            outcome = plane._pull_from(oid, nodes)
        if outcome != "ok" and loc.get("spilled"):
            if plane._restore_spilled(oid, loc["spilled"],
                                      int(loc.get("spilled_size") or 0)):
                outcome = "ok"
        return {"ok": outcome == "ok", "outcome": outcome}

    def _pull_plane(self):
        """Lazily-built daemon-owned ObjectPlane (broadcast legs only —
        the daemon's normal serve path never needs one)."""
        with self._bcast_plane_lock:
            if self._bcast_plane is None:
                from ray_tpu_torch.cluster.object_plane import ObjectPlane
                self._bcast_plane = ObjectPlane(
                    self.store, self.node_id, self.conductor_address,
                    daemon_address=self.address)
            return self._bcast_plane

    def rpc_pin_object(self, oid: bytes) -> dict:
        """Hold a store reference on behalf of a same-host shm-direct
        puller, so the segment cannot be deleted or recycled while the
        puller copies it. Balanced by unpin_object; leaked pins (puller
        died mid-copy) are reaped after 60s."""
        with self._serve_lock:
            ent = self._remote_pins.get(oid)
            if ent is not None:
                ent[0] += 1
                ent[1] = time.monotonic()
                return {"ok": True}
        view = self.store.get(oid, timeout=0.0)
        if view is None:
            return {"ok": False}
        with self._serve_lock:
            ent = self._remote_pins.get(oid)
            if ent is None:
                self._remote_pins[oid] = [1, time.monotonic()]
                return {"ok": True}
            ent[0] += 1
            ent[1] = time.monotonic()
        self.store.release(oid)  # the existing entry's ref covers us
        return {"ok": True}

    def rpc_unpin_object(self, oid: bytes) -> dict:
        with self._serve_lock:
            ent = self._remote_pins.get(oid)
            if ent is None:
                return {"ok": False}
            ent[0] -= 1
            if ent[0] > 0:
                return {"ok": True}
            self._remote_pins.pop(oid, None)
        self.store.release(oid)
        return {"ok": True}

    def rpc_fetch_chunk(self, oid: bytes, offset: int, size: int):
        fault_plane.fire("daemon.chunk.serve", oid=oid, offset=offset)
        with self._serve_lock:
            self._serving_chunks += 1
            ent = self._serve_views.get(oid)
            view = None
            if ent is not None:
                ent[1] = time.monotonic()
                view = ent[0]
        try:
            if view is None:
                view = self.store.get_pinned(oid, timeout=0.0)
                if view is None:
                    chunk = self._read_spilled_chunk(oid, offset, size)
                    if chunk is not None:
                        with self._serve_lock:
                            self._served_chunks += 1
                        return chunk
                    raise KeyError(f"object {oid.hex()} not in store")
                with self._serve_lock:
                    if oid not in self._serve_views \
                            and len(self._serve_views) < 8:
                        self._serve_views[oid] = [view, time.monotonic()]
            # Zero-copy serve: the RPC reply's out-of-band frame path
            # sendmsg()s straight from the pinned shm mapping — no bytes()
            # materialization per chunk. The pin releases when the reply
            # frame (and its view) is garbage collected after send.
            buf = pickle.PickleBuffer(view[offset:offset + size])
            with self._serve_lock:
                self._served_chunks += 1
            return buf
        finally:
            with self._serve_lock:
                self._serving_chunks -= 1

    def rpc_push_chunk(self, oid: bytes, offset: int, total: int,
                       chunk: bytes, stream: Optional[str] = None) -> dict:
        """Receive one chunk of a sender-initiated push (push_manager.h
        role). The sender keeps a WINDOW of chunks pipelined, and the
        server dispatches pipelined frames on a pool — so chunks of one
        stream legally arrive OUT OF ORDER. The first to arrive creates
        the buffer; completion is by byte count, and the completing chunk
        seals + registers the location. Each push carries a
        sender-generated ``stream`` id: a chunk from a DIFFERENT stream
        than the in-progress one is rejected without touching that push
        (two senders racing must not destroy each other's partial writes).
        A concurrent local pull of the same object wins ties (create
        raises already-exists → reject the push; pull is the correctness
        path)."""
        with self._push_lock:  # guards the dict only — never I/O
            st = self._push_partial.get(oid)
            if st is None:
                # Claim the oid with an empty entry; the store create
                # happens below, outside this lock (store I/O must not
                # serialize every concurrent push through one mutex).
                st = self._push_partial[oid] = {
                    "buf": None, "got": set(), "bytes": 0, "total": total,
                    "stream": stream, "ts": time.monotonic(),
                    "lock": threading.Lock()}
            elif st.get("stream") != stream:
                return {"reject": True}  # another sender's push in progress
        with st["lock"]:
            if st["buf"] is None:
                if self.store.contains(oid):
                    with self._push_lock:
                        self._push_partial.pop(oid, None)
                    return {"done": True}
                try:
                    st["buf"] = self.store.create_writer(oid, total)
                except Exception:
                    with self._push_lock:
                        self._push_partial.pop(oid, None)
                    return {"done": True}  # being written by a pull
            if st["total"] != total:
                # Same stream claims a different object size (sender died
                # and resumed under the same id): abort the push and
                # DELETE the unsealed entry — an orphaned CREATED object
                # would wedge every future pull (create→already-exists,
                # get→never sealed).
                with self._push_lock:
                    self._push_partial.pop(oid, None)
                st["buf"].close()
                try:
                    self.store.delete(oid)
                except Exception:
                    pass
                return {"reject": True}
            if offset in st["got"]:
                # Duplicate of an already-applied chunk: the RPC layer's
                # at-least-once retry resent a chunk whose ack was lost.
                # Ack idempotently — aborting here would destroy our own
                # push.
                return {"ok": True}
            st["buf"].write_at(offset, chunk)
            st["got"].add(offset)
            st["bytes"] += len(chunk)
            st["ts"] = time.monotonic()
            if st["bytes"] < total:
                return {"ok": True}
            with self._push_lock:
                self._push_partial.pop(oid, None)
            st["buf"].close()
        try:
            self.store.seal(oid)
        except Exception:
            try:
                self.store.delete(oid)
            except Exception:
                pass
            return {"reject": True}
        try:
            get_client(self.conductor_address).call(
                "add_object_location", oid=oid, node_id=self.node_id)
        except Exception:
            pass  # location registration is best-effort; pulls re-register
        return {"done": True}

    # -- compiled-graph channel forwarder (dag/channel.py) ---------------

    def rpc_channel_write(self, chan_id: bytes, seq: int, data,
                          flags: int = 0,
                          timeout: Optional[float] = None) -> dict:
        """Forward a cross-host compiled-graph slot write into the local
        shm ring (the channel's reader lives on this node). Blocking is
        fine here: classic frames dispatch on the executor pool, and the
        ring itself provides the backpressure (a full ring means the
        consumer is max_in_flight behind)."""
        from ray_tpu_torch.dag.channel import ChannelError, ShmChannelWriter
        with self._chan_lock:
            w = self._chan_writers.get(chan_id)
        if w is None:
            try:
                w = ShmChannelWriter(self.store, chan_id)
            except ChannelError as e:
                return {"ok": False, "error": str(e)}
            with self._chan_lock:
                w = self._chan_writers.setdefault(chan_id, w)
        try:
            w.write(seq, data, int(flags), timeout=timeout)
        except ChannelError as e:
            return {"ok": False, "error": str(e)}
        return {"ok": True}

    def rpc_channel_close(self, chan_id: bytes) -> dict:
        with self._chan_lock:
            w = self._chan_writers.pop(chan_id, None)
        if w is not None:
            try:
                w.close()
            except Exception:
                pass
        return {"ok": True}

    def rpc_delete_object(self, oid: bytes) -> None:
        try:
            self.store.delete(oid)
        except Exception:
            pass
        self._drop_spilled(oid)

    def rpc_delete_objects(self, oids: List[bytes]) -> None:
        """Batched GC deletes (the conductor's free loop coalesces — a
        small-object churn otherwise turns into thousands of serial
        single-delete RPCs that monopolize the store's event loop)."""
        for oid in oids:
            try:
                self.store.delete(oid)
            except Exception:
                pass
            self._drop_spilled(oid)

    def rpc_store_stats(self) -> dict:
        return self.store.stats()

    # ------------------------------------------------------------------
    # jobs (parity: dashboard/modules/job/job_manager.py:507 — the head
    # node runs the entrypoint as a supervised subprocess; records live in
    # the conductor KV so they survive failover)
    # ------------------------------------------------------------------
    def _job_update(self, submission_id: str, **fields) -> None:
        import pickle
        cli = get_client(self.conductor_address)
        try:
            blob = cli.call("kv_get", ns="_jobs", key=submission_id.encode())
            rec = pickle.loads(blob) if blob else {"submission_id":
                                                   submission_id}
            rec.update(fields)
            cli.call("kv_put", ns="_jobs", key=submission_id.encode(),
                     value=pickle.dumps(rec))
        except Exception:
            pass

    def rpc_start_job(self, submission_id: str, entrypoint: str,
                      runtime_env: Optional[dict],
                      conductor_address: str) -> dict:
        # Idempotent by submission id: the client retries dispatch
        # at-least-once (a lost ACK must not double-start the entrypoint).
        with self._lock:
            existing = self._jobs.get(submission_id)
        if existing is not None:
            return {"ok": True, "log_path": existing["log"]}
        log_path = os.path.join(self.session_dir,
                                f"job-{submission_id}.log")
        env = dict(os.environ)
        env.update(self._env_vars)
        env["RAY_TPU_TORCH_ADDRESS"] = conductor_address
        if runtime_env and runtime_env.get("env_vars"):
            env.update({str(k): str(v)
                        for k, v in runtime_env["env_vars"].items()})
        if runtime_env and runtime_env.get("py_modules"):
            from ray_tpu_torch.runtime_env import unpack_py_modules
            extra = unpack_py_modules(
                runtime_env["py_modules"],
                os.path.join(self.session_dir, "py_modules"))
            if extra:
                prev = env.get("PYTHONPATH", "")
                env["PYTHONPATH"] = (extra + os.pathsep + prev) if prev \
                    else extra
        cwd = (runtime_env or {}).get("working_dir") or None
        logf = open(log_path, "wb")
        try:
            proc = subprocess.Popen(
                ["/bin/sh", "-c", entrypoint], env=env, cwd=cwd,
                stdout=logf, stderr=subprocess.STDOUT)
        except OSError as e:
            self._job_update(submission_id, status="FAILED",
                             message=str(e), end_time=time.time())
            return {"ok": False}
        finally:
            logf.close()  # the child holds its own dup of the fd
        with self._lock:
            self._jobs[submission_id] = {"proc": proc, "log": log_path,
                                         "stopped": False}
        self._job_update(submission_id, status="RUNNING",
                         start_time=time.time())
        threading.Thread(target=self._job_waiter, daemon=True,
                         args=(submission_id, proc),
                         name=f"job-{submission_id[:12]}").start()
        return {"ok": True, "log_path": log_path}

    def _job_waiter(self, submission_id: str, proc: subprocess.Popen) -> None:
        code = proc.wait()
        with self._lock:
            stopped = self._jobs.get(submission_id, {}).get("stopped")
        if stopped:
            status, msg = "STOPPED", "stopped by user"
        elif code == 0:
            status, msg = "SUCCEEDED", ""
        else:
            status, msg = "FAILED", f"entrypoint exited with code {code}"
        self._job_update(submission_id, status=status, message=msg,
                         end_time=time.time())
        try:
            get_client(self.conductor_address).call(
                "report_event",
                severity="INFO" if status == "SUCCEEDED" else "WARNING",
                source=f"daemon-{self.node_id.hex()[:8]}",
                event_type=f"JOB_{status}",
                message=f"job {submission_id} {status.lower()}"
                        + (f": {msg}" if msg else ""),
                metadata={"submission_id": submission_id})
        except Exception:
            pass

    def rpc_stop_job(self, submission_id: str) -> bool:
        with self._lock:
            job = self._jobs.get(submission_id)
            if job is None:
                return False
            job["stopped"] = True
        try:
            job["proc"].terminate()
        except OSError:
            pass
        return True

    def rpc_job_log(self, submission_id: str, offset: int = 0,
                    max_bytes: int = 1 << 20) -> dict:
        with self._lock:
            job = self._jobs.get(submission_id)
        path = job["log"] if job else os.path.join(
            self.session_dir, f"job-{submission_id}.log")
        try:
            with open(path, "rb") as f:
                f.seek(offset)
                data = f.read(max_bytes)
        except OSError:
            data = b""
        return {"data": data, "next_offset": offset + len(data)}

    # ------------------------------------------------------------------
    # worker-log tailer (parity: _private/log_monitor.py:104 — publish new
    # worker stdout/stderr lines to the conductor's log channel)
    # ------------------------------------------------------------------
    def _log_monitor_loop(self) -> None:
        import glob
        offsets: Dict[str, int] = {}
        cli = get_client(self.conductor_address)
        while not self._stopped:
            time.sleep(0.25)
            batch: List[dict] = []
            commits: List[tuple] = []   # (path, new_offset) — applied only
            # after a successful publish, so failures re-read not drop
            for path in glob.glob(os.path.join(self.session_dir,
                                               "worker-*.out")):
                try:
                    size = os.path.getsize(path)
                    off = offsets.get(path, 0)
                    if size <= off:
                        continue
                    with open(path, "rb") as f:
                        f.seek(off)
                        chunk = f.read(min(size - off, 1 << 20))
                except OSError:
                    continue  # this file vanished; others still ship
                # ship whole lines only; carry partials forward
                cut = chunk.rfind(b"\n")
                if cut < 0:
                    continue
                pid = os.path.basename(path)[len("worker-"):-len(".out")]
                for line in chunk[:cut].decode(errors="replace").splitlines():
                    batch.append({"node": self.node_id.hex()[:8],
                                  "worker": pid, "line": line})
                commits.append((path, off + cut + 1))
            if not batch:
                continue
            try:
                for i in range(0, len(batch), 1000):
                    cli.call("push_logs", lines=batch[i:i + 1000])
            except Exception:
                continue  # offsets not advanced: lines re-read next tick
            for path, new_off in commits:
                offsets[path] = new_off

    def rpc_ping(self) -> str:
        return "pong"

    def rpc_debug_state(self) -> dict:
        """Structured debug-state dump (raylet debug_state.txt role: the
        node manager's table sizes, pools, budgets — machine-readable)."""
        with self._lock:
            state = {
                "role": "daemon",
                "node_id": self.node_id.hex(),
                "pid": os.getpid(),
                "is_head": self.is_head,
                "resources_total": dict(self.total_resources),
                "resources_available": dict(self._avail),
                "workers": len(self._workers),
                "worker_pids": sorted(
                    w.pid for w in self._workers.values())[:128],
                "idle_workers": {k: len(q)
                                 for k, q in self._idle.items() if q},
                "leases": len(self._leases),
                "bundles": len(self._bundles),
                "pending_demand": len(self._pending_demand),
                "pending_death_reports": len(self._pending_death_reports),
                "prestarting": self._prestarting,
                "jobs": len(self._jobs),
            }
        with self._push_lock:
            state["push_partial"] = len(self._push_partial)
        with self._serve_lock:
            state["serve_views"] = len(self._serve_views)
            state["serving_chunks"] = self._serving_chunks
            state["served_chunks"] = self._served_chunks
            state["remote_pins"] = len(self._remote_pins)
        # Tiering lines (raylet debug_state.txt "Spilled/Restored/Evicted"
        # rows): coordinated registry + the store's own counters.
        with self._spill_lock:
            state["spilled_objects"] = len(self._spilled)
            state["spilled_bytes"] = sum(e[1]
                                         for e in self._spilled.values())
            state["num_spilled"] = self._num_spilled
            state["num_restored_serves"] = self._num_restored_serves
        try:
            st = self.store.stats()
            state["store"] = st
            state["Spilled"] = st.get("spills", 0)
            state["Restored"] = st.get("restores", 0)
            state["Evicted"] = st.get("evictions", 0)
        except Exception:
            pass
        return state

    def rpc_profile_worker(self, pid: int, duration_s: float = 1.0,
                           interval_s: float = 0.01) -> Optional[str]:
        """Profile the worker with this OS pid (None when the pid is not
        one of ours). Parity: the dashboard agent's py-spy trigger,
        reporter/profile_manager.py — here over the worker's RPC server."""
        with self._lock:
            target = next((w for w in self._workers.values()
                           if w.pid == pid and w.address), None)
        if target is None:
            return None
        return get_client(target.address).call(
            "profile", duration_s=duration_s, interval_s=interval_s,
            _timeout=float(duration_s) + 30.0)

    # ------------------------------------------------------------------
    def stop(self) -> None:
        self._stopped = True
        if self._oom_monitor is not None:
            self._oom_monitor.stop()
        with self._bcast_plane_lock:
            plane, self._bcast_plane = self._bcast_plane, None
        if plane is not None:
            plane.stop()
        with self._lock:
            pool, self._actor_start_pool = self._actor_start_pool, None
        if pool is not None:
            pool.shutdown(wait=False, cancel_futures=True)
        with self._lock:
            workers = list(self._workers.values())
            self._workers.clear()
        for w in workers:
            try:
                w.proc.kill()
            except OSError:
                pass
        with self._zygote_lock:
            z, self._zygote_proc = self._zygote_proc, False
        if z not in (None, False):
            try:
                z.kill()
            except OSError:
                pass
        self.server.stop()
        try:
            self.store.close()
            # SIGTERM first: lets the store unlink its segments (its
            # cleanup_all path); escalate only if it lingers.
            self.store_proc.terminate()
            try:
                self.store_proc.wait(timeout=2.0)
            except Exception:
                self.store_proc.kill()
                self.store_proc.wait()  # reap: no zombie for driver life
        except Exception:
            pass
        if self._owns_session_dir:
            import shutil
            shutil.rmtree(self.session_dir, ignore_errors=True)
