"""Worker zygote: pre-import the worker stack once, fork workers on demand.

Role parity: the reference's worker pool keeps actor/task latency down by
prestarting and caching worker PROCESSES (worker_pool.h:156); the cost it
cannot amortize is the interpreter+import price of each cold start. On a
host the Python worker stack costs ~0.25s to import — at that price a
burst of N actor creations serializes into N×0.25s of pure CPU. The zygote
pays the import once, then ``fork()`` produces a ready worker in ~15ms.

Protocol (newline-framed JSON over a unix socket, one request per
connection): {"argv": [...], "env": {...}, "cwd": null|str, "log": path}
-> {"pid": N}. The daemon treats a forked worker exactly like a spawned
one (same --token registration handshake); if the zygote is unavailable it
falls back to subprocess spawn.

Fork discipline: the zygote imports the worker modules but creates no
RPC clients or store connections (verified: importing worker_main starts
no threads), so the child inherits only clean module state. Its one
thread — the parent-death watchdog — holds no locks at any point, so
forking around it is safe (the thread simply doesn't exist in the child). The child closes the listener + request sockets, applies the
request env/cwd, redirects stdout/stderr to the worker log, and enters
``worker_main.main()``. SIGCHLD is ignored so exited workers are reaped by
the kernel (the daemon supervises worker liveness itself, by pid).

Ported from ``ray_tpu/cluster/worker_zygote.py``; the pre-imports moved into
``preimport()`` so a test can check them. The zygote and its children run
with ``CUDA_VISIBLE_DEVICES=""`` (node_daemon.py); workers that lease GPUs
are spawned, never forked.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import socket
import sys
import threading
import time


def _parent_watchdog(sock_path: str) -> None:
    """Exit when the spawning node daemon dies (SIGKILL included): a
    reparented zygote holds the imported worker stack (~150MB RSS) forever
    and nothing will ever ask it to fork again. getppid() flips to the
    reaper's pid on parent death — poll it (PR_SET_PDEATHSIG is
    thread-scoped in the parent and so unusable from a Popen'd child).
    Parity: worker-lifetime supervision, reference worker_pool.h:156."""
    ppid = os.getppid()
    while True:
        time.sleep(1.0)
        if os.getppid() != ppid:
            try:
                os.unlink(sock_path)
            except OSError:
                pass
            os._exit(0)  # rtcheck: allow-exit(orphaned zygote: parent daemon died, nothing to clean up)


def preimport():
    """Pay the import cost ONCE, before accepting fork requests — including
    the modules worker_main.main() imports lazily (runtime_cluster/api
    alone are ~75ms; leaving them to the child would erase most of the
    fork win). None of them imports torch or touches CUDA: a forked child
    must find CUDA uninitialised. Returns the worker_main module."""
    import ray_tpu_torch.core.api           # noqa: F401
    import ray_tpu_torch.core.runtime_cluster  # noqa: F401
    import ray_tpu_torch.cluster.worker_main as worker_main
    return worker_main


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--socket", required=True)
    args = ap.parse_args()

    threading.Thread(target=_parent_watchdog, args=(args.socket,),
                     daemon=True, name="parent-watchdog").start()

    worker_main = preimport()

    # Freeze the imported object graph into the permanent GC generation:
    # children never traverse it, so refcount/gc writes stop COW-faulting
    # the ~170MB of pre-imported module pages (the CPython zygote trick,
    # gc.freeze's documented purpose). Measurably cuts per-fork CPU on
    # single-core hosts and RSS growth everywhere.
    import gc
    gc.collect()
    gc.freeze()

    signal.signal(signal.SIGCHLD, signal.SIG_IGN)  # kernel reaps children
    srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    try:
        os.unlink(args.socket)
    except FileNotFoundError:
        pass
    srv.bind(args.socket)
    srv.listen(64)
    print("ZYGOTE_READY", flush=True)

    while True:
        try:
            conn, _ = srv.accept()
        except OSError:
            return
        try:
            data = b""
            while not data.endswith(b"\n"):
                chunk = conn.recv(65536)
                if not chunk:
                    break
                data += chunk
            if not data.strip():
                continue
            req = json.loads(data)
            pid = os.fork()
            if pid == 0:
                # -- child: become the worker ---------------------------
                try:
                    srv.close()
                    conn.close()
                    os.environ.update(req.get("env") or {})
                    if req.get("cwd"):
                        os.chdir(req["cwd"])
                    log_fd = os.open(req["log"],
                                     os.O_CREAT | os.O_WRONLY | os.O_APPEND,
                                     0o644)
                    os.dup2(log_fd, 1)
                    os.dup2(log_fd, 2)
                    os.close(log_fd)
                    signal.signal(signal.SIGCHLD, signal.SIG_DFL)
                    sys.argv = ["worker_main"] + list(req["argv"])
                    worker_main.main()
                except BaseException:  # noqa: BLE001 - child must not
                    import traceback   # return into the accept loop
                    traceback.print_exc()
                finally:
                    # rtcheck: allow-exit(forked child: must not unwind into the zygote accept loop)
                    os._exit(0)
            conn.sendall(json.dumps({"pid": pid}).encode() + b"\n")
        except Exception:
            pass  # a malformed request must not kill the zygote
        finally:
            try:
                conn.close()
            except Exception:
                pass


if __name__ == "__main__":
    main()
