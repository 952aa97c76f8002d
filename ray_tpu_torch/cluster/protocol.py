"""Control-plane RPC: length-prefixed pickle frames over TCP.

Role parity: src/ray/rpc/grpc_server.h / grpc_client.h — the reference wraps
gRPC; here the control plane is a small threaded RPC layer (the data plane
never goes through it: large objects move via the shm store and node-to-node
chunk streaming in node_daemon.py, and dense math moves over ICI via XLA
collectives).

Wire format: [4B little-endian length][payload] both ways. Two frame
shapes coexist on the request side:

- classic: ``(method, kwargs)`` — one in-flight request per connection,
  response ``(ok, payload)``. Clients pool one socket per concurrent caller.
- pipelined: ``(seq, method, kwargs)`` — many requests in flight per socket;
  the server dispatches each frame on a per-connection pool and replies
  ``(seq, ok, payload)`` in completion order, the client matches by seq
  (parity: gRPC HTTP/2 stream multiplexing, grpc_client.h).

``__batch__`` is a virtual method multiplexing N calls into one frame
(parity: the reference's batched GCS RPCs); it rides either frame shape.

Payload encoding: plain pickle (protocol 5, first byte 0x80), OR — when the
frame carries large binary data (object chunks: fetch_chunk replies,
push_chunk requests) — an out-of-band form (first byte 0x01) where every
``pickle.PickleBuffer`` ≥ _OOB_MIN_BYTES stays a separate segment:

    [0x01][u32 nbuf][u64 len]*nbuf [u32 pickle_len][pickle][buf 0][buf 1]...

The sender never copies those buffers into the pickle stream (they go
straight from the source mapping to ``sendmsg``), and the receiver hands
them out as zero-copy memoryviews over the received frame — the data-plane
analog of the reference shipping chunk payloads as raw gRPC bytes rather
than re-serializing them (object_manager.h chunk transfer).
"""

from __future__ import annotations

import itertools
import os
import pickle
import socket
import socketserver
import struct
import tempfile
import threading
import time
import weakref
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Tuple

from ray_tpu_torch.cluster import fault_plane
from ray_tpu_torch.util import events as _events

# Live pipelined channels, for the rt_rpc_inflight gauge and the slow-op
# watchdog's in-flight frame scan (both sampled by the event flusher —
# never on the request path).
_pipe_channels: "weakref.WeakSet" = weakref.WeakSet()

# rpc.frame ring events aggregate this many frames per event (a slow
# frame flushes the aggregate immediately) — per-frame emission at
# task-fast-path rates would dominate the flusher's fold/ship budget.
_FRAME_AGG = 16


def _rpc_inflight_probe() -> Dict[str, float]:
    n = 0
    for ch in list(_pipe_channels):
        n += len(ch._pending)
    return {"rt_rpc_inflight": float(n),
            "rt_rpc_channels": float(len(_pipe_channels))}


def _rpc_inflight_scan() -> List[tuple]:
    """(kind, ident, elapsed_s) for every in-flight pipelined frame — the
    watchdog's view of stuck RPCs, read from the channels' meta sidecars
    so the request path pays no watchdog registration."""
    out = []
    now = time.monotonic()
    for ch in list(_pipe_channels):
        with ch._lock:
            metas = list(ch._meta.values())
        out.extend(("rpc", m[2], now - m[0]) for m in metas)
    return out


_events.register_probe("rpc", _rpc_inflight_probe)
_events.register_inflight_scan("rpc", _rpc_inflight_scan)


def _uds_path(port: int) -> str:
    """Filesystem rendezvous for the same-host fast path: every server
    listening on 127.0.0.1:<port> ALSO listens on this Unix socket, and
    loopback clients prefer it (a UDS round trip skips the TCP/IP stack —
    measurably cheaper send syscalls on the task push ping-pong). The path
    is derived from the port alone so a client needs nothing beyond the
    ordinary host:port address to find it."""
    return os.path.join(tempfile.gettempdir(), f"rtpt-rpc-{port}.sock")


def _uds_enabled() -> bool:
    from ray_tpu_torch import config
    try:
        return bool(config.get("rpc_same_host_uds"))
    except Exception:
        return True


_frame_cap_gen: Optional[int] = None
_frame_cap_v = 0


def _frame_cap() -> int:
    """rpc_message_max_bytes, cached on the config generation (read per
    received frame — too hot for a raw config.get)."""
    global _frame_cap_gen, _frame_cap_v
    from ray_tpu_torch import config
    if _frame_cap_gen != config.generation:
        _frame_cap_v = int(config.get("rpc_message_max_bytes"))
        _frame_cap_gen = config.generation
    return _frame_cap_v


def _connect_timeout() -> float:
    from ray_tpu_torch import config
    try:
        return float(config.get("rpc_connect_timeout_s"))
    except Exception:
        return 10.0


class RpcError(Exception):
    pass


class ConnectionLost(RpcError):
    pass


class _PooledSocketDead(RpcError):
    """Internal: a cached keep-alive socket failed; retry on a fresh one."""


def _send_frame(sock: socket.socket, payload: bytes) -> None:
    sock.sendall(struct.pack("<I", len(payload)) + payload)


# Buffers at or above this size are shipped out-of-band (never copied into
# the pickle stream). Below it the copy is cheaper than the extra iovec.
_OOB_MIN_BYTES = 256 * 1024


def oob(data) -> Any:
    """Wrap a bytes-like for frame serialization: payloads at or above the
    out-of-band threshold ride as zero-copy iovec segments (the caller's
    buffer is sendmsg()'d directly); smaller ones pickle in-band, where
    the copy is cheaper than the extra segment. Used by bulk-payload call
    sites (compiled-graph channel_write frames) so they inherit whichever
    path is optimal without reimplementing the cutoff."""
    m = memoryview(data)
    if m.nbytes >= _OOB_MIN_BYTES:
        return pickle.PickleBuffer(m)
    return data if isinstance(data, bytes) else bytes(m)


def _dumps_parts(obj: Any) -> List[Any]:
    """Serialize to a list of buffer segments for scatter-send.

    Large ``pickle.PickleBuffer`` values inside ``obj`` stay zero-copy: the
    pickle stream only records a placeholder and the raw buffer rides the
    wire as its own segment (see the module docstring for the layout)."""
    bufs: List[memoryview] = []

    def _cb(pb: pickle.PickleBuffer) -> bool:
        # Truthy return = serialize in-band; falsy = keep out-of-band.
        try:
            view = pb.raw()
        except BufferError:
            return True  # non-contiguous: fall back in-band
        if view.nbytes < _OOB_MIN_BYTES:
            return True
        bufs.append(view)
        return False

    pkl = pickle.dumps(obj, protocol=5, buffer_callback=_cb)
    if not bufs:
        return [pkl]
    header = struct.pack("<BI", 1, len(bufs)) \
        + b"".join(struct.pack("<Q", v.nbytes) for v in bufs) \
        + struct.pack("<I", len(pkl))
    return [header, pkl, *bufs]


def _loads_frame(payload: Any) -> Any:
    """Inverse of _dumps_parts over one received frame payload.

    Out-of-band buffers come back as memoryviews over the receive buffer —
    no per-chunk copy between socket and consumer."""
    if not payload or payload[0] != 1:
        return pickle.loads(payload)
    mv = memoryview(payload)
    (nbuf,) = struct.unpack_from("<I", mv, 1)
    off = 5
    lens = struct.unpack_from("<%dQ" % nbuf, mv, off)
    off += 8 * nbuf
    (pklen,) = struct.unpack_from("<I", mv, off)
    off += 4
    pkl = mv[off:off + pklen]
    off += pklen
    bufs = []
    for n in lens:
        bufs.append(mv[off:off + n])
        off += n
    return pickle.loads(pkl, buffers=bufs)


def _send_parts(sock: socket.socket, parts: List[Any]) -> None:
    """Scatter-send [length][part0][part1]... without concatenating: one
    sendmsg per iovec batch straight from the source buffers (for chunk
    transfers that means directly out of the pinned shm mapping)."""
    if len(parts) == 1:
        # Plain frame (no out-of-band buffers) — the common control-plane
        # case: one small concat + sendall beats iovec bookkeeping.
        payload = parts[0]
        sock.sendall(struct.pack("<I", len(payload)) + payload)
        return
    views = [memoryview(p).cast("B") for p in parts]
    total = sum(v.nbytes for v in views)
    views.insert(0, memoryview(struct.pack("<I", total)))
    while views:
        sent = sock.sendmsg(views)
        while views and sent >= views[0].nbytes:
            sent -= views[0].nbytes
            views.pop(0)
        if views and sent:
            views[0] = views[0][sent:]


def _recv_exact(sock: socket.socket, n: int) -> bytearray:
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        r = sock.recv_into(view[got:], n - got)
        if not r:
            raise ConnectionLost("connection closed")
        got += r
    return buf


def _recv_frame(sock: socket.socket) -> bytearray:
    (length,) = struct.unpack("<I", _recv_exact(sock, 4))
    if length > _frame_cap():
        # A corrupt/malicious length prefix must not allocate gigabytes;
        # the connection is unrecoverable (stream offset is lost).
        raise ConnectionLost(
            f"frame length {length} exceeds rpc_message_max_bytes "
            f"({_frame_cap()})")
    return _recv_exact(sock, length)


def _dispatch(service: Any, method: str, kwargs: dict) -> Tuple[bool, Any]:
    """Resolve and run one method; exceptions become the payload."""
    try:
        # Fault point: delay/raise before serving (subsumes the old
        # _maybe_inject_delay / testing_rpc_delay_us hook). A raise here
        # ships to the caller as the call's error payload — a handler
        # failure, not a transport failure.
        fault_plane.fire("rpc.server.dispatch", method=method)
        if method == "__batch__":
            return True, [_dispatch(service, m, kw)
                          for m, kw in kwargs["calls"]]
        fn = getattr(service, "rpc_" + method, None)
        if fn is None:
            return False, RpcError(f"no such method: {method}")
        return True, fn(**kwargs)
    except SystemExit:
        raise
    except BaseException as e:  # noqa: BLE001 - shipped to caller
        return False, e


def _safe_dumps(resp: tuple) -> List[Any]:
    try:
        return _dumps_parts(resp)
    except Exception:
        # Replace the unpicklable payload, keep the frame shape (a seq
        # prefix must survive so pipelined callers still match it).
        err = RpcError("unpicklable response")
        fallback = resp[:-2] + (False, err)
        return [pickle.dumps(fallback, protocol=5)]


class _Handler(socketserver.BaseRequestHandler):
    def setup(self):
        self.server._conns.add(self.request)  # type: ignore[attr-defined]
        self._pool: Optional[ThreadPoolExecutor] = None
        self._send_lock = threading.Lock()

    def finish(self):
        self.server._conns.discard(self.request)  # type: ignore[attr-defined]
        if self._pool is not None:
            self._pool.shutdown(wait=False)

    def _respond(self, resp: tuple) -> None:
        parts = _safe_dumps(resp)
        with self._send_lock:
            _send_parts(self.request, parts)

    def _sever(self) -> None:
        try:
            self.request.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self.request.close()
        except OSError:
            pass

    def _run_pipelined(self, service: Any, seq: int, method: str,
                       kwargs: dict) -> None:
        ok, payload = _dispatch(service, method, kwargs)
        # Fault point: lose the reply after the handler ran — the
        # "committed but unacked" window every idempotent/deduped op must
        # survive. drop_reply loses just this frame; sever kills the whole
        # connection (and with it every pipelined call in flight).
        act = fault_plane.fire("rpc.server.reply", method=method)
        if act == "drop_reply":
            return
        if act == "sever":
            self._sever()
            return
        try:
            self._respond((seq, ok, payload))
        except OSError:
            pass  # peer gone; the read loop notices and exits

    def handle(self):
        sock = self.request
        if sock.family != socket.AF_UNIX:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        service = self.server.service  # type: ignore[attr-defined]
        while True:
            try:
                req = _recv_frame(sock)
            except (ConnectionLost, OSError):
                return
            try:
                frame = _loads_frame(req)
                if len(frame) == 3:
                    seq, method, kwargs = frame
                else:
                    seq, (method, kwargs) = None, frame
            except Exception:
                return
            if seq is not None:
                # Pipelined frame: normally dispatched off-thread so the
                # read loop keeps draining — a long-poll must not
                # head-of-line-block the requests queued behind it on this
                # socket. Services whose pipelined callers are strictly
                # request-at-a-time per channel (the worker: one in-flight
                # push per lease / per-actor ordered pushers) opt into
                # INLINE dispatch via ``rpc_inline_pipelined`` and skip
                # the executor handoff — a thread wake per push on the
                # task round-trip critical path.
                if getattr(service, "rpc_inline_pipelined", False):
                    self._run_pipelined(service, seq, method, kwargs)
                    continue
                if self._pool is None:
                    self._pool = ThreadPoolExecutor(
                        max_workers=16, thread_name_prefix="rpc-pipe")
                self._pool.submit(self._run_pipelined, service, seq,
                                  method, kwargs)
                continue
            # Classic frame: dispatch inline (no thread handoff on the
            # latency-critical single-call path).
            resp = _dispatch(service, method, kwargs)
            act = fault_plane.fire("rpc.server.reply", method=method)
            if act == "drop_reply":
                continue
            if act == "sever":
                self._sever()
                return
            try:
                self._respond(resp)
            except OSError:
                return


class _Server(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True

    def __init__(self, *args, **kwargs):
        self._conns: set = set()
        super().__init__(*args, **kwargs)


class _UnixServer(socketserver.ThreadingUnixStreamServer):
    allow_reuse_address = True
    daemon_threads = True

    def __init__(self, *args, **kwargs):
        self._conns: set = set()
        super().__init__(*args, **kwargs)


class RpcServer:
    """Serves ``rpc_*`` methods of a service object on host:port.

    Handlers run on a thread per connection; blocking inside a handler (e.g.
    a long-poll wait on a condition variable) only stalls that client.

    Alongside the TCP listener, the server binds a Unix socket at
    ``_uds_path(port)`` (same handler, same service): loopback clients
    connect there instead of through the TCP/IP stack. Failover-safe by
    the same port-takeover convention as TCP — a successor binding the
    port unlinks and re-binds the path.
    """

    def __init__(self, service: Any, host: str = "127.0.0.1", port: int = 0):
        self._srv = _Server((host, port), _Handler)
        self._srv.service = service  # type: ignore[attr-defined]
        self.host, self.port = self._srv.server_address[:2]
        self.address = f"{self.host}:{self.port}"
        self._thread = threading.Thread(
            target=self._srv.serve_forever, daemon=True,
            name=f"rpc-{type(service).__name__}")
        self._thread.start()
        self._usrv: Optional[_UnixServer] = None
        self._upath: Optional[str] = None
        if _uds_enabled():
            try:
                path = _uds_path(self.port)
                try:
                    os.unlink(path)   # stale socket from a dead predecessor
                except FileNotFoundError:
                    pass
                self._usrv = _UnixServer(path, _Handler)
                self._usrv.service = service  # type: ignore[attr-defined]
                self._upath = path
                threading.Thread(
                    target=self._usrv.serve_forever, daemon=True,
                    name=f"rpc-uds-{type(service).__name__}").start()
            except OSError:
                self._usrv = None   # TCP alone still serves everything

    def stop(self) -> None:
        try:
            self._srv.shutdown()
            self._srv.server_close()
        except OSError:
            pass
        if self._usrv is not None:
            try:
                self._usrv.shutdown()
                self._usrv.server_close()
            except OSError:
                pass
            try:
                if self._upath:
                    os.unlink(self._upath)
            except OSError:
                pass
        # Sever live connections too: a handler thread parked on recv would
        # otherwise keep serving this (dead) service's stale in-memory
        # state to clients holding pooled sockets — fatal for failover,
        # where a successor binds the same port.
        conns = list(self._srv._conns)
        if self._usrv is not None:
            conns += list(self._usrv._conns)
        for sock in conns:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                sock.close()
            except OSError:
                pass


class _PipeChannel:
    """One pipelined connection: sequence-numbered frames, a reader thread
    matching responses to waiting futures. Many callers share one socket
    (the classic pool opens one socket per concurrent caller instead)."""

    def __init__(self, sock: socket.socket):
        self._sock = sock
        self._send_lock = threading.Lock()
        self._lock = threading.Lock()
        self._pending: Dict[int, Future] = {}
        # Flight-recorder sidecar: seq -> (t_send, bytes, method). Only
        # populated while events are enabled; popped with the matching
        # future so it can never grow past _pending. The slow-op watchdog
        # reads it via _rpc_inflight_scan, so frames need no per-call
        # watchdog registration.
        self._meta: Dict[int, tuple] = {}
        # Reader-thread-only rpc.frame aggregation [frames, bytes]: one
        # ring event per _FRAME_AGG frames (or any slow frame) keeps the
        # per-frame hot-path cost to two dict ops.
        self._agg = [0, 0]
        self._transport = ("uds" if sock.family == socket.AF_UNIX
                           else "tcp")
        self._seq = itertools.count()
        self.dead: Optional[BaseException] = None
        _pipe_channels.add(self)
        self._reader = threading.Thread(target=self._read_loop, daemon=True,
                                        name="rpc-pipe-reader")
        self._reader.start()

    def request(self, method: str, kwargs: dict) -> Future:
        fut: Future = Future()
        seq = next(self._seq)
        parts = _dumps_parts((seq, method, kwargs))
        record = _events.enabled()
        nbytes = sum(memoryview(p).nbytes for p in parts) if record else 0
        with self._lock:
            if self.dead is not None:
                fut.set_exception(ConnectionLost(str(self.dead)))
                return fut
            self._pending[seq] = fut
            if record:
                # Before the send: the reply (and the reader popping the
                # meta) can only race a meta recorded after it.
                self._meta[seq] = (time.monotonic(), nbytes, method)
        try:
            # Fault point: client-side loss on the pipelined channel. sever
            # closes the shared socket, so the send below (or the reader
            # thread) fails and _fail_all promptly fails EVERY pending
            # future — the fail-fast contract chaos tests pin down.
            if fault_plane.fire("rpc.client.send", method=method,
                                pipelined=True) == "sever":
                self._sock.close()
            with self._send_lock:
                _send_parts(self._sock, parts)
        except BaseException as e:  # noqa: BLE001
            with self._lock:
                self._pending.pop(seq, None)
                self._meta.pop(seq, None)
            self._fail_all(e)
            if not fut.done():
                fut.set_exception(ConnectionLost(repr(e)))
        return fut

    def _read_loop(self) -> None:
        while True:
            try:
                seq, ok, payload = _loads_frame(_recv_frame(self._sock))
            except BaseException as e:  # noqa: BLE001 - socket died
                self._fail_all(e)
                return
            with self._lock:
                fut = self._pending.pop(seq, None)
                meta = self._meta.pop(seq, None)
            if meta is not None:
                # Aggregated frame accounting (reader-thread-only state):
                # a ring event per _FRAME_AGG frames — or immediately for
                # a slow frame — carries the batch's frame/byte totals and
                # the triggering frame's latency as the sample.
                agg = self._agg
                agg[0] += 1
                agg[1] += meta[1]
                lat = time.monotonic() - meta[0]
                if agg[0] >= _FRAME_AGG or lat >= 0.01:
                    _events.emit("rpc.frame", meta[2], value=lat,
                                 attrs={"frames": agg[0], "bytes": agg[1],
                                        "transport": self._transport})
                    agg[0] = agg[1] = 0
            if fut is None:
                continue
            if ok:
                fut.set_result(payload)
            else:
                exc = payload if isinstance(payload, BaseException) \
                    else RpcError(str(payload))
                fut.set_exception(exc)

    def _fail_all(self, exc: BaseException) -> None:
        with self._lock:
            if self.dead is None:
                self.dead = exc
            pending, self._pending = self._pending, {}
            self._meta = {}
        for fut in pending.values():
            if not fut.done():
                fut.set_exception(ConnectionLost(repr(exc)))
        try:
            self._sock.close()
        except OSError:
            pass

    def close(self) -> None:
        self._fail_all(ConnectionLost("channel closed"))


class RpcClient:
    """Pooled client: one socket per concurrent caller to one address.

    ``reconnect_s`` > 0 makes calls retry connection-level failures for up
    to that many seconds — the failover transparency window (a restarted
    conductor comes back on the same port; parity: the reference's GCS RPC
    client reconnection, gcs_rpc_client.h).

    Delivery contract: AT-LEAST-ONCE for every client. Independent of
    reconnect_s, a call whose POOLED keep-alive socket turns out dead is
    re-sent once on a fresh connection (ports get reused; a cached socket
    can point at a long-gone server). Services are designed for this:
    control-plane mutations are idempotent or dedupe by id (ref_update
    batch ids, actor push seqnos, task ids, lease ids).
    """

    def __init__(self, address: str, timeout: Optional[float] = None,
                 reconnect_s: float = 0.0):
        self.address = address
        host, port = address.rsplit(":", 1)
        self._target = (host, int(port))
        self._timeout = timeout
        self._reconnect_s = reconnect_s
        self._free: list = []
        self._lock = threading.Lock()
        self._closed = False
        self._pipe: Optional[_PipeChannel] = None
        self._pipe_lock = threading.Lock()

    def _connect(self) -> socket.socket:
        host = self._target[0]
        if host in ("127.0.0.1", "localhost") and _uds_enabled():
            # Same-host fast path: the server mirrors its TCP listener on a
            # Unix socket. Any failure (no file, refused, server predates
            # the feature) falls straight back to TCP.
            path = _uds_path(self._target[1])
            if os.path.exists(path):
                s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
                try:
                    s.settimeout(self._timeout if self._timeout is not None
                                 else _connect_timeout())
                    s.connect(path)
                    s.settimeout(self._timeout)
                    return s
                except OSError:
                    try:
                        s.close()
                    except OSError:
                        pass
        # Connection establishment is bounded by rpc_connect_timeout_s even
        # when per-call timeouts are unbounded (a dead peer must not hang
        # the caller in connect()); established-socket ops keep the
        # caller's timeout semantics.
        sock = socket.create_connection(
            self._target,
            timeout=self._timeout if self._timeout is not None
            else _connect_timeout())
        sock.settimeout(self._timeout)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return sock

    def call(self, method: str, _timeout: Optional[float] = None, **kwargs) -> Any:
        deadline = (time.monotonic() + self._reconnect_s
                    if self._reconnect_s > 0 else None)
        fresh_retry_done = False
        force_fresh = False
        while True:
            try:
                return self._call_once(method, _timeout, kwargs,
                                       force_fresh=force_fresh)
            except _PooledSocketDead as e:
                # A POOLED socket died under us. Ports get reused: the
                # process-wide client cache (get_client) can hold sockets
                # to a long-gone server whose host:port a NEW server now
                # owns (observed as cross-test flakes; same hazard as a
                # same-port conductor failover). Its pool-mates are stale
                # too — drop them all and retry once on a FRESH
                # connection; further failures follow the normal
                # reconnect-deadline policy.
                with self._lock:
                    stale, self._free = self._free, []
                for s in stale:
                    try:
                        s.close()
                    except OSError:
                        pass
                if not fresh_retry_done:
                    # Retry on a GUARANTEED fresh connection: a concurrent
                    # thread may repool another stale socket between our
                    # drain and the retry's pool pop.
                    fresh_retry_done = True
                    force_fresh = True
                    continue
                if deadline is None or time.monotonic() >= deadline or \
                        self._closed:
                    raise ConnectionLost("connection closed") from e
                time.sleep(0.1)
            except (ConnectionLost, ConnectionRefusedError,
                    ConnectionResetError, BrokenPipeError, OSError):
                if deadline is None or time.monotonic() >= deadline or \
                        self._closed:
                    raise
                time.sleep(0.1)

    def _call_once(self, method: str, _timeout: Optional[float],
                   kwargs: dict, force_fresh: bool = False) -> Any:
        sock = None
        if not force_fresh:
            with self._lock:
                sock = self._free.pop() if self._free else None
        pooled = sock is not None
        if sock is None:
            sock = self._connect()
        try:
            if _timeout is not None:
                sock.settimeout(_timeout)
            if fault_plane.fire("rpc.client.send", method=method) == "sever":
                sock.close()
            _send_parts(sock, _dumps_parts((method, kwargs)))
            if fault_plane.fire("rpc.client.recv", method=method) == "sever":
                sock.close()  # request sent, reply lost: the unacked window
            ok, payload = _loads_frame(_recv_frame(sock))
            if _timeout is not None:
                sock.settimeout(self._timeout)
        except BaseException as e:  # noqa: BLE001 - socket is poisoned either way; classified and re-raised below
            try:
                sock.close()
            except OSError:
                pass
            if pooled and isinstance(e, (ConnectionLost, ConnectionError,
                                         BrokenPipeError)):
                raise _PooledSocketDead() from e
            raise
        with self._lock:
            if self._closed:
                sock.close()
            else:
                self._free.append(sock)
        if not ok:
            raise payload if isinstance(payload, BaseException) else RpcError(
                str(payload))
        return payload

    # -- pipelined path ------------------------------------------------
    def _channel(self) -> _PipeChannel:
        with self._pipe_lock:
            if self._closed:
                raise ConnectionLost("client closed")
            if self._pipe is None or self._pipe.dead is not None:
                self._pipe = _PipeChannel(self._connect())
            return self._pipe

    def sever_pipe(self) -> None:
        """Kill the pipelined channel's socket mid-flight (the honor hook
        for data-plane "sever" fault actions: object.pull.window,
        object.push.chunk). Every pending call_async future on the channel
        fails fast with ConnectionLost via _fail_all."""
        with self._pipe_lock:
            pipe = self._pipe
        if pipe is not None:
            try:
                pipe._sock.close()
            except OSError:
                pass

    def call_async(self, method: str, _retry: bool = False,
                   **kwargs) -> Future:
        """Pipelined single-attempt call: returns a Future without waiting
        for the round-trip, so N calls overlap on one socket. No automatic
        resend by default — a severed channel fails the future FAST with
        ConnectionLost (never hangs; _PipeChannel._fail_all drains every
        pending future the moment the socket dies).

        ``_retry=True`` opts into async reconnect-and-retry under the same
        at-least-once contract as ``call``: on ConnectionLost the call is
        re-sent on a fresh channel (once immediately, then on a 100ms
        cadence until the reconnect_s window closes). ONLY safe for
        idempotent ops — conductor mutations dedupe by id, so its control
        ops qualify; an arbitrary service method may not."""
        if not _retry:
            return self._channel().request(method, kwargs)
        out: Future = Future()
        deadline = (time.monotonic() + self._reconnect_s
                    if self._reconnect_s > 0 else None)
        state = {"fresh_retry_done": False}

        def _issue() -> None:
            try:
                self._channel().request(method, kwargs) \
                    .add_done_callback(_on_done)
            except BaseException as e:  # noqa: BLE001 - connect failed
                _on_failure(e)

        def _on_done(fut: Future) -> None:
            exc = fut.exception()
            if exc is None:
                out.set_result(fut.result())
            elif isinstance(exc, ConnectionLost):
                _on_failure(exc)
            else:
                out.set_exception(exc)

        def _on_failure(exc: BaseException) -> None:
            if self._closed or (deadline is not None
                                and time.monotonic() >= deadline and
                                state["fresh_retry_done"]):
                out.set_exception(exc if isinstance(exc, ConnectionLost)
                                  else ConnectionLost(repr(exc)))
                return
            if not state["fresh_retry_done"]:
                # Stale cached channel: one immediate fresh-socket retry
                # (mirrors call/call_pipelined).
                state["fresh_retry_done"] = True
                _issue()
                return
            if deadline is None:
                out.set_exception(exc if isinstance(exc, ConnectionLost)
                                  else ConnectionLost(repr(exc)))
                return
            # Delayed retry off-thread: _on_failure runs on the reader
            # thread inside _fail_all — sleeping here would stall failing
            # the channel's other pending futures.
            t = threading.Timer(0.1, _issue)
            t.daemon = True
            t.start()

        _issue()
        return out

    def call_pipelined(self, method: str, _timeout: Optional[float] = None,
                       **kwargs) -> Any:
        """Sync call over the shared pipelined channel, with the same
        reconnect/at-least-once contract as ``call``."""
        deadline = (time.monotonic() + self._reconnect_s
                    if self._reconnect_s > 0 else None)
        fresh_retry_done = False
        while True:
            try:
                return self._channel().request(method, kwargs).result(
                    timeout=_timeout if _timeout is not None
                    else self._timeout)
            except ConnectionLost:
                if not fresh_retry_done:
                    fresh_retry_done = True  # stale cached channel: one
                    continue                 # immediate fresh-socket retry
                if deadline is None or time.monotonic() >= deadline or \
                        self._closed:
                    raise
                time.sleep(0.1)

    def call_batch(self, calls: List[Tuple[str, dict]],
                   _timeout: Optional[float] = None,
                   return_exceptions: bool = False) -> List[Any]:
        """Multiplex N method calls into ONE request frame (one round-trip,
        one lock-step on each side). Returns results in call order; a
        failed sub-call raises unless ``return_exceptions``."""
        outcomes = self.call("__batch__", _timeout=_timeout,
                             calls=[(m, kw) for m, kw in calls])
        results = []
        for ok, payload in outcomes:
            if ok:
                results.append(payload)
            elif return_exceptions:
                results.append(payload if isinstance(payload, BaseException)
                               else RpcError(str(payload)))
            else:
                raise payload if isinstance(payload, BaseException) \
                    else RpcError(str(payload))
        return results

    def close(self) -> None:
        with self._lock:
            self._closed = True
            socks, self._free = self._free, []
        for s in socks:
            try:
                s.close()
            except OSError:
                pass
        with self._pipe_lock:
            pipe, self._pipe = self._pipe, None
        if pipe is not None:
            pipe.close()


_client_pool: Dict[Tuple[str, Optional[float], float], RpcClient] = {}
_client_pool_lock = threading.Lock()


def get_client(address: str, timeout: Optional[float] = None,
               reconnect_s: float = 0.0) -> RpcClient:
    """Process-wide client cache (parity: rpc/worker/core_worker_client_pool.h)."""
    key = (address, timeout, reconnect_s)
    with _client_pool_lock:
        cli = _client_pool.get(key)
        if cli is None:
            cli = RpcClient(address, timeout=timeout,
                            reconnect_s=reconnect_s)
            _client_pool[key] = cli
        return cli


def drop_client(address: str) -> None:
    with _client_pool_lock:
        for key in [k for k in _client_pool if k[0] == address]:
            _client_pool.pop(key).close()
