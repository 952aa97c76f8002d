"""HTTP ingress for serve deployments. Ported from
``ray_tpu/serve/http_proxy.py``.

Role parity: serve/_private/http_proxy.py:250 — the proxy actor
translating HTTP to deployment calls. The reference runs uvicorn/starlette
(ASGI); here an asyncio HTTP/1.1 server keeps the package dependency-free
while matching the ASGI proxy's operational shape: one event loop, many
concurrent in-flight requests (each deployment call runs in an executor so
the loop never blocks), keep-alive connections, and chunked
Transfer-Encoding for streaming responses (serve.StreamingResponse).

Admission control (parity: the proxy's backpressure +
max_queued_requests): each deployment gets a queue budget
(serve_max_queued_requests) and an ongoing budget (replicas x
serve_max_ongoing_requests). Past the queue budget requests shed with
503 + Retry-After instead of queueing unboundedly; admitted requests
carry a deadline (serve_request_timeout_s) and time out with 504, the
in-flight call cancelled rather than leaked.

The fault plane's ``serve.proxy.admit`` site fires before admission (a
raised fault sheds with 503), every answered request emits
``serve.request`` (a 503 also ``serve.shed``, a capacity wait past the
deadline ``serve.timeout``), and the ``serve.proxy`` probe samples the
queued and ongoing counts at each ring flush. On a cluster the proxy is a
worker process, as in the JAX package.

Where the port differs from the JAX module: ``close`` stops the listener,
cancels the open connections, drops the probe and joins the loop thread
and both executors, so no thread of a closed proxy is left; the JAX proxy
lives in its own process and leaves that to the process's end.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import json
import threading
import time
import weakref
from typing import Iterable, Optional

from ray_tpu_torch import config
from ray_tpu_torch.cluster import fault_plane
from ray_tpu_torch.util import events

# Proxies constructed in this process and not closed yet: a live proxy
# holds a listening socket and three kinds of threads.
_live_proxies: "weakref.WeakSet" = weakref.WeakSet()


class StreamingResponse:
    """Mark a deployment return value for chunked Transfer-Encoding: each
    element of ``chunks`` is written as one HTTP chunk (str or bytes).

    Delivery is chunked on the WIRE but materialized at the replica: the
    chunk list is complete before the proxy writes it."""

    def __init__(self, chunks: Iterable, content_type: str = "text/plain"):
        self.chunks = list(chunks)
        self.content_type = content_type


_REASONS = {400: "Bad Request", 404: "Not Found", 500: "Internal Error",
            501: "Not Implemented", 503: "Service Unavailable",
            504: "Gateway Timeout"}


def _http_error(code: int, msg: str,
                retry_after: Optional[int] = None) -> bytes:
    body = json.dumps({"error": msg}).encode()
    extra = f"Retry-After: {retry_after}\r\n" if retry_after is not None \
        else ""
    return (f"HTTP/1.1 {code} {_REASONS.get(code, 'Error')}\r\n"
            f"Content-Type: application/json\r\n{extra}"
            f"Content-Length: {len(body)}\r\n\r\n").encode() + body


def _emit(kind: str, ident: str, value: float = 1.0, **attrs) -> None:
    try:
        events.emit(kind, ident, value=value, attrs=attrs or None)
    except Exception:
        pass   # the flight recorder never fails a request


class HTTPProxy:
    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self._routes_cache: dict = {}
        self._routes_ts = 0.0
        self._routes_lock = threading.Lock()
        self._routes_refreshing = False
        self._fetch_future = None   # in-flight fetch shared by missers
        # dedicated 1-thread executor for route refreshes: deployment
        # calls saturating the call pool must never block routing
        self._route_pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="serve-routes")
        # the loop's default executor: blocking deployment calls
        self._call_pool = concurrent.futures.ThreadPoolExecutor(
            thread_name_prefix="serve-proxy-call")
        # Admission book, touched only on the loop thread: per-deployment
        # {"queued": n, "ongoing": n}. Counters for stats()/acceptance.
        self._adm: dict = {}
        self._counts = {"served": 0, "shed": 0, "timeouts": 0, "errors": 0}
        self._loop = asyncio.new_event_loop()
        self._loop.set_default_executor(self._call_pool)
        self._conns: set = set()   # connection tasks, on the loop thread
        self._server = None
        self._closed = False
        self._started = threading.Event()
        self._boot_error: Optional[BaseException] = None
        self._host, self._want_port = host, port
        self._port: Optional[int] = None
        self._thread = threading.Thread(target=self._run_loop, daemon=True,
                                        name="serve-proxy")
        self._thread.start()
        if not self._started.wait(10.0) or self._boot_error is not None:
            self.close()
            raise self._boot_error or RuntimeError(
                "serve proxy failed to start within 10s")
        _live_proxies.add(self)
        events.register_probe("serve.proxy", self._probe)

    def _probe(self) -> dict:
        queued = sum(st["queued"] for st in self._adm.values())
        ongoing = sum(st["ongoing"] for st in self._adm.values())
        return {"rt_serve_queued": float(queued),
                "rt_serve_ongoing": float(ongoing)}

    # -- event loop -------------------------------------------------------
    def _run_loop(self) -> None:
        asyncio.set_event_loop(self._loop)

        async def boot():
            self._server = await asyncio.start_server(
                self._handle_conn, self._host, self._want_port)
            self._port = self._server.sockets[0].getsockname()[1]

        try:
            self._loop.run_until_complete(boot())
        except BaseException as e:  # noqa: BLE001 - re-raised in __init__
            self._boot_error = e
            self._started.set()
            self._loop.close()
            return
        self._started.set()
        try:
            self._loop.run_forever()
        finally:
            if self._server is not None:
                self._server.close()
            self._loop.close()

    async def _handle_conn(self, reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter) -> None:
        task = asyncio.current_task()
        self._conns.add(task)
        try:
            while True:  # keep-alive: serve requests until close/EOF
                line = await reader.readline()
                if not line or line in (b"\r\n", b"\n"):
                    return
                try:
                    method, target, _version = \
                        line.decode("latin1").split(" ", 2)
                except ValueError:
                    writer.write(_http_error(400, "bad request line"))
                    await writer.drain()
                    return
                headers = {}
                while True:
                    h = await reader.readline()
                    if h == b"":
                        return  # EOF mid-headers: aborted request, drop it
                    if h in (b"\r\n", b"\n"):
                        break
                    k, _, v = h.decode("latin1").partition(":")
                    headers[k.strip().lower()] = v.strip()
                if "chunked" in headers.get("transfer-encoding", ""):
                    # unsupported request framing: answer and CLOSE (the
                    # unread chunk bytes would otherwise be parsed as the
                    # next pipelined request)
                    writer.write(_http_error(
                        501, "chunked request bodies not supported"))
                    await writer.drain()
                    return
                try:
                    length = int(headers.get("content-length") or 0)
                except ValueError:
                    writer.write(_http_error(400, "bad Content-Length"))
                    await writer.drain()
                    return
                body = await reader.readexactly(length) if length else b""
                keep = headers.get("connection", "keep-alive") != "close"
                await self._dispatch(method, target, body, writer)
                await writer.drain()
                if not keep:
                    return
        except (asyncio.IncompleteReadError, ConnectionError):
            pass
        finally:
            self._conns.discard(task)
            writer.close()

    # -- admission --------------------------------------------------------
    def _adm_state(self, name: str) -> dict:
        st = self._adm.get(name)
        if st is None:
            st = self._adm[name] = {"queued": 0, "ongoing": 0}
        return st

    @staticmethod
    def _budget(name: str) -> int:
        """Ongoing budget: what the replica set can actually absorb
        (replicas x per-replica cap, from the handle's routing view).
        Before the first refresh lands the single-replica default
        applies — the first calls refresh it."""
        from ray_tpu_torch.serve.api import _handle_for
        h = _handle_for(name)
        cap = h._max_ongoing or int(config.get(
            "serve_max_ongoing_requests"))
        n = len(h._replicas)
        return max(1, max(1, n) * max(1, cap))

    def _reject(self, writer, name: str, code: int, msg: str,
                t0: float) -> None:
        kind = "shed" if code == 503 else \
            "timeouts" if code == 504 else "errors"
        self._counts[kind] += 1
        if code == 503:
            _emit("serve.shed", name)
        _emit("serve.request", name, value=time.monotonic() - t0,
              code=code, deployment=name)
        writer.write(_http_error(
            code, msg, retry_after=1 if code == 503 else None))

    async def _dispatch(self, method: str, target: str, body: bytes,
                        writer: asyncio.StreamWriter) -> None:
        path = target.split("?")[0]

        def match(routes):
            for prefix, dep in sorted(routes.items(),
                                      key=lambda kv: -len(kv[0])):
                if path == prefix or \
                        path.startswith(prefix.rstrip("/") + "/"):
                    return dep
            return None

        # cache read is a plain dict lookup (safe on the loop thread);
        # stale caches refresh in the dedicated route executor without
        # blocking this request
        routes = self._routes()
        name = match(routes)
        if name is None:
            # a just-deployed route may postdate the cache: one
            # authoritative refresh before 404ing. Coalesced single-flight:
            # concurrent misses share ONE controller call.
            routes = await self._loop.run_in_executor(
                None, self._fetch_routes_coalesced)
            name = match(routes)
        if name is None:
            writer.write(_http_error(404, "no matching route"))
            return
        args, kwargs = (), {}
        if body:
            try:
                payload = json.loads(body)
                if isinstance(payload, dict):
                    kwargs = payload
                else:
                    args = (payload,)
            except json.JSONDecodeError:
                args = (body,)

        t0 = time.monotonic()
        try:
            fault_plane.fire("serve.proxy.admit", deployment=name, path=path)
        except Exception:
            self._reject(writer, name, 503, "admission rejected", t0)
            return
        st = self._adm_state(name)
        if st["queued"] >= int(config.get("serve_max_queued_requests")):
            self._reject(writer, name, 503, f"queue full for {name!r}", t0)
            return
        deadline = t0 + float(config.get("serve_request_timeout_s"))
        # Queue for an ongoing slot. The loop is single-threaded, so the
        # counters need no lock; check-then-act is atomic between awaits.
        st["queued"] += 1
        try:
            while st["ongoing"] >= self._budget(name):
                if time.monotonic() >= deadline:
                    _emit("serve.timeout", name)
                    self._reject(writer, name, 504,
                                 "timed out waiting for capacity", t0)
                    return
                await asyncio.sleep(0.005)
            st["ongoing"] += 1
        finally:
            st["queued"] -= 1

        def call_blocking():
            from ray_tpu_torch.serve.api import _handle_for
            return _handle_for(name).call(
                *args,
                timeout=max(0.05, deadline - time.monotonic()),
                **kwargs)

        try:
            # executor offload: slow model calls never stall the loop —
            # other connections keep being served (the ASGI property)
            out = await self._loop.run_in_executor(None, call_blocking)
        except Exception as e:  # noqa: BLE001 - HTTP error surface
            from ray_tpu_torch.core.exceptions import GetTimeoutError
            from ray_tpu_torch.serve.api import _retryable
            from ray_tpu_torch.serve.controller import ReplicaBusyError
            if isinstance(e, GetTimeoutError):
                # the in-flight call was cancelled by ServeCallRef
                self._reject(writer, name, 504,
                             "deployment call timed out", t0)
            elif isinstance(e, (ReplicaBusyError, RuntimeError)) \
                    or _retryable(e):
                # _retryable covers the call that burned its one retry on
                # a SECOND dying replica: the failure is the replicas',
                # not the request's — the client may retry (503), this is
                # not a 500.
                self._reject(writer, name, 503, repr(e), t0)
            else:
                self._reject(writer, name, 500, repr(e), t0)
            return
        finally:
            st["ongoing"] -= 1
        self._counts["served"] += 1
        _emit("serve.request", name, value=time.monotonic() - t0,
              code=200, deployment=name)
        if isinstance(out, StreamingResponse):
            writer.write((
                "HTTP/1.1 200 OK\r\n"
                f"Content-Type: {out.content_type}\r\n"
                "Transfer-Encoding: chunked\r\n\r\n").encode())
            for chunk in out.chunks:
                data = chunk.encode() if isinstance(chunk, str) else \
                    bytes(chunk)
                if not data:
                    continue
                writer.write(f"{len(data):x}\r\n".encode() + data + b"\r\n")
                await writer.drain()
            writer.write(b"0\r\n\r\n")
            return
        data = json.dumps(out, default=str).encode()
        writer.write((
            "HTTP/1.1 200 OK\r\nContent-Type: application/json\r\n"
            f"Content-Length: {len(data)}\r\n\r\n").encode() + data)

    # -- control ----------------------------------------------------------
    def _routes(self) -> dict:
        """NON-BLOCKING cache read: returns the current table immediately;
        a stale table kicks off (at most one) background refresh on the
        dedicated route thread. Callers on the event loop never wait."""
        with self._routes_lock:
            stale = time.monotonic() - self._routes_ts > 1.0
            if stale and not self._routes_refreshing:
                self._routes_refreshing = True
                self._route_pool.submit(self._fetch_routes)
            return self._routes_cache

    def _fetch_routes(self) -> dict:
        """Blocking controller fetch (runs on the route thread only)."""
        from ray_tpu_torch.core import api as core_api
        from ray_tpu_torch.serve.controller import ServeController
        try:
            controller = core_api.get_actor(ServeController.CONTROLLER_NAME)
            fresh = core_api.get(controller.get_routes.remote(), timeout=10)
            with self._routes_lock:
                self._routes_cache = fresh
        except Exception:
            pass  # keep serving the stale table
        finally:
            with self._routes_lock:
                # success OR failure advances the clock: a dead controller
                # backs off instead of retrying per request
                self._routes_ts = time.monotonic()
                self._routes_refreshing = False
        return self._routes_cache

    def _fetch_routes_coalesced(self) -> dict:
        """Authoritative fetch with single-flight coalescing: callers that
        arrive while a fetch is running wait for THAT fetch's result."""
        created = False
        with self._routes_lock:
            fut = self._fetch_future
            if fut is None:
                fut = self._fetch_future = \
                    self._route_pool.submit(self._fetch_routes)
                created = True
        if created:
            # registered OUTSIDE the lock: a completed future runs the
            # callback synchronously in this thread
            def clear(_f):
                with self._routes_lock:
                    self._fetch_future = None

            fut.add_done_callback(clear)
        try:
            return fut.result(timeout=15)
        except Exception:
            return self._routes_cache

    def port(self) -> int:
        return self._port

    def reconfigure(self, overrides: dict) -> dict:
        """Apply config overrides; a value of None clears the override.
        Admission reads config at request time, so operators can live-tune
        the ingress knobs (queue budget, per-replica cap, deadline) without
        bouncing the listener and dropping its keep-alive connections."""
        for name, value in overrides.items():
            if value is None:
                config.clear_override(name)
            else:
                config.set_override(name, value)
        return {k: config.get(k) for k in overrides}

    def stats(self) -> dict:
        """Admission counters + live occupancy (acceptance checks and the
        controller's http_stats passthrough read these)."""
        return {
            "served": self._counts["served"],
            "shed": self._counts["shed"],
            "timeouts": self._counts["timeouts"],
            "errors": self._counts["errors"],
            "queued": sum(st["queued"] for st in self._adm.values()),
            "ongoing": sum(st["ongoing"] for st in self._adm.values()),
        }

    async def _stop_serving(self) -> None:
        self._server.close()
        for task in list(self._conns):
            task.cancel()
        await asyncio.gather(*self._conns, return_exceptions=True)

    def close(self) -> None:
        """Stop the listener, cancel the open connections, then join the
        loop thread and the executors (idempotent). A deployment call still
        running in the call pool is waited for; its deadline bounds it."""
        if self._closed:
            return
        self._closed = True
        _live_proxies.discard(self)
        events.unregister_probe("serve.proxy", self._probe)
        if self._server is not None and self._thread.is_alive():
            try:
                asyncio.run_coroutine_threadsafe(
                    self._stop_serving(), self._loop).result(timeout=10)
            except (concurrent.futures.TimeoutError, RuntimeError):
                pass   # the loop is stuck or already stopped: stop it below
            self._loop.call_soon_threadsafe(self._loop.stop)
        self._thread.join(timeout=10)
        self._call_pool.shutdown(wait=True, cancel_futures=True)
        self._route_pool.shutdown(wait=True, cancel_futures=True)

    @property
    def closed(self) -> bool:
        return self._closed
