"""Distributed FIFO queue backed by an async actor (parity:
python/ray/util/queue.py — Queue over an _QueueActor). Ported from
``ray_tpu/util/queue.py``: the actor's coroutines run on its worker's
event loop (``cluster/worker_main.py``) or, on the in-process runtime, on
the actor's own loop thread."""

from __future__ import annotations

import asyncio
from typing import Any, Optional


class Empty(Exception):
    pass


class Full(Exception):
    pass


class _QueueActor:
    def __init__(self, maxsize: int = 0):
        self.q = asyncio.Queue(maxsize=maxsize)

    async def put(self, item, timeout: Optional[float] = None) -> bool:
        if timeout is None:
            await self.q.put(item)
            return True
        try:
            await asyncio.wait_for(self.q.put(item), timeout)
            return True
        except asyncio.TimeoutError:
            return False

    async def get(self, timeout: Optional[float] = None):
        if timeout is None:
            return True, await self.q.get()
        try:
            return True, await asyncio.wait_for(self.q.get(), timeout)
        except asyncio.TimeoutError:
            return False, None

    def put_nowait(self, item) -> bool:
        try:
            self.q.put_nowait(item)
            return True
        except asyncio.QueueFull:
            return False

    def get_nowait(self):
        try:
            return True, self.q.get_nowait()
        except asyncio.QueueEmpty:
            return False, None

    def qsize(self) -> int:
        return self.q.qsize()

    def empty(self) -> bool:
        return self.q.empty()

    def full(self) -> bool:
        return self.q.full()


class Queue:
    def __init__(self, maxsize: int = 0, actor_options: Optional[dict] = None):
        import ray_tpu_torch as rt
        opts = dict(actor_options or {})
        opts.setdefault("max_concurrency", 64)
        self.actor = rt.remote(_QueueActor).options(**opts).remote(maxsize)

    def put(self, item: Any, block: bool = True,
            timeout: Optional[float] = None) -> None:
        import ray_tpu_torch as rt
        if not block:
            if not rt.get(self.actor.put_nowait.remote(item)):
                raise Full
            return
        if not rt.get(self.actor.put.remote(item, timeout)):
            raise Full

    def get(self, block: bool = True, timeout: Optional[float] = None) -> Any:
        import ray_tpu_torch as rt
        if not block:
            ok, item = rt.get(self.actor.get_nowait.remote())
        else:
            ok, item = rt.get(self.actor.get.remote(timeout))
        if not ok:
            raise Empty
        return item

    def put_nowait(self, item: Any) -> None:
        self.put(item, block=False)

    def get_nowait(self) -> Any:
        return self.get(block=False)

    def qsize(self) -> int:
        import ray_tpu_torch as rt
        return rt.get(self.actor.qsize.remote())

    def empty(self) -> bool:
        import ray_tpu_torch as rt
        return rt.get(self.actor.empty.remote())

    def full(self) -> bool:
        import ray_tpu_torch as rt
        return rt.get(self.actor.full.remote())

    def shutdown(self) -> None:
        import ray_tpu_torch as rt
        rt.kill(self.actor)
