"""ActorPool (parity: python/ray/util/actor_pool.py) — round-robin a pool of
actors over a stream of work items with bounded in-flight submissions.
Ported from ``ray_tpu/util/actor_pool.py`` unchanged but for the runtime it
calls."""

from __future__ import annotations

from typing import Any, Callable, Iterable, List


class ActorPool:
    def __init__(self, actors: List[Any]):
        self._idle = list(actors)
        self._future_to_actor = {}
        self._index_to_future = {}
        self._next_task_index = 0
        self._next_return_index = 0
        self._pending_submits = []

    def map(self, fn: Callable, values: Iterable[Any]):
        """Ordered map: yields results in submission order."""
        for v in values:
            self.submit(fn, v)
        while self.has_next():
            yield self.get_next()

    def map_unordered(self, fn: Callable, values: Iterable[Any]):
        for v in values:
            self.submit(fn, v)
        while self.has_next():
            yield self.get_next_unordered()

    def submit(self, fn: Callable, value: Any) -> None:
        if self._idle:
            actor = self._idle.pop()
            future = fn(actor, value)
            self._future_to_actor[future] = (self._next_task_index, actor)
            self._index_to_future[self._next_task_index] = future
            self._next_task_index += 1
        else:
            self._pending_submits.append((fn, value))

    def has_next(self) -> bool:
        return bool(self._future_to_actor) or bool(self._pending_submits)

    def _return_actor(self, actor) -> None:
        self._idle.append(actor)
        if self._pending_submits:
            self.submit(*self._pending_submits.pop(0))

    def get_next(self, timeout: float = None) -> Any:
        import ray_tpu_torch as rt
        if self._next_return_index >= self._next_task_index and \
                not self._pending_submits:
            raise StopIteration("No more results to get")
        while self._next_return_index not in self._index_to_future:
            if not self.has_next():
                raise StopIteration("No more results to get")
            # drain a pending submit into flight
            if self._pending_submits and self._idle:
                self.submit(*self._pending_submits.pop(0))
        future = self._index_to_future.pop(self._next_return_index)
        self._next_return_index += 1
        _, actor = self._future_to_actor.pop(future)
        try:
            return rt.get(future, timeout=timeout)
        finally:
            self._return_actor(actor)

    def get_next_unordered(self, timeout: float = None) -> Any:
        import ray_tpu_torch as rt
        if not self._future_to_actor:
            if not self._pending_submits:
                raise StopIteration("No more results to get")
        ready, _ = rt.wait(list(self._future_to_actor), num_returns=1,
                           timeout=timeout)
        if not ready:
            raise TimeoutError("get_next_unordered timed out")
        future = ready[0]
        idx, actor = self._future_to_actor.pop(future)
        self._index_to_future.pop(idx, None)
        try:
            return rt.get(future)
        finally:
            self._return_actor(actor)

    def has_free(self) -> bool:
        return bool(self._idle) and not self._pending_submits

    def pop_idle(self):
        return self._idle.pop() if self.has_free() else None

    def push(self, actor) -> None:
        self._return_actor(actor)
