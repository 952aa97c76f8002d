"""multiprocessing.Pool-compatible API over cluster actors.

Role parity: python/ray/util/multiprocessing — Pool whose workers are
cluster actors, so ``pool.map`` scales past one machine with the stdlib
interface. Ported from ``ray_tpu/util/multiprocessing.py``.

Where the port differs: the JAX pool ships each function as a cloudpickle
blob (``apply_async`` wraps it with its ``kwds`` in a lambda); the port
passes the function itself as a task argument, which its runtime ships by
import path (``core/serialization.py``), and ``kwds`` as a
``functools.partial``. On the cluster runtime a pool's function must be
defined at module level: a lambda raises ``TypeError`` at submission,
where the stdlib pool would fail to pickle it too. ``imap`` on a closed
pool raises ``ValueError``, as ``map`` does (the JAX ``imap`` submits).
"""

from __future__ import annotations

import functools
import itertools
from typing import Any, Callable, Iterable, List, Optional


class _PoolActor:
    def run(self, fn: Callable, args: tuple) -> Any:
        return fn(*args)

    def run_batch(self, fn: Callable, items: list, star: bool) -> list:
        return [fn(*it) if star else fn(it) for it in items]


class AsyncResult:
    def __init__(self, refs, single: bool):
        self._refs = refs
        self._single = single

    def get(self, timeout: Optional[float] = None):
        import ray_tpu_torch as rt
        outs = rt.get(self._refs, timeout=timeout)
        if self._single:
            return outs[0]
        return list(itertools.chain.from_iterable(outs))

    def wait(self, timeout: Optional[float] = None) -> None:
        import ray_tpu_torch as rt
        rt.wait(self._refs, num_returns=len(self._refs), timeout=timeout)

    def ready(self) -> bool:
        import ray_tpu_torch as rt
        done, _ = rt.wait(self._refs, num_returns=len(self._refs),
                          timeout=0)
        return len(done) == len(self._refs)


class Pool:
    def __init__(self, processes: Optional[int] = None,
                 ray_remote_args: Optional[dict] = None):
        import multiprocessing

        import ray_tpu_torch as rt
        if not rt.is_initialized():
            rt.init()
        n = processes or multiprocessing.cpu_count()
        opts = ray_remote_args or {"num_cpus": 1}
        cls = rt.remote(_PoolActor)
        self._actors = [cls.options(**opts).remote() for _ in range(n)]
        self._n = n
        self._closed = False

    def _chunks(self, items: List[Any], chunksize: Optional[int]):
        if chunksize is None:
            chunksize = max(1, len(items) // (self._n * 4) or 1)
        for i in range(0, len(items), chunksize):
            yield items[i:i + chunksize]

    def _batch_refs(self, fn: Callable, iterable: Iterable, star: bool,
                    chunksize: Optional[int]) -> list:
        if self._closed:
            raise ValueError("Pool is closed")
        items = list(iterable)
        return [self._actors[i % self._n].run_batch.remote(fn, chunk, star)
                for i, chunk in enumerate(self._chunks(items, chunksize))]

    def _map_async(self, fn: Callable, iterable: Iterable, star: bool,
                   chunksize: Optional[int]) -> AsyncResult:
        return AsyncResult(self._batch_refs(fn, iterable, star, chunksize),
                           single=False)

    def map(self, fn: Callable, iterable: Iterable,
            chunksize: Optional[int] = None) -> list:
        return self._map_async(fn, iterable, False, chunksize).get()

    def map_async(self, fn, iterable, chunksize=None) -> AsyncResult:
        return self._map_async(fn, iterable, False, chunksize)

    def starmap(self, fn: Callable, iterable: Iterable,
                chunksize: Optional[int] = None) -> list:
        return self._map_async(fn, iterable, True, chunksize).get()

    def starmap_async(self, fn, iterable, chunksize=None) -> AsyncResult:
        return self._map_async(fn, iterable, True, chunksize)

    def apply(self, fn: Callable, args: tuple = (), kwds: dict = None):
        return self.apply_async(fn, args, kwds).get()

    def apply_async(self, fn: Callable, args: tuple = (),
                    kwds: dict = None) -> AsyncResult:
        if self._closed:
            raise ValueError("Pool is closed")
        if kwds:
            fn = functools.partial(fn, **kwds)
        return AsyncResult([self._actors[0].run.remote(fn, tuple(args))],
                           single=True)

    def imap(self, fn: Callable, iterable: Iterable,
             chunksize: Optional[int] = None):
        import ray_tpu_torch as rt
        for ref in self._batch_refs(fn, iterable, False, chunksize):
            yield from rt.get(ref)

    def close(self) -> None:
        self._closed = True

    def terminate(self) -> None:
        import ray_tpu_torch as rt
        self._closed = True
        for a in self._actors:
            try:
                rt.kill(a)
            except Exception:
                pass

    def join(self) -> None:
        if not self._closed:
            raise ValueError("close() must precede join()")

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.terminate()
        return False
