"""Actor API: ActorClass / ActorHandle / ActorMethod. Ported from
``ray_tpu/core/actor.py``.

Role parity: python/ray/actor.py (ActorClass:377, ActorHandle:1022,
ActorMethod:92). An actor is a stateful worker (a thread in the in-process
runtime); method calls are ordered per caller and execute under the actor's
concurrency policy (max_concurrency; async actors run on an asyncio loop).
The class goes to the runtime by reference, beside its descriptor.
``.bind()`` makes a DAG node (``dag/nodes.py``).
"""

from __future__ import annotations

import functools
import inspect
from typing import Dict, List, Optional, Union

from ray_tpu_torch.core.ids import ActorID
from ray_tpu_torch.core.options import (ActorOptions, TaskOptions,
                                        make_actor_options, make_task_options)
from ray_tpu_torch.core.refs import ObjectRef
from ray_tpu_torch.core.task_spec import FunctionDescriptor


def method(**opts):
    """Per-method option decorator (e.g. ``@method(num_returns=2)``)."""
    def wrap(fn):
        fn.__rt_method_options__ = opts
        return fn
    return wrap


class ActorMethod:
    def __init__(self, handle: "ActorHandle", name: str, opts: TaskOptions):
        self._handle = handle
        self._name = name
        self._opts = opts

    def options(self, **updates) -> "ActorMethod":
        return ActorMethod(self._handle, self._name,
                           make_task_options(self._opts, **updates))

    def remote(self, *args, **kwargs) -> Union[ObjectRef, List[ObjectRef]]:
        from ray_tpu_torch.core.api import _global_runtime
        rt = _global_runtime()
        refs = rt.submit_actor_task(self._handle, self._name, args, kwargs,
                                    self._opts)
        if self._opts.num_returns == 1:
            return refs[0]
        return refs

    def __call__(self, *a, **k):
        raise TypeError("Actor methods cannot be called directly; use .remote().")


class ActorHandle:
    """Serializable handle to a live actor."""

    def __init__(self, actor_id: ActorID, class_name: str,
                 method_options: Dict[str, dict], is_async: bool = False):
        self._rt_actor_id = actor_id
        self._rt_class_name = class_name
        self._rt_method_options = method_options
        self._rt_is_async = is_async

    @property
    def actor_id(self) -> ActorID:
        return self._rt_actor_id

    def __getattr__(self, name: str) -> ActorMethod:
        if name.startswith("_"):
            raise AttributeError(name)
        base = self._rt_method_options.get(name)
        if base is None:
            raise AttributeError(
                f"Actor class {self._rt_class_name!r} has no method {name!r}")
        return ActorMethod(self, name, make_task_options(None, **base))

    def __repr__(self):
        return (f"ActorHandle({self._rt_class_name}, "
                f"{self._rt_actor_id.hex()[:8]})")

    def __reduce__(self):
        return (ActorHandle, (self._rt_actor_id, self._rt_class_name,
                              self._rt_method_options, self._rt_is_async))


class ActorClass:
    def __init__(self, cls: type, options: ActorOptions):
        self._cls = cls
        self._opts = options
        self._descriptor: Optional[FunctionDescriptor] = None
        functools.update_wrapper(self, cls, updated=[])

    @staticmethod
    def _scan_methods(cls: type) -> Dict[str, dict]:
        out: Dict[str, dict] = {}
        for name, fn in inspect.getmembers(cls, callable):
            if name.startswith("_") and name != "__call__":
                continue
            opts = dict(getattr(fn, "__rt_method_options__", {}))
            out[name] = opts
        return out

    def _desc(self) -> FunctionDescriptor:
        if self._descriptor is None:
            self._descriptor = FunctionDescriptor.for_callable(self._cls)
        return self._descriptor

    def options(self, **updates) -> "ActorClass":
        ac = ActorClass(self._cls, make_actor_options(self._opts, **updates))
        ac._descriptor = self._desc()
        return ac

    def remote(self, *args, **kwargs) -> ActorHandle:
        from ray_tpu_torch.core.api import _global_runtime
        rt = _global_runtime()
        methods = self._scan_methods(self._cls)
        is_async = any(inspect.iscoroutinefunction(getattr(self._cls, n, None))
                       for n in methods)
        return rt.create_actor(self._desc(), self._cls, args, kwargs,
                               self._opts, methods, is_async)

    def bind(self, *args, **kwargs):
        """Lazy DAG node (parity: class_node.py:16 via .bind())."""
        from ray_tpu_torch.dag.nodes import ClassNode
        return ClassNode(self, args, kwargs)

    def __call__(self, *a, **k):
        raise TypeError(
            f"Actor class {self._cls.__name__!r} cannot be instantiated "
            "directly; use .remote().")

    @property
    def cls(self) -> type:
        return self._cls
