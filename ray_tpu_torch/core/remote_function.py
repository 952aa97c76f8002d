"""@remote function handle. Ported from ``ray_tpu/core/remote_function.py``.

Role parity: python/ray/remote_function.py:34 (RemoteFunction, `_remote` at
:240) — holds the user callable plus default options; ``.options()`` returns
a derived handle; ``.remote()`` submits through the connected runtime. The
callable goes to the runtime by reference, beside its descriptor, where the
JAX package sends a pickled blob. ``.bind()`` makes a DAG node
(``dag/nodes.py``).
"""

from __future__ import annotations

import functools
from typing import List, Union

from ray_tpu_torch.core.options import TaskOptions, make_task_options
from ray_tpu_torch.core.refs import ObjectRef
from ray_tpu_torch.core.task_spec import FunctionDescriptor


class RemoteFunction:
    def __init__(self, fn, options: TaskOptions):
        if not callable(fn):
            raise TypeError("@remote must wrap a callable")
        self._fn = fn
        self._opts = options
        self._descriptor = None   # lazily computed
        functools.update_wrapper(self, fn)

    def _desc(self) -> FunctionDescriptor:
        if self._descriptor is None:
            self._descriptor = FunctionDescriptor.for_callable(self._fn)
        return self._descriptor

    # -- public API --------------------------------------------------------
    def options(self, **updates) -> "RemoteFunction":
        rf = RemoteFunction(self._fn, make_task_options(self._opts, **updates))
        rf._descriptor = self._desc()
        return rf

    def remote(self, *args, **kwargs) -> Union[ObjectRef, List[ObjectRef]]:
        from ray_tpu_torch.core.api import _global_runtime
        rt = _global_runtime()
        refs = rt.submit_task(self._desc(), self._fn, args, kwargs,
                              self._opts)
        if self._opts.num_returns == 1:
            return refs[0]
        return refs

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Remote function {self._fn.__qualname__!r} cannot be called "
            "directly; use .remote() (or access the original via .func).")

    def bind(self, *args, **kwargs):
        """Lazy DAG node (parity: function_node.py:12 via .bind())."""
        from ray_tpu_torch.dag.nodes import FunctionNode
        return FunctionNode(self, args, kwargs)

    @property
    def func(self):
        return self._fn
