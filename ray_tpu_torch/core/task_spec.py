"""Function descriptors and the task-argument rule. Ported from
``ray_tpu/core/task_spec.py``.

The JAX package ships a function by a content hash of its cloudpickle and
caches it in workers. The port's in-process runtime holds the callable by
reference instead, keyed by its ``FunctionDescriptor``, as it holds objects
by reference (``runtime_local.py``): nothing is pickled, so a remote lambda
or a class defined inside a test works. ``TaskSpec``, the unit the JAX
cluster runtime ships between processes, waits for the port's cluster
runtime.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

from ray_tpu_torch.core.refs import ObjectRef


def resolve_task_args(args, kwargs, resolve_ref):
    """Materialize the ObjectRefs in a TOP-LEVEL positional or keyword
    position (reference task_spec.h ByReference args; nested refs stay
    refs) via ``resolve_ref(ref)``. Returns (args_list, kwargs_dict) ready
    to call the function with."""
    res_args = [resolve_ref(a) if isinstance(a, ObjectRef) else a
                for a in args]
    res_kwargs = {k: resolve_ref(v) if isinstance(v, ObjectRef) else v
                  for k, v in kwargs.items()}
    return res_args, res_kwargs


@dataclass
class FunctionDescriptor:
    """Handle for a remote function or actor class. The runtime keeps the
    callable in a table keyed by ``function_id``; the id stays unique
    because the table holds the callable alive."""
    function_id: str              # sha1 of the callable's name and identity
    module: str
    qualname: str

    @classmethod
    def for_callable(cls, fn) -> "FunctionDescriptor":
        module = getattr(fn, "__module__", "") or ""
        qualname = getattr(fn, "__qualname__", repr(fn))
        fid = hashlib.sha1(
            f"{module}.{qualname}@{id(fn):x}".encode()).hexdigest()
        return cls(function_id=fid, module=module, qualname=qualname)

    def repr_name(self) -> str:
        return f"{self.module}.{self.qualname}"

