"""Function descriptors and the task-argument rule. Ported from
``ray_tpu/core/task_spec.py``.

The JAX package ships a function by a content hash of its cloudpickle and
caches it in workers. The port's in-process runtime holds the callable by
reference instead, keyed by its ``FunctionDescriptor``, as it holds objects
by reference (``runtime_local.py``): nothing is pickled, so a remote lambda
or a class defined inside a test works there. The cluster runtime pickles
the callable by import path (``serialization.dumps``) and caches the blob
under the same ``function_id``; it ships task specs as dicts, so the JAX
module's ``TaskSpec`` dataclass is not copied.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import List

from ray_tpu_torch.core.refs import ObjectRef


def top_level_ref_args(args, kwargs) -> List[ObjectRef]:
    """The ONE definition of which task arguments the execution plane
    resolves by value: ObjectRefs in a TOP-LEVEL positional or keyword
    position (reference task_spec.h ByReference args; nested refs stay
    refs and are merely borrowed). The submit side derives the dependency
    gate and the in-spec arg inliner from this list, the worker derives
    its arg resolution from ``resolve_task_args`` — both sides share this
    helper so the two rules can never drift."""
    out: List[ObjectRef] = []
    for a in args:
        if isinstance(a, ObjectRef):
            out.append(a)
    for v in kwargs.values():
        if isinstance(v, ObjectRef):
            out.append(v)
    return out


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

