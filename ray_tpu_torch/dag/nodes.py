"""DAG node types + executor. Ported from ``ray_tpu/dag/nodes.py``."""

from __future__ import annotations

from typing import Any, Dict, List, Tuple


class DAGNode:
    def __init__(self, args: tuple, kwargs: dict):
        self._bound_args = args
        self._bound_kwargs = kwargs

    # -- traversal -------------------------------------------------------
    def _children(self) -> List["DAGNode"]:
        out = []
        for v in list(self._bound_args) + list(self._bound_kwargs.values()):
            if isinstance(v, DAGNode):
                out.append(v)
        return out

    def _resolve_args(self, memo: Dict[int, Any], input_value) -> Tuple:
        def rv(v):
            if isinstance(v, DAGNode):
                return v._execute_memo(memo, input_value)
            return v
        args = tuple(rv(a) for a in self._bound_args)
        kwargs = {k: rv(v) for k, v in self._bound_kwargs.items()}
        return args, kwargs

    def _execute_memo(self, memo: Dict[int, Any], input_value):
        key = id(self)
        if key in memo:
            return memo[key]
        out = self._execute_impl(memo, input_value)
        memo[key] = out
        return out

    def _execute_impl(self, memo, input_value):
        raise NotImplementedError

    def execute(self, input_value: Any = None):
        """Execute the graph; returns the root's result (ObjectRefs are
        resolved at the boundary)."""
        import ray_tpu_torch as rt
        out = self._execute_memo({}, input_value)
        from ray_tpu_torch.core.refs import ObjectRef
        return rt.get(out) if isinstance(out, ObjectRef) else out

    def experimental_compile(self, max_in_flight: int = 8,
                             _submit_timeout: float = 60.0):
        """Compile this bound graph into a static plan over persistent shm
        channels (parity: dag_node.experimental_compile → CompiledDAG).
        Returns a CompiledGraph whose execute() costs a channel write, not
        a task submission; call teardown() to restore the actors to normal
        task service."""
        from ray_tpu_torch.dag.compiled import compile_dag
        return compile_dag(self, max_in_flight=max_in_flight,
                           submit_timeout=_submit_timeout)


class InputNode(DAGNode):
    """Placeholder for the value passed to execute() (input_node.py:13)."""

    def __init__(self):
        super().__init__((), {})

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False

    def _execute_impl(self, memo, input_value):
        return input_value


class FunctionNode(DAGNode):
    def __init__(self, remote_fn, args, kwargs):
        super().__init__(args, kwargs)
        self._remote_fn = remote_fn

    def _execute_impl(self, memo, input_value):
        import ray_tpu_torch as rt
        from ray_tpu_torch.core.refs import ObjectRef
        args, kwargs = self._resolve_args(memo, input_value)
        # materialize upstream refs are fine as args (worker resolves)
        return self._remote_fn.remote(*args, **kwargs)


class ClassNode(DAGNode):
    """A bound actor-to-be; method .bind() produces ClassMethodNodes."""

    def __init__(self, actor_cls, args, kwargs):
        super().__init__(args, kwargs)
        self._actor_cls = actor_cls
        self._actor_handle = None

    def _execute_impl(self, memo, input_value):
        if self._actor_handle is None:
            args, kwargs = self._resolve_args(memo, input_value)
            # Upstream ObjectRefs pass straight through to .remote(): the
            # constructing worker resolves them, instead of this process
            # blocking on an owner-side rt.get() round trip per ref.
            self._actor_handle = self._actor_cls.remote(*args, **kwargs)
        return self._actor_handle

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        return _MethodBinder(self, name)


class _MethodBinder:
    def __init__(self, class_node: ClassNode, method: str):
        self._class_node = class_node
        self._method = method

    def bind(self, *args, **kwargs) -> "ClassMethodNode":
        return ClassMethodNode(self._class_node, self._method, args, kwargs)


class ClassMethodNode(DAGNode):
    def __init__(self, class_node: ClassNode, method: str, args, kwargs):
        super().__init__(args, kwargs)
        self._class_node = class_node
        self._method = method

    def _execute_impl(self, memo, input_value):
        handle = self._class_node._execute_memo(memo, input_value)
        args, kwargs = self._resolve_args(memo, input_value)
        return getattr(handle, self._method).remote(*args, **kwargs)


class MultiOutputNode(DAGNode):
    """Root node bundling several leaves so one execute() returns all of
    them (parity: python/ray/dag/output_node.py MultiOutputNode)."""

    def __init__(self, outputs):
        outputs = list(outputs)
        if not outputs:
            raise ValueError("MultiOutputNode requires at least one output")
        for o in outputs:
            if not isinstance(o, DAGNode):
                raise TypeError(
                    f"MultiOutputNode outputs must be DAGNodes, got "
                    f"{type(o).__name__}")
        super().__init__(tuple(outputs), {})

    def _execute_impl(self, memo, input_value):
        args, _ = self._resolve_args(memo, input_value)
        return list(args)

    def execute(self, input_value: Any = None):
        """Returns one value per bundled leaf, refs resolved elementwise."""
        import ray_tpu_torch as rt
        from ray_tpu_torch.core.refs import ObjectRef
        out = self._execute_memo({}, input_value)
        return [rt.get(o) if isinstance(o, ObjectRef) else o for o in out]
