"""Lazy call graphs, ported from ``ray_tpu/dag/`` (parity: python/ray/dag
— DAGNode dag_node.py:23, FunctionNode function_node.py:12, ClassNode
class_node.py:16, InputNode input_node.py:13, MultiOutputNode
output_node.py). Build with ``fn.bind(...)``, execute with
``dag.execute(input)``; nodes memoize within one execution.
``dag.experimental_compile(max_in_flight=N)`` turns a bound actor-method
graph into a static plan over persistent shm channels (dag/compiled.py),
which needs the port's cluster runtime."""

from ray_tpu_torch.dag.nodes import (ClassMethodNode, ClassNode, DAGNode,
                                     FunctionNode, InputNode,
                                     MultiOutputNode)

__all__ = ["DAGNode", "FunctionNode", "ClassNode", "ClassMethodNode",
           "InputNode", "MultiOutputNode", "CompiledGraph",
           "CompiledGraphRef", "stage_programs", "bubble_bound",
           "validate_programs", "PipeOp"]


def __getattr__(name):
    # CompiledGraph/CompiledGraphRef import lazily: dag/__init__ is pulled
    # in by the public package init, and compiled.py reaches into cluster
    # modules that workers may not want at import time.
    if name in ("CompiledGraph", "CompiledGraphRef"):
        from ray_tpu_torch.dag import compiled
        return getattr(compiled, name)
    if name in ("stage_programs", "bubble_bound", "validate_programs",
                "PipeOp"):
        from ray_tpu_torch.dag import schedule
        return getattr(schedule, name)
    raise AttributeError(name)
