"""ray_tpu_torch.workflow — durable DAG execution, ported from
``ray_tpu/workflow/`` onto the port's ``dag/nodes.py``.

Parity surface: reference python/ray/workflow (workflow_executor.py,
workflow_state_from_storage.py, workflow_storage.py, the event system):
run a DAG of tasks where every step's result is checkpointed to
pluggable storage; a crashed/resumed workflow skips completed steps and
recomputes only the rest. Steps may return ``continuation(sub_dag)``
(dynamic workflows) and wait on externally-delivered ``event``s. Step
functions must be defined at module level (execution.py says why).
"""

from ray_tpu_torch.workflow.execution import (continuation, delete, event,
                                              get_output, get_status,
                                              list_all, resume, run,
                                              run_async, send_event,
                                              set_storage)

__all__ = ["run", "run_async", "resume", "get_output", "get_status",
           "list_all", "delete", "continuation", "event", "send_event",
           "set_storage"]
