"""ray_tpu_torch: the PyTorch and CUDA port of ray_tpu.

The JAX package ``ray_tpu`` stays the reference. This package serves and
trains the flagship LM, trains the ViT and ResNet-50 (``models``, ``train``)
and trains RL policies (``rl``: PPO, IMPALA, APPO, A2C, DQN, SAC, TD3,
DDPG and offline BC, MARWIL and CQL) on an NVIDIA Hopper card (H100)
through the same entry points as the JAX package, with each TPU kernel
rewritten by hand in CUDA C++ for ``sm_90a``. Its core API (``init``,
``remote``, ``get``, ``put``, ...) is the JAX package's, over the port's own
in-process runtime: tasks on a thread pool, actors on threads. It imports
torch and numpy only, never JAX nor ``ray_tpu``. What is ported so far, and
what is queued, is in ROADMAP.md.

    import ray_tpu_torch as rt

    rt.init()
    @rt.remote
    def f(x): return x + 1
    rt.get(f.remote(1))   # -> 2
"""

from ray_tpu_torch._device import device_name, require_sm90, resolve_device
from ray_tpu_torch.core.actor import ActorHandle
from ray_tpu_torch.core.api import (available_resources, cancel,
                                    cluster_resources, get, get_actor,
                                    get_runtime_context, init,
                                    is_initialized, kill, method, nodes, put,
                                    remote, shutdown, timeline, wait)
from ray_tpu_torch.core.exceptions import (ActorDiedError, ActorError,
                                           GetTimeoutError, ObjectLostError,
                                           RayTpuError, TaskError,
                                           WorkerCrashedError)
from ray_tpu_torch.core.refs import ObjectRef

__all__ = [
    "init", "shutdown", "is_initialized", "get", "put", "wait", "remote",
    "cancel", "kill", "get_actor", "method", "get_runtime_context",
    "timeline", "nodes", "cluster_resources", "available_resources",
    "ObjectRef", "ActorHandle", "RayTpuError", "TaskError", "ActorError",
    "ActorDiedError", "ObjectLostError", "GetTimeoutError",
    "WorkerCrashedError", "resolve_device", "device_name", "require_sm90",
]
