"""ray_tpu_torch.serve — model serving on either of the port's runtimes.
Ported from ``ray_tpu/serve/``.

Parity surface: reference python/ray/serve — ServeController singleton
actor (controller.py:73) reconciling deployments into replica actors
(_private/deployment_state.py), HTTP proxy (_private/http_proxy.py:250),
queue-aware handle routing (_private/router.py:263), dynamic request
batching (@serve.batch), deployment autoscaling
(_private/autoscaling_policy.py).

On the cluster runtime (``init(address=...)``) the controller, the HTTP
proxy and every replica are worker processes, as in the JAX package, and
a deployment must be defined at module level (it ships by import path);
on the in-process runtime they are actors of this process. A deployment
replica can hold a card (``num_gpus`` in ``ray_actor_options``) and
@serve.batch turns concurrent requests into one batched forward on it.
``serve.run(..., compile=True)`` sends the returned handle's calls through
a compiled graph on each replica's worker. Serve itself holds no tensor
and takes no device: the deployment's model does.

Ingress hardening: the proxy sheds past per-deployment queue budgets
(503 + Retry-After), admitted requests carry a deadline (504 with the
replica call cancelled), handles retry dead/shed calls once on a
different replica, @serve.batch adapts its flush window to a p99 target,
and scale-down/delete drains replicas gracefully (DRAINING off the
routing table, in-flight requests finish, then kill).
"""

from ray_tpu_torch.serve.api import (Application, Deployment, ServeCallRef,
                                     batch, delete, deployment,
                                     get_deployment_handle, run, shutdown,
                                     status)
from ray_tpu_torch.serve.controller import ReplicaBusyError
from ray_tpu_torch.serve.http_proxy import StreamingResponse

__all__ = ["deployment", "run", "delete", "shutdown", "status",
           "get_deployment_handle", "batch", "Deployment", "Application",
           "StreamingResponse", "ServeCallRef", "ReplicaBusyError"]
