"""Client proxy: thin drivers over an in-cluster proxy. Ported from
``ray_tpu/client/``.

Role parity: python/ray/util/client — ``ray.init("ray://...")``. Here:
``ray_tpu_torch.init(address="client://host:port")`` (thin Python client)
against a proxy started by ``serve_proxy`` or ``python -m ray_tpu_torch
client-server``.
"""

from ray_tpu_torch.client.runtime import ClientRuntime
from ray_tpu_torch.client.server import ClientProxy, serve_proxy

__all__ = ["ClientProxy", "ClientRuntime", "serve_proxy"]
