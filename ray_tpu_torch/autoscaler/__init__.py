"""ray_tpu_torch.autoscaler — load-driven cluster scaling, ported from
``ray_tpu/autoscaler/``. Its GCP TPU-VM provider (``gcp.py``) becomes a
GCE GPU-VM provider (``gce.py``) that scales whole NVLink domains.

Parity surface: reference python/ray/autoscaler — StandardAutoscaler
(_private/autoscaler.py:172), bin-packing ResourceDemandScheduler
(_private/resource_demand_scheduler.py:101), pluggable NodeProvider
(node_provider.py) with the fake in-process provider
(_private/fake_multi_node/) for tests. A node type's ``"GPU"`` count
becomes the cards its daemon leases out.
"""

from ray_tpu_torch.autoscaler.autoscaler import (FakeNodeProvider,
                                                 NodeProvider,
                                                 StandardAutoscaler,
                                                 fit_demand)

__all__ = ["StandardAutoscaler", "NodeProvider", "FakeNodeProvider",
           "fit_demand"]
