"""State API: cluster-wide introspection. Ported from ``ray_tpu/state/``.

Role parity: python/ray/experimental/state/api.py (list_actors, list_tasks,
list_nodes, list_objects, list_placement_groups, summarize_tasks) backed by
the conductor's tables (the role of GCS + dashboard/state_aggregator.py),
plus span listing (util/tracing) and on-demand worker profiling
(util/profiler; the reporter module's py-spy role).
"""

from ray_tpu_torch.state.api import (debug_state, list_actors,
                                     list_cluster_events, list_nodes,
                                     list_objects, list_placement_groups,
                                     list_ring_events, list_spans,
                                     list_tasks, profile_worker,
                                     summarize_tasks)

__all__ = ["list_actors", "list_tasks", "list_nodes", "list_objects",
           "list_placement_groups", "list_cluster_events", "list_spans",
           "list_ring_events", "debug_state", "profile_worker",
           "summarize_tasks"]
