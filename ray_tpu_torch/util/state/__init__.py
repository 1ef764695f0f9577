"""State observability API (reference: python/ray/util/state); the port's
copy of ``ray_tpu/util/state``."""

from .api import (StateApiClient, available_resources, cluster_resources,
                  get_actor, get_log, get_node, get_placement_group,
                  get_task,
                  list_actors, list_cluster_events, list_jobs, list_logs,
                  list_nodes, list_objects,
                  list_placement_groups, list_tasks, list_workers,
                  summarize_actors, summarize_objects, summarize_tasks,
                  timeline)

__all__ = [
    "StateApiClient", "available_resources", "cluster_resources",
    "get_actor", "get_log", "get_node", "get_placement_group", "get_task",
    "list_actors", "list_cluster_events", "list_jobs", "list_logs",
    "list_nodes", "list_objects",
    "list_placement_groups", "list_tasks", "list_workers",
    "summarize_actors", "summarize_objects", "summarize_tasks", "timeline",
]
