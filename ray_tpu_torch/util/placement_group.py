"""Placement groups: gang reservation of resource bundles across nodes.

Public API mirroring the reference (reference: python/ray/util/
placement_group.py:41 PlacementGroup, :145 placement_group()), backed by the
control plane's 2-phase PREPARE/COMMIT bundle reservation (reference:
src/ray/raylet/placement_group_resource_manager.h:54-61).  Strategies:
PACK / SPREAD / STRICT_PACK / STRICT_SPREAD.

The port's copy of ``ray_tpu/util/placement_group.py``; a bundle asks
for cards with ``"GPU"`` where the reference's asks for chips with
``"TPU"``.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

from .._private import common
from .._private.core import current_core

VALID_STRATEGIES = ("PACK", "SPREAD", "STRICT_PACK", "STRICT_SPREAD")


class PlacementGroup:
    """Handle to a (possibly still-scheduling) placement group."""

    def __init__(self, pg_id: str,
                 bundles: Optional[List[Dict[str, float]]] = None,
                 create_future=None):
        self.id = pg_id
        self._bundles = bundles
        self._create_future = create_future  # never pickled (__reduce__)

    @property
    def bundle_specs(self) -> List[Dict[str, float]]:
        if self._bundles is None:
            view = self._view()
            self._bundles = view["bundles"] if view else []
        return self._bundles

    @property
    def bundle_count(self) -> int:
        return len(self.bundle_specs)

    def _view(self):
        return current_core().control.call("get_pg", {"pg_id": self.id})

    def ready(self, timeout: Optional[float] = None) -> bool:
        """Block until all bundles are reserved (or the group failed).

        The reference returns an ObjectRef from a probe task scheduled in
        bundle 0 (placement_group.py:75); here the create RPC's deferred
        reply resolves exactly when scheduling finishes, so the handle
        that created the group waits on that — no poll interval in the
        churn path.  Deserialized handles fall back to a state poll.
        """
        deadline = None if timeout is None else time.monotonic() + timeout
        fut = self._create_future
        if fut is not None:
            from concurrent.futures import TimeoutError as FutTimeout

            # the future is a wait signal only — state is then read live
            # below (the reply snapshot could predate a node loss or a
            # concurrent remove_placement_group)
            try:
                fut.result(timeout=timeout)
            except FutTimeout:
                return False
            except Exception:
                pass  # control hiccup: the poll decides
            self._create_future = None
        while True:
            view = self._view()
            if view is None:
                raise ValueError(f"placement group {self.id} does not exist")
            if view["state"] == "ALIVE":
                return True
            if view["state"] == "DEAD":
                return False
            if deadline is not None and time.monotonic() > deadline:
                return False
            time.sleep(0.05)

    def wait(self, timeout_seconds: float = 30.0) -> bool:
        return self.ready(timeout=timeout_seconds)

    def __reduce__(self):
        return (PlacementGroup, (self.id, self._bundles))

    def __repr__(self):
        return f"PlacementGroup(id={self.id})"


def placement_group(bundles: List[Dict[str, float]], strategy: str = "PACK",
                    name: str = "", lifetime: Optional[str] = None,
                    ) -> PlacementGroup:
    """Asynchronously create a placement group (reference:
    util/placement_group.py:145)."""
    if strategy not in VALID_STRATEGIES:
        raise ValueError(f"strategy must be one of {VALID_STRATEGIES}")
    if not bundles:
        raise ValueError("bundles must be non-empty")
    for b in bundles:
        if not isinstance(b, dict) or not b:
            raise ValueError(f"each bundle must be a non-empty dict, got {b!r}")
        if any(v < 0 for v in b.values()):
            raise ValueError(f"bundle resources must be >= 0: {b!r}")
    pgid = common.placement_group_id()
    core = current_core()
    # async create: the control plane schedules in the background; handle is
    # usable immediately (tasks against it queue until ALIVE).  The reply
    # resolves when scheduling finishes — ready() consumes it.
    fut = core.control.call_async("create_pg", {
        "pg_id": pgid, "bundles": bundles, "strategy": strategy,
        "name": name, "detached": lifetime == "detached",
    })
    return PlacementGroup(pgid, list(bundles), create_future=fut)


def remove_placement_group(pg: PlacementGroup) -> None:
    """Release all bundles and kill actors/tasks scheduled in them."""
    current_core().control.call("remove_pg", {"pg_id": pg.id}, timeout=30.0)


def get_placement_group(name: str) -> PlacementGroup:
    view = current_core().control.call("get_pg", {"pg_id": None, "name": name})
    if view is None:
        raise ValueError(f"no placement group named {name!r}")
    return PlacementGroup(view["pg_id"], view["bundles"])


def placement_group_table() -> Dict[str, Dict]:
    """All placement groups, keyed by id (reference:
    util/placement_group.py placement_group_table)."""
    views = current_core().control.call("list_pgs", {})
    return {v["pg_id"]: v for v in views}
