"""Placement groups: gang resource reservation API.

Reference: ray python/ray/util/placement_group.py (placement_group :145,
PlacementGroup handle with .ready()/.wait(), remove_placement_group,
get_placement_group, placement_group_table).
"""

from __future__ import annotations

from typing import Dict, List, Optional

from ray_tpu_torch._private.ids import PlacementGroupID
from ray_tpu_torch._raylet import get_core_worker


_READY_TASK = None


def _pg_ready_task():
    """Module-level remote fn shared by every PlacementGroup.ready() call:
    a per-call closure would mint a fresh function id (= fresh scheduling
    key) each time, so no lease is ever reused and every ready() pays a
    worker spawn (~200ms instead of ~1ms)."""
    global _READY_TASK
    if _READY_TASK is None:
        from ray_tpu_torch.api import remote

        @remote
        def _wait_placement_group_ready(pg_id):
            get_core_worker().wait_placement_group_ready(pg_id)
            return True

        _READY_TASK = _wait_placement_group_ready
    return _READY_TASK


class PlacementGroup:
    def __init__(self, pg_id: PlacementGroupID, bundles: Optional[List[dict]] = None):
        self.id = pg_id
        self._bundles = bundles

    def ready(self):
        """ObjectRef-style awaitable: returns a ref resolved when ready
        (reference returns a task ref; we run the wait in a task)."""
        return _pg_ready_task().options(num_cpus=0).remote(self.id)

    def wait(self, timeout_seconds: Optional[float] = None) -> bool:
        return get_core_worker().wait_placement_group_ready(
            self.id, timeout=timeout_seconds if timeout_seconds is not None else -1
        )

    @property
    def bundle_specs(self) -> List[dict]:
        if self._bundles is None:
            info = get_core_worker()._gcs.call(
                "get_placement_group", {"placement_group_id": self.id}
            )
            self._bundles = info.spec.bundles if info else []
        return self._bundles

    @property
    def bundle_count(self) -> int:
        return len(self.bundle_specs)

    def __eq__(self, other):
        return isinstance(other, PlacementGroup) and other.id == self.id

    def __hash__(self):
        return hash(self.id)

    def __reduce__(self):
        return (PlacementGroup, (self.id, self._bundles))


def placement_group(
    bundles: List[Dict[str, float]],
    strategy: str = "PACK",
    name: str = "",
    lifetime: Optional[str] = None,
) -> PlacementGroup:
    if strategy not in ("PACK", "SPREAD", "STRICT_PACK", "STRICT_SPREAD"):
        raise ValueError(f"invalid placement group strategy {strategy}")
    if not bundles:
        raise ValueError("placement group requires at least one bundle")
    for b in bundles:
        if not b or any(v < 0 for v in b.values()):
            raise ValueError(f"invalid bundle {b}")
    cw = get_core_worker()
    pg_id = cw.create_placement_group(
        bundles, strategy=strategy, name=name, lifetime=lifetime
    )
    return PlacementGroup(pg_id, [dict(b) for b in bundles])


def remove_placement_group(pg: PlacementGroup) -> None:
    get_core_worker().remove_placement_group(pg.id)


def get_placement_group(name: str) -> PlacementGroup:
    info = get_core_worker()._gcs.call("get_placement_group", {"name": name})
    if info is None:
        raise ValueError(f"placement group '{name}' not found")
    return PlacementGroup(info.spec.placement_group_id, info.spec.bundles)


def placement_group_table() -> dict:
    infos = get_core_worker()._gcs.call("list_placement_groups", {})
    return {
        info.spec.placement_group_id.hex(): {
            "name": info.spec.name,
            "strategy": info.spec.strategy,
            "state": info.state.name,
            "bundles": {i: b for i, b in enumerate(info.spec.bundles)},
            "bundle_locations": {
                i: n.hex() for i, n in info.bundle_locations.items()
            },
        }
        for info in infos
    }
