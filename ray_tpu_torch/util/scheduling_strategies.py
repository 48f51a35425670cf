"""Scheduling strategies.

Reference: ray python/ray/util/scheduling_strategies.py —
PlacementGroupSchedulingStrategy (:41), NodeAffinitySchedulingStrategy (:135)
and the "DEFAULT"/"SPREAD" string strategies (:15).
"""

from __future__ import annotations

from typing import Optional, Union

from ray_tpu_torch._private.specs import SchedulingStrategySpec


class PlacementGroupSchedulingStrategy:
    def __init__(
        self,
        placement_group,
        placement_group_bundle_index: int = -1,
        placement_group_capture_child_tasks: Optional[bool] = None,
    ):
        self.placement_group = placement_group
        self.placement_group_bundle_index = placement_group_bundle_index
        self.placement_group_capture_child_tasks = placement_group_capture_child_tasks


class NodeAffinitySchedulingStrategy:
    def __init__(self, node_id, soft: bool = False):
        # Accepts a NodeID or its hex string.
        self.node_id = node_id
        self.soft = soft


class NodeLabelSchedulingStrategy:
    def __init__(self, hard: Optional[dict] = None, soft: Optional[dict] = None):
        self.hard = hard or {}
        self.soft = soft or {}


SchedulingStrategyT = Union[
    None, str, PlacementGroupSchedulingStrategy,
    NodeAffinitySchedulingStrategy, NodeLabelSchedulingStrategy,
]


def to_spec(strategy: SchedulingStrategyT, options: dict) -> SchedulingStrategySpec:
    """Lower user-facing strategy objects to the wire spec."""
    from ray_tpu_torch._private.ids import NodeID

    pg = options.get("placement_group")
    if pg is not None and strategy is None:
        strategy = PlacementGroupSchedulingStrategy(
            pg, options.get("placement_group_bundle_index", -1)
        )
    if strategy is None or strategy == "DEFAULT":
        return SchedulingStrategySpec(kind="DEFAULT")
    if strategy == "SPREAD":
        return SchedulingStrategySpec(kind="SPREAD")
    if isinstance(strategy, PlacementGroupSchedulingStrategy):
        pg = strategy.placement_group
        pg_id = getattr(pg, "id", pg)
        return SchedulingStrategySpec(
            kind="PLACEMENT_GROUP",
            placement_group_id=pg_id,
            bundle_index=strategy.placement_group_bundle_index,
            capture_child_tasks=bool(strategy.placement_group_capture_child_tasks),
        )
    if isinstance(strategy, NodeAffinitySchedulingStrategy):
        node_id = strategy.node_id
        if isinstance(node_id, str):
            node_id = NodeID.from_hex(node_id)
        return SchedulingStrategySpec(
            kind="NODE_AFFINITY", node_id=node_id, soft=strategy.soft
        )
    if isinstance(strategy, NodeLabelSchedulingStrategy):
        return SchedulingStrategySpec(
            kind="NODE_LABEL", hard_labels=dict(strategy.hard),
            soft_labels=dict(strategy.soft))
    raise ValueError(f"unsupported scheduling strategy: {strategy!r}")
