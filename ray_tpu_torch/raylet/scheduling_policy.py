"""Cluster scheduling policies.

Role of the reference's scheduling policy suite
(ray: src/ray/raylet/scheduling/policy/ — hybrid_scheduling_policy.h:36-50
pack-then-spread with top-k randomization, spread_scheduling_policy.cc,
node_affinity, bundle policies in bundle_scheduling_policy.cc). Policies are
pure functions over a `view`: {node_id: (total: Resources, available:
Resources)} so both raylets (cluster task manager) and the GCS (actor/PG
schedulers) share them.
"""

from __future__ import annotations

import random
from typing import Dict, List, Optional, Tuple

from ray_tpu_torch._private.config import CONFIG
from ray_tpu_torch._private.ids import NodeID
from ray_tpu_torch._private.specs import Resources, resources_fit

View = Dict[NodeID, Tuple[Resources, Resources]]  # node -> (total, available)


def _critical_resource_utilization(total: Resources, available: Resources) -> float:
    """Max utilization across resources the node actually has (hybrid scorer,
    reference: scorer.cc / hybrid_scheduling_policy.cc)."""
    util = 0.0
    for k, t in total.items():
        if t <= 0 or k.startswith("node:"):
            continue
        used = t - available.get(k, 0.0)
        util = max(util, used / t)
    return util


def hybrid_policy(
    view: View,
    demand: Resources,
    local_node: Optional[NodeID],
    spread_threshold: Optional[float] = None,
) -> Optional[NodeID]:
    """Pack onto low-utilization nodes (local first) below the threshold;
    above it, spread via top-k random choice among best-scored nodes."""
    if spread_threshold is None:
        spread_threshold = CONFIG.scheduler_spread_threshold
    feasible = [
        nid for nid, (total, _a) in view.items() if resources_fit(total, demand)
    ]
    if not feasible:
        return None
    available_now = [
        nid for nid in feasible if resources_fit(view[nid][1], demand)
    ]
    pool = available_now or feasible
    scored: List[Tuple[float, int, NodeID]] = []
    for nid in pool:
        total, avail = view[nid]
        util = _critical_resource_utilization(total, avail)
        # Below threshold: prefer packing (lower util first, local preferred).
        is_local = 0 if nid == local_node else 1
        if util < spread_threshold:
            scored.append((0.0, is_local, nid))
        else:
            scored.append((util, is_local, nid))
    scored.sort(key=lambda t: (t[0], t[1]))
    best_score = scored[0][0]
    top = [t for t in scored if t[0] == best_score]
    k = max(1, int(len(top) * CONFIG.scheduler_top_k_fraction))
    return random.choice(top[:k])[2] if len(top) > 1 else top[0][2]


def spread_policy(
    view: View, demand: Resources, rr_counter: int
) -> Optional[NodeID]:
    """Round-robin over feasible nodes (reference: spread policy)."""
    feasible = sorted(
        nid for nid, (total, avail) in view.items()
        if resources_fit(avail, demand) or resources_fit(total, demand)
    )
    if not feasible:
        return None
    return feasible[rr_counter % len(feasible)]


def node_affinity_policy(
    view: View, demand: Resources, target: NodeID, soft: bool, local_node: Optional[NodeID]
) -> Optional[NodeID]:
    if target in view and resources_fit(view[target][0], demand):
        return target
    if soft:
        return hybrid_policy(view, demand, local_node)
    return None


def _labels_match(labels: Dict[str, str], constraints: Dict[str, object]
                  ) -> bool:
    """{key: value} = equality, {key: None} = key exists,
    {key: [v1, v2]} = value in set (reference: node-label scheduling's
    In/Exists operators, node_label_scheduling_policy.cc)."""
    for key, want in (constraints or {}).items():
        have = labels.get(key)
        if want is None:
            if key not in labels:
                return False
        elif isinstance(want, (list, tuple, set)):
            if have not in want:
                return False
        elif have != want:
            return False
    return True


def node_label_policy(
    view: View,
    demand: Resources,
    labels: Dict[NodeID, Dict[str, str]],
    hard: Dict[str, object],
    soft: Dict[str, object],
    local_node: Optional[NodeID],
) -> Optional[NodeID]:
    """Hard label constraints filter; soft constraints prefer. Within each
    tier, hybrid pack-then-spread ordering (reference:
    scheduling/policy/node_label_scheduling_policy.cc)."""
    eligible = {
        nid: ta for nid, ta in view.items()
        if _labels_match(labels.get(nid, {}), hard)
    }
    if not eligible:
        return None
    preferred = {
        nid: ta for nid, ta in eligible.items()
        if _labels_match(labels.get(nid, {}), soft)
    }
    for tier in (preferred, eligible):
        if tier:
            pick = hybrid_policy(tier, demand, local_node)
            if pick is not None:
                return pick
    return None
