"""Demand-signal bus: the autoscaler-ready signals the ROADMAP's
elastic-scaling item needs, derived from the health store plus the
GCS node manager's load view — one structured, versioned dict so a
future autoscaler (or an external one) consumes a stable shape instead
of scraping dashboards.

Pure derivation: no state of its own, recomputed per `get_demand_signals`
call from what the store already holds.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional

DEMAND_SIGNALS_VERSION = 1

# staleness bound for gauge-derived signals: a dead series yields None
# (signal absent), never a stale number an autoscaler would act on
_GAUGE_MAX_AGE_S = 60.0
_RATE_WINDOW_S = 60.0


def compute_demand_signals(store, cluster_load: Optional[Dict[str, Any]],
                           firing_alerts: int,
                           now: Optional[float] = None) -> Dict[str, Any]:
    """`store` is a health MetricsStore; `cluster_load` is the
    node-manager's handle_get_cluster_load shape ({"nodes", "demands",
    "pending_pg_bundles"}) or None if unavailable."""
    now = now if now is not None else time.time()

    serve = {
        "queue_depth": store.latest_gauge(
            "ray_tpu_llm_queue_depth", max_age_s=_GAUGE_MAX_AGE_S, now=now),
        "ttft_p50_s": store.window_quantile(
            "ray_tpu_llm_ttft_seconds", None, _RATE_WINDOW_S, 0.5, now=now),
        "ttft_p99_s": store.window_quantile(
            "ray_tpu_llm_ttft_seconds", None, _RATE_WINDOW_S, 0.99, now=now),
        "request_rate": store.window_rate(
            "ray_tpu_serve_requests_total", None, _RATE_WINDOW_S, now=now),
        "ok_rate": store.window_rate(
            "ray_tpu_serve_requests_total", {"outcome": "ok"},
            _RATE_WINDOW_S, now=now),
        "shed_rate": store.window_rate(
            "ray_tpu_serve_requests_total", {"outcome": "shed"},
            _RATE_WINDOW_S, now=now),
    }
    rl = {
        "sample_shed_rate": store.window_rate(
            "ray_tpu_events_by_type_total", {"type": "rl.sample_shed"},
            _RATE_WINDOW_S, now=now),
        "stale_drop_rate": store.window_rate(
            "ray_tpu_events_by_type_total", {"type": "rl.stale_drop"},
            _RATE_WINDOW_S, now=now),
    }

    pending: Dict[str, Any] = {"pg_bundles": [], "task_demands": []}
    pools: Dict[str, Dict[str, float]] = {}
    nodes_alive = 0
    if cluster_load:
        pending["pg_bundles"] = cluster_load.get("pending_pg_bundles") or []
        pending["task_demands"] = [
            {"resources": shape, "count": count}
            for shape, count, _labels in cluster_load.get("demands") or []]
        for _nid, node in (cluster_load.get("nodes") or {}).items():
            if not node.get("alive"):
                continue
            nodes_alive += 1
            for res, total in (node.get("total") or {}).items():
                pool = pools.setdefault(
                    res, {"total": 0.0, "available": 0.0})
                pool["total"] += float(total)
                pool["available"] += float(
                    (node.get("available") or {}).get(res, 0.0))
        for pool in pools.values():
            used = pool["total"] - pool["available"]
            pool["utilization"] = (used / pool["total"]
                                   if pool["total"] > 0 else 0.0)

    return {
        "version": DEMAND_SIGNALS_VERSION,
        "time": round(now, 3),
        "serve": serve,
        "rl": rl,
        "pending": pending,
        "pools": pools,
        "nodes_alive": nodes_alive,
        "alerts_firing": firing_alerts,
    }
