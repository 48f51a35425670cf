"""GCS metrics manager: hosts the cluster health plane.

Assembles the health store + SLO engine behind three RPCs
(``push_metrics`` / ``query_metrics`` / ``get_demand_signals``) plus
the scorecard reads (``get_health`` / ``get_alerts``), and runs the
evaluation loop on the gcs-io event loop.

Ingest paths:

* workers/raylets/dashboard push cumulative registry snapshots (or ad-
  hoc gauge points) via ``push_metrics`` — batched + bounded sender in
  ``health/push.py``;
* the GCS process itself installs a DIRECT push sink (first-wins, so in
  an embedded head the one process-wide pusher is GCS-labeled and ships
  the shared registry exactly once);
* the eval loop self-samples control-plane state that lives outside any
  registry: nodes-alive, the event manager's per-type totals (as the
  ``ray_tpu_events_by_type_total{type}`` counter family the shed /
  deadline / rl-starvation rules watch), and pending placement-group
  bundles. Those series are excluded from this process's registry push
  so they enter the store exactly once, with counter semantics.
"""

from __future__ import annotations

import asyncio
import logging
import threading
import time
from typing import Any, Dict, Optional

from ray_tpu_torch._private.config import CONFIG
from ray_tpu_torch.health import MetricsStore, SloEngine
from ray_tpu_torch.health import demand as health_demand
from ray_tpu_torch.health import push as health_push
from ray_tpu_torch.util import metrics as um

logger = logging.getLogger(__name__)

# control-plane families the eval loop feeds into the store directly;
# they must not ALSO arrive via this process's registry pusher
_SELF_SAMPLED = (
    "ray_tpu_events_by_type_total",
    "ray_tpu_cluster_nodes_alive",
    "ray_tpu_pending_pg_bundles",
)


class GcsMetricsManager:
    """Thread-safe like GcsEventManager: the embedded deployment's
    direct push sink appends from the pusher THREAD while handlers and
    the eval loop run on the gcs-io loop (the store carries the lock)."""

    def __init__(self, node_manager, event_manager):
        self._node_manager = node_manager
        self._event_manager = event_manager
        self.store = MetricsStore()
        self.engine = SloEngine(self.store)
        # "<source>#<pid>" -> last push stats (pushed / dropped / time);
        # written from the pusher thread AND the gcs-io loop
        self._sources: Dict[Any, dict] = {}
        self._sources_lock = threading.Lock()
        # event types whose counter series got a zero-baseline primer
        # (only touched by sample_control_plane on the gcs-io loop)
        self._primed_types: set = set()
        # exposition mirrors of the self-sampled control-plane series, so
        # the health plane's own inputs appear in prometheus_text()
        self._nodes_gauge = um.get_or_create_gauge(
            "ray_tpu_cluster_nodes_alive",
            "Alive raylets registered with the GCS.")
        self._pending_pg_gauge = um.get_or_create_gauge(
            "ray_tpu_pending_pg_bundles",
            "Placement-group bundles waiting for feasible nodes.")
        self._events_gauge = um.get_or_create_gauge(
            "ray_tpu_events_by_type_total",
            "Cluster lifecycle events received by the GCS, by type "
            "(cumulative; exposed as a gauge mirror of the event "
            "manager's counts).", ("type",))
        for name in _SELF_SAMPLED:
            health_push.exclude_prefix(name)
        # first-wins: in an embedded head this makes the GCS the process's
        # single registry pusher; standalone worker/raylet processes
        # install their RPC sinks instead (raylet.py / core_worker.py)
        self._push_token = health_push.set_push_sink(
            self.add_local, "gcs")

    # -- ingest ---------------------------------------------------------------

    def add_local(self, payload: Dict) -> None:
        """Direct sink for the in-process pusher: same path the RPC
        handler takes, minus the wire."""
        source = str(payload.get("source") or "?")
        pid = payload.get("pid")
        t = float(payload.get("time") or time.time())
        snapshot = payload.get("snapshot")
        if snapshot:
            self.store.ingest_snapshot(f"{source}#{pid}", t, snapshot)
        points = payload.get("points")
        if points:
            self.store.ingest_points(f"{source}#{pid}", t, points)
        stats = payload.get("stats")
        if stats is not None:
            with self._sources_lock:
                self._sources[pid] = {"source": source,
                                      "received": time.time(), **stats}
                if len(self._sources) > 512:
                    for p, _ in sorted(
                            self._sources.items(),
                            key=lambda kv: kv[1].get("received", 0.0)
                    )[:len(self._sources) - 512]:
                        self._sources.pop(p, None)

    async def handle_push_metrics(self, payload):
        self.add_local(payload)
        return True

    # -- control-plane self-sampling ------------------------------------------

    def sample_control_plane(self, now: Optional[float] = None) -> None:
        now = now if now is not None else time.time()
        alive = sum(1 for info in self._node_manager._nodes.values()
                    if info.alive)
        self.store.ingest_gauge(now, "ray_tpu_cluster_nodes_alive",
                                None, float(alive))
        self._nodes_gauge.set(float(alive))
        locator = getattr(self._node_manager, "pg_locator", None)
        if locator is not None:
            try:
                pending = len(locator.pending_bundle_shapes())
            except Exception:  # noqa: BLE001 — sampling never breaks eval
                pending = 0
            self.store.ingest_gauge(now, "ray_tpu_pending_pg_bundles",
                                    None, float(pending))
            self._pending_pg_gauge.set(float(pending))
        with self._event_manager._lock:
            counts = dict(self._event_manager._type_counts)
        for etype, count in counts.items():
            # the event manager and this store share the GCS's lifetime,
            # so a type's true pre-history is ZERO — prime the watermark
            # so the FIRST event of a type registers as a delta of 1
            # (the generic baseline rule would swallow it, and a drill's
            # single injected kill would be invisible to rate rules)
            if etype not in self._primed_types:
                # raylint: disable=cross-domain-mutation — only the
                # gcs-io loop's eval_loop calls sample_control_plane;
                # the pusher thread never reaches it
                self._primed_types.add(etype)
                self.store.ingest_counter_absolute(
                    "gcs", now, "ray_tpu_events_by_type_total",
                    {"type": etype}, 0.0)
            self.store.ingest_counter_absolute(
                "gcs", now, "ray_tpu_events_by_type_total",
                {"type": etype}, float(count))
            self._events_gauge.set(float(count), tags={"type": etype})

    async def eval_loop(self) -> None:
        """Runs on the gcs-io loop for the GCS's lifetime (cancelled in
        GcsServer.stop)."""
        while True:
            await asyncio.sleep(max(0.1, CONFIG.health_eval_interval_s))
            try:
                self.sample_control_plane()
                self.engine.evaluate()
            except Exception:  # noqa: BLE001 — the evaluator must never die
                logger.debug("health eval pass failed", exc_info=True)

    # -- queries --------------------------------------------------------------

    async def handle_query_metrics(self, payload):
        return self.store.query(
            name=payload.get("name"),
            tags=payload.get("tags"),
            since=payload.get("since"),
            until=payload.get("until"),
            resolution=payload.get("resolution", "raw"),
            limit_series=int(payload.get("limit_series", 200)))

    async def handle_get_demand_signals(self, payload):
        load = await self._node_manager.handle_get_cluster_load({})
        return health_demand.compute_demand_signals(
            self.store, load, len(self.engine.active_alerts()))

    async def handle_get_alerts(self, payload):
        return {"active": self.engine.active_alerts(),
                "history": self.engine.history()}

    async def handle_get_health(self, payload):
        now = time.time()
        load = await self._node_manager.handle_get_cluster_load({})
        with self._sources_lock:
            sources = {pid: dict(st) for pid, st in self._sources.items()}
        return {
            "time": round(now, 3),
            "scorecard": self.engine.scorecard(now),
            "alerts": self.engine.active_alerts(),
            "demand": health_demand.compute_demand_signals(
                self.store, load, len(self.engine.active_alerts()), now),
            "store": self.store.stats(),
            "push_sources": {
                f"{st.get('source')}#{pid}": {
                    "pushed": st.get("pushed", 0),
                    "dropped": st.get("dropped", 0),
                    "lag_s": max(0.0, now - st.get("received", now)),
                }
                for pid, st in sources.items()
            },
        }

    def stop(self) -> None:
        health_push.clear_push_sink(self._push_token)
