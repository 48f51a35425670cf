"""GCS server: headnode control plane.

Role of the reference's GcsServer (ray: src/ray/gcs/gcs_server/gcs_server.h,
gcs_server_main.cc), hosting:
  - node membership + health checks (gcs_node_manager.cc,
    gcs_health_check_manager.h:39 — here: heartbeat staleness detection),
  - resource view sync (the ray_syncer equivalent: heartbeat replies carry the
    full cluster resource view back to each raylet),
  - actor manager (actor_manager.py), placement groups (pg_manager.py),
  - jobs (gcs_job_manager.cc), internal KV (gcs_kv_manager.cc) which also
    stores exported functions (gcs_function_manager.h),
  - task events for observability (gcs_task_manager.cc),
  - pubsub (pubsub_handler.cc).

Runs embedded in the head node process on its own EventLoopThread, or
standalone via `python -m ray_tpu_torch.gcs.server`.
"""

from __future__ import annotations

import asyncio
import logging
import threading
import time
from collections import OrderedDict, deque
from fnmatch import fnmatchcase
from typing import Dict, List, Optional

from ray_tpu_torch._private import event_log
from ray_tpu_torch._private import tracing as _tracing
from ray_tpu_torch._private.config import CONFIG
from ray_tpu_torch._private.ids import JobID, NodeID
from ray_tpu_torch._private.rpc import (ClientPool, ConnectionLost,
                                  EventLoopThread, RpcServer)
from ray_tpu_torch._private.specs import (
    JobInfo,
    NodeInfo,
    Resources,
    TaskSpec,
    resources_fit,
)
from ray_tpu_torch.gcs import pubsub as ps
from ray_tpu_torch.gcs.actor_manager import GcsActorManager
from ray_tpu_torch.gcs.metrics_manager import GcsMetricsManager
from ray_tpu_torch.gcs.pg_manager import GcsPlacementGroupManager
from ray_tpu_torch.gcs.storage import make_store

logger = logging.getLogger(__name__)
_elog = event_log.logger_for("gcs")


class GcsNodeManager:
    """Node registry + cluster resource view + failure detection."""

    def __init__(self, publisher: ps.Publisher, store=None):
        self._pub = publisher
        self._store = store
        self._nodes: Dict[NodeID, NodeInfo] = {}
        self._last_heartbeat: Dict[NodeID, float] = {}
        self._pending_demands: Dict[NodeID, list] = {}
        # explicit autoscaler.sdk.request_resources() demand: shapes the
        # cluster must be able to fit even with no tasks queued
        self._requested_resources: list = []
        self._death_listeners = []
        self.pg_locator = None  # wired to GcsPlacementGroupManager by GcsServer
        # Versioned view for delta heartbeats (reference:
        # ray_syncer.h:78-88 — per-node snapshots with version numbers,
        # only newer snapshots relayed). A node's version bumps only when
        # its entry CHANGES, so idle-cluster heartbeat replies are empty
        # deltas instead of the O(N) full view (O(N^2)/period cluster-wide).
        self._view_version = 0
        self._node_versions: Dict[NodeID, int] = {}
        self._removed_log: deque = deque(maxlen=10_000)  # (version, nid)
        self._removed_pruned_below = 0
        self._load_persisted()

    def _persist_node(self, node_id: NodeID) -> None:
        if self._store is None:
            return
        import pickle

        info = self._nodes.get(node_id)
        if info is not None:
            self._store.put("nodes", node_id.binary(),
                            pickle.dumps(info, protocol=5))

    def _load_persisted(self) -> None:
        """Reload the node registry after a GCS restart: live raylets keep
        heartbeating the same address, so their entries pick right back
        up (a fresh heartbeat grace period applies); truly dead nodes age
        out through the normal health check."""
        if self._store is None:
            return
        import pickle

        for key in self._store.keys("nodes"):
            try:
                info = pickle.loads(self._store.get("nodes", key))
            except Exception:  # noqa: BLE001 — skip torn records
                logger.warning("node recovery: skipping torn record %r", key)
                continue
            if info.alive:
                self._nodes[info.node_id] = info
                self._last_heartbeat[info.node_id] = time.monotonic()
                self._bump_node(info.node_id)

    def _bump_node(self, node_id: NodeID) -> None:
        self._view_version += 1
        self._node_versions[node_id] = self._view_version

    def add_death_listener(self, cb):
        self._death_listeners.append(cb)

    # -- RPC --
    async def handle_register_node(self, payload):
        info: NodeInfo = payload["info"]
        self._nodes[info.node_id] = info
        self._last_heartbeat[info.node_id] = time.monotonic()
        self._bump_node(info.node_id)
        self._persist_node(info.node_id)
        self._pub.publish(ps.NODE_CHANNEL, info.node_id, info)
        _elog.emit("node.alive", node_id=info.node_id.hex(),
                   address=info.raylet_address)
        logger.info("node %s registered (%s)", info.node_id.hex()[:8], info.raylet_address)
        return True

    async def handle_unregister_node(self, payload):
        await self._mark_dead(payload["node_id"], expected=True)
        return True

    async def handle_report_resources(self, payload):
        """Raylet heartbeat; the reply syncs the cluster view (syncer
        role). With known_version the reply is a DELTA — only nodes whose
        entries changed since the caller's version, plus removals; a full
        view goes out only on version-gap (or to legacy callers)."""
        node_id: NodeID = payload["node_id"]
        info = self._nodes.get(node_id)
        if info is None or not info.alive:
            return {"status": "unknown_node"}
        if (info.resources_available != payload["available"]
                or info.resources_total != payload.get(
                    "total", info.resources_total)):
            self._bump_node(node_id)
        info.resources_available = payload["available"]
        info.resources_total = payload.get("total", info.resources_total)
        if payload.get("draining") and not getattr(info, "draining", False):
            info.draining = True
            self._bump_node(node_id)
        self._last_heartbeat[node_id] = time.monotonic()
        self._pending_demands[node_id] = payload.get("pending_demands", [])
        known = payload.get("known_version")
        if known is None:
            return {
                "status": "ok",
                "cluster_view": {
                    nid: (n.raylet_address, n.resources_total,
                          n.resources_available, n.labels)
                    for nid, n in self._nodes.items()
                    if n.alive
                },
            }
        if (known and known >= self._removed_pruned_below
                and known <= self._view_version):
            # (known > _view_version means WE restarted and lost version
            # state — fall through to the full view, else the caller would
            # keep a stale view forever)
            delta = {
                nid: (n.raylet_address, n.resources_total,
                      n.resources_available, n.labels)
                for nid, n in self._nodes.items()
                if n.alive and self._node_versions.get(nid, 0) > known
            }
            removed = [nid for v, nid in self._removed_log if v > known]
            return {"status": "ok", "view_version": self._view_version,
                    "cluster_delta": delta, "removed": removed}
        # version gap (fresh raylet, or removals pruned past `known`):
        # resend everything, flagged full so the caller REPLACES its view
        return {
            "status": "ok", "view_version": self._view_version,
            "full": True,
            "cluster_delta": {
                nid: (n.raylet_address, n.resources_total,
                      n.resources_available, n.labels)
                for nid, n in self._nodes.items()
                if n.alive
            },
            "removed": [],
        }

    async def handle_get_all_node_info(self, payload):
        return list(self._nodes.values())

    async def handle_request_resources(self, payload):
        """Programmatic scale-up hint (reference:
        ray.autoscaler.sdk.request_resources — python/ray/autoscaler/
        sdk/sdk.py): the given bundle shapes become standing demand the
        autoscaler must satisfy, REPLACING any previous request (so
        request_resources() with no shapes cancels). Not persisted: like
        the reference, the hint is advisory runtime state."""
        shapes = payload.get("shapes") or []
        self._requested_resources = [
            (dict(s), 1, None) for s in shapes if s]
        return len(self._requested_resources)

    async def handle_get_cluster_load(self, payload):
        """Autoscaler snapshot: per-node usage + aggregated unfulfilled
        demand shapes (reference: GCS load feeding load_metrics.py and the
        autoscaler state API gcs_autoscaler_state_manager.cc)."""
        demands: Dict[tuple, int] = {}
        for nid, shapes in self._pending_demands.items():
            info = self._nodes.get(nid)
            if info is None or not info.alive:
                continue
            for shape, count, labels in shapes:
                from ray_tpu_torch._private.specs import _freeze

                key = (tuple(sorted(shape.items())), _freeze(labels) or ())
                demands[key] = demands.get(key, 0) + count
        pending_pgs = []
        if self.pg_locator is not None:
            pending_pgs = self.pg_locator.pending_bundle_shapes()
        return {
            "nodes": {
                nid.hex(): {
                    "total": dict(n.resources_total),
                    "available": dict(n.resources_available),
                    "alive": n.alive,
                    "is_head": n.is_head,
                    "draining": getattr(n, "draining", False),
                    "labels": dict(n.labels),
                }
                for nid, n in self._nodes.items()
            },
            "demands": [(dict(res), v, dict(labels) or None)
                        for (res, labels), v in demands.items()]
                       + [(dict(s), c, lbl)
                          for s, c, lbl in self._requested_resources],
            "pending_pg_bundles": pending_pgs,
        }

    async def handle_check_alive(self, payload):
        node_ids = payload.get("node_ids") or list(self._nodes)
        return {nid: (nid in self._nodes and self._nodes[nid].alive) for nid in node_ids}

    # -- used by actor/pg schedulers --
    def resource_view(self) -> Dict[NodeID, Resources]:
        return {
            nid: dict(n.resources_available)
            for nid, n in self._nodes.items()
            if n.alive and not getattr(n, "draining", False)
        }

    def label_view(self) -> Dict[NodeID, Dict[str, str]]:
        return {
            nid: dict(n.labels)
            for nid, n in self._nodes.items()
            if n.alive
        }

    def raylet_address(self, node_id: NodeID) -> Optional[str]:
        info = self._nodes.get(node_id)
        return info.raylet_address if info is not None and info.alive else None

    def pick_nodes_for(self, spec: TaskSpec) -> List[NodeID]:
        """Feasible nodes for a task spec, best-first (GCS-side scheduling)."""
        strat = spec.scheduling_strategy
        alive = [n for n in self._nodes.values()
                 if n.alive and not getattr(n, "draining", False)]
        if strat.kind == "PLACEMENT_GROUP" and self.pg_locator is not None:
            info = self.pg_locator._groups.get(strat.placement_group_id)
            if info is None:
                return []
            if strat.bundle_index >= 0:
                node = info.bundle_locations.get(strat.bundle_index)
                return [node] if node is not None else []
            return list(dict.fromkeys(info.bundle_locations.values()))
        if strat.kind == "NODE_AFFINITY":
            out = [n.node_id for n in alive if n.node_id == strat.node_id]
            if out or not strat.soft:
                return out
        soft_pref: set = set()
        if strat.kind == "NODE_LABEL":
            from ray_tpu_torch.raylet.scheduling_policy import _labels_match

            alive = [n for n in alive
                     if _labels_match(n.labels, strat.hard_labels or {})]
            # soft constraints PREFER (sort first below) but never exclude:
            # a preferred node that can't fit must fall back to the other
            # hard-eligible nodes, matching the raylet's tiered policy
            soft_pref = {
                n.node_id for n in alive
                if _labels_match(n.labels, strat.soft_labels or {})}
        candidates = [
            n.node_id
            for n in alive
            if resources_fit(n.resources_available, spec.resources)
            or resources_fit(n.resources_total, spec.resources)
        ]
        # Soft-label-preferred first, then most-available (actors spread by
        # default here; per-task fine-grained policy lives in the raylet's
        # cluster task manager).
        candidates.sort(
            key=lambda nid: (
                nid not in soft_pref,
                -sum(self._nodes[nid].resources_available.values()),
            ),
        )
        return candidates

    # -- health loop --
    async def health_check_loop(self):
        period = CONFIG.health_check_period_ms / 1000.0
        threshold = CONFIG.health_check_failure_threshold
        while True:
            await asyncio.sleep(period)
            now = time.monotonic()
            for node_id, info in list(self._nodes.items()):
                if not info.alive:
                    continue
                last = self._last_heartbeat.get(node_id, now)
                if now - last > period * threshold + CONFIG.heartbeat_period_ms / 1000.0 * threshold:
                    logger.warning("node %s missed heartbeats; marking dead",
                                   node_id.hex()[:8])
                    await self._mark_dead(node_id, expected=False)

    async def _mark_dead(self, node_id: NodeID, expected: bool):
        info = self._nodes.get(node_id)
        if info is None or not info.alive:
            return
        info.alive = False
        info.resources_available = {}
        self._view_version += 1
        self._node_versions.pop(node_id, None)
        self._removed_log.append((self._view_version, node_id))
        if len(self._removed_log) == self._removed_log.maxlen:
            # oldest retained removal sets the floor below which delta
            # requests must fall back to a full view
            self._removed_pruned_below = self._removed_log[0][0] + 1
        self._pending_demands.pop(node_id, None)
        self._last_heartbeat.pop(node_id, None)
        self._persist_node(node_id)
        self._pub.publish(ps.NODE_CHANNEL, node_id, info)
        _elog.emit("node.dead", node_id=node_id.hex(), expected=expected)
        for cb in self._death_listeners:
            try:
                await cb(node_id)
            except Exception:
                logger.exception("node-death listener failed")


class GcsKvManager:
    """Namespaced binary KV (internal KV + function/code storage)."""

    def __init__(self, store):
        self._store = store

    @staticmethod
    def _table(ns: Optional[str]) -> str:
        return "kv:" + (ns or "")

    @staticmethod
    def _key(k) -> bytes:
        """Canonical bytes keys: clients pass str or bytes freely, but a
        table mixing both would break prefix scans (str.startswith(bytes)
        raises) and make the same key a silent miss."""
        return k.encode() if isinstance(k, str) else k

    async def handle_kv_put(self, payload):
        overwrite = payload.get("overwrite", True)
        table = self._table(payload.get("namespace"))
        key = self._key(payload["key"])
        if not overwrite and self._store.get(table, key) is not None:
            return False
        self._store.put(table, key, payload["value"])
        return True

    async def handle_kv_get(self, payload):
        return self._store.get(self._table(payload.get("namespace")),
                               self._key(payload["key"]))

    async def handle_kv_multi_get(self, payload):
        table = self._table(payload.get("namespace"))
        return {k: self._store.get(table, self._key(k))
                for k in payload["keys"]}

    async def handle_kv_multi_put(self, payload):
        """Batch put (one round trip per spill batch, not per object)."""
        table = self._table(payload.get("namespace"))
        for k, v in payload["entries"].items():
            self._store.put(table, self._key(k), v)
        return True

    async def handle_kv_del(self, payload):
        table = self._table(payload.get("namespace"))
        key = self._key(payload["key"])
        if payload.get("del_by_prefix"):
            n = 0
            for k in self._store.keys(table, key):
                n += int(self._store.delete(table, k))
            return n
        return int(self._store.delete(table, key))

    async def handle_kv_keys(self, payload):
        return self._store.keys(
            self._table(payload.get("namespace")),
            self._key(payload.get("prefix", b"")))

    async def handle_kv_exists(self, payload):
        return (
            self._store.get(self._table(payload.get("namespace")),
                            self._key(payload["key"]))
            is not None
        )


class GcsJobManager:
    def __init__(self, publisher: ps.Publisher, store=None):
        self._pub = publisher
        self._store = store
        self._jobs: Dict[JobID, JobInfo] = {}
        self._counter = 0
        self._finish_listeners = []
        if store is not None:
            import pickle

            raw = store.get("meta", b"next_job_id")
            if raw is not None:
                # never reuse job ids across GCS incarnations: task/actor
                # ids embed the job id, so a reset counter would collide
                self._counter = int.from_bytes(raw, "little")
            for key in store.keys("jobs"):
                try:
                    info = pickle.loads(store.get("jobs", key))
                    self._jobs[info.job_id] = info
                except Exception:  # noqa: BLE001 — skip torn records
                    logger.warning(
                        "job recovery: skipping torn record %r", key)

    def add_finish_listener(self, cb):
        self._finish_listeners.append(cb)

    def _persist_job(self, job_id) -> None:
        if self._store is None:
            return
        import pickle

        info = self._jobs.get(job_id)
        if info is not None:
            self._store.put("jobs", job_id.binary(),
                            pickle.dumps(info, protocol=5))

    async def handle_get_next_job_id(self, payload):
        self._counter += 1
        if self._store is not None:
            self._store.put("meta", b"next_job_id",
                            self._counter.to_bytes(8, "little"))
        return JobID.from_int(self._counter)

    async def handle_add_job(self, payload):
        info: JobInfo = payload["info"]
        self._jobs[info.job_id] = info
        self._persist_job(info.job_id)
        self._pub.publish(ps.JOB_CHANNEL, info.job_id, info)
        return True

    async def handle_mark_job_finished(self, payload):
        job_id: JobID = payload["job_id"]
        info = self._jobs.get(job_id)
        if info is not None:
            info.is_dead = True
            info.end_time = time.time()
            self._persist_job(job_id)
            self._pub.publish(ps.JOB_CHANNEL, job_id, info)
        for cb in self._finish_listeners:
            try:
                await cb(job_id)
            except Exception:
                logger.exception("job-finish listener failed")
        return True

    async def handle_get_all_job_info(self, payload):
        return list(self._jobs.values())


class GcsTaskEventManager:
    """Bounded task-event buffer for the state API / timeline.

    Reference: src/ray/gcs/gcs_server/gcs_task_manager.cc fed by per-worker
    TaskEventBuffers.
    """

    def __init__(self, max_events: int = 100_000):
        self._events = deque(maxlen=max_events)

    async def handle_add_task_events(self, payload):
        self._events.extend(payload["events"])
        return True

    async def handle_get_task_events(self, payload):
        limit = payload.get("limit", 10_000)
        job_id = payload.get("job_id")
        # server-side task filter: per-task timelines must not ship the
        # whole 100k-event deque over the wire to keep a handful of rows
        task_id = payload.get("task_id")
        out = []
        for ev in reversed(self._events):
            if job_id is not None and ev.get("job_id") != job_id:
                continue
            if task_id is not None and ev.get("task_id") != task_id:
                continue
            out.append(ev)
            if len(out) >= limit:
                break
        return out


class GcsEventManager:
    """Cluster-wide structured lifecycle event store (the generalized
    sibling of GcsTaskEventManager; reference lineage: gcs_task_manager.cc
    fed by per-worker buffers — here fed by every process's
    _private/event_log flusher).

    Thread-safe: the embedded deployment's direct sink appends from the
    event-log flusher THREAD while handlers read on the gcs-io loop.
    """

    def __init__(self, max_events: int = 200_000):
        self._events = deque(maxlen=max_events)
        self._lock = threading.Lock()
        # "<source>#<pid>" -> last flush stats (depth / dropped / emitted)
        self._sources: Dict[str, dict] = {}
        self._type_counts: Dict[str, int] = {}

    def add_local(self, events: List[dict], stats: Optional[dict]) -> None:
        """Direct sink for an in-process event_log (embedded head node):
        same path the RPC handler takes, minus the wire."""
        with self._lock:
            for ev in events:
                self._events.append(ev)
                t = ev.get("type", "?")
                self._type_counts[t] = self._type_counts.get(t, 0) + 1
            if stats:
                # keyed by pid: a process whose label refines during
                # bring-up ("proc:N" -> "driver:N") stays one row
                now = time.time()
                self._sources[stats.get("pid")] = dict(
                    stats, received=now)
                if len(self._sources) > 512:
                    # worker churn: age out sources silent past the
                    # staleness window (stats reporting marks them stale
                    # first), evicting oldest-first past the cap so dead
                    # pids can't grow this forever (and a recycled pid
                    # can't inherit a dead process's counters for long)
                    for pid, _ in sorted(
                            self._sources.items(),
                            key=lambda kv: kv[1].get("received", 0.0)
                    )[:len(self._sources) - 512]:
                        self._sources.pop(pid, None)

    async def handle_add_cluster_events(self, payload):
        self.add_local(payload.get("events") or [],
                       payload.get("stats"))
        return True

    async def handle_get_cluster_events(self, payload):
        """Filtered query, newest-first (callers re-sort for timelines).
        Filters: type (glob), task_id/actor_id/node_id/object_id (exact),
        since (wall time), limit."""
        limit = payload.get("limit", 10_000)
        type_glob = payload.get("type")
        since = payload.get("since")
        id_filters = [(k, payload[k]) for k in
                      ("task_id", "actor_id", "node_id", "object_id",
                       "trace_id")
                      if payload.get(k)]
        out = []
        stale_run = 0
        with self._lock:
            events = list(self._events)
        for ev in reversed(events):
            if since is not None and ev.get("time", 0) < since:
                # Arrival order only approximates event time, so one
                # stale event must not stop the scan — but a long
                # CONSECUTIVE run of them means we are past any
                # realistic flush-lag inversion and the rest of the
                # deque is history. Without this, every 1s preempt
                # watcher poll scans the full 100k ring even when the
                # cluster is idle.
                stale_run += 1
                if stale_run >= 2048:
                    break
                continue
            stale_run = 0
            if type_glob and not fnmatchcase(ev.get("type", ""), type_glob):
                continue
            if any(ev.get(k) != v for k, v in id_filters):
                continue
            out.append(ev)
            if len(out) >= limit:
                break
        return out

    async def handle_get_event_log_stats(self, payload):
        """Pipeline visibility: per-source buffer depth / flush lag /
        cumulative drops (so silent drops are visible in `ray-tpu
        status`), plus per-type totals."""
        now = time.time()
        with self._lock:
            # prune sources silent for >10min: exited workers must not
            # read as ever-worsening flush lag forever (a WEDGED live
            # process still shows up — its own gauges keep exporting
            # locally, and it stays listed as stale for the full window)
            for pid in [p for p, st in self._sources.items()
                        if now - st.get("received", now) > 600.0]:
                self._sources.pop(pid, None)
            return {
                "total_events": len(self._events),
                "by_type": dict(self._type_counts),
                "sources": {
                    f"{st.get('source')}#{pid}": {
                        "depth": st.get("depth", 0),
                        "dropped": st.get("dropped", 0),
                        "emitted": st.get("emitted", 0),
                        "flush_lag_s": max(0.0, now - st.get(
                            "received", now)),
                        "stale": now - st.get("received", now) > 30.0,
                    }
                    for pid, st in self._sources.items()
                },
            }


class GcsSpanManager:
    """Cluster-wide span store for distributed request tracing
    — the tracing sibling of GcsEventManager, fed by every process's
    _private/tracing span flusher.

    Two tiers implement tail-based sampling at the collector:

    * durable store — spans of head-SAMPLED traces, and of traces that
      were FORCE-kept (error / deadline expired / shed / latency p99
      breach anywhere in the cluster);
    * provisional ring — spans of unsampled traces, held in arrival
      order until a force marker promotes their trace or they age out of
      the bounded ring. `ray-tpu trace <id>` reads both, so a just-served
      request is inspectable even at sample rate 0 while storage stays
      bounded.

    Profile spans (util.tracing trace_span — no trace id) land in their
    own ring feeding the cluster-wide `ray-tpu timeline`.

    Thread-safe: the embedded head's direct sink appends from the span-
    flusher thread while handlers read on the gcs-io loop.
    """

    def __init__(self, max_spans: Optional[int] = None,
                 provisional_max: Optional[int] = None,
                 profile_max: Optional[int] = None):
        # Both tiers are trace-id-INDEXED (OrderedDict of trace_id ->
        # span list, oldest trace first), bounded by TOTAL span count
        # with whole-trace eviction. The index keeps every store
        # operation O(one trace): promotion is a dict pop, get_trace a
        # dict read, eviction pops oldest traces — a flat deque made all
        # three O(store-size) Python scans on the gcs-io loop / under
        # the ingestion lock, which stalled every GCS RPC and every span
        # flusher once the store neared its 250k-span capacity.
        self._max_spans = max_spans or CONFIG.trace_store_max_spans
        self._provisional_max = (provisional_max
                                 or CONFIG.trace_provisional_max_spans)
        self._spans: "OrderedDict[str, List[dict]]" = OrderedDict()
        self._span_count = 0
        self._provisional: "OrderedDict[str, List[dict]]" = OrderedDict()
        self._provisional_count = 0
        self._profile = deque(maxlen=profile_max
                              or CONFIG.trace_profile_max_spans)
        self._forced: "OrderedDict[str, str]" = OrderedDict()
        self._lock = threading.Lock()
        self._sources: Dict[int, dict] = {}
        self._received = 0

    def add_local(self, spans: List[dict], forced: Optional[list],
                  stats: Optional[dict]) -> None:
        """Direct sink for an in-process tracing buffer (embedded head):
        same path the RPC handler takes, minus the wire."""
        with self._lock:
            for trace_id, reason in forced or ():
                if trace_id not in self._forced:
                    self._forced[trace_id] = reason
                    while len(self._forced) > 4096:
                        self._forced.popitem(last=False)
                    self._promote_locked(trace_id)
            for span in spans or ():
                self._received += 1
                trace_id = span.get("trace_id")
                if trace_id is None:
                    self._profile.append(span)
                elif span.get("sampled") or trace_id in self._forced:
                    self._spans.setdefault(trace_id, []).append(span)
                    self._span_count += 1
                else:
                    self._provisional.setdefault(trace_id,
                                                 []).append(span)
                    self._provisional_count += 1
            # whole-trace eviction, oldest (first-span arrival) first
            while (self._span_count > self._max_spans
                   and len(self._spans) > 1):
                _, evicted = self._spans.popitem(last=False)
                self._span_count -= len(evicted)
            while (self._provisional_count > self._provisional_max
                   and len(self._provisional) > 1):
                _, evicted = self._provisional.popitem(last=False)
                self._provisional_count -= len(evicted)
            if stats:
                self._sources[stats.get("pid")] = dict(stats,
                                                       received=time.time())
                if len(self._sources) > 512:
                    for pid, _ in sorted(
                            self._sources.items(),
                            key=lambda kv: kv[1].get("received", 0.0)
                    )[:len(self._sources) - 512]:
                        self._sources.pop(pid, None)

    def _promote_locked(self, trace_id: str) -> None:
        # O(one trace): failure bursts fire one promotion per refused
        # request, so this must never scan the whole provisional tier
        keep = self._provisional.pop(trace_id, None)
        if keep:
            self._provisional_count -= len(keep)
            self._spans.setdefault(trace_id, []).extend(keep)
            self._span_count += len(keep)

    async def handle_add_spans(self, payload):
        self.add_local(payload.get("spans") or [],
                       payload.get("forced") or [],
                       payload.get("stats"))
        return True

    async def handle_get_trace(self, payload):
        """Every stored span of one trace (durable + provisional),
        ordered by start time, plus the force verdict."""
        trace_id = payload.get("trace_id")
        with self._lock:
            spans = list(self._spans.get(trace_id) or ())
            spans += self._provisional.get(trace_id) or ()
            forced_reason = self._forced.get(trace_id)
        # a span can reach both tiers across a promotion/flush race
        seen = set()
        out = []
        for s in sorted(spans, key=lambda s: (s.get("start", 0.0),
                                              s.get("span_id") or "")):
            key = s.get("span_id")
            if key in seen:
                continue
            seen.add(key)
            out.append(s)
        return {"trace_id": trace_id, "spans": out,
                "forced": forced_reason is not None,
                "forced_reason": forced_reason}

    async def handle_list_traces(self, payload):
        """Newest-first trace summaries from the durable store (sampled +
        force-kept traces — the ones worth listing). Only the newest
        `limit` traces are summarized — the store can hold thousands."""
        limit = payload.get("limit", 100)
        with self._lock:
            newest = list(self._spans.keys())[-limit:]
            groups = [(tid, list(self._spans[tid])) for tid in newest]
            forced = dict(self._forced)
        rows = []
        for trace_id, spans in groups:
            span_ids = {s.get("span_id") for s in spans}
            # root = the earliest span whose parent never arrived; a
            # client-originated trace has NO parentless span here (the
            # proxy's span is a child of the client's), so "parent not
            # stored" is the right rule, same as build_span_tree
            roots = [s for s in spans
                     if s.get("parent_id") not in span_ids]
            roots.sort(key=lambda s: s.get("start", 0.0))
            rows.append({
                "trace_id": trace_id,
                "root": roots[0].get("name") if roots else None,
                "spans": len(spans),
                "procs": sorted({s.get("proc", "?") for s in spans}),
                "start": min(s.get("start", 0.0) for s in spans),
                "duration_s": max(0.0, max(s.get("end", 0.0)
                                           for s in spans)
                                  - min(s.get("start", 0.0)
                                        for s in spans)),
                "forced_reason": forced.get(trace_id),
            })
        rows.sort(key=lambda t: -t["start"])
        return rows

    async def handle_get_profile_spans(self, payload):
        """Cluster-wide profile spans (util.tracing) for the timeline —
        the spans the old process-local-only path silently dropped for
        every non-driver process."""
        limit = payload.get("limit", 10_000)
        with self._lock:
            out = list(self._profile)
        return out[-limit:]

    async def handle_get_span_stats(self, payload):
        now = time.time()
        with self._lock:
            return {
                "spans": self._span_count,
                "provisional": self._provisional_count,
                "traces": len(self._spans),
                "profile": len(self._profile),
                "forced_traces": len(self._forced),
                "received": self._received,
                "sources": {
                    f"{st.get('source')}#{pid}": {
                        "depth": st.get("depth", 0),
                        "dropped": st.get("dropped", 0),
                        "recorded": st.get("recorded", 0),
                        "flush_lag_s": max(0.0, now - st.get(
                            "received", now)),
                    }
                    for pid, st in self._sources.items()
                },
            }


class GcsServer:
    """Assembles all managers onto one RpcServer + loop."""

    def __init__(self, host: str = "127.0.0.1", storage_path: str = ""):
        self._lt = EventLoopThread("gcs-io")
        self._server = RpcServer(self._lt, host, label="gcs")
        self._pool = ClientPool(self._lt, peer_meta={"label": "gcs"},
                                label="gcs")
        self.publisher = ps.Publisher(self._lt)
        store = make_store(storage_path or CONFIG.gcs_storage_path)
        self._store = store
        self.node_manager = GcsNodeManager(self.publisher, store=store)
        self.kv_manager = GcsKvManager(store)
        self.job_manager = GcsJobManager(self.publisher, store=store)
        self.actor_manager = GcsActorManager(
            self.node_manager, self.publisher, self._pool, store=store)
        self.pg_manager = GcsPlacementGroupManager(
            self.node_manager, self.publisher, self._pool, store=store)
        # pubsub subscriptions persist so a restarted GCS resumes pushing
        # actor/node/log events without clients re-subscribing; dead
        # subscribers prune back OUT of the table when a push fails, so
        # worker churn can't grow it without bound
        self.publisher.on_drop = lambda channel, addr: store.delete(
            "pubsub", f"{channel}|{addr}".encode())
        for key in store.keys("pubsub"):
            try:
                channel, addr = key.decode().split("|", 1)
                self.publisher.subscribe(channel, addr)
            except Exception:  # noqa: BLE001 — skip torn records
                logger.warning(
                    "pubsub recovery: skipping torn subscription %r", key)
        self.task_event_manager = GcsTaskEventManager()
        self.event_manager = GcsEventManager()
        self.span_manager = GcsSpanManager()
        self.metrics_manager = GcsMetricsManager(self.node_manager,
                                                 self.event_manager)
        # The head process's lifecycle events skip the wire entirely; the
        # token scopes teardown so a later sink owner isn't clobbered.
        self._event_sink_token = event_log.set_sink(
            self.event_manager.add_local)
        self._span_sink_token = _tracing.set_span_sink(
            self.span_manager.add_local)
        self.node_manager.pg_locator = self.pg_manager
        self.node_manager.add_death_listener(self.actor_manager.on_node_death)
        self.node_manager.add_death_listener(self.pg_manager.on_node_death)
        self.job_manager.add_finish_listener(self.actor_manager.on_job_finished)
        self.address: Optional[str] = None
        self._health_task = None
        self._slo_eval_task = None

    def start(self, port: int = 0) -> str:
        for mgr in (
            self.node_manager,
            self.kv_manager,
            self.job_manager,
            self.actor_manager,
            self.pg_manager,
            self.task_event_manager,
            self.event_manager,
            self.span_manager,
            self.metrics_manager,
        ):
            self._server.register_all(mgr)
        self._server.register("drain_node", self._handle_drain_node)
        self._server.register("preempt_node", self._handle_preempt_node)
        self._server.register("subscribe", self._handle_subscribe)
        self._server.register("unsubscribe", self._handle_unsubscribe)
        self._server.register("gcs_ping", self._handle_ping)
        self._server.register("publish_logs", self._handle_publish_logs)
        self._server.register("report_error", self._handle_report_error)
        self._server.register("get_cluster_memory",
                              self._handle_get_cluster_memory)
        self._server.register("chaos_start", self._handle_chaos_start)
        self._server.register("chaos_stop", self._handle_chaos_stop)
        self._server.register("chaos_status", self._handle_chaos_status)
        self.address = self._server.start(port)
        self._pool.set_local_id(self.address)
        self._health_task = self._lt.submit(self.node_manager.health_check_loop())
        self._slo_eval_task = self._lt.submit(self.metrics_manager.eval_loop())
        # resume actors/PGs that were mid-schedule when a previous GCS
        # incarnation stopped (no-ops on a fresh start)
        self._lt.loop.call_soon_threadsafe(self.actor_manager.recover)
        self._lt.loop.call_soon_threadsafe(self.pg_manager.recover)
        return self.address

    async def _handle_drain_node(self, payload):
        """Graceful drain entry point (reference: `ray drain-node` →
        GcsNodeManager DrainNode). Marks the node draining (excluded from
        GCS-side scheduling immediately) and forwards the drain to its
        raylet, which stops leasing and unregisters once idle."""
        nid: NodeID = payload["node_id"]
        info = self.node_manager._nodes.get(nid)
        if info is None or not info.alive:
            return {"status": "not_found"}
        if info.draining:
            # a drain/preempt is already in flight. Proceeding would be
            # actively destructive during a PREEMPT notice window: the
            # bundle teardown below would kill a training gang
            # mid-checkpoint-drain, and the rollback branch could clear
            # the preempt's scheduling exclusion.
            return {"status": "already_draining"}
        info.draining = True
        self.node_manager._bump_node(nid)
        try:
            reply = await self._pool.get(info.raylet_address).call_async(
                "drain_node",
                {"reason": payload.get("reason", ""),
                 "deadline_s": payload.get("deadline_s", 300.0)},
                timeout=10.0)
        except Exception as e:  # noqa: BLE001 — report, don't crash the GCS
            # the raylet never received the drain: undo the mark, or the
            # node would be excluded from scheduling forever while still
            # accepting direct leases (half-drained wedge)
            info.draining = False
            self.node_manager._bump_node(nid)
            return {"status": "unreachable", "error": str(e)}
        # Re-place any placement-group bundles living on the draining node
        # (reference: drain reschedules bundles like node removal). Leases
        # targeted at those bundles would otherwise spin on 'draining'
        # rejections behind unrelated work until the deadline. This kills
        # the bundles' leased workers on the drained node (cancel_bundles);
        # gang actors restart with their group elsewhere.
        await self.pg_manager.on_node_death(nid)
        return {"status": "ok", "raylet": reply}

    async def _handle_preempt_node(self, payload):
        """Preemptible-TPU advance notice (the announced-node-loss sibling
        of drain_node): the node is excluded from scheduling immediately
        and its raylet stops leasing, but — unlike drain — its placement-
        group bundles are NOT torn down up front. The notice window
        belongs to the workloads: training gangs checkpoint-and-drain
        (train/_internal/backend_executor watches for the
        node.preempt_notice event), serve replicas deregister-then-drain
        (serve controller), and only at the deadline does the raylet kill
        stragglers and unregister. Bundles re-place through the normal
        node-death listener when the node leaves."""
        nid: NodeID = payload["node_id"]
        deadline_s = float(payload.get("deadline_s", 30.0))
        reason = payload.get("reason", "preemption")
        info = self.node_manager._nodes.get(nid)
        if info is None or not info.alive:
            return {"status": "not_found"}
        if info.draining:
            # a drain_node/preempt_node is already in flight — do NOT
            # re-notify, and (crucially) never let this call's rollback
            # clear the exclusion the earlier operation installed
            return {"status": "already_draining"}
        info.draining = True
        self.node_manager._bump_node(nid)
        try:
            reply = await self._pool.get(info.raylet_address).call_async(
                "preempt_notice",
                {"deadline_s": deadline_s, "reason": reason},
                timeout=10.0)
        except Exception as e:  # noqa: BLE001 — report, don't crash the GCS
            if isinstance(e, ConnectionLost) and not e.maybe_delivered:
                # the raylet provably never got the notice: undo the
                # scheduling exclusion (same half-drained-wedge hazard
                # as drain_node)
                info.draining = False
                self.node_manager._bump_node(nid)
                return {"status": "unreachable", "error": str(e)}
            # Timeout / mid-call reset: the raylet MAY already be draining
            # (it rejects its lease queue and arms the deadline on
            # receipt). Keep the exclusion — leasing onto a node that
            # rejects everything and kills itself at the deadline is
            # worse than an idle one.
            return {"status": "unknown", "error": str(e)}
        # The raylet is the single emitter of node.preempt_notice (on
        # receipt, before it touches its queue): one event per notice,
        # and none at all when the notice provably never took effect.
        return {"status": "ok", "deadline_s": deadline_s, "raylet": reply}

    async def _handle_get_cluster_memory(self, payload):
        """Cluster-wide memory aggregation: every alive
        raylet's node_memory_report (arena + spill + per-worker reference
        tables), fanned out CONCURRENTLY — per-node failures land in-band
        so one partitioned node degrades the report instead of timing the
        whole call out. Callers (`ray-tpu memory`, the state API, the
        leak sweep) merge their own driver-side report on top: drivers
        register with the GCS, not a raylet worker pool."""
        payload = payload or {}
        node_timeout = float(payload.get("node_timeout_s", 30.0))
        sub = {"refs": bool(payload.get("refs", True)),
               "worker_timeout_s": float(payload.get("worker_timeout_s",
                                                     10.0))}
        nodes = self._alive_raylets()

        async def _one(addr):
            try:
                return await self._pool.get(addr).call_async(
                    "node_memory_report", dict(sub), timeout=node_timeout)
            except Exception as e:  # noqa: BLE001 — node mid-death
                return {"error": str(e)}

        replies = await asyncio.gather(*(_one(addr) for _, addr in nodes))
        return {"nodes": {nid.hex(): reply
                          for (nid, _), reply in zip(nodes, replies)}}

    # -- chaos control plane (`ray-tpu chaos`, ray_tpu_torch.chaos) -----------------

    def _alive_raylets(self):
        return [(nid, info.raylet_address)
                for nid, info in self.node_manager._nodes.items()
                if info.alive]

    async def _chaos_fanout(self, method: str, payload: dict) -> dict:
        """Relay a chaos op to every alive raylet CONCURRENTLY; per-node
        outcome map. Unreachable/partitioned nodes report as errors and
        cost one shared 5s timeout, not 5s each — `chaos stop` on a
        half-partitioned cluster must not leave faults firing for
        N_dead*5s while it crawls the node list."""
        nodes = self._alive_raylets()

        async def _one(addr):
            try:
                return await self._pool.get(addr).call_async(
                    method, dict(payload, scope="local"), timeout=5.0)
            except Exception as e:  # noqa: BLE001 — chaos bites its own tail
                return {"status": "unreachable", "error": str(e)}

        replies = await asyncio.gather(*(_one(addr) for _, addr in nodes))
        return {nid.hex()[:12]: reply
                for (nid, _), reply in zip(nodes, replies)}

    async def _handle_chaos_start(self, payload):
        from ray_tpu_torch._private import fault_injection as fi

        plan_json = payload["plan"]
        plan = fi.ChaosPlan.from_json(plan_json)  # validate before fan-out
        nodes = {}
        if payload.get("scope", "cluster") == "cluster":
            nodes = await self._chaos_fanout("chaos_start",
                                             {"plan": plan_json})
        fi.install(plan)  # install on the GCS LAST so the fan-out itself
        # is never subject to the plan it is installing
        return {"status": "installed", "seed": plan.seed,
                "rules": len(plan.rules), "nodes": nodes}

    async def _handle_chaos_stop(self, payload):
        from ray_tpu_torch._private import fault_injection as fi

        plan = fi.uninstall()  # uninstall FIRST so the fan-out runs clean
        nodes = {}
        if payload.get("scope", "cluster") == "cluster":
            nodes = await self._chaos_fanout("chaos_stop", {})
        return {"status": "uninstalled",
                "stats": plan.stats() if plan else None, "nodes": nodes}

    async def _handle_chaos_status(self, payload):
        from ray_tpu_torch._private import fault_injection as fi

        plan = fi.active_plan()
        nodes = {}
        if payload.get("scope", "cluster") == "cluster":
            nodes = await self._chaos_fanout("chaos_status", {})
        return {"installed": plan is not None,
                "stats": plan.stats() if plan else None, "nodes": nodes}

    async def _handle_subscribe(self, payload):
        channel = payload["channel"]
        addr = payload["subscriber_address"]
        self.publisher.subscribe(channel, addr)
        self._store.put("pubsub", f"{channel}|{addr}".encode(), b"1")
        return True

    async def _handle_unsubscribe(self, payload):
        addr = payload["subscriber_address"]
        if payload.get("all"):
            self.publisher.unsubscribe_all(addr)
            for key in self._store.keys("pubsub"):
                if key.decode().split("|", 1)[1] == addr:
                    self._store.delete("pubsub", key)
        else:
            self.publisher.unsubscribe(payload["channel"], addr)
            self._store.delete(
                "pubsub", f"{payload['channel']}|{addr}".encode())
        return True

    async def _handle_ping(self, payload):
        return {"status": "ok", "time": time.time()}

    async def _handle_publish_logs(self, payload):
        """Raylet log monitors push worker-log batches here; fan out to
        every subscribed driver (reference: the LOG pubsub channel that
        worker.py:2003 print_worker_logs consumes)."""
        self.publisher.publish(ps.LOG_CHANNEL, payload.get("node"), payload)
        return True

    async def _handle_report_error(self, payload):
        """Task/actor errors pushed by workers; fan out to drivers
        (reference: ERROR channel, worker.py:2115 listen_error_messages)."""
        self.publisher.publish(
            ps.ERROR_CHANNEL, payload.get("job_id"), payload)
        return True

    def stop(self):
        event_log.flush(timeout=0.5)  # pull in the head's own tail events
        event_log.clear_sink(self._event_sink_token)
        _tracing.flush_spans(timeout=0.5)
        _tracing.clear_span_sink(self._span_sink_token)
        if self._health_task is not None:
            self._health_task.cancel()
        if self._slo_eval_task is not None:
            self._slo_eval_task.cancel()
        self.metrics_manager.stop()
        self.publisher.close()
        self._pool.close_all()
        self._server.stop()
        self._lt.stop()
        close = getattr(self._store, "close", None)
        if close is not None:
            close()


def main():
    import argparse

    parser = argparse.ArgumentParser()
    parser.add_argument("--port", type=int, default=6380)
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--storage-path", default="")
    args = parser.parse_args()
    logging.basicConfig(level=logging.INFO)
    event_log.set_default_proc_label("gcs")
    event_log.install_flight_recorder(on_exit=True)
    server = GcsServer(host=args.host, storage_path=args.storage_path)
    addr = server.start(args.port)
    logger.info("GCS serving at %s", addr)
    try:
        while True:
            time.sleep(1.0)
    except KeyboardInterrupt:
        server.stop()


if __name__ == "__main__":
    main()
