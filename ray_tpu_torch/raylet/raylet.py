"""Raylet: per-node manager — lease protocol, local dispatch, PG bundles.

Role of the reference's NodeManager + ClusterTaskManager + LocalTaskManager
(ray: src/ray/raylet/node_manager.cc:1780 HandleRequestWorkerLease,
scheduling/cluster_task_manager.h:42, local_task_manager.h:58,
placement_group_resource_manager.h:46 for the 2PC bundle states). A lease
request is first given a cluster-level decision (hybrid/spread policies over
the synced cluster view — spillback replies carry `retry_at` like
node_manager.proto:74-78); locally-granted requests wait in a dispatch queue
for resources + an idle worker from the WorkerPool.

Differences from the reference, by design: argument staging (dependency
manager pulls) happens in the executing worker rather than the raylet, and
the node-local object store is the worker-embedded store until the plasma shm
store is wired in.
"""

from __future__ import annotations

import asyncio
import logging
import os
import random
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ray_tpu_torch._private import backoff as _backoff
from ray_tpu_torch._private import deadlines as _deadlines
from ray_tpu_torch._private import event_log
from ray_tpu_torch._private import tracing as _tracing
from ray_tpu_torch._private.config import CONFIG
from ray_tpu_torch._private.ids import NodeID, PlacementGroupID, WorkerID
from ray_tpu_torch._private.rpc import (
    ClientPool,
    ConnectionLost,
    EventLoopThread,
    RpcServer,
)
from ray_tpu_torch._private.specs import (
    Address,
    NodeInfo,
    Resources,
    TaskSpec,
    TaskType,
    add_resources,
    resources_fit,
    subtract_resources,
)
from ray_tpu_torch.raylet import scheduling_policy as policy
from ray_tpu_torch.raylet.worker_pool import WorkerHandle, WorkerPool

logger = logging.getLogger(__name__)

_lease_hist = None


def _lease_stage_hist():
    """Lease-path latency histogram (queue = request -> resources
    allocated; dispatch = allocation -> worker popped/granted). Lazy so
    importing the raylet module registers nothing; returns None if the
    metrics layer is broken — a metrics failure must never fail a
    lease grant."""
    global _lease_hist
    if _lease_hist is None:
        try:
            from ray_tpu_torch.util.metrics import get_or_create_histogram

            _lease_hist = get_or_create_histogram(
                "ray_tpu_raylet_lease_stage_seconds",
                "Raylet lease latency by stage (queue/dispatch)",
                tag_keys=("stage",),
            )
        except Exception:  # noqa: BLE001
            _lease_hist = False  # don't retry every grant
    return _lease_hist or None


@dataclass
class _Bundle:
    resources: Resources
    available: Resources
    committed: bool = False


@dataclass
class _Lease:
    worker_id: WorkerID
    resources: Resources
    pg_id: Optional[PlacementGroupID] = None
    bundle_index: int = -1
    cards: Tuple[int, ...] = ()  # card indices bound (Raylet._pick_cards)
    is_actor: bool = False
    retriable: bool = False
    owner_id: str = ""
    start_time: float = field(default_factory=time.monotonic)


@dataclass
class _QueuedLease:
    spec: TaskSpec
    future: asyncio.Future
    enqueue_time: float = field(default_factory=time.monotonic)


def _placement_res(spec: TaskSpec) -> Resources:
    return (spec.placement_resources
            if getattr(spec, "placement_resources", None) is not None
            else spec.resources)


class Raylet:
    def __init__(
        self,
        gcs_address: str,
        resources: Optional[Resources] = None,
        host: str = "127.0.0.1",
        is_head: bool = False,
        labels: Optional[Dict[str, str]] = None,
        log_dir: Optional[str] = None,
        worker_env: Optional[dict] = None,
        accelerator_env: Optional[Dict[str, str]] = None,
        gpu_info=None,
    ):
        self.node_id = NodeID.from_random()
        self.gcs_address = gcs_address
        self.is_head = is_head
        self._elog = event_log.logger_for("raylet", self.node_id.hex()[:12])
        self._event_sink_token = None
        self._lt = EventLoopThread(f"raylet-{self.node_id.hex()[:6]}")
        self._server = RpcServer(self._lt, host, label="raylet")
        self._pool = ClientPool(self._lt, peer_meta={"label": "raylet"},
                                label="raylet")
        self._gcs = None  # RpcClient, set on start
        if resources is None:
            resources = {}
        resources = dict(resources)
        resources.setdefault("CPU", float(os.cpu_count() or 1))
        resources.setdefault("memory", 4.0 * 1024**3)
        self.labels = dict(labels or {})
        # The node's cards (the counterpart of the TPU detection,
        # reference: _private/accelerators/nvidia_gpu.py): `GPU`, the typed
        # `GPU-<part>` and the accelerator-type label, read by a probe
        # process, so the raylet never creates a CUDA context. Values the
        # caller set win. `gpu_info` (a nvidia.GpuInfo) stands in for the
        # probe, for in-process test nodes of fake cards; `accelerator_env`
        # is the environment whose CUDA_VISIBLE_DEVICES allots this node
        # its cards (default: the raylet's own).
        from ray_tpu_torch._private.accelerators import nvidia

        resources, self.labels = nvidia.node_advertisement(
            resources, self.labels, info=gpu_info, env=accelerator_env)
        # The cards a lease binds, by index into the node's allotment: the
        # share of each that is free (a whole card 1.0). A `GPU` lease
        # takes its cards here and gives them back on release.
        self._card_free: Dict[int, float] = {
            i: 1.0 for i in range(int(resources.get("GPU", 0)))}
        self._accelerator_env = accelerator_env
        # On k8s, the autoscaler joins provider pods to GCS nodes via this
        # label (downward-API env; see autoscaler.update's label join).
        pod_name = os.environ.get("RT_POD_NAME") or os.environ.get("POD_NAME")
        if pod_name and accelerator_env is None:
            self.labels.setdefault("ray.io/pod-name", pod_name)
        # node:<ip> affinity resource like the reference.
        self.total: Resources = resources
        self.available: Resources = dict(resources)
        self._bundles: Dict[PlacementGroupID, Dict[int, _Bundle]] = {}
        self._leases: Dict[WorkerID, _Lease] = {}
        self._queue: List[_QueuedLease] = []
        self._dispatch_event: Optional[asyncio.Event] = None
        self._cluster_view: policy.View = {}
        self._cluster_labels: Dict[NodeID, Dict[str, str]] = {}
        self._spread_rr = 0
        # one directory per node: its pool prunes only its own workers' logs
        self._log_dir = log_dir or os.path.join(
            CONFIG.log_dir, "workers", self.node_id.hex()[:12])
        self._worker_env = worker_env
        self.worker_pool: Optional[WorkerPool] = None
        self.address: Optional[str] = None
        self._tasks: List[asyncio.Task] = []
        self._stopped = False
        # Node-local C++ shm object store (plasma equivalent, hosted inside
        # the raylet like the reference's store_runner.cc) + disk spilling
        # state (reference: raylet/local_object_manager.h:41).
        self._store_server = None
        self._store_client = None
        self.store_socket: Optional[str] = None
        self._spilled: Dict[bytes, str] = {}  # store key -> spill URI/path
        # store key -> spilled payload bytes (memory observability: the
        # node report's spill accounting; mirrors _spilled's lifecycle)
        self._spilled_sizes: Dict[bytes, int] = {}
        self._spill_dir: Optional[str] = None
        self._spill_backend = None  # set with the store (external_storage)
        # Remote spill URIs not yet confirmed by the GCS registry
        # (flushed from the spill thread and the heartbeat loop).
        self._pending_spill_uris: Dict[str, str] = {}
        # Keys freed while a registry flush may have been in flight with
        # an older snapshot; the next flush un-registers them.
        self._freed_spill_keys: set = set()
        self._spill_uri_lock = threading.Lock()
        # Serializes _spill_until across the watermark loop and per-worker
        # spill_objects RPCs (both run via asyncio.to_thread).
        self._spill_lock = threading.Lock()
        # Guards the _spilled/_spilled_sizes PAIR: _spill_until writes
        # them from to_thread executor threads while restore/free mutate
        # them on the raylet loop. Held only around the dict ops, never
        # across backend IO (unlike _spill_lock), so the loop may take it.
        # Order when nested: _spill_lock, then _spill_maps_lock.
        self._spill_maps_lock = threading.Lock()
        # Recently-rejected infeasible demand shapes -> last-seen time;
        # reported to the GCS while fresh so the autoscaler sees them.
        self._infeasible: Dict[tuple, float] = {}
        # Graceful drain (reference: scripts.py:2268 drain-node +
        # node_manager's DrainRaylet): once draining, no new leases; the
        # drain watcher unregisters the node when running leases finish.
        self._draining = False
        self.drain_reason = ""
        self.drain_complete = threading.Event()
        # Heartbeat-backoff jitter source: seeded by node id so one node's
        # retry schedule is reproducible while different nodes stay
        # decorrelated (no synchronized reconnect storm on GCS restart).
        self._backoff_rng = random.Random(self.node_id.binary())
        self._reconnect_policy = _backoff.BackoffPolicy(
            base_s=CONFIG.heartbeat_period_ms / 1000.0,
            multiplier=2.0,
            max_s=CONFIG.gcs_reconnect_backoff_max_s,
            jitter=CONFIG.gcs_reconnect_backoff_jitter,
            rng=self._backoff_rng,
        )
        # set by `python -m ray_tpu_torch start` so a drained worker PROCESS
        # exits instead of lingering unregistered
        self._exit_on_drain = False

    # ------------------------------------------------------------------ start
    def start(self, port: int = 0, max_workers: Optional[int] = None) -> str:
        self._server.register_all(self)
        self.address = self._server.start(port)
        self._start_object_store()
        self.total.setdefault(f"node:{self.address}", 1.0)
        self.available.setdefault(f"node:{self.address}", 1.0)
        if max_workers is None:
            max_workers = int(self.total.get("CPU", 1)) * 4 + 4
        self.worker_pool = WorkerPool(
            node_id_hex=self.node_id.hex(),
            raylet_address=self.address,
            gcs_address=self.gcs_address,
            loop=self._lt.loop,
            max_workers=max_workers,
            log_dir=self._log_dir,
            on_worker_death=self._on_worker_death,
            env=self._worker_env,
            accelerator_env=self._accelerator_env,
        )
        # spawned workers learn the socket from their env, which lets them
        # register one-way (no reply round trip on the ctor path)
        self.worker_pool.store_socket = self.store_socket
        from ray_tpu_torch._private.rpc import RpcClient

        self._gcs = RpcClient(self.gcs_address, self._lt,
                              peer_meta={"label": "raylet"}, label="raylet")
        self._gcs.local_id = self.address
        self._pool.set_local_id(self.address)
        # Lifecycle-event flush path for a standalone raylet process: one
        # batched RPC per flush window. An embedded head already has the
        # GCS's direct sink installed (set_sink is first-wins).
        gcs_client = self._gcs

        def _ship_events(events, stats):
            gcs_client.send("add_cluster_events",
                            {"events": events, "stats": stats})

        self._event_sink_token = event_log.set_sink(_ship_events)

        def _ship_spans(spans, forced, stats):
            gcs_client.send("add_spans", {"spans": spans, "forced": forced,
                                          "stats": stats})

        self._span_sink_token = _tracing.set_span_sink(_ship_spans)
        # Metric-snapshot push path (health plane): same first-wins shape
        # — in an embedded head the GCS's direct sink already owns the
        # process pusher, so this no-ops there.
        from ray_tpu_torch.health import push as _health_push

        def _ship_metrics(payload):
            gcs_client.send("push_metrics", payload)

        self._metrics_push_token = _health_push.set_push_sink(
            _ship_metrics, f"raylet:{self.node_id.hex()[:8]}")
        info = NodeInfo(
            node_id=self.node_id,
            raylet_address=self.address,
            resources_total=dict(self.total),
            resources_available=dict(self.available),
            labels=self.labels,
            is_head=self.is_head,
        )
        self._gcs.call("register_node", {"info": info})
        # raylint: disable=cross-domain-mutation — startup ordering: this
        # write precedes the NODE subscribe below and _start_tasks, so no
        # handler or heartbeat mutation can exist yet; every later
        # _cluster_view mutation is loop-confined
        self._cluster_view[self.node_id] = (dict(self.total), dict(self.available))
        self._cluster_addrs: Dict[NodeID, str] = {self.node_id: self.address}
        self._view_version = 0  # delta-heartbeat cursor (see _apply_view_reply)
        # Event-driven view updates: heartbeats sync resources every period,
        # but node joins/deaths must reflect immediately (a lease burst right
        # after cluster bring-up would otherwise see a stale one-node view).
        self._gcs.call(
            "subscribe", {"channel": "NODE", "subscriber_address": self.address}
        )

        def _start_tasks():
            self._dispatch_event = asyncio.Event()
            self.worker_pool.start()
            self._tasks.append(self._lt.loop.create_task(self._heartbeat_loop()))
            self._tasks.append(self._lt.loop.create_task(self._dispatch_loop()))
            if self._store_client is not None:
                self._tasks.append(self._lt.loop.create_task(self._spill_loop()))
            if CONFIG.memory_monitor_refresh_ms > 0:
                self._tasks.append(
                    self._lt.loop.create_task(self._memory_monitor_loop()))
            if CONFIG.log_to_driver:
                self._tasks.append(
                    self._lt.loop.create_task(self._log_monitor_loop()))

        self._lt.loop.call_soon_threadsafe(_start_tasks)
        return self.address

    # ------------------------------------------------------- log streaming
    async def _log_monitor_loop(self):
        """Tail per-worker log files and push new lines to the GCS LOG
        pubsub channel, which fans out to subscribed drivers (reference:
        _private/log_monitor.py:134 — the per-node log monitor process;
        here a raylet loop, since the raylet already owns the files).
        VERDICT r1 #6: the LOG/ERROR channels existed but nothing fed them.
        """
        # path -> (inode, committed offset). Every produced batch MUST
        # carry 'ino' alongside 'new_offset' — an offset committed without
        # its inode can't detect rotation, and an uncommitted offset
        # silently re-ships the same lines every scan.
        offsets: Dict[str, Tuple[int, int]] = {}
        period = CONFIG.log_monitor_period_ms / 1000.0
        while True:
            await asyncio.sleep(period)
            try:
                batches = await asyncio.to_thread(
                    self._collect_new_log_lines, offsets)
            except Exception:  # noqa: BLE001 — monitor must never die
                logger.debug("log monitor scan failed", exc_info=True)
                continue
            for batch in batches:
                path = batch.pop("path")
                new_offset = batch.pop("new_offset")
                ino = batch.pop("ino", None)
                if ino is None:
                    # Contract violation, not a runtime condition: fail
                    # loudly (once per scan) instead of silently leaving
                    # the offset uncommitted and re-shipping these lines
                    # forever.
                    logger.error(
                        "log batch for %s lacks 'ino'; offset %d NOT "
                        "committed — lines will re-ship every scan "
                        "(producer bug in _collect_new_log_lines)",
                        path, new_offset)
                rebase = batch.pop("rebase_marks", None)
                if not batch.pop("skip", False):
                    try:
                        await self._gcs.send_async("publish_logs", batch)
                    except (ConnectionLost, OSError):
                        # offset NOT committed: these lines re-read and
                        # re-send next cycle (a GCS blip loses nothing)
                        break
                if rebase is not None:
                    # Rotation bookkeeping mutates ONLY after its tail
                    # batch committed — a publish failure retries next
                    # scan against unmodified marks.
                    with rebase.marks_lock:
                        if rebase.job_marks:
                            rebase.job_marks[:] = [
                                (0, rebase.job_marks[-1][1])]
                if ino is not None:
                    offsets[path] = (ino, new_offset)

    def _collect_new_log_lines(self, offsets: Dict[str, Tuple[int, int]]):
        """-> batches carrying "path"/"new_offset" so the caller commits an
        offset only AFTER its batch is sent (transient GCS failures lose
        nothing). Lines split into per-JOB segments by the worker's
        job_marks — attribution is by write position, not by whoever holds
        the worker at scan time."""
        batches = []
        node = self.node_id.hex()
        live_paths = set()
        for handle in list(self.worker_pool._workers.values()):
            path = handle.log_path
            if not path:
                continue
            live_paths.add(path)
            try:
                st = os.stat(path)
            except OSError:
                continue
            size, ino = st.st_size, st.st_ino
            entry = offsets.get(path)
            if entry is not None:
                prev_ino, start = entry
            else:
                prev_ino, start = ino, 0
                try:
                    # A backup existing before our FIRST scan of this
                    # path means the worker already rotated: nothing has
                    # shipped, so the whole .1 file is unshipped tail.
                    # (Log paths are per-worker-unique, so a .1 here can
                    # only be this worker's own rotation.)
                    prev_ino = os.stat(f"{path}.1").st_ino
                except OSError:
                    pass
            if prev_ino != ino:
                # The worker rotated its log (inode changed — size alone
                # can't detect this: a chatty fresh file may already be
                # past the stale offset). Ship the rotated-out file's
                # unshipped tail from <path>.1, rebase the job marks onto
                # the fresh file, and resume at offset 0 next scan.
                tail = self._rotated_tail_batch(
                    handle, f"{path}.1", prev_ino, start, node)
                if tail is None:
                    tail = {"skip": True}
                tail.update({"path": path, "new_offset": 0, "ino": ino,
                             "rebase_marks": handle})
                batches.append(tail)
                continue
            if size <= start:
                continue
            # cap the read: a multi-MB backlog (pre-existing file, or a
            # worker spewing between scans) must not materialize whole in
            # the raylet — skip ahead and note the gap
            cap = 1 << 20
            skipped = 0
            if size - start > cap:
                skipped = size - start - cap
                start = size - cap
            with open(path, "rb") as f:
                f.seek(start)
                data = f.read(size - start)
            # only ship complete lines; partial tail re-reads next cycle
            cut = data.rfind(b"\n")
            if cut < 0:
                continue
            data = data[:cut + 1]
            end = start + cut + 1
            # split [start, end) into per-job segments at the marks
            with handle.marks_lock:
                marks = list(handle.job_marks)
            unattributed = False
            if not marks:
                # Never-leased worker: no mark to attribute against. While
                # it lives, DEFER (offset uncommitted; its startup output
                # attributes to its first lease next scan). If it died
                # without ever leasing — a startup crash — ship the output
                # explicitly unattributed so drivers can surface it.
                if handle.state != "dead":
                    continue
                unattributed = True
            base_job = None
            for off, job in marks:
                if off <= start:
                    base_job = job
            if base_job is None and marks:
                # bytes before the first mark: startup output of a worker
                # that went on to lease — attribute to that first job
                base_job = marks[0][1]
            # prune marks superseded by the base: offsets only move
            # forward, so anything older than the mark covering `start`
            # can never attribute future bytes (keeps the 64-entry bound
            # in mark_job from ever evicting the live base mark)
            handle.prune_job_marks(start)
            cuts = [(off, job) for off, job in marks if start < off < end]
            segs = []
            prev, prev_job = start, base_job
            for off, job in cuts:
                segs.append((prev, off, prev_job))
                prev, prev_job = off, job
            segs.append((prev, end, prev_job))
            first = True
            for s, e, job in segs:
                if job is None and not unattributed:
                    # attribution was dropped (mark-overflow collapse, or a
                    # job-less system lease): advance past these bytes
                    # without publishing — never misattribute them
                    batches.append({"path": path, "new_offset": e,
                                    "ino": ino, "skip": True})
                    continue
                lines = data[s - start:e - start].decode(
                    "utf-8", "replace").splitlines()
                if len(lines) > 1000:  # flood guard: keep the newest
                    skipped += 1
                    lines = lines[-1000:]
                if first and skipped:
                    lines.insert(0, f"... ({skipped} bytes/lines of log "
                                    "backlog skipped)")
                first = False
                if not lines:
                    continue
                batches.append({
                    "node": node,
                    "pid": handle.pid,
                    "worker_id": handle.worker_id.hex()
                    if handle.worker_id else None,
                    "job_id": job,
                    "unattributed": unattributed,
                    "lines": lines,
                    "path": path,
                    "new_offset": e,
                    "ino": ino,
                })
        for path in list(offsets):
            if path not in live_paths:
                del offsets[path]
        return batches

    def _rotated_tail_batch(self, handle, old_path: str, prev_ino: int,
                            start: int, node: str):
        """The unshipped tail of a rotated-out worker log (now at
        <path>.1), attributed with the PRE-rotation marks (their offsets
        describe the old file). Whole-tail single attribution: a job
        switch landing inside the final unshipped window of the very
        rotation scan is vanishingly rare and bounded. None if there is
        nothing safe to ship."""
        with handle.marks_lock:
            marks = list(handle.job_marks)
        if not marks:
            return None  # never-leased worker: nothing to attribute to
        base_job = marks[0][1]
        for off, job in marks:
            if off <= start:
                base_job = job
        if base_job is None:
            return None
        try:
            ost = os.stat(old_path)
        except OSError:
            ost = None
        if ost is None or ost.st_ino != prev_ino:
            # Rotations outpaced shipping (e.g. a GCS outage spanning two
            # rotations): the unshipped window is gone — say so rather
            # than vanish it.
            return {
                "node": node, "pid": handle.pid,
                "worker_id": handle.worker_id.hex()
                if handle.worker_id else None,
                "job_id": base_job, "unattributed": False,
                "lines": ["... (a window of log lines was lost: the "
                          "worker rotated its log faster than the "
                          "monitor could ship it)"],
            }
        if ost.st_size <= start:
            return None
        cap = 1 << 20
        skipped = max(0, ost.st_size - start - cap)
        read_from = start + skipped
        try:
            with open(old_path, "rb") as f:
                f.seek(read_from)
                data = f.read(ost.st_size - read_from)
        except OSError:
            return None
        lines = data.decode("utf-8", "replace").splitlines()
        if len(lines) > 1000:
            skipped += 1
            lines = lines[-1000:]
        if skipped:
            lines.insert(0, f"... ({skipped} bytes/lines skipped at log "
                            "rotation)")
        if not lines:
            return None
        return {
            "node": node,
            "pid": handle.pid,
            "worker_id": handle.worker_id.hex()
            if handle.worker_id else None,
            "job_id": base_job,
            "unattributed": False,
            "lines": lines,
        }

    # --------------------------------------------------------- OOM killing
    async def _memory_monitor_loop(self):
        """Kill a victim worker when node memory crosses the threshold
        (reference: memory_monitor.h:52 + worker_killing_policy.h)."""
        from ray_tpu_torch.raylet.memory_monitor import (
            MemoryMonitor,
            WorkerCandidate,
            group_by_owner_policy,
            retriable_lifo_policy,
        )

        monitor = MemoryMonitor(threshold=CONFIG.memory_usage_threshold)
        policy = (group_by_owner_policy
                  if CONFIG.worker_killing_policy == "group_by_owner"
                  else retriable_lifo_policy)
        period = CONFIG.memory_monitor_refresh_ms / 1000.0
        while True:
            await asyncio.sleep(period)
            try:
                if not monitor.should_kill():
                    continue
                candidates = [
                    WorkerCandidate(
                        worker_id=wid, is_actor=lease.is_actor,
                        retriable=lease.retriable,
                        start_time=lease.start_time,
                        owner_id=lease.owner_id,
                    )
                    for wid, lease in self._leases.items()
                ]
                victim = policy(candidates)
                if victim is None:
                    continue
                handle = self.worker_pool.get_by_worker_id(victim.worker_id)
                if handle is None:
                    continue
                logger.warning(
                    "node memory above %.0f%%: killing worker %s "
                    "(actor=%s retriable=%s) to relieve pressure",
                    CONFIG.memory_usage_threshold * 100,
                    victim.worker_id.hex()[:8], victim.is_actor,
                    victim.retriable)
                self.worker_pool.kill_worker(handle)
            except Exception:  # noqa: BLE001 — keep monitoring
                logger.exception("memory monitor error")

    # ------------------------------------------------- object store hosting
    def _start_object_store(self):
        """Host the node's C++ shm store; workers learn the socket at
        registration (like plasma's socket in the reference's node info)."""
        if not CONFIG.enable_plasma_store:
            return
        try:
            from ray_tpu_torch._private.shm_store import StoreClient, StoreServer
            from ray_tpu_torch._private.shm_store import native_store_available

            if not native_store_available():
                return
            sock_dir = os.path.join(CONFIG.log_dir, "sockets")
            os.makedirs(sock_dir, exist_ok=True)
            # Unix socket paths cap at ~107 chars; keep it short.
            sock = os.path.join(sock_dir, f"st-{self.node_id.hex()[:12]}.sock")
            self._store_server = StoreServer(
                sock, CONFIG.object_store_memory_bytes)
            self._store_client = StoreClient(sock)
            self.store_socket = sock
            from ray_tpu_torch.raylet.external_storage import backend_from_config

            self._spill_backend = backend_from_config(self.node_id.hex()[:12])
            self._spill_dir = getattr(self._spill_backend, "directory",
                                      getattr(self._spill_backend,
                                              "base_uri", None))
        except Exception as e:  # noqa: BLE001 — degrade to memory-only store
            logger.warning("node object store unavailable: %s", e)
            self._store_server = None
            self._store_client = None

    def _spill_until(self, target_bytes: int) -> int:
        """Spill LRU unreferenced primaries until usage <= target. Returns
        bytes spilled. Runs on the caller's thread (file IO off the loop)."""
        c = self._store_client
        if c is None:
            return 0
        try:
            with self._spill_lock:
                spilled = 0
                _, used, cap = c.stats()
                if used <= target_bytes:
                    return 0
                for key in c.list_ids(primaries=True):
                    view = c.get(key, timeout_ms=0)
                    if view is None:
                        continue
                    try:
                        uri = self._spill_backend.put(key.hex(), view)
                    finally:
                        c.release(key)
                    with self._spill_maps_lock:
                        self._spilled[key] = uri
                        self._spilled_sizes[key] = len(view)
                    self._elog.emit("object.spill", object_id=key.hex(),
                                    node_id=self.node_id.hex(), uri=uri)
                    if self._spill_backend.is_remote:
                        # Recorded per object, BEFORE anything that can
                        # fail later in the batch: a spilled-and-deleted
                        # object the registry never learns about is data
                        # loss waiting for a raylet replacement.
                        with self._spill_uri_lock:
                            self._pending_spill_uris[key.hex()] = uri
                    c.delete(key)
                    spilled += len(view)
                    _, used, cap = c.stats()
                    if used <= target_bytes:
                        break
                return spilled
        finally:
            # Outside _spill_lock: the GCS round trip may block for the
            # RPC timeout, and restores/worker-spill RPCs must not queue
            # behind it. The heartbeat loop retries whatever this misses.
            self._flush_spill_uris()

    def _flush_spill_uris(self) -> None:
        """Attempt to push every pending spill URI to the GCS (blocking;
        call off the event loop). Entries leave the pending set only once
        the GCS confirmed the batch.

        Ordering matters: stale deletes go out BEFORE the batch put, and a
        key that is both freed-stale AND in the current batch was freed
        and then re-spilled — its fresh entry must survive, so it is
        dropped from the stale set entirely (deleting it after the put
        would erase the LIVE registry entry: data loss on the next
        dead-node restore)."""
        from ray_tpu_torch.raylet.external_storage import SPILL_KV_NAMESPACE

        with self._spill_uri_lock:
            batch = dict(self._pending_spill_uris)
            # freed-then-respilled: the new registration supersedes any
            # older entry, so there is nothing left to un-register
            self._freed_spill_keys.difference_update(batch)
            stale = list(self._freed_spill_keys)
        if not batch and not stale:
            return
        try:
            # Un-register keys freed while an older flush snapshot may
            # already have landed their entries — BEFORE registering the
            # current batch, so a delete can never clobber a fresh put.
            for k in stale:
                self._gcs.call("kv_del", {
                    "namespace": SPILL_KV_NAMESPACE, "key": k})
            if batch:
                self._gcs.call("kv_multi_put", {
                    "namespace": SPILL_KV_NAMESPACE, "entries": batch})
        except Exception:  # noqa: BLE001 — GCS restarting; retried later
            logger.warning("failed to sync %d spill URIs (will retry)",
                           len(batch) + len(stale))
            return
        with self._spill_uri_lock:
            for k, uri in batch.items():
                # pop only if unchanged: the object may have been freed and
                # re-spilled to a NEW uri while this flush was in flight
                if self._pending_spill_uris.get(k) == uri:
                    self._pending_spill_uris.pop(k, None)
            self._freed_spill_keys.difference_update(stale)

    async def _spill_loop(self):
        """Watermark-driven background spilling (reference: plasma create
        backpressure + local_object_manager spilling)."""
        while True:
            await asyncio.sleep(1.0)
            c = self._store_client
            if c is None:
                return
            try:
                _, used, cap = c.stats()
                if used > CONFIG.object_spilling_high_watermark * cap:
                    target = int(CONFIG.object_spilling_low_watermark * cap)
                    n = await asyncio.to_thread(self._spill_until, target)
                    if n:
                        logger.info("spilled %d bytes to %s", n, self._spill_dir)
            except Exception:  # noqa: BLE001 — keep the loop alive
                logger.exception("spill loop error")

    async def handle_spill_objects(self, payload):
        """A worker hit store-full: spill synchronously to make room."""
        if self._store_client is None:
            return 0
        _, used, cap = self._store_client.stats()
        need = payload.get("need", 0)
        target = max(0, min(int(CONFIG.object_spilling_low_watermark * cap),
                            cap - need))
        return await asyncio.to_thread(self._spill_until, target)

    async def handle_restore_object(self, payload):
        """Restore a spilled object back into shm for a reader."""
        from ray_tpu_torch._private.shm_store import _pad_id

        oid = payload["object_id"]
        key = _pad_id(oid.binary())
        uri = self._spilled.get(key)
        if uri is None and self._store_client is not None:
            # Not in the in-memory map (fresh raylet incarnation, or the
            # spilling node is gone and this raylet shares the remote
            # target): fall back to the cluster-wide registry.
            uri = await self._lookup_spill_uri(key)
        if uri is None or self._store_client is None:
            return False

        def _restore() -> bool:
            from ray_tpu_torch._private.shm_store import ShmStoreFull

            data = self._spill_backend.get(uri)
            if data is None:
                return False
            for attempt in (0, 1):
                try:
                    self._store_client.put(key, data, primary=True)
                    return True
                except ShmStoreFull:
                    if attempt == 0:
                        # Store under pressure: make room by spilling other
                        # cold primaries, then retry — failing here would
                        # surface as ObjectLost for data that's safe on disk.
                        _, used, cap = self._store_client.stats()
                        self._spill_until(max(0, cap - len(data)))
                        continue
                    return False
                except Exception:  # noqa: BLE001 — EXISTS race is success
                    return self._store_client.contains(key)
            return False

        ok = await asyncio.to_thread(_restore)
        if ok:
            size = self._store_client.size_of(key) or 0
            with self._spill_maps_lock:
                self._spilled[key] = uri  # cache for the next restore/free
                self._spilled_sizes.setdefault(key, size)
            self._elog.emit("object.restore", object_id=key.hex(),
                            node_id=self.node_id.hex(), uri=uri)
        return ok

    async def _lookup_spill_uri(self, key: bytes) -> Optional[str]:
        from ray_tpu_torch.raylet.external_storage import SPILL_KV_NAMESPACE

        if not self._spill_backend.is_remote:
            return None
        try:
            return await self._gcs.call_async("kv_get", {
                "namespace": SPILL_KV_NAMESPACE, "key": key.hex()})
        except Exception:  # noqa: BLE001 — GCS restarting
            return None

    async def handle_free_spilled(self, payload):
        from ray_tpu_torch._private.shm_store import _pad_id
        from ray_tpu_torch.raylet.external_storage import SPILL_KV_NAMESPACE

        to_delete = []
        with self._spill_maps_lock:
            for oid in payload["object_ids"]:
                key = _pad_id(oid.binary())
                uri = self._spilled.pop(key, None)
                self._spilled_sizes.pop(key, None)
                if uri is not None:
                    to_delete.append((key, uri))
        if not to_delete:
            return True
        if self._spill_backend is not None and self._spill_backend.is_remote:
            # Registry bookkeeping exists only for REMOTE spill backends
            # (the cluster-wide URI registry). On the default local-disk
            # backend there is no registry to reconcile — tracking freed
            # keys here would just feed pointless per-key kv_del RPCs to
            # every heartbeat.
            with self._spill_uri_lock:
                for key, _uri in to_delete:
                    # Raced the spill batch before its registry flush: drop
                    # the pending entry so the flush can't register a freed
                    # object; remember the key so a flush whose snapshot
                    # predates this free gets un-registered afterwards.
                    self._pending_spill_uris.pop(key.hex(), None)
                    self._freed_spill_keys.add(key.hex())

        def _delete_batch():
            # Off-loop: a remote backend's delete is a network round trip
            # per object; a batch of frees must not stall lease/restore
            # handling for its duration.
            for _key, uri in to_delete:
                self._spill_backend.delete(uri)

        await asyncio.to_thread(_delete_batch)
        if self._spill_backend.is_remote:
            for key, _uri in to_delete:
                try:
                    await self._gcs.send_async("kv_del", {
                        "namespace": SPILL_KV_NAMESPACE, "key": key.hex()})
                except Exception:  # noqa: BLE001 — best-effort GC
                    logger.debug("spill-key GC kv_del failed for %s",
                                 key.hex(), exc_info=True)
        return True

    def stop(self, unregister: bool = True):
        if self._stopped:
            return
        self._stopped = True
        if self._event_sink_token is not None:
            event_log.flush(timeout=0.5)
            event_log.clear_sink(self._event_sink_token)
        if getattr(self, "_span_sink_token", None) is not None:
            _tracing.flush_spans(timeout=0.5)
            _tracing.clear_span_sink(self._span_sink_token)
        if getattr(self, "_metrics_push_token", None) is not None:
            from ray_tpu_torch.health import push as _health_push
            _health_push.clear_push_sink(self._metrics_push_token)
        for t in self._tasks:
            t.cancel()
        if self._store_client is not None:
            self._store_client.disconnect()
            self._store_client = None
        if self._store_server is not None:
            self._store_server.stop()
            self._store_server = None
        if self.worker_pool is not None:
            self.worker_pool.shutdown()
        if unregister and self._gcs is not None:
            try:
                self._gcs.call("unregister_node", {"node_id": self.node_id}, timeout=2)
            except Exception:  # noqa: BLE001 — GCS notices via heartbeats
                logger.debug("unregister_node failed on stop", exc_info=True)
        self._pool.close_all()
        if self._gcs is not None:
            self._gcs.close()
        self._server.stop()
        self._lt.stop()

    # ------------------------------------------------------------- RPC: pool
    async def handle_register_worker(self, payload):
        self.worker_pool.register_worker(
            payload["worker_id"], payload["pid"], payload["address"],
            spawn_token=payload.get("spawn_token", ""),
        )
        self._kick()
        return {"status": "ok", "node_id": self.node_id,
                "store_socket": self.store_socket}

    async def handle_register_driver(self, payload):
        self.worker_pool.register_driver(
            payload["worker_id"], payload["pid"], payload["address"]
        )
        return {"status": "ok", "node_id": self.node_id,
                "gcs_address": self.gcs_address,
                "store_socket": self.store_socket}

    async def handle_return_worker(self, payload):
        """Lease released by the submitter (direct_task_transport returns)."""
        addr: Address = payload["worker_address"]
        worker_id = addr.worker_id
        lease = self._leases.pop(worker_id, None)
        if lease is not None:
            self._release_lease_resources(lease)
        self.worker_pool.return_worker(worker_id, payload.get("disconnect", False))
        self._kick()
        return True

    # ------------------------------------------------------------ RPC: lease
    def _expired_reply(self, spec: TaskSpec) -> dict:
        """Doomed-work elimination: the spec's deadline passed (on arrival
        or while queued) — tell the owner which task to resolve typed."""
        trace_id = _tracing.trace_id_of(spec)
        self._elog.emit("task.deadline_expired", task_id=spec.task_id.hex(),
                        node_id=self.node_id.hex(), trace_id=trace_id,
                        layer="raylet", function=spec.function_name)
        _backoff.count_deadline_expired("raylet")
        _tracing.force_trace(trace_id, "task.deadline_expired:raylet")
        return {"rejected": True, "deadline_expired": True,
                "task_id": spec.task_id.hex()}

    def _lease_queue_guard(self, spec: TaskSpec) -> Optional[dict]:
        """Bounded lease queue (every queue names its bound —
        raylet_lease_queue_max): overflow returns typed retry_later
        pushback with a hint scaled to the backlog, so the owner paces
        (AIMD) instead of parking work here forever."""
        bound = CONFIG.raylet_lease_queue_max
        if bound <= 0 or len(self._queue) < bound:
            return None
        trace_id = _tracing.trace_id_of(spec)
        self._elog.emit("task.shed", task_id=spec.task_id.hex(),
                        node_id=self.node_id.hex(), trace_id=trace_id,
                        layer="raylet", reason="lease queue full",
                        function=spec.function_name)
        _backoff.count_shed("raylet")
        _tracing.force_trace(trace_id, "task.shed:raylet")
        return {
            "rejected": True,
            "retry_later": True,
            "retry_after_s": _backoff.retry_after_hint(len(self._queue)),
            "reason": f"lease queue full ({len(self._queue)} waiting)",
        }

    async def handle_request_worker_lease(self, payload):
        spec: TaskSpec = payload["spec"]
        spillback_count = payload.get("spillback_count", 0)
        strat = spec.scheduling_strategy

        if _deadlines.expired(spec.deadline_s):
            # expired on arrival: never enters the queue
            return self._expired_reply(spec)

        if self._draining:
            # A draining node takes no new work; the submitter retries
            # against the rest of the cluster (whose views drop this node
            # as its heartbeats report zero availability).
            self._elog.emit("lease.reject", task_id=spec.task_id.hex(),
                            node_id=self.node_id.hex(),
                            function=spec.function_name,
                            reason="node is draining")
            return {"rejected": True, "reason": "node is draining"}

        if strat.kind == "PLACEMENT_GROUP":
            # The submitter routes PG leases to the node holding the bundle.
            if strat.placement_group_id not in self._bundles:
                return {"rejected": True, "reason": "bundle not on this node"}
            shed = self._lease_queue_guard(spec)
            if shed is not None:
                return shed
            return await self._queue_local(spec)

        if spillback_count == 0:
            target = self._cluster_decision(spec)
            if target is None and strat.kind == "NODE_LABEL":
                # hard label constraints are HARD: falling through to the
                # local queue would run the task on a non-matching node.
                # Reject so the submitter keeps retrying (pending until a
                # matching node joins); the shape + its label constraint
                # read as infeasible demand, which the autoscaler only
                # counts against node types declaring matching labels.
                from ray_tpu_torch._private.specs import _freeze

                shape = (tuple(sorted(_placement_res(spec).items())),
                         _freeze(strat.hard_labels) or ())
                self._infeasible[shape] = time.monotonic()
                return {"rejected": True,
                        "reason": "no node satisfies the label constraints"}
            if target is not None and target != self.node_id:
                addr = self._raylet_addr_for(target)
                if addr is not None:
                    self._elog.emit(
                        "lease.spillback", task_id=spec.task_id.hex(),
                        node_id=self.node_id.hex(),
                        function=spec.function_name, target=addr)
                    return {
                        "retry_at": addr,
                        "retry_at_node_id": target,
                    }
        if not resources_fit(self.total, _placement_res(spec)):
            # Remember the shape: rejected demand must still be visible to
            # the autoscaler (reference: the infeasible-task queue in
            # cluster_task_manager is reported as load), otherwise a task no
            # node can host never triggers scale-up.
            shape = (tuple(sorted(_placement_res(spec).items())), ())
            self._infeasible[shape] = time.monotonic()
            self._elog.emit("lease.reject", task_id=spec.task_id.hex(),
                            node_id=self.node_id.hex(),
                            function=spec.function_name,
                            reason="infeasible on this node")
            return {"rejected": True, "reason": "infeasible on this node"}
        shed = self._lease_queue_guard(spec)
        if shed is not None:
            return shed
        return await self._queue_local(spec)

    def _cluster_decision(self, spec: TaskSpec) -> Optional[NodeID]:
        strat = spec.scheduling_strategy
        view = self._cluster_view
        res = _placement_res(spec)
        if strat.kind == "NODE_AFFINITY":
            return policy.node_affinity_policy(
                view, res, strat.node_id, strat.soft, self.node_id
            )
        if strat.kind == "SPREAD":
            self._spread_rr += 1
            return policy.spread_policy(view, res, self._spread_rr)
        if strat.kind == "NODE_LABEL":
            labels = dict(self._cluster_labels)
            labels.setdefault(self.node_id, self.labels)
            return policy.node_label_policy(
                view, res, labels, strat.hard_labels, strat.soft_labels,
                self.node_id)
        return policy.hybrid_policy(view, res, self.node_id)

    def _raylet_addr_for(self, node_id: NodeID) -> Optional[str]:
        entry = self._cluster_addrs.get(node_id) if hasattr(self, "_cluster_addrs") else None
        return entry

    async def _queue_local(self, spec: TaskSpec):
        fut = self._lt.loop.create_future()
        self._queue.append(_QueuedLease(spec, fut))
        self._kick()
        return await fut

    def _kick(self):
        if self._dispatch_event is not None:
            self._lt.loop.call_soon_threadsafe(self._dispatch_event.set)

    # -------------------------------------------------------- dispatch loop
    async def _dispatch_loop(self):
        while True:
            await self._dispatch_event.wait()
            self._dispatch_event.clear()
            again = True
            while again:
                again = False
                now = time.time()
                for q in list(self._queue):
                    if q.future.done():
                        self._queue.remove(q)
                        continue
                    if _deadlines.expired(q.spec.deadline_s, now):
                        # queue-pop doomed-work elimination: the caller
                        # gave up while this lease waited for resources —
                        # dropping it here frees the slot for live work
                        self._queue.remove(q)
                        q.future.set_result(self._expired_reply(q.spec))
                        continue
                    alloc = self._try_allocate(q.spec)
                    if alloc is None:
                        continue
                    self._queue.remove(q)
                    again = True
                    asyncio.ensure_future(self._grant(q, alloc))

    def _pick_cards(self, amount: float) -> Optional[Tuple[int, ...]]:
        """The cards a lease of `amount` GPUs binds, or None while the free
        shares cannot hold it: k whole cards take k cards that are wholly
        free (the lowest indices); a share below one takes the fullest card
        that still holds it, so fractional leases pack and leave whole
        cards whole. () for a lease without cards."""
        if amount <= 0:
            return ()
        if amount >= 1:
            free = [i for i, f in sorted(self._card_free.items())
                    if f >= 1.0 - 1e-9]
            k = int(round(amount))
            return tuple(free[:k]) if len(free) >= k else None
        fits = [(f, i) for i, f in self._card_free.items()
                if f >= amount - 1e-9]
        return (min(fits)[1],) if fits else None

    def _take_cards(self, cards: Tuple[int, ...], amount: float) -> None:
        share = 1.0 if amount >= 1 else amount
        for i in cards:
            self._card_free[i] -= share

    def _return_cards(self, cards: Tuple[int, ...], amount: float) -> None:
        share = 1.0 if amount >= 1 else amount
        for i in cards:
            self._card_free[i] = min(1.0, self._card_free[i] + share)

    def _try_allocate(self, spec: TaskSpec) -> Optional[Tuple[Resources, Optional[PlacementGroupID], int, Tuple[int, ...]]]:
        # The placement decision checks placement_resources; the allocation
        # holds only spec.resources (what the task/actor retains while
        # running — for default-cpu actors that's no CPU, reference
        # semantics: required_resources vs required_placement_resources).
        # A `GPU` lease also needs its cards (_pick_cards).
        cards = self._pick_cards(spec.resources.get("GPU", 0.0))
        if cards is None:
            return None
        alloc = self._try_allocate_resources(spec)
        if alloc is None:
            return None
        self._take_cards(cards, spec.resources.get("GPU", 0.0))
        return (*alloc, cards)

    def _try_allocate_resources(self, spec: TaskSpec) -> Optional[Tuple[Resources, Optional[PlacementGroupID], int]]:
        strat = spec.scheduling_strategy
        place = _placement_res(spec)
        if strat.kind == "PLACEMENT_GROUP":
            bundles = self._bundles.get(strat.placement_group_id)
            if bundles is None:
                return None
            indices = (
                [strat.bundle_index]
                if strat.bundle_index >= 0
                else sorted(bundles.keys())
            )
            for i in indices:
                b = bundles.get(i)
                if b is not None and b.committed and resources_fit(b.available, place):
                    subtract_resources(b.available, spec.resources)
                    return (dict(spec.resources), strat.placement_group_id, i)
            return None
        if resources_fit(self.available, place):
            subtract_resources(self.available, spec.resources)
            return (dict(spec.resources), None, -1)
        return None

    async def _grant(self, q: _QueuedLease, alloc):
        granted_at = time.monotonic()
        hist = _lease_stage_hist()
        if hist is not None:
            hist.observe(max(0.0, granted_at - q.enqueue_time),
                         tags={"stage": "queue"})
        resources, pg_id, bundle_index, cards = alloc
        # A GPU lease runs in a worker bound to exactly its cards (spawned
        # with their CUDA_VISIBLE_DEVICES, never forked from the zygote):
        # the pool keys such workers by their card set.
        worker = await self.worker_pool.pop_worker(
            CONFIG.worker_register_timeout_s, cards=cards)
        if hist is not None:
            hist.observe(max(0.0, time.monotonic() - granted_at),
                         tags={"stage": "dispatch"})
        if worker is None or q.future.done():
            self._release_alloc(resources, pg_id, bundle_index, cards)
            if worker is not None:
                self.worker_pool.return_worker(worker.worker_id)
            if not q.future.done():
                q.future.set_result({"rejected": True, "reason": "no worker available"})
            return
        is_actor = q.spec.task_type == TaskType.ACTOR_CREATION_TASK
        # job attribution for log streaming, marked at the current file
        # offset: lines already written belong to the PREVIOUS job even if
        # the monitor scans after this re-lease
        worker.mark_job(q.spec.job_id.hex() if q.spec.job_id else None)
        owner = q.spec.owner_address
        self._leases[worker.worker_id] = _Lease(
            worker_id=worker.worker_id,
            resources=resources,
            pg_id=pg_id,
            bundle_index=bundle_index,
            cards=cards,
            is_actor=is_actor,
            retriable=(q.spec.actor_creation.max_restarts != 0
                       if is_actor and q.spec.actor_creation is not None
                       else q.spec.max_retries != 0),
            owner_id=(owner.worker_id.hex()
                      if owner is not None and owner.worker_id else ""),
        )
        if is_actor:
            self.worker_pool.mark_actor_worker(
                worker.worker_id, q.spec.actor_creation.actor_id
            )
        addr = Address(
            node_id=self.node_id,
            worker_id=worker.worker_id,
            rpc_address=worker.address.rpc_address,
        )
        self._elog.emit("lease.grant", task_id=q.spec.task_id.hex(),
                        node_id=self.node_id.hex(),
                        function=q.spec.function_name,
                        worker_id=worker.worker_id.hex())
        if getattr(q.spec, "trace_ctx", None) is not None:
            # the raylet's contribution to the trace: queued -> granted,
            # on this process's wall clock (spans never need clock sync —
            # the tree hangs off span ids, not timestamps)
            now = time.time()
            _tracing.record_span(
                "raylet.lease", q.spec.trace_ctx,
                now - (time.monotonic() - q.enqueue_time), now,
                proc=f"raylet:{self.node_id.hex()[:12]}",
                attrs={"task_id": q.spec.task_id.hex(),
                       "worker_id": worker.worker_id.hex()[:12]})
        q.future.set_result({"worker_address": addr})

    def _release_alloc(self, resources: Resources, pg_id, bundle_index,
                       cards: Tuple[int, ...] = ()):
        self._return_cards(cards, resources.get("GPU", 0.0))
        if pg_id is not None:
            bundles = self._bundles.get(pg_id)
            if bundles is not None and bundle_index in bundles:
                add_resources(bundles[bundle_index].available, resources)
            else:
                # The PG was cancelled while this lease ran: cancel_bundles
                # returned only the UNUSED bundle portion to the node pool,
                # so the lease-held portion must come back here — otherwise
                # every PG removal with running workers permanently leaks
                # the consumed chips/CPUs.
                add_resources(self.available, resources)
        else:
            add_resources(self.available, resources)
        self._kick()

    def _release_lease_resources(self, lease: _Lease):
        self._release_alloc(lease.resources, lease.pg_id, lease.bundle_index,
                            lease.cards)

    # ----------------------------------------------------------- RPC: PG 2PC
    async def handle_prepare_bundles(self, payload):
        pg_id: PlacementGroupID = payload["placement_group_id"]
        bundles: Dict[int, Resources] = payload["bundles"]
        total_demand: Resources = {}
        for b in bundles.values():
            for k, v in b.items():
                total_demand[k] = total_demand.get(k, 0.0) + v
        if not resources_fit(self.available, total_demand):
            return False
        subtract_resources(self.available, total_demand)
        entry = self._bundles.setdefault(pg_id, {})
        for i, b in bundles.items():
            entry[i] = _Bundle(resources=dict(b), available=dict(b), committed=False)
        return True

    async def handle_commit_bundles(self, payload):
        pg_id: PlacementGroupID = payload["placement_group_id"]
        entry = self._bundles.get(pg_id, {})
        for i in payload["indices"]:
            if i in entry:
                entry[i].committed = True
        self._kick()
        return True

    async def handle_cancel_bundles(self, payload):
        pg_id: PlacementGroupID = payload["placement_group_id"]
        entry = self._bundles.pop(pg_id, None)
        if entry:
            for b in entry.values():
                # Return the bundle reservation to the node pool. Resources
                # currently consumed by still-running leases are returned when
                # those leases end (guarded in _release_alloc by pg removal).
                add_resources(self.available, b.available)
            # Evict workers still running inside the released bundles: the
            # gang's reservation is gone, so its actors/tasks must not keep
            # holding chips outside any PG (reference: PG removal kills
            # leased workers; also the TPU-gang wholesale reschedule path —
            # gcs/pg_manager.on_node_death — relies on this to free the
            # surviving hosts before re-placing the gang).
            for lease in list(self._leases.values()):
                if lease.pg_id != pg_id:
                    continue
                handle = self.worker_pool.get_by_worker_id(lease.worker_id)
                if handle is not None:
                    # reaper observes the exit -> on_worker_death releases
                    # the lease and reports actor death (restart FSM)
                    self.worker_pool.kill_worker(handle)
        self._kick()
        return True

    async def handle_drain_node(self, payload):
        """Graceful drain (reference: NodeManager::HandleDrainRaylet +
        `ray drain-node`, scripts.py:2268). Stops accepting leases, rejects
        queued ones so their submitters retry elsewhere, then unregisters
        once running leases finish — or kills the stragglers when the
        deadline passes (their actors restart elsewhere via the GCS FSM)."""
        if self._draining:
            return {"status": "already_draining"}
        self._draining = True
        self.drain_reason = payload.get("reason", "")
        self._elog.emit("node.drain", node_id=self.node_id.hex(),
                        reason=self.drain_reason)
        deadline_s = float(payload.get("deadline_s", 300.0))
        for q in list(self._queue):
            if not q.future.done():
                q.future.set_result(
                    {"rejected": True, "reason": "node is draining"})
        self._queue.clear()
        # Release local placement-group bundles (killing their leased
        # workers): the gang reservation cannot 'finish' the way a task
        # does, and the GCS re-places these bundles on other nodes right
        # after this RPC returns (gcs/server.py::_handle_drain_node).
        for pg_id in list(self._bundles):
            await self.handle_cancel_bundles({"placement_group_id": pg_id})
        self._tasks.append(
            self._lt.loop.create_task(self._drain_watch(deadline_s)))
        return {"status": "draining", "active_leases": len(self._leases)}

    async def handle_preempt_notice(self, payload):
        """Advance notice of node loss (preemptible-TPU semantics; GCS
        `preempt_node` forwards here). Differs from handle_drain_node in
        ONE load-bearing way: placement-group bundles survive the notice
        window instead of being cancelled up front, so training gangs can
        checkpoint-and-drain and serve replicas can finish their in-flight
        streams before their workers go away. New leases stop immediately;
        at the deadline any surviving bundles are released and the normal
        drain path kills stragglers and unregisters the node."""
        if self._draining:
            return {"status": "already_draining"}
        deadline_s = float(payload.get("deadline_s", 30.0))
        reason = payload.get("reason", "preemption")
        self._draining = True
        self.drain_reason = f"preempt: {reason}" if reason else "preempt"
        self._elog.emit("node.preempt_notice", node_id=self.node_id.hex(),
                        deadline_s=deadline_s, reason=reason)
        for q in list(self._queue):
            if not q.future.done():
                q.future.set_result(
                    {"rejected": True, "reason": "node is draining"})
        self._queue.clear()
        self._tasks.append(
            self._lt.loop.create_task(self._preempt_watch(deadline_s)))
        return {"status": "draining", "deadline_s": deadline_s,
                "active_leases": len(self._leases),
                "active_bundles": len(self._bundles)}

    async def _preempt_watch(self, deadline_s: float):
        """Wait out the notice window: workloads that heed the notice
        tear their own leases/bundles down (gang shutdown removes its
        placement group; drained serve replicas are killed by their
        controller). Whatever survives the deadline is released the hard
        way, then the node leaves through the normal drain path."""
        deadline = time.monotonic() + deadline_s
        while ((self._leases or self._bundles)
               and time.monotonic() < deadline):
            await asyncio.sleep(0.1)
        for pg_id in list(self._bundles):
            await self.handle_cancel_bundles({"placement_group_id": pg_id})
        await self._drain_watch(5.0)

    async def _drain_watch(self, deadline_s: float):
        deadline = time.monotonic() + deadline_s
        while self._leases and time.monotonic() < deadline:
            await asyncio.sleep(0.1)
        if self._leases:
            logger.warning(
                "drain deadline passed with %d leases running; killing "
                "their workers", len(self._leases))
            for lease in list(self._leases.values()):
                handle = self.worker_pool.get_by_worker_id(lease.worker_id)
                if handle is not None:
                    self.worker_pool.kill_worker(handle)
            # let the reaper observe the deaths so actor-death reports and
            # lease releases happen through the normal path
            t0 = time.monotonic()
            while self._leases and time.monotonic() - t0 < 5.0:
                await asyncio.sleep(0.1)
        try:
            await self._gcs.call_async(
                "unregister_node", {"node_id": self.node_id}, timeout=5.0)
        except (ConnectionLost, OSError, asyncio.TimeoutError):
            pass  # GCS will notice via missed heartbeats
        logger.info("node %s drained (%s)", self.node_id.hex()[:8],
                    self.drain_reason or "no reason given")
        self.drain_complete.set()
        if self._exit_on_drain:
            threading.Thread(
                target=lambda: (time.sleep(0.05), os._exit(0)),
                daemon=True).start()

    async def handle_chaos_start(self, payload):
        """Install a fault-injection plan in this raylet's process
        (message-level chaos; see _private/fault_injection.py). Workers
        spawned AFTER installation inherit it via the RAY_TPU_CHAOS env
        only if the operator exported it; in-process installs cover the
        raylet/GCS/driver side of every worker conversation."""
        from ray_tpu_torch._private import fault_injection as fi

        plan = fi.install(fi.ChaosPlan.from_json(payload["plan"]))
        return {"status": "installed", "seed": plan.seed,
                "rules": len(plan.rules)}

    async def handle_chaos_stop(self, payload):
        from ray_tpu_torch._private import fault_injection as fi

        plan = fi.uninstall()
        return {"status": "uninstalled",
                "stats": plan.stats() if plan else None}

    async def handle_chaos_status(self, payload):
        from ray_tpu_torch._private import fault_injection as fi

        plan = fi.active_plan()
        return {"installed": plan is not None,
                "stats": plan.stats() if plan else None}

    async def handle_die(self, payload):
        """Chaos RPC (`ray-tpu kill-random-node`): ungraceful PROCESS death
        — the GCS discovers it via missed heartbeats, exercising the same
        recovery paths as a crashed host. Only meaningful for raylets
        running as their own process (`python -m ray_tpu_torch start`)."""
        threading.Thread(
            target=lambda: (time.sleep(0.05),
                            event_log.flight_dump("die_rpc"),
                            os._exit(1)),
            daemon=True).start()
        return True

    async def handle_tail_worker_logs(self, payload):
        """Last N lines of each (or one) worker's log file on this node —
        backs the `ray-tpu logs` CLI and the state API logs route. File
        reads run in a thread: a debugging RPC must not stall the lease/
        dispatch loop."""
        return await asyncio.to_thread(
            self._tail_worker_logs_sync, payload.get("pid"),
            int(payload.get("lines", 100)))

    def _tail_worker_logs_sync(self, want_pid, n: int):
        out = {}
        for handle in list(self.worker_pool._workers.values()):
            if not handle.log_path or (want_pid and handle.pid != want_pid):
                continue
            try:
                with open(handle.log_path, "rb") as f:
                    f.seek(0, os.SEEK_END)
                    size = f.tell()
                    f.seek(max(0, size - 256 * 1024))
                    lines = f.read().decode("utf-8", "replace").splitlines()
            except OSError:
                continue
            out[handle.pid] = {
                "worker_id": handle.worker_id.hex()
                if handle.worker_id else None,
                "state": handle.state,
                "path": handle.log_path,
                "lines": lines[-n:],
            }
        return out

    async def handle_list_worker_pids(self, payload):
        """Registered (profile-able) worker pids on this node — lets the
        dashboard agent distinguish real workers from fork-servers, which
        share the same cmdline in /proc."""
        return sorted(h.pid for h in self.worker_pool._workers.values()
                      if h.pid is not None)

    async def handle_profile_worker(self, payload):
        """Fan a CPU/heap profile request to one of this node's workers
        (reference: dashboard reporter profile endpoints). payload:
        {pid, kind: "cpu"|"memory", duration_s?, interval_ms?, top?}."""
        want_pid = payload.get("pid")
        kind = payload.get("kind", "cpu")
        method = {"cpu": "profile_cpu", "memory": "profile_memory",
                  "device": "profile_device"}.get(kind, "profile_cpu")
        timeout = float(payload.get("duration_s", 5.0)) + 30
        if kind == "device" and want_pid is None:
            # device-phase reports are cheap aggregates — with no pid the
            # whole node answers: {pid: snapshot} for every live worker
            # (the `ray-tpu profile --device` cluster fan-out). Queries
            # run CONCURRENTLY with a short per-worker timeout: the
            # caller gives the whole NODE one budget, so two hung
            # workers polled sequentially must not discard every healthy
            # worker's report with them.
            import asyncio as _asyncio

            handles = [h for h in list(self.worker_pool._workers.values())
                       if h.pid is not None and h.address is not None]

            async def _one(handle):
                try:
                    return handle.pid, await self._pool.get(
                        handle.address.rpc_address).call_async(
                            method, payload, timeout=10)
                except Exception as e:  # noqa: BLE001 — worker mid-death
                    return handle.pid, {"error": str(e)}

            results = await _asyncio.gather(*(_one(h) for h in handles))
            return {"node_id": self.node_id,
                    "workers": dict(results)}
        for handle in list(self.worker_pool._workers.values()):
            if handle.pid != want_pid or handle.address is None:
                continue
            return await self._pool.get(
                handle.address.rpc_address).call_async(
                    method, payload, timeout=timeout)
        return {"error": f"no live worker with pid {want_pid} on this node"}

    # ------------------------------------------------------------ RPC: stats
    async def handle_get_node_stats(self, payload):
        store = None
        if self._store_client is not None:
            try:
                n, used, cap = self._store_client.stats()
                store = {"objects": n, "used_bytes": used,
                         "capacity_bytes": cap}
            except Exception:  # noqa: BLE001 — store restarting
                store = None
        return {
            "node_id": self.node_id,
            "total": dict(self.total),
            "available": dict(self.available),
            "queued_leases": len(self._queue),
            "active_leases": len(self._leases),
            "num_workers": self.worker_pool.num_alive if self.worker_pool else 0,
            "store": store,
            "bundles": {
                pg.hex(): {i: b.resources for i, b in e.items()}
                for pg, e in self._bundles.items()
            },
        }

    async def handle_node_memory_report(self, payload):
        """Node-level memory observability: arena occupancy +
        free-list fragmentation, spill accounting, and every live
        worker's memory_report — fanned out CONCURRENTLY with a short
        per-worker timeout (the profile_worker device pattern: the caller
        budgets the NODE, so two hung workers polled sequentially must
        not discard every healthy worker's report with them)."""
        worker_timeout = float(payload.get("worker_timeout_s", 10.0))
        include_refs = bool(payload.get("refs", True))
        base = await asyncio.to_thread(
            self._node_memory_stats_sync, include_refs)

        handles = [h for h in list(self.worker_pool._workers.values())
                   if h.pid is not None and h.address is not None]

        async def _one(handle):
            try:
                return handle.pid, await self._pool.get(
                    handle.address.rpc_address).call_async(
                        "memory_report", {"refs": include_refs},
                        timeout=worker_timeout)
            except Exception as e:  # noqa: BLE001 — worker mid-death
                return handle.pid, {"error": str(e)}

        results = await asyncio.gather(*(_one(h) for h in handles))
        base["workers"] = dict(results)
        return base

    def _node_memory_stats_sync(self, include_resident: bool) -> dict:
        """Store + spill accounting for node_memory_report. Runs in a
        thread: store RPCs can block while the store restarts."""
        store = None
        if self._store_client is not None:
            try:
                c = self._store_client
                n, used, cap = c.stats()
                holes, largest, free_total = c.free_info()
                store = {
                    "objects": n, "used_bytes": used, "capacity_bytes": cap,
                    # a put needs ONE contiguous hole: 1 - largest/total
                    # rises as the arena shatters even while used/capacity
                    # still shows headroom
                    "fragmentation": (0.0 if free_total == 0
                                      else 1.0 - largest / free_total),
                    "free_holes": holes,
                    "largest_free_bytes": largest,
                }
                if include_resident:
                    # Sealed, client-unreferenced residents (the
                    # spillable-primaries + evictable-caches free lists):
                    # the leak sweep correlates these keys against the
                    # cluster union of references — a resident key no ref
                    # table knows is an orphan nothing will ever free.
                    resident = {}
                    for primaries in (True, False):
                        for key in c.list_ids(max_ids=4096,
                                              primaries=primaries):
                            sz = c.size_of(key)
                            if sz is not None:
                                resident[key.hex()] = sz
                    store["resident_unreferenced"] = resident
            except Exception:  # noqa: BLE001 — store restarting
                store = None
        with self._spill_uri_lock:
            pending = len(self._pending_spill_uris)
        # under the maps lock: iterating .values()/keys while a to_thread
        # spill batch mutates the dicts raises "changed size during
        # iteration" on the loop
        with self._spill_maps_lock:
            spill = {"objects": len(self._spilled),
                     "bytes": sum(self._spilled_sizes.values()),
                     "pending_uris": pending,
                     "spilled_keys": [k.hex() for k in self._spilled]}
        return {"node_id": self.node_id, "store": store, "spill": spill}

    async def handle_raylet_ping(self, payload):
        return {"status": "ok", "node_id": self.node_id}

    async def handle_pubsub_message(self, payload):
        channel, key, message = payload
        if channel == "NODE":
            info: NodeInfo = message
            if info.node_id == self.node_id:
                return True
            if info.alive:
                self._cluster_view[info.node_id] = (
                    dict(info.resources_total),
                    dict(info.resources_available),
                )
                self._cluster_addrs[info.node_id] = info.raylet_address
                self._cluster_labels[info.node_id] = dict(info.labels)
            else:
                self._cluster_view.pop(info.node_id, None)
                self._cluster_addrs.pop(info.node_id, None)
                self._cluster_labels.pop(info.node_id, None)
        return True

    # ------------------------------------------------------- background loops
    async def _heartbeat_loop(self):
        period = CONFIG.heartbeat_period_ms / 1000.0
        gcs_failures = 0  # consecutive unreachable-GCS heartbeats
        while True:
            try:
                if self._pending_spill_uris or self._freed_spill_keys:
                    # Spill-registry retry backstop (GCS was unreachable
                    # when the spill thread tried); off-loop, it blocks.
                    await asyncio.to_thread(self._flush_spill_uris)
                # Aggregate queued lease shapes so the autoscaler can
                # bin-pack unfulfilled demand (reference: load reported to
                # GCS drives resource_demand_scheduler.py).
                from ray_tpu_torch._private.specs import _freeze

                demand_counts: Dict[tuple, int] = {}
                for q in self._queue[:200]:
                    strat = q.spec.scheduling_strategy
                    labels = ((_freeze(strat.hard_labels) or ())
                              if strat.kind == "NODE_LABEL" else ())
                    shape = (tuple(sorted(_placement_res(q.spec).items())),
                             labels)
                    demand_counts[shape] = demand_counts.get(shape, 0) + 1
                # Infeasible shapes seen in the last 5s count as demand
                # (the submitter is still retrying them against us).
                now = time.monotonic()
                for shape, ts in list(self._infeasible.items()):
                    if now - ts > 5.0:
                        del self._infeasible[shape]
                    else:
                        demand_counts[shape] = demand_counts.get(shape, 0) + 1
                reply = await self._gcs.call_async(
                    "report_resources",
                    {
                        "node_id": self.node_id,
                        # a draining node advertises zero availability so no
                        # peer's cluster decision picks it
                        "available": ({} if self._draining
                                      else dict(self.available)),
                        "total": dict(self.total),
                        "draining": self._draining,
                        "load": len(self._queue),
                        "known_version": self._view_version,
                        "pending_demands": [
                            (dict(res), n, dict(labels) or None)
                            for (res, labels), n in demand_counts.items()
                        ],
                    },
                    timeout=5.0,
                )
                if reply.get("status") == "ok":
                    self._apply_view_reply(reply)
                elif reply.get("status") == "unknown_node":
                    # A restarted GCS (or one that declared us dead during
                    # a partition) no longer knows this node: re-register
                    # and re-subscribe, then keep heartbeating — the
                    # reference's raylets reconnect to a restarted GCS the
                    # same way (gcs_redis_failure_detector.h). NEVER from
                    # a draining node: it unregistered on purpose and
                    # re-registering would resurrect a zombie the GCS
                    # would keep routing leases to.
                    if not self._draining:
                        await self._reconnect_gcs()
                gcs_failures = 0
            except (ConnectionLost, OSError, asyncio.TimeoutError):
                gcs_failures += 1
            if gcs_failures:
                # Exponential backoff with jitter while the GCS is
                # unreachable (shared policy module — the schedule is
                # bit-for-bit the earlier hand-rolled one, parity-tested):
                # at a fixed period, every raylet of an N-node cluster
                # would hammer a restarting GCS in lockstep. Doubling per
                # consecutive failure caps the aggregate load, and the
                # per-node jitter (seeded by node id: deterministic per
                # node, decorrelated across nodes) spreads the
                # re-registration burst when the GCS comes back.
                await asyncio.sleep(
                    self._reconnect_policy.delay(gcs_failures))
            else:
                await asyncio.sleep(period)

    async def _reconnect_gcs(self) -> None:
        info = NodeInfo(
            node_id=self.node_id,
            raylet_address=self.address,
            resources_total=dict(self.total),
            resources_available=dict(self.available),
            labels=self.labels,
            is_head=self.is_head,
        )
        try:
            await self._gcs.call_async("register_node", {"info": info},
                                       timeout=5.0)
            await self._gcs.call_async(
                "subscribe",
                {"channel": "NODE", "subscriber_address": self.address},
                timeout=5.0)
            self._view_version = 0  # force a full view on the next beat
            logger.warning("re-registered with restarted GCS at %s",
                           self.gcs_address)
        except (ConnectionLost, OSError, asyncio.TimeoutError):
            pass  # next heartbeat retries

    def _apply_view_reply(self, reply: dict) -> None:
        """Sync the local cluster view from a heartbeat reply: a delta
        (changed entries + removals since our version — reference:
        ray_syncer.h versioned snapshot relay) or a full view (legacy
        shape, or GCS-declared version gap)."""
        if "cluster_view" in reply:  # legacy full-view shape
            view = reply["cluster_view"]
            replace = True
        else:
            view = reply.get("cluster_delta", {})
            replace = bool(reply.get("full"))
            self._view_version = reply.get("view_version",
                                           self._view_version)
        if replace:
            self._cluster_addrs = {}
            self._cluster_labels = {}
            self._cluster_view = {}
        for nid in reply.get("removed", []):
            self._cluster_addrs.pop(nid, None)
            self._cluster_labels.pop(nid, None)
            self._cluster_view.pop(nid, None)
        for nid, (addr, total, avail, labels) in view.items():
            self._cluster_addrs[nid] = addr
            self._cluster_labels[nid] = labels
            if nid == self.node_id:
                # our own availability moved since the report was sent;
                # trust local state over the (already stale) echo
                self._cluster_view[nid] = (dict(self.total),
                                           dict(self.available))
            else:
                self._cluster_view[nid] = (total, avail)

    # ------------------------------------------------------------ worker death
    def _on_worker_death(self, handle: WorkerHandle, prev_state: str):
        lease = self._leases.pop(handle.worker_id, None) if handle.worker_id else None
        if lease is not None:
            self._release_lease_resources(lease)
        if prev_state == "actor" and handle.actor_id is not None:
            code = handle.proc.returncode if handle.proc else None
            # An eviction kill (bundle cancel, drain, OOM policy) is NOT an
            # intended actor death even though SIGTERM exits cleanly (code
            # 0): the restart FSM must re-place the actor. Only a
            # self-initiated clean exit counts as intended.
            intended = code == 0 and not handle.evicted
            reason = (f"actor worker evicted by raylet "
                      f"({self.drain_reason or 'bundle released'})"
                      if handle.evicted
                      else f"actor worker process died (exit code {code})")
            # the recovery DECISION: intended deaths stay dead, the rest
            # enter the GCS restart FSM (report_actor_death)
            self._elog.emit("worker.death_report",
                            actor_id=handle.actor_id.hex(),
                            node_id=self.node_id.hex(),
                            intended=intended, reason=reason)
            self._lt.submit(
                self._gcs.send_async(
                    "report_actor_death",
                    {
                        "actor_id": handle.actor_id,
                        "reason": reason,
                        "intended": intended,
                    },
                )
            )
        self._kick()
