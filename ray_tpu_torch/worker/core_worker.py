"""CoreWorker: the in-process runtime of every driver and worker.

Role of the reference's CoreWorker (ray: src/ray/core_worker/core_worker.h:292)
— task submission (core_worker.cc:2147), actor creation (:2224), actor task
submission (:2469), Get (:1542), Put (:1242), Wait (:1735), placement groups
(:2395/:2455) — plus its transports: the lease-based normal-task submitter
with per-scheduling-key worker-lease caching
(transport/direct_task_transport.h:75) and the direct actor submitter with
sequence-number ordering (transport/direct_actor_task_submitter.h:74), the
owner-side task retry FSM (task_manager.h:208) and lineage-based object
recovery (object_recovery_manager.h:41).

One CoreWorker per process; drivers and workers differ only in how they were
started and whether an Executor serves push_task.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import hashlib
import logging
import os
import pickle
import sys
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch import exceptions as exc
from ray_tpu_torch._private import backoff as _backoff
from ray_tpu_torch._private import deadlines as _deadlines
from ray_tpu_torch._private import event_log
from ray_tpu_torch._private import fault_injection as _fi
from ray_tpu_torch._private import serialization as ser
from ray_tpu_torch._private import tracing as _tracing
from ray_tpu_torch._private.config import CONFIG
from ray_tpu_torch._private.ids import (
    ActorID,
    JobID,
    NodeID,
    ObjectID,
    PlacementGroupID,
    TaskID,
    WorkerID,
)
from ray_tpu_torch._private.rpc import (
    ClientPool,
    ConnectionLost,
    EventLoopThread,
    RpcClient,
    RpcServer,
)
from ray_tpu_torch._private.specs import (
    ActorCreationSpec,
    ActorInfo,
    ActorState,
    Address,
    PlacementGroupSpec,
    SchedulingStrategySpec,
    TaskArg,
    TaskSpec,
    TaskType,
    reply_from_wire,
    reply_to_wire,
    spec_from_wire,
    spec_to_wire,
)
from ray_tpu_torch._raylet import ObjectRef, ObjectRefGenerator, global_state
from ray_tpu_torch.gcs import pubsub as ps
from ray_tpu_torch.worker.executor import Executor
from ray_tpu_torch.worker.memory_store import MemoryStore, StoreEntry, _SENTINEL
from ray_tpu_torch.worker.reference_counter import ReferenceCounter

logger = logging.getLogger(__name__)

_task_ctx = threading.local()


@dataclass
class _PendingTask:
    spec: TaskSpec
    retries_left: int
    is_actor_task: bool = False
    pushed_to: Optional[str] = None  # worker rpc address while running
    arg_ids: List[ObjectID] = field(default_factory=list)
    # Pushes that provably never reached a worker (connect refused):
    # requeued without consuming retries_left, bounded by this counter.
    undelivered_failures: int = 0
    # Latency-tracing stamps (time.monotonic, this process's clock):
    # .remote() entry / queued for a lease / push RPC written. The worker
    # returns its own durations in the reply; _on_task_reply stitches both
    # into the per-stage breakdown (_private/latency.py).
    t_submit: Optional[float] = None
    t_queued: Optional[float] = None
    t_pushed: Optional[float] = None


def _slice_segments(segments, off: int, length: int):
    """[off, off+length) across an ordered list of buffer segments without
    flattening the whole payload. A range that lands inside ONE segment
    (the common case: chunk size divides the dominant array buffer) comes
    back as a zero-copy memoryview into that segment — the RPC layer's
    out-of-band framing writes it to the socket as-is; only ranges
    straddling segment boundaries assemble into a fresh buffer."""
    pos = 0
    need_start, need_end = off, off + length
    out = None
    for seg in segments:
        m = memoryview(seg)
        seg_end = pos + m.nbytes
        if seg_end > need_start and pos < need_end:
            a = max(0, need_start - pos)
            b = min(m.nbytes, need_end - pos)
            if out is None and pos <= need_start and seg_end >= need_end:
                return m[a:b].cast("B")  # single-segment: no copy
            if out is None:
                out = bytearray()
            out += m[a:b]
        pos = seg_end
        if pos >= need_end:
            break
    return memoryview(out if out is not None else b"")


@dataclass
class _DepWait:
    """A task parked until its by-reference args materialize (reference:
    core_worker/transport/dependency_resolver.cc:83 — tasks are not
    dispatched until owned deps resolve). Without this, a worker executing
    a dependent task blocks on the arg fetch while HOLDING its CPU slot;
    enough such tasks starve the pool and deadlock the upstream producers
    (e.g. Data's shuffle reduce tasks vs map tasks at n_blocks >= n_cpus).
    """
    spec: TaskSpec
    missing: set


@dataclass
class _GeneratorState:
    total: Optional[int] = None      # known once the task completes
    reported: int = 0
    error: Optional[ser.SerializedObject] = None
    released: bool = False           # consumer closed the stream
    cv: threading.Condition = field(default_factory=threading.Condition)


@dataclass
class _Lease:
    address: Address
    busy: bool = False
    idle_since: float = 0.0


@dataclass
class _KeyState:
    # owner-side submission queue; unbounded BY DESIGN: the bound lives
    # downstream at the raylet lease queue, whose typed pushback paces
    # this queue's drain (pacer below) instead of dropping user work
    pending: deque = field(  # raylint: disable=unbounded-queue
        default_factory=deque)
    leases: Dict[str, _Lease] = field(default_factory=dict)
    inflight_lease_requests: int = 0
    # EMA of per-task wall time for this scheduling key (None = no sample
    # yet). Drives push batching: only provably-short tasks batch.
    avg_task_s: Optional[float] = None
    # AIMD resubmission pacing on typed raylet pushback (lease queue
    # full): delay doubles per retry_later, shrinks additively per grant.
    pacer: _backoff.AIMDPacer = field(default_factory=_backoff.AIMDPacer)


@dataclass
class _ActorRecord:
    actor_id: ActorID
    state: str = "PENDING"  # PENDING | ALIVE | RESTARTING | DEAD
    address: Optional[Address] = None
    seq: int = 0
    # TaskSpec waiting for an address. Bounded by `outstanding` below
    # (actor_mailbox_max, checked synchronously at submit) — the deque
    # itself can't carry the bound because submits buffer before the loop
    # drains them here.
    queue: deque = field(  # raylint: disable=unbounded-queue
        default_factory=deque)
    # Calls accepted (submit_actor_task) and not yet finalized: THE
    # mailbox bound counter, incremented on the user thread so a burst
    # can't overrun the bound while the submit buffer drains. Guarded by
    # `lock`: the increment (user thread) and decrement (loop thread,
    # _finalize_task) are read-modify-writes — unsynchronized, a lost
    # decrement would leak mailbox slots until an idle actor sheds.
    outstanding: int = 0
    lock: threading.Lock = field(default_factory=threading.Lock)
    inflight: int = 0
    death_cause: Optional[str] = None
    max_task_retries: int = 0
    incarnation: int = 0  # observed num_restarts; seq resets per incarnation
    # per-method MAX observed execution time: only provably-short methods
    # may share a batched push (see _push_actor_tasks). Max, not mean — a
    # bimodal long-poll method (usually 1ms, sometimes an hour) must never
    # re-qualify as short.
    method_time_max: Dict[str, float] = field(default_factory=dict)


class CoreWorker:
    def __init__(
        self,
        *,
        mode: str,  # "driver" | "worker"
        gcs_address: str,
        raylet_address: Optional[str],
        job_id: Optional[JobID] = None,
        namespace: str = "",
        node_id: Optional[NodeID] = None,
        host: str = "127.0.0.1",
    ):
        # RT_SPAWN_TIMING: per-phase ctor timing (burst-scale spawn
        # diagnostics; the file is appended by default_worker.py too)
        _timing = os.environ.get("RT_SPAWN_TIMING")
        _marks: List = []
        _t_prev = time.perf_counter()
        _c_prev = time.process_time()

        def _mark(name: str) -> None:
            nonlocal _t_prev, _c_prev
            if _timing:
                now, cnow = time.perf_counter(), time.process_time()
                _marks.append((name, now - _t_prev, cnow - _c_prev))
                _t_prev, _c_prev = now, cnow

        self.mode = mode
        self.namespace = namespace
        # Chaos plans normally arm at fault_injection import; zygote-forked
        # workers inherited the zygote's (possibly pre-plan) module state,
        # so re-check the env here — still free when RAY_TPU_CHAOS is unset.
        if _fi.PLAN is None:
            _fi.load_env_plan()
        self.worker_id = WorkerID.from_random()
        self.node_id = node_id
        self._elog = event_log.logger_for(mode, self.worker_id.hex()[:8])
        self._lt = EventLoopThread(f"cw-{self.worker_id.hex()[:6]}")
        self._server = RpcServer(self._lt, host, label=mode)
        self._peers = ClientPool(
            self._lt,
            peer_meta={"worker_id": self.worker_id.hex(), "label": mode},
            label=mode)
        self._gcs = RpcClient(gcs_address, self._lt, label=mode)
        self.gcs_address = gcs_address
        self._raylet = (RpcClient(raylet_address, self._lt, label=mode)
                        if raylet_address else None)
        self.raylet_address = raylet_address
        self.memory_store = MemoryStore()
        self.reference_counter = ReferenceCounter(
            free_callback=self._free_owned_object,
            notify_owner_release=self._notify_owner_release,
        )
        self.executor = Executor(self)
        self._pending_tasks: Dict[TaskID, _PendingTask] = {}
        # serializes _pending_tasks mutations across the submitting user
        # thread, the RPC loop (_finalize_task), and get()-path
        # reconstruction (user or as_future daemon threads): the
        # check-then-insert in _try_reconstruct must be atomic or two
        # concurrent readers of a lost object both re-execute its task
        self._pending_lock = threading.Lock()
        self._generators: Dict[TaskID, _GeneratorState] = {}
        self._key_states: Dict[tuple, _KeyState] = {}
        self._dep_waiters: Dict[ObjectID, List[_DepWait]] = {}
        # drained whole on every loop wakeup (_drain_submits): depth is
        # bounded by one burst between wakeups, not accumulation
        self._submit_buf: deque = deque()  # raylint: disable=unbounded-queue
        self._submit_scheduled = False
        self._submit_lock = threading.Lock()
        self._inflight_fetches: Dict[ObjectID, Any] = {}
        self._fetch_dedup_lock = threading.Lock()
        self._fetch_sem: Optional[asyncio.Semaphore] = None
        self._actors: Dict[ActorID, _ActorRecord] = {}
        self._actor_sub_started = False
        self._secondary_copies: set = set()
        self._registered_fns: set = set()
        self._fn_blobs: Dict[str, bytes] = {}  # small defs inlined in specs
        self._fn_kv_cache: Dict[bytes, bytes] = {}
        self._put_index = 0
        self._put_lock = threading.Lock()
        self._subscriptions: Dict[str, list] = {}
        self._printed_errors: set = set()  # ERROR-channel dedup (task ids)
        self._node_addr_cache: Dict[NodeID, str] = {}
        self._pg_cache: Dict[PlacementGroupID, Any] = {}
        self._task_events: deque = deque(maxlen=10_000)
        # Demand wakeups for the periodic loops (created on the loop by
        # each loop coroutine): at 1k workers/host, fixed-cadence wakeups
        # in every idle worker add up to a measurable slice of the host
        # (~400us/s/worker), so idle workers must cost ~zero.
        self._task_events_wakeup = None
        self._reaper_wakeup = None
        self._shutdown = False
        self.current_actor_id: Optional[ActorID] = None
        self.is_actor_worker = False
        # Node-local shm store provider (plasma equivalent); connected after
        # raylet registration hands us the store socket.
        self.plasma = None

        _mark("fields")
        # -- connect --
        self._register_handlers()
        self.address_str = self._server.start(0)
        # chaos partitions match on endpoint addresses (fault_injection.py)
        self._peers.set_local_id(self.address_str)
        self._gcs.local_id = self.address_str
        if self._raylet is not None:
            self._raylet.local_id = self.address_str
        _mark("server_start")
        if job_id is None:
            if mode == "driver":
                job_id = self._gcs.call("get_next_job_id", {})
            else:
                # workers inherit job context from the tasks they execute
                # (current_job_id); allocating one here cost every worker
                # spawn a blocking GCS round trip and mis-attributed
                # nested submissions to a phantom job
                job_id = JobID.nil()
        self.job_id = job_id
        self._root_task_id = TaskID.for_normal_task(job_id)
        self.address = Address(
            node_id=self.node_id, worker_id=self.worker_id, rpc_address=self.address_str
        )
        # Publish the global worker BEFORE raylet registration: the raylet may
        # lease this worker and push a task the instant registration lands.
        global_state.core_worker = self
        _mark("job_id")
        if self._raylet is not None:
            payload = {
                "worker_id": self.worker_id,
                "pid": os.getpid(),
                # container workers report an in-container pid; the pool
                # matches on the spawn token instead (worker_pool.py)
                "spawn_token": os.environ.get("RT_SPAWN_TOKEN", ""),
                "address": Address(
                    node_id=None, worker_id=self.worker_id,
                    rpc_address=self.address_str),
            }
            env_socket = os.environ.get("RT_STORE_SOCKET")
            if mode == "worker" and self.node_id is not None:
                # One-way registration: everything the reply would carry is
                # already known (node_id from argv, store socket from the
                # spawn env), so the ctor skips a raylet round trip — under
                # a spawn burst that wait was the longest raylet phase.
                # Plasma connects BEFORE the announce so a task pushed the
                # instant registration lands can never observe plasma=None
                # (with the blocking call this was a narrow race).
                self._connect_plasma(env_socket)
                _mark("plasma")

                def _register_failed(e):
                    # an unregistered worker is invisible to the raylet but
                    # its pool handle would sit 'starting' forever; dying
                    # restores the blocking-call semantics (process exits,
                    # pool reaps the pid and respawns)
                    logger.error("worker registration failed: %s", e)
                    os._exit(1)

                self._post_oneway(self._raylet, "register_worker", payload,
                                  retries=2, retry_delay_s=0.5,
                                  on_failure=_register_failed)
                _mark("register")
            else:
                method = ("register_driver" if mode == "driver"
                          else "register_worker")
                reply = self._raylet.call(method, payload)
                self.node_id = reply.get("node_id", node_id)
                self.address = Address(
                    node_id=self.node_id, worker_id=self.worker_id,
                    rpc_address=self.address_str,
                )
                _mark("register")
                self._connect_plasma(reply.get("store_socket") or env_socket)
                _mark("plasma")
        self._lease_reaper = self._lt.submit(self._lease_reaper_loop())
        # Off-loop helpers are spawned NOW, at init: creating a thread
        # from the RPC loop mid-serving (lazy executors, lazy drainers)
        # stalls the loop for tens of ms on gVisor-class kernels — a
        # pure-tail latency tax on every in-flight request.
        from ray_tpu_torch._private import latency as _latency

        _latency.start_drainer()
        # Task-event flushing lives on its own daemon thread: formatting
        # a 1s batch is thousands of dict builds at serving rates, and
        # doing it on the RPC loop stalled every in-flight reply for
        # milliseconds once per second (the r05 HTTP p99 regression).
        self._task_events_wakeup = threading.Event()
        self._event_flusher = threading.Thread(
            target=self._task_event_flush_loop,
            name=f"cw-taskev-{self.worker_id.hex()[:6]}", daemon=True)
        self._event_flusher.start()
        # Lifecycle-event flush path: batched RPC to the GCS event manager.
        # First-wins: an embedded head keeps the GCS's direct sink; pure
        # worker/driver processes ship over their existing GCS connection.
        gcs_client = self._gcs

        def _ship_events(events, stats):
            gcs_client.send("add_cluster_events",
                            {"events": events, "stats": stats})

        self._event_sink_token = event_log.set_sink(_ship_events)
        # Span flush path rides the same GCS connection (tracing.py): the
        # embedded head keeps the GCS's direct sink (first-wins).

        def _ship_spans(spans, forced, stats):
            gcs_client.send("add_spans", {"spans": spans, "forced": forced,
                                          "stats": stats})

        self._span_sink_token = _tracing.set_span_sink(_ship_spans)
        # Metric-snapshot push path (health plane): per-process registry
        # snapshots on a background cadence. First-wins, same as above —
        # serve replicas / proxy shards are worker processes, so their
        # serving histograms reach the GCS store through this.
        from ray_tpu_torch.health import push as _health_push

        def _ship_metrics(payload):
            gcs_client.send("push_metrics", payload)

        self._metrics_push_token = _health_push.set_push_sink(
            _ship_metrics, f"{mode}:{os.getpid()}")
        if mode == "worker":
            event_log.set_default_proc_label(f"worker:{os.getpid()}")
            event_log.install_flight_recorder(on_exit=True)
        else:
            if event_log.default_proc_label().startswith("proc:"):
                event_log.set_default_proc_label(f"driver:{os.getpid()}")
            event_log.install_flight_recorder(
                on_exit=CONFIG.flight_recorder_on_exit)
        # Node-death awareness: a dead raylet's TCP connections can linger
        # (especially for in-process test raylets), so lease requests to it
        # would hang. Invalidate its clients the moment the GCS declares it
        # dead, and fail the local raylet over if it was ours.
        self.subscribe(ps.NODE_CHANNEL, self._on_node_event)
        # fire-and-forget: the reply carries nothing, and a blocking wait
        # here queued every spawned worker behind the busy GCS loop.
        # retries=-1 (capped backoff, forever): without the subscription
        # this process never learns of node deaths (stale clients to a dead
        # raylet would hang instead of failing over), and a GCS outage
        # longer than any finite budget must not leave a long-lived worker
        # permanently unsubscribed — while the GCS is down there are no
        # node events to miss, so retrying until it returns loses nothing.
        self._post_oneway(self._gcs, "subscribe", {
            "channel": ps.NODE_CHANNEL,
            "subscriber_address": self.address_str}, retries=-1)
        _mark("subscribe")
        if _timing and mode == "worker":
            from ray_tpu_torch._private.spawn_diag import spawn_timing_write

            spawn_timing_write("phases " + " ".join(
                f"{n}={dt:.4f}/{cdt:.4f}" for n, dt, cdt in _marks))
        if self.mode == "driver" and CONFIG.log_to_driver:
            # worker stdout/stderr + error reports stream to the driver
            # console (reference: worker.py:2003 print_worker_logs /
            # :2115 listen_error_messages)
            self.subscribe(ps.LOG_CHANNEL, self._on_worker_logs)
            self.subscribe(ps.ERROR_CHANNEL, self._on_error_message)
            for chan in (ps.LOG_CHANNEL, ps.ERROR_CHANNEL):
                self._gcs.call("subscribe", {
                    "channel": chan,
                    "subscriber_address": self.address_str})

    def _post_oneway(self, client, method: str, payload, *,
                     retries: int = 0, retry_delay_s: float = 1.0,
                     on_failure=None) -> None:
        """Schedule a one-way message on the loop without waiting for the
        write to drain (ctor hot path: a cross-thread wait per message is
        pure overhead when no reply is coming). Transient connect failures
        retry with a delay; retries=-1 retries forever with backoff capped
        at 15s (for messages the process cannot function without). After a
        finite budget, `on_failure` runs (default: log) — fire-and-forget
        must not mean fail-silent."""

        async def _attempt():
            remaining, delay = retries, retry_delay_s
            while True:
                try:
                    await client.send_async(method, payload)
                    return
                except Exception as e:  # noqa: BLE001 — peer down
                    if remaining == 0:
                        if on_failure is not None:
                            on_failure(e)
                        else:
                            logger.warning("one-way %s to %s failed: %s",
                                           method, client.address, e)
                        return
                    remaining -= 1
                    await asyncio.sleep(delay)
                    delay = min(delay * 2, 15.0)

        self._lt.submit(_attempt())

    def _connect_plasma(self, store_socket: Optional[str]) -> None:
        if not store_socket or not CONFIG.enable_plasma_store:
            return
        try:
            from ray_tpu_torch.worker.plasma_provider import PlasmaProvider

            def _raylet_call(method, payload):
                return self._raylet.call(method, payload, timeout=60)

            self.plasma = PlasmaProvider(store_socket, _raylet_call)
            if (self.mode == "driver"
                    and os.environ.get("RT_STORE_PREFAULT") == "1"):
                # Opt-in (long-lived perf contexts): warm the driver's
                # arena mapping so the first checkpoint/weights-sized put
                # runs at memcpy speed. See StoreClient.prefault for why
                # this must not be default-on.
                self.plasma.prefault()
        except Exception as e:  # noqa: BLE001 — degrade to in-memory objects
            logger.warning("plasma store unavailable: %s", e)
            self.plasma = None

    def _plasma_threshold(self) -> int:
        return CONFIG.max_direct_call_object_size

    # ---------------------------------------------------------- runtime envs
    def prepare_runtime_env(self, env: Optional[dict]) -> Optional[dict]:
        """Runtime environments are not part of the port's runtime yet: an
        empty one passes as None, any other raises."""
        if env:
            raise NotImplementedError(
                "runtime_env is not part of ray_tpu_torch's runtime yet")
        return None

    # ------------------------------------------------------------- lifecycle
    def _register_handlers(self):
        s = self._server
        s.register("push_task", self._handle_push_task)
        s.register("push_task_w", self._handle_push_task_w)
        s.register("push_task_batch", self._handle_push_task_batch)
        s.register("fetch_object", self._handle_fetch_object)
        s.register("fetch_object_chunk", self._handle_fetch_object_chunk)
        s.register("add_object_location", self._handle_add_object_location)
        s.register("drop_object_location", self._handle_drop_object_location)
        s.register("get_object", self._handle_get_object)
        s.register("free_objects", self._handle_free_objects)
        s.register("add_borrower", self._handle_add_borrower)
        s.register("remove_borrower", self._handle_remove_borrower)
        s.register("report_generator_item", self._handle_report_generator_item)
        s.register("kill_actor", self._handle_kill_actor)
        s.register("cancel_task", self._handle_cancel_task)
        s.register("exit", self._handle_exit)
        s.register("ping", self._handle_ping)
        s.register("profile_cpu", self._handle_profile_cpu)
        s.register("profile_memory", self._handle_profile_memory)
        s.register("profile_device", self._handle_profile_device)
        s.register("memory_report", self._handle_memory_report)
        s.register("pubsub_message", self._handle_pubsub_message)
        s.register("reconstruct_object", self._handle_reconstruct_object)

    def shutdown(self, mark_job_finished: bool = True):
        if self._shutdown:
            return
        self._shutdown = True
        if self.mode == "driver" and mark_job_finished:
            try:
                self._gcs.call("mark_job_finished", {"job_id": self.job_id}, timeout=5)
            except Exception:  # noqa: BLE001 — GCS reaps the job by driver death
                logger.debug("mark_job_finished failed on shutdown",
                             exc_info=True)
        self._lease_reaper.cancel()
        if self._task_events_wakeup is not None:
            self._task_events_wakeup.set()  # unpark the flusher to exit
        # Final event flush so short-lived drivers still show their tasks in
        # the state API / timeline (the daemon flusher thread sees
        # _shutdown and exits on its own).
        try:
            self._flush_task_events_sync(deadline_s=2.0)
        except Exception:  # noqa: BLE001 — best effort on teardown
            logger.debug("final task-event flush failed", exc_info=True)
        if self._event_sink_token is not None:
            event_log.flush(timeout=0.5)
            event_log.clear_sink(self._event_sink_token)
        if getattr(self, "_span_sink_token", None) is not None:
            _tracing.flush_spans(timeout=0.5)
            _tracing.clear_span_sink(self._span_sink_token)
        if getattr(self, "_metrics_push_token", None) is not None:
            from ray_tpu_torch.health import push as _health_push
            _health_push.clear_push_sink(self._metrics_push_token)
        self.executor.shutdown()
        if self.plasma is not None:
            try:
                self.plasma.close()
            except Exception:  # noqa: BLE001 — store may already be gone
                logger.debug("plasma close failed on shutdown",
                             exc_info=True)
            self.plasma = None
        self._peers.close_all()
        self._gcs.close()
        if self._raylet is not None:
            self._raylet.close()
        self._server.stop()
        self._lt.stop()
        if global_state.core_worker is self:
            global_state.core_worker = None

    def _fire(self, coro):
        """Fire-and-forget a coroutine, swallowing connection errors."""

        async def _safe():
            try:
                await coro
            except Exception:  # noqa: BLE001 — fire-and-forget by contract
                logger.debug("fire-and-forget RPC failed", exc_info=True)

        self._lt.submit(_safe())

    # ---------------------------------------------------------- task context
    def enter_task_context(self, spec: TaskSpec):
        prev = getattr(_task_ctx, "spec", None)
        _task_ctx.spec = spec
        # process-wide fallback for threads with no task context (user
        # threads spawned inside a task): a task worker serves one job at
        # a time, so the last-entered job is the right attribution
        if (spec.job_id is not None and not spec.job_id.is_nil()
                and not self.is_actor_worker):
            self.job_id = spec.job_id
        return prev

    def exit_task_context(self, token):
        _task_ctx.spec = token

    def current_task_id(self) -> TaskID:
        spec = getattr(_task_ctx, "spec", None)
        return spec.task_id if spec is not None else self._root_task_id

    def current_job_id(self) -> JobID:
        """The job this code runs under: the executing task's job inside a
        task/actor, else the process's own (driver) job."""
        spec = getattr(_task_ctx, "spec", None)
        if spec is not None and spec.job_id is not None \
                and not spec.job_id.is_nil():
            return spec.job_id
        return self.job_id

    def current_spec(self) -> Optional[TaskSpec]:
        return getattr(_task_ctx, "spec", None)

    def _parent_deadline(self) -> Optional[float]:
        """Deadline inheritance: a child task submitted from inside a
        running task gets the parent's remaining budget (a child of
        doomed work is doomed work)."""
        spec = getattr(_task_ctx, "spec", None)
        return getattr(spec, "deadline_s", None) if spec is not None else None

    @staticmethod
    def _trace_ctx_for_submit() -> Optional[tuple]:
        """Trace-context inheritance (the tracing sibling of
        _parent_deadline): a child of the ambient context — the serve
        proxy's request scope, or the executing task's own context — or
        a head-sampled fresh root. None (the common case at default
        sample rate) costs one thread-local read."""
        ctx = _tracing.context_for_submission()
        return ctx.to_wire() if ctx is not None else None

    @staticmethod
    def _spec_trace_id(spec: TaskSpec) -> Optional[str]:
        return _tracing.trace_id_of(spec)

    def _expire_spec(self, spec: TaskSpec, layer: str = "owner",
                     record: bool = True) -> None:
        """Doomed-work elimination at an owner-side queue pop: resolve the
        task with a typed DeadlineExceededError instead of spending a
        lease/push on work whose caller already gave up. `record=False`
        when ANOTHER layer already emitted/counted the drop (the raylet's
        _expired_reply) and this call only resolves the caller's refs —
        double-recording would double every raylet-layer total."""
        if record:
            self._elog.emit("task.deadline_expired",
                            task_id=spec.task_id.hex(),
                            trace_id=self._spec_trace_id(spec),
                            layer=layer, function=spec.function_name)
            _backoff.count_deadline_expired(layer)
        _tracing.force_trace(self._spec_trace_id(spec),
                             f"task.deadline_expired:{layer}")
        self._store_error_for_task(spec, exc.DeadlineExceededError(
            f"deadline for task {spec.function_name} passed before "
            f"dispatch", layer=layer, deadline=spec.deadline_s))
        self._finalize_task(spec, "FAILED")

    # ------------------------------------------------------------------- KV
    def kv_get(self, key: bytes, namespace: Optional[str] = None) -> Optional[bytes]:
        cached = self._fn_kv_cache.get(key)
        if cached is not None:
            return cached
        value = self._gcs.call("kv_get", {"key": key, "namespace": namespace})
        if value is not None and key.startswith(b"fun:"):
            self._fn_kv_cache[key] = value
        return value

    def kv_put(self, key: bytes, value: bytes, overwrite: bool = True,
               namespace: Optional[str] = None) -> bool:
        return self._gcs.call(
            "kv_put",
            {"key": key, "value": value, "overwrite": overwrite, "namespace": namespace},
        )

    def kv_del(self, key: bytes, del_by_prefix: bool = False,
               namespace: Optional[str] = None) -> int:
        return self._gcs.call(
            "kv_del",
            {"key": key, "del_by_prefix": del_by_prefix, "namespace": namespace},
        )

    def kv_keys(self, prefix: bytes, namespace: Optional[str] = None) -> list:
        return self._gcs.call(
            "kv_keys", {"prefix": prefix, "namespace": namespace})

    def kv_exists(self, key: bytes, namespace: Optional[str] = None) -> bool:
        return self._gcs.call(
            "kv_exists", {"key": key, "namespace": namespace})

    def register_function(self, fn) -> str:
        data = ser.dumps_function(fn)
        fid = hashlib.sha1(data).hexdigest()
        if fid not in self._registered_fns:
            self.kv_put(b"fun:" + fid.encode(), data, overwrite=False)
            self._registered_fns.add(fid)
            if len(data) <= CONFIG.max_inline_function_bytes:
                self._fn_blobs[fid] = data
        return fid

    # ------------------------------------------------------------------- put
    def put(self, value: Any) -> ObjectRef:
        with self._put_lock:
            self._put_index += 1
            idx = self._put_index
        oid = ObjectID.for_put(self.current_task_id(), idx)
        s = ser.serialize(value)
        # Large payloads go to the node shm store so sibling processes read
        # them zero-copy (reference: Put > inline threshold lands in plasma,
        # core_worker.cc:1242).
        if (self.plasma is not None
                and s.total_bytes() > self._plasma_threshold()
                and self.plasma.put_serialized(oid, s, primary=True)):
            self.memory_store.put_serialized(
                oid, None, value=value, in_plasma=True,
                plasma_node=self.node_id.hex() if self.node_id else None)
        else:
            self.memory_store.put_serialized(oid, s, value=value)
        self.reference_counter.add_owned(oid, self.address)
        self.reference_counter.set_size(oid, s.total_bytes())
        for ref in s.contained_refs:
            pass  # nested refs stay alive via the stored value holding them
        return ObjectRef(oid, owner_address=self.address)

    # ------------------------------------------------------------------- get
    def get(self, refs: List[ObjectRef], timeout: Optional[float] = None) -> List[Any]:
        ids = [r.object_id() for r in refs]
        owners = [r.owner_address for r in refs]
        return self.get_objects_by_id(ids, owners, timeout)

    def get_objects_by_id(
        self, ids: List[ObjectID], owners: List[Optional[Address]],
        timeout: Optional[float] = None,
    ) -> List[Any]:
        deadline = None if timeout is None else time.monotonic() + timeout
        out: List[Any] = []
        for oid, owner in zip(ids, owners):
            out.append(self._get_one(oid, owner, deadline))
        return out

    def _remaining(self, deadline) -> Optional[float]:
        if deadline is None:
            return None
        rem = deadline - time.monotonic()
        if rem <= 0:
            raise exc.GetTimeoutError("get() timed out")
        return rem

    def _get_one(self, oid: ObjectID, owner: Optional[Address], deadline) -> Any:
        while True:
            entry = self.memory_store.get_entry(oid)
            if entry is not None:
                return self._materialize(oid, entry, deadline)
            if self.reference_counter.owns(oid) or (
                owner is not None and owner.rpc_address == self.address_str
            ):
                rem = self._remaining(deadline)
                entry = self.memory_store.wait_entry(oid, rem if rem is not None else None)
                if entry is None:
                    if deadline is not None:
                        raise exc.GetTimeoutError("get() timed out")
                    continue
                return self._materialize(oid, entry, deadline)
            if owner is None:
                raise exc.ObjectLostError(oid.hex())
            # Borrower fast path: the owner (or the executing worker) may be
            # on this node, in which case the payload is already in the node
            # shm store — read it zero-copy without owner RPC.
            if self.plasma is not None:
                s = self.plasma.get_serialized(oid, restore=False)
                if s is not None:
                    value, _ = ser.deserialize_with_refs(s)
                    self.memory_store.put_serialized(
                        oid, None, value=value, in_plasma=True)
                    return value
            # Borrower path: long-poll the owner. The owner may inline the
            # full payload in the reply (e.g. a multi-GiB array whose shm
            # write fell back to the memory store), so the TRANSPORT timeout
            # must be generous — the not-ready wait is still bounded by the
            # short server-side long-poll slice, and a dead owner surfaces
            # as ConnectionLost, not a timeout.
            rem = self._remaining(deadline)
            slice_t = 2.0 if rem is None else min(2.0, rem)
            client = self._peers.get(owner.rpc_address)
            try:
                reply = client.call(
                    "get_object",
                    {"object_id": oid, "want_value": True, "timeout": slice_t},
                    timeout=slice_t + CONFIG.rpc_call_timeout_s,
                )
            except ConnectionLost:
                raise exc.OwnerDiedError(oid.hex())
            status = reply["status"]
            if status == "ready":
                if "data" in reply:
                    value, _ = ser.deserialize_with_refs(reply["data"])
                    if reply.get("is_exception"):
                        self._raise_stored_error(value)
                    return value
                location = reply["location"]
                try:
                    data = self._fetch_from_location(
                        oid, location, owner, deadline,
                        replicas=reply.get("replicas"))
                except _RetryGet:
                    continue  # owner is reconstructing; re-resolve
                value, _ = ser.deserialize_with_refs(data)
                return value
            if status == "freed":
                raise exc.ObjectFreedError(oid.hex())
            if status == "not_owner":
                raise exc.OwnerDiedError(oid.hex())
            # pending: loop (deadline enforced via _remaining)

    def _materialize(self, oid: ObjectID, entry: StoreEntry, deadline) -> Any:
        if entry.freed:
            raise exc.ObjectFreedError(oid.hex())
        if entry.value is not _SENTINEL:
            if entry.is_exception:
                self._raise_stored_error(entry.value)
            return entry.value
        if entry.serialized is None and entry.in_plasma:
            # Same-node shm read (zero-copy; restores from disk if spilled).
            local = (self.plasma is not None and
                     (entry.plasma_node is None or self.node_id is None or
                      entry.plasma_node == self.node_id.hex()))
            if local:
                s = self.plasma.get_serialized(oid)
                if s is not None:
                    value, _ = ser.deserialize_with_refs(s)
                    self.memory_store.cache_value(oid, value)
                    if entry.is_exception:
                        self._raise_stored_error(value)
                    return value
            # Remote (or lost locally): fall through to the location fetch.
            if entry.location is None:
                raise exc.ObjectLostError(oid.hex())
        if entry.location is not None and entry.serialized is None:
            locs = self.reference_counter.get_all_locations(oid)
            data = self._fetch_from_location(
                oid, entry.location, self.address, deadline,
                replicas=[l for l in locs if l != entry.location])
            value, _ = ser.deserialize_with_refs(data)
            if entry.is_exception:
                self._raise_stored_error(value)
            return value
        value, _ = ser.deserialize_with_refs(entry.serialized)
        self.memory_store.cache_value(oid, value)
        if entry.is_exception:
            self._raise_stored_error(value)
        return value

    def _raise_stored_error(self, err: Any):
        if isinstance(err, exc.RayTaskError):
            raise err.as_instanceof_cause()
        if isinstance(err, BaseException):
            raise err
        raise exc.RaySystemError(f"corrupt error object: {err!r}")

    def _fetch_from_location(
        self, oid: ObjectID, location: str, owner: Optional[Address], deadline,
        replicas: Optional[list] = None,
    ) -> ser.SerializedObject:
        attempts = 0
        while True:
            attempts += 1
            client = self._peers.get(location)
            try:
                # max_inline flips the source to chunked mode for anything
                # larger than one chunk: the monolithic reply both buffers
                # the whole object in one message and serializes all
                # readers through the primary copy (VERDICT r2 missing #1).
                reply = client.call(
                    "fetch_object",
                    {"object_id": oid,
                     "max_inline": CONFIG.fetch_chunk_size_bytes},
                    timeout=60)
                if reply.get("status") == "ok":
                    return reply["data"]
                if reply.get("status") == "chunked":
                    sources = [location] + [
                        r for r in (replicas or [])
                        if r != location and r != self.address_str]
                    data = self._chunked_fetch(oid, reply["size"], sources,
                                               deadline, owner)
                    if data is not None:
                        return data
            except ConnectionLost:
                self._peers.invalidate(location)
            # Primary copy lost. Before lineage reconstruction, ask the
            # LOCAL raylet to restore from spill: with a remote spill
            # backend (file:// mount, s3://), the dead node may have
            # spilled this object to shared storage and registered the
            # URI cluster-wide — a storage read beats re-executing the
            # task tree (the preemptible-node recovery path).
            if self.plasma is not None:
                s = self.plasma.get_serialized(oid, restore=True)
                if s is not None:
                    return s
            # Try lineage reconstruction via the owner.
            if owner is not None and owner.rpc_address == self.address_str:
                if not self._try_reconstruct(oid):
                    raise exc.ObjectLostError(oid.hex())
                entry = self.memory_store.wait_entry(oid, 60)
                if entry is None:
                    raise exc.ObjectLostError(oid.hex())
                if entry.is_exception and (entry.value is not _SENTINEL
                                           or entry.serialized is not None):
                    # The re-execution itself failed (e.g. retries
                    # exhausted against a dying node): raise the stored
                    # error — returning its serialized form here would
                    # hand the caller an exception VALUE, unchecked
                    # because the caller's entry snapshot predates it.
                    # (Stored errors are always inline; anything else
                    # falls through to the location re-resolve below.)
                    value = (entry.value if entry.value is not _SENTINEL
                             else ser.deserialize_with_refs(entry.serialized)[0])
                    self._raise_stored_error(value)
                if entry.location is not None and entry.serialized is None:
                    location = entry.location
                    continue
                return entry.serialized
            elif owner is not None:
                try:
                    ok = self._peers.get(owner.rpc_address).call(
                        "reconstruct_object", {"object_id": oid}, timeout=60
                    )
                except ConnectionLost:
                    raise exc.OwnerDiedError(oid.hex())
                if not ok:
                    raise exc.ObjectLostError(oid.hex())
                time.sleep(CONFIG.fetch_retry_interval_ms / 1000.0)
                raise _RetryGet()  # caller loop re-resolves via owner
            if attempts > 3:
                raise exc.ObjectLostError(oid.hex())

    # ------------------------------------------------ chunked object transfer
    def _chunked_fetch(self, oid: ObjectID, size: int, sources: list,
                       deadline, owner: Optional[Address] = None
                       ) -> Optional[ser.SerializedObject]:
        """Pull a large object as pipelined chunks, striped across every
        known copy holder, landing directly in the node shm store when
        possible (reference: pull_manager.h:52 chunked pulls + admission,
        push_manager.h:30; the broadcast tree grows organically — each
        completed receiver registers itself as a source with the owner).
        Concurrent fetches of the same object in this process coalesce
        onto one transfer. Returns None when every source failed (caller
        falls back to reconstruction)."""
        import concurrent.futures as cf

        while True:
            with self._fetch_dedup_lock:
                fut = self._inflight_fetches.get(oid)
                if fut is None:
                    fut = cf.Future()
                    self._inflight_fetches[oid] = fut
                    leader = True
                else:
                    leader = False
            if leader:
                break
            try:
                return fut.result(
                    timeout=None if deadline is None
                    else max(0.1, deadline - time.monotonic()))
            except exc.GetTimeoutError:
                # the LEADER's deadline expired, not necessarily ours: a
                # follower with time left takes over as the new leader
                # instead of inheriting a timeout it never asked for.
                # (This clause must precede TimeoutError — GetTimeoutError
                # subclasses it.)
                if (deadline is not None
                        and time.monotonic() >= deadline):
                    raise
            except TimeoutError:
                raise exc.GetTimeoutError("get() timed out")
        try:
            result = self._lt.run_coro(
                self._chunked_fetch_async(oid, size, sources, deadline,
                                          owner))
            fut.set_result(result)
            return result
        except BaseException as e:
            fut.set_exception(e)
            raise
        finally:
            with self._fetch_dedup_lock:
                self._inflight_fetches.pop(oid, None)

    async def _chunked_fetch_async(self, oid: ObjectID, size: int,
                                   sources: list, deadline,
                                   owner: Optional[Address] = None
                                   ) -> Optional[ser.SerializedObject]:
        chunk = CONFIG.fetch_chunk_size_bytes
        n_chunks = max(1, -(-size // chunk))
        view = None
        if self.plasma is not None:
            view = await asyncio.to_thread(
                self.plasma.create_for_receive, oid, size)
        buf = bytearray(size) if view is None else None
        if self._fetch_sem is None:
            # admission control: bound total in-flight fetch bytes across
            # ALL concurrent fetches in this process (chunk-granular)
            self._fetch_sem = asyncio.Semaphore(
                max(1, CONFIG.fetch_max_inflight_bytes // chunk))
        done = [False] * n_chunks
        dead_sources: set = set()

        async def pull_from(src: str, pending: deque):
            client = self._peers.get(src)
            while pending:
                if deadline is not None and time.monotonic() > deadline:
                    return
                i = pending.popleft()
                off = i * chunk
                ln = min(chunk, size - off)
                await self._fetch_sem.acquire()
                try:
                    r = await client.call_async(
                        "fetch_object_chunk",
                        {"object_id": oid, "off": off, "len": ln},
                        timeout=60)
                    if r.get("status") != "ok":
                        raise ConnectionLost("chunk unavailable")
                    data = r["data"]
                    if view is not None:
                        view[off:off + ln] = data
                    else:
                        buf[off:off + ln] = data
                    done[i] = True
                except (ConnectionLost, OSError, asyncio.TimeoutError):
                    # hand the chunk back; this source is out for THIS
                    # fetch, and a stale replica gets dropped at the owner
                    # so later fetchers don't re-try a dead address
                    pending.append(i)
                    dead_sources.add(src)
                    if src != sources[0]:
                        self._drop_replica_at_owner(oid, src, owner)
                    return
                finally:
                    self._fetch_sem.release()

        # Rounds: one slow/dead replica must NOT fail the fetch while a
        # healthy source (usually the primary) still holds the object —
        # re-spread the handed-back chunks over the surviving sources.
        # The last round re-admits the primary even after a transient
        # timeout marked it dead: reconstruction is the WRONG response to
        # a slow-but-alive primary.
        for rnd in range(3):
            # bounded by the object's own chunk count
            remaining = deque(  # raylint: disable=unbounded-queue
                i for i in range(n_chunks) if not done[i])
            if not remaining:
                break
            if deadline is not None and time.monotonic() > deadline:
                break
            live = [s for s in sources if s not in dead_sources]
            if not live:
                if rnd == 2 or not sources:
                    break
                dead_sources.discard(sources[0])
                live = [sources[0]]
            await asyncio.gather(*(
                asyncio.ensure_future(pull_from(src, remaining))
                for src in live
                for _ in range(max(1, CONFIG.fetch_pipeline_depth))))
        if not all(done):
            if view is not None:
                del view
                await asyncio.to_thread(self.plasma.abort_receive, oid)
            if deadline is not None and time.monotonic() > deadline:
                # the caller asked for a bounded get(): report the timeout,
                # never fall through to reconstruction of a healthy object
                raise exc.GetTimeoutError("get() timed out")
            return None
        if view is not None:
            del view  # drop the writable mapping before sealing
            await asyncio.to_thread(self.plasma.seal_received, oid)
            s = await asyncio.to_thread(
                self.plasma.get_serialized, oid, False)
            if s is None:  # sealed copy already evicted (store thrashing)
                return None
            # future local gets (this worker AND same-node siblings via the
            # plasma fast path) now read shm instead of re-fetching
            self.memory_store.put_serialized(
                oid, None, in_plasma=True,
                plasma_node=self.node_id.hex() if self.node_id else None)
            self._register_as_copy_holder(oid, owner)
        else:
            # heap fallback (no shm store): decode over the assembly buffer
            # directly — bytes(buf) would re-copy the whole object
            s = ser.SerializedObject.from_bytes(memoryview(buf))
        return s

    def _drop_replica_at_owner(self, oid: ObjectID, replica: str,
                               owner: Optional[Address]):
        """A replica failed to serve chunks: have the owner forget it so
        later fetchers stop striping to a dead/evicted copy."""
        try:
            if owner is None or owner.rpc_address == self.address_str:
                self.reference_counter.drop_location(oid, replica)
            else:
                self._lt.submit(
                    self._peers.get(owner.rpc_address).send_async(
                        "drop_object_location",
                        {"object_id": oid, "location": replica}))
        except Exception:  # noqa: BLE001 — healing is best-effort
            logger.debug("replica-healing notification failed",
                         exc_info=True)

    def _register_as_copy_holder(self, oid: ObjectID,
                                 owner: Optional[Address] = None):
        """Tell the owner we hold a durable full copy: later fetchers then
        stripe chunks across us too (pipelined broadcast fan-out)."""
        owner_addr = owner or self.reference_counter.get_owner_address(oid)
        if owner_addr is None or owner_addr.rpc_address == self.address_str:
            self.reference_counter.add_location(oid, self.address_str)
            return
        try:
            self._lt.submit(self._peers.get(owner_addr.rpc_address).send_async(
                "add_object_location",
                {"object_id": oid, "location": self.address_str}))
        except Exception:  # noqa: BLE001 — registration is an optimization
            logger.debug("copy-holder registration failed", exc_info=True)

    def _try_reconstruct(self, oid: ObjectID) -> bool:
        """Owner-side lineage reconstruction (object_recovery_manager.h:41)."""
        if not CONFIG.enable_lineage_reconstruction:
            return False
        spec = self.reference_counter.get_lineage(oid)
        if spec is None:
            return False
        tid = spec.task_id
        with self._pending_lock:
            # atomic check-then-insert: concurrent get()s of a lost
            # object (user thread + as_future resolver threads) race to
            # reconstruct; exactly one may insert and re-execute
            if tid in self._pending_tasks:
                return True  # already re-executing
            spec.attempt_number += 1
            self._pending_tasks[tid] = _PendingTask(
                spec=spec, retries_left=0,
                arg_ids=[a.object_id for a in spec.args if not a.is_inline]
            )
        logger.info("reconstructing %s by re-executing %s", oid.hex()[:12], spec.function_name)
        self._elog.emit("object.reconstruct", object_id=oid.hex(),
                        task_id=tid.hex(), function=spec.function_name)
        self.memory_store.delete([o for o in spec.return_ids()])
        self._normal_submit(spec)
        return True

    # ------------------------------------------------------------------ wait
    def wait(
        self,
        refs: List[ObjectRef],
        num_returns: int = 1,
        timeout: Optional[float] = None,
        fetch_local: bool = True,
    ) -> Tuple[List[ObjectRef], List[ObjectRef]]:
        deadline = None if timeout is None else time.monotonic() + timeout
        pending = list(refs)
        ready: List[ObjectRef] = []
        while True:
            still = []
            for ref in pending:
                if self._is_ready(ref):
                    ready.append(ref)
                else:
                    still.append(ref)
            pending = still
            if len(ready) >= num_returns or not pending:
                break
            if deadline is not None and time.monotonic() >= deadline:
                break
            time.sleep(0.005)
        return ready[:num_returns], ready[num_returns:] + pending

    def _is_ready(self, ref: ObjectRef) -> bool:
        oid = ref.object_id()
        if self.memory_store.contains(oid):
            return True
        if self.reference_counter.owns(oid):
            return False
        owner = ref.owner_address
        if owner is None or owner.rpc_address == self.address_str:
            return False
        try:
            reply = self._peers.get(owner.rpc_address).call(
                "get_object",
                {"object_id": oid, "want_value": False, "timeout": 0},
                timeout=10,
            )
        except ConnectionLost:
            raise exc.OwnerDiedError(oid.hex())
        return reply["status"] in ("ready", "freed")

    # ----------------------------------------------------------- submit task
    def _build_args(self, args, kwargs) -> Tuple[List[TaskArg], Dict[str, TaskArg], List[ObjectID]]:
        arg_ids: List[ObjectID] = []

        def build(value) -> TaskArg:
            if isinstance(value, ObjectRef):
                arg_ids.append(value.object_id())
                self.reference_counter.add_submitted_task_ref(value.object_id())
                return TaskArg(
                    is_inline=False,
                    object_id=value.object_id(),
                    owner_address=value.owner_address or self.address,
                )
            s = ser.serialize(value)
            if s.total_bytes() > CONFIG.max_direct_call_object_size:
                ref = self.put(value)
                arg_ids.append(ref.object_id())
                self.reference_counter.add_submitted_task_ref(ref.object_id())
                return TaskArg(
                    is_inline=False, object_id=ref.object_id(), owner_address=self.address
                )
            nested = [r.object_id() for r in s.contained_refs]
            for r in s.contained_refs:
                arg_ids.append(r.object_id())
                self.reference_counter.add_submitted_task_ref(r.object_id())
            return TaskArg(is_inline=True, data=s, nested_ids=nested)

        return (
            [build(a) for a in args],
            {k: build(v) for k, v in (kwargs or {}).items()},
            arg_ids,
        )

    def submit_task(
        self,
        fn,
        args: tuple,
        kwargs: dict,
        *,
        num_returns=1,
        resources=None,
        max_retries: int = 3,
        retry_exceptions: bool = False,
        scheduling_strategy: Optional[SchedulingStrategySpec] = None,
        name: str = "",
        function_id: Optional[str] = None,
        runtime_env: Optional[dict] = None,
        runtime_env_prepared: bool = False,
        max_calls: int = 0,
        deadline_s: Optional[float] = None,
    ):
        t_submit = time.monotonic()
        fid = function_id or self.register_function(fn)
        if not runtime_env_prepared:
            runtime_env = self.prepare_runtime_env(runtime_env)
        job_id = self.current_job_id()
        task_id = TaskID.for_normal_task(job_id)
        streaming = num_returns == "streaming" or num_returns == -1
        arg_specs, kwarg_specs, arg_ids = self._build_args(args, kwargs)
        spec = TaskSpec(
            task_id=task_id,
            job_id=job_id,
            task_type=TaskType.NORMAL_TASK,
            function_id=fid,
            function_name=name or getattr(fn, "__name__", "task"),
            args=arg_specs,
            num_returns=-1 if streaming else num_returns,
            resources=resources or {"CPU": CONFIG.default_task_num_cpus},
            owner_address=self.address,
            trace_parent=self.current_task_id().hex(),
            trace_ctx=self._trace_ctx_for_submit(),
            max_retries=max_retries,
            retry_exceptions=retry_exceptions,
            max_calls=max_calls,
            scheduling_strategy=scheduling_strategy or SchedulingStrategySpec(),
            runtime_env=runtime_env,
            deadline_s=_deadlines.effective_deadline(
                deadline_s, self._parent_deadline()),
        )
        spec.kwarg_specs = kwarg_specs
        with self._pending_lock:
            self._pending_tasks[task_id] = _PendingTask(
                spec=spec, retries_left=max_retries, arg_ids=arg_ids,
                t_submit=t_submit,
            )
        lineage = spec if CONFIG.enable_lineage_reconstruction else None
        self._record_task_event(spec, "PENDING")
        if streaming:
            # Item oids are registered as owned when each item is reported
            # (_handle_report_generator_item). Creating return refs here
            # would alias item 0's oid and free it from a discarded ref on a
            # GC-dependent schedule.
            self._generators[task_id] = _GeneratorState()
            self._normal_submit(spec)
            return ObjectRefGenerator(task_id)
        return_refs = []
        for oid in spec.return_ids():
            self.reference_counter.add_owned(oid, self.address, lineage_task=lineage)
            return_refs.append(ObjectRef(oid, owner_address=self.address))
        self._normal_submit(spec)
        return return_refs

    def _normal_submit(self, spec: TaskSpec):
        self._enqueue_submit(False, spec)

    def _enqueue_submit(self, is_actor: bool, spec: TaskSpec):
        """Coalesced cross-thread submission: burst submissions from the
        user thread fold into ONE loop wakeup + one drain pass (a
        run_coroutine_threadsafe per task costs a self-pipe write, a Task
        object, and a _pump each — the dominant submit-side overhead at
        >5k tasks/s)."""
        with self._submit_lock:
            self._submit_buf.append((is_actor, spec))
            if self._submit_scheduled:
                return
            self._submit_scheduled = True
        self._lt.loop.call_soon_threadsafe(self._drain_submits)

    def _drain_submits(self):
        with self._submit_lock:
            items = list(self._submit_buf)
            self._submit_buf.clear()
            self._submit_scheduled = False
        task_keys = set()
        actor_groups: Dict[ActorID, List[TaskSpec]] = {}
        now = time.monotonic()
        for is_actor, spec in items:
            if is_actor:
                pending = self._pending_tasks.get(spec.task_id)
                if pending is not None:
                    pending.t_queued = now
                actor_groups.setdefault(spec.actor_id, []).append(spec)
            else:
                key = self._route_or_park(spec)
                if key is not None:
                    task_keys.add(key)
        for key in task_keys:
            asyncio.ensure_future(self._pump(key))
        for actor_id, specs in actor_groups.items():
            asyncio.ensure_future(self._actor_submit_batch(actor_id, specs))

    def _route_or_park(self, spec: TaskSpec):
        """Dependency resolution: dispatching a task whose owned args are
        still pending would make the worker long-poll us for them while
        holding its CPU — park until every owned by-ref arg has an entry
        (value, error, or plasma location). Borrowed args (owner
        elsewhere) dispatch immediately: their readiness is unobservable
        locally and the producing side is another owner's pool.
        Returns the scheduling key when queued, None when parked."""
        missing = {
            a.object_id
            for a in (list(spec.args)
                      + list(getattr(spec, "kwarg_specs", {}).values()))
            if not a.is_inline
            and self.reference_counter.owns(a.object_id)
            and not self.memory_store.contains(a.object_id)
        }
        if missing:
            wait = _DepWait(spec=spec, missing=missing)
            for oid in missing:
                self._dep_waiters.setdefault(oid, []).append(wait)
            return None
        pending = self._pending_tasks.get(spec.task_id)
        if pending is not None:
            # dependency-wait time lands in the 'submit' stage by design
            pending.t_queued = time.monotonic()
        key = spec.scheduling_key()
        st = self._key_states.setdefault(key, _KeyState())
        st.pending.append(spec)
        return key

    async def _enqueue_ready(self, spec: TaskSpec):
        pending = self._pending_tasks.get(spec.task_id)
        if pending is not None:
            pending.t_queued = time.monotonic()
        key = spec.scheduling_key()
        st = self._key_states.setdefault(key, _KeyState())
        st.pending.append(spec)
        await self._pump(key)

    def _release_deps(self, oid: ObjectID):
        """An owned object materialized: unpark tasks that waited on it."""
        waiters = self._dep_waiters.pop(oid, None)
        if not waiters:
            return
        for w in waiters:
            w.missing.discard(oid)
            if not w.missing:
                self._lt.submit(self._enqueue_ready(w.spec))

    def _cancel_parked(self, task_id) -> bool:
        """Remove a dep-parked spec (cancel path). True if it was parked."""
        found = False
        for oid, waiters in list(self._dep_waiters.items()):
            kept = [w for w in waiters if w.spec.task_id != task_id]
            if len(kept) != len(waiters):
                found = True
                if kept:
                    self._dep_waiters[oid] = kept
                else:
                    del self._dep_waiters[oid]
        return found

    async def _pump(self, key):
        st = self._key_states.get(key)
        if st is None:
            return
        # Assign pending specs to idle leases — BATCHED: one push RPC can
        # carry many specs (the worker executes them serially), amortizing
        # the per-RPC round trip that otherwise caps async submission at
        # ~1/RTT per lease (VERDICT r1: async was SLOWER than sync).
        # Batching trades parallelism for overhead, so it is LATENCY-GATED:
        # only keys whose observed task time (EMA from completed pushes) is
        # under the threshold batch at all — batching long tasks onto one
        # worker would serialize them AND free their CPUs for work that
        # should have queued behind them. Unmeasured keys ship 1:1.
        idle = [lease for lease in st.leases.values() if not lease.busy]
        short = (st.avg_task_s is not None
                 and st.avg_task_s * 1e3 < CONFIG.task_batch_latency_ms)
        cap_batch = CONFIG.max_tasks_per_push if short else 1
        for i, lease in enumerate(idle):
            if not st.pending:
                break
            fair = -(-len(st.pending) // (len(idle) - i))  # ceil split
            n = min(cap_batch, fair, len(st.pending))
            # A spec with by-REFERENCE args never joins a batch: its args
            # may be returns of tasks earlier in the same batch, whose
            # values reach this owner only in the batch's single reply —
            # the executing worker would long-poll us for them and
            # deadlock the batch (chained `f.remote(f.remote(...))`).
            specs = []
            while len(specs) < n and st.pending:
                spec = st.pending[0]
                if _deadlines.expired(spec.deadline_s):
                    # queue-pop doomed-work elimination: the caller's
                    # budget ran out while this spec queued — resolve it
                    # typed instead of spending the lease on it
                    st.pending.popleft()
                    self._expire_spec(spec)
                    continue
                if not self._batchable(spec):
                    if not specs:
                        specs.append(st.pending.popleft())  # ship alone
                    break
                specs.append(st.pending.popleft())
            if not specs:
                continue
            lease.busy = True
            asyncio.ensure_future(self._push(key, lease, specs))
        # Request more leases if there is unassigned work.
        want = len(st.pending)
        cap = CONFIG.max_pending_lease_requests_per_scheduling_key
        while st.inflight_lease_requests < min(want, cap):
            st.inflight_lease_requests += 1
            spec = st.pending[0]
            asyncio.ensure_future(self._request_lease(key, spec))
            want -= 1

    async def _resolve_route(self, spec: TaskSpec) -> Optional[str]:
        strat = spec.scheduling_strategy
        if strat.kind == "PLACEMENT_GROUP":
            info = await self._get_pg_info(strat.placement_group_id)
            if info is None:
                return None
            locations = info.bundle_locations
            if strat.bundle_index >= 0:
                node = locations.get(strat.bundle_index)
            else:
                nodes = list(locations.values())
                node = nodes[spec.task_id.binary()[0] % len(nodes)] if nodes else None
            if node is None:
                return None
            return await self._node_raylet_addr(node)
        if strat.kind == "NODE_AFFINITY" and strat.node_id is not None:
            addr = await self._node_raylet_addr(strat.node_id)
            if addr is not None:
                return addr
            if not strat.soft:
                return None
        return self.raylet_address

    async def _get_pg_info(self, pg_id: PlacementGroupID):
        info = self._pg_cache.get(pg_id)
        if info is not None and len(info.bundle_locations) == len(info.spec.bundles):
            return info
        reply = await self._gcs.call_async(
            "wait_placement_group_ready",
            {"placement_group_id": pg_id, "timeout": 60},
        )
        if reply.get("status") != "ready":
            return None
        info = reply["info"]
        # raylint: disable=cross-domain-mutation — GIL-atomic dict ops on
        # a read-through cache: remove_placement_group's pop vs this
        # insert worst-cases a stale entry, which the bundle_locations
        # completeness check above re-validates on every hit
        self._pg_cache[pg_id] = info
        return info

    async def _node_raylet_addr(self, node_id: NodeID) -> Optional[str]:
        addr = self._node_addr_cache.get(node_id)
        if addr is not None:
            return addr
        nodes = await self._gcs.call_async("get_all_node_info", {})
        for n in nodes:
            if n.alive:
                self._node_addr_cache[n.node_id] = n.raylet_address
        return self._node_addr_cache.get(node_id)

    async def _request_lease(self, key, sample_spec: TaskSpec):
        st = self._key_states[key]
        try:
            await self._request_lease_inner(key, sample_spec, st)
        except ConnectionLost:
            if not self._shutdown:
                self._fail_queued(key, exc.RaySystemError(
                    "lost connection to the local raylet"))
        finally:
            st.inflight_lease_requests -= 1

    async def _request_lease_inner(self, key, sample_spec: TaskSpec, st):
        target = await self._resolve_route(sample_spec)
        spillback = 0
        warned = 0.0
        refused = blips = rejects = 0
        # retry delays come from the shared policy module: the
        # constants match the old hand-rolled sleeps at attempt 1 and grow
        # from there instead of hammering a struggling raylet at a fixed
        # cadence.
        refused_policy = _backoff.BackoffPolicy(
            base_s=0.2, multiplier=1.5, max_s=2.0, jitter=0.2)
        blip_policy = _backoff.BackoffPolicy(
            base_s=0.1, multiplier=2.0, max_s=0.5)
        reject_policy = _backoff.BackoffPolicy(
            base_s=0.2, multiplier=1.2, max_s=1.0, jitter=0.1)
        while not self._shutdown:
            while st.pending and _deadlines.expired(
                    st.pending[0].deadline_s):
                # queue-pop doomed-work elimination on the lease path: no
                # point re-asking for work whose caller already gave up
                self._expire_spec(st.pending.popleft())
            if not st.pending:
                return
            if target is None:
                self._fail_queued(key, exc.RaySystemError(
                    f"no feasible node for task {sample_spec.function_name} "
                    f"(strategy={sample_spec.scheduling_strategy.kind})"))
                return
            client = self._peers.get(target)
            try:
                reply = await client.call_async(
                    "request_worker_lease",
                    {"spec": st.pending[0] if st.pending else sample_spec,
                     "spillback_count": spillback},
                    timeout=None,
                )
                refused = blips = 0
            except ConnectionLost as e:
                # Same-target retries apply only to the LOCAL raylet,
                # where the alternative below is failing every queued
                # task; a dead REMOTE target already has a free, instant
                # fallback (re-route through the local raylet). The two
                # budgets are SEPARATE counters: refused retries during a
                # raylet restart must not consume the reset-blip budget
                # needed the moment it comes back up.
                if target == self.raylet_address:
                    if not e.maybe_delivered and refused < 25:
                        # The request provably never reached the raylet
                        # (connect refused — e.g. it is restarting, or a
                        # transient partition healed): retry after a beat
                        # instead of escalating straight to "local raylet
                        # lost". Bounded: a persistently refusing raylet
                        # still escalates below after ~5s.
                        refused += 1
                        self._peers.invalidate(target)
                        await asyncio.sleep(refused_policy.delay(refused))
                        continue
                    if e.maybe_delivered and blips < 3:
                        # Connection reset with the request possibly in
                        # flight. Leases are safe to re-ask (an orphaned
                        # grant is reclaimed by the worker idle timeout),
                        # and a reset on a healthy raylet (GCS restart
                        # ripples, chaos disconnect) must not fail every
                        # queued task; a DEAD raylet turns into connect-
                        # refused on the retry and escalates above.
                        blips += 1
                        self._peers.invalidate(target)
                        await asyncio.sleep(blip_policy.delay(blips))
                        continue
                if target == self.raylet_address:
                    new_local = await self._refresh_local_raylet()
                    if new_local is None or new_local == target:
                        raise
                    target = new_local
                else:
                    target = self.raylet_address
                spillback = 0
                continue
            if "retry_at" in reply:
                target = reply["retry_at"]
                spillback = 1
                continue
            if reply.get("deadline_expired"):
                # the raylet dropped the spec at ITS queue pop: resolve the
                # matching queued spec typed (it may no longer be the head)
                expired_hex = reply.get("task_id")
                for spec in list(st.pending):
                    if spec.task_id.hex() == expired_hex:
                        st.pending.remove(spec)
                        # the raylet already emitted + counted this drop
                        self._expire_spec(spec, layer="raylet",
                                          record=False)
                        break
                continue
            if reply.get("retry_later"):
                # typed pushback from the bounded raylet lease queue: pace
                # resubmission (AIMD — delay doubles per pushback, shrinks
                # per grant) instead of hammering a full queue at a fixed
                # cadence. The task stays queued owner-side; its deadline
                # (checked at the top of this loop) bounds total waiting.
                delay = st.pacer.on_pushback(reply.get("retry_after_s"))
                now = time.monotonic()
                if now - warned > 10:
                    warned = now
                    logger.warning(
                        "lease queue pushback for %s (retry in %.2fs): %s",
                        sample_spec.function_name, delay,
                        reply.get("reason"))
                await asyncio.sleep(delay)
                target = await self._resolve_route(sample_spec)
                spillback = 0
                continue
            if reply.get("rejected"):
                rejects += 1
                now = time.monotonic()
                if now - warned > 10:
                    warned = now
                    logger.warning(
                        "lease request for %s rejected: %s (retrying)",
                        sample_spec.function_name, reply.get("reason"),
                    )
                await asyncio.sleep(reject_policy.delay(rejects))
                target = await self._resolve_route(sample_spec)
                spillback = 0
                continue
            rejects = 0
            st.pacer.on_success()
            addr: Address = reply["worker_address"]
            st.leases[addr.rpc_address] = _Lease(address=addr, busy=False,
                                                idle_since=time.monotonic())
            self._poke_reaper()
            await self._pump(key)
            return

    def _fail_queued(self, key, error: Exception):
        st = self._key_states.get(key)
        if st is None:
            return
        while st.pending:
            spec = st.pending.popleft()
            self._store_error_for_task(spec, error)

    @staticmethod
    def _batchable(spec: TaskSpec) -> bool:
        """Inline-args-only specs may share a batched push (see _pump)."""
        if not all(a.is_inline for a in spec.args):
            return False
        kwargs = getattr(spec, "kwarg_specs", None) or {}
        return all(a.is_inline for a in kwargs.values())

    async def _push(self, key, lease: _Lease, specs: List[TaskSpec]):
        st = self._key_states[key]
        now = time.monotonic()
        for spec in specs:
            pending = self._pending_tasks.get(spec.task_id)
            if pending is not None:
                pending.pushed_to = lease.address.rpc_address
                pending.t_pushed = now
            self._record_task_event(spec, "RUNNING")
        client = self._peers.get(lease.address.rpc_address)
        push_started = time.monotonic()
        try:
            # wire codec (spec_to_wire): ~3us per spec to encode vs ~35us
            # to pickle the dataclass graph — the push frame is THE
            # per-task hot message (SURVEY §3.2 ≲100us/task bar)
            wire = await client.call_async(
                "push_task_w", [spec_to_wire(s) for s in specs],
                timeout=None)
            replies = [reply_from_wire(t) for t in wire]
        except ConnectionLost as e:
            st.leases.pop(lease.address.rpc_address, None)
            self._peers.invalidate(lease.address.rpc_address)
            if not e.maybe_delivered:
                # The push never reached the worker (connect refused —
                # cached lease to an already-dead process, e.g.
                # reconstruction right after a node death): nothing
                # executed, so requeue for a fresh lease WITHOUT
                # consuming at-most-once retry budget. Bounded: a target
                # that refuses connections persistently must still
                # terminate via the normal failure path, not spin.
                for spec in reversed(specs):
                    pending = self._pending_tasks.get(spec.task_id)
                    if pending is None:
                        continue
                    pending.undelivered_failures += 1
                    if pending.undelivered_failures > 20:
                        self._on_worker_failure(spec)
                        continue
                    pending.pushed_to = None
                    st.pending.appendleft(spec)
            else:
                for spec in specs:
                    self._on_worker_failure(spec)
            await self._pump(key)
            return
        # Per-task latency EMA for the batching gate. Prefer the WORKER's
        # own execution timings (exec_s in each reply): an RTT-inclusive
        # sample would keep remote owners above the threshold forever —
        # exactly the regime batching exists to amortize. Fall back to
        # round-trip/batch when no timing came back.
        exec_samples = [r["exec_s"] for r in replies if "exec_s" in r]
        if exec_samples:
            sample = sum(exec_samples) / len(exec_samples)
        else:
            ran = max(1, sum(1 for r in replies if not r.get("not_run")))
            sample = (time.monotonic() - push_started) / ran
        st.avg_task_s = (sample if st.avg_task_s is None
                         else 0.7 * st.avg_task_s + 0.3 * sample)
        retiring = False
        requeue: List[TaskSpec] = []
        for spec, reply in zip(specs, replies):
            if reply.get("not_run"):
                # worker retired mid-batch before reaching this spec: it
                # never executed — put it back at the FRONT of the queue
                requeue.append(spec)
                continue
            self._on_task_reply(spec, reply)
            retiring = retiring or bool(reply.get("worker_retiring"))
        for spec in reversed(requeue):
            pending = self._pending_tasks.get(spec.task_id)
            if pending is not None:
                pending.pushed_to = None
            st.pending.appendleft(spec)
        if retiring:
            # max_calls recycling: the worker exits right after this reply —
            # never reuse the lease, and don't hand it back as "idle"
            st.leases.pop(lease.address.rpc_address, None)
            self._peers.invalidate(lease.address.rpc_address)
            if st.pending:
                await self._pump(key)
            return
        lease.busy = False
        lease.idle_since = time.monotonic()
        if st.pending:
            await self._pump(key)

    def _poke_reaper(self) -> None:
        """Wake the lease reaper (new lease / queued actor call). Safe from
        any thread; no-op before the loop starts."""
        ev = self._reaper_wakeup
        if ev is not None and not ev.is_set():
            self._lt.loop.call_soon_threadsafe(ev.set)

    async def _lease_reaper_loop(self):
        timeout = CONFIG.worker_lease_idle_timeout_ms / 1000.0
        self._reaper_wakeup = ev = asyncio.Event()
        last_actor_sweep = 0.0
        while True:
            if (not any(st.leases for st in self._key_states.values())
                    and not any(
                        rec.queue and rec.state != "DEAD"
                        for rec in self._actors.values())):
                # Nothing to reap or sweep: park until a lease is taken or
                # an actor call queues behind a non-ALIVE actor.
                await ev.wait()
            ev.clear()
            await asyncio.sleep(timeout / 2)
            now = time.monotonic()
            for key, st in list(self._key_states.items()):
                for addr, lease in list(st.leases.items()):
                    if not lease.busy and now - lease.idle_since > timeout:
                        st.leases.pop(addr, None)
                        asyncio.ensure_future(self._return_lease(lease))
            if now - last_actor_sweep > 5.0:
                last_actor_sweep = now
                await self._sweep_stalled_actor_queues()

    async def _sweep_stalled_actor_queues(self):
        """Lost-pubsub backstop: an actor record stuck PENDING/RESTARTING
        with queued calls re-polls the GCS. Without this, one dropped
        ALIVE/DEAD event (subscription raced the publish) hangs every
        caller of the queued tasks forever."""
        for rec in list(self._actors.values()):
            if not rec.queue or rec.state == "DEAD":
                continue
            if rec.state == "ALIVE":
                # ALIVE with parked specs: a flush was lost to the
                # first-contact thread race — push them now.
                await self._flush_actor_queue(rec)
                continue
            try:
                info = await self._gcs.call_async(
                    "get_actor_info", {"actor_id": rec.actor_id})
            except Exception:  # noqa: BLE001 — GCS restarting; the next
                # reconcile tick retries this actor record
                logger.debug("get_actor_info failed during reconcile",
                             exc_info=True)
                continue
            self._apply_actor_info(rec, info)

    async def _return_lease(self, lease: _Lease):
        node = lease.address.node_id
        raylet_addr = self.raylet_address
        if node is not None and node != self.node_id:
            raylet_addr = await self._node_raylet_addr(node) or raylet_addr
        if raylet_addr is None:
            return
        try:
            await self._peers.get(raylet_addr).send_async(
                "return_worker", {"worker_address": lease.address}
            )
        except ConnectionLost:
            pass

    # ------------------------------------------------- task completion paths
    def _register_reply_borrows(self, reply: dict) -> None:
        """Arg-borrow retention, owner side: the executing worker's reply
        names the nested arg refs it kept (executor._attach_retained_
        borrows). Register it as borrower NOW — before _finalize_task
        releases the submitted-task pins — because its own eager
        add_borrower rides a separate (possibly first-contact) peer
        connection and can lose the race against this owner's frame-exit
        free. Double-adds are harmless (borrowers is a set); a borrow
        retained here and dropped later is released by the worker's
        normal remove_borrower / death sweep."""
        borrower = reply.get("borrower_address")
        if not borrower:
            return
        for oid in reply.get("retained_borrows") or ():
            if self.reference_counter.owns(oid):
                self.reference_counter.add_borrower(oid, borrower)

    def _on_task_reply(self, spec: TaskSpec, reply: dict):
        t_reply = time.monotonic()
        pending = self._pending_tasks.get(spec.task_id)
        if pending is None or pending.spec.attempt_number != spec.attempt_number:
            return
        self._register_reply_borrows(reply)
        status = reply.get("status")
        if status == "ok":
            for oid, payload in reply.get("returns", []):
                self._store_return(oid, payload)
            if spec.is_streaming_generator():
                self._finish_generator(spec.task_id, reply.get("streaming_num_items", 0))
            stages = self._task_breakdown(spec, pending, reply, t_reply)
            self._finalize_task(spec, "FINISHED", stages)
        elif status == "cancelled":
            err = exc.TaskCancelledError(spec.task_id)
            self._store_error_for_task(spec, err)
            if spec.is_streaming_generator():
                # wake any consumer still parked in next_generator_item —
                # the error entry alone never signals the stream's cv
                self._finish_generator(spec.task_id, 0,
                                       error=ser.serialize(err))
            self._finalize_task(spec, "CANCELLED")
        else:  # application error
            error_obj = None
            if spec.retry_exceptions and pending.retries_left > 0:
                # A worker-side deadline drop rides the error reply shape,
                # but DeadlineExceededError is "never retried: a deadline
                # is a promise to the caller" (exceptions.py) — and the
                # requeued spec would keep its already-expired absolute
                # deadline, so every retry is a guaranteed futile
                # lease+push round trip (the exact doomed-work
                # amplification the deadlines eliminate at the other layers).
                error_obj, _ = ser.deserialize_with_refs(reply["error"])
                if not isinstance(error_obj, exc.DeadlineExceededError):
                    pending.retries_left -= 1
                    self._resubmit(spec, reason="application error")
                    return
            if error_obj is None:
                error_obj, _ = ser.deserialize_with_refs(reply["error"])
            self._store_error_for_task(spec, error_obj)
            if spec.is_streaming_generator():
                self._finish_generator(spec.task_id, 0, error=reply["error"])
            stages = self._task_breakdown(spec, pending, reply, t_reply)
            self._finalize_task(spec, "FAILED", stages)

    def _task_breakdown(self, spec: TaskSpec, pending: _PendingTask,
                        reply: dict, t_reply: float) -> Optional[dict]:
        """Stitch owner stamps + worker durations into the six-stage
        latency breakdown; record it into metrics/trace/ring buffer."""
        from ray_tpu_torch._private import latency

        stages = latency.owner_breakdown(
            pending.t_submit, pending.t_queued, pending.t_pushed,
            t_reply, time.monotonic(), reply.get("stages"))
        if stages is not None:
            latency.record_breakdown(
                spec.task_id.hex(), spec.function_name,
                spec.task_type.name, stages,
                trace_id=self._spec_trace_id(spec))
            if spec.trace_ctx is not None:
                self._record_owner_trace_spans(spec, stages)
        return stages

    def _record_owner_trace_spans(self, spec: TaskSpec,
                                  stages: dict) -> None:
        """Owner-side spans of a traced task: the task's OWN span (its
        id is the spec's trace_ctx span id, so children recorded by the
        worker/raylet parent correctly) plus the owner-observed stages.
        dispatch/execute are the worker's to record (its wall clock is
        the honest one there); the stage layout mirrors latency.py's
        back-to-back reconstruction ending at the reply-processed
        instant."""
        from ray_tpu_torch._private.latency import STAGES

        end = time.time()
        total = sum(stages.get(s, 0.0) or 0.0 for s in STAGES)
        ctx = spec.trace_ctx
        _tracing.record_span(
            f"task:{spec.function_name}", ctx, end - total, end,
            span_id=ctx[1],
            attrs={"task_id": spec.task_id.hex(),
                   "type": spec.task_type.name})
        t = end - total
        for stage in STAGES:
            dur = stages.get(stage, 0.0) or 0.0
            if stage in ("submit", "queue", "rpc", "reply"):
                _tracing.record_span(f"task.{stage}", ctx, t, t + dur,
                                     attrs={"task_id": spec.task_id.hex()})
            t += dur

    def _on_worker_failure(self, spec: TaskSpec):
        pending = self._pending_tasks.get(spec.task_id)
        if pending is None:
            return
        if pending.retries_left > 0:
            pending.retries_left -= 1
            logger.info("retrying task %s after worker failure (%d retries left)",
                        spec.function_name, pending.retries_left)
            self._resubmit(spec, reason="worker failure")
            return
        # the other half of the retry FSM: budget exhausted, fail for good
        self._elog.emit("task.giveup", task_id=spec.task_id.hex(),
                        trace_id=self._spec_trace_id(spec),
                        reason="worker failure, no retries left")
        err = exc.WorkerCrashedError(
            f"The worker executing task {spec.function_name} died unexpectedly."
        )
        self._store_error_for_task(spec, err)
        self._finalize_task(spec, "FAILED")

    def _resubmit(self, spec: TaskSpec, reason: str = "resubmit"):
        spec.attempt_number += 1
        pending = self._pending_tasks.get(spec.task_id)
        self._elog.emit(
            "task.retry", task_id=spec.task_id.hex(), reason=reason,
            trace_id=self._spec_trace_id(spec),
            attempt=spec.attempt_number,
            retries_left=pending.retries_left if pending else 0)
        if pending is not None:
            pending.spec = spec
            # fresh queue/push stamps for the retry; t_submit stays, so the
            # final breakdown's total covers every attempt
            pending.t_queued = None
            pending.t_pushed = None
        if spec.task_type == TaskType.NORMAL_TASK:
            self._normal_submit(spec)
        else:
            self._actor_submit(spec)

    def _store_return(self, oid: ObjectID, payload: dict):
        if "inline" in payload:
            self.memory_store.put_serialized(oid, payload["inline"])
            if payload["inline"] is not None:
                self.reference_counter.set_size(
                    oid, payload["inline"].total_bytes())
        else:
            self.memory_store.put_serialized(
                oid, None, location=payload["location"],
                in_plasma=payload.get("plasma_node") is not None,
                plasma_node=payload.get("plasma_node"))
            self.reference_counter.set_location(oid, payload["location"])
            if payload.get("size"):
                self.reference_counter.set_size(oid, payload["size"])
        self._release_deps(oid)

    def _store_error_for_task(self, spec: TaskSpec, error: BaseException):
        # tail-based keep: a trace that contains a task FAILURE is
        # interesting regardless of the head-sampling verdict. Consumer-
        # initiated cancels are routine (every abandoned stream ends in
        # one) — promoting them would flood the durable store.
        if not isinstance(error, exc.TaskCancelledError):
            _tracing.force_trace(self._spec_trace_id(spec),
                                 f"task_error:{type(error).__name__}")
        s = ser.serialize(error)
        for oid in spec.return_ids():
            self.memory_store.put_serialized(oid, s, value=error, is_exception=True)
            self._release_deps(oid)
        if spec.is_streaming_generator():
            # Wake consumers parked in next_generator_item: the error
            # entries above never signal the stream's cv, so every
            # terminal failure path that forgot an explicit
            # _finish_generator (actor push failure, _fail_actor_queue)
            # hung streaming consumers forever — chaos-harness find.
            # Idempotent with the call sites that already finish.
            self._finish_generator(spec.task_id, 0, error=s)

    def _finalize_task(self, spec: TaskSpec, state: str,
                       stages: Optional[dict] = None):
        with self._pending_lock:
            pending = self._pending_tasks.pop(spec.task_id, None)
        if pending is not None:
            for oid in pending.arg_ids:
                self.reference_counter.remove_submitted_task_ref(oid)
            if (spec.task_type == TaskType.ACTOR_TASK
                    and spec.actor_id is not None):
                rec = self._actors.get(spec.actor_id)
                if rec is not None:
                    with rec.lock:  # mailbox slot freed
                        if rec.outstanding > 0:
                            rec.outstanding -= 1
        self._record_task_event(spec, state, stages)

    # ------------------------------------------------------- actor submission
    def create_actor(
        self,
        cls,
        args: tuple,
        kwargs: dict,
        *,
        resources=None,
        placement_resources=None,
        max_restarts: int = 0,
        max_task_retries: int = 0,
        max_concurrency: Optional[int] = None,
        name: Optional[str] = None,
        namespace: Optional[str] = None,
        lifetime: Optional[str] = None,
        get_if_exists: bool = False,
        scheduling_strategy: Optional[SchedulingStrategySpec] = None,
        is_asyncio: bool = False,
        runtime_env: Optional[dict] = None,
    ) -> ActorID:
        job_id = self.current_job_id()
        actor_id = ActorID.of(job_id)
        fid = self.register_function(cls)
        runtime_env = self.prepare_runtime_env(runtime_env)
        if max_concurrency is None:
            max_concurrency = 1000 if is_asyncio else 1
        creation = ActorCreationSpec(
            actor_id=actor_id,
            max_restarts=max_restarts,
            max_task_retries=max_task_retries,
            max_concurrency=max_concurrency,
            name=name,
            namespace=namespace if namespace is not None else self.namespace,
            is_detached=lifetime == "detached",
            is_asyncio=is_asyncio,
        )
        arg_specs, kwarg_specs, arg_ids = self._build_args(args, kwargs)
        spec = TaskSpec(
            task_id=TaskID.for_actor_creation_task(actor_id),
            job_id=job_id,
            task_type=TaskType.ACTOR_CREATION_TASK,
            function_id=fid,
            function_name=getattr(cls, "__name__", "Actor") + ".__init__",
            args=arg_specs,
            num_returns=0,
            resources=resources if resources is not None
            else {"CPU": CONFIG.default_actor_num_cpus},
            placement_resources=placement_resources,
            owner_address=self.address,
            trace_parent=self.current_task_id().hex(),
            trace_ctx=self._trace_ctx_for_submit(),
            scheduling_strategy=scheduling_strategy or SchedulingStrategySpec(),
            actor_creation=creation,
            runtime_env=runtime_env,
            function_blob=self._fn_blobs.get(fid),
        )
        spec.kwarg_specs = kwarg_specs
        if name or get_if_exists:
            # named path stays synchronous: the reply decides between
            # "use the existing actor" and a name-conflict error
            reply = self._gcs.call(
                "register_actor",
                {"spec": spec, "get_if_exists": get_if_exists})
            if reply["status"] == "retry_later":
                # bounded GCS creation queue: typed pushback to the caller
                raise exc.RetryLaterError(
                    "GCS actor-creation queue is full",
                    retry_after_s=reply.get("retry_after_s", 1.0),
                    layer="gcs_actor_creation")
            if reply["status"] == "error":
                raise ValueError(reply["message"])
            registered_id = reply["info"].actor_id
        else:
            # Unnamed actors register PIPELINED (reference: CreateActor's
            # GCS registration is async, core_worker.cc:2224): the
            # request is enqueued and .remote() returns immediately, so a
            # burst of N creations pays one round trip of latency, not N.
            # A lost registration (GCS blip) retries once; a retry_later
            # pushback from the bounded creation queue re-registers with
            # paced backoff (the creation-burst analogue of AIMD lease
            # pacing). Both paths eventually mark the local record DEAD
            # so queued method calls fail typed instead of hanging.
            pushback_policy = _backoff.BackoffPolicy(
                base_s=0.25, multiplier=2.0, max_s=5.0, jitter=0.25)

            def _register(attempt: int = 0, pushbacks: int = 0):
                fut = self._gcs.call_future(
                    "register_actor",
                    {"spec": spec, "get_if_exists": False})

                def _mark_dead(aid, cause):
                    dead = ActorInfo(
                        actor_id=aid, state=ActorState.DEAD,
                        death_cause=cause)
                    asyncio.ensure_future(self._on_actor_event_async(dead))

                def _on_reply(f, aid=actor_id):
                    err = f.exception()
                    if err is None:
                        reply = f.result()
                        if (isinstance(reply, dict)
                                and reply.get("status") == "retry_later"):
                            if pushbacks >= 6:
                                logger.warning(
                                    "actor %s shed by the GCS creation "
                                    "queue %d times; giving up", aid,
                                    pushbacks + 1)
                                _mark_dead(
                                    aid,
                                    "GCS actor-creation queue stayed full"
                                    " (typed RetryLaterError pushback)")
                                return
                            delay = max(
                                reply.get("retry_after_s", 0.0),
                                pushback_policy.delay(pushbacks + 1))
                            self._gcs._lt.loop.call_later(
                                delay, lambda: _register(
                                    attempt, pushbacks + 1))
                        return
                    if attempt == 0:
                        logger.warning(
                            "actor %s registration failed (%s); retrying",
                            aid, err)
                        self._gcs._lt.loop.call_later(
                            0.5, lambda: _register(1, pushbacks))
                        return
                    logger.warning(
                        "actor %s registration failed permanently: %s",
                        aid, err)
                    _mark_dead(aid, f"actor registration failed: {err}")

                fut.add_done_callback(_on_reply)

            _register()
            registered_id = actor_id
        rec = self._actors.setdefault(
            registered_id, _ActorRecord(actor_id=registered_id)
        )
        rec.max_task_retries = max_task_retries
        self._ensure_actor_subscription()
        return registered_id

    def _on_worker_logs(self, key, batch):
        """LOG channel: print worker output on the driver console (only
        lines attributed to THIS driver's job — multi-job clusters must
        not interleave consoles)."""
        batch_job = batch.get("job_id")
        startup_crash = batch.get("unattributed", False)
        if batch_job is None and not startup_crash:
            # Unattributed output: broadcasting it would leak lines onto
            # every connected driver's console on multi-job clusters — drop.
            # (The raylet attributes normal startup output to the worker's
            # first lease; only marked startup-CRASH batches pass through.)
            return
        if (not startup_crash and self.job_id
                and batch_job != self.job_id.hex()):
            return
        pid = batch.get("pid")
        node = (batch.get("node") or "")[:8]
        tag = ", startup-crash" if startup_crash else ""
        prefix = f"(worker pid={pid}, node={node}{tag})"
        out = sys.stderr
        for line in batch.get("lines", []):
            print(f"{prefix} {line}", file=out)

    def _on_error_message(self, key, err):
        """ERROR channel: print this job's task errors once per task (the
        same error also surfaces at ray.get — dedup keeps retries quiet)."""
        if self.job_id and err.get("job_id") != self.job_id.hex():
            return
        task_id = err.get("task_id")
        if task_id in self._printed_errors:
            return
        self._printed_errors.add(task_id)
        if len(self._printed_errors) > 10_000:
            self._printed_errors.clear()
        print(f"(task error) {err.get('name')}: {err.get('message')}",
              file=sys.stderr)

    def report_error(self, spec, err: BaseException) -> None:
        """Fire-and-forget error publication to the GCS ERROR channel."""
        try:
            self._lt.submit(self._gcs.send_async("report_error", {
                "job_id": spec.job_id.hex() if spec.job_id else None,
                "task_id": spec.task_id.hex(),
                "name": spec.function_name,
                "message": str(err),
            }))
        except Exception:  # noqa: BLE001 — reporting must not mask the error
            logger.debug("error-report publication failed", exc_info=True)

    def _on_node_event(self, key, info):
        if info.alive:
            self._node_addr_cache[info.node_id] = info.raylet_address
            return
        self._node_addr_cache.pop(info.node_id, None)
        self._peers.invalidate(info.raylet_address)
        if info.raylet_address == self.raylet_address and self.mode == "driver":
            self._lt.submit(self._refresh_local_raylet())

    async def _refresh_local_raylet(self):
        try:
            nodes = await self._gcs.call_async("get_all_node_info", {})
        except (ConnectionLost, OSError):
            return None
        alive = [n for n in nodes if n.alive]
        if not alive:
            return None
        head = next((n for n in alive if n.is_head), alive[0])
        if head.raylet_address != self.raylet_address:
            logger.warning(
                "local raylet died; failing over to %s", head.raylet_address
            )
            self.raylet_address = head.raylet_address
        return self.raylet_address

    def _ensure_actor_subscription(self):
        if self._actor_sub_started:
            return
        self._actor_sub_started = True
        self.subscribe(ps.ACTOR_CHANNEL, self._on_actor_event)
        self._gcs.call(
            "subscribe",
            {"channel": ps.ACTOR_CHANNEL, "subscriber_address": self.address_str},
        )

    def _on_actor_event(self, key, info):
        self._lt.submit(self._on_actor_event_async(info))

    async def _on_actor_event_async(self, info):
        rec = self._actors.get(info.actor_id)
        if rec is None:
            return
        if info.state == ActorState.ALIVE:
            rec.state = "ALIVE"
            self._emit_actor_state(rec, "pubsub event")
            self._note_incarnation(rec, info)
            rec.address = info.address
            await self._flush_actor_queue(rec)
        elif info.state == ActorState.RESTARTING:
            rec.state = "RESTARTING"
            self._emit_actor_state(rec, "pubsub event")
            # the incarnation behind rec.address is DEAD (that is why it is
            # restarting): drop its borrows NOW, before the address is
            # nulled here / overwritten by the next ALIVE — afterwards
            # nothing remembers which worker held them
            self._drop_dead_borrower(rec.address)
            rec.address = None
            if rec.queue:
                # The reaper may have parked while this actor looked
                # ALIVE; queued calls now depend on the lost-ALIVE sweep
                # backstop, so make sure it is running.
                self._poke_reaper()
        elif info.state == ActorState.DEAD:
            rec.state = "DEAD"
            self._emit_actor_state(rec, "pubsub event")
            rec.death_cause = info.death_cause
            self._drop_dead_borrower(rec.address)
            rec.address = None
            self._fail_actor_queue(rec)

    def _drop_dead_borrower(self, address) -> None:
        """A dead actor can never send its borrow releases: drop its
        worker from every owned ref's borrower set, or each object it
        borrowed stays pinned on this owner forever (reference: the owner
        prunes borrowers on worker-failure notifications)."""
        if address is not None:
            self.reference_counter.remove_borrower_everywhere(
                address.rpc_address)

    def _note_incarnation(self, rec: "_ActorRecord", info) -> None:
        """An ALIVE at a higher num_restarts means the PREVIOUS
        incarnation died: reset the sequencing gate for the new worker
        and drop the dead incarnation's borrows (a missed RESTARTING
        pubsub event would otherwise overwrite the only record of which
        address held them). Call BEFORE rec.address is updated."""
        if info.num_restarts > rec.incarnation:
            new_addr = (info.address.rpc_address
                        if info.address is not None else None)
            if (rec.address is not None
                    and rec.address.rpc_address != new_addr):
                self._drop_dead_borrower(rec.address)
            rec.incarnation = info.num_restarts
            rec.seq = 0

    def _emit_actor_state(self, rec: "_ActorRecord", reason: str) -> None:
        """Owner-side actor record FSM transition -> lifecycle event log
        (the client's view can disagree with the GCS FSM during races —
        post-mortems need both sides)."""
        self._elog.emit("actor.client_state", actor_id=rec.actor_id.hex(),
                        state=rec.state, reason=reason)

    def _fail_actor_queue(self, rec: _ActorRecord) -> None:
        """Fail every task queued on a DEAD actor. Callable from any point
        that discovers the death — queueing a spec after the DEAD pubsub
        event already drained the queue would otherwise strand it (and the
        caller's ray.get) forever."""
        while rec.queue:
            spec = rec.queue.popleft()
            self._store_error_for_task(
                spec,
                exc.ActorDiedError(rec.actor_id, error_message=(
                    f"Actor {rec.actor_id.hex()[:12]} is dead: "
                    f"{rec.death_cause}")),
            )
            self._finalize_task(spec, "FAILED")

    def submit_actor_task(
        self, actor_id: ActorID, method_name: str, args: tuple, kwargs: dict,
        *, num_returns=1, deadline_s: Optional[float] = None,
    ):
        t_submit = time.monotonic()
        rec = self._actors.get(actor_id)
        if rec is None:
            rec = _ActorRecord(actor_id=actor_id)
            self._actors[actor_id] = rec
            self._ensure_actor_subscription()
            info = self._gcs.call("get_actor_info", {"actor_id": actor_id})
            if info is not None:
                if info.state == ActorState.ALIVE:
                    rec.state = "ALIVE"
                    self._emit_actor_state(rec, "first contact")
                    rec.address = info.address
                    # First-contact race: a CONCURRENT submit from another
                    # thread can find this record while the GCS call above
                    # was in flight, see a non-ALIVE state, and park its
                    # spec on rec.queue — and its own async poll then
                    # no-ops because the state is ALIVE by the time it
                    # lands. Whoever completes the first-contact poll owns
                    # flushing the queue, or those parked calls hang
                    # forever (observed: concurrent streaming calls from
                    # serve.llm's router threads).
                    self._lt.submit(self._flush_actor_queue(rec))
                elif info.state == ActorState.DEAD:
                    rec.state = "DEAD"
                    self._emit_actor_state(rec, "first contact")
                    rec.death_cause = info.death_cause
        if rec.state == "DEAD":
            raise exc.ActorDiedError(
                actor_id, error_message=f"Actor is dead: {rec.death_cause}"
            )
        mailbox_max = CONFIG.actor_mailbox_max
        if mailbox_max > 0 and rec.outstanding >= mailbox_max:
            # Bounded owner-side mailbox: typed pushback at submit instead
            # of parking an unbounded backlog behind a non-ALIVE (or
            # slow-flushing) actor. The caller retries after the hint —
            # shed, never lost.
            ambient = _tracing.current_trace()
            self._elog.emit("task.shed", actor_id=actor_id.hex(),
                            trace_id=ambient.trace_id if ambient else None,
                            layer="actor_mailbox", reason="mailbox full",
                            method=method_name)
            _backoff.count_shed("actor_mailbox")
            if ambient is not None:
                _tracing.force_trace(ambient.trace_id,
                                     "task.shed:actor_mailbox")
            raise exc.RetryLaterError(
                f"actor {actor_id.hex()[:12]} mailbox is full "
                f"({rec.outstanding} outstanding calls)",
                retry_after_s=_backoff.retry_after_hint(rec.outstanding),
                layer="actor_mailbox")
        streaming = num_returns == "streaming" or num_returns == -1
        task_id = TaskID.for_actor_task(actor_id)
        arg_specs, kwarg_specs, arg_ids = self._build_args(args, kwargs)
        spec = TaskSpec(
            task_id=task_id,
            job_id=self.current_job_id(),
            task_type=TaskType.ACTOR_TASK,
            function_id="",
            function_name=method_name,
            method_name=method_name,
            args=arg_specs,
            num_returns=-1 if streaming else num_returns,
            owner_address=self.address,
            trace_parent=self.current_task_id().hex(),
            trace_ctx=self._trace_ctx_for_submit(),
            actor_id=actor_id,
            deadline_s=_deadlines.effective_deadline(
                deadline_s, self._parent_deadline()),
        )
        spec.kwarg_specs = kwarg_specs
        with self._pending_lock:
            self._pending_tasks[task_id] = _PendingTask(
                spec=spec, retries_left=rec.max_task_retries,
                is_actor_task=True, arg_ids=arg_ids, t_submit=t_submit,
            )
        # mailbox slot held from here until _finalize_task releases it
        # (incremented on the user thread, AFTER every raise-able step,
        # paired with the _pending_tasks entry the decrement keys off)
        with rec.lock:
            rec.outstanding += 1
        if streaming:
            # See submit_task: item oids are owned at report time, not here.
            self._generators[task_id] = _GeneratorState()
            self._actor_submit(spec)
            return ObjectRefGenerator(task_id)
        return_refs = []
        for oid in spec.return_ids():
            self.reference_counter.add_owned(oid, self.address)
            return_refs.append(ObjectRef(oid, owner_address=self.address))
        self._actor_submit(spec)
        return return_refs

    def _actor_submit(self, spec: TaskSpec):
        self._enqueue_submit(True, spec)

    async def _actor_submit_batch(self, actor_id: ActorID,
                                  specs: List[TaskSpec]):
        rec = self._actors[actor_id]
        if rec.state == "ALIVE" and rec.address is not None:
            await self._push_actor_tasks(rec, specs)
            return
        if rec.state == "DEAD":
            for spec in specs:
                self._store_error_for_task(
                    spec, exc.ActorDiedError(
                        rec.actor_id,
                        error_message=f"Actor is dead: {rec.death_cause}"))
                self._finalize_task(spec, "FAILED")
            return
        rec.queue.extend(specs)
        self._poke_reaper()  # sweep backstop for a lost ALIVE event
        # Poll GCS once in case we missed the ALIVE (or DEAD) event.
        info = await self._gcs.call_async(
            "get_actor_info", {"actor_id": actor_id})
        self._apply_actor_info(rec, info)

    def _apply_actor_info(self, rec: _ActorRecord, info) -> None:
        """Reconcile a GCS-polled ActorInfo into the record — the polled
        twin of _on_actor_event_async, for when the pubsub event was lost
        or raced the subscription. A missed DEAD here left queued specs
        (and their callers' ray.get) hanging forever."""
        if info is None:
            return
        if (info.state == ActorState.ALIVE
                and rec.state not in ("ALIVE", "DEAD")):
            # DEAD is terminal: a stale poll reply racing the DEAD pubsub
            # event must not resurrect the record (new submits would stop
            # raising ActorDiedError and push to a dead address)
            rec.state = "ALIVE"
            self._emit_actor_state(rec, "GCS reconcile")
            self._note_incarnation(rec, info)
            rec.address = info.address
            asyncio.ensure_future(self._flush_actor_queue(rec))
        elif (info.state == ActorState.ALIVE and rec.state == "ALIVE"
              and rec.queue):
            # Already ALIVE but specs are parked (another thread queued
            # them while the first-contact poll was in flight): flush.
            asyncio.ensure_future(self._flush_actor_queue(rec))
        elif info.state == ActorState.DEAD and rec.state != "DEAD":
            rec.state = "DEAD"
            self._emit_actor_state(rec, "GCS reconcile")
            rec.death_cause = info.death_cause
            self._drop_dead_borrower(rec.address)
            rec.address = None
            self._fail_actor_queue(rec)

    async def _flush_actor_queue(self, rec: _ActorRecord):
        if rec.queue and rec.state == "ALIVE" and rec.address is not None:
            specs = list(rec.queue)
            rec.queue.clear()
            asyncio.ensure_future(self._push_actor_tasks(rec, specs))

    async def _push_actor_tasks(self, rec: _ActorRecord,
                                specs: List[TaskSpec]):
        """Push a burst of calls to one actor as ONE RPC. Sequence numbers
        are assigned here (on the loop, in FIFO order) so that a restarted
        actor incarnation starts again from 0. The worker preserves
        concurrency semantics per batch (ordered actors run the batch
        serially in seq order; async/threaded actors dispatch every spec
        concurrently — see _handle_push_task_w)."""
        # Assign ALL sequence numbers up-front, before any await: a later
        # batch's coroutine can interleave at the chunk-push awaits below,
        # and taking rec.seq there would hand later-submitted calls
        # earlier sequence numbers (the worker's sequencing gate executes
        # strictly by seq — ordered actors would run calls out of order).
        # A spec requeued after a failed push to THIS incarnation keeps
        # its number: its slot was already burned, and a fresh one would
        # leave a permanent gap the worker's gate waits 60s on for every
        # later call. Specs carried across an incarnation bump re-stamp
        # from the reset counter (the new worker's gate starts at 0).
        #
        # Queue-pop doomed-work elimination: expired specs that were
        # never sequence-stamped are dropped HERE (before a number is
        # burned); already-stamped requeues must still ride to the worker
        # — it drops them at its own pop and advances the gate, so no
        # permanent seq gap can form.
        now = time.time()
        alive = []
        for spec in specs:
            if (spec.sequence_number < 0
                    and _deadlines.expired(spec.deadline_s, now)):
                self._expire_spec(spec)
                continue
            alive.append(spec)
        specs = alive
        if not specs:
            return
        for spec in specs:
            if (spec.sequence_number < 0
                    or getattr(spec, "_seq_incarnation", None)
                    != rec.incarnation):
                spec.sequence_number = rec.seq
                rec.seq += 1
                spec._seq_incarnation = rec.incarnation
            self._record_task_event(spec, "RUNNING")
        cap = max(1, CONFIG.max_tasks_per_push)
        # Chunking: a batched RPC replies once, AFTER every call in it
        # completed — so a long-running call in the batch holds every
        # batch-mate's reply hostage (observed deadlock: tune's quick
        # start_training batched with the hour-long next_result long-poll;
        # tune needed start_training's error to cancel next_result).
        # Only methods MEASURED short may share a chunk; unknown or slow
        # methods ride their own pipelined RPC. Chunks are all in flight
        # concurrently on the multiplexed connection (frames written in
        # seq order; the worker's sequencing gate orders execution), so
        # splitting costs framing bytes, not round trips.
        # at least 50ms: scheduler preemption on a loaded host shows up as
        # tens-of-ms execution blips, and one blip must not permanently
        # unbatch a microsecond method
        threshold = max(0.05, CONFIG.task_batch_latency_ms / 1000.0)
        chunks: List[List[TaskSpec]] = []
        cur: List[TaskSpec] = []
        for spec in specs:
            worst = rec.method_time_max.get(spec.method_name)
            short = worst is not None and worst < threshold
            if short and len(cur) < cap:
                cur.append(spec)
                continue
            if cur:
                chunks.append(cur)
                cur = []
            if short:
                cur.append(spec)
            else:
                chunks.append([spec])
        if cur:
            chunks.append(cur)
        client = self._peers.get(rec.address.rpc_address)

        async def _push_chunk(chunk: List[TaskSpec]):
            t0 = time.monotonic()
            for spec in chunk:
                p = self._pending_tasks.get(spec.task_id)
                if p is not None:
                    p.t_pushed = t0
            try:
                wire = await client.call_async(
                    "push_task_w", [spec_to_wire(s) for s in chunk],
                    timeout=None)
                replies = [reply_from_wire(t) for t in wire]
            except ConnectionLost as e:
                # maybe_delivered=False (connect refused: the actor worker
                # process is already gone) means NOTHING in this chunk
                # executed — the failure path may requeue without burning
                # at-most-once retry budget.
                logger.debug("actor push chunk failed", exc_info=True)
                return [(s, not e.maybe_delivered) for s in chunk]
            except Exception:  # noqa: BLE001 — remote handler error,
                # reply decode failure: these specs got no usable reply.
                # Route them ALL through the push-failure path; letting
                # any exception escape would blow up the gather and
                # strand the OTHER chunks' specs.
                logger.debug("actor push chunk failed", exc_info=True)
                return [(s, False) for s in chunk]
            per_call = (time.monotonic() - t0) / max(1, len(chunk))
            for spec, reply in zip(chunk, replies):
                # prefer the worker-measured execution time: the round
                # trip includes sequencing-gate queueing behind earlier
                # calls, which would inflate fast methods into
                # "long" and permanently defeat batching
                dur = (reply.get("exec_s", per_call)
                       if isinstance(reply, dict) else per_call)
                prev = rec.method_time_max.get(spec.method_name, 0.0)
                if prev >= 1.0 or dur >= 1.0:
                    # a method that ever blocked a full second is a
                    # long-poller: sticky, never re-batches
                    rec.method_time_max[spec.method_name] = max(prev, dur)
                else:
                    # sub-second worst decays, so one preemption blip
                    # doesn't permanently defeat batching
                    rec.method_time_max[spec.method_name] = max(
                        dur, prev * 0.8)
                self._on_task_reply(spec, reply)
            return None

        if len(chunks) == 1:  # hot path: no gather/task machinery
            failed = await _push_chunk(chunks[0]) or []
        else:
            results = await asyncio.gather(*(map(_push_chunk, chunks)))
            failed = [s for chunk in results if chunk for s in chunk]
        if failed:
            await self._on_actor_push_failure(rec, failed)

    async def _on_actor_push_failure(self, rec: _ActorRecord,
                                     failures: List[Tuple[TaskSpec, bool]]):
        """`failures`: (spec, undelivered) pairs. undelivered=True means
        the push provably never reached the worker (ConnectionLost with
        maybe_delivered=False): the call did not execute, so requeueing it
        is safe for ANY method and must not consume the at-most-once
        retry budget (bounded by undelivered_failures so a persistently
        refusing address still terminates)."""
        peer = (rec.address.rpc_address if rec.address is not None
                else rec.actor_id.hex())
        budget = _backoff.default_retry_budget()
        retry_specs = []
        for spec, undelivered in failures:
            pending = self._pending_tasks.get(spec.task_id)
            if pending is not None and undelivered:
                pending.undelivered_failures += 1
                if pending.undelivered_failures <= 20:
                    retry_specs.append(spec)
                    continue
                # persistent refusals: fall through to the budgeted path
            # At-most-once retries spend the (peer, method) token bucket
            # BEFORE spending per-task retries_left: during a brownout
            # every in-flight call fails at once, and N tasks x M retries
            # of un-budgeted resubmission is the retry storm that turns a
            # brownout into a blackout. An empty bucket fails fast with
            # the underlying error (counted in
            # ray_tpu_retry_budget_exhausted_total).
            if (pending is not None and pending.retries_left > 0
                    and budget.try_spend(peer, spec.method_name)):
                pending.retries_left -= 1
                retry_specs.append(spec)
            else:
                self._store_error_for_task(
                    spec,
                    exc.ActorUnavailableError(
                        rec.actor_id,
                        error_message="Lost connection to actor "
                        f"{rec.actor_id.hex()[:12]} while task "
                        f"{spec.method_name} was in flight.",
                    ),
                )
                self._finalize_task(spec, "FAILED")
        if not retry_specs:
            return
        rec.queue.extend(retry_specs)
        self._poke_reaper()  # sweep backstop while the actor restarts
        if rec.state == "DEAD":
            # the DEAD pubsub event already drained the queue before we
            # re-queued these specs — fail them now or they hang forever
            self._fail_actor_queue(rec)
            return
        if rec.state == "ALIVE":
            rec.state = "RESTARTING"  # wait for pubsub to re-resolve
            self._emit_actor_state(rec, "push failure")
        # The address may simply be stale (actor already restarted):
        # re-resolve once from the GCS.
        info = await self._gcs.call_async(
            "get_actor_info", {"actor_id": rec.actor_id}
        )
        if (
            info is not None
            and info.state == ActorState.ALIVE
            and info.address is not None
            and (rec.address is None
                 or info.address.rpc_address != rec.address.rpc_address
                 or info.num_restarts > rec.incarnation)
        ):
            rec.state = "ALIVE"
            self._emit_actor_state(rec, "re-resolved after push failure")
            self._note_incarnation(rec, info)
            rec.address = info.address
            await self._flush_actor_queue(rec)
            return
        if info is not None and info.state == ActorState.DEAD:
            # no restart coming (pubsub DEAD may have been processed before
            # our specs were queued, or the subscription raced creation)
            rec.state = "DEAD"
            self._emit_actor_state(rec, "re-resolved after push failure")
            rec.death_cause = info.death_cause
            self._drop_dead_borrower(rec.address)
            rec.address = None
            self._fail_actor_queue(rec)

    # -------------------------------------------------------- actor controls
    def kill_actor(self, actor_id: ActorID, no_restart: bool = True):
        self._gcs.call("kill_actor", {"actor_id": actor_id, "no_restart": no_restart})

    def get_actor_info(self, actor_id: ActorID):
        return self._gcs.call("get_actor_info", {"actor_id": actor_id})

    def get_named_actor(self, name: str, namespace: Optional[str] = None):
        return self._gcs.call(
            "get_named_actor",
            {"name": name, "namespace": namespace if namespace is not None else self.namespace},
        )

    def cancel_task(self, ref: ObjectRef, force: bool = False):
        self.cancel_task_by_id(ref.object_id().task_id(), force)

    def cancel_task_by_id(self, task_id, force: bool = False):
        """Cancel by TaskID directly — used by ObjectRefGenerator.close(),
        where the consumer holds a generator (task) rather than a ref."""
        pending = self._pending_tasks.get(task_id)
        if pending is None:
            return
        target = pending.pushed_to
        if target is None and pending.spec.task_type == TaskType.ACTOR_TASK:
            # Actor pushes never set pushed_to (that is the normal-task
            # lease field): resolve the actor's CURRENT worker address so
            # a running actor stream actually receives the cancel — the
            # silent local no-op here left abandoned serving streams
            # decoding whole token budgets into the void.
            rec = self._actors.get(pending.spec.actor_id)
            if rec is not None:
                if rec.queue and any(
                        s.task_id == task_id for s in rec.queue):
                    # still parked owner-side waiting for an address:
                    # cancel it locally, nothing to RPC
                    async def _drop_queued():
                        r = self._actors.get(pending.spec.actor_id)
                        if r is None:
                            return
                        for s in list(r.queue):
                            if s.task_id == task_id:
                                r.queue.remove(s)
                                self._cancel_queued_spec(s, task_id)
                                return

                    try:
                        self._lt.submit(_drop_queued()).result(timeout=10)
                    except (TimeoutError, concurrent.futures.TimeoutError):
                        pass
                    return
                if rec.address is not None:
                    target = rec.address.rpc_address
        if target is not None:
            try:
                self._peers.get(target).call(
                    "cancel_task", {"task_id": task_id, "force": force}, timeout=10
                )
            except ConnectionLost:
                pass
        else:
            # Still queued locally (or parked on unresolved deps): drop it.
            # Marshaled onto the event loop — _dep_waiters and _key_states
            # are loop-owned; mutating them from the caller's thread races
            # _drain_submits registration (lost waiters -> hung gets).
            async def _cancel_local():
                if self._cancel_parked(task_id):
                    self._cancel_queued_spec(pending.spec, task_id)
                    return
                key = pending.spec.scheduling_key()
                st = self._key_states.get(key)
                if st is not None:
                    try:
                        st.pending.remove(pending.spec)
                    except ValueError:
                        pass
                    else:
                        self._cancel_queued_spec(pending.spec, task_id)

            try:
                self._lt.submit(_cancel_local()).result(timeout=10)
            except (TimeoutError, concurrent.futures.TimeoutError):
                pass

    def _cancel_queued_spec(self, spec: TaskSpec, task_id):
        """Finalize a spec cancelled before dispatch (loop thread only)."""
        self._store_error_for_task(spec, exc.TaskCancelledError(task_id))
        if spec.is_streaming_generator():
            # wake consumers blocked in next_generator_item — the error
            # entry alone never signals the generator's condition variable
            self._finish_generator(
                task_id, 0,
                error=ser.serialize(exc.TaskCancelledError(task_id)))
        self._finalize_task(spec, "CANCELLED")

    # ------------------------------------------------------ placement groups
    def create_placement_group(
        self, bundles, strategy="PACK", name="", lifetime=None
    ) -> PlacementGroupID:
        job_id = self.current_job_id()
        pg_id = PlacementGroupID.of(job_id)
        spec = PlacementGroupSpec(
            placement_group_id=pg_id,
            bundles=[dict(b) for b in bundles],
            strategy=strategy,
            name=name,
            lifetime=lifetime,
            job_id=job_id,
        )
        reply = self._gcs.call("create_placement_group", {"spec": spec})
        if reply["status"] != "ok":
            raise ValueError(reply.get("message", "placement group creation failed"))
        return pg_id

    def remove_placement_group(self, pg_id: PlacementGroupID):
        self._pg_cache.pop(pg_id, None)
        self._gcs.call("remove_placement_group", {"placement_group_id": pg_id})

    def wait_placement_group_ready(self, pg_id: PlacementGroupID, timeout=None) -> bool:
        reply = self._gcs.call(
            "wait_placement_group_ready",
            {"placement_group_id": pg_id, "timeout": timeout},
            timeout=(timeout + 5) if timeout and timeout > 0 else None,
        )
        return reply.get("status") == "ready"

    # -------------------------------------------------------------- pubsub
    def subscribe(self, channel: str, callback):
        self._subscriptions.setdefault(channel, []).append(callback)

    async def _handle_pubsub_message(self, payload):
        channel, key, message = payload
        for cb in self._subscriptions.get(channel, []):
            try:
                cb(key, message)
            except Exception:
                logger.exception("pubsub callback failed")
        return True

    # ------------------------------------------------------ owner services
    async def _handle_get_object(self, payload):
        oid: ObjectID = payload["object_id"]
        want_value = payload.get("want_value", True)
        timeout = payload.get("timeout", 0)
        entry = self.memory_store.get_entry(oid)
        if entry is None and timeout and timeout > 0:
            loop = asyncio.get_event_loop()
            fut = loop.create_future()

            def _cb(e):
                loop.call_soon_threadsafe(
                    lambda: fut.set_result(e) if not fut.done() else None
                )

            self.memory_store.add_callback(oid, _cb)
            try:
                entry = await asyncio.wait_for(fut, timeout)
            except asyncio.TimeoutError:
                entry = self.memory_store.get_entry(oid)
        if entry is None:
            if self.reference_counter.owns(oid) or oid.task_id() in self._pending_tasks:
                return {"status": "pending"}
            return {"status": "not_owner"}
        if entry.freed:
            return {"status": "freed"}
        if entry.location is not None and entry.serialized is None:
            locs = self.reference_counter.get_all_locations(oid)
            return {"status": "ready", "location": entry.location,
                    "replicas": [l for l in locs if l != entry.location]}
        if entry.in_plasma and entry.serialized is None:
            # Owner holds the payload in its node shm store: serve it from
            # there (borrower is remote — same-node borrowers hit shm
            # directly and never reach this RPC).
            if want_value:
                s = await asyncio.to_thread(self._read_local_plasma, oid)
                if s is None:
                    return {"status": "freed"}
                if (s.wire_size() > CONFIG.fetch_chunk_size_bytes
                        and not entry.is_exception):
                    # don't inline multi-chunk payloads in one reply:
                    # point the borrower at our fetch/chunk service
                    return {"status": "ready",
                            "location": self.address_str,
                            "replicas": self.reference_counter
                            .get_all_locations(oid)}
                return {"status": "ready", "data": s,
                        "is_exception": entry.is_exception}
            return {"status": "ready"}
        if want_value:
            if (entry.serialized is not None
                    and not entry.is_exception
                    and entry.serialized.wire_size()
                    > CONFIG.fetch_chunk_size_bytes):
                return {"status": "ready", "location": self.address_str,
                        "replicas": self.reference_counter
                        .get_all_locations(oid)}
            return {
                "status": "ready",
                "data": entry.serialized,
                "is_exception": entry.is_exception,
            }
        return {"status": "ready"}

    def _read_local_plasma(self, oid: ObjectID):
        if self.plasma is None:
            return None
        return self.plasma.get_serialized(oid)

    async def _handle_fetch_object(self, payload):
        """Serve a whole object — or, when the caller sets max_inline and
        the object is bigger, announce its flat wire size so the caller
        switches to chunked pulls (fetch_object_chunk). Reference:
        object_manager.cc Pull/chunked reads + object_buffer_pool.cc."""
        oid: ObjectID = payload["object_id"]
        max_inline = payload.get("max_inline")
        entry = self.memory_store.get_entry(oid)
        if entry is None:
            return {"status": "not_found"}
        if entry.serialized is None and entry.in_plasma:
            if max_inline is not None:
                view = await asyncio.to_thread(
                    self.plasma.get_raw_view, oid) if self.plasma else None
                if view is None:
                    return {"status": "not_found"}
                if view.nbytes > max_inline:
                    return {"status": "chunked", "size": view.nbytes}
                # serve from the already-pinned view (a second
                # get_serialized would redo the store lookup + pin)
                return {"status": "ok",
                        "data": ser.SerializedObject.from_bytes(view)}
            s = await asyncio.to_thread(self._read_local_plasma, oid)
            if s is None:
                return {"status": "not_found"}
            return {"status": "ok", "data": s}
        if entry.serialized is None:
            return {"status": "not_found"}
        s = entry.serialized
        if max_inline is not None:
            size = sum(seg.nbytes if hasattr(seg, "nbytes") else len(seg)
                       for seg in s.wire_segments())
            if size > max_inline:
                return {"status": "chunked", "size": size}
        return {"status": "ok", "data": s}

    async def _handle_fetch_object_chunk(self, payload):
        """One [off, off+length) range of the flat wire payload.

        Copy-free serving: chunks go back as PickleBuffer views — a pinned
        slice of the shm arena, or a zero-copy slice of a memory-store
        resident's wire segments — which the RPC layer's out-of-band
        framing scatters straight to the socket. The arena slice keeps the
        parent view (and through it the GC-tied store ref) alive until the
        reply frame is written."""
        oid: ObjectID = payload["object_id"]
        off, length = payload["off"], payload["len"]
        entry = self.memory_store.get_entry(oid)
        if entry is None:
            return {"status": "not_found"}
        if entry.serialized is None and entry.in_plasma:
            if self.plasma is None:
                return {"status": "not_found"}
            view = await asyncio.to_thread(self.plasma.get_raw_view, oid)
            if view is None:
                return {"status": "not_found"}
            return {"status": "ok",
                    "data": pickle.PickleBuffer(view[off:off + length])}
        if entry.serialized is None:
            return {"status": "not_found"}
        return {"status": "ok",
                "data": pickle.PickleBuffer(_slice_segments(
                    entry.serialized.wire_segments(), off, length))}

    async def _handle_add_object_location(self, payload):
        self.reference_counter.add_location(
            payload["object_id"], payload["location"])
        return True

    async def _handle_drop_object_location(self, payload):
        self.reference_counter.drop_location(
            payload["object_id"], payload["location"])
        return True

    async def _handle_free_objects(self, payload):
        plasma_frees = []
        for oid in payload["object_ids"]:
            entry = self.memory_store.get_entry(oid)
            if entry is not None and entry.in_plasma and self.plasma is not None:
                plasma_frees.append(oid)
        self.memory_store.delete(payload["object_ids"])
        for oid in payload["object_ids"]:
            # raylint: disable=cross-domain-mutation — GIL-atomic set
            # add/discard with no compound invariant across the two
            # sites: free-vs-hold of the same oid is ordered by the
            # owner's ref protocol (free only after all refs dropped)
            self._secondary_copies.discard(oid)
        if plasma_frees:
            def _free():
                for oid in plasma_frees:
                    self.plasma.free(oid)
            await asyncio.to_thread(_free)
        return True

    async def _handle_add_borrower(self, payload):
        self.reference_counter.add_borrower(payload["object_id"], payload["borrower"])
        return True

    async def _handle_remove_borrower(self, payload):
        self.reference_counter.remove_borrower(payload["object_id"], payload["borrower"])
        return True

    async def _handle_reconstruct_object(self, payload):
        return self._try_reconstruct(payload["object_id"])

    @staticmethod
    def _attach_worker_stages(replies, recv: float, shared: bool) -> None:
        """Turn the executor's raw stamps into the reply's `stages` dict
        (worker's own clock — durations only, so the owner can stitch
        them against its stamps with no cross-process clock sync).
        `shared`: the replies share one receive stamp (a batched push), so
        per-reply pack time can't be isolated — later batchmates' waiting
        shows up in their dispatch stage instead."""
        wall = time.monotonic() - recv
        for r in replies:
            if not isinstance(r, dict):
                continue
            started = r.pop("_rt_exec_started", None)
            fn_s = r.pop("_rt_fn_s", None)
            if started is None:
                continue
            dispatch = max(0.0, started - recv)
            execute = fn_s if fn_s is not None else (r.get("exec_s") or 0.0)
            if shared:
                pack = 0.0
            else:
                pack = max(0.0, wall - dispatch - execute)
            r["stages"] = {"dispatch": dispatch, "exec": execute,
                           "pack": pack,
                           "wall": dispatch + execute + pack}

    @staticmethod
    def _record_worker_trace_spans(specs, replies) -> None:
        """Worker-side spans of traced tasks (dispatch + execute), laid
        out on THIS process's wall clock ending at reply time — the
        owner records submit/queue/rpc/reply from its own stamps, so the
        pair covers the whole round trip without clock sync. One `is
        None` check per untraced spec."""
        now = time.time()
        for spec, reply in zip(specs, replies):
            ctx = getattr(spec, "trace_ctx", None)
            if ctx is None or not isinstance(reply, dict):
                continue
            stages = reply.get("stages")
            if not stages:
                continue
            end_exec = now - (stages.get("pack", 0.0) or 0.0)
            execute = stages.get("exec", 0.0) or 0.0
            dispatch = stages.get("dispatch", 0.0) or 0.0
            _tracing.record_span(
                "task.execute", ctx, end_exec - execute, end_exec,
                attrs={"task_id": spec.task_id.hex(),
                       "function": spec.function_name,
                       "status": reply.get("status", "?")})
            _tracing.record_span(
                "task.dispatch", ctx, end_exec - execute - dispatch,
                end_exec - execute,
                attrs={"task_id": spec.task_id.hex()})

    async def _handle_push_task(self, payload):
        recv = time.monotonic()
        spec: TaskSpec = payload["spec"]
        self._record_task_event(spec, "EXECUTING")
        reply = await self.executor.execute(spec)
        self._attach_worker_stages([reply], recv, shared=False)
        self._record_worker_trace_spans([spec], [reply])
        if spec.task_type == TaskType.ACTOR_CREATION_TASK:
            # creation tasks have no owner-side _finalize_task (the GCS
            # pushes them); record completion here or the timeline shows
            # every __init__ as never finishing
            ok = (reply.get("status") == "ok" if isinstance(reply, dict)
                  else True)
            self._record_task_event(spec, "FINISHED" if ok else "FAILED")
        return reply

    async def _handle_push_task_batch(self, payload):
        """Owner-batched normal-task pushes (see _pump): execute serially in
        arrival order, in ONE thread-pool job. If a task retires the worker
        (max_calls), the rest of the batch is returned not_run so the owner
        re-queues it."""
        recv = time.monotonic()
        specs = payload["specs"]
        for spec in specs:
            self._record_task_event(spec, "EXECUTING")
        loop = asyncio.get_event_loop()
        replies = await loop.run_in_executor(
            self.executor._pool, self.executor.execute_batch_sync, specs)
        self._attach_worker_stages(replies, recv, shared=len(specs) > 1)
        self._record_worker_trace_spans(specs, replies)
        return {"replies": replies}

    async def _handle_push_task_w(self, payload):
        """Wire-codec push (hot path): payload is a list of spec tuples,
        the reply a list of wire reply tuples. One spec executes through
        the normal async path; a batch of normal tasks runs serially in
        one thread-pool job; a batch of actor calls dispatches every spec
        concurrently so async/threaded actor semantics hold (ordered
        actors still serialize on the executor's sequencing gate)."""
        recv = time.monotonic()
        specs = [spec_from_wire(t) for t in payload]
        for spec in specs:
            self._record_task_event(spec, "EXECUTING")
        if len(specs) == 1:
            reply = await self.executor.execute(specs[0])
            self._attach_worker_stages([reply], recv, shared=False)
            self._record_worker_trace_spans(specs, [reply])
            return [reply_to_wire(reply)]
        if all(s.task_type == TaskType.NORMAL_TASK for s in specs):
            loop = asyncio.get_event_loop()
            replies = await loop.run_in_executor(
                self.executor._pool, self.executor.execute_batch_sync,
                specs)
            self._attach_worker_stages(replies, recv, shared=True)
            self._record_worker_trace_spans(specs, replies)
            return [reply_to_wire(r) for r in replies]
        creation = self.executor._actor_spec
        if creation is None or (creation.max_concurrency <= 1
                                and not creation.is_asyncio):
            # plain ordered actor: the calls would serialize on the seq
            # gate anyway — run them in ONE pool job (a loop hop per call
            # costs more than a trivial method body)
            loop = asyncio.get_event_loop()
            replies = await loop.run_in_executor(
                self.executor._pool, self.executor.execute_actor_batch_sync,
                specs)
            self._attach_worker_stages(replies, recv, shared=True)
            self._record_worker_trace_spans(specs, replies)
            return [reply_to_wire(r) for r in replies]
        replies = await asyncio.gather(
            *(self.executor.execute(s) for s in specs))
        self._attach_worker_stages(replies, recv, shared=True)
        self._record_worker_trace_spans(specs, replies)
        return [reply_to_wire(r) for r in replies]

    async def _handle_kill_actor(self, payload):
        # kill(no_restart=False) is a crash-style kill: exit NONZERO so
        # the raylet's death report reads unintended and the GCS restart
        # FSM reschedules the actor (max_restarts permitting). A clean
        # exit(0) here would read as intended and strand the actor dead
        # regardless of its restart budget.
        code = 0 if payload.get("no_restart", True) else 1
        threading.Thread(
            target=lambda: (time.sleep(0.05), os._exit(code)), daemon=True
        ).start()
        return True

    async def _handle_cancel_task(self, payload):
        return self.executor.cancel(payload["task_id"], payload.get("force", False))

    async def _handle_exit(self, payload):
        threading.Thread(target=lambda: (time.sleep(0.05), os._exit(0)), daemon=True).start()
        return True

    async def _handle_ping(self, payload):
        return {"status": "ok", "worker_id": self.worker_id.hex(), "pid": os.getpid()}

    async def _handle_profile_cpu(self, payload):
        """Live CPU flamegraph sampling (reference: dashboard py-spy,
        profile_manager.py:83). Runs in a thread so the worker keeps
        serving RPCs while being sampled."""
        from ray_tpu_torch.util.profiling import sample_cpu_profile

        return await asyncio.to_thread(
            sample_cpu_profile,
            float(payload.get("duration_s", 5.0)),
            float(payload.get("interval_ms", 10.0)))

    async def _handle_profile_memory(self, payload):
        from ray_tpu_torch.util.profiling import heap_snapshot

        return await asyncio.to_thread(
            heap_snapshot, int(payload.get("top", 30)),
            bool(payload.get("stop", False)),
            float(payload.get("duration_s", 0.0)))

    async def _handle_profile_device(self, payload):
        """Device-plane phase reports: every DeviceStepProfiler
        registered in this worker (train step, decode wave) plus process
        compile/HBM telemetry — fanned out by the raylet for `ray-tpu
        profile --device` and merged with task-stage spans driver-side."""
        from ray_tpu_torch._private import device_profiler

        # to_thread like the cpu/memory handlers: the profiler's first
        # touch imports torch (seconds) — never on the RPC loop
        return await asyncio.to_thread(
            device_profiler.snapshot_all,
            int(payload.get("recent", 64)))

    async def _handle_memory_report(self, payload):
        """Cluster memory observability: this worker's full
        reference-table snapshot plus memory-store and paged-KV pool
        occupancy — fanned out by the raylet's node_memory_report for
        `ray-tpu memory` / get_cluster_memory. to_thread like the profile
        handlers: the snapshots take component locks and size whole
        payload tables, never on the RPC loop."""
        return await asyncio.to_thread(
            self.memory_report, bool((payload or {}).get("refs", True)))

    def memory_report(self, include_refs: bool = True) -> dict:
        """Memory-observability snapshot of THIS worker. include_refs=False
        is the cheap summary form (counts + store/KV occupancy only) for
        periodic samplers like the dashboard head."""
        from ray_tpu_torch._private import kv_registry

        now = time.time()
        report = {
            "worker_id": self.worker_id.hex(),
            "pid": os.getpid(),
            "mode": self.mode,
            "address": self.address_str,
            "node_id": self.node_id.hex() if self.node_id else None,
            "actor_id": (self.current_actor_id.hex()
                         if self.current_actor_id else None),
            "counts": self.reference_counter.summary(),
            "memory_store": {"objects": self.memory_store.size(),
                             "bytes": self.memory_store.total_bytes()},
            "kv": kv_registry.report_all(),
        }
        if not include_refs:
            return report
        snap = self.reference_counter.snapshot()
        refs = []
        for oid, ref in snap.items():
            entry = self.memory_store.get_entry(oid)
            size = ref.size_bytes
            if not size and entry is not None and entry.serialized is not None:
                size = entry.serialized.total_bytes()
            refs.append({
                "object_id": oid.hex(),
                "kind": "owned" if ref.owned else "borrowed",
                "local_refs": ref.local_refs,
                "submitted_task_refs": ref.submitted_task_refs,
                "pinned": ref.pinned,
                "borrowers": sorted(ref.borrowers),
                "owner_address": getattr(ref.owner_address, "rpc_address",
                                         None),
                "size_bytes": int(size),
                "age_s": max(0.0, now - ref.created_at),
                "location": ref.location,
                "in_plasma": bool(entry is not None and entry.in_plasma),
            })
        report["refs"] = refs
        # Store-resident entries with NO ref in this worker's table. The
        # memory store is process-private, so nothing can ever free an
        # unreferenced entry — the leak detector's orphan candidates.
        # Secondary/primary copies held for remote owners (the executor's
        # hold_secondary_copy) are tracked by the OWNER's ref table, not
        # ours: marked so the sweep checks them against the cluster union
        # instead of flagging them outright.
        unref = []
        for (oid, nbytes, created, in_plasma, freed,
             _is_exc) in self.memory_store.entries_snapshot():
            if freed or oid in snap:
                continue
            unref.append({
                "object_id": oid.hex(),
                "size_bytes": int(nbytes),
                "age_s": max(0.0, now - created),
                "in_plasma": bool(in_plasma),
                "secondary": oid in self._secondary_copies,
            })
        report["unreferenced_entries"] = unref
        return report

    # ---------------------------------------------- generator streaming (owner)
    async def _handle_report_generator_item(self, payload):
        task_id: TaskID = payload["task_id"]
        state = self._generators.get(task_id)
        if state is None:
            return False
        if payload.get("error"):
            with state.cv:
                state.error = payload["item"]["inline"] if payload.get("item") else None
                state.total = state.reported
                state.cv.notify_all()
            return True
        if payload.get("done"):
            self._finish_generator(task_id, payload["index"])
            return True
        index = payload["index"]
        oid = ObjectID.for_task_return(task_id, index + 1)
        # Own/store and publish under the stream's cv: release_generator
        # marks `released` under the same lock before freeing, so an item
        # report racing close() either lands before the release snapshot
        # (and is freed by it) or sees the flag and drops the item —
        # never an owned-but-orphaned object.
        with state.cv:
            if state.released:
                return False
            self.reference_counter.add_owned(oid, self.address)
            self._store_return(oid, payload["item"])
            state.reported = max(state.reported, index + 1)
            state.cv.notify_all()
        return True

    def _finish_generator(self, task_id: TaskID, total: int, error=None):
        state = self._generators.get(task_id)
        if state is None:
            return
        with state.cv:
            state.total = total
            if error is not None:
                state.error = error
            state.cv.notify_all()

    def next_generator_item(self, task_id: TaskID, consumed: int, timeout=None):
        """Blocking: returns the ObjectRef for item `consumed`, or None at end."""
        state = self._generators.get(task_id)
        if state is None:
            return None
        with state.cv:
            # End-of-stream requires total set AND all items reported: the
            # task-completion reply (which carries total) travels on a
            # different channel than item reports and may arrive first.
            state.cv.wait_for(
                lambda: state.reported > consumed
                or state.error is not None
                or (state.total is not None and state.reported >= state.total),
                timeout,
            )
            if state.reported > consumed:
                oid = ObjectID.for_task_return(task_id, consumed + 1)
                return ObjectRef(oid, owner_address=self.address)
            if state.error is not None:
                err, _ = ser.deserialize_with_refs(state.error)
                state.released = True
                reported = state.reported
                self._generators.pop(task_id, None)
                # items reported past the consumer's cursor were owned at
                # report time and have no other holder — free them, or an
                # errored/cancelled stream leaks them (same cleanup as
                # release_generator, for the next()-observes-error path)
                self._free_unconsumed_generator_items(
                    task_id, consumed, reported)
                self._raise_stored_error(err)
            self._generators.pop(task_id, None)
            return None

    def _free_unconsumed_generator_items(self, task_id: TaskID,
                                         consumed: int,
                                         reported: int) -> None:
        for index in range(consumed, reported):
            oid = ObjectID.for_task_return(task_id, index + 1)
            if self.reference_counter.owns(oid):
                self.reference_counter.add_local_ref(oid)
                self.reference_counter.remove_local_ref(oid)

    def release_generator(self, task_id: TaskID, consumed: int) -> None:
        """Drop an abandoned stream's owner-side state
        (ObjectRefGenerator.close): the _generators entry, plus the
        reported-but-unconsumed return objects — they were add_owned with
        zero local refs when the executor reported them, so nothing else
        will ever free them. A ref-pair bump routes through the reference
        counter's normal zero-count path (which also clears the memory
        store / plasma copy); items the consumer DID take stay alive
        through the consumer's own ObjectRef."""
        state = self._generators.pop(task_id, None)
        if state is None:
            return
        with state.cv:
            state.released = True  # in-flight item reports drop their item
            reported = state.reported
            if state.total is None:
                state.total = reported  # unblock any parked consumer
            state.cv.notify_all()
        self._free_unconsumed_generator_items(task_id, consumed, reported)

    def report_generator_item(self, spec: TaskSpec, index: int, item, done: bool,
                              error: bool = False):
        """Executor-side: stream one yielded item to the owner."""
        owner = spec.owner_address
        client = self._peers.get(owner.rpc_address)
        try:
            if _fi.PLAN is not None:
                # `mid_stream` lifecycle point: a chaos plan can kill/drop/
                # delay this worker between generator items — the replica-
                # dies-mid-decode scenario serve.llm failover is tested
                # against. Inside the try: an injected ConnectionLost must
                # take the SAME OwnerDiedError translation as a real
                # owner-connection failure, not surface as a novel
                # application error no production path can produce.
                act = _fi.intercept_sync(
                    _fi.SITE_MID_STREAM, method=spec.function_name,
                    label=self.mode, peer=owner.rpc_address)
                if act == "drop":
                    return  # this item report is lost in flight
            client.send(
                "report_generator_item",
                {"task_id": spec.task_id, "index": index, "item": item,
                 "done": done, "error": error},
            )
        except ConnectionLost:
            raise exc.OwnerDiedError(spec.task_id.hex())

    # --------------------------------------------------------- ref counting
    def register_deserialized_ref(self, ref: ObjectRef):
        oid = ref.object_id()
        owner = ref.owner_address
        first = self.reference_counter.add_borrowed(oid, owner)
        self.reference_counter.add_local_ref(oid)
        if first and owner is not None and owner.rpc_address != self.address_str:
            # Fire-and-forget: may run on the RPC loop thread mid-decode, so
            # it must never block on the loop.
            client = self._peers.get(owner.rpc_address)
            self._fire(
                client.send_async(
                    "add_borrower", {"object_id": oid, "borrower": self.address_str}
                )
            )

    def _notify_owner_release(self, oid: ObjectID, owner_address):
        self.memory_store.delete([oid])
        if owner_address is None or owner_address.rpc_address == self.address_str:
            return
        client = self._peers.get(owner_address.rpc_address)
        self._fire(
            client.send_async(
                "remove_borrower", {"object_id": oid, "borrower": self.address_str}
            )
        )

    def _free_owned_object(self, oid: ObjectID, locations):
        # Runs from arbitrary contexts — including ON the submission event
        # loop (ref drops in _on_task_reply when a task's last plasma arg
        # dies). Every outbound notification here must therefore be
        # fire-and-forget: one blocking raylet/peer RPC from the loop
        # thread wedges the entire actor-task transport (the long-poll
        # starvation bug this replaced).
        entry = self.memory_store.get_entry(oid)
        self.memory_store.delete([oid])
        if (entry is not None and entry.in_plasma and self.plasma is not None
                and (entry.plasma_node is None or self.node_id is None
                     or entry.plasma_node == self.node_id.hex())):
            self.plasma.free_local(oid)
            if self._raylet is not None:
                self._fire(self._raylet.send_async(
                    "free_spilled", {"object_ids": [oid]}))
        if isinstance(locations, str):  # tolerate old single-location form
            locations = [locations]
        for location in locations or []:
            if location == self.address_str:
                continue
            try:
                self._fire(self._peers.get(location).send_async(
                    "free_objects", {"object_ids": [oid]}))
            except ConnectionLost:
                pass

    def free_objects(self, refs: List[ObjectRef]):
        """Manual eviction (reference: internal_api.free)."""
        for ref in refs:
            oid = ref.object_id()
            locs = self.reference_counter.get_all_locations(oid)
            entry = self.memory_store.get_entry(oid)
            self.memory_store.mark_freed(oid)
            if (entry is not None and entry.in_plasma
                    and self.plasma is not None
                    and (entry.plasma_node is None or self.node_id is None
                         or entry.plasma_node == self.node_id.hex())):
                self.plasma.free(oid)
            for loc in locs:
                try:
                    self._peers.get(loc).send("free_objects", {"object_ids": [oid]})
                except ConnectionLost:
                    pass

    def hold_secondary_copy(self, oid: ObjectID):
        self._secondary_copies.add(oid)

    # ------------------------------------------------------------- executor glue
    def become_actor(self, creation: ActorCreationSpec):
        self.is_actor_worker = True
        self.current_actor_id = creation.actor_id
        # pin the actor's job as this process's own: submissions from
        # async-actor coroutines / user threads have no _task_ctx, and the
        # nil fallback would mis-attribute them (and escape job cleanup)
        self.job_id = creation.actor_id.job_id()
        self._gcs.call(
            "report_actor_alive",
            {"actor_id": creation.actor_id, "address": self.address, "pid": os.getpid()},
        )

    def exit_actor_process(self, intended: bool = True):
        # 1s margin so the terminating call's reply flushes before the hard
        # exit even on a loaded worker (matches max_calls retirement).
        threading.Thread(
            target=lambda: (time.sleep(1.0), os._exit(0 if intended else 1)),
            daemon=True,
        ).start()

    # ------------------------------------------------------------ futures API
    def as_future(self, ref: ObjectRef):
        import concurrent.futures

        fut: concurrent.futures.Future = concurrent.futures.Future()

        def _resolve():
            try:
                fut.set_result(self.get([ref])[0])
            except BaseException as e:  # noqa: BLE001
                fut.set_exception(e)

        threading.Thread(target=_resolve, daemon=True).start()
        return fut

    def as_asyncio_future(self, ref: ObjectRef):
        loop = asyncio.get_event_loop()
        afut = loop.create_future()

        def _resolve():
            try:
                value = self.get([ref])[0]
                loop.call_soon_threadsafe(
                    lambda: afut.set_result(value) if not afut.done() else None
                )
            except BaseException as e:  # noqa: BLE001
                loop.call_soon_threadsafe(
                    lambda: afut.set_exception(e) if not afut.done() else None
                )

        threading.Thread(target=_resolve, daemon=True).start()
        return afut

    def on_completed(self, ref: ObjectRef, callback):
        def _cb(entry):
            callback(ref)

        self.memory_store.add_callback(ref.object_id(), _cb)

    # ------------------------------------------------------------ task events
    def _record_task_event(self, spec: TaskSpec, state: str,
                           stages: Optional[dict] = None):
        # Hot path (2+ calls per task): append a small tuple of scalars —
        # NOT the spec itself, which pins inline arg payloads (up to 100KB
        # each) for the life of the bounded deque. Dict formatting happens
        # once per flush batch in _flush_task_events. `stages` rides only
        # on terminal events (the per-stage latency breakdown).
        # raylint: disable=cross-domain-mutation — lock-free SPSC deque:
        # deque.append/popleft are atomic, producers append here from any
        # thread, and the flusher daemon is the ONLY consumer (popleft in
        # _format_task_events) — the documented threading-free pattern
        self._task_events.append(
            (spec.task_id, spec.function_name, spec.task_type.name,
             spec.job_id, state, time.time(), spec.trace_parent, stages,
             self._spec_trace_id(spec)))
        ev = self._task_events_wakeup
        if ev is not None:
            ev.set()  # plain threading.Event: no loop interaction here

    def _task_event_flush_loop(self):
        """Daemon flusher thread: the RPC loop's only involvement is the
        actual send coroutine — formatting a 1s batch (thousands of dict
        builds at serving rates) happens HERE, off the loop, where it
        used to stall every in-flight reply for milliseconds once per
        second (the r05 HTTP p99 regression)."""
        ev = self._task_events_wakeup
        while not self._shutdown:
            if not self._task_events:
                ev.wait()  # idle workers: zero periodic wakeups
            ev.clear()
            if self._shutdown:
                return
            time.sleep(1.0)  # batch window (same flush latency)
            self._flush_task_events_sync()

    def _format_task_events(self, limit: int = 5000) -> list:
        """Drain up to `limit` raw task-event tuples into wire dicts
        (flusher thread / teardown only — never the RPC loop)."""
        node = self.node_id.hex() if self.node_id else None
        worker = self.worker_id.hex()
        events = []
        while self._task_events and len(events) < limit:
            task_id, name, type_name, job_id, state, ts, parent, \
                stages, trace_id = self._task_events.popleft()
            ev = {
                "task_id": task_id.hex(),
                "name": name,
                "type": type_name,
                "state": state,
                "parent": parent,
                "job_id": job_id.hex() if job_id else None,
                "node": node,
                "worker_id": worker,
                "time": ts,
                "trace_id": trace_id,
            }
            if stages is not None:
                ev["stages"] = stages
            events.append(ev)
        return events

    def _flush_task_events_sync(self, deadline_s: float = 10.0):
        # Drain FULLY in 5000-event sends: a single capped send per second
        # falls behind batched submission rates (>5k events/s) and the
        # bounded deque would silently drop the overflow.
        deadline = time.monotonic() + deadline_s
        while self._task_events:
            events = self._format_task_events()
            if not events:
                return
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return
            coro = self._gcs.send_async(
                "add_task_events", {"events": events})
            try:
                self._lt.submit(coro).result(timeout=remaining)
            # NB: Future.result raises concurrent.futures.TimeoutError,
            # which is NOT the builtin TimeoutError until Python 3.11 —
            # catching only the builtin would kill the flusher thread on
            # the first slow GCS send
            except (ConnectionLost, OSError, TimeoutError,
                    concurrent.futures.TimeoutError):
                return
            except RuntimeError:  # loop closed mid-teardown
                coro.close()  # suppress the never-awaited warning
                return


class _RetryGet(Exception):
    pass
