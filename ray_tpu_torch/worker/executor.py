"""Task/actor execution inside a worker process.

Role of the reference's execution half of CoreWorker
(ray: src/ray/core_worker/core_worker.cc:2883 ExecuteTask, :3455
HandlePushTask; Python callback _raylet.pyx:2253 task_execution_handler) plus
the server-side actor scheduling queues
(transport/actor_scheduling_queue.cc — per-caller sequence-number ordering —
and concurrency_group_manager.cc for async/threaded actors).

Returns policy (matches the reference): small results are inlined in the
PushTaskReply back to the owner; large results stay in this worker's store and
the reply carries a location marker. Streaming-generator items are reported to
the owner one by one (report_generator_item) as they are yielded.
"""

from __future__ import annotations

import asyncio
import ctypes
import logging
import os
import threading
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch._private import backoff as _backoff
from ray_tpu_torch._private import deadlines as _deadlines
from ray_tpu_torch._private import tracing as _tracing
from ray_tpu_torch._private.config import CONFIG
from ray_tpu_torch._private.ids import ActorID, ObjectID, TaskID
from ray_tpu_torch._private import serialization as ser
from ray_tpu_torch._private.specs import Address, TaskArg, TaskSpec, TaskType
from ray_tpu_torch.exceptions import (
    AsyncioActorExit,
    DeadlineExceededError,
    RayTaskError,
    TaskCancelledError,
)

logger = logging.getLogger(__name__)


def _async_raise(thread_id: int, exc_type) -> bool:
    """Inject an exception into a running thread (cancellation support,
    mirrors the reference's cancellation-by-KeyboardInterrupt in
    _raylet.pyx execute_task_with_cancellation_handler)."""
    res = ctypes.pythonapi.PyThreadState_SetAsyncExc(
        ctypes.c_ulong(thread_id), ctypes.py_object(exc_type)
    )
    return res == 1


class _SequencingGate:
    """Starts actor tasks in per-caller sequence order."""

    def __init__(self):
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._next_seq: Dict[bytes, int] = {}

    def wait_turn(self, caller: bytes, seq: int):
        with self._cv:
            expected = self._next_seq.setdefault(caller, 0)
            if seq < expected:
                return  # replay after restart; let it run
            self._cv.wait_for(lambda: self._next_seq.get(caller, 0) >= seq, timeout=60)

    def advance(self, caller: bytes, seq: int):
        with self._cv:
            cur = self._next_seq.setdefault(caller, 0)
            if seq + 1 > cur:
                self._next_seq[caller] = seq + 1
            self._cv.notify_all()


class Executor:
    def __init__(self, core_worker):
        self.cw = core_worker
        self._fn_cache: Dict[str, Any] = {}
        self._pool = ThreadPoolExecutor(max_workers=256, thread_name_prefix="rt-exec")
        self.actor_instance: Any = None
        self.actor_id: Optional[ActorID] = None
        self._actor_spec = None
        self._seq_gate = _SequencingGate()
        self._actor_semaphore: Optional[threading.Semaphore] = None
        self._async_loop: Optional[asyncio.AbstractEventLoop] = None
        self._running_threads: Dict[TaskID, int] = {}  # task -> thread ident
        self._cancelled: set = set()
        self._calls_by_function: Dict[str, int] = {}  # max_calls counting
        self._recycle_lock = threading.Lock()  # guards the 2 fields above/below:
        # the executor pool has many threads; even though leases serialize
        # tasks one-at-a-time today, the retire bookkeeping must not depend
        # on that implicit invariant.
        self._retiring = False  # set when max_calls is reached
        # Per-TASK retire flag: thread-local, NOT an instance field — with a
        # shared field a concurrent max_calls=0 task could clobber the flag
        # between this task's pre-execution set and its return packaging.
        self._task_tls = threading.local()

    # ------------------------------------------------------------------ entry
    async def execute(self, spec: TaskSpec) -> dict:
        """Run on the worker's RPC loop; dispatches to a thread and returns
        the PushTaskReply payload."""
        loop = asyncio.get_event_loop()
        if spec.task_type == TaskType.ACTOR_TASK:
            return await loop.run_in_executor(self._pool, self._run_actor_task, spec)
        if spec.task_type == TaskType.ACTOR_CREATION_TASK:
            return await loop.run_in_executor(self._pool, self._run_actor_creation, spec)
        reply = await loop.run_in_executor(
            self._pool, self._run_normal_task, spec)
        if self._retiring:
            # tell the owner to drop this lease (max_calls recycling)
            reply["worker_retiring"] = True
        return reply

    def execute_batch_sync(self, specs) -> list:
        """Blocking batch execution for owner-batched normal-task pushes —
        runs in ONE thread-pool job (an event-loop hop per task would cost
        more than a noop task itself). Returns one reply per spec; specs
        after a worker-retiring task are returned {"not_run": True}."""
        replies = []
        retired = False
        for spec in specs:
            if retired:
                replies.append({"not_run": True})
                continue
            reply = self._run_normal_task(spec)
            if self._retiring:
                reply["worker_retiring"] = True
                retired = True
            replies.append(reply)
        return replies

    def execute_actor_batch_sync(self, specs) -> list:
        """Blocking batch execution for owner-batched ORDERED actor calls:
        they serialize on the sequencing gate regardless, so one pool job
        running them in seq order avoids a loop+thread hop per call."""
        return [self._run_actor_task(spec) for spec in specs]

    def cancel(self, task_id: TaskID, force: bool) -> bool:
        self._cancelled.add(task_id)
        ident = self._running_threads.get(task_id)
        if ident is not None:
            return _async_raise(ident, TaskCancelledError)
        return True

    # ---------------------------------------------------------------- helpers
    def _load_function(self, function_id: str, blob=None):
        fn = self._fn_cache.get(function_id)
        if fn is None:
            data = (blob if blob is not None
                    else self.cw.kv_get(b"fun:" + function_id.encode()))
            if data is None:
                raise RuntimeError(f"function {function_id} not found in GCS")
            fn = ser.loads_function(data)
            self._fn_cache[function_id] = fn
        return fn

    def _resolve_args(
        self, args: List[TaskArg], kwargs: Dict[str, TaskArg]
    ) -> Tuple[list, dict]:
        # Gather by-reference args and fetch them in one batch.
        ref_ids, ref_owners = [], []
        for a in list(args) + list(kwargs.values()):
            if not a.is_inline:
                ref_ids.append(a.object_id)
                ref_owners.append(a.owner_address)
        fetched = {}
        if ref_ids:
            values = self.cw.get_objects_by_id(ref_ids, ref_owners, timeout=None)
            fetched = dict(zip(ref_ids, values))

        def materialize(a: TaskArg):
            if a.is_inline:
                value, _refs = ser.deserialize_with_refs(a.data)
                return value
            return fetched[a.object_id]

        return [materialize(a) for a in args], {
            k: materialize(a) for k, a in kwargs.items()
        }

    def _package_returns(
        self, spec: TaskSpec, result: Any
    ) -> List[Tuple[ObjectID, dict]]:
        return_ids = spec.return_ids()
        if spec.num_returns <= 1:
            values = [result]
        else:
            values = list(result)
            if len(values) != spec.num_returns:
                raise ValueError(
                    f"task {spec.function_name} declared num_returns="
                    f"{spec.num_returns} but returned {len(values)} values"
                )
        out = []
        for oid, value in zip(return_ids, values):
            out.append((oid, self._package_value(
                oid, value, recipient=spec.owner_address)))
        return out

    def _pre_register_return_borrows(self, s, recipient) -> None:
        """Close the return-borrow race: an ObjectRef serialized into a
        RETURN value loses its last local ref the moment the task frame
        exits, and the recipient's eager one-way add_borrower may arrive
        AFTER this (owner) worker already freed the object — a borrowed
        ref from a task return would then be flaky by design. Registering
        the recipient as a borrower HERE, synchronously, before the value
        leaves the process, keeps every contained owned ref alive until
        the recipient releases it (remove_borrower on its last local ref)
        or dies (the owner drops dead borrowers wholesale). A recipient
        that never deserializes the value holds the borrow until death —
        the price of not piggybacking registration on replies like the
        reference does.

        Refs this worker merely BORROWS (forwarding: a queue actor
        handing an owned-elsewhere ref onward) have the same race one
        hop removed — this worker's own borrow is released by GC the
        moment the value leaves its heap, and the owner may free before
        the recipient's async registration lands. For those this worker
        PINS the ref with an extra local ref (extending its own borrow,
        which the owner already honors) and registers the recipient
        asynchronously; the pin is released only when that registration
        completes, so the owner always sees add(recipient) strictly
        before remove(this worker) — without ever blocking reply
        packaging on a possibly-hung owner (a partitioned owner must
        not stall every reply this actor sends)."""
        if recipient is None or not s.contained_refs:
            return
        addr = getattr(recipient, "rpc_address", None)
        if addr is None or addr == self.cw.address.rpc_address:
            return  # self-call: local refcounts already cover it
        for ref in s.contained_refs:
            oid = ref.object_id()
            if self.cw.reference_counter.owns(oid):
                self.cw.reference_counter.add_borrower(oid, addr)
                continue
            owner = ref.owner_address
            owner_addr = getattr(owner, "rpc_address", None)
            if owner_addr is None or owner_addr in (
                    addr, self.cw.address.rpc_address):
                # unknown owner (the ref is doomed regardless), the
                # recipient IS the owner (its local counts cover it), or
                # a self-owned ref already handled above
                continue
            self._register_forward_borrow(oid, owner_addr, addr)

    def _register_forward_borrow(self, oid: ObjectID, owner_addr: str,
                                 borrower_addr: str) -> None:
        """Pin `oid` locally, register `borrower_addr` with the owner
        async, release the pin when the registration settles (success or
        failure — a dead owner means the ref is already doomed)."""
        rc = self.cw.reference_counter
        rc.add_local_ref(oid)

        def _release(fut):
            try:
                fut.result()
            except Exception:  # noqa: BLE001 — owner gone: ref doomed
                logger.debug("forward-borrow registration with %s failed "
                             "for %s", owner_addr, oid.hex(), exc_info=True)
            rc.remove_local_ref(oid)

        try:
            client = self.cw._peers.get(owner_addr)
            fut = asyncio.run_coroutine_threadsafe(
                client.call_async("add_borrower",
                                  {"object_id": oid,
                                   "borrower": borrower_addr},
                                  timeout=30.0),
                self.cw._lt.loop)
            fut.add_done_callback(_release)
        except Exception:  # noqa: BLE001 — loop shutting down
            rc.remove_local_ref(oid)
            logger.debug("forward-borrow registration submit failed "
                         "for %s", oid.hex(), exc_info=True)

    def _attach_retained_borrows(self, spec: TaskSpec, reply: dict) -> None:
        """The other half of the borrow protocol, for ARGS: a ref nested
        in a task argument whose owner is the SUBMITTER races the same
        way returns do — the submitter's frame-exit free (its local ref
        plus the submitted-task pin both drop when this reply lands) can
        beat this worker's eager first-contact add_borrower. The reply
        therefore reports every nested arg ref this worker RETAINED
        (e.g. a sample-queue actor that stored the entry), and the owner
        registers the borrow synchronously BEFORE releasing its pins
        (core_worker._register_reply_borrows). A ref retained here but
        dropped later is cleaned by the normal remove_borrower path."""
        kwarg_specs = getattr(spec, "kwarg_specs", {}) or {}
        nested = [nid
                  for a in list(spec.args) + list(kwarg_specs.values())
                  for nid in a.nested_ids]
        if not nested:
            return
        owner_addr = getattr(spec.owner_address, "rpc_address", None)
        if owner_addr is None or owner_addr == self.cw.address.rpc_address:
            return  # self-call: local refcounts already cover it
        held = [oid for oid in nested
                if self.cw.reference_counter.holds_borrow(oid)]
        if held:
            reply["retained_borrows"] = held
            reply["borrower_address"] = self.cw.address.rpc_address

    def _package_value(self, oid: ObjectID, value: Any,
                       recipient=None) -> dict:
        s = ser.serialize(value)
        self._pre_register_return_borrows(s, recipient)
        if s.total_bytes() <= CONFIG.max_direct_call_object_size:
            return {"inline": s}
        # Keep the primary copy on this node; the owner records the location.
        # Preferred home is the node shm store (same-node readers map it
        # zero-copy; the raylet can spill it); fall back to this worker's
        # memory store when the shm store is absent/full.
        plasma_node = None
        if (self.cw.plasma is not None
                and self.cw.plasma.put_serialized(oid, s, primary=True)):
            plasma_node = self.cw.node_id.hex() if self.cw.node_id else ""
            self.cw.memory_store.put_serialized(
                oid, None, value=value, in_plasma=True,
                plasma_node=plasma_node)
        elif getattr(self._task_tls, "will_retire", False):
            # max_calls: this worker exits right after the reply — a
            # memory-store primary copy would die with it, so ship the
            # value inline (the shm store, when available above, survives
            # the worker: it lives in the raylet).
            return {"inline": s}
        else:
            self.cw.memory_store.put_serialized(oid, s, value=value)
        self.cw.hold_secondary_copy(oid)
        return {"location": self.cw.address.rpc_address,
                "plasma_node": plasma_node, "size": s.total_bytes()}

    def _deadline_reply(self, spec: TaskSpec) -> dict:
        """Queue-pop doomed-work elimination on the worker: the spec's
        deadline passed while it waited for this thread (sequencing gate,
        concurrency semaphore, pool backlog). The caller gets a typed
        DeadlineExceededError; no ERROR-channel broadcast — an expired
        deadline is the caller's own budget, not an application fault."""
        trace_id = _tracing.trace_id_of(spec)
        self.cw._elog.emit(
            "task.deadline_expired", task_id=spec.task_id.hex(),
            trace_id=trace_id, layer="worker",
            function=spec.function_name)
        _backoff.count_deadline_expired("worker")
        _tracing.force_trace(trace_id, "task.deadline_expired:worker")
        err = DeadlineExceededError(
            f"deadline for {spec.function_name} passed before execution "
            "started", layer="worker", deadline=spec.deadline_s)
        return {
            "status": "error",
            "error_str": str(err),
            "is_application_error": True,
            "error": ser.serialize(err),
            "return_ids": spec.return_ids(),
        }

    def _error_reply(self, spec: TaskSpec, exc: BaseException) -> dict:
        if spec.trace_ctx is not None:
            # tail-keep from the failing side too: generator errors reach
            # the owner via item reports, not this reply
            _tracing.force_trace(spec.trace_ctx[0],
                                 f"task_error:{type(exc).__name__}")
        if isinstance(exc, RayTaskError):
            err = exc
        else:
            err = RayTaskError.from_exception(spec.function_name, exc)
        # stream the failure to subscribed drivers (ERROR pubsub channel) —
        # fire-and-forget, the reply below is the authoritative path
        self.cw.report_error(spec, exc)
        s = ser.serialize(err)
        return {
            "status": "error",
            "error_str": str(exc),
            "is_application_error": True,
            "error": s,
            "return_ids": spec.return_ids(),
        }

    # ---------------------------------------------------------- normal tasks
    def _run_normal_task(self, spec: TaskSpec) -> dict:
        t0 = time.monotonic()
        reply = self._run_normal_task_inner(spec)
        self._attach_retained_borrows(spec, reply)
        # worker-measured execution time: the owner's push-batching gate
        # needs task duration EXCLUDING network RTT (an RTT-inclusive
        # sample would lock remote owners out of batching forever)
        reply["exec_s"] = time.monotonic() - t0
        # when this pool thread picked the task up — the push handler
        # turns it into the 'dispatch' stage of the latency breakdown
        reply.setdefault("_rt_exec_started", t0)
        return reply

    def _run_normal_task_inner(self, spec: TaskSpec) -> dict:
        if spec.task_id in self._cancelled:
            return {
                "status": "cancelled",
                "return_ids": spec.return_ids(),
            }
        if _deadlines.expired(spec.deadline_s):
            return self._deadline_reply(spec)
        token = self.cw.enter_task_context(spec)
        self._running_threads[spec.task_id] = threading.get_ident()
        limit = getattr(spec, "max_calls", 0)
        with self._recycle_lock:
            # CLAIM the call slot now (not at completion): two concurrent
            # tasks of a max_calls=N function must not both read the same
            # pre-increment count, or the one that actually reaches the
            # limit would skip the inline-return path below and lose its
            # result when the worker exits. Packaging uses the flag to avoid
            # leaving a primary copy in the about-to-exit memory store.
            n = self._calls_by_function.get(spec.function_id, 0) + 1
            self._calls_by_function[spec.function_id] = n
            self._task_tls.will_retire = bool(limit) and n >= limit
        try:
            fn = self._load_function(spec.function_id)
            args, kwargs = self._resolve_args(spec.args, getattr(spec, "kwarg_specs", {}) or {})
            if spec.is_streaming_generator():
                return self._run_generator(spec, fn, args, kwargs)
            fn_t0 = time.monotonic()
            result = fn(*args, **kwargs)
            fn_s = time.monotonic() - fn_t0
            return {"status": "ok", "_rt_fn_s": fn_s,
                    "returns": self._package_returns(spec, result)}
        except TaskCancelledError:
            return {"status": "cancelled", "return_ids": spec.return_ids()}
        except BaseException as e:  # noqa: BLE001 — errors are data here
            return self._error_reply(spec, e)
        finally:
            self._running_threads.pop(spec.task_id, None)
            self.cw.exit_task_context(token)
            self._maybe_recycle_worker(spec)

    def _maybe_recycle_worker(self, spec: TaskSpec) -> None:
        """max_calls worker recycling (reference: @ray.remote(max_calls=) —
        the worker exits after N executions of the function, e.g. to release
        leaked memory/accelerator state; the raylet spawns a fresh one)."""
        limit = getattr(spec, "max_calls", 0)
        if not limit:
            return
        with self._recycle_lock:
            # the call slot was already claimed pre-execution; the tls flag
            # says whether THIS task was the one that reached the limit
            if not getattr(self._task_tls, "will_retire", False) \
                    or self._retiring:
                return
            self._retiring = True  # reply carries worker_retiring (execute)
        logger.info("worker reached max_calls=%d for %s; exiting",
                    limit, spec.function_name)
        # Delayed exit so the in-flight task reply flushes first (the
        # reply is small — large returns go to the shm store, see
        # _package_value — so 1s is orders of magnitude above local
        # socket flush time). The owner drops the lease on seeing the
        # flag, so no new task races the exit.
        threading.Thread(
            target=lambda: (time.sleep(1.0), os._exit(0)),
            daemon=True,
        ).start()

    def _run_generator(self, spec: TaskSpec, fn, args, kwargs) -> dict:
        """Streaming generator: report each item to the owner as produced."""
        gen = None
        trace_ctx = spec.trace_ctx
        span_cap = CONFIG.trace_max_stream_spans if trace_ctx is not None \
            else 0
        try:
            gen = fn(*args, **kwargs)
            index = 0
            t_prev = time.time() if trace_ctx is not None else 0.0
            for item in gen:
                oid = ObjectID.for_task_return(spec.task_id, index + 1)
                payload = self._package_value(
                    oid, item, recipient=spec.owner_address)
                self.cw.report_generator_item(spec, index, payload, done=False)
                if index < span_cap:
                    # per-chunk spans (decode steps for serve.llm): each
                    # covers produce->reported; capped — a long stream's
                    # tail adds volume, not shape
                    t_now = time.time()
                    _tracing.record_span(
                        "task.stream_item", trace_ctx, t_prev, t_now,
                        attrs={"task_id": spec.task_id.hex(),
                               "index": index})
                    t_prev = t_now
                index += 1
            self.cw.report_generator_item(spec, index, None, done=True)
            return {"status": "ok", "returns": [], "streaming_num_items": index}
        except TaskCancelledError:
            # consumer-initiated close (ObjectRefGenerator.close →
            # cancel_task): not an application error — no ERROR-channel
            # broadcast, a plain cancelled reply. Still finish the stream
            # so any racing next_generator_item waiter wakes.
            err = RayTaskError.from_exception(
                spec.function_name, TaskCancelledError(spec.task_id))
            self.cw.report_generator_item(
                spec, -1, {"inline": ser.serialize(err)}, done=True, error=True
            )
            return {"status": "cancelled", "return_ids": spec.return_ids()}
        except BaseException as e:  # noqa: BLE001
            err = RayTaskError.from_exception(spec.function_name, e)
            oid = ObjectID.for_task_return(spec.task_id, 1)
            self.cw.report_generator_item(
                spec, -1, {"inline": ser.serialize(err)}, done=True, error=True
            )
            return self._error_reply(spec, e)
        finally:
            # Cancellation can land between yields (the injected
            # TaskCancelledError hits report_generator_item, not the user
            # frame): close the user generator EXPLICITLY so its cleanup
            # (e.g. an LLM engine releasing the request's slot) runs now,
            # not at a GC of unknown timing.
            close = getattr(gen, "close", None)
            if close is not None:
                try:
                    close()
                except Exception:  # noqa: BLE001 — teardown must not mask
                    logger.debug("generator close failed", exc_info=True)

    # ---------------------------------------------------------------- actors
    def _run_actor_creation(self, spec: TaskSpec) -> dict:
        # companion lines to the ctor phases (core_worker.__init__): the
        # cpu delta start→created is the creation-task execution cost; the
        # ctor-phases→start gap is main-loop bring-up + task receive
        from ray_tpu_torch._private.spawn_diag import spawn_timing_write

        spawn_timing_write("creation_start")
        token = self.cw.enter_task_context(spec)
        try:
            creation = spec.actor_creation
            cls = self._load_function(spec.function_id,
                                      getattr(spec, 'function_blob', None))
            args, kwargs = self._resolve_args(spec.args, getattr(spec, "kwarg_specs", {}) or {})
            self.actor_instance = cls(*args, **kwargs)
            self.actor_id = creation.actor_id
            self._actor_spec = creation
            if creation.max_concurrency > 1 or creation.is_asyncio:
                self._actor_semaphore = threading.Semaphore(creation.max_concurrency)
            if creation.is_asyncio:
                self._start_async_loop()
            self.cw.become_actor(creation)
            spawn_timing_write("created")
            return {"status": "ok", "returns": []}
        except BaseException as e:  # noqa: BLE001
            return self._error_reply(spec, e)
        finally:
            self.cw.exit_task_context(token)

    def _start_async_loop(self):
        loop = asyncio.new_event_loop()
        self._async_loop = loop
        t = threading.Thread(target=loop.run_forever, name="rt-actor-asyncio", daemon=True)
        t.start()

    def _run_actor_task(self, spec: TaskSpec) -> dict:
        if spec.method_name == "__ray_terminate__":
            self.cw.exit_actor_process(intended=True)
            return {"status": "ok", "returns": []}
        if spec.method_name == "__rt_pipeline_loop__":
            # Compiled-DAG stage loop (dag/compiled_channels.py): args are
            # (loop_fn, *loop_args); the loop gets the LIVE actor instance
            # and runs until its channels close. It occupies the actor's
            # ordered queue on purpose — a compiled pipeline dedicates its
            # actors (reference: compiled_dag_node.py actor loops).
            token = self.cw.enter_task_context(spec)
            try:
                if self.actor_instance is None:
                    raise RuntimeError("actor instance not initialized")
                args, kwargs = self._resolve_args(
                    spec.args, getattr(spec, "kwarg_specs", {}) or {})
                result = args[0](self.actor_instance, *args[1:], **kwargs)
                return {"status": "ok",
                        "returns": self._package_returns(spec, result)}
            except BaseException as e:  # noqa: BLE001
                return self._error_reply(spec, e)
            finally:
                self.cw.exit_task_context(token)
        caller = spec.owner_address.worker_id.binary() if spec.owner_address else b""
        creation = self._actor_spec
        ordered = creation is None or (
            creation.max_concurrency <= 1 and not creation.is_asyncio
        )
        if ordered:
            self._seq_gate.wait_turn(caller, spec.sequence_number)
        # execution time EXCLUDING the gate wait, reported to the owner:
        # its push batcher must classify methods by what they actually
        # cost, not by how long they queued behind earlier calls
        exec_started = time.monotonic()
        reply = self._run_actor_body(spec, caller, ordered)
        if isinstance(reply, dict):
            self._attach_retained_borrows(spec, reply)
            reply["exec_s"] = time.monotonic() - exec_started
            # dispatch stage = recv -> here; for ordered actors that
            # includes the sequencing-gate wait, which IS dispatch queueing
            reply.setdefault("_rt_exec_started", exec_started)
        return reply

    def _run_actor_body(self, spec: TaskSpec, caller: bytes,
                        ordered: bool) -> dict:
        try:
            if self.actor_instance is None:
                raise RuntimeError("actor instance not initialized")
            method = getattr(self.actor_instance, spec.method_name)
            token = self.cw.enter_task_context(spec)
            self._running_threads[spec.task_id] = threading.get_ident()
            if self._actor_semaphore is not None:
                self._actor_semaphore.acquire()
            try:
                if _deadlines.expired(spec.deadline_s):
                    # queue-pop drop AFTER the sequencing-gate/semaphore
                    # wait (that wait IS the actor's dispatch queue); the
                    # finally blocks still advance the gate, so a dropped
                    # call can't wedge later sequence numbers
                    return self._deadline_reply(spec)
                args, kwargs = self._resolve_args(
                    spec.args, getattr(spec, "kwarg_specs", {}) or {}
                )
                if spec.is_streaming_generator():
                    return self._run_generator(spec, method, args, kwargs)
                if self._async_loop is not None and asyncio.iscoroutinefunction(method):
                    fut = asyncio.run_coroutine_threadsafe(
                        method(*args, **kwargs), self._async_loop
                    )
                    result = fut.result()
                else:
                    result = method(*args, **kwargs)
                return {"status": "ok", "returns": self._package_returns(spec, result)}
            finally:
                if self._actor_semaphore is not None:
                    self._actor_semaphore.release()
                self._running_threads.pop(spec.task_id, None)
                self.cw.exit_task_context(token)
        except (AsyncioActorExit, SystemExit):
            self.cw.exit_actor_process(intended=True)
            # resolve the terminating call's ref(s) with None — empty
            # returns would leave the caller's get() hanging forever
            if spec.is_streaming_generator():
                return {"status": "ok", "returns": [],
                        "streaming_num_items": 0}
            n = max(spec.num_returns, 1)
            value = None if spec.num_returns <= 1 else tuple([None] * n)
            return {"status": "ok",
                    "returns": self._package_returns(spec, value)}
        except TaskCancelledError:
            return {"status": "cancelled", "return_ids": spec.return_ids()}
        except BaseException as e:  # noqa: BLE001
            return self._error_reply(spec, e)
        finally:
            if ordered:
                self._seq_gate.advance(caller, spec.sequence_number)

    def shutdown(self):
        self._pool.shutdown(wait=False, cancel_futures=True)
        if self._async_loop is not None:
            self._async_loop.call_soon_threadsafe(self._async_loop.stop)
