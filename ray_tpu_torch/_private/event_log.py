"""Cluster-wide structured lifecycle event log + crash flight recorder.

Reference capability: the per-worker bounded, drop-counting TaskEventBuffer
feeding the GCS task manager (ray: src/ray/core_worker/task_event_buffer.h:206
-> gcs_task_manager.cc) — the pipeline behind `ray list tasks`, timelines and
post-mortem debugging. Here the same substrate is generalized beyond task
state: every lifecycle DECISION in the system (task retry-FSM verdicts,
lease/dispatch outcomes, actor FSM transitions and restart decisions, object
spill/restore/reconstruction, chaos-rule firings, recovery choices) is one
structured record in a per-process bounded ring buffer, flushed asynchronously
to the GCS event manager (gcs/server.py GcsEventManager) for cluster-wide
queries.

Design constraints:

* NEVER block the emitting thread — `emit()` is a seq bump + two deque
  appends under a lock held for nanoseconds. The flusher is a daemon
  thread; a slow or dead sink backs events up into a bounded pending
  queue whose overflow is COUNTED (`ray_tpu_events_dropped_total`),
  never waited on.
* ZERO transport coupling — rpc.py does not know this module exists (the
  raw echo RTT is unchanged); components wire their own sink
  (GCS: direct append; raylet/worker: batched `add_cluster_events` RPC).
* POST-MORTEM FIRST — the ring buffer holds the last N events even after
  they were flushed, so the flight recorder (signal/atexit/excepthook, and
  the chaos `kill` action) can dump a process's final moments to the
  session dir; `ray-tpu debug postmortem` merges per-process dumps plus
  the GCS event log into one causally ordered cluster timeline.

Every record:

    {"seq": <per-process counter>, "pid": ..., "proc": "raylet:ab12..",
     "time": <wall>, "mono": <monotonic>, "type": "actor.restarting",
     "task_id"/"actor_id"/"node_id"/"object_id": <hex or None>,
     "data": {<schema fields>}}

Ordering across processes is by (time, pid, seq): wall clocks order the
inter-process happens-before edges (every cross-process edge in this system
is an RPC that takes far longer than host clock skew on one node), and
`seq` gives exact intra-process order even within one clock tick.

Event types and their required data fields live in EVENT_SCHEMAS; the
golden corpus tests/event_schema_golden.json pins them so drift fails
loudly (see tests/test_event_log.py, `python -m tests.test_event_log`
regenerates). New FSM transitions / recovery decisions MUST emit here —
enforced by raylint RTL006 (fsm-transition-event).
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

# ---------------------------------------------------------------- schemas

# type -> required data-field names. The contract the golden corpus pins:
# renaming a type or dropping a field is an API break for every consumer
# of the event log (state API, postmortem, dashboards, chaos audit).
EVENT_SCHEMAS: Dict[str, Tuple[str, ...]] = {
    # owner-side task retry FSM (core_worker)
    "task.retry": ("reason", "attempt", "retries_left"),
    "task.giveup": ("reason",),
    # overload protection: work refused by a bounded queue with
    # typed pushback (layer = raylet | gcs_actor_creation | actor_mailbox
    # | serve), vs doomed work dropped at queue-pop because its deadline
    # passed (layer = owner | raylet | worker). Shed work was never
    # accepted; expired work is resolved with DeadlineExceededError.
    "task.shed": ("layer", "reason"),
    "task.deadline_expired": ("layer",),
    # raylet lease/dispatch decisions
    "lease.grant": ("function", "worker_id"),
    "lease.reject": ("function", "reason"),
    "lease.spillback": ("function", "target"),
    # GCS actor FSM + restart decisions (gcs/actor_manager)
    "actor.pending": ("class_name",),
    "actor.alive": ("address", "restarts"),
    "actor.restarting": ("reason", "restarts"),
    "actor.dead": ("reason",),
    # owner-side actor client record transitions (core_worker)
    "actor.client_state": ("state", "reason"),
    # raylet worker-pool handle FSM + death recovery decision
    "worker.state": ("state", "worker_id"),
    "worker.death_report": ("intended", "reason"),
    # object lifecycle (spill/restore/reconstruction)
    "object.spill": ("uri",),
    "object.restore": ("uri",),
    "object.reconstruct": ("function",),
    # memory observability: leak-sweep verdicts and arena pressure
    "object.leak_suspect": ("kind", "size_bytes", "age_s", "owner", "holder"),
    "memory.pressure": ("used_bytes", "capacity_bytes", "frac"),
    # node membership + drain
    "node.alive": ("address",),
    "node.dead": ("expected",),
    "node.drain": ("reason",),
    # preemptible-TPU advance notice: announced node loss with a
    # deadline-carrying drain window (gangs checkpoint-and-drain, serve
    # replicas deregister-then-drain) — the injection anchor every
    # preemption-drill SLO timeline starts from (drills/slo.py)
    "node.preempt_notice": ("deadline_s", "reason"),
    # a training gang observed a preempt notice and is checkpointing +
    # unwinding so the trainer reschedules it onto a fresh placement group
    "gang.checkpoint_drain": ("reason", "world_size"),
    # chaos drills (ray_tpu_torch.drills): run markers + verdicts. drill.phase
    # records every injection ("inject") and workload window ("window");
    # SLO math pairs injection markers with the recovery events between
    # them, so these are load-bearing for MTTR, not just bookkeeping.
    "drill.start": ("scenario", "seed"),
    "drill.phase": ("scenario", "phase"),
    "drill.verdict": ("scenario", "passed"),
    # placement-group FSM (gcs/pg_manager)
    "pg.state": ("state",),
    # chaos (fault_injection): every fired rule / partition hit
    "chaos.inject": ("site", "method", "label", "peer", "action", "rule"),
    "chaos.partition": ("site", "method", "label", "peer"),
    "chaos.plan": ("op", "seed", "rules"),
    # flight recorder bookkeeping
    "flight.dump": ("reason",),
    # distributed request tracing: a trace was force-kept by a
    # tail trigger (error / deadline_expired / shed / latency p99 breach)
    # — the GCS span store promotes its provisional spans on this mark
    "trace.force": ("reason",),
    # serve control-plane fault tolerance: the controller
    # write-throughs its reconcile state into the GCS KV on every
    # mutation, and a restarted incarnation ADOPTS live replicas/proxy
    # shards instead of restarting them. controller_recover is the
    # recovery anchor the controller_kill drill's MTTR pairs against;
    # replica_adopted events prove the data plane was never touched.
    "serve.controller_checkpoint": ("incarnation", "reason"),
    "serve.controller_recover": ("incarnation", "adopted_replicas",
                                 "restarted_replicas"),
    "serve.replica_adopted": ("replica_id", "incarnation"),
    # decoupled RL dataflow: the rollout fleet is crashable —
    # every membership change (death, respawn, elastic scale) and every
    # sample-plane decision (queue shed, zombie-push reject, staleness
    # drop) emits, and the learner stamps one rl.learner_step per ACTUAL
    # update so step cadence / zero-stale-trained derive from the log
    # (drills/slo.rl_slo — the rl_rollout_storm verdict reads these).
    "rl.learner_step": ("step", "version", "env_steps"),
    "rl.weights_broadcast": ("version",),
    "rl.stale_drop": ("version", "batch_version"),
    "rl.sample_shed": ("runner", "depth"),
    "rl.zombie_push": ("runner", "incarnation", "current"),
    "rl.runner_dead": ("runner", "reason"),
    "rl.runner_respawn": ("runner", "incarnation"),
    "rl.fleet_scale": ("from_runners", "to_runners", "reason"),
    # device-plane performance observability: one compile.*
    # pair per XLA backend compilation, emitted by the device profiler's
    # jax.monitoring listener — a recompile storm is a dense run of these
    # in `ray-tpu debug postmortem`. The listener only fires at compile
    # END, so compile.start's envelope time is the emit instant; its
    # data.t_start carries the true wall start.
    "compile.start": ("source", "t_start"),
    "compile.end": ("source", "duration_s"),
    # a DeviceStepProfiler aggregate report (bench runs, `ray-tpu
    # profile --device` fan-outs): phase fractions of accounted time
    "perf.phase_report": ("profiler", "steps", "fracs"),
    # tools/perf_gate.py: a gated benchmark metric fell past its noise
    # band vs the BENCH_* trajectory (the CI perf-regression gate)
    "perf.regression": ("metric", "baseline", "current", "band"),
    # cluster health plane: the GCS-side streaming SLO engine
    # (health/engine.py) flips a rule's state — one firing/resolved pair
    # per incident by construction (state-machine dedup + flap damping),
    # so drills can cross-check alert timelines against injection ground
    # truth. health.slo_eval is a sparse heartbeat (every
    # health_eval_log_every evals) proving the evaluator is running.
    "alert.firing": ("rule", "severity", "value"),
    "alert.resolved": ("rule", "severity", "duration_s"),
    "health.slo_eval": ("rules", "firing"),
}

_ID_KEYS = ("task_id", "actor_id", "node_id", "object_id", "trace_id")

# ------------------------------------------------------------ module state

_lock = threading.Lock()
_seq = itertools.count(1)
_ring: deque = deque(maxlen=4096)          # post-mortem window (never popped)
_pending: deque = deque()                  # awaiting flush (bounded manually)
_dropped = 0                               # pending-queue overflow, cumulative
_emitted = 0
_unknown_types: set = set()
_default_proc: Optional[str] = None

_sink: Optional[Callable[[List[dict], dict], None]] = None
_sink_token: Optional[object] = None
_flusher: Optional[threading.Thread] = None
_flush_wake = threading.Event()
_metrics = None
_metrics_failed = False

_flight_installed = False
_flight_lock = threading.Lock()


def _config():
    from ray_tpu_torch._private.config import CONFIG

    return CONFIG


def _get_metrics():
    """(depth_gauge, lag_gauge, dropped_counter, emitted_counter), created
    lazily so importing this module registers nothing."""
    global _metrics, _metrics_failed
    if _metrics is None and not _metrics_failed:
        try:
            from ray_tpu_torch.util.metrics import Counter, Gauge, get_metric

            def _gauge(name, desc):
                m = get_metric(name)
                return m if m is not None else Gauge(name, desc,
                                                     tag_keys=("proc",))

            def _counter(name, desc):
                m = get_metric(name)
                return m if m is not None else Counter(name, desc,
                                                       tag_keys=("proc",))

            _metrics = (
                _gauge("ray_tpu_event_buffer_depth",
                       "Unflushed lifecycle events pending in this process"),
                _gauge("ray_tpu_event_flush_lag_seconds",
                       "Age of the oldest unflushed lifecycle event"),
                _counter("ray_tpu_events_dropped_total",
                         "Lifecycle events dropped by pending-queue "
                         "overflow (sink slow or unreachable)"),
                _counter("ray_tpu_events_emitted_total",
                         "Lifecycle events emitted in this process"),
            )
        except Exception:  # noqa: BLE001 — metrics must never break emits
            _metrics_failed = True
    return _metrics


def default_proc_label() -> str:
    global _default_proc
    if _default_proc is None:
        _default_proc = f"proc:{os.getpid()}"
    return _default_proc


def set_default_proc_label(label: str) -> None:
    """Process-wide fallback label for emits without an explicit logger
    (e.g. chaos firings in a spawned worker before its CoreWorker binds)."""
    global _default_proc
    _default_proc = label


class EventLogger:
    """A component-bound emitter: stamps every record with the component's
    `proc` label (one PROCESS can host gcs + raylet + driver in tests, so
    attribution must ride each event, not the process)."""

    __slots__ = ("proc",)

    def __init__(self, proc: str):
        self.proc = proc

    def emit(self, etype: str, *, task_id: Optional[str] = None,
             actor_id: Optional[str] = None, node_id: Optional[str] = None,
             object_id: Optional[str] = None,
             trace_id: Optional[str] = None, **data) -> None:
        emit(etype, proc=self.proc, task_id=task_id, actor_id=actor_id,
             node_id=node_id, object_id=object_id, trace_id=trace_id,
             **data)


def logger_for(kind: str, ident: Optional[str] = None) -> EventLogger:
    return EventLogger(kind if not ident else f"{kind}:{ident}")


def emit(etype: str, *, proc: Optional[str] = None,
         task_id: Optional[str] = None, actor_id: Optional[str] = None,
         node_id: Optional[str] = None, object_id: Optional[str] = None,
         trace_id: Optional[str] = None, **data) -> None:
    """Record one lifecycle event. Cheap and non-blocking by contract:
    callable from any thread, including event-loop threads and code
    holding component locks."""
    global _dropped, _emitted
    schema = EVENT_SCHEMAS.get(etype)
    if schema is None and etype not in _unknown_types:
        # tolerated at runtime (an event is better than a crash), but the
        # schema-drift test fails on any emit site using an unknown type
        _unknown_types.add(etype)
    rec = {
        "seq": next(_seq),
        "pid": os.getpid(),
        "proc": proc or default_proc_label(),
        "time": time.time(),
        "mono": time.monotonic(),
        "type": etype,
        "task_id": task_id,
        "actor_id": actor_id,
        "node_id": node_id,
        "object_id": object_id,
        # trace-context cross-reference: lets `ray-tpu trace`
        # pull the lifecycle decisions for a trace and postmortem filter
        # a timeline down to one request
        "trace_id": trace_id,
        "data": data,
    }
    cfg = _config()
    max_pending = cfg.event_log_max_pending
    with _lock:
        if _ring.maxlen != cfg.event_log_max_events:
            _resize_ring_locked(cfg.event_log_max_events)
        _ring.append(rec)
        _emitted += 1
        if len(_pending) >= max_pending:
            _pending.popleft()   # oldest-first: keep the newest evidence
            _dropped += 1
        _pending.append(rec)
    m = _get_metrics()
    if m is not None:
        try:
            m[3].inc(tags={"proc": rec["proc"]})
        except Exception:  # noqa: BLE001 — metrics never break emits
            pass
    _ensure_flusher()
    _flush_wake.set()


def _resize_ring_locked(maxlen: int) -> None:
    global _ring
    _ring = deque(_ring, maxlen=maxlen)


# ------------------------------------------------------------------- sink

def set_sink(sink: Callable[[List[dict], dict], None],
             force: bool = False) -> Optional[object]:
    """Install the flush sink: `sink(events, source_stats)` ships a batch
    (direct append for an in-process GCS, `add_cluster_events` RPC
    otherwise). First-set wins unless force=True — in an embedded head the
    GCS's direct sink must not be displaced by the driver's RPC sink to
    the very same GCS. Returns an ownership token for clear_sink, or None
    if another sink is already installed."""
    global _sink, _sink_token
    with _lock:
        if _sink is not None and not force:
            return None
        _sink = sink
        _sink_token = object()
        token = _sink_token
    _ensure_flusher()
    _flush_wake.set()
    return token


def clear_sink(token: Optional[object]) -> None:
    """Remove the sink iff `token` still owns it (a later set_sink by
    another component must not be clobbered by an earlier owner's
    teardown)."""
    global _sink, _sink_token
    if token is None:
        return
    with _lock:
        if _sink_token is token:
            _sink = None
            _sink_token = None


def _ensure_flusher() -> None:
    global _flusher
    if _flusher is not None and _flusher.is_alive():
        return
    with _lock:
        if _flusher is not None and _flusher.is_alive():
            return
        _flusher = threading.Thread(target=_flush_loop, daemon=True,
                                    name="rt-event-flusher")
        _flusher.start()


def _flush_loop() -> None:
    while True:
        _flush_wake.wait(timeout=_config().event_log_flush_interval_s)
        _flush_wake.clear()
        try:
            _flush_once()
        except Exception:  # noqa: BLE001 — the flusher must never die
            pass
        _update_gauges()


def _flush_once(batch_size: int = 2000) -> None:
    global _dropped
    sink = _sink
    while True:
        with _lock:
            if sink is None or not _pending:
                return
            batch = [_pending.popleft()
                     for _ in range(min(batch_size, len(_pending)))]
            stats = _stats_locked()
        try:
            sink(batch, stats)
        except Exception:  # noqa: BLE001 — sink down: back the batch up
            with _lock:
                # requeue at the FRONT (order preserved); the bound still
                # applies — overflow drops the OLDEST records
                _pending.extendleft(reversed(batch))
                over = len(_pending) - _config().event_log_max_pending
                for _ in range(max(0, over)):
                    _pending.popleft()
                    _dropped += 1
            return


def _stats_locked() -> dict:
    return {
        "source": default_proc_label(),
        "pid": os.getpid(),
        "depth": len(_pending),
        "dropped": _dropped,
        "emitted": _emitted,
        "time": time.time(),
    }


_dropped_exported = 0


def _update_gauges() -> None:
    global _dropped_exported
    m = _get_metrics()
    if m is None:
        return
    with _lock:
        depth = len(_pending)
        oldest = _pending[0]["mono"] if _pending else None
        dropped = _dropped
    proc = {"proc": default_proc_label()}
    try:
        m[0].set(depth, tags=proc)
        m[1].set(0.0 if oldest is None else max(
            0.0, time.monotonic() - oldest), tags=proc)
        # counters are monotonic: export only the delta since last sync
        if dropped > _dropped_exported:
            m[2].inc(dropped - _dropped_exported, tags=proc)
            _dropped_exported = dropped
    except Exception:  # noqa: BLE001 — metrics never break the flusher
        pass


def flush(timeout: float = 2.0) -> bool:
    """Best-effort synchronous drain (shutdown paths, tests). True if the
    pending queue emptied within the timeout."""
    _ensure_flusher()
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        with _lock:
            if not _pending or _sink is None:
                return not _pending
        _flush_wake.set()
        time.sleep(0.01)
    return False


def local_stats() -> dict:
    """This process's pipeline counters (exposed by `ray-tpu status` and
    the saturation tests)."""
    with _lock:
        return {
            "ring": len(_ring),
            "pending": len(_pending),
            "dropped": _dropped,
            "emitted": _emitted,
            "sink_installed": _sink is not None,
        }


def recent(n: int = 1000,
           etype: Optional[str] = None) -> List[dict]:
    """Last n ring-buffer events (oldest first), optionally type-filtered."""
    with _lock:
        out = list(_ring)
    if etype is not None:
        from fnmatch import fnmatchcase

        out = [e for e in out if fnmatchcase(e["type"], etype)]
    return out[-n:]


def clear_for_tests() -> None:
    """Reset buffers + counters (NOT the sink) between test scenarios."""
    global _dropped, _emitted, _dropped_exported
    with _lock:
        _ring.clear()
        _pending.clear()
        _dropped = 0
        _emitted = 0
        _dropped_exported = 0
        _unknown_types.clear()


def unknown_types() -> set:
    return set(_unknown_types)


# -------------------------------------------------------- flight recorder

def flight_dir() -> str:
    cfg = _config()
    configured = cfg.flight_recorder_dir
    if configured:
        return configured
    # session dir layout: <session>/logs (CONFIG.log_dir) -> <session>/flight
    return os.path.join(os.path.dirname(cfg.log_dir.rstrip("/")), "flight")


def flight_dump(reason: str, out_dir: Optional[str] = None) -> Optional[str]:
    """Write this process's ring buffer + recent latency breakdowns to the
    session flight dir (atomic rename). Safe to call from signal handlers
    and teardown paths; returns the path or None on failure."""
    try:
        d = out_dir or flight_dir()
        os.makedirs(d, exist_ok=True)
        with _lock:
            events = list(_ring)
            stats = _stats_locked()
        try:
            from ray_tpu_torch._private import latency

            breakdowns = latency.recent(200)
        except Exception:  # noqa: BLE001 — latency buffer is optional here
            breakdowns = []
        doc = {
            "pid": os.getpid(),
            "proc": default_proc_label(),
            "time": time.time(),
            "reason": reason,
            "stats": stats,
            "events": events,
            "latency": breakdowns,
        }
        path = os.path.join(d, f"flight-{os.getpid()}.json")
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(doc, f, default=str)
        os.replace(tmp, path)
        _prune_flight_dir(d)
        return path
    except Exception:  # noqa: BLE001 — a dying process must still die
        return None


def _prune_flight_dir(d: str, keep: int = 200) -> None:
    try:
        files = [os.path.join(d, f) for f in os.listdir(d)
                 if f.startswith("flight-") and f.endswith(".json")]
        if len(files) <= keep:
            return
        files.sort(key=os.path.getmtime)
        for f in files[:len(files) - keep]:
            os.unlink(f)
    except OSError:
        pass


def install_flight_recorder(on_exit: bool = False) -> None:
    """Arm the crash hooks once per process:
      * sys.excepthook — any unhandled exception dumps before propagating;
      * SIGTERM — dump, then restore the previous disposition and re-raise
        (exit codes and existing handlers, e.g. the worker's exit-0, are
        preserved);
      * atexit — only with on_exit=True (worker/raylet/gcs PROCESSES,
        where every exit is worth a record; in-process drivers would spam
        a dump per test otherwise).
    Kill-style deaths that skip Python entirely (SIGKILL, os._exit) leave
    no dump — the chaos `kill` action compensates by dumping explicitly
    before exiting (fault_injection.py)."""
    global _flight_installed
    with _flight_lock:
        if _flight_installed:
            return
        _flight_installed = True
    import sys

    prev_hook = sys.excepthook

    def _hook(tp, val, tb):
        flight_dump(f"unhandled_exception:{tp.__name__}")
        prev_hook(tp, val, tb)

    sys.excepthook = _hook
    try:
        import signal

        prev_term = signal.getsignal(signal.SIGTERM)

        def _term(signum, frame):
            flight_dump("sigterm")
            signal.signal(signal.SIGTERM, prev_term or signal.SIG_DFL)
            os.kill(os.getpid(), signum)

        signal.signal(signal.SIGTERM, _term)
    except (ValueError, OSError):  # not the main thread / restricted env
        pass
    if on_exit:
        import atexit

        atexit.register(lambda: flight_dump("exit"))


# ------------------------------------------------- post-mortem merging

def load_flight_dumps(d: Optional[str] = None) -> List[dict]:
    """Parse every flight-*.json in the session flight dir (torn/partial
    files skipped — a crash can interrupt its own dump)."""
    d = d or flight_dir()
    out: List[dict] = []
    if not os.path.isdir(d):
        return out
    for name in sorted(os.listdir(d)):
        if not (name.startswith("flight-") and name.endswith(".json")):
            continue
        try:
            with open(os.path.join(d, name)) as f:
                out.append(json.load(f))
        except (OSError, ValueError):
            continue
    return out


def merge_timeline(*event_lists: List[dict]) -> List[dict]:
    """Merge event streams (flight dumps, GCS event-log queries) into one
    causally ordered timeline: dedupe by (pid, seq) — the same record can
    appear both in a dump and in the GCS log — then order by
    (time, pid, seq): wall time across processes, exact seq within one."""
    seen = set()
    merged: List[dict] = []
    for events in event_lists:
        for ev in events or ():
            key = (ev.get("pid"), ev.get("seq"))
            if key in seen and key != (None, None):
                continue
            seen.add(key)
            merged.append(ev)
    merged.sort(key=lambda e: (e.get("time", 0.0), e.get("pid") or 0,
                               e.get("seq") or 0))
    return merged


def postmortem_timeline(flight_dir_path: Optional[str] = None,
                        cluster_events: Optional[List[dict]] = None,
                        task_id: Optional[str] = None,
                        trace_id: Optional[str] = None) -> List[dict]:
    """The `ray-tpu debug postmortem` core: flight dumps + (optionally) a
    GCS cluster-event query merged into one ordered timeline. `trace_id`
    narrows the timeline to one distributed request (the other half of
    the trace<->event cross-reference; `ray-tpu trace` links back)."""
    dumps = load_flight_dumps(flight_dir_path)
    streams = [d.get("events") or [] for d in dumps]
    if cluster_events:
        streams.append(cluster_events)
    merged = merge_timeline(*streams)
    if task_id:
        merged = [e for e in merged if e.get("task_id") == task_id]
    if trace_id:
        merged = [e for e in merged if e.get("trace_id") == trace_id]
    return merged


def format_events(events: List[dict]) -> str:
    """Human-readable one-line-per-event rendering (events CLI +
    postmortem)."""
    lines = []
    for ev in events:
        t = ev.get("time", 0.0)
        ts = time.strftime("%H:%M:%S", time.localtime(t))
        ids = " ".join(
            f"{k.split('_')[0]}={str(ev[k])[:12]}"
            for k in _ID_KEYS if ev.get(k))
        data = ev.get("data") or {}
        detail = " ".join(f"{k}={data[k]}" for k in sorted(data))
        lines.append(f"{ts}.{int((t % 1) * 1e3):03d} "
                     f"{str(ev.get('proc', '?')):<22} "
                     f"{str(ev.get('type', '?')):<20} "
                     f"{ids}{' ' if ids and detail else ''}{detail}")
    return "\n".join(lines)
