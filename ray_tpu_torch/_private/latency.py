"""Cross-layer task latency tracing: per-stage breakdowns of the
submit -> lease -> dispatch -> execute -> reply path.

Reference capability: ray's task-event timelines (Ray: A Distributed
Framework..., arXiv:1712.05889 treats per-component timing as first-class)
and the C++ core worker's task profiling events. Here the OWNER stamps its
side of every task (submit / queue / push) with `time.monotonic()`, the
WORKER returns its own durations (dispatch / execute / pack) in the
PushTaskReply, and the owner stitches both into one six-stage breakdown —
no cross-process clock sync needed, the wire time falls out as
`rpc = owner_rtt - worker_wall`.

Stages of a task round trip:

  submit    owner: .remote() entry -> spec queued (arg build/serialize,
            dependency resolution, submit-buffer drain)
  queue     owner: queued -> pushed (worker-lease wait + pending queue)
  rpc       both directions on the wire: owner round trip minus the
            worker-measured wall time
  dispatch  worker: push received -> function body starts (wire decode,
            thread-pool hop, arg fetch, actor sequencing gate)
  execute   worker: the function body itself
  reply     worker return packaging + owner reply processing (store puts)

Breakdowns feed three consumers: tagged Histogram metrics (p50/p90/p99
exported by `prometheus_text()`), the process-local chrome-trace buffer
(`ray-tpu timeline` stage-segmented spans), and a ring buffer behind
`recent()` / the `ray-tpu latency` CLI.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

STAGES = ("submit", "queue", "rpc", "dispatch", "execute", "reply")

# Sub-millisecond buckets matter here: the whole control-plane budget is
# ~100us/task (SURVEY §3.2), so the default Histogram boundaries (5ms+)
# would collapse every interesting sample into the first bucket.
STAGE_BOUNDARIES = [
    1e-5, 2.5e-5, 5e-5, 1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3,
    0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 15.0, 60.0,
]

_lock = threading.Lock()
_recent: deque = deque(maxlen=2048)
_stage_hist = None
_total_hist = None

# Raw breakdowns awaiting metric/trace recording. The owner's RPC reply
# loop only APPENDS here (record_breakdown); the histogram observes and
# chrome-trace span formatting — ~60us/task, enough to stall every
# in-flight reply at serving rates — run on the drainer thread below.
# Bounded: under a sustained burst the OLDEST breakdowns drop (the
# histograms lose samples, never the request path).
_pending_raw: deque = deque(maxlen=65536)
_drain_lock = threading.Lock()
_drainer: Optional[threading.Thread] = None
_drain_wake = threading.Event()
_DRAIN_INTERVAL_S = 0.5


def _metrics():
    """Lazily create the per-process stage histograms (importing
    util.metrics at module load would register metrics in processes that
    never run tasks)."""
    global _stage_hist, _total_hist
    if _stage_hist is None:
        from ray_tpu_torch.util.metrics import get_or_create_histogram

        _stage_hist = get_or_create_histogram(
            "ray_tpu_task_stage_seconds",
            "Per-stage task latency (submit/queue/rpc/dispatch/execute/"
            "reply)",
            boundaries=STAGE_BOUNDARIES,
            tag_keys=("stage", "type"),
        )
        _total_hist = get_or_create_histogram(
            "ray_tpu_task_total_seconds",
            "End-to-end task latency (submit -> reply processed)",
            boundaries=STAGE_BOUNDARIES,
            tag_keys=("type",),
        )
    return _stage_hist, _total_hist


def owner_breakdown(
    t_submit: Optional[float],
    t_queued: Optional[float],
    t_pushed: Optional[float],
    t_reply: float,
    t_done: float,
    worker_stages: Optional[Dict[str, float]],
) -> Optional[Dict[str, float]]:
    """Stitch owner stamps + worker durations into the six-stage
    breakdown. Returns None when any stamp is missing (e.g. lineage
    reconstruction re-submits, which skip the user submit path)."""
    if t_submit is None or t_queued is None or t_pushed is None:
        return None
    w = worker_stages or {}
    wall = w.get("wall", 0.0) or 0.0
    return {
        "submit": max(0.0, t_queued - t_submit),
        "queue": max(0.0, t_pushed - t_queued),
        "rpc": max(0.0, (t_reply - t_pushed) - wall),
        "dispatch": max(0.0, w.get("dispatch", 0.0) or 0.0),
        "execute": max(0.0, w.get("exec", 0.0) or 0.0),
        "reply": max(0.0, (w.get("pack", 0.0) or 0.0)
                     + max(0.0, t_done - t_reply)),
    }


def record_breakdown(task_id_hex: str, name: str, task_type: str,
                     stages: Dict[str, float],
                     trace_id: Optional[str] = None) -> None:
    """Queue one task's breakdown for recording. Runs on the owner's RPC
    reply loop, so it must stay O(1): the histogram observes and trace
    span formatting happen on the drainer thread (readers drain inline
    first, so `recent()`/metrics stay consistent at read time). NO
    thread creation here — spawning a thread from the reply loop stalls
    it for tens of ms on gVisor-class kernels, which is exactly the tail
    this deferral removes (CoreWorker.__init__ calls start_drainer).
    `trace_id` stamps the breakdown for trace<->latency cross-reference
    and arms the p99-breach tail-keep check on the drainer."""
    _pending_raw.append((task_id_hex, name, task_type, stages, trace_id))
    _drain_wake.set()


def start_drainer() -> None:
    """Start the background drainer (idempotent). Called from cold paths
    only (process init), never from the request path."""
    global _drainer
    with _drain_lock:
        if _drainer is not None and _drainer.is_alive():
            return
        _drainer = threading.Thread(target=_drain_loop, daemon=True,
                                    name="rt-latency-drain")
        _drainer.start()


def _drain_loop() -> None:
    while True:
        _drain_wake.wait(timeout=_DRAIN_INTERVAL_S)
        _drain_wake.clear()
        try:
            drain_pending()
        except Exception:  # noqa: BLE001 — the drainer must never die
            pass


def drain_pending() -> None:
    """Record every queued breakdown (drainer thread + read paths)."""
    while True:
        try:
            item = _pending_raw.popleft()
        except IndexError:
            return
        _record_one(*item)


def _record_one(task_id_hex: str, name: str, task_type: str,
                stages: Dict[str, float],
                trace_id: Optional[str] = None) -> None:
    stage_hist, total_hist = _metrics()
    total = 0.0
    for stage in STAGES:
        dur = stages.get(stage)
        if dur is None:
            continue
        total += dur
        stage_hist.observe(dur, tags={"stage": stage, "type": task_type})
    total_hist.observe(total, tags={"type": task_type})
    now = time.time()
    entry = {
        "task_id": task_id_hex,
        "name": name,
        "type": task_type,
        "time": now,
        "total": total,
        "trace_id": trace_id,
        "stages": {s: stages.get(s, 0.0) for s in STAGES},
    }
    with _lock:
        _recent.append(entry)
    # every task feeds the p99 window; only traced ones can breach it
    _check_tail_keep(trace_id, stages, total)
    # Stage-segmented spans into the local chrome-trace buffer: the six
    # stages laid out back-to-back, ending at the reply-processed instant.
    # Local-only (ship=False): cluster-wide consumers already get the
    # stages inside the terminal task event; shipping six more spans per
    # task would tax the flusher for data the GCS already holds.
    from ray_tpu_torch._private.tracing import record_profile_span

    t = now - total
    for stage in STAGES:
        dur = stages.get(stage, 0.0) or 0.0
        record_profile_span(f"{name}:{stage}", t, t + dur,
                            attrs={"task_id": task_id_hex, "stage": stage,
                                   "trace_id": trace_id},
                            thread="task-stages", ship=False)
        t += dur


# Tail-based force-keep on latency: per-stage reservoirs of the recent
# window; a traced task whose stage lands past ~p99 of that window (or
# whose total exceeds trace_force_slow_s) promotes its trace. Runs on the
# drainer thread only — never the reply loop.
_stage_window: Dict[str, deque] = {s: deque(maxlen=512) for s in STAGES}
_P99_MIN_SAMPLES = 64


def _check_tail_keep(trace_id: Optional[str], stages: Dict[str, float],
                     total: float) -> None:
    from ray_tpu_torch._private.config import CONFIG
    from ray_tpu_torch._private.tracing import force_trace

    slow_s = CONFIG.trace_force_slow_s
    if trace_id is not None and slow_s > 0 and total >= slow_s:
        force_trace(trace_id, f"latency_slow:{total:.3f}s")
    breached = None
    for stage in STAGES:
        dur = stages.get(stage, 0.0) or 0.0
        window = _stage_window[stage]
        if (trace_id is not None and breached is None
                and len(window) >= _P99_MIN_SAMPLES):
            p99 = _quantile(list(window), 0.99)
            # require real signal: microsecond jitter over a fast stage
            # must not force-keep half the traffic
            if dur > p99 and dur > 0.005:
                breached = stage
        window.append(dur)
    if breached is not None:
        force_trace(trace_id, f"latency_p99_breach:{breached}")


def recent(n: int = 100) -> List[Dict[str, Any]]:
    """The last n recorded breakdowns in this process (newest last)."""
    drain_pending()
    with _lock:
        out = list(_recent)
    return out[-n:]


def clear_recent() -> None:
    _pending_raw.clear()
    with _lock:
        _recent.clear()


def format_breakdowns(entries: List[Dict[str, Any]],
                      summarize: bool = True) -> str:
    """Fixed-width stage table for the `ray-tpu latency` CLI. `entries`
    are breakdown dicts (recent() shape, or task events carrying
    'stages')."""
    header = (f"{'task':<28} {'type':<14} {'total':>9} "
              + " ".join(f"{s:>9}" for s in STAGES))
    lines = [header, "-" * len(header)]
    per_stage: Dict[str, List[float]] = {s: [] for s in STAGES}
    totals: List[float] = []
    for e in entries:
        stages = e.get("stages") or {}
        total = e.get("total")
        if total is None:
            total = sum(stages.get(s, 0.0) or 0.0 for s in STAGES)
        name = str(e.get("name") or e.get("task_id", "?"))[:28]
        cells = []
        for s in STAGES:
            v = stages.get(s, 0.0) or 0.0
            per_stage[s].append(v)
            cells.append(f"{v * 1e3:>8.2f}m")
        totals.append(total)
        lines.append(f"{name:<28} {str(e.get('type', ''))[:14]:<14} "
                     f"{total * 1e3:>8.2f}m " + " ".join(cells))
    if summarize and totals:
        lines.append("-" * len(header))
        for q, label in ((0.5, "p50"), (0.9, "p90"), (0.99, "p99")):
            cells = [f"{_quantile(per_stage[s], q) * 1e3:>8.2f}m"
                     for s in STAGES]
            lines.append(f"{'[' + label + ']':<28} {'':<14} "
                         f"{_quantile(totals, q) * 1e3:>8.2f}m "
                         + " ".join(cells))
    return "\n".join(lines)


def _quantile(values: List[float], q: float) -> float:
    if not values:
        return 0.0
    vs = sorted(values)
    idx = min(len(vs) - 1, int(q * len(vs)))
    return vs[idx]
