"""End-to-end distributed request tracing.

Dapper-style trace-context propagation over the task tree (reference
lineage: ray's util/tracing/tracing_helper.py otel context injection
around task submit/execute; W3C `traceparent` on the serve ingress), built
the same way deadlines propagate: an AMBIENT thread-scoped
context plus a TaskSpec field that rides the wire codec.

The pieces:

* ``TraceContext`` — (trace_id, span_id, parent_id, sampled), rendered
  to/from the W3C ``traceparent`` header
  (``00-<trace_id:32>-<span_id:16>-<flags:2>``).
* Ambient propagation — ``trace_scope(ctx)`` installs a thread-scoped
  context (the serve proxy does this per request); inside an executing
  task the context falls back to the spec's own ``trace_ctx``, so nested
  submissions inherit child-from-parent with no explicit plumbing.
  ``context_for_submission()`` mints the child context every submit path
  stamps onto its TaskSpec.
* Head sampling — with no ambient context, a new root is created with
  probability ``trace_sample_rate`` (default 0.0: plain task submission
  does no tracing work beyond one thread-local read + one config read —
  the zero-cost-uninstalled bar; the raw-echo RTT
  microbenchmark never touches this module at all).
* Span recording — ``record_span`` appends one dict to a bounded
  process-local buffer; a daemon flusher ships batches to a pluggable
  sink (GCS direct-append on the embedded head, ``add_spans`` RPC from
  raylet/worker/driver — the same shape as _private/event_log). Spans
  are recorded for EVERY context-carrying operation, sampled or not:
  the sampled bit rides each span and the GCS span store parks
  unsampled spans in a provisional ring.
* Tail-based force-keep — ``force_trace(trace_id, reason)`` marks a
  trace interesting (error, ``task.deadline_expired``, a shed, a
  latency-stage p99 breach). Forced trace ids ride the next flush batch;
  the GCS store promotes the trace's provisional spans into the durable
  store, so the interesting traces survive any head sample rate.

Rendering helpers (``build_span_tree`` / ``format_trace`` /
``trace_chrome``) are pure and shared by `ray-tpu trace`, the dashboard
``/api/trace`` route, and tests.
"""

from __future__ import annotations

import os
import random
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

_W3C_VERSION = "00"

# ------------------------------------------------------------ trace context


class TraceContext:
    """One position in a trace: the trace id, THIS span's id, the parent
    span's id (None at the root) and the head-sampling decision."""

    __slots__ = ("trace_id", "span_id", "parent_id", "sampled")

    def __init__(self, trace_id: str, span_id: str,
                 parent_id: Optional[str] = None, sampled: bool = False):
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.sampled = sampled

    def child(self) -> "TraceContext":
        """A new span under this one (same trace, same sampling verdict)."""
        return TraceContext(self.trace_id, new_span_id(),
                            parent_id=self.span_id, sampled=self.sampled)

    def to_wire(self) -> Tuple[str, str, Optional[str], bool]:
        """The flat tuple TaskSpec.trace_ctx carries (specs.py codec)."""
        return (self.trace_id, self.span_id, self.parent_id, self.sampled)

    @staticmethod
    def from_wire(t) -> Optional["TraceContext"]:
        if t is None:
            return None
        return TraceContext(t[0], t[1], t[2], bool(t[3]))

    def traceparent(self) -> str:
        flags = "01" if self.sampled else "00"
        return f"{_W3C_VERSION}-{self.trace_id}-{self.span_id}-{flags}"

    def __repr__(self):
        return (f"TraceContext({self.trace_id[:8]}.., span={self.span_id}, "
                f"parent={self.parent_id}, sampled={self.sampled})")


def new_trace_id() -> str:
    return os.urandom(16).hex()


def new_span_id() -> str:
    return os.urandom(8).hex()


def parse_traceparent(value: Optional[str]) -> Optional[TraceContext]:
    """W3C traceparent -> TraceContext (None on anything malformed —
    ingress must degrade to generating a fresh context, never 500)."""
    if not value:
        return None
    parts = value.strip().split("-")
    if len(parts) != 4:
        return None
    version, trace_id, span_id, flags = parts
    if (len(version) != 2 or len(trace_id) != 32 or len(span_id) != 16
            or len(flags) != 2):
        return None
    try:
        int(trace_id, 16), int(span_id, 16)
        sampled = bool(int(flags, 16) & 0x1)
    except ValueError:
        return None
    if int(trace_id, 16) == 0 or int(span_id, 16) == 0:
        return None
    return TraceContext(trace_id, span_id, sampled=sampled)


# -------------------------------------------------------------- ambient ctx

_ambient = threading.local()


class trace_scope:
    """Install a thread-scoped trace context (the serve proxy wraps each
    request's submissions and stream iteration in one). Nested scopes
    stack; None is a no-op scope."""

    __slots__ = ("ctx", "_prev")

    def __init__(self, ctx: Optional[TraceContext]):
        self.ctx = ctx
        self._prev = None

    def __enter__(self):
        self._prev = getattr(_ambient, "ctx", None)
        if self.ctx is not None:
            _ambient.ctx = self.ctx
        return self

    def __exit__(self, *exc):
        _ambient.ctx = self._prev
        return False


def current_trace() -> Optional[TraceContext]:
    """The ambient context: an explicit trace_scope wins; inside a running
    task the executing spec's own trace_ctx is the ambient context (so
    children inherit through nested tasks, actor pushes and generator
    bodies with zero per-layer plumbing)."""
    ctx = getattr(_ambient, "ctx", None)
    if ctx is not None:
        return ctx
    try:
        from ray_tpu_torch._raylet import global_state

        cw = global_state.core_worker
        if cw is None:
            return None
        spec = cw.current_spec()
    except Exception:  # noqa: BLE001 — no runtime yet
        return None
    if spec is None:
        return None
    wire = getattr(spec, "trace_ctx", None)
    return TraceContext.from_wire(wire) if wire is not None else None


def context_for_submission() -> Optional[TraceContext]:
    """The context a new TaskSpec is stamped with: a child of the ambient
    context when one exists, else a head-sampled fresh root (probability
    ``trace_sample_rate``), else None — and None must stay CHEAP, it is
    on every task-submit hot path."""
    parent = current_trace()
    if parent is not None:
        return parent.child()
    rate = _config().trace_sample_rate
    if rate <= 0.0 or random.random() >= rate:
        return None
    return TraceContext(new_trace_id(), new_span_id(), sampled=True)


def start_trace(sampled: bool = True) -> TraceContext:
    """Explicitly start a new root trace (CLI/test entry point)."""
    return TraceContext(new_trace_id(), new_span_id(), sampled=sampled)


def trace_id_of(spec) -> Optional[str]:
    """The trace id off a TaskSpec's wire ctx (None when untraced) —
    THE extraction helper; call sites must not hand-roll the tuple
    indexing (a wire-shape change would have to chase every copy)."""
    ctx = getattr(spec, "trace_ctx", None)
    return ctx[0] if ctx is not None else None


def ingest_traceparent(header: Optional[str]) -> TraceContext:
    """Ingress entry point (serve proxy): continue the client's W3C
    `traceparent` (the returned context is a CHILD of the client's span,
    inheriting its sampled flag), or mint a fresh root — head-sampled at
    ``trace_sample_rate`` — when the header is absent or malformed. Always
    returns a context: every HTTP response carries a trace id, so a
    user-visible error is always traceable (tail force-keep promotes the
    spans even when unsampled)."""
    parent = parse_traceparent(header)
    if parent is not None:
        return parent.child()
    rate = _config().trace_sample_rate
    sampled = rate > 0.0 and random.random() < rate
    return TraceContext(new_trace_id(), new_span_id(), sampled=sampled)


# ------------------------------------------------------------- span buffer

_lock = threading.Lock()
# Local tail for get_trace_events/timeline/flight dumps. Sized to the
# deque it replaced in util/tracing/tracing_helper (100k): the latency
# stage lane records 6 LOCAL-only spans per task, so a smaller ring
# would silently truncate the driver-side timeline history.
_ring: deque = deque(maxlen=100_000)
_pending: deque = deque()           # awaiting flush (bounded manually)
_forced_pending: List[Tuple[str, str]] = []   # (trace_id, reason)
_forced_seen: deque = deque(maxlen=2048)      # dedupe window
_forced_seen_set: set = set()
_dropped = 0
_recorded = 0

_sink = None
_sink_token: Optional[object] = None
_flusher: Optional[threading.Thread] = None
_flush_wake = threading.Event()


def _config():
    from ray_tpu_torch._private.config import CONFIG

    return CONFIG


def _proc_label() -> str:
    from ray_tpu_torch._private import event_log

    return event_log.default_proc_label()


def record_span(name: str, trace, start: float, end: float, *,
                span_id: Optional[str] = None,
                parent_id: Optional[str] = None,
                proc: Optional[str] = None,
                attrs: Optional[Dict[str, Any]] = None) -> Optional[str]:
    """Record one span of a trace. `trace` is a TraceContext or the wire
    tuple off a TaskSpec; None is a cheap no-op (callers guard with one
    `is None` check, same contract as the chaos PLAN check). By default
    the span gets a FRESH id parented at the context's span (a stage
    under the task); pass span_id/parent_id to record the context's own
    span. Returns the span id (for chaining), or None when untraced."""
    if trace is None:
        return None
    if isinstance(trace, TraceContext):
        trace_id, ctx_span, sampled = trace.trace_id, trace.span_id, \
            trace.sampled
        ctx_parent = trace.parent_id
    else:
        trace_id, ctx_span, ctx_parent, sampled = (
            trace[0], trace[1], trace[2], bool(trace[3]))
    if span_id is None:
        sid = new_span_id()
        pid = parent_id if parent_id is not None else ctx_span
    else:
        sid = span_id
        pid = parent_id if parent_id is not None else ctx_parent
    _append_span({
        "trace_id": trace_id,
        "span_id": sid,
        "parent_id": pid,
        "name": name,
        "proc": proc or _proc_label(),
        "pid": os.getpid(),
        "start": start,
        "end": end,
        "sampled": sampled,
        "attrs": dict(attrs) if attrs else {},
    })
    return sid


def record_profile_span(name: str, start: float, end: float, *,
                        thread: Optional[str] = None,
                        attrs: Optional[Dict[str, Any]] = None,
                        ship: bool = True) -> None:
    """A profile span (util.tracing trace_span/record_event): no trace id
    unless an ambient context is active. With ship=True it drains through
    the span flusher so `ray-tpu timeline` sees WORKER spans too — the
    process-local-only deque this replaces silently showed driver spans
    only. ship=False keeps it in the local ring (the latency stage lane,
    which already reaches the GCS inside task events)."""
    # current_trace(), not the raw thread-local: a trace_span inside an
    # EXECUTING traced task inherits via the spec fallback, same as
    # submissions do — the raw read would silently detach those spans
    ctx = current_trace()
    rec = {
        "trace_id": ctx.trace_id if ctx is not None else None,
        "span_id": new_span_id(),
        "parent_id": ctx.span_id if ctx is not None else None,
        "name": name,
        "proc": _proc_label(),
        "pid": os.getpid(),
        "start": start,
        "end": end,
        "sampled": bool(ctx.sampled) if ctx is not None else False,
        "attrs": dict(attrs) if attrs else {},
        "thread": thread or threading.current_thread().name,
        "profile": True,
    }
    if ship:
        _append_span(rec)
    else:
        with _lock:
            _ring.append(rec)


def _append_span(rec: dict) -> None:
    global _dropped, _recorded
    cfg = _config()
    with _lock:
        _ring.append(rec)
        _recorded += 1
        if len(_pending) >= cfg.trace_max_pending:
            _pending.popleft()
            _dropped += 1
        _pending.append(rec)
    _ensure_flusher()
    _flush_wake.set()


def force_trace(trace_id: Optional[str], reason: str) -> None:
    """Tail-based keep: mark a trace interesting (error / deadline
    expired / shed / latency p99 breach). The mark rides the next span
    flush; the GCS store promotes the trace's provisional spans. Cheap
    and deduped — callers may fire it per failure without throttling."""
    if not trace_id:
        return
    with _lock:
        if trace_id in _forced_seen_set:
            return
        if len(_forced_seen) == _forced_seen.maxlen:
            _forced_seen_set.discard(_forced_seen[0])
        _forced_seen.append(trace_id)
        _forced_seen_set.add(trace_id)
        _forced_pending.append((trace_id, reason))
    from ray_tpu_torch._private import event_log

    event_log.emit("trace.force", trace_id=trace_id, reason=reason)
    _ensure_flusher()
    _flush_wake.set()


# ------------------------------------------------------------------- sink

def set_span_sink(sink, force: bool = False) -> Optional[object]:
    """Install the flush sink: `sink(spans, forced, stats)`. First-set
    wins unless force=True (embedded head keeps the GCS direct sink; see
    event_log.set_sink for the rationale)."""
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


def clear_span_sink(token: Optional[object]) -> None:
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
                                    name="rt-span-flusher")
        _flusher.start()


def _flush_loop() -> None:
    while True:
        _flush_wake.wait(timeout=_config().trace_flush_interval_s)
        _flush_wake.clear()
        try:
            _flush_once()
        except Exception:  # noqa: BLE001 — the flusher must never die
            pass


def _flush_once(batch_size: int = 2000) -> None:
    global _dropped
    sink = _sink
    while True:
        with _lock:
            if sink is None or (not _pending and not _forced_pending):
                return
            batch = [_pending.popleft()
                     for _ in range(min(batch_size, len(_pending)))]
            forced = list(_forced_pending)
            _forced_pending.clear()
            stats = _span_stats_locked()
        try:
            sink(batch, forced, stats)
        except Exception:  # noqa: BLE001 — sink down: back the batch up
            with _lock:
                _pending.extendleft(reversed(batch))
                _forced_pending[:0] = forced
                over = len(_pending) - _config().trace_max_pending
                for _ in range(max(0, over)):
                    _pending.popleft()
                    _dropped += 1
            return


def _span_stats_locked() -> dict:
    return {
        "source": _proc_label(),
        "pid": os.getpid(),
        "depth": len(_pending),
        "dropped": _dropped,
        "recorded": _recorded,
        "time": time.time(),
    }


def flush_spans(timeout: float = 2.0) -> bool:
    """Best-effort synchronous drain (tests, CLI before a query)."""
    _ensure_flusher()
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        with _lock:
            if (not _pending and not _forced_pending) or _sink is None:
                return not _pending
        _flush_wake.set()
        time.sleep(0.01)
    return False


def local_span_stats() -> dict:
    with _lock:
        return {
            "ring": len(_ring),
            "pending": len(_pending),
            "dropped": _dropped,
            "recorded": _recorded,
            "sink_installed": _sink is not None,
        }


def get_local_spans(n: int = 1000) -> List[dict]:
    """Last n locally-recorded spans (oldest first) — the compat backing
    for util.tracing.get_trace_events and flight-recorder dumps."""
    with _lock:
        out = list(_ring)
    return out[-n:]


def clear_local_ring() -> None:
    """Drop only the local span tail (get_trace_events(clear=True) —
    the legacy profile-buffer contract). Unflushed spans and pending
    force markers are NOT touched: clearing a read-side cache must never
    lose spans still on their way to the GCS store."""
    with _lock:
        _ring.clear()


def clear_for_tests() -> None:
    global _dropped, _recorded
    with _lock:
        _ring.clear()
        _pending.clear()
        _forced_pending.clear()
        _forced_seen.clear()
        _forced_seen_set.clear()
        _dropped = 0
        _recorded = 0


# -------------------------------------------------------------- rendering

def build_span_tree(spans: List[dict]) -> List[dict]:
    """Parent-link spans into a forest: each node is
    {"span": <rec>, "children": [...]} ordered by start time. A span
    whose parent never arrived (cross-process flush race, unsampled
    parent aged out) roots its own subtree instead of vanishing."""
    by_id = {s["span_id"]: {"span": s, "children": []} for s in spans}
    roots: List[dict] = []
    for node in by_id.values():
        parent = node["span"].get("parent_id")
        if parent is not None and parent in by_id:
            by_id[parent]["children"].append(node)
        else:
            roots.append(node)

    def _sort(nodes):
        nodes.sort(key=lambda n: n["span"].get("start", 0.0))
        for n in nodes:
            _sort(n["children"])

    _sort(roots)
    return roots


def format_trace(spans: List[dict]) -> str:
    """`ray-tpu trace` rendering: the cross-process span tree with
    per-span durations, proc attribution and offsets from trace start."""
    if not spans:
        return "(no spans)"
    t0 = min(s.get("start", 0.0) for s in spans)
    procs = sorted({s.get("proc", "?") for s in spans})
    lines = [
        f"trace {spans[0].get('trace_id', '?')} — {len(spans)} span(s) "
        f"across {len(procs)} process(es): {', '.join(procs)}",
    ]

    def _walk(node, depth):
        s = node["span"]
        dur_ms = max(0.0, (s.get("end", 0.0) - s.get("start", 0.0))) * 1e3
        off_ms = max(0.0, s.get("start", 0.0) - t0) * 1e3
        attrs = s.get("attrs") or {}
        detail = " ".join(f"{k}={attrs[k]}" for k in sorted(attrs))
        lines.append(
            f"  {'  ' * depth}+{off_ms:9.2f}ms {s.get('name', '?'):<28} "
            f"{dur_ms:9.2f}ms  {s.get('proc', '?'):<20}"
            f"{'  ' + detail if detail else ''}")
        for child in node["children"]:
            _walk(child, depth + 1)

    for root in build_span_tree(spans):
        _walk(root, 0)
    return "\n".join(lines)


def trace_chrome(spans: List[dict]) -> list:
    """Chrome-trace export of one trace: 'X' slices per span, one lane
    per process, plus flow events ('s'/'f') along every cross-process
    parent->child edge so chrome://tracing draws the causal arrows
    between proxy, owner, raylet and worker lanes."""
    trace = []
    by_id = {}
    for s in spans:
        entry = {
            "cat": "trace", "ph": "X", "name": s.get("name", "?"),
            "pid": s.get("proc") or "?",
            "tid": s.get("thread") or f"pid:{s.get('pid')}",
            "ts": int(s.get("start", 0.0) * 1e6),
            "dur": max(1, int((s.get("end", 0.0)
                               - s.get("start", 0.0)) * 1e6)),
            "args": {"trace_id": s.get("trace_id"),
                     "span_id": s.get("span_id"),
                     "parent_id": s.get("parent_id"),
                     **(s.get("attrs") or {})},
        }
        trace.append(entry)
        by_id[s.get("span_id")] = entry
    flow = 0
    for s in spans:
        parent = by_id.get(s.get("parent_id"))
        child = by_id.get(s.get("span_id"))
        if parent is None or child is None:
            continue
        if parent["pid"] == child["pid"]:
            continue  # same-process nesting reads fine without arrows
        flow += 1
        trace.append({"cat": "trace", "ph": "s", "id": flow,
                      "name": "propagate", "pid": parent["pid"],
                      "tid": parent["tid"], "ts": parent["ts"]})
        trace.append({"cat": "trace", "ph": "f", "id": flow,
                      "name": "propagate", "bp": "e", "pid": child["pid"],
                      "tid": child["tid"], "ts": child["ts"]})
    return trace
