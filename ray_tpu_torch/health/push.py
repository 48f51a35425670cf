"""Background metric pusher: every process ships its ``util.metrics``
registry to the GCS MetricsManager on a fixed cadence.

Same substrate discipline as the event-log flusher (event_log.py): the
snapshot thread never blocks on the sink, pending payloads back up into
a bounded drop-oldest queue whose overflow is COUNTED
(``ray_tpu_health_push_dropped_total``), and the sink is first-set-wins
so an embedded head's direct GCS sink is not displaced by the driver's
RPC sink to the very same GCS.

Aggregator guard: processes that call ``collect_llm_metrics`` merge
remote replicas' serving series into their OWN registry (dashboard
head, ``ray-tpu status``, drivers). If such a process also pushed its
registry, every merged series would reach the store twice — once from
the replica that owns it and once re-badged under the aggregator.
``exclude_prefix("ray_tpu_llm")`` (called by ``collect_llm_metrics`` on
first merge) removes the merged families from this process's push
payloads; the owning replicas keep pushing theirs.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Callable, Dict, Optional

from ray_tpu_torch.util import metrics as um

# sink(payload: dict) — ships one push_metrics payload (direct call for
# an in-process GCS, `send("push_metrics", ...)` otherwise)
_lock = threading.Lock()
_sink: Optional[Callable[[Dict], None]] = None
_sink_token: Optional[object] = None
_source: Optional[str] = None
_pending: deque = deque()          # bounded manually (drop-oldest, counted)
_dropped = 0
_pushed = 0
_excluded_prefixes: set = set()
_pusher: Optional[threading.Thread] = None
_wake = threading.Event()
_metrics = None
_metrics_failed = False

PUSH_PREFIX = "ray_tpu_"


def _config():
    from ray_tpu_torch._private.config import CONFIG

    return CONFIG


def _get_metrics():
    global _metrics, _metrics_failed
    if _metrics is None and not _metrics_failed:
        try:
            _metrics = (
                um.get_or_create_counter(
                    "ray_tpu_health_pushes_total",
                    "Metric snapshots pushed to the GCS health store",
                    ("proc",)),
                um.get_or_create_counter(
                    "ray_tpu_health_push_dropped_total",
                    "Metric push payloads dropped by pending-queue "
                    "overflow (GCS slow or unreachable)",
                    ("proc",)),
            )
        except Exception:  # noqa: BLE001 — metrics must never break pushes
            _metrics_failed = True
    return _metrics


def set_push_sink(sink: Callable[[Dict], None], source: str,
                  force: bool = False) -> Optional[object]:
    """Install the push sink + this process's source label. First-set
    wins unless force=True; returns an ownership token for
    clear_push_sink, or None if another sink is already installed."""
    global _sink, _sink_token, _source
    with _lock:
        if _sink is not None and not force:
            return None
        _sink = sink
        _source = source
        _sink_token = object()
        token = _sink_token
    _ensure_pusher()
    _wake.set()
    return token


def clear_push_sink(token: Optional[object]) -> None:
    global _sink, _sink_token
    if token is None:
        return
    with _lock:
        if _sink_token is token:
            _sink = None
            _sink_token = None


def exclude_prefix(prefix: str) -> None:
    """Stop shipping metric families under `prefix` from THIS process —
    called by aggregators that merge other processes' snapshots into
    their own registry (see module docstring)."""
    with _lock:
        _excluded_prefixes.add(prefix)


def _ensure_pusher() -> None:
    global _pusher
    if _pusher is not None and _pusher.is_alive():
        return
    with _lock:
        if _pusher is not None and _pusher.is_alive():
            return
        _pusher = threading.Thread(target=_push_loop, daemon=True,
                                   name="rt-health-pusher")
        _pusher.start()


def _build_payload(now: float) -> Optional[Dict]:
    source = _source
    if source is None:
        return None
    snapshot = um.snapshot_metrics(PUSH_PREFIX)
    with _lock:
        excluded = tuple(_excluded_prefixes)
        dropped = _dropped
        pushed = _pushed
    if excluded:
        snapshot = [e for e in snapshot
                    if not any(e["name"].startswith(p) for p in excluded)]
    if not snapshot:
        return None
    return {
        "source": source,
        "pid": os.getpid(),
        "time": now,
        "snapshot": snapshot,
        "stats": {"dropped": dropped, "pushed": pushed},
    }


def _push_loop() -> None:
    while True:
        _wake.wait(timeout=_config().health_push_interval_s)
        _wake.clear()
        try:
            _push_once()
        except Exception:  # noqa: BLE001 — the pusher must never die
            pass


def _push_once() -> None:
    global _dropped, _pushed
    if _sink is None:
        return
    payload = _build_payload(time.time())
    max_pending = max(1, _config().health_push_max_pending)
    with _lock:
        if payload is not None:
            if len(_pending) >= max_pending:
                _pending.popleft()   # drop-oldest: newest snapshot wins
                _dropped += 1
            _pending.append(payload)
        sink = _sink
        batch = list(_pending)
    if sink is None or not batch:
        return
    sent = 0
    try:
        for p in batch:
            sink(p)
            sent += 1
    except Exception:  # noqa: BLE001 — sink down: keep unsent payloads
        pass
    with _lock:
        for _ in range(min(sent, len(_pending))):
            _pending.popleft()
        _pushed += sent
        dropped, pushed = _dropped, _pushed
    m = _get_metrics()
    if m is not None and sent:
        try:
            proc = {"proc": _source or f"proc:{os.getpid()}"}
            m[0].inc(sent, tags=proc)
            global _dropped_exported
            if dropped > _dropped_exported:
                m[1].inc(dropped - _dropped_exported, tags=proc)
                _dropped_exported = dropped
        except Exception:  # noqa: BLE001
            pass


_dropped_exported = 0


def flush(timeout: float = 2.0) -> bool:
    """Snapshot + push synchronously (tests, shutdown). True if the
    pending queue drained within the timeout."""
    _ensure_pusher()
    deadline = time.monotonic() + timeout
    _wake.set()
    while time.monotonic() < deadline:
        with _lock:
            if _sink is None:
                return False
            empty = not _pending
        if empty:
            # force one fresh snapshot through before declaring success
            try:
                _push_once()
            except Exception:  # noqa: BLE001
                pass
            with _lock:
                return not _pending
        _wake.set()
        time.sleep(0.01)
    return False


def local_stats() -> Dict:
    with _lock:
        return {
            "pending": len(_pending),
            "dropped": _dropped,
            "pushed": _pushed,
            "sink_installed": _sink is not None,
            "excluded_prefixes": sorted(_excluded_prefixes),
        }


def clear_for_tests() -> None:
    """Reset queue + counters (NOT the sink) between test scenarios."""
    global _dropped, _pushed, _dropped_exported
    with _lock:
        _pending.clear()
        _dropped = 0
        _pushed = 0
        _dropped_exported = 0
        _excluded_prefixes.clear()
