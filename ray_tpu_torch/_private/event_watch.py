"""Consumer-side protocol for watching the cluster event log.

Everything that REACTS to cluster events — the serve controller's
preempt-notice sweep, the train gang's preemption watcher, drill
scenarios waiting on recovery markers — polls `get_cluster_events` and
must agree on three load-bearing details:

  * IDENTITY is (proc, pid, seq). Pids are reused across hosts and
    per-process seqs all start at 0, so (pid, seq) alone collides on
    multi-host clusters and a second node's notice gets swallowed.
  * ORDER: the server returns newest-first; consumers act in
    chronological order (reversed).
  * THE SINCE ANCHOR advances to just before the newest consumed event,
    keeping `slack` seconds of clock-skew window; the seen-set absorbs
    the overlap so nothing is double-handled and nothing is skipped.

EventCursor is that protocol in one place. It deliberately knows
nothing about transport beyond a callable with `get_cluster_events`
semantics — the default resolves this process's GCS connection lazily
so importing the module stays side-effect free.
"""

from __future__ import annotations

import time
from typing import Callable, List, Optional

SKEW_SLACK_S = 5.0


def _default_call(method: str, payload: dict, timeout: float):
    from ray_tpu_torch._raylet import get_core_worker

    return get_core_worker()._gcs.call(method, payload, timeout=timeout)


class EventCursor:
    """Incremental, exactly-once view of one event type in the cluster
    log. `poll()` returns only events not seen by THIS cursor, in
    chronological order, and returns [] (never raises) when the GCS is
    unreachable mid-restart/fault — callers just retry next tick.

    `advance=False` freezes the since anchor at its initial value (with
    `slack=0.0` that is exactly the caller's cut-off): drill scenarios
    use this to ask "first event strictly after the injection" without
    the skew slack re-admitting pre-injection history.
    """

    def __init__(self, etype: str, since: Optional[float] = None,
                 slack: float = SKEW_SLACK_S, advance: bool = True,
                 call: Optional[Callable] = None):
        self.etype = etype
        self.since = (time.time() if since is None else since) - slack
        self._slack = slack
        self._advance = advance
        self._call = call or _default_call
        self._seen: set = set()

    def poll(self, limit: int = 100, timeout: float = 5.0) -> List[dict]:
        try:
            events = self._call(
                "get_cluster_events",
                {"type": self.etype, "since": self.since, "limit": limit},
                timeout)
        except Exception:  # noqa: BLE001 — GCS mid-restart/fault: retry
            return []
        return self.fresh(events)

    def fresh(self, events: Optional[List[dict]]) -> List[dict]:
        """Dedup + order a raw newest-first `get_cluster_events` reply;
        usable directly when the caller already holds the events."""
        out: List[dict] = []
        for ev in reversed(events or []):  # newest-first -> chronological
            key = (ev.get("proc"), ev.get("pid"), ev.get("seq"))
            if key in self._seen:
                continue
            self._seen.add(key)
            if self._advance:
                self.since = max(self.since,
                                 ev.get("time", 0.0) - self._slack)
            out.append(ev)
        return out
