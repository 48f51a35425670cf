"""Unified retry policy: exponential backoff, AIMD pacing, retry budgets.

THE retry-policy module (CONTRIBUTING: new RPC callers route their retry
delays and budgets through here). Before it, the tree carried at
least three hand-rolled copies of the same policy — the raylet->GCS
heartbeat reconnect, the owner's actor-push requeue, and the
owner's lease re-ask — each with its own constants and its own bugs
waiting to diverge. Worse, none of them had a *budget*: during a
brownout every caller retried independently, multiplying offered load
exactly when capacity was lowest (the retry-storm half of metastable
collapse; cf. the Gemma-on-TPU serving comparison in PAPERS.md).

Three primitives:

* `BackoffPolicy` — exponential backoff with jitter. `delay(attempt)` is
  a pure function of (attempt, rng), so a seeded rng gives a node a
  reproducible schedule while different nodes stay decorrelated (the
  heartbeat reconnect's property, now shared).
* `AIMDPacer` — congestion-style pacing for *pushback* (typed
  RetryLaterError / retry_later replies from a bounded queue):
  multiplicative increase of the resubmission delay on every pushback,
  additive decrease on success. The owner paces; it never hammers a
  queue that told it "later".
* `RetryBudget` — token buckets keyed by (peer, method). Every retry
  spends a token; tokens refill at a bounded rate. When a bucket is dry
  the caller FAILS FAST with the underlying error instead of amplifying
  a brownout into a storm. `ray_tpu_retry_budget_exhausted_total`
  counts the fail-fasts.

Shed/doomed-work observability lives here too (`count_shed`,
`count_deadline_expired`) so every layer increments the same
`ray_tpu_shed_total{layer=...}` / `ray_tpu_deadline_expired_total`
series next to its `task.shed` / `task.deadline_expired` event emit.
"""

from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

_metrics_lock = threading.Lock()
_counters: Dict[str, object] = {}
_metrics_failed = False


def _counter(name: str, desc: str, tag_keys: Tuple[str, ...]):
    """Lazily-created Counter; never lets a metrics failure break a
    retry path (same contract as event_log's metrics)."""
    global _metrics_failed
    if _metrics_failed:
        return None
    with _metrics_lock:
        c = _counters.get(name)
        if c is None:
            try:
                from ray_tpu_torch.util.metrics import Counter, get_metric

                c = get_metric(name)
                if c is None:
                    c = Counter(name, desc, tag_keys=tag_keys)
                _counters[name] = c
            except Exception:  # noqa: BLE001 — metrics must never break retries
                _metrics_failed = True
                return None
        return c


def count_shed(layer: str, n: int = 1) -> None:
    """One refused-with-pushback unit of work (bounded queue overflow,
    429/503 shed): `ray_tpu_shed_total{layer=...}`."""
    c = _counter("ray_tpu_shed_total",
                 "Work refused with typed pushback, by layer",
                 ("layer",))
    if c is not None:
        try:
            c.inc(n, tags={"layer": layer})
        except Exception:  # noqa: BLE001
            pass


def count_deadline_expired(layer: str, n: int = 1) -> None:
    """One unit of doomed work dropped at queue-pop:
    `ray_tpu_deadline_expired_total{layer=...}`."""
    c = _counter("ray_tpu_deadline_expired_total",
                 "Already-expired work dropped at queue-pop, by layer",
                 ("layer",))
    if c is not None:
        try:
            c.inc(n, tags={"layer": layer})
        except Exception:  # noqa: BLE001
            pass


def count_budget_exhausted(method: str, n: int = 1) -> None:
    c = _counter("ray_tpu_retry_budget_exhausted_total",
                 "Retries refused by an empty (peer,method) token bucket "
                 "(caller failed fast with the underlying error)",
                 ("method",))
    if c is not None:
        try:
            c.inc(n, tags={"method": method})
        except Exception:  # noqa: BLE001
            pass


def retry_after_hint(depth: int, per_item_s: float = 0.001,
                     floor_s: float = 0.5, cap_s: float = 5.0) -> float:
    """THE retry-after hint a bounded queue attaches to its pushback:
    scaled to the backlog it would have to drain (depth x per-item cost),
    floored so a just-full queue doesn't invite an instant re-hammer,
    capped so a deep backlog doesn't park callers for minutes. One
    formula for every shed site (raylet lease queue, GCS creation queue,
    actor mailbox) — divergent hand-tuned hints are how pacing policies
    drift apart."""
    return min(cap_s, max(floor_s, depth * per_item_s))


@dataclass
class BackoffPolicy:
    """Exponential backoff with downward jitter.

    delay(attempt) = min(base_s * multiplier^min(attempt, max_exponent),
                         max_s) * (1 - jitter * rng.random())

    `attempt` counts consecutive failures starting at 1 (attempt 0 means
    "no failure yet" and returns 0.0). The formula is bit-for-bit the
    raylet's earlier heartbeat-reconnect schedule (parity-tested in
    tests/test_overload.py), now shared by every call site.
    """

    base_s: float = 0.2
    multiplier: float = 2.0
    max_s: float = 5.0
    jitter: float = 0.0          # fraction of the delay subtracted
    max_exponent: int = 10       # caps multiplier^n overflow
    rng: random.Random = field(default_factory=random.Random)

    def delay(self, attempt: int) -> float:
        if attempt <= 0:
            return 0.0
        base = min(self.base_s * (self.multiplier
                                  ** min(attempt, self.max_exponent)),
                   self.max_s)
        if self.jitter:
            base *= 1.0 - self.jitter * self.rng.random()
        return base


class AIMDPacer:
    """Delay-domain AIMD for typed pushback.

    on_pushback(hint) — multiplicative increase: the resubmission delay
    doubles (from `base_s`), floored at the queue's own retry-after
    hint, capped at `max_s`.
    on_success() — additive decrease: the delay shrinks by `decrease_s`
    toward zero, so a recovered queue regains full submission rate in a
    few successes rather than instantly (no thundering re-herd).
    """

    def __init__(self, base_s: float = 0.05, multiplier: float = 2.0,
                 decrease_s: float = 0.05, max_s: float = 5.0):
        self.base_s = base_s
        self.multiplier = multiplier
        self.decrease_s = decrease_s
        self.max_s = max_s
        self._delay = 0.0
        self._lock = threading.Lock()

    @property
    def delay_s(self) -> float:
        return self._delay

    def on_pushback(self, hint_s: Optional[float] = None) -> float:
        with self._lock:
            grown = self._delay * self.multiplier if self._delay else self.base_s
            self._delay = min(self.max_s, max(grown, hint_s or 0.0))
            return self._delay

    def on_success(self) -> float:
        with self._lock:
            self._delay = max(0.0, self._delay - self.decrease_s)
            return self._delay


class RetryBudget:
    """Token-bucket retry budgets keyed by (peer, method).

    Each key's bucket starts full (`capacity` tokens) and refills at
    `fill_per_s`. `try_spend` takes one token and returns True; an empty
    bucket returns False — the caller must fail fast with the underlying
    error (and the refusal is counted). Disabled budgets always grant
    (the chaos-brownout e2e compares amplification on vs off).
    """

    def __init__(self, capacity: float = 10.0, fill_per_s: float = 1.0,
                 enabled: bool = True, max_keys: int = 4096):
        self.capacity = float(capacity)
        self.fill_per_s = float(fill_per_s)
        self.enabled = enabled
        self._max_keys = max_keys
        self._buckets: Dict[Tuple[str, str], Tuple[float, float]] = {}
        self._lock = threading.Lock()

    def tokens(self, peer: str, method: str,
               now: Optional[float] = None) -> float:
        now = time.monotonic() if now is None else now
        with self._lock:
            level, at = self._buckets.get((peer, method),
                                          (self.capacity, now))
            return min(self.capacity, level + (now - at) * self.fill_per_s)

    def try_spend(self, peer: str, method: str,
                  now: Optional[float] = None) -> bool:
        if not self.enabled:
            return True
        now = time.monotonic() if now is None else now
        with self._lock:
            if ((peer, method) not in self._buckets
                    and len(self._buckets) >= self._max_keys):
                # bounded key table: evict the stalest bucket (a full
                # bucket by now) instead of growing per dead peer forever
                stalest = min(self._buckets, key=lambda k: self._buckets[k][1])
                del self._buckets[stalest]
            level, at = self._buckets.get((peer, method),
                                          (self.capacity, now))
            level = min(self.capacity, level + (now - at) * self.fill_per_s)
            if level < 1.0:
                self._buckets[(peer, method)] = (level, now)
                count_budget_exhausted(method)
                return False
            self._buckets[(peer, method)] = (level - 1.0, now)
            return True


_default_budget: Optional[RetryBudget] = None
_default_budget_lock = threading.Lock()


def default_retry_budget() -> RetryBudget:
    """Process-wide budget configured from CONFIG (retry_budget_capacity /
    retry_budget_fill_per_s / retry_budget_enabled)."""
    global _default_budget
    if _default_budget is None:
        with _default_budget_lock:
            if _default_budget is None:
                from ray_tpu_torch._private.config import CONFIG

                _default_budget = RetryBudget(
                    capacity=CONFIG.retry_budget_capacity,
                    fill_per_s=CONFIG.retry_budget_fill_per_s,
                    enabled=CONFIG.retry_budget_enabled,
                )
    return _default_budget


def reset_default_retry_budget() -> None:
    """Test hook: drop the memoized budget so CONFIG overrides apply."""
    global _default_budget
    with _default_budget_lock:
        _default_budget = None
