"""Deadline propagation helpers (doomed-work elimination).

A task's deadline is an ABSOLUTE wall-clock instant (`time.time()`
domain) carried on its TaskSpec. It is absolute in process memory so
requeues/retries never extend it, but it rides the wire as REMAINING
time (specs.spec_to_wire stamps `deadline - now`, spec_from_wire
re-anchors `now + remaining`), so a modest clock skew between hosts
shifts the budget rather than corrupting it.

Sources, earliest wins (`effective_deadline`):

* explicit `.options(deadline_s=...)` — relative seconds from submission;
* the AMBIENT submission deadline — a thread-scoped override the serve
  proxy installs from the request's `X-Request-Deadline` /
  `X-Request-Timeout-S` header, so work submitted on behalf of an HTTP
  request inherits the client's patience without plumbing a parameter
  through every layer;
* the PARENT task's deadline — children inherit the remaining budget
  (a child of doomed work is doomed work).

Enforcement is at every queue-pop: the owner's submit pump, the raylet
lease queue, and the worker executor all drop already-expired specs,
emit `task.deadline_expired`, count
`ray_tpu_deadline_expired_total{layer=...}`, and the caller gets a typed
`DeadlineExceededError`.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

_ambient = threading.local()


class ambient_deadline:
    """Context manager installing a thread-scoped absolute submission
    deadline (`time.time()` domain). Nested scopes keep the earliest."""

    def __init__(self, deadline: Optional[float]):
        self.deadline = deadline
        self._prev: Optional[float] = None

    def __enter__(self):
        self._prev = getattr(_ambient, "deadline", None)
        if self.deadline is not None:
            if self._prev is not None:
                _ambient.deadline = min(self._prev, self.deadline)
            else:
                _ambient.deadline = self.deadline
        return self

    def __exit__(self, *exc):
        _ambient.deadline = self._prev
        return False


def current_ambient_deadline() -> Optional[float]:
    return getattr(_ambient, "deadline", None)


def effective_deadline(explicit_rel_s: Optional[float],
                       parent_abs: Optional[float],
                       now: Optional[float] = None) -> Optional[float]:
    """Absolute deadline for a new submission: min of the explicit
    relative budget, the ambient submission deadline, and the parent's
    remaining budget. None when nothing constrains the task."""
    now = time.time() if now is None else now
    candidates = []
    if explicit_rel_s is not None:
        candidates.append(now + float(explicit_rel_s))
    ambient = current_ambient_deadline()
    if ambient is not None:
        candidates.append(ambient)
    if parent_abs is not None:
        candidates.append(parent_abs)
    return min(candidates) if candidates else None


def expired(deadline_abs: Optional[float],
            now: Optional[float] = None) -> bool:
    if deadline_abs is None:
        return False
    return (time.time() if now is None else now) >= deadline_abs


def remaining_s(deadline_abs: Optional[float],
                now: Optional[float] = None) -> Optional[float]:
    if deadline_abs is None:
        return None
    return deadline_abs - (time.time() if now is None else now)
