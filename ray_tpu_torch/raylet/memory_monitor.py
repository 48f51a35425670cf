"""Node memory monitor + OOM worker-killing policies.

Reference: ray src/ray/common/memory_monitor.h:52 (threshold check over
/proc meminfo + cgroup limits) and the raylet worker-killing policies
(raylet/worker_killing_policy.h:34 — prefer killing retriable tasks,
last-started first; group-by-owner variant :85). When node memory crosses
the threshold the raylet kills a victim worker instead of letting the
kernel OOM-killer take down the raylet or arbitrary processes.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

logger = logging.getLogger(__name__)


def system_memory_usage_fraction() -> float:
    """Used/total from /proc/meminfo (MemAvailable-based, like the
    reference's memory_monitor.cc)."""
    try:
        info = {}
        with open("/proc/meminfo") as f:
            for line in f:
                parts = line.split()
                if len(parts) >= 2:
                    info[parts[0].rstrip(":")] = int(parts[1])
        total = info.get("MemTotal", 0)
        avail = info.get("MemAvailable", total)
        if total <= 0:
            return 0.0
        return 1.0 - avail / total
    except OSError:
        return 0.0


@dataclass
class WorkerCandidate:
    worker_id: object
    is_actor: bool
    retriable: bool           # task has retries left / actor restartable
    start_time: float         # when the current task/actor started
    owner_id: Optional[str] = None


def retriable_lifo_policy(candidates: List[WorkerCandidate]
                          ) -> Optional[WorkerCandidate]:
    """The reference's default: kill the LAST-started RETRIABLE task first
    (it has made the least progress and can be retried); fall back to the
    last-started non-retriable; actors last (most state to lose)."""
    def sort_key(c: WorkerCandidate) -> Tuple:
        return (
            c.is_actor,          # tasks before actors
            not c.retriable,     # retriable before non-retriable
            -c.start_time,       # youngest first
        )

    if not candidates:
        return None
    return sorted(candidates, key=sort_key)[0]


def group_by_owner_policy(candidates: List[WorkerCandidate]
                          ) -> Optional[WorkerCandidate]:
    """Reference worker_killing_policy.h:85: pick the owner (driver/actor)
    with the MOST workers and kill its youngest — spreads memory pressure
    fairly across jobs instead of starving one."""
    if not candidates:
        return None
    groups: dict = {}
    for c in candidates:
        groups.setdefault(c.owner_id, []).append(c)
    biggest = max(groups.values(), key=len)
    return retriable_lifo_policy(biggest)


class MemoryMonitor:
    def __init__(
        self,
        get_usage: Callable[[], float] = system_memory_usage_fraction,
        threshold: float = 0.95,
        min_kill_interval_s: float = 2.0,
    ):
        self.get_usage = get_usage
        self.threshold = threshold
        self.min_kill_interval_s = min_kill_interval_s
        self._last_kill = 0.0

    def should_kill(self) -> bool:
        if self.get_usage() < self.threshold:
            return False
        now = time.monotonic()
        if now - self._last_kill < self.min_kill_interval_s:
            return False
        self._last_kill = now
        return True
