"""In-process live profiling: CPU flamegraphs + heap snapshots.

Reference capability: the dashboard's py-spy CPU profiling
(dashboard/modules/reporter/profile_manager.py:83) and memray heap
profiling (:192). Neither tool ships in this image, so both are
implemented natively:

- CPU: a sampling profiler over `sys._current_frames()` — folded-stack
  output (`a;b;c count` per line, flamegraph.pl / speedscope compatible).
  Pure Python sampling (~50-100us/sample) is fine at the default 10ms
  interval; unlike py-spy it needs no ptrace and works in-process.
- Heap: `tracemalloc` snapshots grouped by allocation site.

Exposed on every worker via the profile_cpu / profile_memory RPCs
(core_worker), fanned out through the raylet by `ray-tpu profile`.
"""

from __future__ import annotations

import sys
import threading
import time
import traceback
from typing import Dict, List, Optional


def sample_cpu_profile(duration_s: float = 5.0,
                       interval_ms: float = 10.0,
                       exclude_thread: Optional[int] = None
                       ) -> Dict[str, object]:
    """Sample all threads' stacks for duration_s -> folded stack counts."""
    folded: Dict[str, int] = {}
    names = {}
    samples = 0
    deadline = time.monotonic() + duration_s
    interval = max(0.001, interval_ms / 1000.0)
    while time.monotonic() < deadline:
        for t in threading.enumerate():
            names[t.ident] = t.name
        for ident, frame in sys._current_frames().items():
            if ident == threading.get_ident() or ident == exclude_thread:
                continue  # never profile the profiler
            stack: List[str] = []
            for fs in traceback.extract_stack(frame):
                stack.append(f"{fs.name} ({fs.filename.rsplit('/', 1)[-1]}"
                             f":{fs.lineno})")
            key = names.get(ident, str(ident)) + ";" + ";".join(stack)
            folded[key] = folded.get(key, 0) + 1
        samples += 1
        time.sleep(interval)
    return {"folded": folded, "samples": samples,
            "duration_s": duration_s, "interval_ms": interval_ms}


def folded_to_text(profile: Dict[str, object], top: int = 0) -> str:
    """flamegraph.pl-compatible text (one `stack count` line each)."""
    items = sorted(profile["folded"].items(), key=lambda kv: -kv[1])
    if top:
        items = items[:top]
    return "\n".join(f"{stack} {count}" for stack, count in items)


def heap_snapshot(top: int = 30, stop: bool = False,
                  duration_s: float = 0.0) -> Dict[str, object]:
    """Top allocation sites by retained size. First call starts
    tracemalloc (only subsequent allocations are tracked — same contract
    as attaching memray to a live process). Pass ``stop=True`` to disarm
    tracing afterwards — tracemalloc taxes every allocation for as long
    as it runs, so profiled workers need a way back to full speed.

    ``duration_s`` makes a cold call usable in ONE round trip: when
    tracemalloc is not yet tracing, start it, sample for ``duration_s``,
    and return the snapshot — without it the first `ray-tpu profile
    --memory` only armed tracing and returned no data, and the heap
    path was effectively unreachable from the CLI.

    The result carries both per-line ``stats`` and flamegraph-compatible
    ``folded`` stacks (size bytes as the fold count; render with
    folded_to_text, invert with parse_folded)."""
    import tracemalloc

    if not tracemalloc.is_tracing():
        if stop:
            return {"started": False, "stats": [], "stopped": True,
                    "folded": {},
                    "note": "tracemalloc was not running"}
        tracemalloc.start(10)
        if duration_s <= 0:
            return {"started": True, "stats": [], "folded": {},
                    "note": "tracemalloc started; snapshot again to see "
                            "allocations made from now on"}
        time.sleep(duration_s)
    snap = tracemalloc.take_snapshot()
    stats = snap.statistics("lineno")[:top]
    out = []
    for s in stats:
        frame = s.traceback[0]
        out.append({"file": frame.filename, "line": frame.lineno,
                    "size_bytes": s.size, "count": s.count})
    folded: Dict[str, int] = {}
    for s in snap.statistics("traceback")[:max(top, 100)]:
        # tracemalloc stores frames most-recent-LAST; folded stacks read
        # root-first, which matches — join as-is
        stack = ";".join(
            f"{f.filename.rsplit('/', 1)[-1]}:{f.lineno}"
            for f in s.traceback)
        folded[stack] = folded.get(stack, 0) + s.size
    current, peak = tracemalloc.get_traced_memory()
    if stop:
        tracemalloc.stop()
    return {"started": False, "stats": out, "stopped": stop,
            "folded": folded,
            "traced_current_bytes": current, "traced_peak_bytes": peak}


def parse_folded(text: str) -> Dict[str, int]:
    """Invert folded_to_text: `stack count` lines back into the folded
    dict (blank/comment lines skipped) — the round-trip contract the
    profiling tests pin for both the CPU and heap profilers."""
    out: Dict[str, int] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        stack, _, count = line.rpartition(" ")
        if not stack or not count.isdigit():
            continue
        out[stack] = out.get(stack, 0) + int(count)
    return out
