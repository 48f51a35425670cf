"""Process-wide registry of paged-KV block pools (memory observability).

The port's copy of `ray_tpu/_private/kv_registry.py`. The paged engine's
block pool is a ref-counted memory plane: blocks move between free,
cached (LRU) and active (refcount > 0), and a pin leak there exhausts
decode capacity. Engines register on construction, weakly, so a dropped
engine disappears from reports; `report_all` snapshots every live one.
The `ray_tpu_kv_blocks{state}` gauge the reference refreshes here waits
for a port of `ray_tpu.util.metrics`.
"""

from __future__ import annotations

import threading
import weakref
from typing import Any, Dict, List

_lock = threading.Lock()
_engines: "weakref.WeakValueDictionary[int, Any]" = weakref.WeakValueDictionary()
_next_id = 0


def register(engine: Any) -> None:
    """Called by PagedInferenceEngine.__init__ (any object exposing
    ``kv_block_report()`` works)."""
    global _next_id
    with _lock:
        _next_id += 1
        _engines[_next_id] = engine


def report_all() -> List[Dict[str, Any]]:
    """Every live engine's KV block-pool report. An engine whose report
    fails (mid-teardown) is left out; the report degrades, it does not
    die."""
    with _lock:
        engines = list(_engines.values())
    reports: List[Dict[str, Any]] = []
    for eng in engines:
        try:
            reports.append(eng.kv_block_report())
        except Exception:  # noqa: BLE001 — engine mid-teardown
            continue
    return reports
