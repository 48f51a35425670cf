"""Process-wide registry of paged-KV block pools (memory observability).

The port's copy of `ray_tpu/_private/kv_registry.py`. The paged engine's
block pool is a ref-counted memory plane: blocks move between free,
cached (LRU) and active (refcount > 0), and a pin leak there exhausts
decode capacity. Engines register on construction, weakly, so a dropped
engine disappears from reports; `report_all` snapshots every live one and
refreshes the `ray_tpu_kv_blocks{state}` gauge with the free, cached and
active blocks summed over them.

After `util.metrics.use_runtime(kv_registry=...)` each engine also
registers with the runtime's registry, whose `report_all` answers the
worker's `memory_report()["kv"]` and sums the gauge over every engine
registered there, the port's included: this module's `report_all` then
refreshes the gauge through it, so that one family holds one sum.
"""

from __future__ import annotations

import threading
import weakref
from typing import Any, Callable, Dict, List

from ray_tpu_torch.util import metrics

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
    runtime_kv = metrics.runtime()["kv_registry"]
    if runtime_kv is not None:
        runtime_kv.register(engine)


def forward_live(register_fn: Callable[[Any], None]) -> None:
    """Register every live engine with `register_fn` (the runtime's)."""
    with _lock:
        engines = list(_engines.values())
    for eng in engines:
        register_fn(eng)


def _blocks_gauge():
    return metrics.backend().get_or_create_gauge(
        "ray_tpu_kv_blocks",
        "Paged-KV block pool occupancy by state (free / cached / active), "
        "summed over this process's engines",
        tag_keys=("state",))


def report_all() -> List[Dict[str, Any]]:
    """Every live engine's KV block-pool report; also refreshes the
    ray_tpu_kv_blocks{state} gauge. An engine whose report fails
    (mid-teardown) is left out; the report degrades, it does not die."""
    with _lock:
        engines = list(_engines.values())
    reports: List[Dict[str, Any]] = []
    totals = {"free": 0, "cached": 0, "active": 0}
    for eng in engines:
        try:
            rep = eng.kv_block_report()
        except Exception:  # noqa: BLE001 — engine mid-teardown
            continue
        reports.append(rep)
        for state in totals:
            totals[state] += int(rep.get(f"{state}_blocks", 0))
    if reports:
        runtime_kv = metrics.runtime()["kv_registry"]
        if runtime_kv is not None:
            runtime_kv.report_all()
        else:
            g = _blocks_gauge()
            for state, n in totals.items():
                g.set(float(n), tags={"state": state})
    return reports
