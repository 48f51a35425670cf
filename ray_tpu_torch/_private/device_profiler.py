"""Step-phase accounting of the engine's decode waves.

The port's counterpart of `ray_tpu/_private/device_profiler.py`
(`get_profiler`, `DeviceStepProfiler.record_step` and `report`): each
decode wave records the host-measured seconds of its phases (input_wait,
prefill, device_execute, reply); `report()` gives totals and the fraction
of accounted time per phase, which the engine's `stats()` carries. The
caller fences its own device phase (the engine's one device-to-host copy
of a wave's tokens ends its device_execute).

Device memory comes from `torch.cuda.memory_stats` on the card; on the
CPU there is none, as the reference reports none for CPU devices. Not
ported: the fenced step scopes of the train loop, `jax.monitoring`
compile telemetry (PyTorch runs eagerly and the decode graphs are
captured once, so there is no compile phase to carve out), MFU, and the
metrics and `event_log` emission, which wait for ports of
`ray_tpu.util.metrics` and `ray_tpu._private.event_log`.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Dict, Optional

import torch

from ray_tpu_torch._private.device import resolve_device

# The phases an engine's decode wave records (the reference's list has h2d
# and compile too, which no port caller records).
PHASES = ("input_wait", "prefill", "device_execute", "reply")

_lock = threading.Lock()
_registry: Dict[str, "DeviceStepProfiler"] = {}


def hbm_stats(device) -> Dict[str, int]:
    """Device memory of `device` from the caching allocator: bytes in use,
    their peak and the card's total; {} on the CPU."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return {}
    stats = torch.cuda.memory_stats(dev)
    return {"bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak",
                                               0)),
            "bytes_limit": int(torch.cuda.get_device_properties(
                dev).total_memory)}


class DeviceStepProfiler:
    """Phase accounting for a repeated device program (a decode wave).
    Thread-safe; one instance per logical step stream."""

    def __init__(self, name: str, *, device=None):
        self.name = name
        self.device = resolve_device(device)
        self._steps: deque = deque(maxlen=1024)
        self._totals: Dict[str, float] = {}
        self._n = 0
        self._lock = threading.Lock()

    def record_step(self, phases: Dict[str, float],
                    tokens: Optional[int] = None) -> None:
        """Record one already-timed step: {phase: seconds}, ending now."""
        total = sum(phases.values())
        rec = {"time": time.time() - total, "total": total,
               "phases": dict(phases), "tokens": tokens}
        with self._lock:
            self._steps.append(rec)
            self._n += 1
            for ph, dur in phases.items():
                self._totals[ph] = self._totals.get(ph, 0.0) + max(0.0, dur)

    def report(self, recent: int = 64,
               include_hbm: bool = True) -> Dict[str, Any]:
        """Totals, the fraction of accounted time per phase
        (input_wait_frac, device_execute_frac, ...), device memory, and the
        last `recent` step records (none for recent=0)."""
        with self._lock:
            totals = dict(self._totals)
            steps = self._n
            recent_steps = list(self._steps)[-recent:] if recent > 0 else []
        accounted = sum(totals.values()) or 1.0
        fracs = {f"{ph}_frac": round(totals.get(ph, 0.0) / accounted, 4)
                 for ph in PHASES}
        for ph in set(totals) - set(PHASES):
            fracs[f"{ph}_frac"] = round(totals[ph] / accounted, 4)
        return {
            "profiler": self.name,
            "steps": steps,
            "phase_seconds": {k: round(v, 6) for k, v in totals.items()},
            "accounted_s": round(accounted if totals else 0.0, 6),
            **fracs,
            "hbm": hbm_stats(self.device) if include_hbm else {},
            "recent_steps": recent_steps,
        }

    def reset(self) -> None:
        with self._lock:
            self._steps.clear()
            self._totals.clear()
            self._n = 0


def get_profiler(name: str, **kwargs) -> DeviceStepProfiler:
    """Process-wide registry by name: the first caller creates, later
    callers share it; construction kwargs apply only on creation, but a
    `device` is resolved on every call (so it raises without CUDA unless
    given "cpu")."""
    resolve_device(kwargs.get("device"))
    with _lock:
        prof = _registry.get(name)
        if prof is None:
            prof = _registry[name] = DeviceStepProfiler(name, **kwargs)
        return prof
