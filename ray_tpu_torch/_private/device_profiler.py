"""Step-phase accounting of the train loop's steps and the engine's decode
waves.

The port's counterpart of `ray_tpu/_private/device_profiler.py`
(`get_profiler`, `DeviceStepProfiler.step` / `record_step` / `report`).
A train loop wraps each step in `step(tokens)` and its parts in
`phase(name)`; a phase ends when the device has finished the value given
to its `fence()` (the work queued on that tensor's stream so far), where
the reference waits with `jax.block_until_ready`. `external(name, s)`
attributes seconds measured elsewhere. A decode wave records the
host-measured seconds of its phases (input_wait, prefill, device_execute,
reply) with `record_step`; the engine's one device-to-host copy of a
wave's tokens ends its device_execute. `report()` gives totals, the
fraction of accounted time per phase, the compile seconds and the MFU of
the last step with a device_execute phase: flops_per_step over its seconds
and the card's peak (`peak_flops_per_chip`; one card, where the reference
multiplies the peak by its devices).

Compile seconds are what a caller puts in the "compile" phase (the bench
wraps its first, compiling step in it); the reference carves backend
compiles out of any phase through a `jax.monitoring` listener, which
torch.compile has no stable counterpart of. Device memory comes from
`torch.cuda.memory_stats` on the card; on the CPU there is none, as the
reference reports none for CPU devices. The metrics (phase histogram, MFU
and memory gauges) and `event_log` emission wait for ports of
`ray_tpu.util.metrics` and `ray_tpu._private.event_log`.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Dict, Iterator, Optional

import torch

from ray_tpu_torch._private.device import resolve_device

# The phases of a train step (input_wait, h2d, compile, device_execute) and
# of a decode wave (input_wait, prefill, device_execute, reply).
PHASES = ("input_wait", "h2d", "compile", "prefill", "device_execute",
          "reply")

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


def _tensors(value) -> Iterator[torch.Tensor]:
    if isinstance(value, torch.Tensor):
        yield value
    elif isinstance(value, dict):
        for v in value.values():
            yield from _tensors(v)
    elif isinstance(value, (list, tuple)):
        for v in value:
            yield from _tensors(v)


def _block(value) -> None:
    """Fence: wait until the work queued so far on the current stream of
    each CUDA device that holds a tensor of `value` is done. CPU tensors
    and other leaves are ready already."""
    for dev in {t.device for t in _tensors(value) if t.is_cuda}:
        torch.cuda.current_stream(dev).synchronize()


class _Phase:
    """One timed, fenced phase inside a step scope."""

    __slots__ = ("_scope", "_name", "_t0", "_fence")

    def __init__(self, scope: "_StepScope", name: str):
        self._scope = scope
        self._name = name
        self._fence = None

    def fence(self, value):
        """Register the value (a tensor, or nested dicts, lists and tuples
        of them) whose readiness ends this phase; returns it."""
        self._fence = value
        return value

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None and self._fence is not None:
            _block(self._fence)
        self._scope.external(self._name, time.perf_counter() - self._t0)
        self._fence = None
        return False


class _StepScope:
    """One step's phase accounting; created by DeviceStepProfiler.step()."""

    __slots__ = ("_prof", "_phases", "_tokens")

    def __init__(self, prof: "DeviceStepProfiler", tokens: Optional[int]):
        self._prof = prof
        self._phases: Dict[str, float] = {}
        self._tokens = tokens

    def phase(self, name: str) -> _Phase:
        return _Phase(self, name)

    def external(self, name: str, seconds: float) -> None:
        """Attribute seconds measured elsewhere to a phase of this step."""
        self._phases[name] = self._phases.get(name, 0.0) + max(0.0, seconds)

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            self._prof.record_step(self._phases, tokens=self._tokens)
        return False


class DeviceStepProfiler:
    """Phase accounting for a repeated device program (a train step, a
    decode wave). Thread-safe; one instance per logical step stream."""

    def __init__(self, name: str, *, device=None,
                 flops_per_step: Optional[float] = None,
                 peak_flops_per_chip: Optional[float] = None):
        self.name = name
        self.device = resolve_device(device)
        self.flops_per_step = flops_per_step
        self.peak_flops_per_chip = peak_flops_per_chip
        self._steps: deque = deque(maxlen=1024)
        self._totals: Dict[str, float] = {}
        self._n = 0
        self._mfu_last: Optional[float] = None
        self._lock = threading.Lock()

    def step(self, tokens: Optional[int] = None) -> _StepScope:
        """A scope around one step: its phases are recorded when it ends
        without an exception."""
        return _StepScope(self, tokens)

    def record_step(self, phases: Dict[str, float],
                    tokens: Optional[int] = None) -> None:
        """Record one already-timed step: {phase: seconds}, ending now."""
        total = sum(phases.values())
        mfu = None
        dev = phases.get("device_execute", 0.0)
        if self.flops_per_step and self.peak_flops_per_chip and dev > 0:
            mfu = self.flops_per_step / dev / self.peak_flops_per_chip
        rec = {"time": time.time() - total, "total": total,
               "phases": dict(phases), "mfu": mfu, "tokens": tokens}
        with self._lock:
            self._steps.append(rec)
            self._n += 1
            if mfu is not None:
                self._mfu_last = mfu
            for ph, dur in phases.items():
                self._totals[ph] = self._totals.get(ph, 0.0) + max(0.0, dur)

    def report(self, recent: int = 64,
               include_hbm: bool = True) -> Dict[str, Any]:
        """Totals, the fraction of accounted time per phase
        (input_wait_frac, device_execute_frac, ...), the compile seconds,
        the last MFU, device memory, and the last `recent` step records
        (none for recent=0)."""
        with self._lock:
            totals = dict(self._totals)
            steps = self._n
            recent_steps = list(self._steps)[-recent:] if recent > 0 else []
            mfu = self._mfu_last
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
            "compile_s": round(totals.get("compile", 0.0), 6),
            "mfu": mfu,
            **fracs,
            "hbm": hbm_stats(self.device) if include_hbm else {},
            "recent_steps": recent_steps,
        }

    def reset(self) -> None:
        with self._lock:
            self._steps.clear()
            self._totals.clear()
            self._n = 0
            self._mfu_last = None


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
