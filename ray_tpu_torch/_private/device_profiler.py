"""Step-phase accounting of the train loop's steps and the engine's decode
waves, with its metrics, events and compile telemetry.

The port's counterpart of `ray_tpu/_private/device_profiler.py`
(`get_profiler`, `DeviceStepProfiler.step` / `record_step` / `report`,
`observe_phase`, `hbm_stats`, `compile_stats`, `snapshot_all`,
`steps_to_spans`). A train loop wraps each step in `step(tokens)` and its
parts in `phase(name)`; a phase ends when the device has finished the
value given to its `fence()` (the work queued on that tensor's stream so
far), where the reference waits with `jax.block_until_ready`.
`external(name, s)` attributes seconds measured elsewhere. A decode wave
records the host-measured seconds of its phases (input_wait, prefill,
device_execute, reply) with `record_step`; the engine's one device-to-host
copy of a wave's tokens ends its device_execute. `report()` gives totals,
the fraction of accounted time per phase, the compile seconds and the MFU
of the last step with a device_execute phase: flops_per_step over its
seconds and the card's peak (`peak_flops_per_chip`; one card, where the
reference multiplies the peak by its devices).

Exports, under the reference's names, tags and buckets, into the registry
of `util.metrics` (the runtime's after `use_runtime`):

  ray_tpu_step_phase_seconds{phase,profiler}   histogram, every phase
  ray_tpu_device_mfu{profiler}                 gauge (needs flops_per_step)
  ray_tpu_hbm_bytes_in_use{device}             gauge (torch.cuda.memory_stats)
  ray_tpu_hbm_bytes_peak{device}               gauge

and the events `compile.start` / `compile.end` (one pair per torch.compile
compilation, from `torch._dynamo.callback`'s start and end hooks: dynamo's
tracing, the backend's compile, a lazy backward, a cudagraph recording)
and `perf.phase_report` (`report(emit_event=True)`).

Compile seconds: the listener's seconds since a step began (a scope) or
since the last recorded step (`record_step`) are carved out of that step's
device_execute (else h2d) and added to its "compile" phase, as the
reference carves XLA's backend compiles. A step that already has a
"compile" phase of its own (the bench wraps its first, compiling step in
one) keeps it as it is: the listener's seconds of that step lie inside it
and are not added again. Device memory comes from `torch.cuda.memory_stats`
on the card; CPU devices have none and are left out of `hbm_stats`.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Any, Dict, Iterator, List, Optional

import torch

from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch.util import metrics

# The reference's phases; a decode wave also records "prefill", which
# reports and spans carry as a phase of its own.
PHASES = ("input_wait", "h2d", "compile", "device_execute", "reply")

# One decode chunk (~100 µs) to a compile (minutes).
_PHASE_BOUNDARIES = [
    1e-5, 5e-5, 1e-4, 5e-4, 1e-3, 5e-3, 0.01, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 15.0, 60.0, 300.0,
]

_lock = threading.Lock()
_registry: Dict[str, "DeviceStepProfiler"] = {}

_metrics_lock = threading.Lock()
_families = None
_families_generation = -1


def _metrics():
    """(phase histogram, MFU gauge, (in-use gauge, peak gauge)), made on
    first use in `util.metrics.backend()`, and again after a
    `use_runtime`."""
    global _families, _families_generation
    with _metrics_lock:
        if _families is None or _families_generation != metrics.generation():
            m = metrics.backend()
            hist = m.get_or_create_histogram(
                "ray_tpu_step_phase_seconds",
                "Per-phase device-step latency (input_wait/h2d/compile/"
                "device_execute/reply)",
                boundaries=_PHASE_BOUNDARIES, tag_keys=("phase", "profiler"))
            mfu = m.get_or_create_gauge(
                "ray_tpu_device_mfu",
                "Model FLOPs utilization of the profiled step (device_execute "
                "time vs the per-chip peak-flops table)", ("profiler",))
            hbm = (m.get_or_create_gauge(
                       "ray_tpu_hbm_bytes_in_use",
                       "Device memory in use (device.memory_stats)",
                       ("device",)),
                   m.get_or_create_gauge(
                       "ray_tpu_hbm_bytes_peak",
                       "Peak device memory in use (device.memory_stats)",
                       ("device",)))
            _families = (hist, mfu, hbm)
            _families_generation = metrics.generation()
        return _families


# -- compile telemetry (torch._dynamo's compile start and end hooks) -----------

_compile_lock = threading.Lock()
_compile_seconds = 0.0
_compile_count = 0
_compile_open: Optional[float] = None


def _source(args) -> str:
    trigger = getattr(getattr(args, "callback_trigger", None), "name", None)
    cid = getattr(args, "compile_id", None)
    return ("torch._dynamo" + (f".{trigger.lower()}" if trigger else "")
            + (f":{cid}" if cid else ""))


def _on_compile_start(*args) -> None:
    """Dynamo calls this as its outermost compilation begins, on the
    compiling thread."""
    global _compile_open
    now = time.time()
    with _compile_lock:
        _compile_open = time.perf_counter()
    metrics.emit("compile.start", source=_source(args[0] if args else None),
                 t_start=now)


def _on_compile_end(*args) -> None:
    global _compile_seconds, _compile_count, _compile_open
    with _compile_lock:
        if _compile_open is None:
            return
        duration = time.perf_counter() - _compile_open
        _compile_open = None
        _compile_seconds += duration
        _compile_count += 1
    metrics.emit("compile.end", source=_source(args[0] if args else None),
                 duration_s=duration)


def install_compile_listener() -> None:
    """Install the compile listener (process-wide, idempotent).
    `torch._dynamo.reset()` clears dynamo's callbacks, so profilers
    install it again on construction, in `get_profiler`, at each step
    scope and at each recorded step: a compile after a reset is seen once
    a profiler has been used since the reset."""
    from torch._dynamo.callback import callback_handler

    with _compile_lock:
        if _on_compile_start not in callback_handler.start_callbacks:
            callback_handler.register_start_callback(_on_compile_start)
        if _on_compile_end not in callback_handler.end_callbacks:
            callback_handler.register_end_callback(_on_compile_end)


def compile_stats() -> Dict[str, float]:
    """Cumulative compile telemetry of this process."""
    with _compile_lock:
        return {"compiles": _compile_count, "compile_s": _compile_seconds}


def _compile_now() -> float:
    with _compile_lock:
        return _compile_seconds


# -- device memory --------------------------------------------------------------

def hbm_stats(devices: Optional[List[Any]] = None,
              export: bool = True) -> Dict[str, Dict[str, int]]:
    """Device memory per CUDA device (every visible card for None) from
    the caching allocator: bytes in use, their peak and the card's total,
    exported as the ray_tpu_hbm_bytes_{in_use,peak}{device} gauges. CPU
    devices have no device memory and are left out."""
    if devices is None:
        devices = ([torch.device("cuda", i)
                    for i in range(torch.cuda.device_count())]
                   if torch.cuda.is_available() else [])
    out: Dict[str, Dict[str, int]] = {}
    gauges = _metrics()[2] if export else None
    for d in devices:
        dev = torch.device(d)
        if dev.type != "cuda":
            continue
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        label = str(dev)
        stats = torch.cuda.memory_stats(dev)
        entry = {"bytes_in_use": int(stats.get("allocated_bytes.all.current",
                                               0)),
                 "peak_bytes_in_use": int(stats.get(
                     "allocated_bytes.all.peak", 0)),
                 "bytes_limit": int(torch.cuda.get_device_properties(
                     dev).total_memory)}
        if gauges:
            gauges[0].set(float(entry["bytes_in_use"]), tags={"device": label})
            gauges[1].set(float(entry["peak_bytes_in_use"]),
                          tags={"device": label})
        out[label] = entry
    return out


def observe_phase(phase: str, seconds: float, profiler: str = "data") -> None:
    """One phase sample into the histogram without a step scope: how the
    input pipeline (data/dataset.py) contributes its waits."""
    _metrics()[0].observe(max(0.0, seconds),
                          tags={"phase": phase, "profiler": profiler})


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

    __slots__ = ("_prof", "_phases", "_tokens", "_wall0", "_compile0")

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
        install_compile_listener()
        self._wall0 = time.time()
        self._compile0 = _compile_now()
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            self._prof._finish_step(
                self._wall0, sum(self._phases.values()), dict(self._phases),
                _compile_now() - self._compile0, self._tokens)
        return False


class DeviceStepProfiler:
    """Phase accounting for a repeated device program (a train step, a
    decode wave). Thread-safe; one instance per logical step stream.
    hbm_every: export the device-memory gauges every that many steps (0:
    never)."""

    def __init__(self, name: str, *, device=None,
                 flops_per_step: Optional[float] = None,
                 peak_flops_per_chip: Optional[float] = None,
                 hbm_every: int = 0):
        self.name = name
        self.device = resolve_device(device)
        self.flops_per_step = flops_per_step
        self.peak_flops_per_chip = peak_flops_per_chip
        self.hbm_every = hbm_every
        self._steps: deque = deque(maxlen=1024)
        self._totals: Dict[str, float] = {}
        self._n = 0
        self._mfu_last: Optional[float] = None
        self._lock = threading.Lock()
        # compiles since this mark belong to the next recorded step
        self._compile_mark = _compile_now()
        install_compile_listener()
        _metrics()

    def step(self, tokens: Optional[int] = None) -> _StepScope:
        """A scope around one step: its phases are recorded when it ends
        without an exception."""
        return _StepScope(self, tokens)

    def record_step(self, phases: Dict[str, float],
                    tokens: Optional[int] = None,
                    wall0: Optional[float] = None) -> None:
        """Record one already-timed step: {phase: seconds}, ending now (or
        begun at wall time `wall0`)."""
        install_compile_listener()
        now_c = _compile_now()
        with self._lock:
            mark, self._compile_mark = self._compile_mark, now_c
        total = sum(phases.values())
        self._finish_step(wall0 if wall0 is not None else time.time() - total,
                          total, dict(phases), max(0.0, now_c - mark), tokens)

    def _finish_step(self, wall0: float, total: float,
                     phases: Dict[str, float], compile_d: float,
                     tokens: Optional[int]) -> None:
        hist, mfu_gauge, _ = _metrics()
        with self._lock:
            self._compile_mark = max(self._compile_mark, _compile_now())
        if compile_d > 0 and "compile" not in phases:
            for carve in ("device_execute", "h2d"):
                if phases.get(carve, 0.0) > 0:
                    phases[carve] = max(0.0, phases[carve] - compile_d)
                    break
            phases["compile"] = compile_d
        mfu = None
        dev = phases.get("device_execute", 0.0)
        if self.flops_per_step and self.peak_flops_per_chip and dev > 0:
            mfu = self.flops_per_step / dev / self.peak_flops_per_chip
            mfu_gauge.set(mfu, tags={"profiler": self.name})
        for ph, dur in phases.items():
            hist.observe(max(0.0, dur),
                         tags={"phase": ph, "profiler": self.name})
        rec = {"time": wall0, "total": total, "phases": phases, "mfu": mfu,
               "tokens": tokens}
        with self._lock:
            self._steps.append(rec)
            self._n += 1
            n = self._n
            if mfu is not None:
                self._mfu_last = mfu
            for ph, dur in phases.items():
                self._totals[ph] = self._totals.get(ph, 0.0) + max(0.0, dur)
        if self.hbm_every and n % self.hbm_every == 0:
            hbm_stats([self.device])

    def report(self, recent: int = 64, emit_event: bool = True,
               include_hbm: bool = True) -> Dict[str, Any]:
        """Totals, the fraction of accounted time per phase
        (input_wait_frac, device_execute_frac, ...), the compile seconds,
        the last MFU, the process's compile telemetry, device memory, and
        the last `recent` step records (none for recent=0). With
        `emit_event`, a `perf.phase_report` event of the fractions once a
        step is recorded."""
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
        rep = {
            "profiler": self.name,
            "steps": steps,
            "phase_seconds": {k: round(v, 6) for k, v in totals.items()},
            "accounted_s": round(accounted if totals else 0.0, 6),
            "compile_s": round(totals.get("compile", 0.0), 6),
            "mfu": mfu,
            **fracs,
            "compile_process": compile_stats(),
            "hbm": hbm_stats([self.device]) if include_hbm else {},
            "recent_steps": recent_steps,
        }
        if emit_event and steps:
            metrics.emit("perf.phase_report", profiler=self.name,
                         steps=steps, fracs=dict(fracs))
        return rep

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
    install_compile_listener()
    with _lock:
        prof = _registry.get(name)
        if prof is None:
            prof = _registry[name] = DeviceStepProfiler(name, **kwargs)
        return prof


def snapshot_all(recent: int = 64) -> Dict[str, Any]:
    """Every registered profiler's report, the process's compile telemetry
    and one device-memory sweep (the reference's profile_device body)."""
    with _lock:
        profs = list(_registry.values())
    return {
        "pid": os.getpid(),
        "compile": compile_stats(),
        "hbm": hbm_stats(),
        "profilers": {p.name: p.report(recent=recent, emit_event=False,
                                       include_hbm=False)
                      for p in profs},
    }


def steps_to_spans(report: Dict[str, Any], proc: str) -> List[Dict[str, Any]]:
    """One report's recent steps as span dicts (the runtime's tracing
    shape): a span a step, and its phases laid back to back inside it, one
    lane per (proc, profiler)."""
    spans: List[Dict[str, Any]] = []
    name = report.get("profiler", "?")
    for i, rec in enumerate(report.get("recent_steps", ())):
        t0 = rec.get("time", 0.0)
        t = t0
        spans.append({
            "span_id": f"dev-{name}-{i}", "parent_id": None,
            "trace_id": None, "name": f"{name}.step",
            "proc": proc, "thread": f"device:{name}",
            "start": t0, "end": t0 + rec.get("total", 0.0),
            "attrs": {"mfu": rec.get("mfu"), "tokens": rec.get("tokens")},
        })
        phases = rec.get("phases", {})
        # the reference's phases first, then any others (the engine's
        # "prefill") in name order
        ordered = [p for p in PHASES if p in phases] + sorted(
            p for p in phases if p not in PHASES)
        for ph in ordered:
            dur = phases.get(ph, 0.0)
            if dur <= 0:
                continue
            spans.append({
                "span_id": f"dev-{name}-{i}-{ph}",
                "parent_id": f"dev-{name}-{i}", "trace_id": None,
                "name": f"{name}:{ph}", "proc": proc,
                "thread": f"device:{name}",
                "start": t, "end": t + dur,
                "attrs": {"phase": ph},
            })
            t += dur
    return spans
