"""Metrics and events of the port: Counter, Gauge and Histogram with tag
keys, rendered in Prometheus exposition format, and a bounded event ring.

The port's copy of what it needs from `ray_tpu/util/metrics.py`
(`Counter`, `Gauge`, `Histogram`, `get_metric`, the `get_or_create_*`
functions, `prometheus_text`, `snapshot_metrics`), plus one install point
for the JAX package's runtime. The port's own runtime (`ray_tpu_torch.api`)
keeps its metrics in this registry. The JAX runtime's pieces come in as
values, never as imports:

    import ray_tpu.util.metrics
    from ray_tpu._private import event_log, kv_registry
    from ray_tpu_torch.util import metrics

    metrics.use_runtime(metrics=ray_tpu.util.metrics, emit=event_log.emit,
                        kv_registry=kv_registry)

After it, the port's families (`backend()`) are created in the runtime's
registry, which the dashboard's /metrics scrapes; the port's events go to
the runtime's event log; and every live port engine, and each one built
later, registers with the runtime's `kv_registry`, so that the worker's
`memory_report()["kv"]` lists it. Values observed before the install stay
in the port's own registry. Without it, families live in this module's
registry and events in a bounded local ring (`events()`): when the ring
is full the oldest event makes room and is counted (`event_stats()`), and
an event the runtime's `emit` refuses lands in the ring and is counted
too. `use_runtime()` with no arguments goes back to the port's own.
"""

from __future__ import annotations

import itertools
import sys
import threading
import time
from collections import defaultdict, deque
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

_registry_lock = threading.Lock()
_registry: List["Metric"] = []


def _tags_key(tags: Optional[Dict[str, str]]) -> Tuple:
    return tuple(sorted((tags or {}).items()))


class Metric:
    def __init__(self, name: str, description: str = "",
                 tag_keys: Optional[Sequence[str]] = None):
        if not name:
            raise ValueError("metric name is required")
        self._name = name
        self._description = description
        self._tag_keys = tuple(tag_keys or ())
        self._lock = threading.Lock()
        with _registry_lock:
            _registry.append(self)

    def _merged(self, tags: Optional[Dict[str, str]]) -> Dict[str, str]:
        out = dict(tags or {})
        unknown = set(out) - set(self._tag_keys)
        if unknown:
            raise ValueError(f"unknown tag keys {unknown}; declared "
                             f"{self._tag_keys}")
        return out

    def _samples(self) -> List[Tuple[str, Dict[str, str], float]]:
        raise NotImplementedError


class Counter(Metric):
    def __init__(self, name, description="", tag_keys=None):
        super().__init__(name, description, tag_keys)
        self._values: Dict[Tuple, float] = defaultdict(float)

    def inc(self, value: float = 1.0,
            tags: Optional[Dict[str, str]] = None) -> None:
        if value <= 0:
            raise ValueError("Counter.inc value must be positive")
        merged = self._merged(tags)
        with self._lock:
            self._values[_tags_key(merged)] += value

    def _samples(self):
        with self._lock:
            return [(self._name, dict(k), v)
                    for k, v in self._values.items()]


class Gauge(Metric):
    def __init__(self, name, description="", tag_keys=None):
        super().__init__(name, description, tag_keys)
        self._values: Dict[Tuple, float] = {}

    def set(self, value: float,  # noqa: A003
            tags: Optional[Dict[str, str]] = None) -> None:
        merged = self._merged(tags)
        with self._lock:
            self._values[_tags_key(merged)] = float(value)

    def _samples(self):
        with self._lock:
            return [(self._name, dict(k), v)
                    for k, v in self._values.items()]


class Histogram(Metric):
    def __init__(self, name, description="", boundaries=None, tag_keys=None):
        super().__init__(name, description, tag_keys)
        if not boundaries:
            boundaries = [0.005, 0.01, 0.05, 0.1, 0.5, 1, 5, 10, 50, 100]
        self._boundaries = sorted(boundaries)
        self._counts: Dict[Tuple, List[int]] = {}
        self._sums: Dict[Tuple, float] = defaultdict(float)
        self._totals: Dict[Tuple, int] = defaultdict(int)

    def observe(self, value: float,
                tags: Optional[Dict[str, str]] = None) -> None:
        merged = self._merged(tags)
        key = _tags_key(merged)
        with self._lock:
            buckets = self._counts.setdefault(
                key, [0] * (len(self._boundaries) + 1))
            idx = len(self._boundaries)
            for i, b in enumerate(self._boundaries):
                if value <= b:
                    idx = i
                    break
            buckets[idx] += 1
            self._sums[key] += value
            self._totals[key] += 1

    def _samples(self):
        out = []
        with self._lock:
            for key, buckets in self._counts.items():
                tags = dict(key)
                cum = 0
                for b, c in zip(self._boundaries, buckets):
                    cum += c
                    out.append((f"{self._name}_bucket",
                                {**tags, "le": str(b)}, cum))
                out.append((f"{self._name}_bucket",
                            {**tags, "le": "+Inf"}, self._totals[key]))
                out.append((f"{self._name}_sum", tags, self._sums[key]))
                out.append((f"{self._name}_count", tags, self._totals[key]))
                # Estimated p50/p90/p99 beside the exact buckets, as the
                # runtime's registry renders them.
                for q in (0.5, 0.9, 0.99):
                    out.append((f"{self._name}_quantile",
                                {**tags, "quantile": str(q)},
                                self._quantile_locked(key, q)))
        return out

    @staticmethod
    def _bucket_quantile(boundaries, buckets, total, q: float) -> float:
        """A quantile from bucket counts: linear inside the bucket, the
        overflow bucket clamped to the top boundary."""
        if not buckets or total <= 0:
            return 0.0
        target = q * total
        cum = 0
        lo = 0.0
        for boundary, count in zip(boundaries, buckets):
            if cum + count >= target:
                frac = (target - cum) / count if count else 0.0
                return lo + (boundary - lo) * frac
            cum += count
            lo = boundary
        return boundaries[-1]

    def _quantile_locked(self, key: Tuple, q: float) -> float:
        return self._bucket_quantile(
            self._boundaries, self._counts.get(key),
            self._totals.get(key, 0), q)


def get_metric(name: str) -> Optional[Metric]:
    """The registered metric named `name` (the newest registration)."""
    with _registry_lock:
        for m in reversed(_registry):
            if m._name == name:
                return m
    return None


# The runtime's control-plane latency buckets: 10 µs to 30 s.
LATENCY_BOUNDARIES = [1e-5, 5e-5, 1e-4, 5e-4, 1e-3, 5e-3, 0.01, 0.05,
                      0.1, 0.5, 1, 5, 30]


def get_or_create_histogram(name: str, description: str = "",
                            boundaries: Optional[Sequence[float]] = None,
                            tag_keys: Optional[Sequence[str]] = None
                            ) -> Histogram:
    """The registered Histogram named `name`, or a new one."""
    m = get_metric(name)
    if isinstance(m, Histogram):
        return m
    return Histogram(name, description,
                     boundaries=list(boundaries or LATENCY_BOUNDARIES),
                     tag_keys=tag_keys)


def get_or_create_counter(name: str, description: str = "",
                          tag_keys: Optional[Sequence[str]] = None
                          ) -> Counter:
    m = get_metric(name)
    if isinstance(m, Counter):
        return m
    return Counter(name, description, tag_keys=tag_keys)


def get_or_create_gauge(name: str, description: str = "",
                        tag_keys: Optional[Sequence[str]] = None) -> Gauge:
    m = get_metric(name)
    if isinstance(m, Gauge):
        return m
    return Gauge(name, description, tag_keys=tag_keys)


def snapshot_metrics(prefix: str) -> List[Dict]:
    """A serializable, cumulative snapshot of every metric of this registry
    whose name starts with `prefix`: how the port's runtime ships a
    process's metrics to the GCS health store (`health/push.py`)."""
    with _registry_lock:
        metrics = [m for m in _registry if m._name.startswith(prefix)]
    out: List[Dict] = []
    for m in metrics:
        entry: Dict = {"name": m._name, "type": type(m).__name__,
                       "description": m._description,
                       "tag_keys": list(m._tag_keys)}
        with m._lock:
            if isinstance(m, Histogram):
                entry["boundaries"] = list(m._boundaries)
                entry["samples"] = [
                    (list(key), list(counts), m._sums[key], m._totals[key])
                    for key, counts in m._counts.items()]
            else:
                entry["samples"] = [(list(k), v)
                                    for k, v in m._values.items()]
        out.append(entry)
    return out


def prometheus_text() -> str:
    """All metrics of this registry in Prometheus exposition format."""
    lines: List[str] = []
    with _registry_lock:
        metrics = list(_registry)
    for m in metrics:
        if m._description:
            lines.append(f"# HELP {m._name} {m._description}")
        kind = {"Counter": "counter", "Gauge": "gauge",
                "Histogram": "histogram"}.get(type(m).__name__, "untyped")
        lines.append(f"# TYPE {m._name} {kind}")
        for name, tags, value in m._samples():
            if tags:
                tag_str = ",".join(
                    f'{k}="{v}"' for k, v in sorted(tags.items()))
                lines.append(f"{name}{{{tag_str}}} {value}")
            else:
                lines.append(f"{name} {value}")
    return "\n".join(lines) + "\n"


# -- the runtime, as values ----------------------------------------------------

_runtime_lock = threading.Lock()
_runtime: Dict[str, Any] = {"metrics": None, "emit": None,
                            "kv_registry": None}
_generation = 0


def use_runtime(metrics=None, emit: Optional[Callable[..., None]] = None,
                kv_registry=None) -> None:
    """Route the port's metrics and events to the runtime.

    metrics: a module of the runtime's metrics API (`get_or_create_*`,
    `prometheus_text`), e.g. `ray_tpu.util.metrics`: the port's families
    are created there from now on. emit: the runtime's event emitter,
    `emit(type, **fields)`, e.g. `ray_tpu._private.event_log.emit`.
    kv_registry: the runtime's KV block-pool registry (`register`,
    `report_all`): port engines register there, live ones now. None for
    any of them keeps (or puts back) the port's own."""
    global _generation
    with _runtime_lock:
        _runtime.update(metrics=metrics, emit=emit, kv_registry=kv_registry)
        _generation += 1
    if kv_registry is not None:
        from ray_tpu_torch._private import kv_registry as port_kv

        port_kv.forward_live(kv_registry.register)


def runtime() -> Dict[str, Any]:
    """The runtime's pieces installed by `use_runtime` (None: the port's)."""
    with _runtime_lock:
        return dict(_runtime)


def generation() -> int:
    """Bumped by every `use_runtime`: a cache of metric objects made
    before it is stale."""
    return _generation


def backend():
    """The module whose registry the port's families are created in: the
    runtime's after `use_runtime(metrics=...)`, else this one."""
    return _runtime["metrics"] or sys.modules[__name__]


# -- events --------------------------------------------------------------------

# The events the port emits and the fields its call sites pass: those of
# `ray_tpu/_private/event_log.py` EVENT_SCHEMAS, which lists the fields an
# event needs at least. The `rl.*` sites pass more than that list (JAX's
# `rllib/dataflow.py` and `algorithms/impala.py` as well), and
# `drills/slo.rl_slo` reads some of the extra ones (`min_batch_version`,
# `staleness_bound`), so here each type lists every field its sites pass.
EVENT_SCHEMAS: Dict[str, Tuple[str, ...]] = {
    "compile.start": ("source", "t_start"),
    "compile.end": ("source", "duration_s"),
    "perf.phase_report": ("profiler", "steps", "fracs"),
    # the decoupled RL dataflow (`rllib/dataflow.py`, IMPALA's loop and the
    # sync runner group)
    "rl.learner_step": ("step", "version", "env_steps", "min_batch_version",
                        "staleness_bound", "stale_dropped", "discarded_dead",
                        "runners"),
    "rl.weights_broadcast": ("version", "runners"),
    "rl.stale_drop": ("version", "batch_version", "bound", "runner"),
    "rl.sample_shed": ("runner", "depth"),
    "rl.zombie_push": ("runner", "incarnation", "current"),
    "rl.runner_dead": ("actor_id", "runner", "reason", "incarnation"),
    "rl.runner_respawn": ("actor_id", "runner", "incarnation", "reason"),
    "rl.fleet_scale": ("from_runners", "to_runners", "reason"),
}

# Fields that are keywords of the runtime's event envelope
# (`event_log.emit(etype, *, actor_id=..., **data)`), not data: they reach
# the runtime's emit as those keywords and stand beside "data" in a record
# of the local ring, as in the runtime's records.
ENVELOPE = ("actor_id",)

RING_EVENTS = 4096
_events_lock = threading.Lock()
_ring: deque = deque(maxlen=RING_EVENTS)
_seq = itertools.count(1)
_stats = {"emitted": 0, "forwarded": 0, "evicted": 0, "refused": 0}


def emit(etype: str, **data) -> None:
    """One event of a type in EVENT_SCHEMAS with exactly its fields: to
    the runtime's event log once installed, else to the local ring. An
    event of another type or fields raises ValueError."""
    emit_to(None, etype, **data)


def emit_to(sink: Optional[Callable[..., None]], etype: str,
            **data) -> None:
    """`emit` through the runtime emitter `sink` (None: the route that
    `use_runtime` installed in this process). For an actor of the port's
    that runs in a runtime worker, which has not called `use_runtime`: its
    creator hands it the emitter installed there, `runtime()["emit"]`."""
    if sink is None:
        sink = _runtime["emit"]
    fields = EVENT_SCHEMAS.get(etype)
    if fields is None:
        raise ValueError(f"unknown event type {etype!r}; known: "
                         f"{sorted(EVENT_SCHEMAS)}")
    if set(data) != set(fields):
        raise ValueError(f"{etype} takes the fields {fields}, not "
                         f"{tuple(sorted(data))}")
    with _events_lock:
        _stats["emitted"] += 1
    if sink is not None:
        try:
            sink(etype, **data)
            with _events_lock:
                _stats["forwarded"] += 1
            return
        except Exception:  # noqa: BLE001 — kept locally and counted
            with _events_lock:
                _stats["refused"] += 1
    rec = {"seq": next(_seq), "time": time.time(), "type": etype}
    rec.update({k: data.pop(k) for k in ENVELOPE if k in data})
    rec["data"] = data
    with _events_lock:
        if len(_ring) == _ring.maxlen:
            _stats["evicted"] += 1
        _ring.append(rec)


def events(prefix: str = "") -> List[Dict[str, Any]]:
    """The local ring's events (oldest first) whose type starts with
    `prefix`."""
    with _events_lock:
        return [e for e in _ring if e["type"].startswith(prefix)]


def event_stats() -> Dict[str, int]:
    """emitted: every event; forwarded: taken by the runtime's emit;
    refused: raised by it (kept in the ring); evicted: pushed out of the
    full ring by a newer one."""
    with _events_lock:
        return dict(_stats)
