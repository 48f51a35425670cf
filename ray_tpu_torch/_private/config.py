"""Env-overridable config registry.

Equivalent of the reference's `RAY_CONFIG(type, name, default)` table
(ray: src/ray/common/ray_config_def.h) — every knob can be overridden with an
`RT_<NAME>` environment variable or via `ray_tpu_torch.init(_system_config={...})`,
and the chosen values are propagated to every spawned process through the
`RT_SYSTEM_CONFIG` env var (JSON).
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
from typing import Any, Dict

_ENV_PREFIX = "RT_"
_SYSTEM_CONFIG_ENV = "RT_SYSTEM_CONFIG"


class _SessionPath:
    """The default of a path knob: `leaf` under this session's own
    directory, made at the first read of any such knob in
    `tempfile.gettempdir()` (so it honours TMPDIR). Every session path is
    then set as an override, so `RT_SYSTEM_CONFIG` carries the same
    directory to every process the session spawns, and two sessions on
    one host never share one."""

    def __init__(self, leaf: str):
        self.leaf = leaf


class _Config:
    def __init__(self):
        self._defaults: Dict[str, Any] = {}
        self._values: Dict[str, Any] = {}
        # Resolved-value memo: config reads sit on the task-submit hot path
        # (several per task), and an os.environ lookup per read costs ~25µs.
        # Env overrides are read ONCE per process, like the reference's
        # RayConfig (ray_config_def.h) — set() updates the memo.
        self._resolved: Dict[str, Any] = {}
        self._lock = threading.Lock()

    def define(self, name: str, default: Any) -> None:
        self._defaults[name] = default

    def get(self, name: str) -> Any:
        try:
            return self._resolved[name]
        except KeyError:
            pass
        with self._lock:
            if name in self._values:
                val = self._values[name]
            elif name not in self._defaults:
                raise KeyError(f"unknown config {name}")
            else:
                default = self._defaults[name]
                env = os.environ.get(_ENV_PREFIX + name.upper())
                if isinstance(default, _SessionPath):
                    self._resolve_session_paths()
                    val = self._values[name]
                else:
                    val = _coerce(env, default) if env is not None else default
            self._resolved[name] = val
            return val

    def _resolve_session_paths(self) -> None:
        root = None
        for name, default in self._defaults.items():
            if not isinstance(default, _SessionPath) or name in self._values:
                continue
            val = os.environ.get(_ENV_PREFIX + name.upper())
            if val is None:
                if root is None:
                    root = tempfile.mkdtemp(
                        prefix=f"rt_torch_session_{os.getpid()}_")
                val = os.path.join(root, default.leaf)
            self._values[name] = val

    def set(self, name: str, value: Any) -> None:
        if name not in self._defaults:
            raise KeyError(f"unknown config {name}")
        with self._lock:
            self._values[name] = value
            self._resolved[name] = value

    def apply_system_config(self, overrides: Dict[str, Any]) -> None:
        for k, v in overrides.items():
            self.set(k, v)

    def load_from_env(self) -> None:
        raw = os.environ.get(_SYSTEM_CONFIG_ENV)
        if raw:
            self.apply_system_config(json.loads(raw))

    def serialized_overrides(self) -> str:
        with self._lock:
            return json.dumps(self._values)

    def __getattr__(self, name: str) -> Any:
        if name.startswith("_"):
            raise AttributeError(name)
        return self.get(name)


def _coerce(raw: str, default: Any) -> Any:
    if isinstance(default, bool):
        return raw.lower() in ("1", "true", "yes")
    if isinstance(default, int):
        return int(raw)
    if isinstance(default, float):
        return float(raw)
    return raw


CONFIG = _Config()
_d = CONFIG.define

# --- kernel timing -----------------------------------------------------------
_d("heartbeat_period_ms", 250)          # raylet -> GCS resource report period
_d("health_check_period_ms", 1000)      # GCS -> raylet liveness probe period
_d("health_check_failure_threshold", 5)
_d("worker_register_timeout_s", 30.0)
_d("worker_lease_idle_timeout_ms", 1000)  # submitter returns cached leases after this
_d("worker_pool_idle_timeout_s", 60.0)    # raylet kills idle spare workers
_d("worker_log_max_files", 2000)          # prune oldest dead-worker logs past this
# Per-worker log rotation (reference: ray_constants LOGGING_ROTATE_BYTES
# 512 MiB / LOGGING_ROTATE_BACKUP_COUNT 5): a long-lived chatty worker
# must not grow its log unboundedly. 0 bytes disables rotation.
_d("worker_log_rotate_bytes", 512 * 1024 * 1024)
_d("worker_log_rotate_backups", 5)
_d("worker_pool_prestart", 0)
# cap on simultaneously-STARTING worker processes (reference:
# maximum_startup_concurrency = num CPUs): an unthrottled 1k-actor burst
# fork/imports 1k pythons at once and starves the raylet of CPU until the
# GCS declares the node dead. 0 = auto (max(4, cores)).
_d("worker_maximum_startup_concurrency", 0)
# fork-server worker spawn (workers/zygote.py): one preimported process
# per node forks workers in ~10-30ms instead of ~0.25s of fresh-python
# imports each. Accelerator/container workers always use fresh spawns.
_d("enable_worker_zygote", True)
_d("rpc_connect_timeout_s", 10.0)
_d("rpc_call_timeout_s", 60.0)

# --- objects -----------------------------------------------------------------
_d("max_direct_call_object_size", 100 * 1024)  # inline threshold (bytes)
_d("object_store_memory_bytes", 2 * 1024**3)   # per-node plasma capacity
_d("object_store_fallback_dir", _SessionPath("spill"))
# External spill target (reference: external_storage.py:451 smart_open
# URIs). "" = node-local disk; "file:///mnt/..." = shared mount;
# "s3://..."/"gs://..." = object store via fsspec. Remote targets register
# spill URIs in the GCS so restores survive the spilling node.
_d("object_spilling_uri", "")
_d("enable_plasma_store", True)                # node-local C++ shm store
_d("object_spilling_high_watermark", 0.80)     # spill above this fill ratio
_d("object_spilling_low_watermark", 0.60)      # ...down to this ratio
_d("memory_usage_threshold", 0.95)             # OOM killer trigger fraction
_d("memory_monitor_refresh_ms", 500)           # 0 disables the monitor
_d("worker_killing_policy", "retriable_lifo")  # or "group_by_owner"
_d("fetch_retry_interval_ms", 100)
_d("max_lineage_bytes", 64 * 1024**2)
_d("enable_lineage_reconstruction", True)
# chunked object transfer (reference: object_manager chunked pulls,
# object_manager.proto chunk_size / pull_manager.h admission control)
_d("fetch_chunk_size_bytes", 4 * 1024**2)      # chunk granularity
_d("fetch_max_inflight_bytes", 256 * 1024**2)  # admission cap across fetches
_d("fetch_pipeline_depth", 4)                  # in-flight chunks per source

# --- tasks / actors ----------------------------------------------------------
_d("default_task_num_cpus", 1.0)
_d("default_actor_num_cpus", 1.0)
_d("task_retry_delay_ms", 0)
_d("actor_restart_delay_ms", 100)
_d("max_pending_lease_requests_per_scheduling_key", 10)
_d("max_tasks_per_push", 32)            # normal-task specs per batched push RPC
_d("task_batch_latency_ms", 5.0)        # batch pushes only for keys faster than this
_d("log_to_driver", True)               # stream worker stdout/stderr to the driver
_d("log_monitor_period_ms", 500)        # worker-logfile tail interval
_d("streaming_generator_backpressure_objects", -1)  # -1 = unbounded

# --- scheduling --------------------------------------------------------------
_d("scheduler_spread_threshold", 0.5)  # hybrid policy: pack below this utilization
_d("scheduler_top_k_fraction", 0.2)
_d("max_tasks_in_flight_per_worker", 1)
# actor-creation specs carry serialized class defs up to this size inline,
# sparing every fresh actor worker a GCS function-table round trip
_d("max_inline_function_bytes", 64 * 1024)

# raylet->GCS heartbeat backoff while the GCS is unreachable: doubles per
# consecutive failure up to the cap, with per-node seeded jitter (fraction
# of the interval subtracted) so a restarted GCS isn't hit by a
# synchronized reconnect storm from every node at once.
_d("gcs_reconnect_backoff_max_s", 5.0)
_d("gcs_reconnect_backoff_jitter", 0.5)

# --- overload protection (_private/backoff.py, deadlines.py) -----------------
# Every queue names its bound (CONTRIBUTING). Overflow returns typed
# pushback (RetryLaterError / retry_later replies with a retry-after
# hint) and counts ray_tpu_shed_total{layer=...}; it never parks work
# forever or fails it as lost.
_d("raylet_lease_queue_max", 2000)       # queued lease requests per raylet
_d("gcs_actor_creation_queue_max", 4000)  # actors pending first creation
_d("actor_mailbox_max", 10_000)          # owner-side queued calls per actor
# Decoupled RL dataflow (rllib/dataflow.py): sample batches queued between
# the rollout fleet and the learner — entries are (ref, version) stamps,
# the payloads live in the object store. Overflow is typed shed back to
# the pushing runner (retry_later + retry-after hint), never silent loss.
_d("rl_sample_queue_max", 64)
# Token-bucket retry budgets per (peer, method): each retry spends a
# token; an empty bucket fails fast with the underlying error instead of
# amplifying a brownout into a retry storm. retry_budget_enabled=False
# restores pre-budget behavior (the chaos-brownout e2e compares both).
_d("retry_budget_capacity", 10.0)
_d("retry_budget_fill_per_s", 1.0)
_d("retry_budget_enabled", True)

# --- gcs ---------------------------------------------------------------------
_d("gcs_storage_path", "")  # "" = pure in-memory; path = snapshot for restart
_d("maximum_gcs_dead_node_cache_count", 1000)

# --- logging -----------------------------------------------------------------
_d("log_dir", _SessionPath("logs"))
_d("log_to_driver", True)

# --- distributed request tracing (_private/tracing.py) -----------------------
# Head sampling: probability a ROOT trace context is minted for a task
# submission with no ambient context. 0.0 (default) = plain task
# submission does no tracing work at all (one thread-local read + one
# config read); serve requests still carry a context (the proxy always
# generates one for response attribution) but it is unsampled unless the
# client's traceparent sets the sampled flag — tail-based force-keep
# (errors, deadline drops, sheds, latency p99 breaches) promotes the
# interesting ones anyway.
_d("trace_sample_rate", 0.0)
_d("trace_max_pending", 20_000)        # unflushed span bound (overflow = drop)
_d("trace_flush_interval_s", 1.0)      # span flusher batch window
_d("trace_store_max_spans", 200_000)   # GCS durable span store bound
_d("trace_provisional_max_spans", 50_000)  # GCS undecided (unsampled) ring
_d("trace_profile_max_spans", 100_000)  # GCS profile-span ring (timeline)
# per-stream cap on engine decode-chunk / generator item spans (the tail
# of a long stream adds no shape information, only volume)
_d("trace_max_stream_spans", 64)
# force-keep a trace whose end-to-end task latency exceeds this many
# seconds (0 = p99-relative only: a stage breaching ~p99 of the recent
# window force-keeps, computed on the latency drainer thread)
_d("trace_force_slow_s", 0.0)

# --- event log / flight recorder (_private/event_log.py) ---------------------
_d("event_log_max_events", 4096)        # per-process post-mortem ring size
_d("event_log_max_pending", 20_000)     # unflushed-queue bound (overflow = drop)
_d("event_log_flush_interval_s", 1.0)   # flusher batch window
_d("flight_recorder_dir", "")           # "" = <session>/flight next to log_dir
# dump the ring on EVERY process exit (worker/raylet/gcs mains pass
# on_exit=True explicitly; this flips it for drivers too)
_d("flight_recorder_on_exit", False)

# --- cluster health plane (ray_tpu_torch/health/) -----------------------------------
_d("health_push_interval_s", 5.0)      # per-process metric snapshot cadence
_d("health_push_max_pending", 4)       # unsent-snapshot bound (overflow = drop)
_d("health_eval_interval_s", 5.0)      # GCS-side SLO evaluation cadence
# multiplies every rule window (fast ~5m, slow ~1h) — drills/smokes set
# this <1 to compress the clock while exercising the production rules
# unchanged (e.g. 0.05: 5m->15s, 1h->3m)
_d("health_window_scale", 1.0)
_d("health_store_max_series", 2000)    # distinct (name, tags) series bound
_d("health_store_raw_points", 720)     # raw ring length per series
_d("health_store_rollup_buckets", 360)  # rollup buckets kept per tier
# emit the health.slo_eval heartbeat every N evals (sparse by design)
_d("health_eval_log_every", 12)

CONFIG.load_from_env()
