"""First-class LLM serving metrics.

The serving stack is distributed — engine replicas and the router run in
worker processes, but `prometheus_text()` (and the dashboard and the
CLI, once ported) read the LOCAL registry. The flow is therefore:

  * replicas observe into their own process registry (TTFT/TPOT
    histograms, queue-depth / batch-occupancy gauges, token/preemption
    counters — everything under the ``ray_tpu_llm_`` prefix);
  * `collect_llm_metrics()` pulls each replica's cumulative snapshot
    (`llm_metrics_snapshot` RPC) and merges the DELTA since that
    replica's previous scrape into the calling process's registry
    (util/metrics.py merge_metrics_snapshot), so repeated collection
    never double-counts;
  * the dashboard's time-series sampler and the CLI, once ported, call
    the same collector, so one code path feeds /metrics and the
    terminal.

LLM applications are discoverable cluster-wide: build_llm_app stamps the
engine deployment's name into the app's ingress flags (``llm_engine``),
so a fresh process (the CLI) can find every serving app from the
controller alone.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional

from ray_tpu_torch.util import metrics as um

METRIC_PREFIX = "ray_tpu_llm"
TTFT_NAME = "ray_tpu_llm_ttft_seconds"
TPOT_NAME = "ray_tpu_llm_tpot_seconds"
QUEUE_DEPTH_NAME = "ray_tpu_llm_queue_depth"
OCCUPANCY_NAME = "ray_tpu_llm_batch_occupancy"
TOKENS_NAME = "ray_tpu_llm_tokens_generated_total"
PREEMPTIONS_NAME = "ray_tpu_llm_preemptions_total"
REQUESTS_NAME = "ray_tpu_llm_requests_total"
SHED_NAME = "ray_tpu_llm_requests_shed_total"
PREFIX_HITS_NAME = "ray_tpu_llm_prefix_cache_hits_total"
PREFIX_MISSES_NAME = "ray_tpu_llm_prefix_cache_misses_total"
PREFIX_HIT_TOKENS_NAME = "ray_tpu_llm_prefix_cache_hit_tokens_total"
PREFIX_EVICTIONS_NAME = "ray_tpu_llm_prefix_cache_evictions_total"
PREFIX_BYTES_SAVED_NAME = "ray_tpu_llm_prefix_cache_bytes_saved_total"

_TAG_KEYS = ("deployment", "replica")

# Serving latencies live well under the control-plane 30s ceiling: sub-ms
# TPOT on small models up to tens of seconds of TTFT under queueing.
SERVING_BOUNDARIES = [0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                      0.5, 1.0, 2.5, 5.0, 10.0, 30.0]


def ttft_histogram() -> um.Histogram:
    return um.get_or_create_histogram(
        TTFT_NAME, "time from request arrival to its first streamed token",
        boundaries=SERVING_BOUNDARIES, tag_keys=_TAG_KEYS)


def tpot_histogram() -> um.Histogram:
    return um.get_or_create_histogram(
        TPOT_NAME, "mean time per output token after the first",
        boundaries=SERVING_BOUNDARIES, tag_keys=_TAG_KEYS)


def _get_or_create(cls, name: str, description: str,
                   tag_keys=_TAG_KEYS):
    m = um.get_metric(name)
    if isinstance(m, cls):
        return m
    return cls(name, description, tag_keys=tag_keys)


def queue_depth_gauge() -> um.Gauge:
    return _get_or_create(um.Gauge, QUEUE_DEPTH_NAME,
                          "requests queued ahead of engine admission")


def occupancy_gauge() -> um.Gauge:
    return _get_or_create(um.Gauge, OCCUPANCY_NAME,
                          "fraction of engine batch slots in use")


def tokens_counter() -> um.Counter:
    return _get_or_create(um.Counter, TOKENS_NAME,
                          "tokens streamed to clients")


def preemptions_counter() -> um.Counter:
    return _get_or_create(um.Counter, PREEMPTIONS_NAME,
                          "engine recompute-preemptions")


def requests_counter() -> um.Counter:
    return _get_or_create(
        um.Counter, REQUESTS_NAME, "serving requests by outcome",
        tag_keys=_TAG_KEYS + ("outcome",))


def shed_counter() -> um.Counter:
    return _get_or_create(um.Counter, SHED_NAME,
                          "requests rejected with 429 by the router",
                          tag_keys=("deployment",))


# engine prefix-cache counter name -> (metric factory args, engine
# prefix_stats key); the replica diffs the engine's cumulative stats into
# these each gauge refresh (engine.py _update_gauges)
PREFIX_CACHE_COUNTERS = {
    PREFIX_HITS_NAME: ("requests admitted with a prefix-cache hit",
                       "hit_requests"),
    PREFIX_MISSES_NAME: ("requests admitted with no cached prefix",
                         "miss_requests"),
    PREFIX_HIT_TOKENS_NAME: ("prompt tokens whose prefill was skipped "
                             "(KV served from cached blocks)",
                             "hit_tokens"),
    PREFIX_EVICTIONS_NAME: ("cached KV blocks evicted (LRU) to serve "
                            "new allocations", "evictions"),
    PREFIX_BYTES_SAVED_NAME: ("KV bytes not recomputed thanks to "
                              "prefix-cache hits", "bytes_saved"),
}


def prefix_cache_counter(name: str) -> um.Counter:
    return _get_or_create(um.Counter, name, PREFIX_CACHE_COUNTERS[name][0])


def snapshot() -> List[Dict]:
    """Cumulative snapshot of this process's llm metrics (RPC payload)."""
    return um.snapshot_metrics(METRIC_PREFIX)


# -- cluster collection ------------------------------------------------------

_collector_lock = threading.Lock()
_prev_snapshots: Dict[str, List[Dict]] = {}  # source id -> last snapshot


def find_llm_apps(controller=None) -> Dict[str, Dict[str, str]]:
    """{app_name: {"engine": engine_deployment, "ingress": router}} for
    every deployed LLM serving app (identified by the ``llm_engine``
    ingress flag build_llm_app stamps)."""
    import ray_tpu_torch
    from ray_tpu_torch.serve import context as serve_ctx

    controller = controller or serve_ctx.get_controller()
    apps = ray_tpu_torch.get(controller.list_applications.remote())
    out: Dict[str, Dict[str, str]] = {}
    for app_name, info in apps.items():
        engine = (info.get("ingress_flags") or {}).get("llm_engine")
        if engine:
            out[app_name] = {"engine": engine, "ingress": info["ingress"]}
    return out


def collect_llm_metrics(app_name: Optional[str] = None,
                        timeout_s: float = 10.0) -> int:
    """Pull per-replica metric snapshots from every LLM serving app (or
    just `app_name`) and merge the deltas into THIS process's registry.
    Returns the number of replicas scraped. After this,
    prometheus_text() carries the ray_tpu_llm_* series."""
    import ray_tpu_torch
    from ray_tpu_torch.serve import context as serve_ctx

    # This process is about to become an AGGREGATOR of other processes'
    # serving series. Its own health-plane pusher must stop shipping the
    # merged ray_tpu_llm_* families or the GCS store would count every
    # replica's series twice (once from the replica that owns it, once
    # re-badged under this process).
    from ray_tpu_torch.health import push as _health_push

    _health_push.exclude_prefix(METRIC_PREFIX)
    controller = serve_ctx.get_controller()
    apps = find_llm_apps(controller)
    if app_name is not None:
        apps = {k: v for k, v in apps.items() if k == app_name}
    probes = []  # (source_id, ref)
    for app, names in apps.items():
        for dep in (names["engine"], names["ingress"]):
            # listen_for_change with a mismatched version returns the
            # replica set immediately WITH stable replica ids — the delta
            # watermarks must be keyed by replica identity, not list
            # position, or any replica churn re-merges a survivor's full
            # cumulative history as a fresh delta (double-counting)
            snap = ray_tpu_torch.get(controller.listen_for_change.remote(
                f"{app}#{dep}", -1, timeout=0))
            for rid, h in snap["replicas"]:
                probes.append((
                    rid,
                    h.handle_request.remote("llm_metrics_snapshot", (), {})))
    if apps:
        # proxy shards host per-shard embedded LLM routers whose shed
        # counters live in the shard process registries
        try:
            shards = ray_tpu_torch.get(
                controller.get_http_proxy_handles.remote(), timeout=5)
        except Exception:  # noqa: BLE001 — older controller / no proxies
            shards = {}
        for idx, shard in shards.items():
            try:
                probes.append((f"proxy_shard:{idx}",
                               shard.llm_metrics_snapshot.remote()))
            except Exception:  # noqa: BLE001 — shard mid-restart
                pass
    # ONE bounded wait for the whole fan-out, then cheap gets: harvesting
    # serially at timeout_s each would stall the caller (the dashboard's
    # sampler tick) k*timeout_s when k replicas are mid-restart — same
    # pattern as controller._autoscale.
    done_set = set()
    if probes:
        refs = [ref for _, ref in probes]
        try:
            done, _ = ray_tpu_torch.wait(refs, num_returns=len(refs),
                                   timeout=timeout_s)
            done_set = set(done)
        except Exception:  # noqa: BLE001
            pass
    scraped = 0
    for source, ref in probes:
        if ref not in done_set:
            continue
        try:
            snap = ray_tpu_torch.get(ref, timeout=1.0)
        except Exception:  # noqa: BLE001 — replica mid-restart
            continue
        with _collector_lock:
            um.merge_metrics_snapshot(snap, _prev_snapshots.get(source))
            _prev_snapshots[source] = snap
        scraped += 1
    if app_name is None:
        # Replica ids are unique per incarnation: watermarks of replicas
        # no longer in any set can never be consulted again — drop them
        # (only on unfiltered sweeps: a filtered call must not forget
        # other apps' watermarks). Dead replicas' GAUGE samples are
        # pruned too: counters/histograms aggregate across lifetimes,
        # but a queue-depth reading for a replica that no longer exists
        # is stale forever.
        live = {source for source, _ in probes}
        with _collector_lock:
            for k in list(_prev_snapshots):
                if k not in live:
                    del _prev_snapshots[k]
        for name in (QUEUE_DEPTH_NAME, OCCUPANCY_NAME):
            g = um.get_metric(name)
            if isinstance(g, um.Gauge):
                with g._lock:
                    g._values = {
                        k: v for k, v in g._values.items()
                        if dict(k).get("replica") in live}
    return scraped


def maybe_collect_local(timeout_s: float = 2.0) -> int:
    """Best-effort collect for background samplers (the dashboard's
    time-series loop): no-op unless serve is already running and
    reachable from this process. Never raises."""
    try:
        from ray_tpu_torch.serve import context as serve_ctx

        serve_ctx.get_controller()  # raises if serve isn't running
        return collect_llm_metrics(timeout_s=timeout_s)
    except Exception:  # noqa: BLE001 — serve down / ray not initialized
        return 0


def serving_summary() -> Dict[str, Any]:
    """Human-facing rollup of the locally-merged llm series (the CLI's
    data source; call collect_llm_metrics first)."""
    out: Dict[str, Any] = {}
    ttft = um.get_metric(TTFT_NAME)
    tpot = um.get_metric(TPOT_NAME)
    if isinstance(ttft, um.Histogram):
        out["ttft_s"] = ttft.quantiles_by("deployment")
    if isinstance(tpot, um.Histogram):
        out["tpot_s"] = tpot.quantiles_by("deployment")
    for key, name in (("queue_depth", QUEUE_DEPTH_NAME),
                      ("batch_occupancy", OCCUPANCY_NAME)):
        g = um.get_metric(name)
        if g is not None:
            out[key] = {"/".join(v for _, v in tags.items()): val
                        for _, tags, val in g._samples()}
    for key, name in (("tokens_generated", TOKENS_NAME),
                      ("preemptions", PREEMPTIONS_NAME),
                      ("requests_shed", SHED_NAME)):
        c = um.get_metric(name)
        if c is not None:
            out[key] = sum(v for _, _, v in c._samples())
    pc = {}
    for name, (_desc, key) in PREFIX_CACHE_COUNTERS.items():
        c = um.get_metric(name)
        if c is not None:
            pc[key] = sum(v for _, _, v in c._samples())
    if pc:
        out["prefix_cache"] = pc
    req = um.get_metric(REQUESTS_NAME)
    if req is not None:
        by_outcome: Dict[str, float] = {}
        for _, tags, v in req._samples():
            o = tags.get("outcome", "")
            by_outcome[o] = by_outcome.get(o, 0) + v
        out["requests"] = by_outcome
    return out
