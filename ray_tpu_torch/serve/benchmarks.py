"""Serve microbenchmarks of the port, on its own serve: the counterpart of
`ray_tpu/serve/benchmarks.py`.

  * `run_serve_benchmarks`: handle-call and HTTP-proxy RPS and latency
    percentiles of an echo deployment, and the router's cost over a raw
    actor call.
  * `run_sustained_benchmark`: the most offered HTTP rps the sharded proxy
    holds at a target p99 (a binary search over open-loop load, which fails
    a level whose arrival schedule falls behind).
  * `run_prefix_ttft_benchmark`: client-observed TTFT through serve.llm,
    cold against a prefix hit. Every request carries the same shared
    prefix plus a unique tail; cold requests carry fresh prefixes of the
    same length (a full prefill), hit requests the shared one, already
    cached (a tail-only prefill). Requests are serial, so the difference
    is prefill compute, not queueing. The serving stack comes in as a
    value (`serve.ServingStack`; by default this package's serve).

The HTTP benchmarks need `aiohttp` (the proxy's server).

Run:
    python -m ray_tpu_torch.serve.benchmarks              # all three
    python -m ray_tpu_torch.serve.benchmarks classic      # handle + HTTP
    python -m ray_tpu_torch.serve.benchmarks sustained
    python -m ray_tpu_torch.serve.benchmarks prefix [--device cpu]
"""

from __future__ import annotations

import json
import random
import threading
import time
from typing import Any, Dict, Optional


def _percentiles(samples_ms):
    xs = sorted(samples_ms)

    def pct(p):
        return round(xs[min(len(xs) - 1, int(p / 100 * len(xs)))], 2)

    return {"p50_ms": pct(50), "p90_ms": pct(90), "p99_ms": pct(99)}


def run_serve_benchmarks(n_requests: int = 200,
                         http_port: int = 0) -> Dict[str, dict]:
    import urllib.request

    import ray_tpu_torch
    from ray_tpu_torch import serve

    out: Dict[str, dict] = {}
    ray_tpu_torch.init(num_cpus=4, ignore_reinit_error=True)
    http_port = http_port or 18431

    @serve.deployment
    def echo(body=None):
        return "ok"

    serve.run(echo.bind(), name="bench", http_port=http_port)
    handle = serve.get_deployment_handle("echo", "bench")

    # warm the replica + route
    assert handle.remote(None).result(timeout_s=30) == "ok"
    url = f"http://127.0.0.1:{http_port}/bench"
    with urllib.request.urlopen(url, timeout=10) as r:
        r.read()

    # -- handle path (router + replica actor call) --------------------------
    lat = []
    t0 = time.perf_counter()
    for _ in range(n_requests):
        s = time.perf_counter()
        handle.remote(None).result(timeout_s=30)
        lat.append((time.perf_counter() - s) * 1e3)
    dt = time.perf_counter() - t0
    out["serve_handle"] = {"rps": round(n_requests / dt, 1),
                           **_percentiles(lat)}

    # -- HTTP proxy path ----------------------------------------------------
    # persistent connections, like any real serving client: a fresh TCP
    # connect per request benchmarks the kernel's handshake, not the
    # proxy. Latency percentiles from one serial keep-alive connection;
    # throughput from 4 concurrent keep-alive clients.
    import http.client
    import threading as _threading

    host_port = f"127.0.0.1:{http_port}"
    conn = http.client.HTTPConnection(host_port, timeout=30)
    lat = []
    for _ in range(n_requests):
        s = time.perf_counter()
        conn.request("GET", "/bench")
        conn.getresponse().read()
        lat.append((time.perf_counter() - s) * 1e3)
    conn.close()

    counts = [0] * 4
    stop_at = time.perf_counter() + 3.0

    client_errors: list = []

    def _client(i: int):
        try:
            c = http.client.HTTPConnection(host_port, timeout=30)
            while time.perf_counter() < stop_at:
                c.request("GET", "/bench")
                c.getresponse().read()
                counts[i] += 1
            c.close()
        except Exception as e:  # noqa: BLE001 — surface after join
            client_errors.append(e)

    threads = [_threading.Thread(target=_client, args=(i,))
               for i in range(len(counts))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    dt = time.perf_counter() - t0
    if client_errors:
        # a died client silently deflates rps; fail the run instead
        raise client_errors[0]
    out["serve_http"] = {"rps": round(sum(counts) / dt, 1),
                         "concurrency": len(counts),
                         **_percentiles(lat)}

    # -- router probe overhead ----------------------------------------------
    # the pow-2 router probes replica queue lengths before assignment
    # (reference: pow_2_scheduler.py:49); quantify it against a raw actor
    # round trip with no routing at all
    @ray_tpu_torch.remote
    class Raw:
        def ping(self):
            return "ok"

    raw = Raw.remote()
    ray_tpu_torch.get(raw.ping.remote())
    t0 = time.perf_counter()
    for _ in range(n_requests):
        ray_tpu_torch.get(raw.ping.remote())
    raw_ms = (time.perf_counter() - t0) / n_requests * 1e3
    handle_ms = out["serve_handle"]["p50_ms"]
    out["router_probe_overhead"] = {
        "raw_actor_call_ms": round(raw_ms, 2),
        "handle_call_p50_ms": handle_ms,
        "overhead_ms": round(handle_ms - raw_ms, 2),
    }
    serve.shutdown()
    return out


# -- sustained-load mode ------------------------------------------------------


def _offered_load_trial(host_port: str, path: str, rate_hz: float,
                        duration_s: float, n_workers: int) -> Dict:
    """Open-loop load at `rate_hz` for `duration_s`: workers with
    persistent connections pull arrival slots off one shared schedule.
    Returns latencies + the worst schedule lag (send time minus the
    slot's nominal time) — sustained lag means the offered load exceeds
    what the plane drains, even before latencies blow up."""
    import http.client
    import itertools

    arrivals = itertools.count()
    t0 = time.perf_counter() + 0.05
    deadline_idx = int(rate_hz * duration_s)
    lat: list = []
    lags: list = []
    errors: list = []
    lock = threading.Lock()

    def worker():
        try:
            conn = http.client.HTTPConnection(host_port, timeout=30)
            my_lat, my_lags = [], []
            while True:
                i = next(arrivals)
                if i >= deadline_idx:
                    break
                target = t0 + i / rate_hz
                now = time.perf_counter()
                if now < target:
                    time.sleep(target - now)
                    now = time.perf_counter()
                my_lags.append(now - target)
                conn.request("GET", path)
                conn.getresponse().read()
                my_lat.append((time.perf_counter() - now) * 1e3)
            conn.close()
            with lock:
                lat.extend(my_lat)
                lags.extend(my_lags)
        except Exception as e:  # noqa: BLE001 — surfaced to the caller
            with lock:
                errors.append(e)

    threads = [threading.Thread(target=worker) for _ in range(n_workers)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return {"lat_ms": lat, "max_lag_s": max(lags) if lags else 0.0,
            "completed": len(lat)}


def run_sustained_benchmark(target_p99_ms: float = 5.0,
                            duration_s: float = 3.0,
                            num_shards: Optional[int] = None,
                            num_replicas: int = 2,
                            http_port: int = 0) -> Dict[str, dict]:
    """Binary-search the max offered HTTP rps holdable at
    p99 <= target_p99_ms through the sharded proxy. 'Holdable' = the
    p99 stays under target AND the arrival schedule never falls behind
    by more than 0.25s (otherwise the level is queueing, not serving)."""
    import ray_tpu_torch
    from ray_tpu_torch import serve

    ray_tpu_torch.init(num_cpus=4, ignore_reinit_error=True)
    http_port = http_port or 18437

    @serve.deployment(num_replicas=num_replicas)
    def echo(body=None):
        return "ok"

    serve.run(echo.bind(), name="sustained", http_port=http_port,
              http_shards=num_shards)
    handle = serve.get_deployment_handle("echo", "sustained")
    assert handle.remote(None).result(timeout_s=30) == "ok"
    host_port = f"127.0.0.1:{http_port}"
    # warm every shard's connection path
    _offered_load_trial(host_port, "/sustained", 50, 1.0, 4)

    def holds(rate_hz: float) -> Dict:
        n_workers = max(4, min(64, int(rate_hz * 0.04)))
        r = _offered_load_trial(host_port, "/sustained", rate_hz,
                                duration_s, n_workers)
        xs = sorted(r["lat_ms"])
        p99 = xs[min(len(xs) - 1, int(0.99 * len(xs)))] if xs else 1e9
        p50 = xs[len(xs) // 2] if xs else 1e9
        ok = (p99 <= target_p99_ms and r["max_lag_s"] < 0.25
              and r["completed"] >= 0.95 * rate_hz * duration_s)
        return {"ok": ok, "p50_ms": round(p50, 2), "p99_ms": round(p99, 2),
                "rate_hz": rate_hz, "max_lag_s": round(r["max_lag_s"], 3)}

    # geometric probe (up from 100, or down when even that fails — a
    # loaded CI host may hold only tens of rps at the target), then bisect
    lo, best = 0.0, None
    hi = None
    rate = 100.0
    for _ in range(8):
        r = holds(rate)
        if r["ok"]:
            lo, best = rate, r
            if hi is not None:
                break
            rate *= 2
        else:
            hi = rate
            if lo > 0 or rate <= 10.0:
                break
            rate /= 2
    if hi is not None and lo > 0:
        for _ in range(4):
            mid = (lo + hi) / 2
            if hi - lo < max(25.0, 0.1 * hi):
                break
            r = holds(mid)
            if r["ok"]:
                lo, best = mid, r
            else:
                hi = mid
    floor = None
    if best is None:
        # target unreachable on this host (a throttled CI share can have
        # a serial p50 above the whole p99 budget): report the floor
        # level's actual numbers so the artifact explains itself
        floor = holds(25.0)
    from ray_tpu_torch.serve.context import get_controller

    shards = len(ray_tpu_torch.get(
        get_controller().get_http_proxy_handles.remote()))
    serve.shutdown()
    out = best or {"ok": False, "p99_ms": None, "rate_hz": 0.0}
    result = {
        "rps": round(lo, 1),
        "target_p99_ms": target_p99_ms,
        "p50_ms": out.get("p50_ms"),
        "p99_ms": out.get("p99_ms"),
        "num_shards": shards,
        "num_replicas": num_replicas,
        "duration_s": duration_s,
        "note": ("max OFFERED open-loop rps held with p99 <= target and "
                 "no arrival-schedule backlog; binary search"),
    }
    if floor is not None:
        result["target_unreachable"] = True
        result["floor_25rps"] = {k: floor[k]
                                 for k in ("p50_ms", "p99_ms", "max_lag_s")}
    return {"serve_http_sustained": result}



# -- prefix-cache TTFT mode ----------------------------------------------------


def cpu_config():
    """The reference's CPU configuration: wider than tiny(), so that the
    shared prefix's prefill dominates routing and call overhead."""
    from ray_tpu_torch.models import llama

    return llama.LlamaConfig(
        vocab_size=512, d_model=256, n_layers=4, n_heads=8, n_kv_heads=4,
        d_head=32, d_ff=512, max_seq_len=1024)


def run_prefix_ttft_benchmark(n_requests: int = 6,
                              shared_prefix_len: int = 448,
                              tail_len: int = 8, *, stack=None, device=None,
                              config: Optional[Any] = None,
                              params: Optional[Dict] = None
                              ) -> Dict[str, dict]:
    """Client-observed TTFT, cold against a prefix hit, through one
    serve.llm replica: two warm-up requests (the full-length and the
    tail-length prefill), then `n_requests` rounds of one cold and one hit
    request; the replica's prefix-cache counters. stack: the serving stack
    (default: the port's own serve). Default config: small_1b on the card,
    `cpu_config()` on the CPU. The replica draws the weights from seed 0
    on its device unless `params` are given (as `benchmark_serving`); on
    the card it asks for the whole card (`replica_options`)."""
    from ray_tpu_torch._private.device import resolve_device
    from ray_tpu_torch.inference.benchmarks import (PagedEngineBuilder,
                                                    replica_options)
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.serve import require_stack

    stack = require_stack(stack, "run_prefix_ttft_benchmark", "get_actor",
                          "get")
    dev = resolve_device(device)
    if config is None:
        config = (llama.LlamaConfig.small_1b() if dev.type == "cuda"
                  else cpu_config())
    max_len = 2 * shared_prefix_len
    block = 16
    build = PagedEngineBuilder(
        config, dev, dict(max_batch=4, max_len=max_len, block_size=block,
                          n_blocks=4 * (max_len // block), decode_chunk=4),
        params=params)

    stack.init()
    app = stack.build_llm_app(build, name="llm_prefix", num_replicas=1,
                              default_config={"max_new_tokens": 4},
                              shed_queue_depth=10_000,
                              engine_actor_options=replica_options(dev, 1))
    try:
        handle = stack.run(app, name="llm_prefix")
        stream = handle.options(method_name="stream_tokens", stream=True)
        rng = random.Random(0)

        def ttft(prompt) -> float:
            t0 = time.perf_counter()
            gen = stream.remote({"prompt": prompt, "max_new_tokens": 2})
            it = iter(gen)
            next(it)
            dt = (time.perf_counter() - t0) * 1e3
            gen.close()
            return dt

        def rand_tokens(n):
            return [1 + rng.randrange(30) for _ in range(n)]

        # both prefill programs (full length, tail length) out of the
        # measurement
        ttft(rand_tokens(shared_prefix_len + tail_len))
        warm_prefix = rand_tokens(shared_prefix_len)
        ttft(warm_prefix + rand_tokens(tail_len))

        cold, hits = [], []
        for _ in range(n_requests):
            cold.append(ttft(rand_tokens(shared_prefix_len)
                             + rand_tokens(tail_len)))
            hits.append(ttft(warm_prefix + rand_tokens(tail_len)))

        controller = stack.get_actor("SERVE_CONTROLLER")
        replicas = stack.get(controller.get_replica_handles.remote(
            "llm_prefix", "llm_prefix_engine"))
        stats = stack.get(replicas[0].handle_request.remote(
            "get_stats", (), {}), timeout=30)
        pc = stats["engine"]["prefix_cache"]
    finally:
        stack.shutdown()

    def p50(xs):
        return round(sorted(xs)[len(xs) // 2], 2)

    return {"llm_prefix_ttft": {
        "cold_p50_ms": p50(cold),
        "hit_p50_ms": p50(hits),
        "hit_over_cold": round(p50(hits) / max(p50(cold), 1e-9), 3),
        "shared_prefix_len": shared_prefix_len,
        "n_requests": n_requests,
        "cache": {k: pc.get(k) for k in
                  ("hit_requests", "miss_requests", "hit_tokens",
                   "evictions", "bytes_saved")},
        "note": ("serial client-observed TTFT through serve.llm; hit = "
                 "shared system prompt served from cached KV blocks"),
    }}


if __name__ == "__main__":
    import sys

    args = sys.argv[1:]
    device = None
    if "--device" in args:
        i = args.index("--device")
        device = args[i + 1]
        del args[i:i + 2]
    modes = set(args) or {"classic", "sustained", "prefix"}
    out: Dict[str, dict] = {}
    if "classic" in modes:
        out.update(run_serve_benchmarks())
    if "sustained" in modes:
        out.update(run_sustained_benchmark())
    if "prefix" in modes:
        out.update(run_prefix_ttft_benchmark(device=device))
    print(json.dumps(out))
