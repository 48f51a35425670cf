"""Prefix-cache TTFT over serve.llm: the port's counterpart of
`ray_tpu/serve/benchmarks.py` `run_prefix_ttft_benchmark`.

Every request carries the same shared prefix plus a unique tail; cold
requests carry fresh prefixes of the same length (a full prefill), hit
requests the shared one, already cached (a tail-only prefill). Requests
are serial, so the difference is prefill compute, not queueing. The
serving stack comes in as a value (`serve.ServingStack`).

Run (on the card, through the in-process stand-in):
    python -m ray_tpu_torch.serve.benchmarks
"""

from __future__ import annotations

import json
import random
import time
from typing import Any, Dict, Optional

import torch


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
    (required). Default config: small_1b on the card, `cpu_config()` on
    the CPU, with weights from seed 0 unless `params` are given."""
    from ray_tpu_torch._private.device import resolve_device
    from ray_tpu_torch.inference.paged_engine import PagedInferenceEngine
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.serve import require_stack

    stack = require_stack(stack, "run_prefix_ttft_benchmark", "get_actor",
                          "get")
    dev = resolve_device(device)
    if config is None:
        config = (llama.LlamaConfig.small_1b() if dev.type == "cuda"
                  else cpu_config())
    if params is None:
        params = llama.init(config,
                            torch.Generator(device=dev).manual_seed(0),
                            device=dev)
    max_len = 2 * shared_prefix_len
    block = 16

    def build():
        return PagedInferenceEngine(params, config, max_batch=4,
                                    max_len=max_len, block_size=block,
                                    n_blocks=4 * (max_len // block),
                                    decode_chunk=4, device=dev)

    stack.init()
    app = stack.build_llm_app(build, name="llm_prefix", num_replicas=1,
                              default_config={"max_new_tokens": 4},
                              shed_queue_depth=10_000)
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
    from ray_tpu_torch.serve.local import LocalServingStack

    print(json.dumps(run_prefix_ttft_benchmark(stack=LocalServingStack())))
