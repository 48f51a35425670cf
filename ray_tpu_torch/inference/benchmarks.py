"""Inference benchmarks: decode tokens/s at full continuous-batching
occupancy, beside the card's memory-bandwidth bound, and the serving
numbers users feel: TTFT p50/p99 and delivered tokens/s under Poisson
arrivals through serve.llm.

Counterpart of `ray_tpu/inference/benchmarks.py` (`benchmark_engine`,
`benchmark_serving`). The bound reads the detected card's device-memory
bandwidth (`_private/accelerators/nvidia.py`); a CPU run reports none,
since a CPU rate is no device metric. `benchmark_serving` runs on the
port's own serve (`ray_tpu_torch.init` and `ray_tpu_torch.serve`), or on
a serving stack passed as a value (`ray_tpu_torch.serve.ServingStack`).
Each engine replica builds its engine through `PagedEngineBuilder`, which
travels to the replica's process as values: the config, the device and
the engine's settings (the replica draws the weights from seed 0 on its
own card) or, for small models, the weights themselves too.

Run: python -m ray_tpu_torch.inference.benchmarks            # engine decode
     python -m ray_tpu_torch.inference.benchmarks serving    # serving
"""

from __future__ import annotations

import json
import time
from typing import Any, Dict, Optional

import torch

from ray_tpu_torch._private.device import resolve_device


def benchmark_engine(config: Optional[Any] = None, *, max_batch: int = 8,
                     max_len: int = 512, new_tokens: int = 64,
                     device=None) -> Dict[str, Any]:
    """Random weights from seed 0, `max_batch` 16-token prompts, one warm-up
    generate (it captures the decode graph), then one timed generate of
    `new_tokens` each: one wave, the whole decode in one loop. Default
    config: small_1b on the card, tiny on the CPU."""
    from ray_tpu_torch.inference.engine import (GenerationConfig,
                                                InferenceEngine)
    from ray_tpu_torch.models import llama

    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    if config is None:
        config = (llama.LlamaConfig.small_1b() if on_card
                  else llama.LlamaConfig.tiny())
    params = llama.init(config, torch.Generator(device=dev).manual_seed(0),
                        device=dev)
    eng = InferenceEngine(params, config, max_batch=max_batch,
                          max_len=max_len, device=dev)
    gen = GenerationConfig(max_new_tokens=new_tokens)
    prompts = [[1 + (i % 31)] * 16 for i in range(max_batch)]

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    eng.generate(prompts, gen)
    sync()
    t0 = time.perf_counter()
    n_tokens = sum(len(toks) for toks in eng.generate(prompts, gen))
    sync()
    dt = time.perf_counter() - t0
    tok_s = n_tokens / dt
    detail: Dict[str, Any] = {
        "model_params_m": config.num_params() / 1e6,
        "max_batch": max_batch,
        "max_len": max_len,
        "new_tokens_per_req": new_tokens,
        "device": str(dev),
        "device_kind": torch.cuda.get_device_name(dev) if on_card else "cpu",
        "hbm_roofline_tokens_per_sec": None,
        "roofline_frac": None,
    }
    if on_card:
        from ray_tpu_torch._private.accelerators.nvidia import peaks

        # Every decode step reads the weights and the whole dense cache.
        itemsize = torch.empty((), dtype=config.dtype).element_size()
        param_bytes = config.num_params() * itemsize
        kv_bytes = (config.n_layers * max_batch * max_len
                    * config.n_kv_heads * config.d_head * 2 * itemsize)
        bandwidth = peaks(detail["device_kind"])[1]
        roofline = bandwidth / (param_bytes + kv_bytes) * max_batch
        detail["hbm_roofline_tokens_per_sec"] = roofline
        detail["roofline_frac"] = tok_s / roofline
    return {"metric": "engine_decode_tokens_per_sec", "value": tok_s,
            "unit": "tokens/s", "seconds": dt, "detail": detail}


class PagedEngineBuilder:
    """`build_engine` of the serving benchmarks: a PagedInferenceEngine of
    `config` on `device` with the engine settings `engine`, over `params`,
    or over weights drawn from seed 0 on the device where it is called
    (the replica's card) when `params` is None. It is pickled into each
    replica's process, so it holds values only: a model too large to
    travel (Llama-3-8B is 16 GB of bf16) goes by its seed."""

    def __init__(self, config, device, engine: Dict[str, Any], *,
                 params: Optional[Dict] = None):
        self.config = config
        self.device = torch.device(device)
        self.engine = dict(engine)
        self.params = params

    def weights(self) -> Dict:
        from ray_tpu_torch.models import llama

        if self.params is not None:
            return self.params
        return llama.init(self.config, torch.Generator(
            device=self.device).manual_seed(0), device=self.device)

    def __call__(self):
        from ray_tpu_torch.inference.paged_engine import PagedInferenceEngine

        return PagedInferenceEngine(self.weights(), self.config,
                                    device=self.device, **self.engine)


# benchmark_serving's engine settings, the reference's
SERVING_ENGINE = dict(max_batch=8, max_len=128, block_size=16, decode_chunk=4)


def replica_options(dev, num_replicas: int) -> Optional[Dict[str, Any]]:
    """The engine replicas' actor options: on the card, each asks for its
    share of one card (`num_gpus` 1 / num_replicas); on the CPU none."""
    if torch.device(dev).type != "cuda":
        return None
    return {"num_gpus": 1.0 / num_replicas}


def benchmark_serving(config: Optional[Any] = None, *, stack=None,
                      num_replicas: int = 2, n_requests: int = 24,
                      arrival_rate_hz: float = 8.0,
                      max_new_tokens: int = 12, prompt_len: int = 8,
                      device=None, params: Optional[Dict] = None
                      ) -> Dict[str, Any]:
    """Serving under open-loop Poisson arrivals: requests fire on an
    exponential-gap schedule (random.Random(0)) whatever the completions,
    stream through the stack's router and `num_replicas` paged-engine
    replicas, and the numbers come from client-observed token arrival
    times. 2 * num_replicas warm-up requests run first, outside the
    measurement. stack: the serving stack (default: the port's own serve
    on `ray_tpu_torch.init`). Default config: small_1b on the card, tiny
    on the CPU. Each replica draws the weights from seed 0 on its device,
    unless `params` (weights small enough to travel to the replicas, or
    already resident where the stack runs its replicas in this process)
    are given. The replicas' actor options are `replica_options`: on the
    card, a share of one card each."""
    import random
    import threading

    from ray_tpu_torch.models import llama
    from ray_tpu_torch.serve import require_stack

    stack = require_stack(stack, "benchmark_serving")
    dev = resolve_device(device)
    if config is None:
        config = (llama.LlamaConfig.small_1b() if dev.type == "cuda"
                  else llama.LlamaConfig.tiny())
    build = PagedEngineBuilder(config, dev, SERVING_ENGINE, params=params)

    stack.init()
    app = stack.build_llm_app(
        build, name="llm_bench", num_replicas=num_replicas,
        default_config={"max_new_tokens": max_new_tokens},
        shed_queue_depth=10_000,  # measure queueing, don't shed it
        engine_actor_options=replica_options(dev, num_replicas))
    try:
        handle = stack.run(app, name="llm_bench")
        stream = handle.options(method_name="stream_tokens", stream=True)
        rng = random.Random(0)
        prompts = [[1 + rng.randrange(31) for _ in range(prompt_len)]
                   for _ in range(n_requests)]
        # every replica's first programs out of the measurement
        warm = [threading.Thread(
            target=lambda p=p: list(stream.remote({"prompt": p})))
            for p in prompts[:num_replicas * 2]]
        for t in warm:
            t.start()
        for t in warm:
            t.join()

        results: list = [None] * n_requests

        def issue(i: int, prompt):
            t0 = time.perf_counter()
            first = None
            n = 0
            for _tok in stream.remote({"prompt": prompt}):
                if first is None:
                    first = time.perf_counter()
                n += 1
            results[i] = (t0, first, time.perf_counter(), n)

        threads = []
        t_start = time.perf_counter()
        for i, prompt in enumerate(prompts):
            time.sleep(rng.expovariate(arrival_rate_hz))
            t = threading.Thread(target=issue, args=(i, prompt))
            t.start()
            threads.append(t)
        for t in threads:
            t.join()
        t_end = time.perf_counter()
    finally:
        stack.shutdown()

    done = [r for r in results if r is not None and r[1] is not None]
    if not done:
        raise RuntimeError(
            "no serving request produced a first token; the serving "
            "stack is down, not slow")
    ttfts = sorted((first - t0) * 1e3 for t0, first, _, _ in done)
    total_tokens = sum(n for _, _, _, n in done)

    def pct(p):
        return round(ttfts[min(len(ttfts) - 1,
                               int(p / 100 * len(ttfts)))], 2)

    return {
        "metric": "llm_serving_ttft_p50_ms",
        "value": pct(50),
        "unit": "ms",
        "detail": {
            "ttft_p99_ms": pct(99),
            "tokens_per_sec": round(total_tokens / (t_end - t_start), 1),
            "n_requests": len(done),
            "num_replicas": num_replicas,
            "arrival_rate_hz": arrival_rate_hz,
            "max_new_tokens": max_new_tokens,
            "platform": "gpu" if dev.type == "cuda" else "cpu",
            "note": ("open-loop Poisson arrivals through serve.llm "
                     "(router + continuous-batching engine replicas, "
                     "streaming token path); client-observed timings"),
        },
    }


if __name__ == "__main__":
    import sys

    if "serving" in sys.argv[1:]:
        print(json.dumps(benchmark_serving()))
    else:
        print(json.dumps(benchmark_engine()))
