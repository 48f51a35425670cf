"""Inference benchmark: decode tokens/s at full continuous-batching
occupancy, beside the card's memory-bandwidth bound.

Counterpart of `ray_tpu/inference/benchmarks.py` `benchmark_engine`. The
bound reads the detected card's device-memory bandwidth
(`_private/accelerators/nvidia.py`); a CPU run reports none, since a CPU
rate is no device metric. `benchmark_serving` (Poisson arrivals through
serve.llm) waits for a port of the serve stack.

Run: python -m ray_tpu_torch.inference.benchmarks
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


if __name__ == "__main__":
    print(json.dumps(benchmark_engine()))
