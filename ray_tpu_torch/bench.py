"""Headline benchmark of the port: Llama training-step throughput on one
NVIDIA card.

    python -m ray_tpu_torch.bench [--device cpu]

Counterpart of `bench.py`'s headline (its RT_BENCH_HEADLINE_ONLY branch).
Prints ONE JSON line: {"metric", "value", "unit", "detail"}. Metric:
training tokens/s per GPU on the JAX bench's 8B-width proxy (Llama-3-8B
layer shapes at 5 layers, vocab 32000, chunked CE of 1024; bf16, the flash
kernels, remat "dots", B=4, S=2048, `adamw(3e-4, weight_decay=0.0)`),
with `make_train_step`'s compiled step. One warm-up step (recorded as the
profiler's compile phase), 20 timed steps, then 5 profiled steps split into
input_wait / h2d / device_execute. MFU is taken against the dense bf16
peak of the detected part (`_private/accelerators/nvidia.py`).

Without CUDA it raises, unless --device cpu is given: that run takes
`LlamaConfig.tiny()` at B=4, S=128 for 3 steps, compiles with aot_eager
(inductor's CPU code is no part of the port) and reports no MFU and no
device memory, since a CPU rate is no device metric. The JAX bench's
subsystem benches (multichip, PPO, serve) wait for their ports.
"""

from __future__ import annotations

import argparse
import functools
import json
import subprocess
import time
from typing import Any, Dict

import numpy as np
import torch

from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch._private.device_profiler import DeviceStepProfiler

# The JAX bench's shapes on the card (bench.py:191-199, :205).
BATCH, SEQ, STEPS = 4, 2048, 20
# Its CPU smoke's.
CPU_BATCH, CPU_SEQ, CPU_STEPS = 4, 128, 3
PROFILED_STEPS = 5


def bench_config():
    """bench.py's 8B-width proxy: Llama-3-8B layer widths at 5 layers,
    vocab 32000, chunked CE of 1024, bf16, remat "dots"."""
    from ray_tpu_torch.models import llama

    return llama.LlamaConfig(
        vocab_size=32_000, d_model=4096, n_layers=5, n_heads=32,
        n_kv_heads=8, d_head=128, d_ff=14_336, max_seq_len=2048,
        loss_chunk_size=1024)


def nvidia_smi_line() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return proc.stdout.strip().splitlines()[0]


def run(device=None, *, config=None) -> Dict[str, Any]:
    """The benchmark; -> its JSON object. config defaults to the bench's
    (the tiny config with device="cpu")."""
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.train import adamw, init_train_state, make_train_step

    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    if on_card:
        from ray_tpu_torch._private.accelerators.nvidia import (
            bf16_peak_flops_per_device)

        kind = torch.cuda.get_device_name(dev)
        peak = bf16_peak_flops_per_device(kind)
        batch, seq, steps = BATCH, SEQ, STEPS
        cfg = config or bench_config()
    else:
        kind, peak = "cpu", None
        batch, seq, steps = CPU_BATCH, CPU_SEQ, CPU_STEPS
        cfg = config or llama.LlamaConfig.tiny()
    backend = "inductor" if on_card else "aot_eager"

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    opt = adamw(3e-4, weight_decay=0.0)  # as bench.py:210
    gen = torch.Generator(device=dev).manual_seed(0)
    state = init_train_state(functools.partial(llama.init, cfg, gen), opt,
                             device=dev)
    step = make_train_step(functools.partial(llama.loss_fn, config=cfg), opt,
                           backend=backend)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size,
                                             (batch, seq + 1))
    host = {"inputs": np.ascontiguousarray(toks[:, :-1]),
            "targets": np.ascontiguousarray(toks[:, 1:])}
    data = {k: torch.as_tensor(v, device=dev) for k, v in host.items()}
    tokens_per_step = batch * seq
    flops_tok = llama.flops_per_token(cfg, seq)
    prof = DeviceStepProfiler("train", device=dev,
                              flops_per_step=flops_tok * tokens_per_step,
                              peak_flops_per_chip=peak)
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)

    # The first step compiles: the compile phase.
    with prof.step(tokens=tokens_per_step) as sp:
        with sp.phase("compile") as ph:
            state, m = step(state, data)
            ph.fence(m)
    sync()
    t0 = time.perf_counter()
    for _ in range(steps):
        state, m = step(state, data)
    loss = float(m["loss"])
    dt = (time.perf_counter() - t0) / steps
    tok_s = tokens_per_step / dt
    mfu = flops_tok * tok_s / peak if peak else None

    # Phase attribution: a short profiled segment after the timed loop,
    # each phase fenced (bench.py:252-300).
    for _ in range(min(steps, PROFILED_STEPS)):
        with prof.step(tokens=tokens_per_step) as sp:
            with sp.phase("input_wait"):
                hb = {k: np.array(v) for k, v in host.items()}
            with sp.phase("h2d") as ph:
                b2 = ph.fence({k: torch.as_tensor(v, device=dev)
                               for k, v in hb.items()})
            with sp.phase("device_execute") as ph:
                state, m2 = step(state, b2)
                ph.fence(m2)
    rep = prof.report(recent=0)
    detail = {
        "model_params_m": round(cfg.num_params() / 1e6, 1),
        "seq_len": seq,
        "global_batch": batch,
        "step_time_ms": dt * 1e3,
        "mfu": mfu,
        "peak_flops_per_gpu": peak,
        "remat_policy": cfg.remat_policy,
        "compiled": True,
        "backend": backend,
        "compile_s": rep["compile_s"],
        "loss": loss,
        "platform": "gpu" if on_card else "cpu",
        "device_kind": kind,
        "nvidia_smi": nvidia_smi_line() if on_card else None,
        "n_devices": 1,
        "input_wait_frac": rep["input_wait_frac"],
        "device_frac": rep["device_execute_frac"],
        "train_step_phases": {k: v for k, v in rep.items()
                              if k not in ("recent_steps", "hbm")},
        "peak_memory_bytes": (torch.cuda.max_memory_allocated(dev)
                              if on_card else None),
        "model_proxy": {"north_star": "llama3-8b", "width_match": True,
                        "depth": int(cfg.n_layers), "full_depth": 32},
    }
    return {"metric": "llama_train_tokens_per_sec_per_gpu", "value": tok_s,
            "unit": "tokens/s/gpu", "detail": detail}


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default=None,
                        help="cuda (the default; raises without it) or cpu")
    args = parser.parse_args(argv)
    print(json.dumps(run(args.device)))


if __name__ == "__main__":
    main()
