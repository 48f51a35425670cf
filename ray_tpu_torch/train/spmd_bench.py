"""Measured multi-GPU SPMD training-step benchmark.

    python -m ray_tpu_torch.train.spmd_bench [--n-devices N] [--steps K]
                                             [--device cpu]

Counterpart of `ray_tpu/train/spmd_bench.py`. It runs the SAME global
batch through the one-GPU step (the unsharded eager step, on rank 0 while
the others wait) and through the sharded step over a named (dp, fsdp, tp)
mesh spanning N ranks (one per GPU, NCCL), and prints ONE JSON line:
tokens/s per GPU, MFU per GPU (against the part's dense bf16 peak,
`_private/accelerators/nvidia.py`), scaling efficiency (per-GPU throughput
kept going from 1 to N GPUs), peak device memory per GPU, the device time
of the mesh step's NCCL kernels by name, and the largest loss difference
between the two trajectories (the mesh program must be a re-partitioning
of the same arithmetic).

On the card the configuration is the JAX bench's (Llama-3-8B widths, 5
layers, vocab 32000, chunked CE of 1024, bf16, remat "dots", B = 4 N,
S = 2048, `adamw(3e-4, weight_decay=0.0)`); both steps run eagerly (the
sharded step is not compiled). With --device cpu it runs gloo ranks on the
tiny fp32 config at B = 2 N, S = 128 and reports no MFU and no device
memory: a CPU rate is no device metric.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import sys
import time
from typing import Any, Dict, Optional

import numpy as np
import torch


def axis_plan(n_devices: int) -> Dict[str, int]:
    """Split n devices over the (dp, fsdp, tp) named mesh, model axes
    first: 8 -> dp=2, fsdp=2, tp=2; 4 -> fsdp=2, tp=2; 2 -> tp=2; odd
    prime counts fall back to pure dp."""
    plan = {"dp": 1, "fsdp": 1, "tp": 1}
    rest = n_devices
    for axis in ("tp", "fsdp"):
        if rest % 2 == 0:
            plan[axis] = 2
            rest //= 2
    plan["dp"] = rest
    return plan


def tiny_config():
    from ray_tpu_torch.models import llama

    return dataclasses.replace(llama.LlamaConfig.tiny(), dtype=torch.float32)


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def launch_counts() -> Dict[str, int]:
    """The flash kernels' launch counters of this process."""
    from ray_tpu_torch.ops import flash_attention as fa

    return {"flash_fwd": fa.flash_fwd_cuda.launches,
            "flash_bwd_dq": fa.flash_bwd_dq_cuda.launches,
            "flash_bwd_dkv": fa.flash_bwd_dkv_cuda.launches}


def train_run(cfg, plan: Optional[Dict[str, int]], tokens: np.ndarray,
              steps: int, seed: int = 0, lr: float = 3e-4,
              num_slices: int = 1) -> Dict[str, Any]:
    """On this rank of a gang: a seeded state, one warm-up step and `steps`
    timed eager steps on the global batch `tokens` [B, S+1]; plan None is
    the unsharded step on this rank alone, else the sharded step over the
    mesh MeshConfig(**plan) (with `num_slices` a leading dcn dim).
    -> {"step_s", "losses", "grad_norms" (warm-up first), "peak_gib"
    (None on the CPU), "launches" (per timed step, this rank's)}."""
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.parallel.mesh import MeshConfig, build_multislice_mesh
    from ray_tpu_torch.parallel.sharding import LogicalAxisRules
    from ray_tpu_torch.train import adamw, init_train_state, make_train_step
    from ray_tpu_torch.train.backend import rank_device
    from ray_tpu_torch.train.spmd import batch_sharding, shard_local_batch

    dev = rank_device()
    opt = adamw(lr, weight_decay=0.0)
    init = functools.partial(llama.init, cfg, torch.Generator(
        device=dev).manual_seed(seed))
    batch_np = {"inputs": tokens[:, :-1], "targets": tokens[:, 1:]}
    if plan is None:
        state = init_train_state(init, opt, device=dev)
        loss_fn = functools.partial(llama.loss_fn, config=cfg)
        batch = {k: torch.as_tensor(np.ascontiguousarray(v), device=dev)
                 for k, v in batch_np.items()}
    else:
        rules = LogicalAxisRules()
        mesh = build_multislice_mesh(MeshConfig(**plan), num_slices,
                                     device_type=dev.type)
        state = init_train_state(init, opt, device=dev,
                                 param_logical_axes=llama.param_logical_axes(
                                     cfg), mesh=mesh, rules=rules)
        loss_fn = functools.partial(llama.loss_fn, config=cfg, mesh=mesh,
                                    rules=rules)
        batch = shard_local_batch(batch_np, batch_sharding(mesh, rules),
                                  mesh, dev)
    step = make_train_step(loss_fn, opt, compiled=False)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    metrics = []
    state, m = step(state, batch)  # warm-up
    metrics.append(m)
    _sync(dev)
    launches = []
    t0 = time.perf_counter()
    for _ in range(steps):
        before = launch_counts()
        state, m = step(state, batch)
        after = launch_counts()
        launches.append({k: after[k] - before[k] for k in after})
        metrics.append(m)
    _sync(dev)
    step_s = (time.perf_counter() - t0) / max(steps, 1)
    out = {"step_s": step_s,
           "losses": [float(m["loss"]) for m in metrics],
           "grad_norms": [float(m["grad_norm"]) for m in metrics],
           "peak_gib": (torch.cuda.max_memory_allocated(dev) / 2**30
                        if dev.type == "cuda" else None),
           "launches": launches}
    if dev.type == "cuda" and plan is not None:
        out["collectives_ms"] = _profile_collectives(step, state, batch)
    del state
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def _profile_collectives(step, state, batch) -> Dict[str, float]:
    """Device ms of one more step's kernels: each NCCL kernel by name (its
    time includes waiting for the other ranks) and the rest as
    "compute". The profiler's "nccl:..." annotations, which span the same
    kernels on the device timeline, are left out."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(state, batch)
        torch.cuda.synchronize()
    out: Dict[str, float] = {}
    for e in prof.key_averages():
        if (e.device_type != torch.autograd.DeviceType.CUDA
                or e.key.startswith("nccl:")):
            continue
        kind = e.key.split("(")[0] if "nccl" in e.key.lower() else "compute"
        out[kind] = out.get(kind, 0.0) + e.self_device_time_total / 1e3
    return out


def _bench_rank(n: int, steps: int, plan: Dict[str, int], cfg, batch: int,
                seq: int, seed: int) -> Dict[str, Any]:
    """One rank of the bench: rank 0 runs the one-GPU step first while the
    others wait, then every rank runs the mesh step."""
    import torch.distributed as dist

    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (batch, seq + 1))
    one = train_run(cfg, None, toks, steps) if dist.get_rank() == 0 else None
    dist.barrier()
    mesh = train_run(cfg, plan, toks, steps)
    return {"one": one, "mesh": mesh}


def run(n_devices: int, steps: int = 3, device=None,
        timeout_s: float = 1500.0) -> Dict[str, Any]:
    """The bench on a gang of n_devices ranks; -> its JSON object."""
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.train.backend import launch_gang

    on_card = device is None or torch.device(device).type == "cuda"
    plan = axis_plan(n_devices)
    if on_card:
        from ray_tpu_torch.bench import bench_config

        cfg = bench_config()
        batch, seq = 4 * n_devices, 2048
    else:
        cfg = tiny_config()
        batch, seq = 2 * n_devices, 128
    res = launch_gang(_bench_rank, n_devices, device, timeout_s,
                      args=(n_devices, steps, plan, cfg, batch, seq, 1))
    one, meshes = res[0]["one"], [r["mesh"] for r in res]
    tokens = batch * seq
    flops_tok = llama.flops_per_token(cfg, seq)
    step_1, step_n = one["step_s"], max(m["step_s"] for m in meshes)
    per_gpu_1 = tokens / step_1
    per_gpu_n = tokens / step_n / n_devices
    diffs = [abs(a - b) for a, b in zip(one["losses"], meshes[0]["losses"])]
    detail = {
        "platform": "gpu" if on_card else "cpu",
        "n_devices": n_devices,
        "mesh_axes": plan,
        "model_params_m": round(cfg.num_params() / 1e6, 1),
        "seq_len": seq,
        "global_batch": batch,
        "steps": steps,
        "step_time_ms_1dev": step_1 * 1e3,
        "step_time_ms_ndev": step_n * 1e3,
        "tokens_per_sec_per_gpu_1dev": per_gpu_1,
        "scaling_efficiency": per_gpu_n / per_gpu_1,
        "loss_max_abs_diff": max(diffs),
        "loss_max_rel_diff": max(d / abs(a) for d, a in
                                 zip(diffs, one["losses"])),
        "loss_1dev": one["losses"],
        "loss_ndev": meshes[0]["losses"],
        "grad_norm_1dev": one["grad_norms"],
        "grad_norm_ndev": meshes[0]["grad_norms"],
    }
    if on_card:
        from ray_tpu_torch._private.accelerators.nvidia import (
            bf16_peak_flops_per_device)
        from ray_tpu_torch.bench import nvidia_smi_line

        card = nvidia_smi_line()
        peak = bf16_peak_flops_per_device(card.split(",")[0])
        detail.update({
            "card": card,
            "mfu_1dev": flops_tok * per_gpu_1 / peak,
            "mfu": flops_tok * per_gpu_n / peak,
            "peak_gib_1dev": one["peak_gib"],
            "peak_gib_per_gpu": [m["peak_gib"] for m in meshes],
            "collectives_ms_rank0": meshes[0].get("collectives_ms"),
        })
    return {"metric": "train_multigpu_tokens_per_sec_per_gpu",
            "value": per_gpu_n, "unit": "tokens/s/gpu", "detail": detail}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--n-devices", type=int, default=None,
                   help="ranks to span (default: every visible card)")
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--device", default=None, choices=("cuda", "cpu"))
    args = p.parse_args(argv)
    n = args.n_devices
    if n is None:
        if args.device == "cpu":
            n = 4
        else:
            from ray_tpu_torch._private.backend_probe import cuda_device_count

            n = cuda_device_count()
            if n == 0:
                raise RuntimeError("no CUDA card visible; pass --device cpu "
                                   "to run gloo ranks")
    print(json.dumps(run(n, steps=args.steps, device=args.device)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
