"""Measured multi-GPU SPMD training-step benchmark.

    python -m ray_tpu_torch.train.spmd_bench [--n-devices N] [--steps K]
                                             [--device cpu] [--eager]

Counterpart of `ray_tpu/train/spmd_bench.py`. It runs the SAME global
batch through the one-GPU step (the unsharded step, on rank 0 while the
others wait) and through the sharded step over a named (dp, fsdp, tp) mesh
spanning N ranks (one per GPU, NCCL), and prints ONE JSON line: tokens/s
per GPU, MFU per GPU (against the part's dense bf16 peak,
`_private/accelerators/nvidia.py`), scaling efficiency (per-GPU throughput
kept going from 1 to N GPUs), peak device memory per GPU, the device time
of the mesh step's NCCL kernels by name against the rest, the compiled
mesh step's collectives by kind (`parallel.hlo_report`), and the largest
loss difference between the two trajectories (the mesh program must be a
re-partitioning of the same arithmetic).

By default the steps are compiled, as the JAX step is jitted: the one-GPU
step, and the mesh step compiled and eager side by side (`sharded` in the
detail; the top-level numbers are the compiled step's). --eager runs every
step eagerly. On the card the configuration is the JAX bench's (Llama-3-8B
widths, 5 layers, vocab 32000, chunked CE of 1024, bf16, remat "dots",
B = 4 N, S = 2048, `adamw(3e-4, weight_decay=0.0)`). With --device cpu it
runs gloo ranks on the tiny fp32 config at B = 2 N, S = 128 (compiled with
aot_eager) and reports no MFU and no device memory: a CPU rate is no
device metric.
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


def compile_backend(dev) -> str:
    """What a compiled step is built with: inductor on the card, aot_eager
    on CPU ranks (no Triton there)."""
    return "inductor" if dev.type == "cuda" else "aot_eager"


def model_run(family: str, cfg, plan: Optional[Dict[str, int]],
              batch_np: Dict[str, np.ndarray], logical, steps: int,
              seed: int = 0, lr: float = 3e-4, num_slices: int = 1,
              compiled: bool = False) -> Dict[str, Any]:
    """On this rank of a gang: a seeded state of the port's model `family`
    ("llama", "mixtral", "vit", "t5"), one warm-up step and `steps` timed
    steps on the global batch `batch_np` ({name: numpy}); plan None is the
    unsharded step on this rank alone, else the sharded step over the mesh
    MeshConfig(**plan) (with `num_slices` a leading dcn dim), the batch
    placed by `logical` ({name: logical axes}). compiled: the step of
    `make_train_step(compiled=True)` (`compile_backend`), else eager.
    -> {"step_s", "compile_s" (the warm-up step's seconds), "losses",
    "grad_norms" (warm-up first), "peak_gib" (None on the CPU),
    "launches" (per timed step, this rank's), and on the card with a
    mesh "collectives_ms"; compiled with a mesh, "collectives": the step's
    `collective_report`}."""
    import importlib

    from ray_tpu_torch.parallel.mesh import MeshConfig, build_multislice_mesh
    from ray_tpu_torch.parallel.sharding import LogicalAxisRules
    from ray_tpu_torch.train import adamw, init_train_state, make_train_step
    from ray_tpu_torch.train.backend import rank_device
    from ray_tpu_torch.train.spmd import shard_local_batch

    mod = importlib.import_module(f"ray_tpu_torch.models.{family}")
    dev = rank_device()
    opt = adamw(lr, weight_decay=0.0)
    init = functools.partial(mod.init, cfg, torch.Generator(
        device=dev).manual_seed(seed))
    if plan is None:
        state = init_train_state(init, opt, device=dev)
        loss_fn = functools.partial(mod.loss_fn, config=cfg)
        batch = {k: torch.as_tensor(np.ascontiguousarray(v), device=dev)
                 for k, v in batch_np.items()}
    else:
        rules = LogicalAxisRules()
        mesh = build_multislice_mesh(MeshConfig(**plan), num_slices,
                                     device_type=dev.type)
        state = init_train_state(init, opt, device=dev,
                                 param_logical_axes=mod.param_logical_axes(
                                     cfg), mesh=mesh, rules=rules)
        loss_fn = functools.partial(mod.loss_fn, config=cfg, mesh=mesh,
                                    rules=rules)
        batch = {k: shard_local_batch({k: v}, rules.to_physical(
            logical[k], mesh), mesh, dev)[k] for k, v in batch_np.items()}
    if compiled:
        torch._dynamo.reset()
    step = make_train_step(loss_fn, opt, compiled=compiled,
                           backend=compile_backend(dev))
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    metrics = []
    t0 = time.perf_counter()
    state, m = step(state, batch)  # warm-up (and the compile)
    metrics.append(m)
    _sync(dev)
    compile_s = time.perf_counter() - t0
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
    out = {"step_s": step_s, "compile_s": compile_s,
           "losses": [float(m["loss"]) for m in metrics],
           "grad_norms": [float(m["grad_norm"]) for m in metrics],
           "peak_gib": (torch.cuda.max_memory_allocated(dev) / 2**30
                        if dev.type == "cuda" else None),
           "launches": launches}
    if dev.type == "cuda" and plan is not None:
        out["collectives_ms"] = _profile_collectives(step, state, batch)
    if compiled and plan is not None:
        from ray_tpu_torch.parallel.hlo_report import collective_report

        # from the programs the steps above compiled: nothing runs
        out["collectives"] = collective_report(step, state, batch)
    del state, step
    if compiled:
        torch._dynamo.reset()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


TOKENS = {"inputs": ("batch", "seq"), "targets": ("batch", "seq")}


def train_run(cfg, plan: Optional[Dict[str, int]], tokens: np.ndarray,
              steps: int, seed: int = 0, lr: float = 3e-4,
              num_slices: int = 1, compiled: bool = False) -> Dict[str, Any]:
    """`model_run` of Llama on the global token batch `tokens` [B, S+1]
    (inputs and targets its shifted views, both (batch, seq))."""
    return model_run("llama", cfg, plan, {"inputs": tokens[:, :-1],
                                          "targets": tokens[:, 1:]},
                     TOKENS, steps, seed, lr, num_slices, compiled)


def model_forms(family: str, cfg, plan: Optional[Dict[str, int]],
                batch_np, logical, steps: int, forms=("eager", "compiled"),
                seed: int = 0, lr: float = 3e-4) -> Dict[str, Any]:
    """`model_run` once per form ("eager", "compiled") from the same seeded
    state on the same batch, in one rank process; -> {form: its result}."""
    return {form: model_run(family, cfg, plan, batch_np, logical, steps,
                            seed, lr, compiled=form == "compiled")
            for form in forms}


def versus_one(family: str, cfg, plan: Dict[str, int], batch_np, logical,
               steps: int, seed: int = 0, lr: float = 3e-4,
               compiled: bool = False, first_step_and_fp32: bool = False
               ) -> Dict[str, Any]:
    """The unsharded step on rank 0 alone (the others wait), then the
    sharded step on every rank, from the same seeded state on the same
    global batch; -> {"one": rank 0's result or None, "mesh": this
    rank's}. first_step_and_fp32: also "first", `first_step` of cfg (rank
    0's comparison), and "fp32", {"one", "mesh"}: the same runs with cfg
    in fp32, TF32 off."""
    import torch.distributed as dist

    def both(config):
        one = (model_run(family, config, None, batch_np, logical, steps,
                         seed, lr, compiled=compiled)
               if dist.get_rank() == 0 else None)
        dist.barrier()
        return {"one": one, "mesh": model_run(family, config, plan, batch_np,
                                              logical, steps, seed, lr,
                                              compiled=compiled)}

    out = both(cfg)
    if first_step_and_fp32:
        out["first"] = first_step(family, cfg, plan, batch_np, logical, seed)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        out["fp32"] = both(dataclasses.replace(cfg, dtype=torch.float32))
    return out


def first_step(family: str, cfg, plan: Dict[str, int], batch_np, logical,
               seed: int = 0) -> Dict[str, Any]:
    """The loss and the gradients of `family`'s seeded state on the global
    batch, before any update: the unsharded step's on rank 0 alone (the
    others wait), then the sharded step's on every rank, its gradients
    after the data-parallel reduction. -> rank 0: both losses and global
    gradient norms, their relative differences, and the largest relative
    L2 difference of a gradient leaf with its name; the other ranks {}."""
    import importlib

    import torch.distributed as dist

    from ray_tpu_torch.parallel.mesh import MeshConfig, build_mesh
    from ray_tpu_torch.parallel.sharding import (LogicalAxisRules,
                                                 full_tensor, shard_params)
    from ray_tpu_torch.train.backend import rank_device
    from ray_tpu_torch.train.optim import global_norm, tree_leaves
    from ray_tpu_torch.train.spmd import shard_local_batch

    mod = importlib.import_module(f"ray_tpu_torch.models.{family}")
    dev = rank_device()

    def loss_and_grads(mesh):
        params = mod.init(cfg, torch.Generator(device=dev).manual_seed(seed),
                          device=dev)
        batch = {k: torch.as_tensor(np.ascontiguousarray(v), device=dev)
                 for k, v in batch_np.items()}
        if mesh is not None:
            rules = LogicalAxisRules()
            params = shard_params(params, mod.param_logical_axes(cfg), mesh,
                                  rules)
            batch = {k: shard_local_batch({k: v}, rules.to_physical(
                logical[k], mesh), mesh, dev)[k] for k, v in batch_np.items()}
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        loss = mod.loss_fn(params, batch, cfg, mesh=mesh)
        grads = torch.autograd.grad(loss, leaves)
        return (float(full_tensor(loss)),
                [full_tensor(g).detach() for g in grads],
                list(_leaf_names(params)))

    one = loss_and_grads(None) if dist.get_rank() == 0 else None
    dist.barrier()
    loss, grads, names = loss_and_grads(build_mesh(MeshConfig(**plan),
                                                   device_type=dev.type))
    if one is None:
        return {}
    norms = float(global_norm(grads)), float(global_norm(one[1]))
    leaf_rel = [float((a.float() - b.float()).norm() / b.float().norm())
                for a, b in zip(grads, one[1])]
    worst = int(np.argmax(leaf_rel))
    return {"loss": (loss, one[0]),
            "loss_rel": abs(loss - one[0]) / abs(one[0]),
            "grad_norm": norms,
            "grad_norm_rel": abs(norms[0] - norms[1]) / abs(norms[1]),
            "leaf_rel_max": leaf_rel[worst], "leaf": names[worst]}


def _leaf_names(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaf_names(v, f"{prefix}{k}/")
    else:
        yield prefix.rstrip("/")


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
                seq: int, seed: int, compiled: bool) -> Dict[str, Any]:
    """One rank of the bench: rank 0 runs the one-GPU step first while the
    others wait, then every rank runs the mesh step (compiled, then eager,
    when `compiled`; eager alone otherwise)."""
    import torch.distributed as dist

    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (batch, seq + 1))
    one = (train_run(cfg, None, toks, steps, compiled=compiled)
           if dist.get_rank() == 0 else None)
    dist.barrier()
    forms = ("compiled", "eager") if compiled else ("eager",)
    return {"one": one, "mesh": {
        form: train_run(cfg, plan, toks, steps, compiled=form == "compiled")
        for form in forms}}


def nccl_split(collectives_ms: Optional[Dict[str, float]]):
    """(NCCL kernels' ms, the rest's ms) of `_profile_collectives`."""
    if not collectives_ms:
        return None, None
    nccl = sum(v for k, v in collectives_ms.items() if k != "compute")
    return nccl, collectives_ms.get("compute", 0.0)


def run(n_devices: int, steps: int = 3, device=None,
        timeout_s: float = 1500.0, compiled: bool = True) -> Dict[str, Any]:
    """The bench on a gang of n_devices ranks; -> its JSON object. compiled
    (the default, as `make_train_step`'s): the one-GPU step compiled, and
    the mesh step compiled and eager side by side, the top-level numbers
    the compiled one's; else every step eager."""
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
                      args=(n_devices, steps, plan, cfg, batch, seq, 1,
                            compiled))
    one = res[0]["one"]
    tokens = batch * seq
    flops_tok = llama.flops_per_token(cfg, seq)
    step_1 = one["step_s"]
    per_gpu_1 = tokens / step_1
    peak = None
    if on_card:
        from ray_tpu_torch._private.accelerators.nvidia import (
            bf16_peak_flops_per_device)
        from ray_tpu_torch.bench import nvidia_smi_line

        card = nvidia_smi_line()
        peak = bf16_peak_flops_per_device(card.split(",")[0])
    forms = {}
    for form in res[0]["mesh"]:
        meshes = [r["mesh"][form] for r in res]
        step_n = max(m["step_s"] for m in meshes)
        per_gpu_n = tokens / step_n / n_devices
        nccl_ms, compute_ms = nccl_split(meshes[0].get("collectives_ms"))
        forms[form] = {
            "step_time_ms": step_n * 1e3,
            "compile_s": max(m["compile_s"] for m in meshes),
            "tokens_per_sec_per_gpu": per_gpu_n,
            "scaling_efficiency": per_gpu_n / per_gpu_1,
            "mfu": flops_tok * per_gpu_n / peak if peak else None,
            "peak_gib_per_gpu": [m["peak_gib"] for m in meshes],
            "collectives_ms_rank0": meshes[0].get("collectives_ms"),
            "nccl_ms_rank0": nccl_ms, "compute_ms_rank0": compute_ms,
            "collectives_rank0": meshes[0].get("collectives"),
            "losses": meshes[0]["losses"],
            "grad_norms": meshes[0]["grad_norms"],
        }
    main_form = forms["compiled" if compiled else "eager"]
    diffs = [abs(a - b) for a, b in zip(one["losses"], main_form["losses"])]
    detail = {
        "platform": "gpu" if on_card else "cpu",
        "n_devices": n_devices,
        "mesh_axes": plan,
        "model_params_m": round(cfg.num_params() / 1e6, 1),
        "seq_len": seq,
        "global_batch": batch,
        "steps": steps,
        "compiled": compiled,
        "step_time_ms_1dev": step_1 * 1e3,
        "compile_s_1dev": one["compile_s"],
        "step_time_ms_ndev": main_form["step_time_ms"],
        "tokens_per_sec_per_gpu_1dev": per_gpu_1,
        "scaling_efficiency": main_form["scaling_efficiency"],
        "loss_max_abs_diff": max(diffs),
        "loss_max_rel_diff": max(d / abs(a) for d, a in
                                 zip(diffs, one["losses"])),
        "loss_1dev": one["losses"],
        "loss_ndev": main_form["losses"],
        "grad_norm_1dev": one["grad_norms"],
        "grad_norm_ndev": main_form["grad_norms"],
        "sharded": forms,
    }
    if on_card:
        detail.update({
            "card": card,
            "mfu_1dev": flops_tok * per_gpu_1 / peak,
            "mfu": main_form["mfu"],
            "peak_gib_1dev": one["peak_gib"],
            "peak_gib_per_gpu": main_form["peak_gib_per_gpu"],
            "collectives_ms_rank0": main_form["collectives_ms_rank0"],
        })
    return {"metric": "train_multigpu_tokens_per_sec_per_gpu",
            "value": main_form["tokens_per_sec_per_gpu"],
            "unit": "tokens/s/gpu", "detail": detail}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--n-devices", type=int, default=None,
                   help="ranks to span (default: every visible card)")
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--device", default=None, choices=("cuda", "cpu"))
    p.add_argument("--eager", action="store_true",
                   help="every step eager (default: the one-GPU step and "
                   "the mesh step compiled, the mesh step eager beside)")
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
    print(json.dumps(run(n, steps=args.steps, device=args.device,
                         compiled=not args.eager)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
