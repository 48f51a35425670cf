"""Rank-side runs of the SPMD path on numpy inputs, returning numpy.

A parity check holds the port's multi-rank path against a reference that
runs in another process (the JAX package, on its CPU mesh). These functions
are what each rank of a `train.backend.launch_gang` gang runs for it: they
take numpy arrays and plain values (picklable, made from a seed by the
caller), run the port's sharded functions on a mesh of the gang, and return
whole results as numpy (DTensors gathered with `full_tensor`), with the
flash kernels' calls counted on this rank. They import nothing but the
port, so a rank never loads what its caller has loaded.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Any, Dict, List

import numpy as np
import torch


def _full(x) -> np.ndarray:
    from ray_tpu_torch.parallel.sharding import full_tensor

    return full_tensor(x).detach().cpu().numpy()


def _tree_np(tree):
    if isinstance(tree, dict):
        return {k: _tree_np(v) for k, v in tree.items()}
    return _full(tree)


@contextlib.contextmanager
def counting_flash():
    """Count the calls of the flash forward and backward on this rank (the
    custom operators look their bodies up by name); -> the live counts."""
    from ray_tpu_torch.ops import flash_attention as fa

    counts = {"flash_fwd": 0, "flash_bwd": 0}
    fwd, bwd = fa._flash_fwd, fa._flash_bwd

    def count_fwd(*a):
        counts["flash_fwd"] += 1
        return fwd(*a)

    def count_bwd(*a):
        counts["flash_bwd"] += 1
        return bwd(*a)

    fa._flash_fwd, fa._flash_bwd = count_fwd, count_bwd
    try:
        yield counts
    finally:
        fa._flash_fwd, fa._flash_bwd = fwd, bwd


def _mesh(mesh_kw: Dict[str, int], num_slices: int = 1):
    from ray_tpu_torch.parallel.mesh import MeshConfig, build_multislice_mesh

    return build_multislice_mesh(MeshConfig(**mesh_kw), num_slices)


# -- mesh and sharding ---------------------------------------------------------

def mesh_cases(cases: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Per case {"mesh": config kwargs, "slices": n, "shape": tensor shape,
    "logical": logical axes}: the mesh's dim names and sizes, this rank's
    coordinate, the placements and local block (as (start, stop) per dim)
    of a tensor of that shape, and whether the full tensor comes back from
    its blocks (shard_params, then full_tensor)."""
    import torch.distributed as dist

    from ray_tpu_torch.parallel.mesh import mesh_sizes
    from ray_tpu_torch.parallel.sharding import (LogicalAxisRules,
                                                 local_slices, shard_params,
                                                 with_logical_constraint)

    out = []
    for case in cases:
        mesh = _mesh(case["mesh"], case.get("slices", 1))
        rules = LogicalAxisRules()
        placements = rules.to_physical(case["logical"], mesh)
        block = local_slices(case["shape"], placements, mesh)
        full = torch.arange(int(np.prod(case["shape"])),
                            dtype=torch.float32).reshape(case["shape"])
        sharded = shard_params({"w": full}, {"w": tuple(case["logical"])},
                               mesh, rules)["w"]
        replicated = with_logical_constraint(
            sharded, (None,) * full.dim(), mesh, rules)
        out.append({
            "rank": dist.get_rank(),
            "sizes": mesh_sizes(mesh),
            "coord": list(mesh.get_coordinate()),
            "placements": [repr(p) for p in placements],
            "block": [(s.start, s.stop) for s in block],
            "local_equal": bool(torch.equal(sharded.to_local(),
                                            full[block])),
            "round_trip": bool(torch.equal(sharded.full_tensor(), full)),
            "constrained": bool(torch.equal(replicated.to_local(), full)),
        })
    return out


def grad_reduce_case(mesh_kw, shape, logical, seed) -> Dict[str, Any]:
    """A bf16 parameter of `shape`, gathered over the data dims by
    `ShardingContext.gather`, whose gathered gradient on rank r is c_r
    (small integers from seed + r, so that bf16 holds every sum exactly).
    -> this rank's block's slices, c_r, its reduced gradient block (the
    backward's reduce-scatter and all-reduce) and its dtype, and the dtype
    the gather hands the model."""
    import torch.distributed as dist

    from ray_tpu_torch.parallel.sharding import ShardingContext, local_slices

    mesh = _mesh(mesh_kw)
    ctx = ShardingContext(mesh)
    placements = ctx.placements(logical)
    block = local_slices(shape, placements, mesh)
    local = torch.zeros(shape, dtype=torch.bfloat16)[block].clone()
    local.requires_grad_()
    w = ctx.gather(local, placements)
    c = np.random.default_rng(seed + dist.get_rank()).integers(
        -16, 17, w.shape).astype(np.float32)
    w.backward(torch.from_numpy(c).to(w.dtype))
    return {"block": [(sl.start, sl.stop) for sl in block], "c": c,
            "grad": local.grad.float().numpy(),
            "grad_dtype": str(local.grad.dtype), "gathered": str(w.dtype)}


def tp_sum_case(m, k, n, seed) -> Dict[str, Any]:
    """A row-parallel product of bf16 h [m, k] and w [k, n] (small integers,
    the same on every rank) over tp=<world>, each rank its k-block: summed
    by the engines' `tp_sum_f32` and by the training step's `tp_sum`, and
    whether the tp=<world> dense and paged engines sum with the former."""
    import torch.distributed as dist

    from ray_tpu_torch.inference.engine import (InferenceEngine,
                                                shard_params_for_inference)
    from ray_tpu_torch.inference.paged_engine import PagedInferenceEngine
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.models.llama import _row_out
    from ray_tpu_torch.parallel.sharding import ShardingContext

    world = dist.get_world_size()
    mesh = _mesh({"tp": world})
    ctx = ShardingContext(mesh)
    rng = np.random.default_rng(seed)
    h = rng.integers(-64, 65, (m, k)).astype(np.float32)
    w = rng.integers(-64, 65, (k, n)).astype(np.float32)
    t = ctx.coord["tp"]
    cut = slice(t * k // world, (t + 1) * k // world)
    hb = torch.from_numpy(h[:, cut]).to(torch.bfloat16)
    wb = torch.from_numpy(w[cut]).to(torch.bfloat16)
    cfg = llama.LlamaConfig(vocab_size=64, d_model=32, n_layers=1,
                            n_heads=world, n_kv_heads=world, d_head=8,
                            d_ff=64, max_seq_len=32)
    params = shard_params_for_inference(
        llama.init(cfg, torch.Generator().manual_seed(seed), device="cpu"),
        cfg, mesh)
    engines = (InferenceEngine(params, cfg, max_batch=1, max_len=16,
                               mesh=mesh, device="cpu"),
               PagedInferenceEngine(params, cfg, block_size=4, max_len=16,
                                    max_batch=1, mesh=mesh, device="cpu"))
    f32 = _row_out(hb, wb, ctx.tp_sum_f32)
    return {"h": h, "w": w, "f32": f32.float().numpy(),
            "f32_dtype": str(f32.dtype),
            "bf16": _row_out(hb, wb, ctx.tp_sum).float().numpy(),
            "engines_f32": [eng._fwd.keywords["tp_sum"].__func__
                            is ShardingContext.tp_sum_f32 for eng in engines]}


def checkpoint_case(mesh_kw, shape, logical) -> Dict[str, Any]:
    """A bf16 DTensor of `shape` in the layout `logical` names, saved by
    `Checkpoint.from_arrays` on every rank (each into its own directory)
    and read back: -> whether the saved leaf is the whole tensor, bit for
    bit, its dtype, and this rank's block's shape."""
    import tempfile

    from ray_tpu_torch.parallel.sharding import (LogicalAxisRules,
                                                 distribute_full)
    from ray_tpu_torch.train.checkpoint import Checkpoint

    mesh = _mesh(mesh_kw)
    full = torch.arange(int(np.prod(shape)), dtype=torch.float32).reshape(
        shape).to(torch.bfloat16)
    w = distribute_full(full, mesh,
                        LogicalAxisRules().to_physical(logical, mesh))
    back = Checkpoint.from_arrays({"w": w, "step": 3},
                                  tempfile.mkdtemp()).to_arrays()
    return {"whole": bool(torch.equal(back["w"].view(torch.int16),
                                      full.view(torch.int16))),
            "dtype": str(back["w"].dtype), "step": back["step"],
            "local_shape": tuple(w.to_local().shape)}


def batch_blocks(mesh_kw, slices, batch_np) -> Dict[str, Any]:
    """This rank's block of a global batch under `batch_sharding`, and its
    mesh coordinate."""
    from ray_tpu_torch.train.spmd import batch_sharding, shard_local_batch

    mesh = _mesh(mesh_kw, slices)
    got = shard_local_batch({"x": batch_np}, batch_sharding(mesh), mesh,
                            torch.device("cpu"))["x"]
    return {"coord": list(mesh.get_coordinate()),
            "local": got.to_local().numpy(),
            "full": got.full_tensor().numpy()}


def feed_blocks(mesh_kw, slices, batches_np, prefetch) -> Dict[str, Any]:
    """The sharded device feed over global batches ({name: numpy}): per
    batch and column, the local block of the DTensor it yields, the block
    shard_local_batch gives the same batch, and the global shape; whether
    the feed ended with its source, its batch count and this rank's mesh
    coordinate."""
    from ray_tpu_torch.data import iter_device_batches
    from ray_tpu_torch.train.spmd import batch_sharding, shard_local_batch

    mesh = _mesh(mesh_kw, slices)
    sharding = batch_sharding(mesh)
    stats: Dict[str, Any] = {}
    out = []
    fed = iter_device_batches(iter(batches_np), device="cpu",
                              sharding=sharding, mesh=mesh,
                              prefetch=prefetch, stats=stats)
    for got, src in zip(fed, batches_np):
        want = shard_local_batch(src, sharding, mesh, torch.device("cpu"))
        out.append({k: {"local": got[k].to_local().numpy(),
                        "want": want[k].to_local().numpy(),
                        "shape": tuple(got[k].shape),
                        "placements":
                            got[k].placements == want[k].placements}
                    for k in src})
    return {"batches": out, "exhausted": next(fed, None) is None,
            "fed": stats["batches"], "coord": list(mesh.get_coordinate())}


def position_feed_blocks(mesh_kw, slices, batches_np, prefetch
                         ) -> Dict[str, Any]:
    """The sharded device feed over only this rank's data position's rows
    of each global batch ({name: numpy}; `local_rows`): per batch and
    column, the local block of the DTensor it yields, the block
    shard_local_batch gives the whole global batch, the DTensor's global
    shape and its value gathered whole; this rank's (position, count)."""
    from ray_tpu_torch.data import iter_device_batches
    from ray_tpu_torch.train.spmd import (batch_sharding, data_position,
                                          shard_local_batch)

    mesh = _mesh(mesh_kw, slices)
    sharding = batch_sharding(mesh)
    pos, n = data_position(sharding, mesh)

    def mine(batch):
        return {k: v[pos * (len(v) // n):(pos + 1) * (len(v) // n)]
                for k, v in batch.items()}

    fed = iter_device_batches((mine(b) for b in batches_np), device="cpu",
                              sharding=sharding, mesh=mesh, local_rows=True,
                              prefetch=prefetch)
    out = []
    for got, src in zip(fed, batches_np):
        want = shard_local_batch(src, sharding, mesh, torch.device("cpu"))
        out.append({k: {"local": got[k].to_local().numpy(),
                        "want": want[k].to_local().numpy(),
                        "shape": tuple(got[k].shape),
                        "full": got[k].full_tensor().numpy()} for k in src})
    return {"batches": out, "position": [pos, n]}


# -- ring and sharded flash attention -------------------------------------------

def attention_cases(cases: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Per case {"fn": "ring" or "flash", "mesh", "causal", "q", "k", "v",
    "do"}: `ring_attention_sharded` (over the mesh's sp dim) or
    `flash_attention_sharded` on DTensors of q/k/v ([B,S,H|H_kv,D], placed
    as the rules place ("batch", "seq", "act_heads", "act_kv")), -> whole o,
    dq, dk, dv (the gradients of sum(o * do)), o's placements and this
    rank's flash calls."""
    from ray_tpu_torch.ops.flash_attention import flash_attention_sharded
    from ray_tpu_torch.parallel.mesh import mesh_sizes
    from ray_tpu_torch.parallel.ring_attention import ring_attention_sharded
    from ray_tpu_torch.parallel.sharding import (LogicalAxisRules,
                                                 distribute_full)

    fns = {"ring": ring_attention_sharded, "flash": flash_attention_sharded}
    out = []
    for case in cases:
        mesh = _mesh(case["mesh"])
        sizes = mesh_sizes(mesh)
        data = sizes["dcn"] if "dcn" in sizes else 1
        data *= sizes["dp"] * sizes["fsdp"]

        def place(x):
            # batch and heads split where they divide, else whole
            batch = "batch" if x.shape[0] % data == 0 else None
            heads = "act_heads" if x.shape[2] % sizes["tp"] == 0 else None
            pl = LogicalAxisRules().to_physical(
                (batch, "seq", heads, "act_kv"), mesh)
            return distribute_full(torch.from_numpy(x), mesh, pl)

        q, k, v, do = (place(case[n]) for n in ("q", "k", "v", "do"))
        for t in (q, k, v):
            t.requires_grad_(True)
        with counting_flash() as counts:
            o = fns[case["fn"]](q, k, v, mesh, causal=case["causal"])
            fwd_calls = counts["flash_fwd"]
            grads = torch.autograd.grad(o, (q, k, v), grad_outputs=do)
        out.append({"o": _full(o), "dq": _full(grads[0]),
                    "dk": _full(grads[1]), "dv": _full(grads[2]),
                    "placements_kept": o.placements == q.placements,
                    "sp_coord": (mesh.get_local_rank("sp")
                                 if sizes["sp"] > 1 else 0),
                    "fwd_calls": fwd_calls,
                    "bwd_calls": counts["flash_bwd"]})
    return out


# -- the sharded Llama step ----------------------------------------------------

def _llama(cfg_kw):
    from ray_tpu_torch.models import llama

    return dataclasses.replace(llama.LlamaConfig.tiny(), dtype=torch.float32,
                               **cfg_kw)


def loss_and_grads(params_np, batch_np, cfg_kw, mesh_kw, slices=1
                   ) -> Dict[str, Any]:
    """The tiny fp32 Llama's loss and gradients on the mesh from numpy
    weights (the JAX init's) and a global batch; -> loss, whole gradients,
    the global norm of the DTensor gradients, this rank's flash calls
    (under remat "dots") and the whole logits of `forward` on the mesh."""
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.models.convert import params_from_jax_numpy
    from ray_tpu_torch.parallel.sharding import shard_params
    from ray_tpu_torch.train.optim import global_norm, tree_leaves
    from ray_tpu_torch.train.spmd import batch_sharding, shard_local_batch

    cfg = _llama(cfg_kw)
    mesh = _mesh(mesh_kw, slices)
    params = shard_params(params_from_jax_numpy(params_np, cfg, "cpu"),
                          llama.param_logical_axes(cfg), mesh)
    batch = shard_local_batch(batch_np, batch_sharding(mesh), mesh,
                              torch.device("cpu"))
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    with counting_flash() as counts:
        loss = llama.loss_fn(params, batch, cfg, mesh=mesh)
        grads = torch.autograd.grad(loss, leaves)
    with torch.no_grad():
        logits = llama.forward(params, batch["inputs"], cfg, mesh=mesh)
    names = _leaf_names(params)
    return {"loss": float(loss), "logits": _full(logits),
            "logits_placements": [repr(p) for p in logits.placements],
            "grads": {n: _full(g) for n, g in zip(names, grads)},
            "grad_norm": float(global_norm(list(grads))),
            "calls": dict(counts)}


def _leaf_names(tree, prefix=""):
    if isinstance(tree, dict):
        return [n for k, v in tree.items()
                for n in _leaf_names(v, f"{prefix}{k}/")]
    return [prefix.rstrip("/")]


def train_steps(params_np, batches_np, cfg_kw, mesh_kw, lr, weight_decay,
                slices=1, compiled=False) -> Dict[str, Any]:
    """AdamW steps of the sharded step from numpy weights, one per global
    batch, eagerly or compiled (aot_eager, fullgraph); -> [(loss, grad
    norm)], the whole final parameters and this rank's flash calls a
    step."""
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.models.convert import params_from_jax_numpy
    from ray_tpu_torch.train import adamw, init_train_state, make_train_step
    from ray_tpu_torch.train.optim import tree_leaves
    from ray_tpu_torch.train.spmd import batch_sharding, shard_local_batch

    cfg = _llama(cfg_kw)
    mesh = _mesh(mesh_kw, slices)
    opt = adamw(lr, weight_decay=weight_decay)
    state = init_train_state(
        lambda dev: params_from_jax_numpy(params_np, cfg, dev), opt,
        device="cpu", param_logical_axes=llama.param_logical_axes(cfg),
        mesh=mesh)
    torch._dynamo.reset()
    step = make_train_step(functools.partial(llama.loss_fn, config=cfg,
                                             mesh=mesh), opt,
                           compiled=compiled, backend="aot_eager")
    metrics, calls = [], []
    for b in batches_np:
        batch = shard_local_batch(b, batch_sharding(mesh), mesh,
                                  torch.device("cpu"))
        with counting_flash() as counts:
            state, m = step(state, batch)
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
        calls.append(dict(counts))
    torch._dynamo.reset()
    return {"metrics": metrics, "params": _tree_np(state.params),
            "calls": calls,
            "moment_placements_match": all(
                p.placements == mu.placements == nu.placements
                for p, mu, nu in zip(tree_leaves(state.params),
                                     tree_leaves(state.opt_state.mu),
                                     tree_leaves(state.opt_state.nu)))}


# -- the compiled sharded step and the zoo on the mesh -------------------------

_CONFIGS = {"llama": "LlamaConfig", "mixtral": "MixtralConfig",
            "vit": "ViTConfig", "t5": "T5Config"}


def _family(family, cfg_kw):
    """The port's model module of `family` and its tiny fp32 config."""
    import importlib

    mod = importlib.import_module(f"ray_tpu_torch.models.{family}")
    tiny = getattr(mod, _CONFIGS[family]).tiny()
    return mod, dataclasses.replace(tiny, dtype=torch.float32, **cfg_kw)


def _shard_batch(batch_np, logical, mesh):
    """{name: global numpy} -> {name: DTensor}, each placed as its logical
    axes `logical[name]` say."""
    from ray_tpu_torch.parallel.sharding import LogicalAxisRules
    from ray_tpu_torch.train.spmd import shard_local_batch

    rules = LogicalAxisRules()
    return {name: shard_local_batch(
        {name: x}, rules.to_physical(logical[name], mesh), mesh,
        torch.device("cpu"))[name] for name, x in batch_np.items()}


def zoo_loss_and_grads(family, params_np, batch_np, logical, cfg_kw,
                       mesh_kw) -> Dict[str, Any]:
    """`family`'s loss_fn(mesh=...) on the tiny fp32 config from numpy
    weights (the JAX init's) and a global batch: -> the loss, the whole
    gradients by name and the whole logits of its forward(mesh=...)."""
    from ray_tpu_torch.models.convert import params_from_jax_numpy
    from ray_tpu_torch.parallel.sharding import shard_params
    from ray_tpu_torch.train.optim import tree_leaves

    mod, cfg = _family(family, cfg_kw)
    mesh = _mesh(mesh_kw)
    params = shard_params(params_from_jax_numpy(params_np, cfg, "cpu"),
                          mod.param_logical_axes(cfg), mesh)
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    batch = _shard_batch(batch_np, logical, mesh)
    loss = mod.loss_fn(params, batch, cfg, mesh=mesh)
    grads = torch.autograd.grad(loss, leaves)
    with torch.no_grad():
        out = mod.forward(params, *_forward_inputs(family, batch), cfg,
                          mesh=mesh)
    logits = out[0] if family == "mixtral" else out
    return {"loss": float(loss), "logits": _full(logits),
            "grads": {n: _full(g) for n, g in zip(_leaf_names(params),
                                                  grads)}}


def _forward_inputs(family, batch):
    """The positional inputs of `family`'s forward in its loss batch."""
    if family == "vit":
        return (batch["images"],)
    if family == "t5":
        return batch["src"], batch["tgt"][:, :-1]
    return (batch["inputs"],)


def zoo_train_steps(family, params_np, batches_np, logical, cfg_kw, mesh_kw,
                    lr, weight_decay, compiled) -> Dict[str, Any]:
    """AdamW steps of `family`'s sharded step from numpy weights, one per
    global batch, compiled (aot_eager, fullgraph) or eagerly; -> [(loss,
    grad norm)], the whole final parameters and this rank's flash calls."""
    from ray_tpu_torch.models.convert import params_from_jax_numpy
    from ray_tpu_torch.train import adamw, init_train_state, make_train_step

    mod, cfg = _family(family, cfg_kw)
    mesh = _mesh(mesh_kw)
    torch._dynamo.reset()
    opt = adamw(lr, weight_decay=weight_decay)
    state = init_train_state(
        lambda dev: params_from_jax_numpy(params_np, cfg, dev), opt,
        device="cpu", param_logical_axes=mod.param_logical_axes(cfg),
        mesh=mesh)
    step = make_train_step(functools.partial(mod.loss_fn, config=cfg,
                                             mesh=mesh), opt,
                           compiled=compiled, backend="aot_eager")
    metrics = []
    with counting_flash() as counts:
        for b in batches_np:
            state, m = step(state, _shard_batch(b, logical, mesh))
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
    torch._dynamo.reset()
    return {"metrics": metrics, "params": _tree_np(state.params),
            "calls": dict(counts)}


def report_case(family, cfg_kw, mesh_kw, batch_np, logical, lr=1e-3
                ) -> Dict[str, Any]:
    """`collective_report` of `family`'s compiled sharded step (aot_eager,
    fullgraph) on its tiny fp32 config from a seeded init, before any step:
    -> the report, the collectives by node ({"op", "kind", "count",
    "bytes", "numel"}), whether the state is bit for bit what it was
    (parameters, moments, counts) and the parameters' whole element count
    and bytes."""
    from ray_tpu_torch.parallel.hlo_report import collective_report, collectives
    from ray_tpu_torch.train import adamw, init_train_state, make_train_step
    from ray_tpu_torch.train.optim import tree_leaves

    mod, cfg = _family(family, cfg_kw)
    mesh = _mesh(mesh_kw)
    torch._dynamo.reset()
    opt = adamw(lr)
    state = init_train_state(
        functools.partial(mod.init, cfg, torch.Generator().manual_seed(0)),
        opt, device="cpu", param_logical_axes=mod.param_logical_axes(cfg),
        mesh=mesh)
    step = make_train_step(functools.partial(mod.loss_fn, config=cfg,
                                             mesh=mesh), opt,
                           backend="aot_eager")
    batch = _shard_batch(batch_np, logical, mesh)
    leaves = [tree_leaves(t) for t in (state.params, state.opt_state.mu,
                                       state.opt_state.nu)]
    before = [[x.to_local().clone() for x in ls] for ls in leaves]
    report = collective_report(step, state, batch)
    nodes = collectives(step, state, batch)
    same = (state.opt_state.count == 0 and int(state.step) == 0 and all(
        torch.equal(x.to_local(), y) for ls, bs in zip(leaves, before)
        for x, y in zip(ls, bs)))
    torch._dynamo.reset()
    return {"report": report, "nodes": nodes, "state_unchanged": same,
            "params": sum(x.numel() for x in leaves[0]),
            "param_bytes": sum(x.numel() * x.element_size()
                               for x in leaves[0])}


# -- pipeline, experts, tp serving ---------------------------------------------

def pipeline_case(ws, xs, ct, mesh_kw) -> Dict[str, Any]:
    """`pipeline_sharded` of tanh(x @ w[0]) stages over the mesh's pp dim:
    ws [pp, d, d], xs [M, mb, d] -> the whole output and the whole
    gradients of sum(out * ct) with respect to ws and xs."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from ray_tpu_torch.parallel.pipeline import pipeline_sharded
    from ray_tpu_torch.parallel.sharding import distribute_full

    mesh = _mesh(mesh_kw)
    names = mesh.mesh_dim_names
    rep = [Replicate()] * len(names)
    staged = [Shard(0) if n == "pp" else Replicate() for n in names]
    wd = distribute_full(torch.from_numpy(ws), mesh, staged)
    xd = DTensor.from_local(torch.from_numpy(xs), mesh, rep, run_check=False)
    wd.requires_grad_(True)
    xd.requires_grad_(True)
    out = pipeline_sharded(lambda w, x: torch.tanh(x @ w[0]), mesh)(wd, xd)
    dw, dx = torch.autograd.grad(
        (out.to_local() * torch.from_numpy(ct)).sum(), (wd, xd))
    return {"out": _full(out), "dw": _full(dw), "dx": _full(dx)}


def moe_case(x, gate_w, ew, mesh_kw, k, capacity_factor) -> Dict[str, Any]:
    """`moe_shard_map` with experts t @ w_e split over the mesh's ep dim:
    -> the whole output, aux, the gradients of sum(out) with respect to x,
    gate_w and the expert weights, and that of aux with respect to gate_w
    (all whole)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from ray_tpu_torch.parallel.moe import moe_shard_map
    from ray_tpu_torch.parallel.sharding import distribute_full

    mesh = _mesh(mesh_kw)
    names = mesh.mesh_dim_names
    rep = [Replicate()] * len(names)
    split = [Shard(0) if n == "ep" else Replicate() for n in names]
    xd = distribute_full(torch.from_numpy(x), mesh, split).requires_grad_(True)
    gd = DTensor.from_local(torch.from_numpy(gate_w), mesh, rep,
                            run_check=False).requires_grad_(True)
    ed = distribute_full(torch.from_numpy(ew), mesh, split).requires_grad_(True)
    out, aux = moe_shard_map(xd, gd, lambda w, t: torch.bmm(t, w), ed, mesh,
                             k=k, capacity_factor=capacity_factor)
    gx, gg, ge = torch.autograd.grad(out.to_local().sum(), (xd, gd, ed),
                                     retain_graph=True)
    (ga,) = torch.autograd.grad(aux.to_local(), gd)
    return {"out": _full(out), "aux": float(aux.to_local()),
            "dx": _full(gx), "dgate": _full(gg), "dexperts": _full(ge),
            "daux_dgate": _full(ga)}


def paged_tp_case(params_np, cfg_kw, mesh_kw, engine_kw, prompts,
                  max_new_tokens) -> Dict[str, Any]:
    """The paged engine tensor-parallel over the mesh's tp dim, from numpy
    weights: -> its streams and host state after `generate`."""
    from ray_tpu_torch.inference import GenerationConfig
    from ray_tpu_torch.inference.engine import shard_params_for_inference
    from ray_tpu_torch.inference.paged_engine import PagedInferenceEngine
    from ray_tpu_torch.models.convert import params_from_jax_numpy

    cfg = _llama(cfg_kw)
    mesh = _mesh(mesh_kw)
    params = shard_params_for_inference(
        params_from_jax_numpy(params_np, cfg, "cpu"), cfg, mesh)
    eng = PagedInferenceEngine(params, cfg, mesh=mesh, device="cpu",
                               **engine_kw)
    streams = eng.generate(prompts, GenerationConfig(
        max_new_tokens=max_new_tokens))
    return {"streams": streams, "block_table": eng.block_table.copy(),
            "lengths": eng.lengths.copy(),
            "free_blocks": sorted(eng.free_blocks),
            "cached": list(eng.cached_lru),
            "prefix_stats": dict(eng.prefix_stats),
            "pool_local_shape": tuple(eng.pool["k"].shape),
            "pool_placements": [repr(p) for p in eng.pool_placements]}


def dense_tp_case(params_np, cfg_kw, mesh_kw, engine_kw, prompts,
                  max_new_tokens) -> Dict[str, Any]:
    """The dense engine tensor-parallel over the mesh's tp dim, from numpy
    weights: -> its streams after `generate`, and its cache's local shape
    and placements."""
    from ray_tpu_torch.inference import GenerationConfig
    from ray_tpu_torch.inference.engine import (InferenceEngine,
                                                shard_params_for_inference)
    from ray_tpu_torch.models.convert import params_from_jax_numpy

    cfg = _llama(cfg_kw)
    mesh = _mesh(mesh_kw)
    params = shard_params_for_inference(
        params_from_jax_numpy(params_np, cfg, "cpu"), cfg, mesh)
    eng = InferenceEngine(params, cfg, mesh=mesh, device="cpu", **engine_kw)
    streams = eng.generate(prompts, GenerationConfig(
        max_new_tokens=max_new_tokens))
    return {"streams": streams,
            "cache_local_shape": tuple(eng.cache["k"].shape),
            "cache_placements": [repr(p) for p in eng.cache_placements]}


# -- collective groups ---------------------------------------------------------

def _error(fn) -> str:
    """'TypeName: message' of what fn() raises, or '' when it returns."""
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the caller checks the type
        return f"{type(e).__name__}: {e}"
    return ""


def mesh_collectives(name, x, chunks, src, compiled):
    """Every mesh collective of the group `name` on this rank's x and
    chunks (torch tensors): the four reductions, allgather, broadcast from
    position src, reducescatter of the chunk list and of a pytree chunk
    list, and a bf16 sum; eagerly, or inside one aot_eager fullgraph
    function. -> {result name: numpy}."""
    from ray_tpu_torch.util import collective as col

    def fn(x, chunks):
        out = {op: col.allreduce(x, name, op) for op in (
            col.ReduceOp.SUM, col.ReduceOp.PRODUCT, col.ReduceOp.MIN,
            col.ReduceOp.MAX)}
        out["allgather"] = col.allgather(x, name)
        out["broadcast"] = col.broadcast(x, src, name)
        out["reducescatter"] = col.reducescatter(list(chunks), name)
        tree = col.reducescatter([{"g": c, "h": [c * 2]} for c in chunks],
                                 name)
        out["reducescatter_tree_g"] = tree["g"]
        out["reducescatter_tree_h"] = tree["h"][0]
        out["bf16_sum"] = col.allreduce(x.to(torch.bfloat16), name).float()
        return out

    if compiled:
        torch._dynamo.reset()
        fn = torch.compile(fn, backend="aot_eager", fullgraph=True)
    out = fn(x, tuple(chunks))
    return {k: v.cpu().numpy() for k, v in out.items()}


def mesh_collective_errors(name, noaxes_name, x, chunks, n):
    """The typed errors of the mesh group `name` (n positions) on this
    rank's tensors, each eagerly and inside an aot_eager fullgraph
    function: a chunk list one short, a broadcast source n, send and recv
    inside a compiled region, a group with no axes and no mesh while
    compiling (`noaxes_name`), a DTensor that spans the gang. ->
    {case: 'TypeName: message'}."""
    from torch.distributed.tensor import Replicate

    from ray_tpu_torch.parallel.sharding import distribute_full
    from ray_tpu_torch.util import collective as col

    def compiled(fn):
        torch._dynamo.reset()
        return _error(lambda: torch.compile(
            fn, backend="aot_eager", fullgraph=True)(x))

    short = list(chunks)[:-1]
    mesh = col.get_group_mesh(name)
    spread = distribute_full(x, mesh, [Replicate()] * mesh.ndim)
    return {
        "chunks_eager": _error(lambda: col.reducescatter(short, name)),
        "chunks_compiled": compiled(
            lambda v: col.reducescatter([v] * (n - 1), name)),
        "src_eager": _error(lambda: col.broadcast(x, n, name)),
        "src_compiled": compiled(lambda v: col.broadcast(v, n, name)),
        "send_compiled": compiled(lambda v: (col.send(v, 0, name), v)[1]),
        "recv_compiled": compiled(lambda v: (col.recv(0, name), v)[1]),
        "noaxes_compiled": compiled(
            lambda v: col.allreduce(v, noaxes_name)),
        "dtensor_eager": _error(lambda: col.allreduce(spread, name)),
    }


def collective_cases(groups, host, errors):
    """On this rank, its tensors on its device: each mesh group of `groups`
    ({name: (mesh config kwargs, mesh_axes, per-rank x, per-rank chunks,
    broadcast src)}) bootstrapped and run eagerly and compiled
    (`mesh_collectives`); the host path on `host` (per-rank values: a
    pytree, a gather value, the broadcast payload on its source, chunks)
    over a "host" group and over a mesh group's numpy path, with a
    send/recv ring and interleaved tags (`host_collectives`); the typed
    errors of the mesh group `errors`; and a group whose world is not the
    gang's. -> {...} of numpy."""
    import torch.distributed as dist

    from ray_tpu_torch.parallel.mesh import MeshConfig
    from ray_tpu_torch.train.backend import rank_device
    from ray_tpu_torch.util import collective as col

    rank, world = dist.get_rank(), dist.get_world_size()
    dev = rank_device()

    def on_dev(x):
        return torch.from_numpy(x).to(dev)

    out = {"mesh": {}, "rank": rank}
    for name, (mesh_kw, axes, xs, chunks, src) in groups.items():
        col.init_collective_group(world, rank, "mesh", name, mesh_axes=axes)
        col.bootstrap_mesh(MeshConfig(**mesh_kw), group_name=name)
        x = on_dev(xs[rank])
        ch = [on_dev(c) for c in chunks[rank]]
        out["mesh"][name] = {
            form: mesh_collectives(name, x, ch, src, form == "compiled")
            for form in ("eager", "compiled")}
    col.init_collective_group(world, rank, "mesh", "noaxes")
    name = errors
    n = len(groups[name][3][rank])
    out["errors"] = mesh_collective_errors(
        name, "noaxes", on_dev(groups[name][2][rank]),
        [on_dev(c) for c in groups[name][3][rank]], n)
    out["mismatch"] = _error(lambda: col.init_collective_group(
        world - 1, rank % (world - 1), "host", "wrong_world"))
    col.init_collective_group(world, rank, "host", "host")
    out["host"] = host_collectives("host", host, rank, world)
    out["host_on_mesh"] = host_collectives("noaxes", host, rank, world)
    out["info"] = col.get_group_info("host")
    for name in list(groups) + ["noaxes", "host"]:
        col.destroy_collective_group(name)
    out["left"] = [col.is_group_initialized(n) for n in groups]
    return out


def allreduce_busbw(nbytes, iters) -> Dict[str, Any]:
    """One NCCL all-reduce of `nbytes` of bf16 over the gang, timed on the
    card with CUDA events over `iters` calls after two warm-up calls: ->
    rank 0: ms a call, the algorithm bandwidth (bytes / s) and the bus
    bandwidth (algbw * 2(n - 1) / n); the other ranks {}."""
    import torch.distributed as dist

    from ray_tpu_torch.train.backend import rank_device

    n = dist.get_world_size()
    x = torch.zeros(nbytes // 2, dtype=torch.bfloat16, device=rank_device())
    for _ in range(2):
        dist.all_reduce(x)
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        dist.all_reduce(x)
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / iters
    if dist.get_rank() != 0:
        return {}
    algbw = nbytes / (ms / 1e3)
    return {"bytes": nbytes, "ms": ms, "algbw": algbw,
            "busbw": algbw * 2 * (n - 1) / n, "ranks": n}


def spmd_versus_one(*args) -> Dict[str, Any]:
    """`train.spmd_bench.versus_one(*args)` on this rank."""
    from ray_tpu_torch.train import spmd_bench

    return spmd_bench.versus_one(*args)


def host_collectives(name, values, rank, world):
    """The host path of group `name` on this rank's numpy values: each
    reduction of a pytree, allgather, broadcast from rank 2, reducescatter,
    a send/recv ring on tag 7, two messages on tags 8 and 9 received in the
    other order, and a barrier. -> {result name: numpy or pytree}."""
    from ray_tpu_torch.util import collective as col

    v = values[rank]
    out = {op: col.allreduce(v["tree"], name, op) for op in (
        col.ReduceOp.SUM, col.ReduceOp.PRODUCT, col.ReduceOp.MIN,
        col.ReduceOp.MAX)}
    out["allgather"] = col.allgather(v["gather"], name)
    out["broadcast"] = col.broadcast(v["payload"] if rank == 2 else None, 2,
                                     name)
    out["reducescatter"] = col.reducescatter(v["chunks"], name)
    col.send(np.array([rank]), (rank + 1) % world, name, tag=7)
    out["ring"] = int(col.recv((rank - 1) % world, name, tag=7)[0])
    peer = (rank + 1) % world
    col.send({"tag": 8, "from": rank}, peer, name, tag=8)
    col.send({"tag": 9, "from": rank}, peer, name, tag=9)
    prev = (rank - 1) % world
    out["tags"] = [col.recv(prev, name, tag=9), col.recv(prev, name, tag=8)]
    col.barrier(name)
    return out


# -- on the card: each rank on its device ---------------------------------------

def _swiglu(w, x):
    """A Llama MLP stage (SwiGLU) of this rank's stage parameters."""
    return (torch.nn.functional.silu(x @ w["w_gate"][0])
            * (x @ w["w_up"][0])) @ w["w_down"][0]


def pipeline_mlp_case(d_model, d_ff, m, mb, seed) -> Dict[str, Any]:
    """A pp=<world> GPipe pipeline of Llama MLP stages (fp32, SwiGLU at
    d_model x d_ff) over every rank, on this rank's device: the output and
    the gradients of sum(out * ct) with respect to the stage parameters
    and the microbatches [m, mb, d_model], against the sequential
    composition of the same stages on rank 0 alone. -> rank 0: the largest
    relative error of each against it and the pipeline's seconds."""
    import time

    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from ray_tpu_torch.parallel.pipeline import pipeline_sharded
    from ray_tpu_torch.parallel.sharding import distribute_full
    from ray_tpu_torch.train.backend import rank_device

    dev = rank_device()
    n = dist.get_world_size()
    mesh = _mesh({"pp": n})
    g = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev) * scale

    full = {"w_gate": randn(n, d_model, d_ff, scale=d_model ** -0.5),
            "w_up": randn(n, d_model, d_ff, scale=d_model ** -0.5),
            "w_down": randn(n, d_ff, d_model, scale=d_ff ** -0.5)}
    xs, ct = randn(m, mb, d_model), randn(m, mb, d_model)
    names = mesh.mesh_dim_names
    rep = [Replicate()] * len(names)
    staged = [Shard(0) if a == "pp" else Replicate() for a in names]
    wd = {k: distribute_full(v, mesh, staged).requires_grad_(True)
          for k, v in full.items()}
    xd = DTensor.from_local(xs, mesh, rep,
                            run_check=False).requires_grad_(True)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = pipeline_sharded(_swiglu, mesh)(wd, xd)
    grads = torch.autograd.grad((out.to_local() * ct).sum(),
                                list(wd.values()) + [xd])
    got = [_full_tensor(x) for x in [out] + list(grads)]
    if dev.type == "cuda":
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    if dist.get_rank() != 0:
        return {}
    ws = {k: v.clone().requires_grad_(True) for k, v in full.items()}
    x = xs.clone().requires_grad_(True)
    y = x
    for i in range(n):
        y = _swiglu({k: w[i:i + 1] for k, w in ws.items()}, y)
    want = [y] + list(torch.autograd.grad((y * ct).sum(),
                                          list(ws.values()) + [x]))

    def rel(a, b):
        b = b.detach()
        return float((a - b).norm() / b.norm())

    errs = dict(zip(["out"] + [f"d{k}" for k in full] + ["dx"],
                    (rel(a, b) for a, b in zip(got, want))))
    return {"rel_err": errs, "seconds": secs}


def _full_tensor(x):
    from ray_tpu_torch.parallel.sharding import full_tensor

    return full_tensor(x).detach()


def dense_engine_versus_one(cfg, prompts, max_new_tokens, max_len, seed
                            ) -> Dict[str, Any]:
    """The dense engine tensor-parallel over tp=<world> against the one-card
    engine (rank 0 alone, first) on the same weights (`llama.init` of
    `cfg` from `seed` on each rank) and prompts: greedy streams, and the
    prompts' prefill logits through each engine's forward on a fresh cache.
    -> rank 0: both streams, the logits' relative L2 difference, whether
    every request's first token agrees and, per request, the tokens that
    agree before the first divergence; where the difference arises: per
    layer, the relative L2 difference of the prefill's residual stream
    after it ("stream_rel") and of the layer's own update given one card's
    input ("layer_rel"); and one card's own logits with each prompt
    prefilled alone against the batch ("alone_rel")."""
    import torch.distributed as dist

    from ray_tpu_torch.inference import GenerationConfig, InferenceEngine
    from ray_tpu_torch.inference.engine import shard_params_for_inference
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.train.backend import rank_device

    dev = rank_device()
    n = dist.get_world_size()
    gen_cfg = GenerationConfig(max_new_tokens=max_new_tokens)
    full = llama.init(cfg, torch.Generator(device=dev).manual_seed(seed),
                      device=dev)
    b, s = len(prompts), max(len(p) for p in prompts)
    tokens = torch.zeros((b, s), dtype=torch.int64, device=dev)
    valid = torch.zeros((b, s), dtype=torch.bool, device=dev)
    for i, p in enumerate(prompts):
        tokens[i, :len(p)] = torch.as_tensor(p)
        valid[i, :len(p)] = True

    def prefill(eng, toks):
        """The prompts' logits through the engine's own forward."""
        config = eng._model_config
        cache = llama.init_kv_cache(config, len(toks), max_len, device=dev)
        zeros = torch.zeros(len(toks), dtype=torch.int64, device=dev)
        with torch.no_grad():
            return eng._fwd(eng.params, toks, cache, zeros, config)[0]

    def stream(eng, feed=None):
        """The prefill's residual stream (the embedding, then each layer's
        output) through llama's sublayers with the engine's tp sum; with
        `feed` (one card's stream) layer i reads feed[i], not its own."""
        c, params = eng._model_config, eng.params
        tp_sum = getattr(eng._fwd, "keywords", {}).get("tp_sum")
        cache = llama.init_kv_cache(c, b, max_len, device=dev)
        zeros = torch.zeros(b, dtype=torch.int64, device=dev)
        positions = torch.arange(s, device=dev).expand(b, s)
        out = [params["embed"][tokens].to(c.dtype)]
        with torch.no_grad():
            for i in range(c.n_layers):
                lp = llama._layer_params(params, i)
                x = llama._attn_sublayer(
                    out[-1] if feed is None else feed[i], lp, positions, c,
                    kv_cache=(cache["k"][i], cache["v"][i]), lengths=zeros,
                    tp_sum=tp_sum)
                out.append(llama._mlp_sublayer(x, lp, c, tp_sum=tp_sum))
        return out

    def rel(x, ref):
        x, ref = x[valid].float(), ref[valid].float()
        return float((x - ref).norm() / ref.norm())

    one = {}
    if dist.get_rank() == 0:
        eng = InferenceEngine(full, cfg, max_batch=b, max_len=max_len,
                              device=dev)
        one = {"streams": eng.generate(prompts, gen_cfg),
               "logits": prefill(eng, tokens), "stream": stream(eng)}
        alone = torch.zeros_like(one["logits"])
        for i, p in enumerate(prompts):
            alone[i, :len(p)] = prefill(eng, tokens[i:i + 1, :len(p)])[0]
        one["alone_rel"] = rel(alone, one["logits"])
        del eng, alone
    dist.barrier()
    feed = one.get("stream") or [
        torch.empty((b, s, cfg.d_model), dtype=cfg.dtype, device=dev)
        for _ in range(cfg.n_layers + 1)]
    for x in feed:
        dist.broadcast(x, 0)
    mesh = _mesh({"tp": n})
    sharded = shard_params_for_inference(full, cfg, mesh)
    del full
    eng = InferenceEngine(sharded, cfg, max_batch=b, max_len=max_len,
                          mesh=mesh, device=dev)
    streams = eng.generate(prompts, gen_cfg)
    logits = prefill(eng, tokens)
    own, fed = stream(eng), stream(eng, feed)
    if dist.get_rank() != 0:
        return {}
    agree = []
    for x, y in zip(streams, one["streams"]):
        k = 0
        while k < min(len(x), len(y)) and x[k] == y[k]:
            k += 1
        agree.append(k)
    return {"streams": streams, "one_streams": one["streams"],
            "logits_rel": rel(logits, one["logits"]),
            "first_equal": all(x[:1] == y[:1] for x, y in
                               zip(streams, one["streams"])),
            "agree_before_divergence": agree,
            "stream_rel": [rel(x, y) for x, y in zip(own[1:], feed[1:])],
            "layer_rel": [rel(fed[i + 1] - feed[i], feed[i + 1] - feed[i])
                          for i in range(cfg.n_layers)],
            "alone_rel": one["alone_rel"]}


def run_cases(cases: List[Any]) -> List[Any]:
    """Run (function name in this module, args) cases in order; -> their
    results. One gang serves a whole test file this way."""
    here = globals()
    return [here[name](*args) for name, args in cases]
