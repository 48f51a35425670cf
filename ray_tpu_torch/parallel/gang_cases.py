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
                slices=1) -> Dict[str, Any]:
    """AdamW steps of the sharded eager step from numpy weights, one per
    global batch; -> [(loss, grad norm)] and the whole final parameters."""
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.models.convert import params_from_jax_numpy
    from ray_tpu_torch.train import adamw, init_train_state, make_train_step
    from ray_tpu_torch.train.spmd import batch_sharding, shard_local_batch

    cfg = _llama(cfg_kw)
    mesh = _mesh(mesh_kw, slices)
    opt = adamw(lr, weight_decay=weight_decay)
    state = init_train_state(
        lambda dev: params_from_jax_numpy(params_np, cfg, dev), opt,
        device="cpu", param_logical_axes=llama.param_logical_axes(cfg),
        mesh=mesh)
    step = make_train_step(functools.partial(llama.loss_fn, config=cfg,
                                             mesh=mesh), opt, compiled=False)
    metrics = []
    for b in batches_np:
        batch = shard_local_batch(b, batch_sharding(mesh), mesh,
                                  torch.device("cpu"))
        state, m = step(state, batch)
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    from ray_tpu_torch.train.optim import tree_leaves

    return {"metrics": metrics, "params": _tree_np(state.params),
            "moment_placements_match": all(
                p.placements == mu.placements == nu.placements
                for p, mu, nu in zip(tree_leaves(state.params),
                                     tree_leaves(state.opt_state.mu),
                                     tree_leaves(state.opt_state.nu)))}


# -- pipeline, experts, tp serving ---------------------------------------------

def pipeline_case(ws, xs, mesh_kw) -> np.ndarray:
    """`pipeline_sharded` of tanh(x @ w[0]) stages over the mesh's pp dim:
    ws [pp, d, d], xs [M, mb, d] -> the whole output."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from ray_tpu_torch.parallel.pipeline import pipeline_sharded
    from ray_tpu_torch.parallel.sharding import distribute_full

    mesh = _mesh(mesh_kw)
    names = mesh.mesh_dim_names
    rep = [Replicate()] * len(names)
    staged = [Shard(0) if n == "pp" else Replicate() for n in names]
    out = pipeline_sharded(lambda w, x: torch.tanh(x @ w[0]), mesh)(
        distribute_full(torch.from_numpy(ws), mesh, staged),
        DTensor.from_local(torch.from_numpy(xs), mesh, rep, run_check=False))
    return _full(out)


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


def run_cases(cases: List[Any]) -> List[Any]:
    """Run (function name in this module, args) cases in order; -> their
    results. One gang serves a whole test file this way."""
    here = globals()
    return [here[name](*args) for name, args in cases]
