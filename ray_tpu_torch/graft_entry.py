"""Compile-check entry of the port: the counterpart of
`__graft_entry__.entry()`.

`entry(device)` returns the forward step of the flagship model (Llama-3-8B
head shapes at d_model 1024, 4 layers; `__graft_entry__._flagship_config`)
with example arguments sized for one card: tokens [1, 512]. The step
compiles under `torch.compile(fn, fullgraph=True)`; the flash forward is a
custom operator inside its graph. Weights come from a seeded
`torch.Generator` (torch cannot reproduce `jax.random`; the tests carry the
JAX `init(PRNGKey(0))` across with `models/convert.py`).

`dryrun_multichip(n, device)` is the counterpart of
`__graft_entry__.dryrun_multichip`: on a gang of n ranks (one per GPU over
NCCL; or, when the caller asks for "cpu", n gloo ranks, which every line it
prints says) it runs the JAX dry run's checks in order on tiny fp32 shapes:
one sharded Llama training step on the (dp, fsdp, sp, tp) plan of n (the
ring over sp when sp > 1, its loss against the same step without the ring),
the pipeline at pp=2 and the expert-parallel MoE at ep=2 (each against its
one-rank arithmetic), the step on a dcn=2 multi-slice mesh, and tp=2 paged
decode (its streams against the unsharded engine's). No choice of device
is made inside: too few cards raise.
"""

from __future__ import annotations

import torch

from ray_tpu_torch._private.device import resolve_device


def flagship_config():
    """Llama-3-8B head shapes (d_head 128, GQA) at reduced width and depth,
    as the JAX entry's."""
    from ray_tpu_torch.models.llama import LlamaConfig

    return LlamaConfig(
        vocab_size=32_000, d_model=1024, n_layers=4, n_heads=8,
        n_kv_heads=4, d_head=128, d_ff=3584, max_seq_len=2048,
    )


def entry(device=None):
    """-> (fn, example_args): the flagship forward step, (params, tokens)
    -> logits [1, 512, vocab] fp32, and its arguments on `device` (cuda by
    default; raises without it unless given "cpu")."""
    from ray_tpu_torch.models import llama

    dev = resolve_device(device)
    config = flagship_config()
    params = llama.init(config, torch.Generator(device=dev).manual_seed(0),
                        device=dev)
    tokens = torch.zeros((1, 512), dtype=torch.int64, device=dev)

    def forward_step(params, tokens):
        return llama.forward(params, tokens, config)

    return forward_step, (params, tokens)


def _axis_plan(n: int):
    """Split n devices over (dp, fsdp, sp, tp), largest axes first (the JAX
    dry run's plan)."""
    factors = []
    m = n
    for p in (2, 3, 5, 7):
        while m % p == 0:
            factors.append(p)
            m //= p
    if m > 1:
        factors.append(m)
    axes = {"dp": 1, "fsdp": 1, "sp": 1, "tp": 1}
    order = ["tp", "sp", "fsdp", "dp"]
    for i, f in enumerate(factors):
        axes[order[i % len(order)]] *= f
    return axes


# The ring's loss against the same step without it (fp32, tiny).
RING_REL_TOL = 1e-5
# The compiled sharded step against the eager one from the same state
# (fp32, tiny; the compiled step is not bit-repeatable).
COMPILED_REL_TOL = 1e-4
# The split pipeline and MoE against their one-rank arithmetic (fp32).
SPLIT_ATOL = 1e-5


def _compile_backend() -> str:
    """inductor on the card; aot_eager on CPU ranks (no Triton there)."""
    from ray_tpu_torch.train.backend import rank_device

    return "inductor" if rank_device().type == "cuda" else "aot_eager"


def _tiny_step(mesh, cfg, tokens, seed, compiled=False):
    """One sharded AdamW step (eager, or compiled as one program over the
    DTensor parameters) of the tiny config on `mesh`; -> (loss, grad norm,
    the loss of the state the step started from with the ring turned
    off)."""
    import dataclasses
    import functools

    from ray_tpu_torch.models import llama
    from ray_tpu_torch.parallel.sharding import LogicalAxisRules
    from ray_tpu_torch.train import adamw, init_train_state, make_train_step
    from ray_tpu_torch.train.backend import rank_device
    from ray_tpu_torch.train.spmd import batch_sharding, shard_local_batch

    dev = rank_device()
    rules = LogicalAxisRules()
    opt = adamw(1e-3)
    state = init_train_state(
        functools.partial(llama.init, cfg, torch.Generator(
            device=dev).manual_seed(seed)), opt, device=dev,
        param_logical_axes=llama.param_logical_axes(cfg), mesh=mesh,
        rules=rules)
    batch = shard_local_batch({"inputs": tokens[:, :-1],
                               "targets": tokens[:, 1:]},
                              batch_sharding(mesh, rules), mesh, dev)
    with torch.no_grad():
        plain = dataclasses.replace(cfg, use_ring_attention=False)
        no_ring = float(llama.loss_fn(state.params, batch, plain, mesh=mesh,
                                      rules=rules))
    step = make_train_step(functools.partial(
        llama.loss_fn, config=cfg, mesh=mesh, rules=rules), opt,
        compiled=compiled, backend=_compile_backend())
    state, m = step(state, batch)
    return float(m["loss"]), float(m["grad_norm"]), no_ring


def _mixtral_ep_step(mesh, seed):
    """One sharded eager AdamW step of the tiny fp32 Mixtral on `mesh` (its
    MoE through moe_shard_map over ep); -> (loss, grad norm)."""
    import dataclasses
    import functools

    import numpy as np

    from ray_tpu_torch.models import mixtral
    from ray_tpu_torch.train import adamw, init_train_state, make_train_step
    from ray_tpu_torch.train.backend import rank_device
    from ray_tpu_torch.train.spmd import batch_sharding, shard_local_batch

    dev = rank_device()
    cfg = dataclasses.replace(mixtral.MixtralConfig.tiny(),
                              dtype=torch.float32)
    opt = adamw(1e-3)
    state = init_train_state(
        functools.partial(mixtral.init, cfg, torch.Generator(
            device=dev).manual_seed(seed)), opt, device=dev,
        param_logical_axes=mixtral.param_logical_axes(cfg), mesh=mesh)
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, (4, 65))
    batch = shard_local_batch({"inputs": toks[:, :-1],
                               "targets": toks[:, 1:]},
                              batch_sharding(mesh), mesh, dev)
    step = make_train_step(functools.partial(mixtral.loss_fn, config=cfg,
                                             mesh=mesh), opt, compiled=False)
    state, m = step(state, batch)
    return float(m["loss"]), float(m["grad_norm"])


def _dryrun_body(n_devices: int, tag: str):
    """One rank of the dry run; -> the lines it reports."""
    import dataclasses

    import numpy as np
    import torch.distributed as dist

    from ray_tpu_torch.models import llama
    from ray_tpu_torch.parallel.mesh import (MeshConfig, build_mesh,
                                             build_multislice_mesh,
                                             mesh_sizes)
    from ray_tpu_torch.train.backend import rank_device

    lines = []

    def say(msg):
        lines.append(f"[dryrun {tag}] {msg}")

    def check(cond, msg):
        if not cond:
            raise RuntimeError(f"dry run check failed: {msg}")

    dev = rank_device()
    plan = _axis_plan(n_devices)
    mesh = build_mesh(MeshConfig(**plan))
    say(f"mesh axes: {mesh_sizes(mesh)}")
    cfg = dataclasses.replace(llama.LlamaConfig.tiny(), dtype=torch.float32,
                              use_ring_attention=plan["sp"] > 1)
    rng = np.random.default_rng(1)
    b = max(2, plan["dp"] * plan["fsdp"])
    s = 64 * max(1, plan["sp"])
    toks = rng.integers(0, cfg.vocab_size, (b, s + 1))
    loss, norm, no_ring = _tiny_step(mesh, cfg, toks, seed=0)
    check(loss == loss and loss > 0, f"loss {loss} must be finite, positive")
    say(f"llama train step OK on {n_devices} ranks (dp={plan['dp']} "
        f"fsdp={plan['fsdp']} sp={plan['sp']} tp={plan['tp']}): "
        f"loss={loss:.6f} grad_norm={norm:.6f}")
    if cfg.use_ring_attention:
        rel = abs(loss - no_ring) / abs(no_ring)
        check(rel <= RING_REL_TOL, f"ring loss {loss} vs {no_ring}: {rel}")
        say(f"ring over sp={plan['sp']} against the gathered-sequence flash "
            f"attention: loss {loss:.6f} vs {no_ring:.6f} (rel {rel:.2e})")
    c_loss, c_norm, _ = _tiny_step(mesh, cfg, toks, seed=0, compiled=True)
    rel = max(abs(c_loss - loss) / abs(loss), abs(c_norm - norm) / abs(norm))
    check(rel <= COMPILED_REL_TOL, f"compiled step (loss {c_loss}, grad norm "
          f"{c_norm}) vs eager ({loss}, {norm}): {rel}")
    say(f"compiled sharded step ({_compile_backend()}) OK: loss="
        f"{c_loss:.6f} grad_norm={c_norm:.6f}, rel {rel:.2e} against the "
        "eager step")

    if n_devices % 2 == 0:
        from torch.distributed.tensor import DTensor

        from ray_tpu_torch.parallel.moe import moe_layer, moe_shard_map
        from ray_tpu_torch.parallel.pipeline import pipeline_sharded
        from ray_tpu_torch.parallel.sharding import distribute_full

        pp = 2
        mesh2 = build_mesh(MeshConfig(dp=n_devices // pp, pp=pp))
        d = 16
        gen = np.random.default_rng(2)
        ws = torch.as_tensor(gen.normal(size=(pp, d, d)) * 0.3,
                             dtype=torch.float32, device=dev)
        xs = torch.as_tensor(gen.normal(size=(4, 4, d)), dtype=torch.float32,
                             device=dev)
        names = mesh2.mesh_dim_names
        rep = [torch.distributed.tensor.Replicate()] * len(names)
        staged = [torch.distributed.tensor.Shard(0) if a == "pp" else r
                  for a, r in zip(names, rep)]
        piped = pipeline_sharded(lambda w, x: torch.tanh(x @ w[0]), mesh2)(
            distribute_full(ws, mesh2, staged),
            DTensor.from_local(xs, mesh2, rep, run_check=False))
        want = torch.tanh(torch.tanh(xs @ ws[0]) @ ws[1])
        err = float((piped.to_local() - want).abs().max())
        check(tuple(piped.shape) == tuple(xs.shape) and err <= SPLIT_ATOL,
              f"pipeline: shape {tuple(piped.shape)}, err {err}")
        say(f"pipeline (pp={pp}) OK: max |err| {err:.2e} against the stages "
            "in sequence")

        ep = 2
        mesh3 = build_mesh(MeshConfig(dp=n_devices // ep, ep=ep))
        gate_w = torch.as_tensor(gen.normal(size=(d, 4)), dtype=torch.float32,
                                 device=dev)
        ew = torch.as_tensor(gen.normal(size=(4, d, d)) * 0.3,
                             dtype=torch.float32, device=dev)
        x = torch.as_tensor(gen.normal(size=(32, d)), dtype=torch.float32,
                            device=dev)
        names = mesh3.mesh_dim_names
        split = [torch.distributed.tensor.Shard(0) if a == "ep" else r
                 for a, r in zip(names, rep)]
        expert_fn = lambda w, t: torch.bmm(t, w)  # noqa: E731
        out, _aux = moe_shard_map(
            distribute_full(x, mesh3, split), DTensor.from_local(
                gate_w, mesh3, rep, run_check=False),
            expert_fn, distribute_full(ew, mesh3, split), mesh3, k=1,
            capacity_factor=4.0)
        idx = mesh3.get_local_rank("ep")
        mine = x[idx * 16:(idx + 1) * 16]
        want, _ = moe_layer(mine, gate_w, expert_fn, ew, k=1,
                            capacity_factor=4.0)
        err = float((out.to_local() - want).abs().max())
        check(tuple(out.shape) == tuple(x.shape) and err <= SPLIT_ATOL,
              f"MoE: shape {tuple(out.shape)}, err {err}")
        say(f"MoE dispatch (ep={ep}) OK: max |err| {err:.2e} against the "
            "one-rank layer on this rank's tokens")
        mx_loss, mx_norm = _mixtral_ep_step(mesh3, seed=4)
        check(np.isfinite([mx_loss, mx_norm]).all() and mx_loss > 0,
              f"Mixtral ep step: loss {mx_loss}, grad norm {mx_norm}")
        say(f"Mixtral step (dp={n_devices // ep} x ep={ep}) OK: "
            f"loss={mx_loss:.6f} grad_norm={mx_norm:.6f}")

        per_slice = n_devices // 2
        ms_plan = _axis_plan(per_slice)
        ms_mesh = build_multislice_mesh(MeshConfig(**ms_plan), num_slices=2)
        ms_cfg = dataclasses.replace(llama.LlamaConfig.tiny(),
                                     dtype=torch.float32,
                                     use_ring_attention=ms_plan["sp"] > 1)
        mb = max(2, 2 * ms_plan["dp"] * ms_plan["fsdp"])
        mtoks = rng.integers(0, ms_cfg.vocab_size,
                             (mb, 64 * max(1, ms_plan["sp"]) + 1))
        ms_loss, _, _ = _tiny_step(ms_mesh, ms_cfg, mtoks, seed=7)
        check(ms_loss > 0 and ms_loss == ms_loss, f"loss {ms_loss}")
        say(f"multi-slice mesh (dcn=2 x {ms_plan}) OK: loss={ms_loss:.6f}")

        from ray_tpu_torch.inference import GenerationConfig
        from ray_tpu_torch.inference.engine import shard_params_for_inference
        from ray_tpu_torch.inference.paged_engine import PagedInferenceEngine

        tp_mesh = build_mesh(MeshConfig(tp=2, dp=n_devices // 2))
        dec_cfg = dataclasses.replace(llama.LlamaConfig.tiny(),
                                      dtype=torch.float32)
        full = llama.init(dec_cfg, torch.Generator(device=dev).manual_seed(9),
                          device=dev)
        prompts, gen_cfg = [[1, 2, 3], [4, 5]], GenerationConfig(
            max_new_tokens=6)
        eng = PagedInferenceEngine(
            shard_params_for_inference(full, dec_cfg, tp_mesh), dec_cfg,
            max_batch=2, max_len=64, block_size=8, mesh=tp_mesh,
            decode_chunk=4, device=dev)
        toks_tp = eng.generate(prompts, gen_cfg)
        ref = PagedInferenceEngine(full, dec_cfg, max_batch=2, max_len=64,
                                   block_size=8, decode_chunk=4, device=dev)
        toks_one = ref.generate(prompts, gen_cfg)
        check(len(toks_tp) == 2 and all(len(t) == 6 for t in toks_tp),
              f"tp decode gave {toks_tp}")
        check(toks_tp == toks_one, f"tp=2 streams {toks_tp} vs {toks_one}")
        say(f"tp=2 paged decode OK: streams {toks_tp}, the unsharded "
            "engine's")
    dist.barrier()
    say("all multichip checks passed")
    return lines


def dryrun_multichip(n_devices: int, device=None,
                     timeout_s: float = 1200.0):
    """The multi-GPU dry run on a gang of n_devices ranks: device None or
    "cuda" needs n_devices cards (raises with fewer); "cpu" runs gloo
    ranks. Prints rank 0's lines and returns them."""
    from ray_tpu_torch.train.backend import launch_gang

    dev_type = "cuda" if device is None else torch.device(device).type
    tag = ("nccl" if dev_type == "cuda"
           else f"cpu-ranks: {n_devices} gloo CPU ranks, no GPU")
    lines = launch_gang(_dryrun_body, n_devices, dev_type, timeout_s,
                        args=(n_devices, tag))[0]
    for line in lines:
        print(line, flush=True)
    return lines
