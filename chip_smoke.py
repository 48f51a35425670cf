#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`ray_tpu_torch`) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

  (a) build every CUDA kernel of the port from `ray_tpu_torch/ops/csrc`
      with nvcc (one process per source, started together); print each
      kernel's ptxas registers and spills (and the sm90 kernels' dynamic
      shared memory; they must not spill), and check that the libraries
      launch the design `kernel_variant` names for every dtype and head
      size;
  (b) hold the flash forward kernel against its plain PyTorch version on
      the card, at the shapes the serving path gives it and at edge cases
      (GQA, head sizes 32 to 128, ragged lengths, cross-length causal, rows
      that see no key), and at what the sm90 tiling makes risky (lengths
      off 128, 1.5 tiles, H_kv = 1, the training shape) in bf16 and fp32;
  (c) time it at the Llama-3-8B attention shape beside its plain version,
      the one PyTorch call that computes the same function (timed only as
      a yardstick; the port never calls it) and the card's bound;
  (f) hold the two backward kernels (dQ, dK/dV) against their plain
      version in fp32 and bf16, at the shapes of tests/test_torch_cuda.py,
      at the training path's and on q and dO read through transposed
      views, with dq exactly 0 on rows that see no key; and one autograd
      round trip of `flash_attention` against the plain backward;
  (g) time them at the training shape (B=4, S=2048, H=32/8, D=128, bf16,
      causal) beside the plain backward, the backward of
      `scaled_dot_product_attention` (yardstick only) and the bound; and
      the forward at that shape beside the library's forward;
  (d) the serving path: Llama-3-8B at full width and depth in bf16, random
      weights from a seed, `forward` on prompts of 300 to 2048 tokens
      through the flash kernel (n_layers launches a call), its last-position
      logits held against `forward_with_cache` prefill;
  (e) `InferenceEngine(max_batch=4, max_len=2048)` answers 8 greedy
      requests (more than slots); a second run gives the same tokens;
  (h) the training path, on the JAX package's train-bench configuration
      (bench.py: Llama-3-8B layer widths, 5 layers, vocab 32000, chunked CE
      of 1024, remat "dots", bf16, B=4, S=2048): `make_train_step` with
      AdamW takes a warm-up step and 10 timed steps on one batch; each step
      launches flash_fwd 2L times (remat reruns it), dQ and dK/dV L times.
      Then 3 steps of the tiny fp32 config on cuda and on cpu from the same
      weights agree.

The launch counts are set to 0 just before each main path (serving: (d)
and (e); training: (h)) and read just after it. The last three lines of
stdout are the card's `nvidia-smi` name and power limit, one JSON object on
the kernels, and `{"ok": true, "device": ...}`. Without CUDA, or without
the repository beside it, it exits non-zero and prints no result.
"""

from __future__ import annotations

import functools
import gc
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

# Where the phases run. The card; a rehearsal may point it elsewhere.
DEVICE = "cuda"

# What the card could do at best, (dense bf16 FLOP/s, bytes/s): set in
# main() from the card's name (ray_tpu_torch/_private/accelerators/nvidia.py).
PEAKS = None

# Tolerances of kernel against plain version, |a - b| <= atol + rtol * |b|.
# fp32: FMA in another order and __expf, errors ~1e-6 on values ~1.
# bf16: the kernel rounds P to bf16 before P.V and both round O to bf16, so
# one bf16 ulp of O (2^-8 relative) plus P's rounding.
TOL = {"fp32": {"o": (1e-4, 1e-4), "lse": (1e-4, 1e-5)},
       "bf16": {"o": (1e-2, 1e-2), "lse": (1e-3, 1e-5)}}

# Backward kernels against the plain backward, for each of dq, dk, dv:
# |err| <= atol * max|plain| + rtol * |plain|. fp32: summation order and
# __expf only. bf16: P and dS round to bf16 before their products (2^-9
# relative each, summed over up to S terms of either sign) and the result
# once (one bf16 ulp), so the absolute part scales with the gradient's size.
BWD_TOL = {"fp32": (1e-4, 1e-4), "bf16": (1e-2, 1e-2)}

# The shapes of tests/test_torch_cuda.py: (b, s_q, s_k, h, h_kv, d, causal).
BWD_SHAPES = [
    (1, 64, 64, 2, 2, 32, True),
    (2, 130, 130, 4, 2, 64, True),
    (1, 513, 513, 8, 2, 128, False),
    (1, 17, 300, 4, 4, 128, True),     # s_q < s_k
    (1, 200, 50, 4, 1, 64, True),      # s_q > s_k: 150 rows see no key
    (3, 1, 129, 8, 8, 32, True),       # one query row
    # What the sm90 tilings (dK/dV: 128 keys over two warpgroups, 64-row Q
    # tiles; dQ: 128 query rows over two warpgroups, 64-key K/V tiles; both
    # 64-column TMA boxes) make risky:
    (1, 1000, 1000, 8, 2, 128, True),  # S not a multiple of 128
    (1, 2047, 2047, 4, 1, 128, True),  # H_kv = 1, S = 2047
    (2, 192, 192, 4, 2, 64, True),     # 1.5 tiles of 128
    (1, 100, 700, 8, 2, 128, True),    # s_q < s_k under causal
    # s_q > s_k: 570 rows see no key, and the dQ blocks of rows 128 .. 511
    # see none at all (they load nothing and store zeros)
    (1, 700, 130, 8, 2, 128, True),
    (2, 1, 129, 8, 8, 128, True),      # one query row in a dQ block of 128
]
# Read through [B,S,H,D] strides of [B,H,S,D] storage (q and dO): the
# backward kernels' tensor maps and loads take the caller's strides.
BWD_VIEW = (2, 320, 320, 4, 2, 128, True)
# The training path's attention: Llama-3-8B heads at B=4, S=2048.
TRAIN_ATTN = (4, 2048, 2048, 32, 8, 128, True)
# The serving path's: Llama-3-8B heads on one prompt of 2048 tokens, and
# the prompt lengths that `forward` is driven at.
SERVE_ATTN = (1, 2048, 2048, 32, 8, 128, True)
MAIN_LENGTHS = (300, 1000, 2048)
# One autograd round trip of `flash_attention` at the 8B heads.
ROUND_TRIP = (2, 300, 300, 32, 8, 128, True)

# Tiny fp32 train steps, cuda (kernels) against cpu (plain versions) from
# the same weights: fp32 on both, summation order, __expf and the kernels'
# tiles. Loss and grad norm: relative 1e-4 (the port agrees with the JAX
# step to ~1e-6 on the CPU). Parameters: an element whose gradient is at
# rounding level takes an AdamW step of up to one learning rate in a
# direction set by that rounding, so they agree to the learning rate.
TINY_LR = 1e-3
TINY_REL_TOL = 1e-4

# The first training step's loss (chunked CE) against the loss from the full
# `forward` logits on the same parameters: bf16 logits from products tiled
# differently, averaged over B*S tokens. Relative.
CHUNKED_LOSS_REL_TOL = 1e-3

# forward (flash kernel) against forward_with_cache prefill (plain cache
# attention) at 8B in bf16: both round activations to bf16 at every layer,
# on different attention arithmetic, for 32 layers. Relative L2 distance of
# the last-position logits; a wrong mask or head mapping gives ~1.
FORWARD_REL_TOL = 5e-2


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds of fn() on the card, by CUDA events."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def attention_inputs(b, s_q, s_k, h, h_kv, d, dtype, seed, device):
    g = torch.Generator(device=device).manual_seed(seed)
    q = torch.randn((b, s_q, h, d), generator=g, device=device).to(dtype)
    k = torch.randn((b, s_k, h_kv, d), generator=g, device=device).to(dtype)
    v = torch.randn((b, s_k, h_kv, d), generator=g, device=device).to(dtype)
    return q, k, v


def bound(nbytes, flops):
    """Least time on this card for `nbytes` moved and `flops` of bf16 work:
    (ms, "bytes" or "operations")."""
    t_ops, t_bytes = flops / PEAKS[0], nbytes / PEAKS[1]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes > t_ops
                                       else "operations")


def visible_pairs(s_q, s_k, causal):
    """(query, key) pairs that attention computes on."""
    if not causal:
        return s_q * s_k
    off = s_k - s_q
    return sum(max(0, min(s_k, i + off + 1)) for i in range(s_q))


def flash_bound(b, s_q, s_k, h, h_kv, d, causal):
    """Least time for the forward's work in bf16, and what bounds it.
    Bytes: q, k, v read once, o and lse written once. Operations: 4*d per
    (query, key) pair that this causal structure lets a query see."""
    nbytes = 2 * (2 * b * s_q * h * d + 2 * b * s_k * h_kv * d) \
        + 4 * b * h * s_q
    flops = 4.0 * d * visible_pairs(s_q, s_k, causal) * b * h
    return (*bound(nbytes, flops), flops)


def bwd_bounds(b, s_q, s_k, h, h_kv, d, causal):
    """{kernel: (ms, bound_by, flops)} for the backward kernels in bf16.
    dq reads q, k, v, dO, lse, delta and writes dq: 3 products (S, dP,
    dS.K) of 2*d flops per visible pair. dkv reads the same and writes dk,
    dv: 4 products (S, dP, P^T.dO, dS^T.Q)."""
    pairs = visible_pairs(s_q, s_k, causal) * b * h
    q_like, kv_like, rows = 2 * b * s_q * h * d, 2 * b * s_k * h_kv * d, \
        8 * b * h * s_q
    out = {}
    for name, n_prod, nbytes in (
            ("flash_bwd_dq", 3, 3 * q_like + 2 * kv_like + rows),
            ("flash_bwd_dkv", 4, 2 * q_like + 4 * kv_like + rows)):
        flops = n_prod * 2.0 * d * pairs
        out[name] = (*bound(nbytes, flops), flops)
    return out


# -- (a) ---------------------------------------------------------------------

# A kernel's mangled name: its length, then e.g. flash_fwd_kernelIfLi128E.
PTXAS_KERNEL = re.compile(r"(?<=\d)(flash_[a-z0-9_]+?kernel)I(\w+?)E")


def ptxas_report(log):
    """nvcc's -Xptxas -v log -> [(kernel, dtype, head size, registers,
    spill store bytes, spill load bytes)] for each compiled kernel."""
    out, cur = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            m = PTXAS_KERNEL.search(line)
            if m:
                args = m.group(2)
                dtype = "fp32" if args.startswith("f") else "bf16"
                d = int(re.search(r"Li(\d+)", args + "E").group(1))
                cur = [m.group(1), dtype, d, None, None, None]
                out.append(cur)
        elif cur is not None and "spill stores" in line:
            nums = [int(x) for x in re.findall(r"(\d+) bytes spill", line)]
            cur[4], cur[5] = nums[0], nums[1]
        elif cur is not None and "Used" in line and "registers" in line:
            cur[3] = int(re.search(r"Used (\d+) registers", line).group(1))
    return [tuple(r) for r in out]


def phase_build():
    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.ops import flash_attention as fa

    t0 = time.perf_counter()
    built = _build.build(*sorted(set(fa.KERNELS.values())))
    log(f"[a] built {sorted(built)} in {time.perf_counter() - t0:.2f} s")
    for b in built.values():
        log(f"[a] {b.name}: {b.path.name}, nvcc {b.seconds:.2f} s")
        for kern, dtype, d, regs, st, ld in ptxas_report(b.log):
            sm90 = kern.endswith("_sm90_kernel")
            smem = (fa.sm90_smem_bytes(kern.replace("_sm90_kernel", ""),
                                       torch.bfloat16, d) if sm90 else None)
            log(f"[a]   {kern} {dtype} D={d}: {regs} registers, spill "
                f"stores {st} B, loads {ld} B"
                + (f", dynamic shared memory {smem} B" if sm90 else ""))
            if sm90:
                check(st == 0 and ld == 0, f"{kern} D={d} spills")
    for kernel in fa.KERNELS:
        for dtype in fa.KERNEL_DTYPES:
            for d in fa.KERNEL_HEAD_DIMS:
                want = fa.kernel_variant(kernel, dtype, d)
                got = fa.built_variant(kernel, dtype, d)
                check(got == want, f"{kernel} {dtype} D={d} launches {got}, "
                      f"not {want}")
    log("[a] designs (bf16 D=128): " + ", ".join(
        f"{k} {fa.built_variant(k, torch.bfloat16, 128)}"
        for k in fa.KERNELS))


# -- (b) ---------------------------------------------------------------------

def flash_cases(main_lengths):
    bf16, fp32 = torch.bfloat16, torch.float32
    # (b, s_q, s_k, h, h_kv, d, dtype, causal, q as a transposed view)
    cases = [(1, s, s, 32, 8, 128, bf16, True, False) for s in main_lengths]
    cases += [
        (2, 300, 300, 32, 8, 128, bf16, False, False),
        (2, 300, 300, 4, 4, 32, fp32, True, False),
        (1, 1000, 1000, 8, 2, 64, fp32, False, False),
        (1, 1000, 1000, 4, 2, 32, bf16, True, False),
        (2, 257, 257, 4, 4, 64, bf16, True, True),
        (1, 100, 1000, 8, 2, 128, bf16, True, False),
        (1, 100, 1000, 8, 2, 128, fp32, True, False),
        (2, 1, 700, 8, 8, 128, bf16, True, False),
        (1, 300, 100, 4, 2, 64, fp32, True, False),   # 200 rows see no key
        (1, 300, 100, 4, 2, 128, bf16, True, False),
    ]
    # What the sm90 tiling (128 query rows over two warpgroups, 128-key
    # tiles, 64-column TMA boxes) makes risky, in both dtypes.
    for dtype in (bf16, fp32):
        cases += [
            (1, 1000, 1000, 8, 2, 128, dtype, True, False),
            (1, 2047, 2047, 32, 8, 128, dtype, True, False),
            (2, 192, 192, 4, 2, 64, dtype, True, False),
            (1, 100, 700, 8, 2, 128, dtype, True, False),
            (1, 700, 130, 8, 2, 128, dtype, True, False),
            (1, 2047, 2047, 4, 1, 128, dtype, True, False),
            (2, 320, 320, 4, 2, 128, dtype, False, True),
            (4, 2048, 2048, 32, 8, 128, dtype, True, False),
        ]
    return cases


def phase_flash_check(main_lengths):
    from ray_tpu_torch.ops import flash_attention as fa

    main_err = 0.0  # largest o error at the shapes the main path gives it
    for i, (b, s_q, s_k, h, h_kv, d, dtype, causal, view) in enumerate(
            flash_cases(main_lengths)):
        name = "bf16" if dtype == torch.bfloat16 else "fp32"
        q, k, v = attention_inputs(b, s_q, s_k, h, h_kv, d, dtype, i, DEVICE)
        if view:  # [B,H,S,D] storage read through [B,S,H,D] strides
            q = q.transpose(1, 2).contiguous().transpose(1, 2)
        scale = d ** -0.5
        o, lse = fa.flash_fwd_cuda(q, k, v, causal, scale)
        torch.cuda.synchronize()
        o_ref, lse_ref = fa._reference_attention_torch(q, k, v, causal, scale)
        seen = lse_ref > -1e29  # rows that see at least one key
        o_err = (o.float() - o_ref.float()).abs()
        lse_err = (lse - lse_ref).abs()[seen]
        (oa, orl), (la, lrl) = TOL[name]["o"], TOL[name]["lse"]
        o_ok = bool((o_err <= oa + orl * o_ref.float().abs()).all())
        lse_ok = bool((lse_err <= la + lrl * lse_ref[seen].abs()).all())
        unseen = ~seen
        zero_ok = (bool((lse[unseen] <= -1e29).all())
                   and bool((o.transpose(1, 2)[unseen] == 0).all()))
        o_max = float(o_err.max())
        lse_max = float(lse_err.max()) if lse_err.numel() else 0.0
        tag = (f"b={b} s_q={s_q} s_k={s_k} h={h}/{h_kv} d={d} {name} "
               f"causal={causal}{' view' if view else ''}")
        log(f"[b] {tag}: o max_abs_err {o_max:.3e}, lse max_abs_err "
            f"{lse_max:.3e}, rows seeing no key {int(unseen.sum())}")
        check(o_ok and lse_ok and zero_ok, f"flash_fwd disagrees at {tag}")
        if (b, h, h_kv, d, dtype, causal) == (1, 32, 8, 128,
                                               torch.bfloat16, True):
            main_err = max(main_err, o_max)
    return main_err


# -- (c) ---------------------------------------------------------------------

def phase_flash_time():
    import torch.nn.functional as F
    from ray_tpu_torch.ops import flash_attention as fa

    b, s, _, h, h_kv, d, _ = SERVE_ATTN
    q, k, v = attention_inputs(b, s, s, h, h_kv, d, torch.bfloat16, 99,
                               DEVICE)
    scale = d ** -0.5
    ms = cuda_ms(lambda: fa.flash_fwd_cuda(q, k, v, True, scale))
    plain_ms = cuda_ms(
        lambda: fa._reference_attention_torch(q, k, v, True, scale), iters=5)
    # The library yardstick on the same inputs, KV heads expanded outside
    # the timed region; the port never calls it.
    qt = q.transpose(1, 2).contiguous()
    kt = k.repeat_interleave(h // h_kv, dim=2).transpose(1, 2).contiguous()
    vt = v.repeat_interleave(h // h_kv, dim=2).transpose(1, 2).contiguous()
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, scale=scale))
    bound_ms, bound_by, flops = flash_bound(b, s, s, h, h_kv, d, True)
    log(f"[c] flash_fwd at B={b} S={s} H={h}/{h_kv} D={d} bf16 causal: "
        f"{ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.4f}"
        f" ms, scaled_dot_product_attention {library_ms:.4f} ms, bound "
        f"{bound_ms:.4f} ms ({bound_by})")
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


# -- (f) ---------------------------------------------------------------------

def bwd_inputs(shape, dtype, seed, device):
    b, s_q, s_k, h, h_kv, d, _ = shape
    q, k, v = attention_inputs(b, s_q, s_k, h, h_kv, d, dtype, seed, device)
    g = torch.Generator(device=device).manual_seed(seed + 1)
    do = torch.randn((b, s_q, h, d), generator=g, device=device).to(dtype)
    return q, k, v, do


def grad_errors(got, want, name):
    """Max |err| of (dq, dk, dv) and whether each is inside BWD_TOL."""
    atol, rtol = BWD_TOL[name]
    errs, ok = [], True
    for a, b in zip(got, want):
        err = (a.float() - b.float()).abs()
        ref = b.float().abs()
        ok &= bool((err <= atol * float(ref.max()) + rtol * ref).all())
        errs.append(float(err.max()))
    return errs, ok


def phase_bwd_check():
    from ray_tpu_torch.ops import flash_attention as fa

    main_err = {"flash_bwd_dq": 0.0, "flash_bwd_dkv": 0.0}
    cases = [(shape, False) for shape in BWD_SHAPES + [TRAIN_ATTN]]
    for i, (shape, view) in enumerate(cases + [(BWD_VIEW, True)]):
        b, s_q, s_k, h, h_kv, d, causal = shape
        scale = d ** -0.5
        for dtype in (torch.float32, torch.bfloat16):
            name = "bf16" if dtype == torch.bfloat16 else "fp32"
            q, k, v, do = bwd_inputs(shape, dtype, 100 + i, DEVICE)
            if view:
                q, do = (t.transpose(1, 2).contiguous().transpose(1, 2)
                         for t in (q, do))
            o, lse = fa.flash_fwd_cuda(q, k, v, causal, scale)
            got = fa._flash_bwd(q, k, v, o, lse, do, causal, scale)
            torch.cuda.synchronize()
            want = fa._flash_bwd_reference_torch(q, k, v, o, lse, do, causal,
                                                 scale)
            errs, ok = grad_errors(got, want, name)
            unseen = lse < -1e29
            zero_ok = bool((got[0].transpose(1, 2)[unseen] == 0).all())
            tag = (f"b={b} s_q={s_q} s_k={s_k} h={h}/{h_kv} d={d} {name} "
                   f"causal={causal}{' view' if view else ''}")
            log(f"[f] {tag}: dq/dk/dv max_abs_err {errs[0]:.3e} / "
                f"{errs[1]:.3e} / {errs[2]:.3e} (largest |dq|/|dk|/|dv| "
                f"{float(want[0].float().abs().max()):.3g} / "
                f"{float(want[1].float().abs().max()):.3g} / "
                f"{float(want[2].float().abs().max()):.3g}), rows seeing no "
                f"key {int(unseen.sum())}")
            check(ok and zero_ok, f"flash backward disagrees at {tag}")
            if shape == TRAIN_ATTN and dtype == torch.bfloat16:
                main_err = {"flash_bwd_dq": errs[0],
                            "flash_bwd_dkv": max(errs[1], errs[2])}
            del q, k, v, do, o, lse, got, want
    # One autograd round trip: flash_attention(...).backward(dO) on the card
    # against the plain backward on the same tensors.
    b, s, _, h, h_kv, d, causal = ROUND_TRIP
    for dtype in (torch.float32, torch.bfloat16):
        name = "bf16" if dtype == torch.bfloat16 else "fp32"
        q, k, v, do = bwd_inputs(ROUND_TRIP, dtype, 7, DEVICE)
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        o = fa.flash_attention(*leaves, causal=causal)
        o.backward(do)
        _, lse = fa._flash_fwd(q, k, v, causal, d ** -0.5)
        want = fa._flash_bwd_reference_torch(q, k, v, o.detach(), lse, do,
                                             causal, d ** -0.5)
        errs, ok = grad_errors([t.grad for t in leaves], want, name)
        log(f"[f] autograd round trip {name} b={b} s={s} h={h}/{h_kv} d={d}: "
            f"dq/dk/dv max_abs_err {errs[0]:.3e} / {errs[1]:.3e} / "
            f"{errs[2]:.3e}")
        check(ok, f"flash_attention autograd disagrees in {name}")
    return main_err


# -- (g) ---------------------------------------------------------------------

def phase_bwd_time():
    import torch.nn.functional as F
    from ray_tpu_torch.ops import flash_attention as fa

    b, s, _, h, h_kv, d, causal = TRAIN_ATTN
    scale = d ** -0.5
    q, k, v, do = bwd_inputs(TRAIN_ATTN, torch.bfloat16, 99, DEVICE)
    o, lse = fa.flash_fwd_cuda(q, k, v, causal, scale)
    delta = (do.float() * o.float()).sum(dim=-1).transpose(1, 2).contiguous()
    ms = {
        "flash_bwd_dq": cuda_ms(lambda: fa.flash_bwd_dq_cuda(
            q, k, v, do, lse, delta, causal, scale)),
        "flash_bwd_dkv": cuda_ms(lambda: fa.flash_bwd_dkv_cuda(
            q, k, v, do, lse, delta, causal, scale)),
    }
    # The plain version computes both kernels' outputs in one function.
    plain_ms = cuda_ms(lambda: fa._flash_bwd_reference_torch(
        q, k, v, o, lse, do, causal, scale), iters=3, warmup=1)
    # The library yardstick: the backward alone of one
    # scaled_dot_product_attention call, KV heads expanded outside the timed
    # region; it computes dq, dk and dv together. The port never calls it.
    qt = q.transpose(1, 2).contiguous().requires_grad_(True)
    kt = k.repeat_interleave(h // h_kv, dim=2).transpose(1, 2).contiguous()
    vt = v.repeat_interleave(h // h_kv, dim=2).transpose(1, 2).contiguous()
    kt.requires_grad_(True)
    vt.requires_grad_(True)
    out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                         scale=scale)
    dot = do.transpose(1, 2).contiguous()
    library_ms = cuda_ms(lambda: torch.autograd.grad(
        out, (qt, kt, vt), dot, retain_graph=True))
    fwd_ms = cuda_ms(lambda: fa.flash_fwd_cuda(q, k, v, causal, scale))
    with torch.no_grad():
        fwd_library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, scale=scale))
    fwd_bound = flash_bound(b, s, s, h, h_kv, d, causal)
    log(f"[g] flash_fwd at the training shape: {fwd_ms:.4f} ms "
        f"({fwd_bound[2] / fwd_ms / 1e9:.1f} TFLOP/s), "
        f"scaled_dot_product_attention {fwd_library_ms:.4f} ms, bound "
        f"{fwd_bound[0]:.4f} ms")
    bounds = bwd_bounds(*TRAIN_ATTN)
    timing = {}
    for name in ("flash_bwd_dq", "flash_bwd_dkv"):
        bound_ms, bound_by, flops = bounds[name]
        log(f"[g] {name} at B={b} S={s} H={h}/{h_kv} D={d} bf16 causal: "
            f"{ms[name]:.4f} ms ({flops / ms[name] / 1e9:.1f} TFLOP/s), "
            f"plain backward {plain_ms:.4f} ms, scaled_dot_product_attention"
            f" backward {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
            f"({bound_by}, {flops / 1e9:.1f} GFLOP)")
        timing[name] = {"ms": ms[name], "plain_ms": plain_ms,
                        "library_ms": library_ms, "bound_ms": bound_ms,
                        "bound_by": bound_by}
    timing["flash_fwd_train_shape"] = {
        "ms": fwd_ms, "library_ms": fwd_library_ms, "bound_ms": fwd_bound[0],
        "bound_by": fwd_bound[1]}
    return timing


# -- (d) ---------------------------------------------------------------------

def phase_forward(cfg, params, lengths, seed):
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.ops import flash_attention as fa

    rng = np.random.default_rng(seed)
    for s in lengths:
        tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, s)),
                                 device=DEVICE)
        before = fa.flash_fwd_cuda.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            logits = llama.forward(params, tokens, cfg)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launched = fa.flash_fwd_cuda.launches - before
        check(launched == cfg.n_layers,
              f"forward launched flash_fwd {launched} times, not "
              f"{cfg.n_layers}")
        check(tuple(logits.shape) == (1, s, cfg.vocab_size),
              f"logits shape {tuple(logits.shape)}")
        check(bool(torch.isfinite(logits).all()), "non-finite logits")
        last = logits[0, -1].clone()
        del logits
        cache = llama.init_kv_cache(cfg, 1, s, device=DEVICE)
        with torch.no_grad():
            pre, _ = llama.forward_with_cache(
                params, tokens, cache,
                torch.zeros(1, dtype=torch.int64, device=DEVICE), cfg)
        ref = pre[0, -1]
        del pre, cache
        rel = float((last - ref).norm() / ref.norm())
        same_top = int(last.argmax()) == int(ref.argmax())
        log(f"[d] forward S={s}: {dt:.3f} s ({s / dt:.1f} tok/s), flash "
            f"launches {launched}, last-position logits vs forward_with_cache"
            f" prefill: rel L2 {rel:.3e}, same argmax {same_top}")
        check(rel <= FORWARD_REL_TOL,
              f"forward and forward_with_cache differ (rel {rel:.3e})")


# -- (e) ---------------------------------------------------------------------

def phase_engine(cfg, params, seed):
    from ray_tpu_torch.inference import GenerationConfig, InferenceEngine

    rng = np.random.default_rng(seed)
    lengths = [120, 500, 64, 900, 1500, 33, 2000, 250]
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in lengths]
    eng = InferenceEngine(params, cfg, max_batch=4, max_len=2048,
                          device=DEVICE)

    def run(max_new):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = eng.generate(prompts, GenerationConfig(max_new_tokens=max_new))
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    firsts, t_prefill = run(1)
    out1, t1 = run(32)
    out2, t2 = run(32)
    check(all(len(o) == 32 for o in out1),
          f"token counts {[len(o) for o in out1]}")
    check(out1 == out2, "a second greedy run gave other tokens")
    check([o[0] for o in out1] == [f[0] for f in firsts],
          "first tokens differ between prefill-only and full runs")
    check(sorted(eng.free_slots) == [0, 1, 2, 3], "slots not released")
    n_prompt = sum(lengths)
    n_decode = sum(len(o) for o in out1) - len(prompts)
    log(f"[e] engine: {len(prompts)} requests, 4 slots, prompts {lengths}")
    log(f"[e] prefill only (max_new_tokens=1): {t_prefill:.3f} s, "
        f"{n_prompt / t_prefill:.1f} prompt tok/s")
    log(f"[e] max_new_tokens=32: {t1:.3f} s and {t2:.3f} s; decode "
        f"{n_decode} tokens in {t1 - t_prefill:.3f} s beyond the prefill-only"
        f" run, {n_decode / (t1 - t_prefill):.1f} tok/s")


# -- (h) ---------------------------------------------------------------------

def bench_config():
    """The JAX package's train-bench configuration (bench.py:191-199):
    Llama-3-8B layer widths at 5 layers, vocab 32000, chunked CE of 1024;
    remat "dots" and bf16 are the config's defaults."""
    from ray_tpu_torch.models import llama

    return llama.LlamaConfig(
        vocab_size=32_000, d_model=4096, n_layers=5, n_heads=32,
        n_kv_heads=8, d_head=128, d_ff=14_336, max_seq_len=2048,
        loss_chunk_size=1024)


def kernel_counts():
    from ray_tpu_torch.ops import flash_attention as fa

    return {"flash_fwd": fa.flash_fwd_cuda.launches,
            "flash_bwd_dq": fa.flash_bwd_dq_cuda.launches,
            "flash_bwd_dkv": fa.flash_bwd_dkv_cuda.launches}


def reset_kernel_counts():
    from ray_tpu_torch.ops import flash_attention as fa

    for fn in (fa.flash_fwd_cuda, fa.flash_bwd_dq_cuda, fa.flash_bwd_dkv_cuda):
        fn.launches = 0


def kernel_group(name):
    """A kernel's name -> the group the step's time is split into."""
    for kernel in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        if f"{kernel}_kernel" in name or f"{kernel}_sm90_kernel" in name:
            return kernel
    if any(t in name.lower() for t in ("gemm", "nvjet", "xmma", "cutlass")):
        return "matrix products (cuBLAS)"
    return "other (elementwise, reductions, AdamW, copies)"


def profile_steps(step, state, data, n):
    """Run n steps under torch.profiler; -> (state, [(kernel name, ms a
    step, launches a step)]) from the device events."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            state, _ = step(state, data)
        torch.cuda.synchronize()
    kernels = [(e.key, e.self_device_time_total / 1e3 / n, e.count / n)
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    return state, sorted(kernels, key=lambda k: -k[1])


def phase_train(cfg, batch, seq, steps, seed):
    """The training main path; returns its kernel launch counts."""
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.train import adamw, init_train_state, make_train_step

    opt = adamw(3e-4, weight_decay=0.0)  # as bench.py:210
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    t0 = time.perf_counter()
    state = init_train_state(functools.partial(llama.init, cfg, gen), opt,
                             device=DEVICE)
    step = make_train_step(functools.partial(llama.loss_fn, config=cfg), opt)
    toks = torch.as_tensor(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (batch, seq + 1)), device=DEVICE)
    data = {"inputs": toks[:, :-1], "targets": toks[:, 1:]}
    with torch.no_grad():  # the unchunked loss of the same parameters
        logits = llama.forward(state.params, data["inputs"], cfg)
        full_loss = float(torch.nn.functional.cross_entropy(
            logits.flatten(0, 1), data["targets"].flatten()))
        del logits
    torch.cuda.synchronize()
    log(f"[h] {cfg.n_layers} layers at Llama-3-8B widths, vocab "
        f"{cfg.vocab_size}, bf16, remat {cfg.remat_policy}, loss chunk "
        f"{cfg.loss_chunk_size}: {cfg.num_params() / 1e9:.3f} B params; "
        f"init and the unchunked loss {time.perf_counter() - t0:.2f} s")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    reset_kernel_counts()
    want = {"flash_fwd": 2 * cfg.n_layers, "flash_bwd_dq": cfg.n_layers,
            "flash_bwd_dkv": cfg.n_layers}
    per_step = []
    t0 = time.perf_counter()
    state, m = step(state, data)  # warm-up
    first_loss = float(m["loss"])
    warm_s = time.perf_counter() - t0
    per_step.append(kernel_counts())
    metrics = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        before = kernel_counts()
        state, m = step(state, data)
        after = kernel_counts()
        per_step.append({k: after[k] - before[k] for k in after})
        metrics.append(m)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / steps
    counts = kernel_counts()
    losses = torch.stack([m["loss"] for m in metrics]).float().cpu()
    norms = torch.stack([m["grad_norm"] for m in metrics]).float().cpu()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    from ray_tpu_torch._private.accelerators.nvidia import (
        bf16_peak_flops_per_device)
    peak = bf16_peak_flops_per_device(torch.cuda.get_device_name(0))
    tok_s = batch * seq / step_s
    mfu = llama.flops_per_token(cfg, seq) * tok_s / peak
    log(f"[h] B={batch} S={seq}: warm-up step {warm_s:.3f} s (loss "
        f"{first_loss:.4f}; from full forward logits {full_loss:.4f}); "
        f"{steps} steps on one batch: {step_s * 1e3:.2f} ms a step, "
        f"{tok_s:.1f} tok/s, MFU {mfu:.4f} (of {peak / 1e12:.0f} TFLOP/s "
        f"bf16 dense), peak memory {peak_gib:.2f} GiB")
    log(f"[h] losses {[round(x, 4) for x in losses.tolist()]}; grad norms "
        f"{[round(x, 4) for x in norms.tolist()]}")
    log(f"[h] launches a step {per_step[1]}; in all {counts}")
    check(bool(torch.isfinite(losses).all() and torch.isfinite(norms).all()),
          "non-finite loss or grad norm")
    check(float(losses[-1]) < first_loss, "the loss did not fall")
    rel = abs(first_loss - full_loss) / abs(full_loss)
    check(rel <= CHUNKED_LOSS_REL_TOL,
          f"chunked loss {first_loss} and full loss {full_loss} differ "
          f"(rel {rel:.3e})")
    check(all(p == want for p in per_step),
          f"launches per step {per_step}, not {want}")

    # Where a step's device time goes: two more steps under torch.profiler.
    state, kernels = profile_steps(step, state, data, 2)
    busy = sum(ms for _, ms, _ in kernels)
    groups = {}
    for name, ms, _ in kernels:
        groups[kernel_group(name)] = groups.get(kernel_group(name), 0.0) + ms
    log(f"[h] torch.profiler, 2 steps: kernels {busy:.2f} ms a step of the "
        f"{step_s * 1e3:.2f} ms step (device idle share "
        f"{1 - busy / (step_s * 1e3):.3f}); by group (ms a step): "
        + ", ".join(f"{g} {ms:.2f}" for g, ms in
                    sorted(groups.items(), key=lambda x: -x[1])))
    for name, ms, n in kernels[:10]:
        log(f"[h]   {ms:8.3f} ms {n:6.1f}x  {name[:110]}")
    return kernel_counts()


def phase_train_tiny(steps=3, seed=5):
    """3 fp32 steps of LlamaConfig.tiny() on cuda (kernels) and cpu (plain
    versions) from the same weights and batches."""
    import dataclasses

    from ray_tpu_torch.models import llama
    from ray_tpu_torch.train import adamw, init_train_state, make_train_step
    from ray_tpu_torch.train.optim import tree_map

    cfg = dataclasses.replace(llama.LlamaConfig.tiny(), dtype=torch.float32)
    weights = llama.init(cfg, torch.Generator().manual_seed(seed),
                         device="cpu")
    rng = np.random.default_rng(seed)
    batches = [rng.integers(0, cfg.vocab_size, (2, 65)) for _ in range(steps)]
    runs = {}
    for dev in (DEVICE, "cpu"):
        opt = adamw(TINY_LR, weight_decay=1e-4)
        state = init_train_state(
            lambda d: tree_map(lambda w: w.to(d, copy=True), weights), opt,
            device=dev)
        step = make_train_step(functools.partial(llama.loss_fn, config=cfg),
                               opt)
        out = []
        for b in batches:
            state, m = step(state, {"tokens": torch.as_tensor(b, device=dev)})
            out.append((float(m["loss"]), float(m["grad_norm"])))
        runs[dev] = (out, state.params)
    (got, p_got), (want, p_want) = runs[DEVICE], runs["cpu"]
    rel = max(max(abs(a - b) / abs(b) for a, b in zip(x, y))
              for x, y in zip(got, want))
    from ray_tpu_torch.train.optim import tree_leaves
    p_err = max(float((a.cpu() - b).abs().max())
                for a, b in zip(tree_leaves(p_got), tree_leaves(p_want)))
    log(f"[h] tiny fp32, {steps} steps, cuda vs cpu: (loss, grad norm) "
        f"{got} vs {want}; largest relative difference {rel:.3e}, "
        f"parameters {p_err:.3e}")
    check(rel <= TINY_REL_TOL and p_err <= TINY_LR,
          "tiny train steps on cuda and cpu disagree")


def nvidia_smi_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return proc.stdout.strip().splitlines()[0]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "runs on an NVIDIA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from ray_tpu_torch import device_info
    from ray_tpu_torch._private.accelerators.nvidia import peaks
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    info = device_info()
    card = nvidia_smi_line()
    global PEAKS
    PEAKS = peaks(info["kind"])
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}"
        f"; peaks {PEAKS[0] / 1e12:.0f} TFLOP/s bf16, {PEAKS[1] / 1e12:.2f}"
        " TB/s")
    t_start = time.perf_counter()

    phase_build()
    main_lengths = MAIN_LENGTHS
    max_err = {"flash_fwd": phase_flash_check(main_lengths)}
    timing = {"flash_fwd": phase_flash_time()}
    max_err.update(phase_bwd_check())
    timing.update(phase_bwd_time())
    timing["flash_fwd"]["train_shape"] = timing.pop("flash_fwd_train_shape")
    gc.collect()
    torch.cuda.empty_cache()

    cfg = llama.LlamaConfig.llama3_8b()
    t0 = time.perf_counter()
    params = llama.init(cfg, torch.Generator(device=DEVICE).manual_seed(0),
                        device=DEVICE)
    torch.cuda.synchronize()
    n_bytes = sum(w.numel() * w.element_size() for w in (
        [params[k] for k in ("embed", "final_norm", "lm_head")]
        + list(params["layers"].values())))
    log(f"[d] llama3_8b bf16: {cfg.num_params() / 1e9:.3f} B params, "
        f"{n_bytes / 2**30:.2f} GiB, init {time.perf_counter() - t0:.2f} s")

    reset_kernel_counts()
    phase_forward(cfg, params, main_lengths, seed=1)
    phase_engine(cfg, params, seed=2)
    serve = kernel_counts()
    check(serve["flash_fwd"] > 0, "the serving path never launched flash_fwd")
    log(f"[d+e] launches on the serving path: {serve}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
        f"{time.perf_counter() - t_start:.1f} s so far")
    del params
    gc.collect()
    torch.cuda.empty_cache()

    train = phase_train(bench_config(), batch=TRAIN_ATTN[0],
                        seq=TRAIN_ATTN[1], steps=10, seed=3)
    phase_train_tiny()
    log(f"[h] launches on the training path: {train}; "
        f"{time.perf_counter() - t_start:.1f} s in all")

    sources = {"flash_fwd": ("ray_tpu_torch/ops/csrc/flash_fwd.cu", 45),
               "flash_bwd_dq": ("ray_tpu_torch/ops/csrc/flash_bwd.cu", 151),
               "flash_bwd_dkv": ("ray_tpu_torch/ops/csrc/flash_bwd.cu", 201)}
    kernels = []
    for name, (source, line) in sources.items():
        launches = serve[name] + train[name]
        check(launches > 0, f"no main path launched {name}")
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": f"ray_tpu/ops/flash_attention.py:{line}",
            "launches": launches,
            "design": fa.built_variant(name, torch.bfloat16, 128),
            "launches_by_path": {"serve": serve[name], "train": train[name]},
            "max_abs_err": max_err[name], **timing[name]})
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": info["platform"], "kind": info["kind"],
        "count": info["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
