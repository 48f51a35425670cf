#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`ray_tpu_torch`) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

  (a) build every CUDA kernel of the serving path from `ray_tpu_torch/ops/
      csrc` with nvcc (one process per source, started together);
  (b) hold each kernel against its plain PyTorch version on the card, at the
      shapes the main path gives it and at edge cases (GQA, head sizes 32
      to 128, ragged lengths, cross-length causal, rows that see no key);
  (c) time each kernel at the Llama-3-8B attention shape beside its plain
      version, the one PyTorch call that computes the same function (timed
      only as a yardstick; the port never calls it) and the card's bound;
  (d) the main path: Llama-3-8B at full width and depth in bf16, random
      weights from a seed, `forward` on prompts of 300 to 2048 tokens
      through the flash kernel (n_layers launches a call), its last-position
      logits held against `forward_with_cache` prefill;
  (e) `InferenceEngine(max_batch=4, max_len=2048)` answers 8 greedy
      requests (more than slots); a second run gives the same tokens.

The launch counts are set to 0 just before (d) and read just after (e). The
last three lines of stdout are the card's `nvidia-smi` name and power limit,
one JSON object on the kernels, and `{"ok": true, "device": ...}`.
Without CUDA, or without the repository beside it, it exits non-zero and
prints no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

# Where the phases run. The card; a rehearsal may point it elsewhere.
DEVICE = "cuda"

# H100 SXM, dense (NVIDIA data sheet): what the card could do at best.
PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12}
PEAK_BYTES_PER_S = 3.35e12

# Tolerances of kernel against plain version, |a - b| <= atol + rtol * |b|.
# fp32: FMA in another order and __expf, errors ~1e-6 on values ~1.
# bf16: the kernel rounds P to bf16 before P.V and both round O to bf16, so
# one bf16 ulp of O (2^-8 relative) plus P's rounding.
TOL = {"fp32": {"o": (1e-4, 1e-4), "lse": (1e-4, 1e-5)},
       "bf16": {"o": (1e-2, 1e-2), "lse": (1e-3, 1e-5)}}

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


def flash_bound(b, s_q, s_k, h, h_kv, d, causal, dtype_name):
    """Least time for the forward's work on this card, and what bounds it.
    Bytes: q, k, v read once, o and lse written once. Operations: 4*d per
    (query, key) pair that this causal structure lets a query see."""
    elem = 2 if dtype_name == "bf16" else 4
    nbytes = elem * (2 * b * s_q * h * d + 2 * b * s_k * h_kv * d) \
        + 4 * b * h * s_q
    if causal:
        off = s_k - s_q
        pairs = sum(max(0, min(s_k, i + off + 1)) for i in range(s_q))
    else:
        pairs = s_q * s_k
    flops = 4.0 * d * pairs * b * h
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype_name]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes > t_ops
                                       else "operations"), flops


# -- (a) ---------------------------------------------------------------------

def phase_build():
    from ray_tpu_torch.ops import _build

    t0 = time.perf_counter()
    built = _build.build("flash_fwd")
    log(f"[a] built {sorted(built)} in {time.perf_counter() - t0:.2f} s")
    for b in built.values():
        log(f"[a] {b.name}: {b.path.name}, nvcc {b.seconds:.2f} s")
        for line in b.log.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                log(f"[a]   {line.strip()}")


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

    b, s, h, h_kv, d = 1, 2048, 32, 8, 128
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
    bound_ms, bound_by, flops = flash_bound(b, s, s, h, h_kv, d, True, "bf16")
    log(f"[c] flash_fwd at B={b} S={s} H={h}/{h_kv} D={d} bf16 causal: "
        f"{ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.4f}"
        f" ms, scaled_dot_product_attention {library_ms:.4f} ms, bound "
        f"{bound_ms:.4f} ms ({bound_by})")
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


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
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    info = device_info()
    card = nvidia_smi_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t_start = time.perf_counter()

    phase_build()
    main_lengths = (300, 1000, 2048)
    max_err = phase_flash_check(main_lengths)
    timing = phase_flash_time()

    cfg = llama.LlamaConfig.llama3_8b()
    t0 = time.perf_counter()
    params = llama.init(cfg, torch.Generator(device="cuda").manual_seed(0),
                        device="cuda")
    torch.cuda.synchronize()
    n_bytes = sum(w.numel() * w.element_size() for w in (
        [params[k] for k in ("embed", "final_norm", "lm_head")]
        + list(params["layers"].values())))
    log(f"[d] llama3_8b bf16: {cfg.num_params() / 1e9:.3f} B params, "
        f"{n_bytes / 2**30:.2f} GiB, init {time.perf_counter() - t0:.2f} s")

    fa.flash_fwd_cuda.launches = 0
    phase_forward(cfg, params, main_lengths, seed=1)
    phase_engine(cfg, params, seed=2)
    launches = fa.flash_fwd_cuda.launches
    check(launches > 0, "the main path never launched flash_fwd")
    log(f"[d+e] flash_fwd launches on the main path: {launches}; peak "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
        f"{time.perf_counter() - t_start:.1f} s in all")

    print(card)
    print(json.dumps({"kernels": [{
        "name": "flash_fwd", "route": "cuda",
        "source": "ray_tpu_torch/ops/csrc/flash_fwd.cu",
        "replaces": "ray_tpu/ops/flash_attention.py:45",
        "launches": launches, "max_abs_err": max_err, "max_err": max_err,
        **timing}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": info["platform"], "kind": info["kind"],
        "count": info["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
