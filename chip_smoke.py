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
      requests (more than slots); a second run gives the same tokens; the
      repaired cache attention (bf16 cache read as it is, fp32
      accumulation) against its fp32-copy plain version at the 8B cache;
      one decode step on 4 slots at lengths near 2048, timed and split by
      torch.profiler in three forms (the former loop: the fp32-copy
      attention, eager, a host read a step; repaired eager; repaired CUDA
      graph), the graph's token block and executed steps identical to the
      eager loop's; and `benchmark_engine` (decode tok/s at 8 slots
      against the card's memory-bandwidth bound);
  (i) the paged serving path on the same 8B weights: `forward_with_paged_
      cache` through a scrambled block table against `forward_with_cache`
      (a 1500-token prefill, then 4 decode steps); a prefix hit (1024
      tokens from cached blocks, the tail prefilled at offset 1024) against
      a cold prefill; `PagedInferenceEngine(block_size=64, max_len=2048,
      max_batch=8)` serving 12 requests on a shared 1024-token system
      prompt, half at the start and half once the first is done, twice on
      fresh engines (identical streams, prefix hits, every block back);
      TTFT cold against a prefix hit; decode tok/s at 8 slots and a
      profile of one such step (eager and graph); then the tiny fp32
      config on the card against the CPU (a small pool that preempts, and
      a prefix-hit script): streams, block tables after every wave and
      prefix statistics identical; and sampling inside the decode graph
      repeatable on two fresh engines of each kind;
  (h) the training path, on the JAX package's train-bench configuration
      (bench.py: Llama-3-8B layer widths, 5 layers, vocab 32000, chunked CE
      of 1024, remat "dots", bf16, B=4, S=2048): the eager step
      (`make_train_step(..., compiled=False)`) with AdamW takes a warm-up
      step and 10 timed steps on one batch; each step launches flash_fwd 2L
      times (remat reruns it), dQ and dK/dV L times; its device time by
      kernel group, and the group of elementwise work, reductions, casts
      and AdamW by operator;
  (h-2) the compiled step (`make_train_step`'s default: the loss with its
      backward and the norm with AdamW, each a torch.compile program, the
      flash kernels custom operators inside) from the same seeded state,
      under "dots" (launches 2L / L / L a step) and "dots_attn" (L / L / L:
      the forward's O and lse are saved): its first 3 steps' losses and
      grad norms against the eager step's, the loss falls, step time,
      tokens/s, MFU, compile seconds, peak memory and the device time by
      kernel group. Then 3 steps of the tiny fp32 config eagerly on cuda,
      compiled on cuda and eagerly on cpu from the same weights agree;
  (bench) `python -m ray_tpu_torch.bench`'s run in this process, its JSON
      line printed;
  (j) `graft_entry.entry()` compiled (fullgraph) against its eager forward;
  (k) the model zoo (`ray_tpu_torch.models.{mixtral,vit,t5,mlp}`): (k-1)
      Mixtral at Mixtral-8x7B's widths and 2 layers (MIXTRAL_8X7B), random
      bf16 weights from a seed, `forward` on B=4, S=2048 through the flash
      kernel (L launches) and through the plain attention: logits, and the
      share of routing choices that differ; (k-2) its training step,
      compiled (inductor, remat "dots"), with AdamW as the bench takes it:
      2L / L / L launches a step, each of the first 3 steps against the
      eager loss and gradient of the same state (the first the seeded
      state; the drift from the eager trajectory is logged beside the
      spread that one bf16 ulp of one gate weight gives it), the loss
      falls, step ms, tok/s, MFU, compile seconds, peak memory and the
      device time by group (projection mm, expert bmm, routing, dispatch
      and combine, flash); (k-3) the tiny fp32 Mixtral, 3 eager steps on
      cuda against cpu; (k-4)
      ViT-B/16 (B=32) and T5-base (B=8, 512 -> 128) in bf16 and the MLP,
      eagerly: a forward, 3 steps in which the loss falls, T5's greedy
      decode of 32 tokens twice with the same tokens, and each tiny fp32
      config on cuda against cpu;
  (l) the SPMD path (`ray_tpu_torch.parallel`, `train.spmd`), its branch
      chosen by `torch.cuda.device_count()`: (l-1) always, a world-1 NCCL
      gang on cuda:0: the tiny fp32 config and the bench configuration
      (SPMD_STEPS eager steps) through the sharded code on a 1 x ... x 1
      mesh (DTensor parameters and moments, the local_map'ed flash
      kernels) against the unsharded step from the same state (fp32 1e-5
      relative; bf16 loss 1e-3, grad norm 1e-2; for the bench config the
      unsharded steps are (h)'s first), with (h)'s 2L / L / L launches a
      step; then the same compiled (the sharded step one program over the
      DTensor parameters) against the compiled unsharded step, the tiny
      config (fp32 1e-4) and the bench widths at 1 layer (bf16 loss 1e-3,
      grad norm 1e-2; 2L / L / L), with the seconds it adds; the tiny
      Mixtral (compiled, 1e-4), ViT and T5 (eager, 1e-5) sharded steps
      against their unsharded ones; and the dense engine with mesh= at
      tp=1 against the engine without it (the same greedy tokens); (l-2)
      with fewer than 4 cards, `graft_entry.dryrun_multichip(4,
      device="cpu")` on 4 gloo CPU ranks (NCCL takes one rank a card), as
      its lines say; (l-3) with 4 cards or more, one rank a card over NCCL,
      each part logged and the next one run if it fails (the phase then
      fails at its end): the dry run, `spmd_bench` (fsdp=2 x tp=2 against
      the 1-GPU compiled step on one global batch, B=16 S=2048, the
      compiled and the eager sharded step side by side: step ms, tok/s and
      MFU per GPU, scaling efficiency, peak memory per GPU, NCCL ms against
      compute ms, the trajectories within 1e-2, the compiled step's first
      step within bf16 loss 1e-3 and grad norm 1e-2 of the eager one's),
      the ring step at sp=2 x fsdp=2 (the bench widths, B=4 S=2048) with
      each rank's flash launches (2L(c+1) / L(c+1) / L(c+1) at sp
      coordinate c) and its losses and grad norms against the same mesh
      without the ring (bf16 loss 1e-3, grad norm 1e-2), then compiled
      (its first step against the eager ring's, the same launches),
      Mixtral at 8x7B widths and 2 layers over ep=4 (B=4 S=2048, eager and
      compiled from the same state within 1e-3, MFU, peak memory and the
      all-to-all's device ms), ViT-B/16 over dp=4 and T5-base over dp=2 x
      tp=2 against the one-card step on the same global batch (three
      steps, losses within 1e-3), a pp=4 pipeline of Llama-width SwiGLU
      stages (fp32: output and gradients within 1e-4 of the sequential
      composition on one card), the Llama-3-8B dense engine at tp=4
      against the one-card engine (prefill logits within 2e-2, the first
      token of every request equal, the tokens that agree before the first
      divergence), and Llama-3-8B at its full 32 layers over fsdp=4 (B=8
      S=2048, 3 steps), eager and then compiled from the same state.
      `--only l` runs (l) alone after (a); `python3 chip_smoke.py --only l`
      on a host with four cards is the four-card run, and `--only l
      --part NAME` runs one of its parts (bench, ring, mixtral, vit, t5,
      pipeline, engine, llama8b) alone;
  (m) RLlib's one-process path (`ray_tpu_torch.rllib`), fp32 with TF32
      off: (m-1) the Nature-CNN actor-critic at full width on a seeded
      [128, 84, 84, 4] uint8 minibatch, `forward_train` and one PPO update
      (PPO's defaults) on the card against the same state on the CPU
      (loss, metrics, gradients, parameters after the step), and the
      update's time against its bound; (m-2) one update of every ported
      learner (PPO, DQN, CQL, MARWIL, SAC with the same noise, the V-trace
      update) on the card against the CPU; (m-3) PPO on the port's
      CartPole under tests/test_rllib.py's settings (best return above 60
      within 15 iterations), two iterations at PPO's defaults on the 84x84
      synthetic image env with the Nature CNN (env-steps/s, updates/s,
      seconds sampling and learning, peak memory) and
      `benchmark_env_steps` (8 envs, 256 steps); (m-4) one APPO V-trace
      update (the clipped surrogate) on the Nature CNN at (m-1)'s 128
      frames as [4, 32] rows, card against CPU; one DreamerV3 train_step
      at its full width on the card against the CPU from one state with
      the same Gumbel noise (losses, the three gradients, the parameters
      after the three Adam steps); DreamerV3 on the port's CartPole under
      tests/test_rllib_catalog.py::test_dreamerv3_learns's settings (best
      return >= 60 within 70 iterations, seconds an iteration and the
      share in train_step); multi-agent PPO with two policies on a
      two-agent env defined here (best return above 8 within 30
      iterations). Its numbers are printed beside the card's name and
      power limit. `--only m` runs (m) alone after (a). It launches none
      of the flash kernels;
  (n) the data plane (`ray_tpu_torch.data`, `_private.serialization`):
      (n-1) (h-2)'s compiled step at the bench configuration (B=4, S=2048,
      "dots") fed 12 seeded numpy token batches by `iter_device_batches`,
      in turns with resident device batches of the same tokens: at prefetch
      1 and 0, every yielded batch equal to its source bit for bit (read
      back after the step consumed it), the first step's loss identical
      to the resident runs' and the rest within 1e-4 (the compiled step's
      own run-to-run drift is ~1e-5), 2L / L / L launches a step, step ms
      fed against resident and overlap_frac; (n-2) ViT-B/16 (B=32, bf16,
      eager) fed uint8 [32, 224, 224, 3] random crops and flips of a seeded
      image pool made on the host, cast on the card inside the step: 10
      steps at prefetch 1 and 0 in which the loss falls, step ms against
      resident batches,
      overlap_frac, produce_s, wait_s and the feed's host-to-device GB/s
      from a profiled run; then 200 batches whose bytes are their index,
      each checked on the card after a long kernel on the consumer's
      stream (a stream race shows as a wrong byte); (n-3) serialize / deserialize round trips of
      CUDA tensors (fp32, bf16, int64, bool, 0-d, empty, non-contiguous)
      exact on cuda:0 with one typed put and get each, the host buffer
      overwritten and freed after the get, and `dataplane_bench`'s JSON
      line. Its numbers are printed beside the card's name and power
      limit. `--only n` runs (n) alone after (a);
  (o) Train's checkpoint and predictor (`ray_tpu_torch.train.checkpoint`,
      `.predictor`): (o-1) the compiled bench step at the bench widths cut
      to 1 layer (B=4, S=2048, bf16, "dots"): two steps, the whole
      TrainState saved by `Checkpoint.from_arrays` and restored by
      `to_arrays` into a fresh state, which must equal the saved one bit
      for bit; step 3 on both runs gives the identical loss, step 4 within
      1e-4 (the GB written, the save and restore seconds); (o-2)
      `CompiledPredictor` over ViT-B/16 (bf16, published widths) at
      batches of 1, 3, 17, 32 and 64 rows, each against the eager forward
      on the same rows in the same padded batch (bf16 1e-2 + 1e-2 |ref|;
      the eager forward of the rows alone is logged beside it), exactly
      one compile per distinct bucket, images/s per batch. Its numbers
      are printed beside the card's name and power limit. `--only o` runs
      (o) alone after (a), and (o-2) there also with inductor on the same
      batches, timed and held against eager beside the default (about a
      minute of compile a bucket).

The launch counts are set to 0 just before each main path (serving: (d)
and (e); paged serving: (i), which runs no flash kernel; training: (h);
compiled training: (h-2); Mixtral: (k-1) and (k-2); the SPMD path's
eager sharded steps, its compiled sharded steps and the zoo on the mesh:
(l), each on its own; the fed training path: (n-1)'s fed runs; the
checkpointed training path: (o-1)) and read just after it. The last
three lines of stdout are the card's `nvidia-smi` name and power limit, one
JSON object on the kernels, and `{"ok": true, "device": ...}`. Without
CUDA, or without the repository beside it, it exits non-zero and prints no
result.
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

# The compiled step (h-2) against the eager step (h) from the same seeded
# state, the first COMPARED_STEPS steps: bf16 through 5 layers, the same
# function with other fusions and so other roundings. Relative.
COMPILED_LOSS_REL_TOL = 1e-2
COMPILED_NORM_REL_TOL = 2e-2
COMPARED_STEPS = 3
# What torch.compile builds the compiled step with on the card (a rehearsal
# on the CPU takes aot_eager).
COMPILE_BACKEND = "inductor"

# The first training step's loss (chunked CE) against the loss from the full
# `forward` logits on the same parameters: bf16 logits from products tiled
# differently, averaged over B*S tokens. Relative.
CHUNKED_LOSS_REL_TOL = 1e-3

# forward (flash kernel) against forward_with_cache prefill (plain cache
# attention) at 8B in bf16: both round activations to bf16 at every layer,
# on different attention arithmetic, for 32 layers. Relative L2 distance of
# the last-position logits; a wrong mask or head mapping gives ~1.
FORWARD_REL_TOL = 5e-2


# (e): the dense decode on the card, 4 slots at lengths near the engine's
# max_len of 2048, timed over DECODE_STEPS steps.
DECODE_LENGTHS = (2000, 1990, 1950, 1900)
DECODE_MAX_LEN = 2048
DECODE_STEPS = 32
# The repaired cache attention against its fp32-copy plain version on the
# same bf16 inputs: both round only their inputs (and their bf16 output)
# and accumulate in fp32 in another order. Relative L2 of the output; a
# wrong head mapping or mask gives ~1.
ATTN_REL_TOL = 1e-3
# benchmark_engine at 8B: decode tok/s at full occupancy.
ENGINE_BENCH = dict(max_batch=8, max_len=512, new_tokens=64)

# (i): the paged engine's settings (its default pool: 129 blocks), the
# prompts of the forward checks, and the serving script.
PAGED_ENGINE = dict(block_size=64, max_len=2048, max_batch=8)
PAGED_PROMPT = 1500
PAGED_PREFIX = 1024
PAGED_DECODE_STEPS = 4
SERVE_REQUESTS = 12
SERVE_TAIL = (64, 900)
SERVE_NEW = 48
# Paged against dense logits at 8B bf16 (and a prefix hit against a cold
# prefill): the same arithmetic through other shapes for 32 layers, as
# phase (d)'s bound. Relative L2.
PAGED_REL_TOL = 5e-2

# (k): Mixtral-8x7B's widths, from Mistral AI's published
# Mixtral-8x7B-v0.1 config.json (hidden 4096, intermediate 14336, 32 query
# and 8 KV heads of 128, 8 local experts with 2 a token, vocab 32000,
# rope_theta 1e6, rms_norm_eps 1e-5, 32768 positions), cut in depth from 32
# layers to 2: a layer holds 1.451 B parameters, and the whole model's
# weights, gradients and AdamW moments in bf16 would need ~370 GB.
# capacity_factor 1.25 and aux_loss_coef 0.01 are the JAX package's
# defaults; bf16, remat "dots" (MixtralConfig's defaults).
MIXTRAL_8X7B = dict(vocab_size=32_000, d_model=4096, n_layers=2, n_heads=32,
                    n_kv_heads=8, d_head=128, d_ff=14_336, rope_theta=1e6,
                    norm_eps=1e-5, max_seq_len=32_768, n_experts=8,
                    experts_per_token=2, capacity_factor=1.25,
                    aux_loss_coef=0.01)
# Its batch (B, S): the Llama training shape, so the flash kernels see the
# shape of phase (h); the timed compiled steps.
MIXTRAL_BATCH = (4, 2048)
MIXTRAL_STEPS = 10
# (k-4): ViT-B/16 and T5-base at their published widths (fields of
# ViTConfig.base_16() and T5Config.base() replaced: none on the card), in
# bf16 on VIT_BATCH images and T5_SHAPE = (batch, source, target) tokens,
# T5's greedy decode of T5_DECODE tokens, the MLP on MLP_BATCH rows, each
# for ZOO_STEPS eager steps.
VIT_CUT = {}
VIT_BATCH = 32
T5_CUT = {}
T5_SHAPE = (8, 512, 128)
T5_DECODE = 32
MLP_BATCH = 256
ZOO_STEPS = 3
# Their tiny fp32 configs on the card against the CPU, logits and loss:
# |a - b| <= ZOO_TINY_TOL * (1 + |b|) (fp32, sums in another order).
ZOO_TINY_TOL = 1e-4

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


def rel_l2(a, b) -> float:
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm())


def phase_cache_attention(cfg, seed):
    """The repaired `_decode_attention` and `_cached_attention` against
    their fp32-copy plain versions, on bf16 inputs at the 8B cache's shape
    (4 rows of 2048 positions, lengths near 2048)."""
    from ray_tpu_torch.models import llama

    g = torch.Generator(device=DEVICE).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=DEVICE).to(cfg.dtype)

    b, t = len(DECODE_LENGTHS), DECODE_MAX_LEN
    h, kv, d = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    k_cache, v_cache = randn(b, t, kv, d), randn(b, t, kv, d)
    lengths = torch.as_tensor(DECODE_LENGTHS, device=DEVICE)
    q, k, v = randn(b, 1, h, d), randn(b, 1, kv, d), randn(b, 1, kv, d)
    s = 16  # a block of new queries whose keys are already in the cache
    q_block = randn(b, s, h, d)
    with torch.no_grad():
        pairs = {
            "_decode_attention": (
                llama._decode_attention(q, k, v, k_cache, v_cache, lengths,
                                        cfg),
                llama._decode_attention_plain(q, k, v, k_cache, v_cache,
                                              lengths, cfg)),
            "_cached_attention": (
                llama._cached_attention(q_block, k_cache, v_cache,
                                        lengths - s, cfg),
                llama._cached_attention_plain(q_block, k_cache, v_cache,
                                              lengths - s, cfg)),
        }
    for name, (got, want) in pairs.items():
        rel = rel_l2(got, want)
        log(f"[e] {name} (bf16 cache [{b},{t},{kv},{d}], lengths "
            f"{list(DECODE_LENGTHS)}) against its fp32-copy plain version: "
            f"rel L2 {rel:.3e}")
        check(got.dtype == want.dtype and bool(torch.isfinite(got).all())
              and rel <= ATTN_REL_TOL, f"{name} disagrees (rel {rel:.3e})")


def op_group(key):
    """A profiled CPU op -> the group a decode step's device time goes to."""
    if key == "aten::mm":
        return "matrix products (weights)"
    if key == "aten::bmm":
        return "cache attention products"
    if key in ("aten::copy_", "aten::index_select", "aten::index",
               "aten::index_put_", "aten::_index_put_impl_", "aten::cat",
               "aten::stack", "aten::index_copy_", "aten::gather"):
        return "copies, casts and gathers"
    return "elementwise, reductions, softmax, sampling"


def profile_decode(run_steps, n):
    """run_steps(n) under torch.profiler -> (wall ms a step, kernel ms a
    step, {group: ms a step}); the groups come from the CPU op each kernel
    was launched by, so a graph replay (whose kernels have no op) shows
    only its total."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_steps(n)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / n
    events = prof.key_averages()
    busy = sum(e.self_device_time_total for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3 / n
    groups = {}
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CPU and \
                e.self_device_time_total > 0:
            grp = op_group(e.key)
            groups[grp] = groups.get(grp, 0.0) + \
                e.self_device_time_total / 1e3 / n
    return wall, busy, groups


def prefill_slots(eng, cfg, lengths, seed):
    """Prefill slots 0..len(lengths)-1 with random prompts of those lengths;
    -> the decode loop's inputs (first tokens, lengths, budget, active)."""
    from ray_tpu_torch.inference import GenerationConfig

    rng = np.random.default_rng(seed)
    n, bucket = len(lengths), eng._bucket_for(max(lengths))
    toks = np.zeros((n, bucket), np.int64)
    for i, s in enumerate(lengths):
        toks[i, :s] = rng.integers(0, cfg.vocab_size, s)
    slots = eng._tensor(range(n))
    firsts = eng._prefill_batch(eng._tensor(toks), slots,
                                eng._tensor(lengths), GenerationConfig())
    budget = torch.full((n,), 1 << 20, device=DEVICE)
    active = torch.ones(n, dtype=torch.bool, device=DEVICE)
    return firsts[:, None], eng._tensor(lengths), budget, active


def time_decode(tag, name, run_steps, n, slots):
    """Time run_steps(n) decode steps on `slots` rows, profile 4 more, and
    log both."""
    run_steps(2)  # warm: a graph is captured on first use
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run_steps(n)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / n
    wall, busy, groups = profile_decode(run_steps, 4)
    log(f"[{tag}] decode step, {name}: {ms:.3f} ms a step, "
        f"{slots * 1e3 / ms:.1f} tok/s; torch.profiler over 4 steps: "
        f"{wall:.3f} ms a step, kernels {busy:.3f} ms (device idle share "
        f"{max(0.0, 1 - busy / wall):.3f})"
        + ("; by group (ms a step): " + ", ".join(
            f"{g} {v:.3f}" for g, v in sorted(groups.items(),
                                               key=lambda x: -x[1]))
           if groups else ""))


def decode_bound_ms(cfg, params, lengths):
    """Least time of one decode step on this card: every weight but the
    embedding table (one row a token) read once, and each row's K/V up to
    its length."""
    nbytes = sum(w.numel() * w.element_size() for w in (
        [params[k] for k in ("final_norm", "lm_head")]
        + list(params["layers"].values())))
    nbytes += (sum(lengths) * 2 * cfg.n_layers * cfg.n_kv_heads * cfg.d_head
               * params["lm_head"].element_size())
    return nbytes / PEAKS[1] * 1e3


def phase_decode(cfg, params, seed):
    """One dense decode step at 4 slots: where its time goes, before and
    after the repairs; the graph against the eager loop."""
    from ray_tpu_torch.inference import GenerationConfig, InferenceEngine
    from ray_tpu_torch.models import llama

    b, n = len(DECODE_LENGTHS), DECODE_STEPS
    eng = InferenceEngine(params, cfg, max_batch=b, max_len=DECODE_MAX_LEN,
                          device=DEVICE)
    inputs = prefill_slots(eng, cfg, DECODE_LENGTHS, seed)
    gen = GenerationConfig(max_new_tokens=n + 1)
    dec = eng._decoder
    graph_mode = dec.use_graph  # on the card; a rehearsal has no graphs
    # The graph against the eager loop on this first wave: each writes the
    # K/V it reads, so the second run reads nothing the first left behind.
    dec.use_graph = False
    eager = eng._decode_full(*inputs, n, -1, gen)
    dec.use_graph = graph_mode
    graph = eng._decode_full(*inputs, n, -1, gen)
    log(f"[e] decode {n} steps on {b} slots: eager executed {eager[1]}, "
        f"graph executed {graph[1]}; token blocks identical "
        f"{np.array_equal(eager[0], graph[0])}")
    check(eager[1] == graph[1] == n and np.array_equal(eager[0], graph[0]),
          "the CUDA graph's decode differs from the eager loop's")

    def run(steps, use_graph):
        dec.use_graph = use_graph
        dec.run(*inputs, steps, -1, gen)

    def run_former(steps):
        # The former loop: the fp32-copy attention, eager, a host read a
        # step.
        dec._load({"tok": inputs[0], "lens": inputs[1], "rem": inputs[2],
                   "act": inputs[3], "eos": -1})
        for _ in range(steps):
            dec._step(gen)
            dec._state["act"].any().item()

    forms = {"former (fp32-copy attention, eager, host read a step)":
             run_former,
             "repaired, eager": lambda k: run(k, False),
             "repaired, CUDA graph": lambda k: run(k, graph_mode)}
    plain = llama._decode_attention
    for name, fn in forms.items():
        if name.startswith("former"):
            llama._decode_attention = llama._decode_attention_plain
        try:
            time_decode("e", name, fn, n, b)
        finally:
            llama._decode_attention = plain
    bound_ms = decode_bound_ms(cfg, params, DECODE_LENGTHS)
    log(f"[e] decode step bound: the weights but the embedding table, and "
        f"the cache up to each length, once at {PEAKS[1] / 1e12:.2f} TB/s: "
        f"{bound_ms:.3f} ms, {b * 1e3 / bound_ms:.1f} tok/s on {b} slots")
    del eng
    gc.collect()
    torch.cuda.empty_cache()

    from ray_tpu_torch.inference.benchmarks import benchmark_engine
    res = benchmark_engine(cfg, device=DEVICE, **ENGINE_BENCH)
    det = res["detail"]
    bound = ("no bound off the card" if det["roofline_frac"] is None else
             f"bound {det['hbm_roofline_tokens_per_sec']:.1f} tok/s, "
             f"roofline share {det['roofline_frac']:.3f}")
    log(f"[e] benchmark_engine {ENGINE_BENCH}: {res['value']:.1f} tok/s "
        f"({res['seconds']:.3f} s) on {det['device_kind']}, {bound}")
    gc.collect()
    torch.cuda.empty_cache()


# -- (i) ---------------------------------------------------------------------

def paged_pool_blocks():
    nb = -(-PAGED_ENGINE["max_len"] // PAGED_ENGINE["block_size"])
    return nb, 1 + max(nb, PAGED_ENGINE["max_batch"] * nb // 2)


def phase_paged_forward(cfg, params, seed):
    """(i-1) paged against dense through a scrambled block table; (i-2) a
    prefix hit against a cold prefill."""
    from ray_tpu_torch.models import llama

    rng = np.random.default_rng(seed)
    bs, max_len = PAGED_ENGINE["block_size"], PAGED_ENGINE["max_len"]
    nb, n_blocks = paged_pool_blocks()
    pool = llama.init_paged_kv_cache(cfg, n_blocks, bs, device=DEVICE)
    perm = rng.permutation(np.arange(1, n_blocks))
    table = torch.as_tensor(perm[None, :nb], device=DEVICE)
    s = PAGED_PROMPT
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size, s),
                             device=DEVICE)
    toks = torch.zeros((1, max_len), dtype=torch.int64, device=DEVICE)
    toks[0, :s] = prompt  # padded to the engine's bucket
    valid = torch.arange(max_len, device=DEVICE)[None] < s
    zero = torch.zeros(1, dtype=torch.int64, device=DEVICE)
    cache = llama.init_kv_cache(cfg, 1, max_len, device=DEVICE)
    with torch.no_grad():
        paged, _ = llama.forward_with_paged_cache(params, toks, pool, table,
                                                  zero, cfg, valid=valid)
        cold_last = paged[0, s - 1].clone()
        del paged
        dense, _ = llama.forward_with_cache(params, toks[:, :s], cache, zero,
                                            cfg)
        dense = dense[:, -1]
        rels = [rel_l2(cold_last, dense[0])]
        for step in range(PAGED_DECODE_STEPS):
            nxt = dense.argmax(-1)[:, None]
            lens = torch.full((1,), s + step, device=DEVICE)
            paged, _ = llama.forward_with_paged_cache(params, nxt, pool,
                                                      table, lens, cfg)
            dense, _ = llama.forward_with_cache(params, nxt, cache, lens, cfg)
            dense = dense[:, -1]
            rels.append(rel_l2(paged[0, -1], dense[0]))
    log(f"[i-1] forward_with_paged_cache through a scrambled table "
        f"{perm[:6].tolist()}... against forward_with_cache: prefill of {s} "
        f"(padded to {max_len}), then {PAGED_DECODE_STEPS} decode steps: "
        f"rel L2 {[f'{r:.3e}' for r in rels]}")
    check(max(rels) <= PAGED_REL_TOL, f"paged and dense differ ({rels})")
    del cache
    # (i-2): the first PAGED_PREFIX tokens' blocks serve a second table.
    m = PAGED_PREFIX
    k = m // bs
    hit_table = torch.cat([table[:, :k], torch.as_tensor(
        perm[None, nb:2 * nb - k], device=DEVICE)], dim=1)
    shared = [x[:, table[0, :k]].clone() for x in pool.values()]
    n_tail = s - m
    bucket = 1 << (n_tail - 1).bit_length()
    tail = torch.zeros((1, bucket), dtype=torch.int64, device=DEVICE)
    tail[0, :n_tail] = prompt[m:]
    tail_valid = torch.arange(bucket, device=DEVICE)[None] < n_tail
    with torch.no_grad():
        hit, _ = llama.forward_with_paged_cache(
            params, tail, pool, hit_table, torch.full((1,), m, device=DEVICE),
            cfg, valid=tail_valid)
    rel = rel_l2(hit[0, n_tail - 1], cold_last)
    kept = all(torch.equal(a, x[:, table[0, :k]])
               for a, x in zip(shared, pool.values()))
    log(f"[i-2] prefix hit: {m} tokens from {k} cached blocks, the {n_tail}-"
        f"token tail prefilled at offset {m} (bucket {bucket}), against the "
        f"cold prefill of all {s}: last-position rel L2 {rel:.3e}; cached "
        f"blocks unchanged {kept}")
    check(rel <= PAGED_REL_TOL and kept,
          f"prefix-hit logits differ (rel {rel:.3e}) or the cached blocks "
          "changed")


def serve_script(eng, prompts, new):
    """Half of `prompts` at the start, the rest once the first request is
    done. -> ({req: tokens}, {req: done count}, seconds)."""
    from ray_tpu_torch.inference import GenerationConfig

    half = len(prompts) // 2
    sent = {"early": False, "late": False, "first_done": False}

    def feed(_block):
        if not sent["early"]:
            sent["early"] = True
            return [(i, prompts[i], new) for i in range(half)], (), False
        if sent["first_done"] and not sent["late"]:
            sent["late"] = True
            return [(i, prompts[i], new)
                    for i in range(half, len(prompts))], (), False
        return [], (), sent["late"]

    streams = {i: [] for i in range(len(prompts))}
    dones = {i: 0 for i in range(len(prompts))}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for rid, tok, done in eng.serve_stream(feed, GenerationConfig(
            max_new_tokens=new)):
        check(tok is not None, f"request {rid} aborted: "
              f"{eng.abort_reasons.get(rid)}")
        streams[rid].append(tok)
        if done:
            dones[rid] += 1
            sent["first_done"] = True
    torch.cuda.synchronize()
    return streams, dones, time.perf_counter() - t0


def check_drained(eng, tag):
    rep = eng.kv_block_report()
    check(rep["active_blocks"] == 0 and rep["active_slots"] == 0
          and rep["free_blocks"] + rep["cached_blocks"] == eng.n_blocks - 1,
          f"{tag}: blocks not all returned ({rep})")
    return rep


def phase_paged_serve(cfg, params, seed):
    """(i-3): serve_stream on the 8B weights, twice, and the rates."""
    from ray_tpu_torch.inference import GenerationConfig
    from ray_tpu_torch.inference.paged_engine import PagedInferenceEngine

    rng = np.random.default_rng(seed)
    system = rng.integers(0, cfg.vocab_size, PAGED_PREFIX).tolist()
    tails = np.linspace(*SERVE_TAIL, SERVE_REQUESTS).astype(int)
    rng.shuffle(tails)
    prompts = [system + rng.integers(0, cfg.vocab_size, int(n)).tolist()
               for n in tails]
    runs = []
    for run in range(2):
        eng = PagedInferenceEngine(params, cfg, device=DEVICE, **PAGED_ENGINE)
        eng.profiler.reset()
        torch.cuda.reset_peak_memory_stats()
        streams, dones, secs = serve_script(eng, prompts, SERVE_NEW)
        rep = check_drained(eng, f"serve run {run + 1}")
        ph = eng.profiler.report(recent=0)["phase_seconds"]
        stats = dict(eng.prefix_stats)
        n_prefill = sum(map(len, prompts)) - stats["hit_tokens"]
        log(f"[i-3] run {run + 1} (fresh engine, {eng.n_blocks} blocks of "
            f"{eng.block_size}, {rep['bytes_per_token']} B a token): "
            f"{SERVE_REQUESTS} requests, tails {sorted(tails.tolist())}, "
            f"{SERVE_NEW} new each, in {secs:.3f} s; prefix {stats}; "
            f"preemptions {eng.preemptions}, peak active {eng.peak_active}; "
            f"phases {ph}; prefill {n_prefill} tokens, "
            f"{n_prefill / max(ph.get('prefill', 0), 1e-9):.1f} tok/s of "
            f"prefill phase; peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        check(all(len(v) == SERVE_NEW for v in streams.values())
              and all(v == 1 for v in dones.values()),
              f"run {run + 1}: tokens {[len(v) for v in streams.values()]}, "
              f"done {list(dones.values())}")
        runs.append((streams, stats, eng.preemptions))
        if run == 0:
            del eng
            gc.collect()
            torch.cuda.empty_cache()
    check(runs[0][0] == runs[1][0], "the two runs' greedy streams differ")
    check(runs[0][1:] == runs[1][1:], "the two runs' prefix statistics or "
          "preemptions differ")
    check(runs[1][1]["hit_requests"] > 0, "the second run had no prefix hit")
    log("[i-3] the two runs: streams, prefix statistics and preemptions "
        "identical")

    # TTFT, on the second engine (its cache holds the system prompt):
    # a prefix hit against a cold system prompt, in turns, each on a tail
    # of its own.
    ttft = {"cold": [], "hit": []}
    for _ in range(2):
        for kind in ("cold", "hit"):
            head = (system if kind == "hit" else
                    rng.integers(0, cfg.vocab_size, PAGED_PREFIX).tolist())
            tail = rng.integers(0, cfg.vocab_size,
                                PAGED_PROMPT - PAGED_PREFIX).tolist()
            before = eng.prefix_stats["hit_tokens"]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.generate([head + tail], GenerationConfig(max_new_tokens=1))
            ttft[kind].append(time.perf_counter() - t0)
            hit = eng.prefix_stats["hit_tokens"] - before
            check((hit == PAGED_PREFIX) == (kind == "hit"),
                  f"{kind} request matched {hit} tokens")
    log(f"[i-3] TTFT of a {PAGED_PROMPT}-token prompt (max_new_tokens=1): "
        f"cold {[f'{t * 1e3:.2f}' for t in ttft['cold']]} ms "
        f"({PAGED_PROMPT / min(ttft['cold']):.1f} prompt tok/s), prefix hit "
        f"of {PAGED_PREFIX} {[f'{t * 1e3:.2f}' for t in ttft['hit']]} ms")

    # Decode at 8 slots: 8 requests on the cached system prompt, each with
    # a tail of one block, asking for one block of new tokens: one wave.
    slots, new = PAGED_ENGINE["max_batch"], PAGED_ENGINE["block_size"]
    batch = [system + rng.integers(0, cfg.vocab_size, new).tolist()
             for _ in range(slots)]
    eng.profiler.reset()
    out = eng.generate(batch, GenerationConfig(max_new_tokens=new))
    check_drained(eng, "decode at 8 slots")
    rep = eng.profiler.report(recent=64)
    decode_tok = sum(r["tokens"] for r in rep["recent_steps"])
    dev_s = rep["phase_seconds"]["device_execute"]
    log(f"[i-3] decode at {slots} slots: {decode_tok} tokens in "
        f"{len(rep['recent_steps'])} waves, device_execute {dev_s:.3f} s, "
        f"{decode_tok / dev_s:.1f} tok/s ({dev_s * 1e3 * slots / decode_tok:.3f}"
        f" ms a step)")
    check(all(len(o) == new for o in out), "decode at 8 slots: token counts")

    # Where a paged decode step's time goes: the 8 slots at these lengths,
    # the system prompt's blocks shared as the prefix cache shares them
    # (the step's work does not depend on the pool's contents).
    dec, bs = eng._decoder, eng.block_size
    shared = PAGED_PREFIX // bs
    lens = len(batch[0]) + 1
    own = -(-(lens + DECODE_STEPS + 8) // bs) - shared
    table = np.zeros_like(eng.block_table)
    table[:, :shared] = np.arange(1, shared + 1)
    table[:, shared:shared + own] = (shared + 1 + np.arange(slots * own)
                                     ).reshape(slots, own)
    tokens = rng.integers(0, cfg.vocab_size, (slots, 1))
    inputs = (tokens, np.full(slots, lens), np.full(slots, 1 << 20),
              np.ones(slots, bool))
    gen = GenerationConfig()
    graph_mode = dec.use_graph

    def run(steps, use_graph):
        dec.use_graph = use_graph
        dec.run(*inputs, steps, -1, gen, table=table)

    for name, use_graph in (("eager", False), ("CUDA graph", graph_mode)):
        time_decode("i-3", f"paged, {slots} slots at {lens}, {name}",
                    lambda k: run(k, use_graph), DECODE_STEPS, slots)
    bound_ms = decode_bound_ms(cfg, params, [lens] * slots)
    log(f"[i-3] paged decode step bound: {bound_ms:.3f} ms, "
        f"{slots * 1e3 / bound_ms:.1f} tok/s on {slots} slots")
    del eng
    gc.collect()
    torch.cuda.empty_cache()


def paged_snapshot(eng):
    rep = eng.kv_block_report()
    return (eng.block_table.tolist(), eng.lengths.tolist(),
            dict(eng.prefix_stats), eng.preemptions,
            {k: rep[k] for k in ("free_blocks", "cached_blocks",
                                 "active_blocks", "active_slots")})


def watch_waves(eng):
    """-> the list that gets the engine's paged_snapshot after every decode
    wave (the engine records each wave in its profiler)."""
    snaps, prof = [], eng.profiler

    class Watch:
        def record_step(self, *args, **kwargs):
            prof.record_step(*args, **kwargs)
            snaps.append(paged_snapshot(eng))

        def report(self, *args, **kwargs):
            return prof.report(*args, **kwargs)

    eng.profiler = Watch()
    return snaps


def phase_paged_tiny(seed=7):
    """(i-4): the tiny fp32 config through the paged engine on the card and
    on the CPU from the same weights: a pool small enough to preempt
    (tests/test_paged_engine.py) and a prefix-hit script
    (tests/test_prefix_cache.py)."""
    import dataclasses

    from ray_tpu_torch.inference import GenerationConfig, InferenceEngine
    from ray_tpu_torch.inference.paged_engine import PagedInferenceEngine
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.train.optim import tree_map

    cfg = dataclasses.replace(llama.LlamaConfig.tiny(vocab_size=128),
                              dtype=torch.float32)
    weights = llama.init(cfg, torch.Generator().manual_seed(seed),
                         device="cpu")
    shared = [3] * 37
    scripts = {
        "preemption": (dict(max_batch=4, max_len=64, block_size=8,
                            n_blocks=9), 24,
                       [[[2, 4, 6], [1, 3, 5], [7, 8, 9]]]),
        "prefix": (dict(max_batch=4, max_len=128, block_size=16,
                        decode_chunk=4), 10,
                   [[shared + [7, 8]], [shared + [9]], [[5] * 32],
                    [[5] * 32], [[11, 4, 8]]]),
    }
    for name, (kw, new, calls) in scripts.items():
        got = {}
        for dev in (DEVICE, "cpu"):
            params = tree_map(lambda w: w.to(dev, copy=True), weights)
            eng = PagedInferenceEngine(params, cfg, device=dev, **kw)
            snaps = watch_waves(eng)
            outs = [eng.generate(prompts, GenerationConfig(
                max_new_tokens=new)) for prompts in calls]
            got[dev] = (outs, snaps, paged_snapshot(eng))
        same = got[DEVICE] == got["cpu"]
        final = got["cpu"][2]
        log(f"[i-4] tiny fp32 paged '{name}' {kw}: {len(got['cpu'][1])} "
            f"decode waves; prefix {final[2]}, preemptions {final[3]}; "
            f"{DEVICE} and cpu streams, block tables after every wave and "
            f"prefix statistics identical {same}")
        check(same, f"tiny paged '{name}' differs between {DEVICE} and cpu")
        check(final[3] > 0 if name == "preemption"
              else final[2]["hit_requests"] > 0 and final[2]["cow_copies"] > 0,
              f"tiny paged '{name}' never preempted or hit")
    # Sampling inside the decode graph draws from the engine's generator,
    # registered with the graph: seeded, so two fresh engines agree.
    params = tree_map(lambda w: w.to(DEVICE, copy=True), weights)
    gen = GenerationConfig(max_new_tokens=12, temperature=1.0, top_k=20,
                           top_p=0.9)
    prompts = [[2, 4, 6], [1, 3, 5, 7, 9]]
    for cls, kw in ((InferenceEngine, dict(max_batch=2, max_len=64)),
                    (PagedInferenceEngine, dict(max_batch=2, max_len=64,
                                                block_size=8))):
        runs = [cls(params, cfg, device=DEVICE, **kw).generate(prompts, gen)
                for _ in range(2)]
        ok = runs[0] == runs[1] and all(
            0 <= t < cfg.vocab_size and len(o) == 12
            for o in runs[0] for t in o)
        log(f"[i-4] tiny {cls.__name__} sampled (temperature 1, top_k 20, "
            f"top_p 0.9) on {DEVICE}: two fresh engines agree and stay in the "
            f"vocabulary {ok}")
        check(ok, f"sampled {cls.__name__} on {DEVICE} not repeatable")


# -- (h) ---------------------------------------------------------------------

def bench_config():
    """The JAX package's train-bench configuration (bench.py:191-199) as the
    port's bench takes it: Llama-3-8B layer widths at 5 layers, vocab
    32000, chunked CE of 1024, remat "dots", bf16."""
    from ray_tpu_torch.bench import bench_config

    return bench_config()


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
    step, launches a step)] from the device events, {operator: ms a step}
    of the device time of the kernels each CPU operator launched)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            state, _ = step(state, data)
        torch.cuda.synchronize()
    events = prof.key_averages()
    kernels = [(e.key, e.self_device_time_total / 1e3 / n, e.count / n)
               for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA]
    ops = {e.key: e.self_device_time_total / 1e3 / n for e in events
           if e.device_type == torch.autograd.DeviceType.CPU
           and e.self_device_time_total > 0}
    return state, sorted(kernels, key=lambda k: -k[1]), ops


def phase_train(cfg, batch, seq, steps, seed):
    """The training main path, the eager step; returns its kernel launch
    counts and {"ms", "tok_s", "mfu", "peak_gib", "first": the first
    COMPARED_STEPS steps' (loss, grad norm)}."""
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.train import adamw, init_train_state, make_train_step

    opt = adamw(3e-4, weight_decay=0.0)  # as bench.py:210
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    t0 = time.perf_counter()
    state = init_train_state(functools.partial(llama.init, cfg, gen), opt,
                             device=DEVICE)
    step = make_train_step(functools.partial(llama.loss_fn, config=cfg), opt,
                           compiled=False)
    data = train_batch(cfg, batch, seq, seed)
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
    metrics = [m]
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
    tok_s, mfu = train_rates(cfg, batch, seq, step_s)
    log(f"[h] B={batch} S={seq}: warm-up step {warm_s:.3f} s (loss "
        f"{first_loss:.4f}; from full forward logits {full_loss:.4f}); "
        f"{steps} steps on one batch: {step_s * 1e3:.2f} ms a step, "
        f"{tok_s:.1f} tok/s, MFU {mfu:.4f} (of {PEAKS[0] / 1e12:.0f} TFLOP/s"
        f" bf16 dense), peak memory {peak_gib:.2f} GiB")
    log(f"[h] losses {[round(x, 4) for x in losses.tolist()]}; grad norms "
        f"{[round(x, 4) for x in norms.tolist()]} (the first is the warm-up "
        "step's)")
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

    # Where a step's device time goes: two more steps under torch.profiler,
    # and the group of elementwise work, reductions, casts and AdamW split
    # by the operator that launched each kernel.
    state, kernels, ops = profile_steps(step, state, data, 2)
    log_kernel_groups("h", "eager dots", kernels, step_s)
    other = sorted(((op, ms) for op, ms in ops.items()
                    if op_is_other(op)), key=lambda x: -x[1])
    log(f"[h] the other group by operator ({sum(ms for _, ms in other):.2f}"
        " ms a step): " + ", ".join(f"{op} {ms:.2f}" for op, ms in
                                    other[:16]))
    first = [(float(m["loss"]), float(m["grad_norm"]))
             for m in metrics[:COMPARED_STEPS]]
    return kernel_counts(), {"ms": step_s * 1e3, "tok_s": tok_s, "mfu": mfu,
                             "peak_gib": peak_gib, "first": first}


def train_batch(cfg, batch, seq, seed):
    """One batch of random tokens from `seed`, on the card, laid out as the
    bench lays its batch out (so a compiled step serves both)."""
    toks = torch.as_tensor(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (batch, seq + 1)), device=DEVICE)
    return {"inputs": toks[:, :-1].contiguous(),
            "targets": toks[:, 1:].contiguous()}


def train_rates(cfg, batch, seq, step_s):
    """-> (tokens/s, MFU against the card's dense bf16 peak)."""
    from ray_tpu_torch.models import llama

    tok_s = batch * seq / step_s
    return tok_s, llama.flops_per_token(cfg, seq) * tok_s / PEAKS[0]


def op_is_other(op):
    """Whether a profiled operator's kernels fall in kernel_group's other
    group (not a matrix product, not a flash kernel)."""
    return op_group(op) != "matrix products (weights)" and \
        not op.startswith("ray_tpu_torch::")


def log_kernel_groups(tag, form, kernels, step_s):
    busy = sum(ms for _, ms, _ in kernels)
    groups = {}
    for name, ms, _ in kernels:
        groups[kernel_group(name)] = groups.get(kernel_group(name), 0.0) + ms
    log(f"[{tag}] {form}, torch.profiler, 2 steps: kernels {busy:.2f} ms a "
        f"step of the {step_s * 1e3:.2f} ms step (device idle share "
        f"{1 - busy / (step_s * 1e3):.3f}); by group (ms a step): "
        + ", ".join(f"{g} {ms:.2f}" for g, ms in
                    sorted(groups.items(), key=lambda x: -x[1])))
    for name, ms, n in kernels[:10]:
        log(f"[{tag}]   {ms:8.3f} ms {n:6.1f}x  {name[:110]}")


def phase_train_compiled(cfg, batch, seq, steps, seed, eager):
    """(h-2): the compiled step (`make_train_step`'s default) at the bench
    configuration under "dots" and "dots_attn", each from the state phase
    (h) started from; `eager` is (h)'s result. Returns the launch counts."""
    import dataclasses

    from ray_tpu_torch.models import llama
    from ray_tpu_torch.train import adamw, init_train_state, make_train_step

    data = train_batch(cfg, batch, seq, seed)
    fwd_per_layer = {"dots": 2, "dots_attn": 1}
    forms = {"eager dots": eager}
    for policy, per_layer in fwd_per_layer.items():
        pcfg = dataclasses.replace(cfg, remat_policy=policy)
        opt = adamw(3e-4, weight_decay=0.0)
        gen = torch.Generator(device=DEVICE).manual_seed(seed)
        state = init_train_state(functools.partial(llama.init, pcfg, gen),
                                 opt, device=DEVICE)
        step = make_train_step(functools.partial(llama.loss_fn, config=pcfg),
                               opt, backend=COMPILE_BACKEND)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        want = {"flash_fwd": per_layer * cfg.n_layers,
                "flash_bwd_dq": cfg.n_layers, "flash_bwd_dkv": cfg.n_layers}
        per_step, first = [], []
        t0 = time.perf_counter()
        for i in range(COMPARED_STEPS):
            before = kernel_counts()
            state, m = step(state, data)
            first.append((float(m["loss"]), float(m["grad_norm"])))
            after = kernel_counts()
            per_step.append({k: after[k] - before[k] for k in after})
            if i == 0:
                compile_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            before = kernel_counts()
            state, m = step(state, data)
            after = kernel_counts()
            per_step.append({k: after[k] - before[k] for k in after})
        torch.cuda.synchronize()
        step_s = (time.perf_counter() - t0) / steps
        last_loss = float(m["loss"])
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        tok_s, mfu = train_rates(pcfg, batch, seq, step_s)
        form = f"compiled {policy}"
        forms[form] = {"ms": step_s * 1e3, "tok_s": tok_s, "mfu": mfu,
                       "peak_gib": peak_gib, "compile_s": compile_s}
        rel_loss = [abs(a[0] - b[0]) / abs(b[0])
                    for a, b in zip(first, eager["first"])]
        rel_norm = [abs(a[1] - b[1]) / abs(b[1])
                    for a, b in zip(first, eager["first"])]
        log(f"[h-2] {form} ({COMPILE_BACKEND}): first step (compiles) "
            f"{compile_s:.2f} s; {steps} steps: {step_s * 1e3:.2f} ms a step,"
            f" {tok_s:.1f} tok/s, MFU {mfu:.4f}, peak memory {peak_gib:.2f} "
            f"GiB; launches a step {per_step[0]}")
        log(f"[h-2] {form}: first {COMPARED_STEPS} steps (loss, grad norm) "
            f"{first}, eager {eager['first']}: relative difference loss "
            f"{max(rel_loss):.3e}, grad norm {max(rel_norm):.3e}; last loss "
            f"{last_loss:.4f}")
        check(all(p == want for p in per_step),
              f"{form}: launches per step {per_step}, not {want}")
        check(max(rel_loss) <= COMPILED_LOSS_REL_TOL
              and max(rel_norm) <= COMPILED_NORM_REL_TOL,
              f"{form} differs from the eager step")
        check(np.isfinite(last_loss) and last_loss < first[0][0],
              f"{form}: the loss did not fall")
        state, kernels, _ = profile_steps(step, state, data, 2)
        log_kernel_groups("h-2", form, kernels, step_s)
        del state, step
        gc.collect()
        torch.cuda.empty_cache()
    log("[h-2] forms (ms a step, tok/s, MFU, peak GiB, compile s): "
        + "; ".join(f"{form} {r['ms']:.2f}, {r['tok_s']:.1f}, "
                    f"{r['mfu']:.4f}, {r['peak_gib']:.2f}, "
                    f"{r.get('compile_s', 0.0):.2f}"
                    for form, r in forms.items()))
    return kernel_counts()


def tiny_train_config():
    """LlamaConfig.tiny() in fp32, its loss in chunks of 32 (two a row of
    the tiny batches)."""
    import dataclasses

    from ray_tpu_torch.models import llama

    return dataclasses.replace(llama.LlamaConfig.tiny(), dtype=torch.float32,
                               loss_chunk_size=32)


def tiny_runs(loss_fn, weights, batches, forms):
    """Steps of make_train_step from the same weights on each batch, for
    each form (name, device, compiled): {name: ([(loss, grad norm)],
    final parameters)}."""
    from ray_tpu_torch.train import adamw, init_train_state, make_train_step
    from ray_tpu_torch.train.optim import tree_map

    runs = {}
    for name, dev, compiled in forms:
        opt = adamw(TINY_LR, weight_decay=1e-4)
        state = init_train_state(
            lambda d: tree_map(lambda w: w.to(d, copy=True), weights), opt,
            device=dev)
        step = make_train_step(loss_fn, opt, compiled=compiled,
                               backend=COMPILE_BACKEND)
        out = []
        for batch in batches:
            state, m = step(state, {k: v.to(dev) for k, v in batch.items()})
            out.append((float(m["loss"]), float(m["grad_norm"])))
        runs[name] = (out, state.params)
    return runs


def check_tiny(tag, runs, names):
    """Each named run against the "cpu" run: loss and grad norm within
    TINY_REL_TOL, parameters within TINY_LR."""
    from ray_tpu_torch.train.optim import tree_leaves

    want, p_want = runs["cpu"]
    for name in names:
        got, p_got = runs[name]
        rel = max(max(abs(a - b) / abs(b) for a, b in zip(x, y))
                  for x, y in zip(got, want))
        p_err = max(float((a.cpu() - b).abs().max())
                    for a, b in zip(tree_leaves(p_got), tree_leaves(p_want)))
        log(f"[{tag}] tiny fp32, {len(got)} steps, {name} on {DEVICE} vs "
            f"eager on cpu: (loss, grad norm) {got} vs {want}; largest "
            f"relative difference {rel:.3e}, parameters {p_err:.3e}")
        check(rel <= TINY_REL_TOL and p_err <= TINY_LR,
              f"tiny train steps, {name} on {DEVICE} and eager on cpu, "
              "disagree")


def phase_train_tiny(steps=3, seed=5):
    """3 fp32 steps of the tiny config on cuda (kernels), eagerly and
    compiled, and eagerly on cpu (plain versions) from the same weights and
    batches (laid out as train_batch lays them out)."""
    from ray_tpu_torch.models import llama

    cfg = tiny_train_config()
    weights = llama.init(cfg, torch.Generator().manual_seed(seed),
                         device="cpu")
    rng = np.random.default_rng(seed)
    batches = []
    for _ in range(steps):
        toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 65)))
        batches.append({"inputs": toks[:, :-1].contiguous(),
                        "targets": toks[:, 1:].contiguous()})
    # The eager step on the card, the compiled step on the card, and the
    # eager step on the CPU (the plain versions) that both are held to.
    compiled = f"compiled ({COMPILE_BACKEND})"
    runs = tiny_runs(functools.partial(llama.loss_fn, config=cfg), weights,
                     batches, (("eager", DEVICE, False),
                               (compiled, DEVICE, True),
                               ("cpu", "cpu", False)))
    check_tiny("h", runs, ["eager", compiled])


def phase_bench():
    """The port's bench in this process (`python -m ray_tpu_torch.bench`):
    its JSON line, on an earlier line of this script's output. On the card
    its configuration and batch are (h-2)'s "dots" form's, whose compiled
    programs it finds in torch.compile's cache."""
    from ray_tpu_torch import bench

    res = bench.run(DEVICE, config=bench_config())
    log(f"[bench] {json.dumps(res)}")
    det = res["detail"]
    check(res["value"] > 0 and np.isfinite(det["loss"])
          and det["compile_s"] > 0, "the bench's step did not run")
    check(det["mfu"] is not None or DEVICE == "cpu",
          "the bench reported no MFU on the card")


def phase_entry():
    """(j) `graft_entry.entry()` compiled (fullgraph) against its eager
    forward on the same arguments."""
    from ray_tpu_torch import graft_entry

    fn, args = graft_entry.entry(DEVICE)
    with torch.no_grad():
        want = fn(*args)
        t0 = time.perf_counter()
        got = torch.compile(fn, backend=COMPILE_BACKEND, fullgraph=True)(
            *args)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    rel = rel_l2(got, want)
    log(f"[j] graft_entry.entry() compiled ({COMPILE_BACKEND}, fullgraph) in"
        f" {secs:.2f} s with its first call: logits {tuple(got.shape)}, rel "
        f"L2 to the eager forward {rel:.3e}")
    check(got.shape == want.shape and bool(torch.isfinite(got).all())
          and rel <= FORWARD_REL_TOL, "the compiled entry differs")


# -- (k) ---------------------------------------------------------------------

def mixtral_config():
    from ray_tpu_torch.models import mixtral

    return mixtral.MixtralConfig(**MIXTRAL_8X7B)


def mixtral_state(cfg, seed, opt):
    """The training state of `cfg` from `seed`, on the card."""
    from ray_tpu_torch.models import mixtral
    from ray_tpu_torch.train import init_train_state

    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    return init_train_state(functools.partial(mixtral.init, cfg, gen), opt,
                            device=DEVICE)


def phase_mixtral_forward(cfg, params, seed):
    """(k-1) `mixtral.forward` through the flash kernel and through the
    plain attention on the same weights and batch: logits, and the share of
    (token, slot) routing choices that differ between the two."""
    from ray_tpu_torch.models import mixtral
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.parallel import moe

    b, s = MIXTRAL_BATCH
    tokens = torch.as_tensor(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)), device=DEVICE)
    route, kernel_fwd = moe.route, fa._flash_fwd

    def run(attention):
        routes = []

        def recording(logits, k, capacity):
            r = route(logits, k, capacity)
            routes.append(torch.where(r.keep, r.expert, -1))
            return r

        moe.route, fa._flash_fwd = recording, attention
        try:
            before = fa.flash_fwd_cuda.launches
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.no_grad():
                logits, aux = mixtral.forward(params, tokens, cfg)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        finally:
            moe.route, fa._flash_fwd = route, kernel_fwd
        return (logits, float(aux), torch.stack(routes), secs,
                fa.flash_fwd_cuda.launches - before)

    got = run(kernel_fwd)
    want = run(fa._reference_attention_torch)
    rel = rel_l2(got[0], want[0])
    flips = float((got[2] != want[2]).float().mean())
    log(f"[k-1] mixtral.forward B={b} S={s} at 8x7B widths, {cfg.n_layers} "
        f"layers: flash kernel {got[3]:.3f} s (the first call of the phase; "
        f"{got[4]} launches), plain attention {want[3]:.3f} s ({want[4]} "
        f"launches); logits rel L2 "
        f"{rel:.3e}; aux {got[1]:.6f} / {want[1]:.6f}; (token, slot) "
        f"routing choices that differ {flips:.3e} of {got[2].numel()}")
    check(tuple(got[0].shape) == (b, s, cfg.vocab_size)
          and bool(torch.isfinite(got[0]).all()), "mixtral logits")
    check(got[4] == cfg.n_layers and want[4] == 0,
          f"forward launched flash_fwd {got[4]} and {want[4]} times, not "
          f"{cfg.n_layers} and 0")
    check(rel <= FORWARD_REL_TOL,
          f"mixtral forward: kernel and plain attention differ ({rel:.3e})")


def log_mixtral_groups(form, kernels, ops, step_s):
    """The step's device time by group: the flash kernels; the matrix
    products (cuBLAS kernels), split by the operator that launched them
    (aten::mm: attention projections, gate logits, lm_head; aten::bmm: the
    experts); routing, dispatch and combine (sort, cumsum, gather, scatter
    and index kernels: the embedding's and the loss's gathers fall here
    too); and the rest."""
    busy = sum(ms for _, ms, _ in kernels)
    groups = {}
    for name, ms, _ in kernels:
        grp = kernel_group(name)
        if grp.startswith("other") and any(
                t in name.lower() for t in ("index", "gather", "scatter",
                                            "sort", "cumsum", "scan")):
            grp = "routing, dispatch and combine"
        groups[grp] = groups.get(grp, 0.0) + ms
    log(f"[k-2] {form}, torch.profiler, 2 steps: kernels {busy:.2f} ms a "
        f"step of the {step_s * 1e3:.2f} ms step (device idle share "
        f"{1 - busy / (step_s * 1e3):.3f}); by group (ms a step): "
        + ", ".join(f"{g} {ms:.2f}" for g, ms in
                    sorted(groups.items(), key=lambda x: -x[1]))
        + f"; matrix products by operator: projection aten::mm "
        f"{ops.get('aten::mm', 0.0):.2f}, expert aten::bmm "
        f"{ops.get('aten::bmm', 0.0):.2f}")
    for name, ms, n in kernels[:10]:
        log(f"[k-2]   {ms:8.3f} ms {n:6.1f}x  {name[:110]}")


def loss_and_norm(loss_fn, params, data):
    """(loss, global grad norm) of loss_fn at params, eagerly, no update."""
    from ray_tpu_torch.train.optim import global_norm, tree_leaves

    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    try:
        with torch.enable_grad():
            loss = loss_fn(params, data)
            grads = torch.autograd.grad(loss, leaves)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    return float(loss), float(global_norm(grads))


def rel_diffs(got, want):
    """Largest relative difference of loss and of grad norm, step by
    step."""
    return (max(abs(a[0] - b[0]) / abs(b[0]) for a, b in zip(got, want)),
            max(abs(a[1] - b[1]) / abs(b[1]) for a, b in zip(got, want)))


def phase_mixtral_train(cfg, seed):
    """(k-2) make_train_step over mixtral.loss_fn, compiled, with AdamW as
    the bench takes it: a warm-up step and MIXTRAL_STEPS timed steps on one
    batch, 2L / L / L launches a step; each of its first COMPARED_STEPS
    steps held against the eager loss and gradient of the same state (the
    first is the seeded state). The eager trajectory from the seeded state,
    and from it with one gate weight one bf16 ulp away, say how far a
    trajectory moves by itself: routing is a discrete choice, and AdamW's
    first steps are lr * sign(g)."""
    from ray_tpu_torch.models import mixtral
    from ray_tpu_torch.train import adamw, make_train_step

    b, s = MIXTRAL_BATCH
    data = train_batch(cfg, b, s, seed)
    loss = functools.partial(mixtral.loss_fn, config=cfg)
    opt = adamw(3e-4, weight_decay=0.0)  # as bench.py:210
    trajectories = []
    for nudge in (False, True):
        state = mixtral_state(cfg, seed, opt)
        if nudge:  # the next bf16 value of one gate weight
            state.params["layers"]["moe_gate"].view(-1)[:1].view(
                torch.int16).add_(1)
        step = make_train_step(loss, opt, compiled=False)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = []
        for _ in range(COMPARED_STEPS):
            state, m = step(state, data)
            out.append((float(m["loss"]), float(m["grad_norm"])))
        trajectories.append(out)
        eager_s = time.perf_counter() - t0
        del state, step
        gc.collect()
        torch.cuda.empty_cache()
    eager, nudged = trajectories
    spread = rel_diffs(nudged, eager)
    log(f"[k-2] eager: {COMPARED_STEPS} steps in {eager_s:.2f} s, peak "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; (loss,"
        f" grad norm) from the seeded state {eager}; with one moe_gate "
        f"weight one bf16 ulp away {nudged}: relative spread loss "
        f"{spread[0]:.3e}, grad norm {spread[1]:.3e}")

    state = mixtral_state(cfg, seed, opt)
    step = make_train_step(loss, opt, backend=COMPILE_BACKEND)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    want = {"flash_fwd": 2 * cfg.n_layers, "flash_bwd_dq": cfg.n_layers,
            "flash_bwd_dkv": cfg.n_layers}
    per_step, first, same_state = [], [], []
    compile_s = 0.0
    for i in range(COMPARED_STEPS):
        same_state.append(loss_and_norm(loss, state.params, data))
        before = kernel_counts()
        t0 = time.perf_counter()
        state, m = step(state, data)
        first.append((float(m["loss"]), float(m["grad_norm"])))
        if i == 0:
            compile_s = time.perf_counter() - t0
        after = kernel_counts()
        per_step.append({k: after[k] - before[k] for k in after})
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(MIXTRAL_STEPS):
        before = kernel_counts()
        state, m = step(state, data)
        after = kernel_counts()
        per_step.append({k: after[k] - before[k] for k in after})
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / MIXTRAL_STEPS
    last_loss = float(m["loss"])
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    tok_s = b * s / step_s
    mfu = mixtral.flops_per_token(cfg, s) * tok_s / PEAKS[0]
    rel_loss, rel_norm = rel_diffs(first, same_state)
    drift = rel_diffs(first, eager)
    log(f"[k-2] compiled dots ({COMPILE_BACKEND}) B={b} S={s}, "
        f"{cfg.num_params() / 1e9:.3f} B params: first step (compiles) "
        f"{compile_s:.2f} s; {MIXTRAL_STEPS} steps: {step_s * 1e3:.2f} ms a "
        f"step, {tok_s:.1f} tok/s, MFU {mfu:.4f} (mixtral.flops_per_token "
        f"{mixtral.flops_per_token(cfg, s) * b * s / 1e12:.2f} TFLOP a step,"
        f" of {PEAKS[0] / 1e12:.0f} TFLOP/s bf16 dense), peak memory "
        f"{peak_gib:.2f} GiB; launches a step {per_step[0]}")
    log(f"[k-2] compiled dots: first {COMPARED_STEPS} steps (loss, grad "
        f"norm) {first}; eager from the same states {same_state}: relative "
        f"difference loss {rel_loss:.3e}, grad norm {rel_norm:.3e}; against "
        f"the eager trajectory: loss {drift[0]:.3e}, grad norm "
        f"{drift[1]:.3e}; last loss {last_loss:.4f}")
    check(all(p == want for p in per_step),
          f"mixtral: launches per step {per_step}, not {want}")
    check(rel_loss <= COMPILED_LOSS_REL_TOL
          and rel_norm <= COMPILED_NORM_REL_TOL,
          "the compiled mixtral step differs from the eager step")
    check(np.isfinite(last_loss) and last_loss < first[0][0],
          "mixtral: the loss did not fall")
    state, kernels, ops = profile_steps(step, state, data, 2)
    log_mixtral_groups("compiled dots", kernels, ops, step_s)
    del state, step
    gc.collect()
    torch.cuda.empty_cache()


def phase_mixtral_tiny(steps=3, seed=9):
    """(k-3) 3 eager fp32 steps of the tiny Mixtral on the card (kernels)
    and on the CPU (plain versions) from the same weights."""
    import dataclasses

    from ray_tpu_torch.models import mixtral

    cfg = dataclasses.replace(mixtral.MixtralConfig.tiny(vocab_size=256),
                              dtype=torch.float32)
    weights = mixtral.init(cfg, torch.Generator().manual_seed(seed),
                           device="cpu")
    rng = np.random.default_rng(seed)
    batches = [{"tokens": torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                                       (2, 65)))}
               for _ in range(steps)]
    runs = tiny_runs(functools.partial(mixtral.loss_fn, config=cfg),
                     weights, batches,
                     (("eager", DEVICE, False), ("cpu", "cpu", False)))
    check_tiny("k-3", runs, ["eager"])


def train_eagerly(tag, loss_fn, params, batch, lr):
    """ZOO_STEPS eager AdamW steps on one batch; checks that the loss
    falls; -> the losses."""
    from ray_tpu_torch.train import adamw, init_train_state, make_train_step

    opt = adamw(lr, weight_decay=0.0)
    state = init_train_state(lambda dev: params, opt, device=DEVICE)
    step = make_train_step(loss_fn, opt, compiled=False)
    torch.cuda.reset_peak_memory_stats()
    losses = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(ZOO_STEPS):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    log(f"[k-4] {tag}: {ZOO_STEPS} eager AdamW steps (lr {lr}) on one batch"
        f" in {secs:.3f} s, losses {[round(x, 4) for x in losses]}, peak "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    check(np.isfinite(losses).all() and losses[-1] < losses[0],
          f"{tag}: the loss did not fall ({losses})")
    return losses


def check_tiny_forward(tag, module, cfg, args, seed):
    """The tiny fp32 config's logits and loss on the card against the CPU
    from the same weights: |a - b| <= ZOO_TINY_TOL * (1 + |b|)."""
    from ray_tpu_torch.train.optim import tree_map

    weights = module.init(cfg, torch.Generator().manual_seed(seed),
                          device="cpu")
    out = {}
    for dev in (DEVICE, "cpu"):
        params = tree_map(lambda w: w.to(dev, copy=True), weights)
        inputs, batch = args(dev)
        with torch.no_grad():
            out[dev] = (module.forward(params, *inputs, cfg).cpu(),
                        float(module.loss_fn(params, batch, cfg)))
    (logits, loss), (ref, ref_loss) = out[DEVICE], out["cpu"]
    err = float(((logits - ref).abs() / (1 + ref.abs())).max())
    loss_err = abs(loss - ref_loss) / (1 + abs(ref_loss))
    log(f"[k-4] tiny fp32 {tag}, {DEVICE} vs cpu: logits {tuple(ref.shape)} "
        f"error {err:.3e}, loss {loss:.6f} vs {ref_loss:.6f}")
    check(err <= ZOO_TINY_TOL and loss_err <= ZOO_TINY_TOL,
          f"tiny {tag} differs between {DEVICE} and cpu")


def phase_zoo_others(seed):
    """(k-4) ViT-B/16, T5-base and the MLP on the card, eagerly: a forward,
    ZOO_STEPS train steps in which the loss falls, T5's greedy decode twice
    with the same tokens; and each tiny fp32 config on the card against the
    CPU."""
    import dataclasses

    from ray_tpu_torch.models import mlp, t5, vit

    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=DEVICE).manual_seed(seed)

    cfg = dataclasses.replace(vit.ViTConfig.base_16(), **VIT_CUT)
    params = vit.init(cfg, gen, device=DEVICE)
    n = VIT_BATCH
    batch = {"images": torch.as_tensor(rng.standard_normal(
        (n, cfg.image_size, cfg.image_size, cfg.num_channels)),
        dtype=torch.float32, device=DEVICE),
        "labels": torch.as_tensor(rng.integers(0, cfg.num_classes, n),
                                  device=DEVICE)}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        logits = vit.forward(params, batch["images"], cfg)
    torch.cuda.synchronize()
    log(f"[k-4] ViT-B/16 ({cfg.num_params() / 1e6:.1f} M params, bf16) "
        f"forward of {n} images: {time.perf_counter() - t0:.3f} s, logits "
        f"{tuple(logits.shape)}")
    check(tuple(logits.shape) == (n, cfg.num_classes)
          and bool(torch.isfinite(logits).all()), "ViT logits")
    train_eagerly("ViT-B/16", functools.partial(vit.loss_fn, config=cfg),
                  params, batch, 1e-3)
    del params, batch, logits

    cfg = dataclasses.replace(t5.T5Config.base(), **T5_CUT)
    params = t5.init(cfg, gen, device=DEVICE)
    n, s_src, s_tgt = T5_SHAPE
    src = rng.integers(3, cfg.vocab_size, (n, s_src))
    src[::2, s_src * 3 // 4:] = cfg.pad_id  # every other source padded
    tgt = rng.integers(3, cfg.vocab_size, (n, s_tgt))
    tgt[:, 0] = 1
    batch = {"src": torch.as_tensor(src, device=DEVICE),
             "tgt": torch.as_tensor(tgt, device=DEVICE)}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        logits = t5.forward(params, batch["src"], batch["tgt"][:, :-1], cfg)
    torch.cuda.synchronize()
    log(f"[k-4] T5-base ({cfg.num_params() / 1e6:.1f} M params, bf16) "
        f"forward of {n} x {s_src} -> {s_tgt - 1}: "
        f"{time.perf_counter() - t0:.3f} s, logits {tuple(logits.shape)}")
    check(tuple(logits.shape) == (n, s_tgt - 1, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()), "T5 logits")
    del logits
    train_eagerly("T5-base", functools.partial(t5.loss_fn, config=cfg),
                  params, batch, 1e-3)
    decoded = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        decoded.append(t5.greedy_decode(params, batch["src"], cfg,
                                        max_len=T5_DECODE))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    same = torch.equal(decoded[0], decoded[1])
    log(f"[k-4] T5-base greedy_decode of {T5_DECODE} tokens on {n} sources: "
        f"{secs:.3f} s, shape {tuple(decoded[0].shape)}, two runs identical "
        f"{same}")
    check(same and decoded[0].shape == (n, T5_DECODE),
          "T5 greedy decode not repeatable")
    del params, batch, decoded

    cfg = mlp.MLPConfig()
    params = mlp.init(cfg, gen, device=DEVICE)
    batch = {"x": torch.as_tensor(rng.standard_normal((MLP_BATCH, cfg.in_dim)),
                                  dtype=torch.float32, device=DEVICE),
             "y": torch.as_tensor(rng.integers(0, cfg.out_dim, MLP_BATCH),
                                  device=DEVICE)}
    train_eagerly("MLP", functools.partial(mlp.loss_fn, config=cfg), params,
                  batch, 1e-3)
    log(f"[k-4] MLP accuracy on its batch after {ZOO_STEPS} steps: "
        f"{float(mlp.accuracy(params, batch, cfg)):.4f}")
    gc.collect()
    torch.cuda.empty_cache()

    def vit_args(dev):
        images = torch.as_tensor(np.random.default_rng(1).standard_normal(
            (2, 32, 32, 3)), dtype=torch.float32, device=dev)
        labels = torch.tensor([3, 7], device=dev)
        return (images,), {"images": images, "labels": labels}

    def t5_args(dev):
        b = {k: torch.as_tensor(v, device=dev) for k, v in _tiny_t5().items()}
        return (b["src"], b["tgt"][:, :-1]), b

    def mlp_args(dev):
        x = torch.as_tensor(np.random.default_rng(2).standard_normal(
            (8, 784)), dtype=torch.float32, device=dev)
        return (x,), {"x": x, "y": torch.arange(8, device=dev)}

    check_tiny_forward("ViT", vit, vit.ViTConfig.tiny(), vit_args, seed)
    check_tiny_forward("T5", t5, t5.T5Config.tiny(vocab_size=128), t5_args,
                       seed)
    check_tiny_forward("MLP", mlp, mlp.MLPConfig(), mlp_args, seed)


def _tiny_t5():
    rng = np.random.default_rng(3)
    src = rng.integers(3, 128, (2, 20))
    src[1, 12:] = 0
    tgt = rng.integers(3, 128, (2, 10))
    tgt[:, 0] = 1
    return {"src": src, "tgt": tgt}


def phase_zoo(t_start):
    """(k): the model zoo on the card. Its main path is Mixtral's, (k-1) and
    (k-2): the launch counts are set to 0 before it and read after it. ->
    those counts."""
    from ray_tpu_torch.models import mixtral

    cfg = mixtral_config()
    t0 = time.perf_counter()
    params = mixtral.init(cfg, torch.Generator(device=DEVICE).manual_seed(0),
                          device=DEVICE)
    torch.cuda.synchronize()
    log(f"[k] Mixtral at 8x7B widths, {cfg.n_layers} layers, bf16: "
        f"{cfg.num_params() / 1e9:.3f} B params, init "
        f"{time.perf_counter() - t0:.2f} s")
    reset_kernel_counts()
    phase_mixtral_forward(cfg, params, seed=10)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    phase_mixtral_train(cfg, seed=11)
    counts = kernel_counts()
    log(f"[k] launches on the Mixtral path: {counts}; "
        f"{time.perf_counter() - t_start:.1f} s so far")
    phase_mixtral_tiny()
    phase_zoo_others(seed=12)
    log(f"[k-4] {time.perf_counter() - t_start:.1f} s so far")
    return counts


# -- (l) ---------------------------------------------------------------------

# (l-1): the sharded step on a world-1 mesh against the unsharded one.
SPMD_STEPS = 3
SPMD_TINY_REL_TOL = 1e-5      # fp32: the same arithmetic, reordered sums
SPMD_LOSS_REL_TOL = 1e-3      # bf16 at the bench config
SPMD_NORM_REL_TOL = 1e-2
# (l-3): four cards.
SPMD_CARDS = 4
SPMD_BENCH_STEPS = 3
SPMD_BENCH_LOSS_REL_TOL = 1e-2    # the 1-GPU and 4-GPU trajectories
SPMD_RING = dict(plan={"sp": 2, "fsdp": 2}, batch=4, seq=2048)
SPMD_FULL = dict(plan={"fsdp": 4}, batch=8, seq=2048, steps=3)
SPMD_TIMEOUT_S = 900
# (l-1), the compiled sharded step: against the compiled unsharded step
# from the same state; the compiled step is not bit-repeatable (~2e-5), so
# fp32 is held to 1e-4 (bf16 to SPMD_LOSS_REL_TOL / SPMD_NORM_REL_TOL). At
# the bench widths the depth is cut to SPMD_COMPILED_LAYERS to keep the
# compiles short.
SPMD_COMPILED_TINY_REL_TOL = 1e-4
SPMD_COMPILED_LAYERS = 1
# (l-1), the zoo on a world-1 mesh: Mixtral compiled (1e-4, fp32), ViT and
# T5 eager (SPMD_TINY_REL_TOL).
ZOO_MESH_COMPILED_REL_TOL = 1e-4
# (l-1), the dense engine with mesh= at tp=1 against the engine without.
ENGINE_MESH = dict(max_batch=2, max_len=64, new_tokens=8,
                   prompts=([1, 2, 3, 4], [5, 6, 7, 8, 9, 10, 11]))
# (l-3): Mixtral at 8x7B widths over ep=4, ViT-B/16 over dp=4, T5-base over
# dp=2 x tp=2 against the one-card step, a pp=4 pipeline of Llama-width MLP
# stages, and the Llama-3-8B dense engine at tp=4 against one card.
SPMD_MIXTRAL = dict(plan={"ep": 4}, batch=4, seq=2048, layers=2, steps=2)
SPMD_MIXTRAL_REL_TOL = 1e-3       # eager and compiled, from the same state
SPMD_ZOO_STEPS = 2                # after the warm-up: three steps each
SPMD_ZOO_REL_TOL = 1e-3           # the sharded and the one-card losses
SPMD_VIT = dict(plan={"dp": 4}, batch=32)
SPMD_T5 = dict(plan={"dp": 2, "tp": 2})
SPMD_PIPE = dict(m=8, mb=(2, 256), rel_tol=1e-4)   # fp32
SPMD_ENGINE = dict(prompts=4, prompt_len=(96, 400), new_tokens=32,
                   max_len=512, logits_rel_tol=2e-2)


def _recompiles(limit: int = 64):
    """Room for more compiled configurations of one function than
    torch.compile's default allows in one process (this script compiles
    llama.loss_fn at many configurations; fullgraph raises at the limit)."""
    cfg = torch._dynamo.config
    name = ("recompile_limit" if hasattr(cfg, "recompile_limit")
            else "cache_size_limit")
    return cfg.patch(**{name: limit})


def spmd_world1_runs(cfg, batch, seq, seed, plain_first=None,
                     compiled=False):
    """SPMD_STEPS steps of cfg from the seeded state on train_batch's
    batch through the sharded code on a 1 x ... x 1 mesh (the gang this
    process has joined) and, unless `plain_first` holds them already,
    through the unsharded step; eagerly, or both compiled with
    COMPILE_BACKEND. -> (sharded [(loss, grad norm)], plain [(loss, grad
    norm)], launches per sharded step, the sharded run's launches: the
    counts are set to 0 just before it and read just after)."""
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.parallel.mesh import MeshConfig, build_mesh
    from ray_tpu_torch.train import adamw, init_train_state, make_train_step
    from ray_tpu_torch.train.spmd import batch_sharding, shard_local_batch

    data = train_batch(cfg, batch, seq, seed)

    def run(mesh):
        opt = adamw(3e-4, weight_decay=0.0)
        init = functools.partial(llama.init, cfg, torch.Generator(
            device=DEVICE).manual_seed(seed))
        if mesh is None:
            state = init_train_state(init, opt, device=DEVICE)
            batch_in = data
        else:
            state = init_train_state(
                init, opt, device=DEVICE, mesh=mesh,
                param_logical_axes=llama.param_logical_axes(cfg))
            batch_in = shard_local_batch(
                {k: v.cpu().numpy() for k, v in data.items()},
                batch_sharding(mesh), mesh, torch.device(DEVICE))
        step = make_train_step(functools.partial(
            llama.loss_fn, config=cfg, mesh=mesh), opt, compiled=compiled,
            backend=COMPILE_BACKEND)
        out, launches = [], []
        reset_kernel_counts()
        for _ in range(SPMD_STEPS):
            before = kernel_counts()
            state, m = step(state, batch_in)
            out.append((float(m["loss"]), float(m["grad_norm"])))
            after = kernel_counts()
            launches.append({k: after[k] - before[k] for k in after})
        total = kernel_counts()
        del state
        gc.collect()
        torch.cuda.empty_cache()
        return out, launches, total

    mesh = build_mesh(MeshConfig())
    sharded, launches, total = run(mesh)
    plain = plain_first if plain_first is not None else run(None)[0]
    return sharded, plain, launches, total


def phase_spmd_world1(eager_first=None):
    """(l-1): a world-1 gang on the card (NCCL; gloo in a CPU rehearsal):
    the tiny fp32 config and the bench configuration through the sharded
    code on a 1 x ... x 1 mesh against the unsharded step from the same
    state, with (h)'s launches a step, eagerly and then compiled
    (`phase_spmd_world1_compiled`); the tiny Mixtral, ViT and T5 sharded
    steps against their unsharded ones; the dense engine with mesh= at tp=1
    against the engine without. eager_first: (h)'s first SPMD_STEPS (loss,
    grad norm), from the same seed and batch. -> the kernel launches of the
    sharded steps by path ("spmd": eager, "spmd_compiled", "zoo_mesh"; the
    unsharded ones they are held to do not count)."""
    import tempfile

    from ray_tpu_torch.train import backend

    store = tempfile.mkdtemp(prefix="chip_smoke_gang_")
    backend.init_process_group(0, 1, f"file://{store}/store", DEVICE)
    try:
        cfg = tiny_train_config()
        got, want, _, tiny_total = spmd_world1_runs(cfg, 2, 64, seed=5)
        rel = max(abs(a - b) / abs(b) for x, y in zip(got, want)
                  for a, b in zip(x, y))
        log(f"[l-1] tiny fp32, world-1 mesh, {SPMD_STEPS} steps: (loss, "
            f"grad norm) {got} vs unsharded {want}: rel {rel:.3e}")
        check(rel <= SPMD_TINY_REL_TOL, "the sharded tiny step on a world-1 "
              "mesh differs from the unsharded one")
        cfg = bench_config()
        t0 = time.perf_counter()
        got, want, launches, total = spmd_world1_runs(
            cfg, TRAIN_ATTN[0], TRAIN_ATTN[1], seed=3, plain_first=eager_first)
        secs = time.perf_counter() - t0
        rel_loss = max(abs(a[0] - b[0]) / abs(b[0]) for a, b in zip(got, want))
        rel_norm = max(abs(a[1] - b[1]) / abs(b[1]) for a, b in zip(got, want))
        want_launch = {"flash_fwd": 2 * cfg.n_layers,
                       "flash_bwd_dq": cfg.n_layers,
                       "flash_bwd_dkv": cfg.n_layers}
        log(f"[l-1] bench config (B={TRAIN_ATTN[0]} S={TRAIN_ATTN[1]}, bf16, "
            f"eager {cfg.remat_policy}), world-1 mesh, {SPMD_STEPS} steps in "
            f"{secs:.1f} s: {got} vs unsharded {want}: rel loss "
            f"{rel_loss:.3e}, grad norm {rel_norm:.3e}; launches a step "
            f"{launches}")
        check(rel_loss <= SPMD_LOSS_REL_TOL and rel_norm <= SPMD_NORM_REL_TOL,
              "the sharded bench step on a world-1 mesh differs from the "
              "unsharded one")
        check(all(x == want_launch for x in launches),
              f"sharded launches a step {launches}, not {want_launch}")
        compiled = phase_spmd_world1_compiled()
        zoo = phase_spmd_world1_zoo(seed=21)
        phase_spmd_world1_engine(seed=22)
    finally:
        backend.destroy_process_group()
    return {"spmd": {k: tiny_total[k] + total[k] for k in total},
            "spmd_compiled": compiled, "zoo_mesh": zoo}


def phase_spmd_world1_compiled():
    """(l-1), compiled: the sharded step compiled (one program over the
    DTensor parameters, one for the norm and the update) against the
    compiled unsharded step from the same state, the tiny fp32 config and
    the bench widths at SPMD_COMPILED_LAYERS layers, with 2L / L / L
    launches a step. -> the compiled sharded runs' launches."""
    import dataclasses

    t0 = time.perf_counter()
    with _recompiles():
        cfg = tiny_train_config()
        got, want, _, tiny_total = spmd_world1_runs(cfg, 2, 64, seed=5,
                                                    compiled=True)
        rel = max(abs(a - b) / abs(b) for x, y in zip(got, want)
                  for a, b in zip(x, y))
        log(f"[l-1] compiled ({COMPILE_BACKEND}) tiny fp32, world-1 mesh, "
            f"{SPMD_STEPS} steps: (loss, grad norm) {got} vs the compiled "
            f"unsharded step {want}: rel {rel:.3e}")
        check(rel <= SPMD_COMPILED_TINY_REL_TOL, "the compiled sharded tiny "
              "step on a world-1 mesh differs from the compiled unsharded one")
        cfg = dataclasses.replace(bench_config(),
                                  n_layers=SPMD_COMPILED_LAYERS)
        got, want, launches, total = spmd_world1_runs(
            cfg, TRAIN_ATTN[0], TRAIN_ATTN[1], seed=3, compiled=True)
    secs = time.perf_counter() - t0
    rel_loss = max(abs(a[0] - b[0]) / abs(b[0]) for a, b in zip(got, want))
    rel_norm = max(abs(a[1] - b[1]) / abs(b[1]) for a, b in zip(got, want))
    want_launch = {"flash_fwd": 2 * cfg.n_layers,
                   "flash_bwd_dq": cfg.n_layers,
                   "flash_bwd_dkv": cfg.n_layers}
    log(f"[l-1] compiled ({COMPILE_BACKEND}) bench widths cut to {cfg.n_layers} "
        f"layer(s) (B={TRAIN_ATTN[0]} S={TRAIN_ATTN[1]}, bf16, "
        f"{cfg.remat_policy}), world-1 mesh, {SPMD_STEPS} steps: {got} vs "
        f"the compiled unsharded step {want}: rel loss {rel_loss:.3e}, grad "
        f"norm {rel_norm:.3e}; launches a step {launches}")
    log(f"[l-1] the compiled sharded checks (four compiles) added "
        f"{secs:.1f} s")
    check(rel_loss <= SPMD_LOSS_REL_TOL and rel_norm <= SPMD_NORM_REL_TOL,
          "the compiled sharded bench step on a world-1 mesh differs from "
          "the compiled unsharded one")
    check(all(x == want_launch for x in launches),
          f"compiled sharded launches a step {launches}, not {want_launch}")
    return {k: tiny_total[k] + total[k] for k in total}


def world1_zoo_runs(family, cfg, batch_np, logical, compiled, seed):
    """SPMD_STEPS steps of the port's `family` model from the seeded state
    through its sharded code on a 1 x ... x 1 mesh and through the
    unsharded step (both compiled with COMPILE_BACKEND, or both eager).
    -> (sharded [(loss, grad norm)], plain [...], the sharded run's
    launches: set to 0 just before it and read just after)."""
    import importlib

    from ray_tpu_torch.parallel.mesh import MeshConfig, build_mesh
    from ray_tpu_torch.parallel.sharding import LogicalAxisRules
    from ray_tpu_torch.train import adamw, init_train_state, make_train_step
    from ray_tpu_torch.train.spmd import shard_local_batch

    mod = importlib.import_module(f"ray_tpu_torch.models.{family}")
    mesh = build_mesh(MeshConfig())
    rules = LogicalAxisRules()
    runs, total = {}, None
    for m in (mesh, None):
        opt = adamw(TINY_LR, weight_decay=0.0)
        init = functools.partial(mod.init, cfg, torch.Generator(
            device=DEVICE).manual_seed(seed))
        if m is None:
            state = init_train_state(init, opt, device=DEVICE)
            batch = {k: torch.as_tensor(v, device=DEVICE)
                     for k, v in batch_np.items()}
        else:
            state = init_train_state(
                init, opt, device=DEVICE, mesh=m,
                param_logical_axes=mod.param_logical_axes(cfg))
            batch = {k: shard_local_batch({k: v}, rules.to_physical(
                logical[k], m), m, torch.device(DEVICE))[k]
                for k, v in batch_np.items()}
        step = make_train_step(functools.partial(mod.loss_fn, config=cfg,
                                                 mesh=m), opt,
                               compiled=compiled, backend=COMPILE_BACKEND)
        reset_kernel_counts()
        out = []
        for _ in range(SPMD_STEPS):
            state, metrics = step(state, batch)
            out.append((float(metrics["loss"]), float(metrics["grad_norm"])))
        if m is not None:
            total = kernel_counts()
        runs[m is not None] = out
        del state, step
    return runs[True], runs[False], total


def phase_spmd_world1_zoo(seed):
    """(l-1), the zoo on the mesh: the tiny fp32 Mixtral (compiled, its MoE
    on JAX's token partition), ViT and T5 (eager, as their one-device
    steps run) through their sharded code on a 1 x ... x 1 mesh against
    their unsharded steps from the same state. -> Mixtral's sharded
    launches."""
    import dataclasses

    from ray_tpu_torch.models import mixtral, t5, vit

    rng = np.random.default_rng(seed)
    toks = rng.integers(0, 512, (2, 65))
    cases = [
        ("Mixtral", "mixtral", dataclasses.replace(
            mixtral.MixtralConfig.tiny(), dtype=torch.float32),
         {"inputs": toks[:, :-1], "targets": toks[:, 1:]},
         {"inputs": ("batch", "seq"), "targets": ("batch", "seq")}, True),
        ("ViT", "vit", vit.ViTConfig.tiny(),
         {"images": rng.standard_normal((4, 32, 32, 3)).astype(np.float32),
          "labels": rng.integers(0, 10, 4)},
         {"images": ("batch", None, None, None), "labels": ("batch",)},
         False),
        ("T5", "t5", t5.T5Config.tiny(vocab_size=128), _tiny_t5(),
         {"src": ("batch", None), "tgt": ("batch", None)}, False),
    ]
    counts = None
    with _recompiles():
        for tag, family, cfg, batch, logical, compiled in cases:
            got, want, total = world1_zoo_runs(family, cfg, batch, logical,
                                               compiled, seed)
            rel = max(abs(a - b) / abs(b) for x, y in zip(got, want)
                      for a, b in zip(x, y))
            tol = ZOO_MESH_COMPILED_REL_TOL if compiled else SPMD_TINY_REL_TOL
            form = f"compiled ({COMPILE_BACKEND})" if compiled else "eager"
            log(f"[l-1] tiny {tag} fp32 {form}, world-1 mesh, {SPMD_STEPS} "
                f"steps: (loss, grad norm) {got} vs unsharded {want}: rel "
                f"{rel:.3e}")
            check(rel <= tol, f"the sharded tiny {tag} step on a world-1 "
                  "mesh differs from the unsharded one")
            if family == "mixtral":
                counts = total
    return counts


def phase_spmd_world1_engine(seed):
    """(l-1), the dense engine with mesh= (tp=1, no CUDA graph by rule)
    against the engine without it (its decode a CUDA graph on the card),
    the tiny fp32 config: the same greedy tokens."""
    import dataclasses

    from ray_tpu_torch.inference import GenerationConfig, InferenceEngine
    from ray_tpu_torch.inference.engine import shard_params_for_inference
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.parallel.mesh import MeshConfig, build_mesh

    cfg = dataclasses.replace(llama.LlamaConfig.tiny(), dtype=torch.float32)
    params = llama.init(cfg, torch.Generator(device=DEVICE).manual_seed(seed),
                        device=DEVICE)
    e = ENGINE_MESH
    prompts = [list(p) for p in e["prompts"]]
    gen = GenerationConfig(max_new_tokens=e["new_tokens"])
    kw = dict(max_batch=e["max_batch"], max_len=e["max_len"], device=DEVICE)
    plain = InferenceEngine(params, cfg, **kw).generate(prompts, gen)
    mesh = build_mesh(MeshConfig())
    eng = InferenceEngine(shard_params_for_inference(params, cfg, mesh), cfg,
                          mesh=mesh, **kw)
    sharded = eng.generate(prompts, gen)
    log(f"[l-1] dense engine, tiny fp32, mesh= at tp=1 (CUDA graph "
        f"{eng._decoder.use_graph}): streams {sharded} vs without mesh "
        f"{plain}: identical {sharded == plain}")
    check(sharded == plain, "the dense engine with mesh= differs from the "
          "engine without it")


def phase_spmd_cpu_ranks(n_cards):
    """(l-2): with fewer than SPMD_CARDS cards, the 4-rank dry run on gloo
    CPU ranks (NCCL takes one rank a card)."""
    from ray_tpu_torch import graft_entry

    log(f"[l-2] this machine has {n_cards} GPU(s); the {SPMD_CARDS}-rank "
        "dry run runs on CPU ranks")
    t0 = time.perf_counter()
    lines = graft_entry.dryrun_multichip(SPMD_CARDS, device="cpu")
    check(lines[-1].endswith("all multichip checks passed"),
          "the CPU-rank dry run did not pass")
    log(f"[l-2] the CPU-rank dry run took {time.perf_counter() - t0:.1f} s")


def spmd_tokens(cfg, batch, seq, seed):
    """A global batch of random tokens [batch, seq + 1] from `seed`."""
    return np.random.default_rng(seed).integers(0, cfg.vocab_size,
                                                (batch, seq + 1))


def log_mesh_run(tag, cfg, res, batch, seq, flops_per_token=None):
    """Step ms, tok/s a GPU, MFU and peak memory per rank of a mesh run
    (flops_per_token: the model's, Llama's by default)."""
    step_s = max(r["step_s"] for r in res)
    tok_s = batch * seq / step_s / len(res)
    from ray_tpu_torch.models import llama

    flops = (flops_per_token or llama.flops_per_token)(cfg, seq)
    mfu = flops * tok_s / PEAKS[0]
    peaks = [r["peak_gib"] and round(r["peak_gib"], 2) for r in res]
    log(f"[{tag}] {len(res)} GPUs: {step_s * 1e3:.2f} ms a step, {tok_s:.1f} "
        f"tok/s per GPU, MFU {mfu:.4f}; peak GiB per GPU {peaks}; losses "
        f"{[round(x, 4) for x in res[0]['losses']]}; collectives ms (rank 0, "
        f"one step) {res[0].get('collectives_ms')}; warm-up step (with any "
        f"compile) {max(r.get('compile_s', 0.0) for r in res):.1f} s")
    check(all(np.isfinite(r["losses"]).all() for r in res),
          f"{tag}: a non-finite loss")
    return {"ms": step_s * 1e3, "tok_s_per_gpu": tok_s, "mfu": mfu,
            "peak_gib": [r["peak_gib"] for r in res]}


def first_step_rel(a, b):
    """(relative loss, relative grad norm) of two runs' first steps, which
    start from the same state."""
    return (abs(a["losses"][0] - b["losses"][0]) / abs(b["losses"][0]),
            abs(a["grad_norms"][0] - b["grad_norms"][0])
            / abs(b["grad_norms"][0]))


def add_launches(total, ranks):
    """Add the ranks' per-step launches to `total` in place."""
    for x in ranks:
        for k in total:
            total[k] += sum(s[k] for s in x["launches"])


def check_ring_launches(tag, cfg, ranks, sp):
    """Each rank's flash launches a step: rank r sits at sp coordinate
    r % sp; under causal it visits its own block and every earlier one,
    under remat "dots" twice."""
    for rank, x in enumerate(ranks):
        c = rank % sp + 1
        want = {"flash_fwd": 2 * cfg.n_layers * c,
                "flash_bwd_dq": cfg.n_layers * c,
                "flash_bwd_dkv": cfg.n_layers * c}
        log(f"[l-3] {tag} rank {rank} (sp {rank % sp}): launches a step "
            f"{x['launches'][0]}, want {want}")
        check(all(s == want for s in x["launches"]),
              f"{tag} rank {rank} launched {x['launches']}, not {want}")


def cards_bench(n, launches):
    """(l-3) spmd_bench at fsdp=2 x tp=2: the 1-GPU compiled step, and the
    compiled and eager sharded steps from the same state side by side."""
    from ray_tpu_torch.train import spmd_bench

    res = spmd_bench.run(n, steps=SPMD_BENCH_STEPS, device=DEVICE,
                         compiled=True)
    log(f"[l-3] spmd_bench {json.dumps(res)}")
    det = res["detail"]
    check(det["loss_max_rel_diff"] <= SPMD_BENCH_LOSS_REL_TOL,
          f"the {n}-GPU trajectory left the 1-GPU one: "
          f"{det['loss_1dev']} vs {det['loss_ndev']}")
    def num(x, spec=".2f"):
        return "-" if x is None else format(x, spec)

    rows = [f"1 GPU compiled {num(det['step_time_ms_1dev'])}, "
            f"{num(det['tokens_per_sec_per_gpu_1dev'], '.1f')}, "
            f"{num(det.get('mfu_1dev'), '.4f')}, 1, "
            f"{num(det.get('peak_gib_1dev'))}, -, "
            f"{num(det['compile_s_1dev'], '.1f')}"]
    for form, r in det["sharded"].items():
        peaks = [g and round(g, 2) for g in r["peak_gib_per_gpu"]]
        rows.append(f"{n} GPUs {form} {num(r['step_time_ms'])}, "
                    f"{num(r['tokens_per_sec_per_gpu'], '.1f')}, "
                    f"{num(r['mfu'], '.4f')}, "
                    f"{num(r['scaling_efficiency'], '.4f')}, {peaks}, "
                    f"{num(r['nccl_ms_rank0'])} / "
                    f"{num(r['compute_ms_rank0'])}, "
                    f"{num(r['compile_s'], '.1f')}")
    log(f"[l-3] table, {det['mesh_axes']} B={det['global_batch']} "
        f"S={det['seq_len']} (form: ms a step, tok/s per GPU, MFU, scaling, "
        f"peak GiB per GPU, NCCL ms / compute ms on rank 0, warm-up s): "
        + "; ".join(rows))
    rel_loss, rel_norm = first_step_rel(det["sharded"]["compiled"],
                                        det["sharded"]["eager"])
    log(f"[l-3] compiled vs eager sharded step, first step from the same "
        f"state: rel loss {rel_loss:.3e}, grad norm {rel_norm:.3e}")
    check(rel_loss <= SPMD_LOSS_REL_TOL and rel_norm <= SPMD_NORM_REL_TOL,
          "the compiled sharded bench step differs from the eager one")


def cards_ring(n, launches):
    """(l-3) the ring at sp=2 x fsdp=2: eager, the same mesh without the
    ring, and compiled, from the same state."""
    import dataclasses

    from ray_tpu_torch.train import spmd_bench
    from ray_tpu_torch.train.backend import launch_gang

    cfg = dataclasses.replace(bench_config(), use_ring_attention=True)
    r = SPMD_RING
    tokens = spmd_tokens(cfg, r["batch"], r["seq"], 11)
    res = launch_gang(spmd_bench.train_run, n, DEVICE, SPMD_TIMEOUT_S, args=(
        cfg, r["plan"], tokens, SPMD_STEPS))
    log_mesh_run(f"l-3 ring {r['plan']} B={r['batch']} S={r['seq']}", cfg,
                 res, r["batch"], r["seq"])
    # The same state and batch on the same mesh without the ring: the
    # ring's bf16 blocks, their merge and its backward against one kernel
    # call per shard.
    flat = launch_gang(spmd_bench.train_run, n, DEVICE, SPMD_TIMEOUT_S, args=(
        dataclasses.replace(cfg, use_ring_attention=False), r["plan"],
        tokens, SPMD_STEPS))
    log_mesh_run(f"l-3 no ring {r['plan']} B={r['batch']} S={r['seq']}", cfg,
                 flat, r["batch"], r["seq"])
    rel_loss = max(abs(a - b) / abs(b) for a, b in zip(
        res[0]["losses"], flat[0]["losses"]))
    rel_norm = max(abs(a - b) / abs(b) for a, b in zip(
        res[0]["grad_norms"], flat[0]["grad_norms"]))
    log(f"[l-3] ring vs no ring, {len(res[0]['losses'])} steps (warm-up "
        f"first): losses {res[0]['losses']} vs {flat[0]['losses']}, grad "
        f"norms {res[0]['grad_norms']} vs {flat[0]['grad_norms']}: rel loss "
        f"{rel_loss:.3e}, grad norm {rel_norm:.3e}")
    check(rel_loss <= SPMD_LOSS_REL_TOL and rel_norm <= SPMD_NORM_REL_TOL,
          "the ring step differs from the same mesh without the ring")
    check_ring_launches("ring", cfg, res, r["plan"]["sp"])
    add_launches(launches["spmd"], res)
    comp = launch_gang(spmd_bench.train_run, n, DEVICE, SPMD_TIMEOUT_S, args=(
        cfg, r["plan"], tokens, SPMD_STEPS, 0, 3e-4, 1, True))
    log_mesh_run(f"l-3 ring compiled {r['plan']} B={r['batch']} "
                 f"S={r['seq']}", cfg, comp, r["batch"], r["seq"])
    rel_loss, rel_norm = first_step_rel(comp[0], res[0])
    log(f"[l-3] compiled ring vs eager ring, first step from the same "
        f"state: rel loss {rel_loss:.3e}, grad norm {rel_norm:.3e}; losses "
        f"{comp[0]['losses']} vs {res[0]['losses']}")
    check(rel_loss <= SPMD_LOSS_REL_TOL and rel_norm <= SPMD_NORM_REL_TOL,
          "the compiled ring step differs from the eager one")
    check_ring_launches("compiled ring", cfg, comp, r["plan"]["sp"])
    add_launches(launches["spmd_compiled"], comp)


def cards_mixtral(n, launches):
    """(l-3) Mixtral at 8x7B widths over ep=4: eager and compiled steps
    from the same state, MFU, peak memory and the all-to-all's device
    ms."""
    import dataclasses

    from ray_tpu_torch.models import mixtral
    from ray_tpu_torch.train import spmd_bench
    from ray_tpu_torch.train.backend import launch_gang

    x = SPMD_MIXTRAL
    cfg = dataclasses.replace(mixtral_config(), n_layers=x["layers"])
    tokens = spmd_tokens(cfg, x["batch"], x["seq"], 17)
    res = launch_gang(spmd_bench.model_forms, n, DEVICE, SPMD_TIMEOUT_S,
                      args=("mixtral", cfg, x["plan"], {
                          "inputs": tokens[:, :-1], "targets": tokens[:, 1:]},
                          spmd_bench.TOKENS, x["steps"]))
    forms = {}
    for form in ("eager", "compiled"):
        ranks = [r[form] for r in res]
        forms[form] = ranks
        log_mesh_run(f"l-3 Mixtral {form} {cfg.n_layers} layers {x['plan']} "
                     f"B={x['batch']} S={x['seq']}", cfg, ranks, x["batch"],
                     x["seq"], mixtral.flops_per_token)
        a2a = {k: v for k, v in (ranks[0].get("collectives_ms") or {}).items()
               if "sendrecv" in k.lower() or "alltoall" in k.lower()}
        log(f"[l-3] Mixtral {form}: the all-to-all's device ms (rank 0, one "
            f"step) {a2a}")
        add_launches(launches["zoo_mesh"], ranks)
    rel = abs(forms["compiled"][0]["losses"][0]
              - forms["eager"][0]["losses"][0]) / abs(
        forms["eager"][0]["losses"][0])
    log(f"[l-3] Mixtral compiled vs eager, first step from the same state: "
        f"rel loss {rel:.3e}")
    check(rel <= SPMD_MIXTRAL_REL_TOL, "the compiled Mixtral ep step differs "
          "from the eager one")


def cards_versus_one(tag, family, cfg, plan, batch_np, logical, items):
    """(l-3) `family`'s sharded eager step on the mesh `plan` against the
    one-card step on the same global batch: three steps each."""
    from ray_tpu_torch.train import spmd_bench
    from ray_tpu_torch.train.backend import launch_gang

    n = SPMD_CARDS
    res = launch_gang(spmd_bench.versus_one, n, DEVICE, SPMD_TIMEOUT_S,
                      args=(family, cfg, plan, batch_np, logical,
                            SPMD_ZOO_STEPS))
    one, ranks = res[0]["one"], [r["mesh"] for r in res]
    step_n = max(r["step_s"] for r in ranks)
    rel = max(abs(a - b) / abs(b) for a, b in zip(ranks[0]["losses"],
                                                  one["losses"]))
    log(f"[l-3] {tag} {plan}, eager, {len(one['losses'])} steps: "
        f"{step_n * 1e3:.2f} ms a step on {n} GPUs ({items / step_n / n:.1f} "
        f"per GPU a second) vs {one['step_s'] * 1e3:.2f} ms on one "
        f"({items / one['step_s']:.1f}); peak GiB per GPU "
        f"{[r['peak_gib'] and round(r['peak_gib'], 2) for r in ranks]} vs "
        f"{one['peak_gib'] and round(one['peak_gib'], 2)}; losses "
        f"{ranks[0]['losses']} vs "
        f"{one['losses']}: rel {rel:.3e}; grad norms "
        f"{ranks[0]['grad_norms']} vs {one['grad_norms']}; collectives ms "
        f"(rank 0, one step) {ranks[0].get('collectives_ms')}")
    check(rel <= SPMD_ZOO_REL_TOL, f"{tag} on the mesh differs from the "
          "one-card step")


def cards_vit(n, launches):
    """(l-3) ViT-B/16 over dp=4 against the one-card step."""
    import dataclasses

    from ray_tpu_torch.models import vit

    rng = np.random.default_rng(19)
    cfg = dataclasses.replace(vit.ViTConfig.base_16(), **VIT_CUT)
    b = SPMD_VIT["batch"]
    batch = {"images": rng.standard_normal(
        (b, cfg.image_size, cfg.image_size, cfg.num_channels)).astype(
            np.float32), "labels": rng.integers(0, cfg.num_classes, b)}
    cards_versus_one("ViT-B/16", "vit", cfg, SPMD_VIT["plan"], batch,
                     {"images": ("batch", None, None, None),
                      "labels": ("batch",)}, b)


def cards_t5(n, launches):
    """(l-3) T5-base over dp=2 x tp=2 against the one-card step."""
    import dataclasses

    from ray_tpu_torch.models import t5

    rng = np.random.default_rng(19)
    cfg = dataclasses.replace(t5.T5Config.base(), **T5_CUT)
    m, s_src, s_tgt = T5_SHAPE
    src = rng.integers(3, cfg.vocab_size, (m, s_src))
    src[::2, s_src * 3 // 4:] = cfg.pad_id
    tgt = rng.integers(3, cfg.vocab_size, (m, s_tgt))
    tgt[:, 0] = 1
    cards_versus_one("T5-base", "t5", cfg, SPMD_T5["plan"],
                     {"src": src, "tgt": tgt},
                     {"src": ("batch", None), "tgt": ("batch", None)},
                     m * (s_tgt - 1))


def cards_pipeline(n, launches):
    """(l-3) a pp=4 pipeline of Llama-width MLP stages (fp32): its output
    and gradients against the one-card sequential composition."""
    from ray_tpu_torch.parallel import gang_cases
    from ray_tpu_torch.train.backend import launch_gang

    cfg = bench_config()
    p = SPMD_PIPE
    res = launch_gang(gang_cases.pipeline_mlp_case, n, DEVICE,
                      SPMD_TIMEOUT_S, args=(cfg.d_model, cfg.d_ff, p["m"],
                                            p["mb"][0] * p["mb"][1], 23))[0]
    log(f"[l-3] pipeline pp={n} of SwiGLU stages {cfg.d_model} x "
        f"{cfg.d_ff} (fp32), {p['m']} microbatches of {p['mb']} tokens: "
        f"forward and backward {res['seconds']:.3f} s; relative L2 error "
        f"against the stages in sequence on one card {res['rel_err']}")
    check(max(res["rel_err"].values()) <= p["rel_tol"],
          "the pipeline's output or gradients differ from the sequential "
          "composition")


def cards_engine(n, launches):
    """(l-3) the Llama-3-8B dense engine at tp=4 against the one-card dense
    engine on the same weights and prompts."""
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.parallel import gang_cases
    from ray_tpu_torch.train.backend import launch_gang

    cfg = llama.LlamaConfig.llama3_8b()
    e = SPMD_ENGINE
    rng = np.random.default_rng(29)
    prompts = [rng.integers(1, cfg.vocab_size, int(rng.integers(
        *e["prompt_len"]))).tolist() for _ in range(e["prompts"])]
    t0 = time.perf_counter()
    res = launch_gang(gang_cases.dense_engine_versus_one, n, DEVICE,
                      SPMD_TIMEOUT_S, args=(cfg, prompts, e["new_tokens"],
                                            e["max_len"], 31))[0]
    log(f"[l-3] Llama-3-8B dense engine tp={n} vs one card, "
        f"{len(prompts)} prompts of {[len(p) for p in prompts]} tokens, "
        f"{e['new_tokens']} new ({time.perf_counter() - t0:.1f} s): prefill "
        f"logits rel L2 {res['logits_rel']:.3e}; first tokens equal "
        f"{res['first_equal']}; tokens that agree before the first "
        f"divergence {res['agree_before_divergence']} of {e['new_tokens']}"
        f"; one card's own logits, each prompt prefilled alone against the "
        f"batch: rel L2 {res['alone_rel']:.3e}; per layer, the residual "
        f"stream's rel L2 from one card's "
        f"{[float(f'{x:.3e}') for x in res['stream_rel']]}, and the layer's "
        f"own update given one card's input "
        f"{[float(f'{x:.3e}') for x in res['layer_rel']]}")
    check(res["first_equal"] and res["logits_rel"] <= e["logits_rel_tol"],
          "the tp=4 dense engine differs from the one-card engine")


def cards_llama8b(n, launches):
    """(l-3) Llama-3-8B at its full 32 layers over fsdp=4: the eager step,
    then the compiled step from the same state."""
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.train import spmd_bench
    from ray_tpu_torch.train.backend import launch_gang

    cfg = llama.LlamaConfig.llama3_8b()
    f = SPMD_FULL
    tokens = spmd_tokens(cfg, f["batch"], f["seq"], 13)
    res = launch_gang(spmd_bench.model_forms, n, DEVICE, 2 * SPMD_TIMEOUT_S,
                      args=("llama", cfg, f["plan"], {
                          "inputs": tokens[:, :-1], "targets": tokens[:, 1:]},
                          spmd_bench.TOKENS, f["steps"]))
    for form, path, tag in (("eager", "spmd", ""),
                            ("compiled", "spmd_compiled", " compiled")):
        ranks = [r[form] for r in res]
        log_mesh_run(f"l-3 Llama-3-8B{tag} {cfg.n_layers} layers "
                     f"{f['plan']} B={f['batch']} S={f['seq']}", cfg, ranks,
                     f["batch"], f["seq"])
        add_launches(launches[path], ranks)
    rel_loss, rel_norm = first_step_rel(res[0]["compiled"], res[0]["eager"])
    log(f"[l-3] Llama-3-8B compiled vs eager, first step from the same "
        f"state: rel loss {rel_loss:.3e}, grad norm {rel_norm:.3e}")
    check(rel_loss <= SPMD_LOSS_REL_TOL and rel_norm <= SPMD_NORM_REL_TOL,
          "the compiled Llama-3-8B step differs from the eager one")


def phase_spmd_cards():
    """(l-3): on SPMD_CARDS cards, one rank a card over NCCL: the dry run,
    then each part in turn (a part that fails is logged and the next one
    runs; the phase fails at its end): spmd_bench (fsdp=2 x tp=2, the
    compiled and the eager sharded step against the 1-GPU compiled step),
    the ring (sp=2 x fsdp=2) eager, without the ring and compiled with
    launches per rank, Mixtral over ep=4, ViT-B/16 over dp=4 and T5-base
    over dp=2 x tp=2 against one card, the pp=4 pipeline's gradients, the
    Llama-3-8B dense engine at tp=4 against one card, and Llama-3-8B at
    full depth over fsdp=4, eager and compiled. -> the ranks' kernel
    launches by path (reference runs do not count)."""
    import traceback

    from ray_tpu_torch import graft_entry

    n = SPMD_CARDS
    t0 = time.perf_counter()
    lines = graft_entry.dryrun_multichip(n, device=DEVICE)
    check(lines[-1].endswith("all multichip checks passed"),
          "the NCCL dry run did not pass")
    log(f"[l-3] the NCCL dry run on {n} cards took "
        f"{time.perf_counter() - t0:.1f} s")
    launches = spmd_launches()
    failed = []
    for part in CARDS_PARTS:
        t0 = time.perf_counter()
        try:
            part(n, launches)
        except Exception as e:  # noqa: BLE001 - logged, and fails the phase
            failed.append(part.__name__)
            log(f"[l-3] {part.__name__} FAILED: {e!r}\n"
                + traceback.format_exc())
        log(f"[l-3] {part.__name__}: {time.perf_counter() - t0:.1f} s")
    check(not failed, f"(l-3) parts failed: {failed}")
    return launches


CARDS_PARTS = (cards_bench, cards_ring, cards_mixtral, cards_vit, cards_t5,
               cards_pipeline, cards_engine, cards_llama8b)


def spmd_launches():
    """Zero launch counts for each of (l)'s paths."""
    return {path: {k: 0 for k in kernel_counts()}
            for path in ("spmd", "spmd_compiled", "zoo_mesh")}


def phase_spmd_part(name):
    """One (l-3) part alone (`--only l --part NAME`, e.g. to measure it
    again): cards_NAME on SPMD_CARDS cards. -> its launches by path."""
    part = {p.__name__: p for p in CARDS_PARTS}[f"cards_{name}"]
    n_cards = torch.cuda.device_count()
    check(n_cards >= SPMD_CARDS, f"(l-3) part {name} needs {SPMD_CARDS} "
          f"cards; {n_cards} visible")
    launches = spmd_launches()
    t0 = time.perf_counter()
    part(SPMD_CARDS, launches)
    log(f"[l-3] {part.__name__}: {time.perf_counter() - t0:.1f} s")
    return launches


def phase_spmd(eager_first=None):
    """(l): the SPMD path. -> the kernel launches of its main paths."""
    n_cards = torch.cuda.device_count()
    branch = "(l-3)" if n_cards >= SPMD_CARDS else "(l-2)"
    log(f"[l] {n_cards} GPU(s) visible: (l-1), then {branch}")
    launches = phase_spmd_world1(eager_first)
    if n_cards >= SPMD_CARDS:
        for path, counts in phase_spmd_cards().items():
            for k, v in counts.items():
                launches[path][k] += v
    else:
        phase_spmd_cpu_ranks(n_cards)
    log(f"[l] launches on the SPMD paths: {launches}")
    return launches


# -- (m) RLlib's one-process path ---------------------------------------------

# (m-1): the Nature CNN (ConvActorCriticModule's defaults) on
# make_atari_env's frames, one minibatch of PPO's defaults
# (minibatch_size 128, lr 5e-5).
RL_OBS_SHAPE = (84, 84, 4)
RL_NUM_ACTIONS = 6
RL_MINIBATCH = 128
RL_TIMED_UPDATES = 20
# The card against the CPU in fp32 with TF32 off (main() turns it off for
# cuBLAS and cuDNN; the port flips no flag itself): losses, metrics and
# outputs |a - b| <= RL_ATOL + RL_RTOL * |b|; gradients within RL_GRAD_TOL
# of their tensor's largest; parameters after an update within
# RL_PARAM_TOL of their tensor's largest, except where the CPU's gradient
# is under RL_TINY_GRAD of its tensor's largest: Adam's first step there
# is lr * g / (|g| + 1e-8), whose sign is rounding.
RL_ATOL, RL_RTOL = 1e-5, 1e-4
RL_GRAD_TOL = 1e-4
RL_PARAM_TOL = 1e-5
RL_TINY_GRAD = 1e-6
# (m-3): PPO on CartPole under tests/test_rllib.py's settings, its best
# return over `iterations` above `target`; PPO at its defaults on the
# synthetic image env at 84x84 with `num_envs` envs (`training` overrides
# only in a rehearsal); benchmark_env_steps with the Nature CNN.
RL_CARTPOLE = dict(iterations=15, target=60.0)
RL_IMAGE = dict(size=84, num_envs=8, iterations=2, training={})
RL_BENCH = dict(num_envs=8, steps=256)


def rl_close(tag, got, want):
    """Metrics or outputs (dicts of floats, arrays or tensors) of the card
    against the CPU's; -> the largest absolute difference."""
    worst = 0.0
    for k, w in want.items():
        a = np.asarray(got[k].detach().cpu() if torch.is_tensor(got[k])
                       else got[k], np.float64)
        b = np.asarray(w.detach().cpu() if torch.is_tensor(w) else w,
                       np.float64)
        err = float(np.max(np.abs(a - b))) if a.size else 0.0
        check(a.shape == b.shape and bool(np.all(
            np.abs(a - b) <= RL_ATOL + RL_RTOL * np.abs(b))),
            f"{tag} {k}: card {a.ravel()[:4]} vs cpu {b.ravel()[:4]}")
        worst = max(worst, err)
    return worst


def rl_pair(make):
    """The learner built on the card and on the CPU from one seed: the same
    weights (drawn on the CPU) on both."""
    pair = {"card": make(DEVICE), "cpu": make("cpu")}
    for (n, p), (_, q) in zip(pair["card"].module.named_parameters(),
                              pair["cpu"].module.named_parameters()):
        check(torch.equal(p.detach().cpu(), q.detach()), f"init of {n}")
    return pair


def rl_loss(learner, batch, noise=None):
    """(loss, metrics) of the learner on a numpy batch (SAC: with its
    noise)."""
    if noise is None:
        return learner.compute_metrics(batch)
    from ray_tpu_torch.rllib.learner import batch_to_device

    eps = [torch.from_numpy(n).to(learner.device) for n in noise]
    loss, metrics = learner.losses(batch_to_device(batch, learner.device),
                                   *eps)
    return loss, dict(metrics, total_loss=loss)


def rl_update_check(tag, make, batch, noise=None):
    """One update on the card against the CPU from the same state and
    batch: loss, metrics and gradients first, then the update's metrics
    and the parameters after it. -> largest difference of the outputs."""
    pair = rl_pair(make)
    grads, first = {}, {}
    for side, learner in pair.items():
        params = list(learner.module.parameters())
        loss, first[side] = rl_loss(learner, batch, noise)
        g = torch.autograd.grad(loss, params, allow_unused=True)
        grads[side] = [torch.zeros_like(p) if x is None else x.detach()
                       for p, x in zip(params, g)]
    worst = rl_close(f"{tag} loss", first["card"], first["cpu"])
    names = [n for n, _ in pair["cpu"].module.named_parameters()]
    for n, a, b in zip(names, grads["card"], grads["cpu"]):
        scale = float(b.abs().max()) or 1.0
        check(float((a.cpu() - b).abs().max()) <= RL_GRAD_TOL * scale,
              f"{tag} gradient of {n}")
    kw = {} if noise is None else {"noise": noise}
    out = {side: l.update_from_batch(batch, **kw) for side, l in pair.items()}
    worst = max(worst, rl_close(f"{tag} update", out["card"], out["cpu"]))
    signs = {}
    for (n, p), (_, q), g in zip(pair["card"].module.named_parameters(),
                                 pair["cpu"].module.named_parameters(),
                                 grads["cpu"]):
        diff = (p.detach().cpu() - q.detach()).abs()
        bad = diff > RL_PARAM_TOL * float(q.detach().abs().max())
        tiny = g.abs() <= RL_TINY_GRAD * float(g.abs().max())
        check(not bool((bad & ~tiny).any()),
              f"{tag} parameter {n} after the update: "
              f"{float(diff.max()):.3e}")
        if bool((bad & tiny).any()):
            signs[n] = f"{int((bad & tiny).sum())} of {q.numel()}"
    log(f"[m] {tag}: card vs cpu, largest difference {worst:.3e}; "
        f"parameter entries off by Adam's sign step (gradient under "
        f"{RL_TINY_GRAD:g} of its tensor's largest): {signs or 'none'}")
    return worst


def profile_rl(fn, n):
    """fn() n times under torch.profiler -> (wall ms a call, device-busy ms
    a call, [(CPU operator, device ms a call)] largest first)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / n
    events = prof.key_averages()
    busy = sum(e.self_device_time_total for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3 / n
    ops = sorted(((e.key, e.self_device_time_total / 1e3 / n) for e in events
                  if e.device_type == torch.autograd.DeviceType.CPU
                  and e.self_device_time_total > 0), key=lambda o: -o[1])
    return wall, busy, ops


def log_profile(tag, what, wall, busy, ops, top=6):
    log(f"{tag} {what} under torch.profiler: {wall:.4f} ms wall, "
        f"{busy:.4f} ms device busy (idle share "
        f"{max(0.0, 1 - busy / wall):.3f}); device ms by operator: "
        + ", ".join(f"{k} {v:.4f}" for k, v in ops[:top]))


def conv_flops(module, batch):
    """Forward FLOPs of the conv actor-critic on `batch` observations."""
    h, w, c = module.obs_shape
    flops = 0
    for out_ch, k, s in module.conv_filters:
        h, w = (h - k) // s + 1, (w - k) // s + 1
        flops += 2 * h * w * out_ch * k * k * c
        c = out_ch
    for layer in [*module.torso, module.pi, module.vf]:
        flops += 2 * layer.in_features * layer.out_features
    return batch * flops


def phase_rl_module(card):
    """(m-1) The Nature CNN at full width: forward_train and one PPO update
    on a seeded [RL_MINIBATCH, 84, 84, 4] uint8 minibatch, the card against
    the CPU from the same state; then the update's time on the card
    against its bound and the plain forward."""
    from ray_tpu_torch._private.accelerators.nvidia import (
        fp32_peak_flops_per_device)
    from ray_tpu_torch.rllib.algorithms.ppo import PPOLearner
    from ray_tpu_torch.rllib.learner import batch_to_device

    spec = {"module_class":
            "ray_tpu_torch.rllib.rl_module:ConvActorCriticModule",
            "obs_shape": RL_OBS_SHAPE, "num_actions": RL_NUM_ACTIONS}
    config = {"lr": 5e-5, "seed": 0}  # PPO's defaults
    rng = np.random.default_rng(11)
    n = RL_MINIBATCH
    batch = {"obs": rng.integers(0, 256, (n, *RL_OBS_SHAPE), dtype=np.uint8),
             "actions": rng.integers(0, RL_NUM_ACTIONS, n).astype(np.int32),
             "logp": (-np.log(RL_NUM_ACTIONS)
                      + 0.1 * rng.standard_normal(n)).astype(np.float32),
             "advantages": rng.standard_normal(n).astype(np.float32),
             "value_targets": rng.standard_normal(n).astype(np.float32)}

    def make(dev):
        return PPOLearner(spec, dict(config, device=dev))

    pair = rl_pair(make)
    outs = {}
    for side, learner in pair.items():
        with torch.no_grad():
            outs[side] = learner.module.forward_train(
                batch_to_device(batch, learner.device))
    err = rl_close("(m-1) forward_train", outs["card"], outs["cpu"])
    err = max(err, rl_update_check("(m-1) PPO update, Nature CNN", make,
                                   batch))

    learner = make(DEVICE)
    dev_batch = batch_to_device(batch, learner.device)

    def forward():
        with torch.no_grad():
            learner.module.forward_train(dev_batch)

    def update_device_batch():
        loss, _ = learner.loss_fn(dev_batch)
        learner.apply_gradients(loss)

    fwd_ms = cuda_ms(forward, iters=RL_TIMED_UPDATES)
    upd_ms = cuda_ms(update_device_batch, iters=RL_TIMED_UPDATES)
    loop_ms = cuda_ms(lambda: learner.update_from_batch(batch),
                      iters=RL_TIMED_UPDATES)
    log_profile(f"[m-1] ({card})", "the PPO update on a device batch",
                *profile_rl(update_device_batch, 5))
    # What a process that keeps torch's default gets: cuDNN convolutions
    # in TF32 (matrix products stay fp32).
    torch.backends.cudnn.allow_tf32 = True
    try:
        tf32_ms = cuda_ms(update_device_batch, iters=RL_TIMED_UPDATES)
    finally:
        torch.backends.cudnn.allow_tf32 = False
    params = sum(p.numel() for p in learner.module.parameters())
    flops = 3 * conv_flops(learner.module, n)  # forward + backward
    nbytes = sum(v.nbytes for v in batch.values()) + 8 * 4 * params
    fp32 = fp32_peak_flops_per_device(torch.cuda.get_device_name(0))
    bound_ms = max(flops / fp32, nbytes / PEAKS[1]) * 1e3
    log(f"[m-1] ({card}) Nature CNN {RL_OBS_SHAPE} uint8, {params / 1e6:.3f}"
        f" M params, B={n}, fp32 (TF32 off): forward_train {fwd_ms:.4f} ms;"
        f" PPO update (loss, backward, Adam) on a device batch "
        f"{upd_ms:.4f} ms, from the numpy minibatch as the loop calls it "
        f"(copy in, metrics out) {loop_ms:.4f} ms, with torch's default "
        f"TF32 convolutions {tf32_ms:.4f} ms; bound {bound_ms:.4f} ms "
        f"({flops / 1e9:.2f} GFLOP at {fp32 / 1e12:.0f} TFLOP/s fp32); "
        f"largest card-vs-cpu difference {err:.3e}")
    return {"forward_ms": fwd_ms, "update_ms": upd_ms,
            "update_from_numpy_ms": loop_ms, "update_tf32_conv_ms": tf32_ms,
            "bound_ms": bound_ms,
            "max_abs_err": err}


def phase_rl_learners(card):
    """(m-2) One update of every ported learner on the card against the
    CPU, from the same state and batch, at its algorithm's default batch
    and widths (CartPole's and Pendulum's spaces)."""
    from ray_tpu_torch.rllib.algorithms import cql, dqn, impala, marwil, ppo
    from ray_tpu_torch.rllib.algorithms import sac

    rng = np.random.default_rng(12)

    def f32(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    mlp = {"obs_dim": 4, "num_actions": 2, "hiddens": (64, 64)}
    q = {"obs_dim": 4, "num_actions": 2, "hiddens": (64, 64)}

    def q_batch(n):
        return {"obs": f32(n, 4), "next_obs": f32(n, 4),
                "actions": rng.integers(0, 2, n).astype(np.int32),
                "rewards": f32(n),
                "terminateds": (rng.random(n) < 0.1).astype(np.float32)}

    b, t = 4, 50
    mask = np.ones((b, t), np.float32)
    mask[-1, 20:] = 0
    terms = (rng.random((b, t)) < 0.05).astype(np.float32)
    terms[:, -1] = 1
    cases = {
        "PPO (grad_clip 0.5)": (
            lambda d: ppo.PPOLearner(mlp, {"lr": 5e-5, "grad_clip": 0.5,
                                           "seed": 1, "device": d}),
            {"obs": f32(128, 4), "actions": rng.integers(0, 2, 128),
             "logp": np.full(128, -0.69, np.float32), "advantages": f32(128),
             "value_targets": f32(128)}, None),
        "DQN": (lambda d: dqn.DQNLearner(q, {"lr": 5e-4, "seed": 2,
                                             "device": d}), q_batch(32), None),
        "CQL": (lambda d: cql.CQLLearner(q, {"lr": 5e-4, "seed": 3,
                                             "device": d}),
                q_batch(256), None),
        "MARWIL": (lambda d: marwil.MARWILLearner(mlp, {
            "lr": 1e-3, "seed": 4, "device": d}),
            {"obs": f32(256, 4), "actions": rng.integers(0, 2, 256),
             "returns": 10 * rng.random(256).astype(np.float32)}, None),
        "SAC": (lambda d: sac.SACLearner(3, 1, (256, 256), {
            "lr": 3e-4, "seed": 5, "device": d}),
            {"obs": f32(256, 3), "next_obs": f32(256, 3),
             "actions": np.tanh(f32(256, 1)), "rewards": f32(256),
             "terminateds": np.zeros(256, np.float32)},
            (f32(256, 1), f32(256, 1))),
        "V-trace": (lambda d: impala.VTraceLearner(mlp, {
            "lr": 5e-4, "seed": 6, "device": d}),
            {"obs": f32(b, t, 4), "actions": rng.integers(0, 2, (b, t)),
             "rewards": f32(b, t), "logp": np.full((b, t), -0.69,
                                                   np.float32),
             "terminateds": terms, "mask": mask,
             "bootstrap_value": f32(b)}, None),
    }
    errs = {}
    for name, (make, batch, noise) in cases.items():
        errs[name] = rl_update_check(f"(m-2) {name}", make, batch, noise)
    log(f"[m-2] ({card}) every learner's update on the card matches the "
        f"CPU's: {errs}")
    return errs


def phase_rl_loop(card):
    """(m-3) PPO end to end on the card: CartPole under the JAX test's
    settings (best return above the target), two iterations at PPO's
    defaults on the 84x84 synthetic image env with the Nature CNN, and
    benchmark_env_steps."""
    from ray_tpu_torch.rllib.algorithms import PPOConfig
    from ray_tpu_torch.rllib.benchmarks import benchmark_env_steps
    from ray_tpu_torch.rllib.envs import SYNTHETIC_ENV_ID

    t0 = time.perf_counter()
    algo = (PPOConfig().environment("CartPole-v1")
            .env_runners(num_env_runners=0, num_envs_per_env_runner=4,
                         rollout_fragment_length=128)
            .training(lr=1e-3, train_batch_size=1024, minibatch_size=256,
                      num_epochs=8, entropy_coeff=0.01)
            .debugging(seed=0).resources(device=DEVICE)).build()
    returns = []
    for _ in range(RL_CARTPOLE["iterations"]):
        returns.append(algo.train().get("episode_return_mean", 0.0))
    algo.stop()
    first = next((r for r in returns if r > 0), 0.0)
    log(f"[m-3] ({card}) PPO CartPole-v1 on the card: episode_return_mean "
        f"by iteration {[round(r, 1) for r in returns]}, "
        f"{time.perf_counter() - t0:.1f} s")
    check(max(returns) > RL_CARTPOLE["target"] and max(returns) > first,
          f"PPO did not learn CartPole: best {max(returns):.1f}")

    torch.cuda.reset_peak_memory_stats()
    algo = (PPOConfig().environment(SYNTHETIC_ENV_ID,
                                    env_config={"size": RL_IMAGE["size"]})
            .env_runners(num_env_runners=0,
                         num_envs_per_env_runner=RL_IMAGE["num_envs"])
            .training(**RL_IMAGE["training"])
            .debugging(seed=0).resources(device=DEVICE)).build()
    image = []
    for i in range(RL_IMAGE["iterations"]):
        r = algo.train()
        check(all(np.isfinite(r[k]) for k in ("total_loss", "policy_loss",
                                              "vf_loss", "entropy")),
              f"PPO image iteration {i}: {r}")
        row = {"env_steps_per_s": r["num_env_steps_sampled"]
               / r["sample_seconds"],
               "updates_per_s": r["num_learner_updates"] / r["learn_seconds"],
               "sample_s": r["sample_seconds"], "learn_s": r["learn_seconds"],
               "episode_return_mean": r.get("episode_return_mean")}
        image.append(row)
        log(f"[m-3] ({card}) PPO synthetic {RL_IMAGE['size']}x"
            f"{RL_IMAGE['size']} image env, Nature CNN, PPO defaults, "
            f"{RL_IMAGE['num_envs']} envs, iteration {i + 1}: "
            f"{r['num_env_steps_sampled']} env steps in "
            f"{r['sample_seconds']:.3f} s sampling "
            f"({row['env_steps_per_s']:.1f} env-steps/s), "
            f"{r['num_learner_updates']} updates in {r['learn_seconds']:.3f} s"
            f" learning ({row['updates_per_s']:.1f} updates/s), return "
            f"{row['episode_return_mean']}")
    runner = algo.env_runner_group.local
    wall, busy, ops = profile_rl(lambda: runner.sample(num_steps=16), 2)
    log_profile(f"[m-3] ({card})", "16 vector steps of the image run's "
                f"runner ({RL_IMAGE['num_envs']} envs)", wall, busy, ops)
    algo.stop()
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[m-3] ({card}) peak device memory of the image run {peak:.3f} GiB")
    bench = benchmark_env_steps(
        SYNTHETIC_ENV_ID, env_config={"size": RL_IMAGE["size"]},
        conv_filters=((32, 8, 4), (64, 4, 2), (64, 3, 1)), hiddens=(512,),
        device=DEVICE, **RL_BENCH)
    log(f"[m-3] ({card}) benchmark_env_steps: {json.dumps(bench)}")
    return {"cartpole_returns": returns, "image": image,
            "image_peak_gib": peak, "env_steps_per_s": bench["value"]}


# (m-4): APPO's V-trace update on the Nature CNN at (m-1)'s 128 frames as
# [4, 32] rows; one DreamerV3 train_step at the JAX package's "nano" dims
# (its full width: deter 128, 8 x 8 latents, B=8, T=16, H=10); DreamerV3 on
# CartPole under tests/test_rllib_catalog.py::test_dreamerv3_learns's
# settings (best return >= 60 within 70 iterations); multi-agent PPO with
# two policies on TargetMatch under tests/test_rllib_multi_agent.py's
# learning settings (best return above 8 within 30 iterations).
RL_APPO_ROWS = (4, 32)
RL_DREAMER = dict(iterations=70, target=60.0, training=dict(
    num_steps_per_iteration=200, train_ratio=48, batch_size_B=8,
    batch_length_T=16, horizon_H=10, entropy_coeff=1e-2, actor_lr=5e-5))
RL_MULTI_AGENT = dict(iterations=30, target=8.0, training=dict(
    lr=3e-3, train_batch_size=512, minibatch_size=128, num_epochs=4,
    entropy_coeff=0.0, gamma=0.0))


def _target_match_env():
    """tests/test_rllib_multi_agent.py's TargetMatch on the port's
    MultiAgentEnv: two agents, each sees a one-hot target in {0, 1} and
    gets +1 for the matching action, -1 otherwise; 16 steps an episode."""
    from ray_tpu_torch.rllib import MultiAgentEnv

    class _Space:
        def __init__(self, shape=None, n=None):
            self.shape, self.n = shape, n

    class TargetMatch(MultiAgentEnv):
        possible_agents = ["a0", "a1"]

        def __init__(self, horizon: int = 16):
            self.observation_spaces = {a: _Space(shape=(2,))
                                       for a in self.possible_agents}
            self.action_spaces = {a: _Space(n=2)
                                  for a in self.possible_agents}
            self.horizon = horizon
            self._rng = np.random.default_rng(0)

        def _obs(self):
            self._targets = {a: int(self._rng.integers(2))
                             for a in self.possible_agents}
            return {a: np.eye(2, dtype=np.float32)[t]
                    for a, t in self._targets.items()}

        def reset(self, *, seed=None, options=None):
            if seed is not None:
                self._rng = np.random.default_rng(seed)
            self._t = 0
            return self._obs(), {a: {} for a in self.possible_agents}

        def step(self, action_dict):
            rewards = {a: 1.0 if action_dict[a] == self._targets[a] else -1.0
                       for a in action_dict}
            self._t += 1
            obs = self._obs()
            terms = {a: False for a in action_dict}
            terms["__all__"] = self._t >= self.horizon
            truncs = {a: False for a in action_dict}
            truncs["__all__"] = False
            return obs, rewards, terms, truncs, {a: {} for a in action_dict}

    return TargetMatch


def dreamer_step_check(card):
    """(m-4) One DreamerV3 train_step on the card against the CPU from one
    state (the model drawn on the CPU from one seed), one batch and one
    Gumbel noise: the losses, the three gradients, and the parameters after
    the three Adam steps. -> the largest difference of the losses."""
    from ray_tpu_torch.rllib.algorithms import dreamerv3 as dv3

    cfg = dv3.DreamerV3Config().training(**RL_DREAMER["training"])
    b, t = cfg.batch_size_B, cfg.batch_length_T
    rng = np.random.default_rng(21)
    batch = {"obs": rng.standard_normal((b, t, 4)).astype(np.float32),
             "actions": rng.integers(0, 2, (b, t)),
             "rewards": rng.random((b, t)).astype(np.float32),
             "cont": (rng.random((b, t)) > 0.05).astype(np.float32)}
    sides, grads = {}, {}
    for side, dev in (("card", DEVICE), ("cpu", "cpu")):
        model = dv3.DreamerModel(
            4, 2, deter_dim=cfg.deter_dim, stoch_groups=cfg.stoch_groups,
            stoch_classes=cfg.stoch_classes, embed_dim=cfg.embed_dim,
            hidden_dim=cfg.hidden_dim,
            generator=torch.Generator().manual_seed(0), device=dev)
        learner = dv3.DreamerV3Learner(model, cfg.to_dict())
        seen = grads[side] = {}
        for name, update in list(learner._updates.items()):
            def record(g, state, params, name=name, update=update, seen=seen):
                seen[name] = [x.detach().cpu() for x in g]
                return update(g, state, params)
            learner._updates[name] = record
        sides[side] = (model, learner)
    noise = sides["cpu"][1].draw_noise(b, t, torch.Generator().manual_seed(1))
    out = {side: learner.train_step(
        dv3._to_device(batch, model.wm.gru_h.weight.device),
        {k: v.to(model.wm.gru_h.weight.device) for k, v in noise.items()})
        for side, (model, learner) in sides.items()}
    worst = rl_close("(m-4) DreamerV3 train_step losses", out["card"],
                     out["cpu"])
    signs = {}
    for name in ("wm", "actor", "critic"):
        mods = [getattr(sides[s][0], name) for s in ("card", "cpu")]
        for (n, p), (_, q), gp, gq in zip(
                mods[0].named_parameters(), mods[1].named_parameters(),
                grads["card"][name], grads["cpu"][name]):
            scale = float(gq.abs().max()) or 1.0
            check(float((gp - gq).abs().max()) <= RL_GRAD_TOL * scale,
                  f"(m-4) DreamerV3 gradient of {name}.{n}")
            diff = (p.detach().cpu() - q.detach()).abs()
            bad = diff > RL_PARAM_TOL * float(q.detach().abs().max())
            tiny = gq.abs() <= RL_TINY_GRAD * scale
            check(not bool((bad & ~tiny).any()),
                  f"(m-4) DreamerV3 {name}.{n} after the step: "
                  f"{float(diff.max()):.3e}")
            if bool((bad & tiny).any()):
                signs[f"{name}.{n}"] = int((bad & tiny).sum())
    log(f"[m-4] ({card}) DreamerV3 train_step (B={b} T={t} H="
        f"{cfg.horizon_H}, deter {cfg.deter_dim}, {cfg.stoch_groups} x "
        f"{cfg.stoch_classes} latents) card vs cpu from one state and one "
        f"noise: losses {out['cpu']}, largest difference {worst:.3e}; "
        f"parameter entries off by Adam's sign step: {signs or 'none'}")
    return worst


def dreamer_learns(card):
    """(m-4) DreamerV3 on the port's CartPole on the card under
    test_dreamerv3_learns's settings: the best return, the seconds per
    iteration and the share of them in train_step."""
    from ray_tpu_torch.rllib.algorithms import dreamerv3 as dv3

    algo = (dv3.DreamerV3Config().environment("CartPole-v1")
            .training(**RL_DREAMER["training"]).debugging(seed=0)
            .resources(device=DEVICE)).build()
    spent = [0.0]
    train_step = algo.train_step

    def timed(*a, **kw):
        t0 = time.perf_counter()
        out = train_step(*a, **kw)
        spent[0] += time.perf_counter() - t0
        return out
    algo.train_step = timed
    best, returns = 0.0, []
    t0 = time.perf_counter()
    for _ in range(RL_DREAMER["iterations"]):
        r = algo.train()
        returns.append(round(r.get("episode_return_mean", 0.0), 1))
        best = max(best, returns[-1])
        if best >= RL_DREAMER["target"]:
            break
    wall = time.perf_counter() - t0
    algo.stop()
    per_it = wall / len(returns)
    log(f"[m-4] ({card}) DreamerV3 CartPole-v1 on the card: "
        f"episode_return_mean by iteration {returns}; best {best} after "
        f"{len(returns)} iterations, {per_it:.3f} s an iteration, "
        f"{spent[0] / wall:.3f} of it in train_step ("
        f"{spent[0] / max(1, algo.learner.opt_state['wm'].count) * 1e3:.2f}"
        f" ms a train_step)")
    check(best >= RL_DREAMER["target"],
          f"DreamerV3 never beat random: best {best}")
    return {"returns": returns, "best": best, "s_per_iteration": per_it,
            "train_step_share": spent[0] / wall}


def multi_agent_learns(card):
    """(m-4) MultiAgentPPO with two policies (one per agent) on TargetMatch
    on the card: the best mean episode return."""
    from ray_tpu_torch.rllib import MultiAgentPPOConfig

    algo = (MultiAgentPPOConfig().environment(_target_match_env())
            .training(**RL_MULTI_AGENT["training"])
            .multi_agent(policies=["p0", "p1"],
                         policy_mapping_fn=lambda aid:
                         "p0" if aid == "a0" else "p1")
            .debugging(seed=0).resources(device=DEVICE)).build()
    returns = []
    t0 = time.perf_counter()
    for _ in range(RL_MULTI_AGENT["iterations"]):
        r = algo.train()
        check("p0" in r and "p1" in r, f"a policy did not train: {list(r)}")
        returns.append(round(r.get("episode_return_mean", -np.inf), 2))
        if max(returns) > RL_MULTI_AGENT["target"]:
            break
    algo.stop()
    log(f"[m-4] ({card}) MultiAgentPPO, two policies, TargetMatch on the "
        f"card: episode_return_mean by iteration {returns}, "
        f"{time.perf_counter() - t0:.1f} s")
    check(max(returns) > RL_MULTI_AGENT["target"],
          f"multi-agent PPO did not learn: best {max(returns)}")
    return returns


def phase_rl_more(card):
    """(m-4) APPO, DreamerV3 and multi-agent PPO on the card."""
    from ray_tpu_torch.rllib.algorithms.impala import VTraceLearner

    b, t = RL_APPO_ROWS
    rng = np.random.default_rng(13)
    spec = {"module_class":
            "ray_tpu_torch.rllib.rl_module:ConvActorCriticModule",
            "obs_shape": RL_OBS_SHAPE, "num_actions": RL_NUM_ACTIONS}
    terms = (rng.random((b, t)) < 0.05).astype(np.float32)
    terms[:, -1] = 1
    batch = {"obs": rng.integers(0, 256, (b, t, *RL_OBS_SHAPE),
                                 dtype=np.uint8),
             "actions": rng.integers(0, RL_NUM_ACTIONS, (b, t)),
             "rewards": rng.standard_normal((b, t)).astype(np.float32),
             # far from the policy's, so that the clip bites
             "logp": np.full((b, t), -3.0, np.float32),
             "terminateds": terms, "mask": np.ones((b, t), np.float32),
             "bootstrap_value": rng.standard_normal(b).astype(np.float32)}
    appo = rl_update_check(
        "(m-4) APPO V-trace update, Nature CNN",
        lambda d: VTraceLearner(spec, {"lr": 5e-4, "appo_clip": True,
                                       "clip_param": 0.2, "seed": 7,
                                       "device": d}), batch)
    return {"appo_max_abs_err": appo,
            "dreamer_max_abs_err": dreamer_step_check(card),
            "dreamer": dreamer_learns(card),
            "multi_agent_returns": multi_agent_learns(card)}


def phase_rl(card):
    """(m) RLlib's one-process path: (m-1), (m-2), (m-3), (m-4)."""
    t0 = time.perf_counter()
    out = {"module": phase_rl_module(card),
           "learners": phase_rl_learners(card),
           "loop": phase_rl_loop(card),
           "more": phase_rl_more(card)}
    log(f"[m] RLlib's one-process path: {time.perf_counter() - t0:.1f} s")
    return out


# -- (n) ---------------------------------------------------------------------

# (n-1): the compiled Llama step at the bench configuration fed by the feed.
FEED_STEPS = 12
FEED_PREFETCH = 1
# The compiled step is not bit-for-bit repeatable from the same state and
# batches: two runs drift apart from the fourth step on (~1e-5 relative by
# the twelfth; scatter-adds of the gradient accumulate in no fixed order).
# The first step's loss is compared exactly, the rest to this.
FEED_LOSS_REL_TOL = 1e-4
# (n-2): ViT-B/16 fed uint8 crops of a pool of source images (labels from 10
# classes, so the loss falls as the head learns them), and the stream race.
VIT_FEED_STEPS = 10
VIT_FEED_POOL = 64
VIT_FEED_SOURCE = 256
VIT_FEED_CLASSES = 10
RACE_BATCHES = 200
RACE_PREFETCH = (1, 2)
RACE_SLEEP_CYCLES = 2_000_000  # about 1 ms of the card's clock


def long_kernel():
    """A kernel that keeps the consumer's stream busy for about 1 ms."""
    torch.cuda._sleep(RACE_SLEEP_CYCLES)


def profile_feed(fn):
    """fn() under torch.profiler -> (wall ms, device-busy ms, ms of
    host-to-device copies)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in events) / 1e3
    h2d = sum(e.self_device_time_total for e in events
              if "HtoD" in e.key) / 1e3
    return wall, busy, h2d


def phase_feed_llama(card, seed=13):
    """(n-1) The compiled Llama step at the bench configuration, B and S of
    TRAIN_ATTN, FEED_STEPS steps from one seeded state, in turns: resident
    device batches, the feed at prefetch FEED_PREFETCH and 0, resident
    again. The batches the feed yielded equal their numpy source bit for
    bit (read back after the step consumed them); every run's losses are
    identical; 2L / L / L launches a step. -> the launch counts of the fed
    runs."""
    from ray_tpu_torch._private.dataplane_bench import token_batches
    from ray_tpu_torch._private.device_profiler import DeviceStepProfiler
    from ray_tpu_torch.data import iter_device_batches
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.train import adamw, init_train_state, make_train_step

    cfg = bench_config()
    batch, seq = TRAIN_ATTN[0], TRAIN_ATTN[1]
    source = list(token_batches(cfg.vocab_size, batch, seq, FEED_STEPS, seed))
    want = {"flash_fwd": 2 * cfg.n_layers, "flash_bwd_dq": cfg.n_layers,
            "flash_bwd_dkv": cfg.n_layers}
    nbytes = sum(v.nbytes for v in source[0].values())

    def run(form):
        opt = adamw(3e-4, weight_decay=0.0)  # as bench.py:210
        gen = torch.Generator(device=DEVICE).manual_seed(seed)
        state = init_train_state(functools.partial(llama.init, cfg, gen), opt,
                                 device=DEVICE)
        step = make_train_step(functools.partial(llama.loss_fn, config=cfg),
                               opt, backend=COMPILE_BACKEND)
        stats, scope = {}, [None]
        prof = DeviceStepProfiler("feed", device=DEVICE)
        if form == "resident":
            feed = iter([{k: torch.as_tensor(v, device=DEVICE)
                          for k, v in b.items()} for b in source])
        else:
            feed = iter_device_batches(iter(source), device=DEVICE,
                                       prefetch=form, stats=stats,
                                       scope=lambda: scope[0])
        losses, got, per_step = [], [], []
        torch.cuda.synchronize()
        for i in range(FEED_STEPS):
            if i == 1:  # the first step may compile: timed from the second
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            with prof.step(tokens=batch * seq) as scope[0]:
                b = next(feed)
                before = kernel_counts()
                state, m = step(state, b)
                after = kernel_counts()
            per_step.append({k: after[k] - before[k] for k in after})
            losses.append(m["loss"])
            got.append(b)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / (FEED_STEPS - 1) * 1e3
        check(next(feed, None) is None, f"{form}: the feed outlived its "
              "source")
        exact = all(np.array_equal(g[k].cpu().numpy(), s[k])
                    for g, s in zip(got, source) for k in s)
        losses = torch.stack(losses).float().cpu()
        check(exact, f"feed {form}: a batch differs from its numpy source")
        check(all(p == want for p in per_step),
              f"feed {form}: launches per step {per_step}, not {want}")
        check(bool(torch.isfinite(losses).all()), f"feed {form}: non-finite "
              "loss")
        waits = prof.report(recent=0)["phase_seconds"].get("input_wait", 0.0)
        return {"losses": losses, "ms": ms, "stats": stats,
                "input_wait_s": waits}

    runs = {"resident": run("resident")}
    reset_kernel_counts()
    runs["prefetch1"] = run(FEED_PREFETCH)
    runs["prefetch0"] = run(0)
    counts = kernel_counts()
    runs["resident again"] = run("resident")
    want_losses = runs["resident"]["losses"]
    rel = {form: float(((r["losses"] - want_losses).abs()
                        / want_losses.abs()).max())
           for form, r in runs.items()}
    for form, r in runs.items():
        log(f"[n-1] ({card}) {form}: losses "
            f"{[round(x, 6) for x in r['losses'].tolist()]}, largest "
            f"relative difference from the first resident run's "
            f"{rel[form]:.3e}")
    for form, r in runs.items():
        check(bool(r["losses"][0] == want_losses[0])
              and rel[form] <= FEED_LOSS_REL_TOL,
              f"(n-1) losses fed by {form} differ from the resident "
              f"batch's: first step {float(r['losses'][0])} against "
              f"{float(want_losses[0])}, relative {rel[form]:.3e}")
        extra = ""
        if r["stats"]:
            s = r["stats"]
            extra = (f"; overlap_frac {s['overlap_frac']:.4f}, produce_s "
                     f"{s['produce_s']:.6f}, wait_s {s['wait_s']:.6f}, "
                     f"input_wait in the step scopes "
                     f"{r['input_wait_s']:.6f} s")
        log(f"[n-1] ({card}) {form}: {r['ms']:.2f} ms a step over "
            f"{FEED_STEPS - 1} steps{extra}")
    resident = (runs["resident"]["ms"] + runs["resident again"]["ms"]) / 2
    log(f"[n-1] ({card}) bench config B={batch} S={seq}, {nbytes} bytes of "
        f"tokens a step: fed at prefetch {FEED_PREFETCH} / resident "
        f"{runs['prefetch1']['ms'] / resident:.4f}, at prefetch 0 / resident"
        f" {runs['prefetch0']['ms'] / resident:.4f}; the first step's loss "
        f"identical in all four runs, the rest within {FEED_LOSS_REL_TOL:g} "
        f"(resident against resident {rel['resident again']:.3e}); every "
        f"yielded batch equals its source; launches a step {want}; "
        f"launches of the fed runs {counts}")
    return counts


def vit_feed_batches(pool, labels, crop, steps, batch, seed):
    """`steps` batches of uint8 [batch, crop, crop, 3] random crops of the
    pool, each flipped left-right with probability 1/2, and their labels:
    the host-side map of the ViT feed."""
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        idx = rng.integers(0, len(pool), batch)
        ys = rng.integers(0, pool.shape[1] - crop + 1, batch)
        xs = rng.integers(0, pool.shape[2] - crop + 1, batch)
        flips = rng.random(batch) < 0.5
        images = np.empty((batch, crop, crop, pool.shape[3]), np.uint8)
        for j in range(batch):
            im = pool[idx[j], ys[j]:ys[j] + crop, xs[j]:xs[j] + crop]
            images[j] = im[:, ::-1] if flips[j] else im
        yield {"images": images, "labels": labels[idx]}


def phase_feed_vit(card, seed=14):
    """(n-2) ViT-B/16 at B=VIT_BATCH, bf16, eager, fed uint8 crops (cast on
    the card inside the step): VIT_FEED_STEPS steps in which the loss falls,
    fed at prefetch FEED_PREFETCH and 0 in turns with resident batches of
    the same crops, overlap, and the feed's host-to-device rate from the
    profiler's copies; then the stream race:
    RACE_BATCHES batches whose every byte is their index, each checked on
    the card after a long kernel on the consumer's stream."""
    import dataclasses

    from ray_tpu_torch.data import iter_device_batches
    from ray_tpu_torch.models import vit
    from ray_tpu_torch.train import adamw, init_train_state, make_train_step

    cfg = dataclasses.replace(vit.ViTConfig.base_16(), **VIT_CUT)
    rng = np.random.default_rng(seed)
    size = cfg.image_size * VIT_FEED_SOURCE // 224
    pool = rng.integers(0, 256, (VIT_FEED_POOL, size, size, cfg.num_channels),
                        dtype=np.uint8)
    labels = rng.integers(0, min(VIT_FEED_CLASSES, cfg.num_classes),
                          VIT_FEED_POOL)

    def loss_fn(params, b):
        images = b["images"].to(torch.float32) / 127.5 - 1.0
        return vit.loss_fn(params, {"images": images,
                                    "labels": b["labels"]}, cfg)

    def batches():
        return vit_feed_batches(pool, labels, cfg.image_size, VIT_FEED_STEPS,
                                VIT_BATCH, seed)

    nbytes = sum(v.nbytes for v in next(batches()).values())
    runs = {}
    forms = {"resident": None, "prefetch1": FEED_PREFETCH, "prefetch0": 0,
             "resident again": None, "profiled": FEED_PREFETCH}
    for form, prefetch in forms.items():
        opt = adamw(1e-3, weight_decay=0.0)
        gen = torch.Generator(device=DEVICE).manual_seed(seed)
        state = init_train_state(functools.partial(vit.init, cfg, gen), opt,
                                 device=DEVICE)
        step = make_train_step(loss_fn, opt, compiled=False)
        stats = {}
        if prefetch is None:
            feed = iter([{k: torch.as_tensor(v, device=DEVICE) for k, v in
                          b.items()} for b in batches()])
        else:
            feed = iter_device_batches(batches(), device=DEVICE,
                                       prefetch=prefetch, stats=stats)
        losses = []

        def steps(n):
            nonlocal state
            for _ in range(n):
                state, m = step(state, next(feed))
                losses.append(m["loss"])

        if form == "profiled":  # every batch's copy inside the window
            wall, busy, h2d = profile_feed(lambda: steps(VIT_FEED_STEPS))
            runs[form] = {"ms": wall / VIT_FEED_STEPS, "busy": busy,
                          "h2d": h2d}
            continue
        steps(1)  # the first step: cuBLAS and cuDNN set up, not timed
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        steps(VIT_FEED_STEPS - 1)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / (VIT_FEED_STEPS - 1) * 1e3
        check(next(feed, None) is None, f"(n-2) {form}: the feed outlived "
              "its source")
        losses = torch.stack(losses).float().cpu().tolist()
        runs[form] = {"ms": ms, "losses": losses, "stats": stats}
        check(np.isfinite(losses).all() and losses[-1] < losses[0],
              f"(n-2) ViT {form}: the loss did not fall ({losses})")
        del state, step
    s, p = runs["prefetch1"]["stats"], runs["profiled"]
    diff = max(abs(a - b) for form in ("prefetch1", "prefetch0")
               for a, b in zip(runs[form]["losses"],
                               runs["resident"]["losses"]))
    resident = (runs["resident"]["ms"] + runs["resident again"]["ms"]) / 2
    copied = nbytes * VIT_FEED_STEPS
    h2d_gbps = copied / (p["h2d"] / 1e3) / 1e9 if p["h2d"] > 0 else \
        float("nan")
    log(f"[n-2] ({card}) ViT-B/16 B={VIT_BATCH} bf16 eager, fed uint8 crops "
        f"({nbytes} bytes a batch): {runs['prefetch1']['ms']:.2f} ms a step "
        f"at prefetch {FEED_PREFETCH} and {runs['prefetch0']['ms']:.2f} at "
        f"prefetch 0, against resident {runs['resident']['ms']:.2f} and "
        f"{runs['resident again']['ms']:.2f} "
        f"({runs['prefetch1']['ms'] / resident:.4f}, "
        f"{runs['prefetch0']['ms'] / resident:.4f}); at prefetch "
        f"{FEED_PREFETCH} overlap_frac {s['overlap_frac']:.4f}, produce_s "
        f"{s['produce_s']:.6f}, wait_s {s['wait_s']:.6f} over "
        f"{VIT_FEED_STEPS} batches; losses "
        f"{[round(x, 4) for x in runs['prefetch1']['losses']]} (largest "
        f"difference of a fed run from the resident run's {diff:.3e})")
    log(f"[n-2] ({card}) profiled fed run, {VIT_FEED_STEPS} steps: "
        f"{p['ms']:.2f} ms a step wall, device busy "
        f"{p['busy'] / VIT_FEED_STEPS:.2f} ms a step (idle share "
        f"{max(0.0, 1 - p['busy'] / (p['ms'] * VIT_FEED_STEPS)):.3f}), "
        f"host-to-device copies {p['h2d']:.3f} ms for {copied} bytes: "
        f"{h2d_gbps:.2f} GB/s")

    shape = (VIT_BATCH, cfg.image_size, cfg.image_size, cfg.num_channels)

    def race_batches():
        for i in range(RACE_BATCHES):
            yield {"x": np.full(shape, i % 256, np.uint8)}

    for prefetch in RACE_PREFETCH:
        bad = torch.zeros((), dtype=torch.int64, device=DEVICE)
        n = 0
        t0 = time.perf_counter()
        for i, b in enumerate(iter_device_batches(
                race_batches(), device=DEVICE, prefetch=prefetch)):
            long_kernel()
            bad += (b["x"] != i % 256).sum()
            del b  # the memory returns to the allocator at once
            n += 1
        torch.cuda.synchronize()
        check(n == RACE_BATCHES and int(bad) == 0,
              f"(n-2) stream race at prefetch {prefetch}: {int(bad)} wrong "
              f"bytes in {n} batches")
        log(f"[n-2] ({card}) stream race at prefetch {prefetch}: "
            f"{RACE_BATCHES} batches of {int(np.prod(shape))} bytes, each "
            f"checked on the card after a long kernel: 0 wrong bytes "
            f"({time.perf_counter() - t0:.2f} s)")
    return {"fed_ms": runs["prefetch1"]["ms"], "resident_ms": resident,
            "overlap_frac": s["overlap_frac"], "h2d_gbps": h2d_gbps}


def phase_wire(card):
    """(n-3) The typed tensor wire on the card: serialize / deserialize
    round trips of CUDA tensors come back exact on cuda:0, one typed put and
    one typed get each, the host buffer freed (and its memory reused) right
    after the get; then `dataplane_bench`, its JSON line printed."""
    from ray_tpu_torch._private import dataplane_bench
    from ray_tpu_torch._private import serialization as ser

    g = torch.Generator(device=DEVICE).manual_seed(15)
    cases = {
        "fp32": torch.randn((64, 128), generator=g, device=DEVICE),
        "bf16": torch.randn((64, 128), generator=g, device=DEVICE).to(
            torch.bfloat16),
        "int64": torch.arange(4096, device=DEVICE),
        "bool": torch.randn((33,), generator=g, device=DEVICE) > 0,
        "0-d": torch.tensor(3.5, device=DEVICE),
        "empty": torch.empty((0, 7), device=DEVICE),
        "non-contiguous": torch.randn((64, 128), generator=g,
                                      device=DEVICE)[:, ::3],
    }
    want_dev = torch.device(DEVICE, 0) if DEVICE == "cuda" else \
        torch.device(DEVICE)
    for name, t in cases.items():
        puts, gets = (ser.COPY_STATS["typed_tensor_put"],
                      ser.COPY_STATS["typed_tensor_get"])
        host = bytearray(ser.serialize(t).to_bytes())
        out = ser.deserialize(ser.SerializedObject.from_bytes(host))
        if out.is_cuda:  # the copy has landed: the host buffer may change
            host[:] = b"\xff" * len(host)
        del host  # a CPU tensor is a view of it and keeps it alive
        junk = [bytearray(b"\xee" * 4096) for _ in range(16)]
        del junk
        torch.cuda.synchronize()
        check(out.device == want_dev and out.dtype == t.dtype
              and out.shape == t.shape and torch.equal(out, t),
              f"(n-3) {name}: the round trip changed the tensor")
        check(ser.COPY_STATS["typed_tensor_put"] == puts + 1
              and ser.COPY_STATS["typed_tensor_get"] == gets + 1,
              f"(n-3) {name}: not one typed put and one typed get")
    log(f"[n-3] ({card}) serialize/deserialize of {', '.join(cases)} "
        f"{DEVICE} tensors: exact, on {want_dev}, one typed put and get each")
    log(f"[n-3] ({card}) dataplane_bench:")
    dataplane_bench.main(["--device", DEVICE])


def phase_dataplane(card):
    """(n) The data plane on the card: (n-1), (n-2), (n-3). -> the launch
    counts of (n-1)'s fed runs."""
    t0 = time.perf_counter()
    counts = phase_feed_llama(card)
    gc.collect()
    torch.cuda.empty_cache()
    phase_feed_vit(card)
    gc.collect()
    torch.cuda.empty_cache()
    phase_wire(card)
    log(f"[n] the data plane: {time.perf_counter() - t0:.1f} s")
    return counts


# -- (o) Train's checkpoint and predictor -------------------------------------

# (o-1): the compiled bench step at the bench widths cut to CKPT_LAYERS
# layer(s) (B=4, S=2048, bf16, "dots"): CKPT_STEPS steps, a checkpoint
# after CKPT_SAVE_AFTER, restored into a fresh state; the first step after
# the restore must give the uninterrupted run's loss exactly, the next
# within CKPT_NEXT_REL_TOL (the compiled step's own run-to-run drift).
CKPT_LAYERS = 1
CKPT_SAVE_AFTER = 2
CKPT_STEPS = 4
CKPT_NEXT_REL_TOL = 1e-4
# (o-2): CompiledPredictor over ViT-B/16 (bf16) at these batch sizes, its
# rows against the eager forward on the same rows in the same padded batch
# (bf16 1e-2 + 1e-2 |ref|).
PREDICT_BATCHES = (1, 3, 17, 32, 64)
PREDICT_TIMED = 5
PREDICT_TOL = (1e-2, 1e-2)


def _state_leaves(state):
    from ray_tpu_torch.train.optim import tree_leaves

    return tree_leaves([state.params, state.opt_state.mu,
                        state.opt_state.nu, state.step])


def _same_bits(a, b):
    if a.dtype == torch.bfloat16:
        a, b = a.view(torch.int16), b.view(torch.int16)
    return bool(torch.equal(a, b))


def phase_checkpoint(card, seed=17):
    """(o-1) The compiled bench step at CKPT_LAYERS layer(s): steps 1 and
    2, `Checkpoint.from_arrays` of the whole TrainState, `to_arrays` copied
    into a fresh state (another seed), which must equal the saved state bit
    for bit; then steps 3 and 4 on both runs. -> the kernels' launches."""
    import dataclasses
    import shutil
    import tempfile

    from ray_tpu_torch.models import llama
    from ray_tpu_torch.train import adamw, init_train_state, make_train_step
    from ray_tpu_torch.train.checkpoint import Checkpoint
    from ray_tpu_torch.train.optim import tree_leaves

    cfg = dataclasses.replace(bench_config(), n_layers=CKPT_LAYERS)
    b, s = TRAIN_ATTN[0], TRAIN_ATTN[1]
    opt = adamw(3e-4, weight_decay=0.0)
    step = make_train_step(functools.partial(llama.loss_fn, config=cfg),
                           opt, backend=COMPILE_BACKEND)

    def fresh(k):
        gen = torch.Generator(device=DEVICE).manual_seed(k)
        return init_train_state(functools.partial(llama.init, cfg, gen),
                                opt, device=DEVICE)

    batches = [train_batch(cfg, b, s, seed + i) for i in range(CKPT_STEPS)]
    state, losses = fresh(seed), []
    t0 = time.perf_counter()
    for i in range(CKPT_SAVE_AFTER):
        state, m = step(state, batches[i])
        losses.append(float(m["loss"]))
    first_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    root = tempfile.mkdtemp(prefix="ckpt_o1_")
    try:
        t0 = time.perf_counter()
        ckpt = Checkpoint.from_arrays(state, root)
        save_s = time.perf_counter() - t0
        nbytes = sum(os.path.getsize(os.path.join(root, f))
                     for f in os.listdir(root))
        resumed = fresh(seed + 100)
        t0 = time.perf_counter()
        restored = ckpt.to_arrays()
        with torch.no_grad():
            for dst, src in zip(_state_leaves(resumed),
                                _state_leaves(restored)):
                dst.copy_(src)
        resumed.opt_state.count = restored.opt_state.count
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        del restored
    finally:
        shutil.rmtree(root, ignore_errors=True)
    same = [_same_bits(x, y) for x, y in zip(_state_leaves(resumed),
                                             _state_leaves(state))]
    check(all(same) and resumed.opt_state.count == state.opt_state.count,
          f"(o-1) the restored state differs from the saved one "
          f"({same.count(False)} of {len(same)} leaves)")
    after = []
    for i in range(CKPT_SAVE_AFTER, CKPT_STEPS):
        state, m = step(state, batches[i])
        resumed, mr = step(resumed, batches[i])
        losses.append(float(m["loss"]))
        after.append(float(mr["loss"]))
    rel_next = [abs(a - b) / abs(b) for a, b in
                zip(after[1:], losses[CKPT_SAVE_AFTER + 1:])]
    params = sum(x.numel() for x in tree_leaves(state.params))
    log(f"[o-1] ({card}) compiled bench step at {cfg.n_layers} layer(s) "
        f"(B={b} S={s}, bf16, {cfg.remat_policy}, {params / 1e9:.3f} B "
        f"params): losses {losses}; after a checkpoint at step "
        f"{CKPT_SAVE_AFTER} ({nbytes / 1e9:.3f} GB written, save "
        f"{save_s:.2f} s, restore into a fresh state {restore_s:.2f} s; "
        f"the first {CKPT_SAVE_AFTER} steps with the compile "
        f"{first_s:.1f} s) the restored run's {after}: step "
        f"{CKPT_SAVE_AFTER + 1} identical "
        f"{after[0] == losses[CKPT_SAVE_AFTER]}, the next rel {rel_next}")
    check(after[0] == losses[CKPT_SAVE_AFTER],
          "(o-1) the step after the restore gives another loss")
    check(all(r <= CKPT_NEXT_REL_TOL for r in rel_next),
          "(o-1) the restored run drifts from the uninterrupted one")
    del state, resumed, step
    gc.collect()
    torch.cuda.empty_cache()
    return kernel_counts()


def _predictor_run(params, apply_fn, cfg, **kw):
    """One CompiledPredictor (`kw`: its backend, none for the default) at
    PREDICT_BATCHES rows: -> per batch the rows' largest difference from
    the eager forward on the same rows in the same padded batch and the
    entries over PREDICT_TOL, the ms of a predict call from numpy and of
    the compiled apply on the padded batch on the card (CUDA events); the
    predictor's compiles and buckets."""
    from ray_tpu_torch.train.predictor import CompiledPredictor, _bucket

    pred = CompiledPredictor(params, apply_fn, device=DEVICE, **kw)
    rng = np.random.default_rng(29)
    rows = {}
    for n in PREDICT_BATCHES:
        x = rng.standard_normal((n, cfg.image_size, cfg.image_size,
                                 cfg.num_channels)).astype(np.float32)
        t0 = time.perf_counter()
        got = pred.predict({"inputs": x})["predictions"]
        first_s = time.perf_counter() - t0
        padded = pred._to_device(
            np.concatenate([x, np.repeat(x[-1:], _bucket(n) - n, 0)]))
        with torch.no_grad():
            want = apply_fn(params, padded)[:n].float().cpu().numpy()
            apply_ms = cuda_ms(lambda: pred._apply(pred.params, padded),
                               iters=PREDICT_TIMED, warmup=1)
        err = np.abs(got - want)
        bad = err > PREDICT_TOL[0] + PREDICT_TOL[1] * np.abs(want)
        t0 = time.perf_counter()
        for _ in range(PREDICT_TIMED):
            pred.predict({"inputs": x})
        wall = (time.perf_counter() - t0) / PREDICT_TIMED
        rows[n] = {"bucket": _bucket(n), "first_call_s": first_s,
                   "ms": wall * 1e3, "images_per_s": n / wall,
                   "apply_ms": apply_ms, "max_abs_err": float(err.max()),
                   "over_tol": int(bad.sum()), "size": want.size,
                   "shape_ok": got.shape == want.shape,
                   "eager_max": float(np.abs(want).max())}
    return pred, rows


def phase_predictor(card, compare=False):
    """(o-2) CompiledPredictor over ViT-B/16 (bf16, ViTConfig.base_16())
    at PREDICT_BATCHES rows with its default backend: its outputs against
    the eager forward on the same rows in the same padded batch, one
    compile per distinct bucket, images/s per batch; the eager forward's
    own spread between the rows alone and padded. With `compare` (`--only
    o`) also with COMPILE_BACKEND on the same batches, timed and held
    against eager beside it (its compiles take about a minute a bucket on
    the card, too long for the whole script): the measurement behind the
    default."""
    from ray_tpu_torch.models import vit
    from ray_tpu_torch.train.predictor import _bucket

    cfg = vit.ViTConfig.base_16()
    params = vit.init(cfg, torch.Generator(device=DEVICE).manual_seed(23),
                      device=DEVICE)
    apply_fn = functools.partial(vit.forward, config=cfg)
    runs = [_predictor_run(params, apply_fn, cfg)]
    if compare:
        runs.append(_predictor_run(params, apply_fn, cfg,
                                   backend=COMPILE_BACKEND))
    # The eager forward of the rows alone against them in the bucket's
    # batch, padded with the last row: bf16 GEMMs of another batch size
    # round differently, and ViT-B/16's 12 layers carry that to its logits.
    rng = np.random.default_rng(29)
    spread, eager_ms = {}, {}
    for n in PREDICT_BATCHES:
        x = rng.standard_normal((n, cfg.image_size, cfg.image_size,
                                 cfg.num_channels)).astype(np.float32)
        padded = np.concatenate([x, np.repeat(x[-1:], _bucket(n) - n, 0)])
        with torch.no_grad():
            xs = [torch.from_numpy(v).to(DEVICE) for v in (padded, x)]
            want, alone = (apply_fn(params, v)[:n].float().cpu().numpy()
                           for v in xs)
            eager_ms[n] = cuda_ms(lambda: apply_fn(params, xs[0]),
                                  iters=PREDICT_TIMED, warmup=1)
        spread[n] = float(np.abs(alone - want).max())
    buckets = sorted({_bucket(n) for n in PREDICT_BATCHES})
    for pred, rows in runs:
        log(f"[o-2] ({card}) CompiledPredictor ViT-B/16 bf16 "
            f"({pred.backend}): batches {list(PREDICT_BATCHES)} -> buckets "
            f"{pred.buckets}, {pred.compiles} compiles; by batch (bucket, "
            f"first call s with its compile, ms a predict call from numpy, "
            f"images/s, ms of the compiled apply on the card against "
            f"eager's, largest difference from eager, entries over "
            f"{PREDICT_TOL[0]} + {PREDICT_TOL[1]}|eager|) "
            + "; ".join(f"{n}: {r['bucket']}, {r['first_call_s']:.2f}, "
                        f"{r['ms']:.3f}, {r['images_per_s']:.1f}, "
                        f"{r['apply_ms']:.3f} vs {eager_ms[n]:.3f}, "
                        f"{r['max_abs_err']:.3e}, {r['over_tol']} of "
                        f"{r['size']}" for n, r in rows.items()))
    log(f"[o-2] ({card}) the eager forward of the rows alone against them "
        f"in the bucket's batch (bf16 rounding of another batch size): "
        f"largest difference {spread}")
    pred, rows = runs[0]
    for n, r in rows.items():
        check(r["shape_ok"] and not r["over_tol"],
              f"(o-2) the predictor's {n} rows differ from the eager "
              f"forward: {r['over_tol']} of {r['size']} entries, largest "
              f"{r['max_abs_err']:.3e} (|eager| up to {r['eager_max']:.3e})")
    for p, _ in runs:
        check(sorted(p.buckets) == buckets and p.compiles == len(buckets),
              f"(o-2) {p.compiles} compiles ({p.backend}) for buckets "
              f"{p.buckets}, not one for each of {buckets}")
    return {"compiles": pred.compiles, "buckets": pred.buckets,
            "backend": pred.backend, "rates": rows,
            "max_abs_err": max(r["max_abs_err"] for r in rows.values()),
            "eager_ms": eager_ms, "eager_batch_size_spread": spread,
            **{p.backend: r for p, r in runs[1:]}}


def phase_train_io(card, compare=False):
    """(o): (o-1) the checkpoint of the compiled step's state, then (o-2)
    the compiled predictor (`compare`: beside COMPILE_BACKEND's). -> the
    flash kernels' launches of (o-1)."""
    t0 = time.perf_counter()
    reset_kernel_counts()
    with _recompiles():  # the script has compiled llama.loss_fn before
        launches = phase_checkpoint(card)
        gc.collect()
        torch.cuda.empty_cache()
        predict = phase_predictor(card, compare)
    log(f"[o] Train's checkpoint and predictor: "
        f"{time.perf_counter() - t0:.1f} s")
    return launches, predict


def nvidia_smi_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return proc.stdout.strip().splitlines()[0]


def main(argv=()) -> int:
    import argparse

    parser = argparse.ArgumentParser(description="Drive ray_tpu_torch on the "
                                     "card(s); see the module docstring.")
    parser.add_argument("--only", choices=("l", "m", "n", "o"), default=None,
                        help="run phase (l), the SPMD path (with 4 cards its "
                        "4-card part), (m), RLlib's one-process path, (n), "
                        "the data plane, or (o), Train's checkpoint and "
                        "predictor, alone after the kernel build")
    parser.add_argument("--part", default=None, choices=[
        p.__name__[len("cards_"):] for p in CARDS_PARTS],
        help="with --only l on 4 cards: this (l-3) part alone")
    args = parser.parse_args(list(argv))
    if args.part is not None and args.only != "l":
        parser.error("--part needs --only l")
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
    if args.only == "l":
        spmd = (phase_spmd_part(args.part) if args.part is not None
                else phase_spmd())
        log(f"[l] {time.perf_counter() - t_start:.1f} s in all")
        print(card)
        print(json.dumps({"spmd_launches": spmd}))
        print(json.dumps({"ok": True, "device": {
            "platform": info["platform"], "kind": info["kind"],
            "count": info["count"]}}))
        return 0
    if args.only == "m":
        reset_kernel_counts()
        rl = phase_rl(card)
        log(f"[m] launches of the flash kernels on the RL path: "
            f"{kernel_counts()} (it runs none); "
            f"{time.perf_counter() - t_start:.1f} s in all")
        print(card)
        print(json.dumps({"rl": rl}))
        print(json.dumps({"ok": True, "device": {
            "platform": info["platform"], "kind": info["kind"],
            "count": info["count"]}}))
        return 0
    if args.only == "o":
        ckpt, predict = phase_train_io(card, compare=True)
        log(f"[o] launches on the checkpointed training path: {ckpt}; "
            f"{time.perf_counter() - t_start:.1f} s in all")
        print(card)
        print(json.dumps({"checkpoint_launches": ckpt,
                          "predictor": predict}))
        print(json.dumps({"ok": True, "device": {
            "platform": info["platform"], "kind": info["kind"],
            "count": info["count"]}}))
        return 0
    if args.only == "n":
        feed = phase_dataplane(card)
        log(f"[n] launches on the fed training path: {feed}; "
            f"{time.perf_counter() - t_start:.1f} s in all")
        print(card)
        print(json.dumps({"feed_launches": feed}))
        print(json.dumps({"ok": True, "device": {
            "platform": info["platform"], "kind": info["kind"],
            "count": info["count"]}}))
        return 0
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
    phase_cache_attention(cfg, seed=4)
    phase_decode(cfg, params, seed=5)
    serve = kernel_counts()
    check(serve["flash_fwd"] > 0, "the serving path never launched flash_fwd")
    log(f"[d+e] launches on the serving path: {serve}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
        f"{time.perf_counter() - t_start:.1f} s so far")

    reset_kernel_counts()
    phase_paged_forward(cfg, params, seed=6)
    phase_paged_serve(cfg, params, seed=8)
    phase_paged_tiny()
    log(f"[i] launches on the paged serving path: {kernel_counts()} (it "
        f"attends through the cache attention, not the flash kernel); "
        f"{time.perf_counter() - t_start:.1f} s so far")
    del params
    gc.collect()
    torch.cuda.empty_cache()

    cfg = bench_config()
    train, eager = phase_train(cfg, batch=TRAIN_ATTN[0], seq=TRAIN_ATTN[1],
                               steps=10, seed=3)
    log(f"[h] launches on the training path: {train}; "
        f"{time.perf_counter() - t_start:.1f} s so far")
    gc.collect()
    torch.cuda.empty_cache()
    reset_kernel_counts()
    compiled = phase_train_compiled(cfg, batch=TRAIN_ATTN[0],
                                    seq=TRAIN_ATTN[1], steps=10, seed=3,
                                    eager=eager)
    log(f"[h-2] launches on the compiled training path: {compiled}; "
        f"{time.perf_counter() - t_start:.1f} s so far")
    phase_train_tiny()
    phase_bench()
    phase_entry()
    log(f"[bench+j] {time.perf_counter() - t_start:.1f} s so far")
    gc.collect()
    torch.cuda.empty_cache()
    zoo = phase_zoo(t_start)
    log(f"[k] {time.perf_counter() - t_start:.1f} s so far")
    gc.collect()
    torch.cuda.empty_cache()
    spmd = phase_spmd(eager["first"])
    log(f"[l] {time.perf_counter() - t_start:.1f} s so far")
    gc.collect()
    torch.cuda.empty_cache()
    reset_kernel_counts()
    phase_rl(card)
    log(f"[m] launches of the flash kernels on the RL path: "
        f"{kernel_counts()} (it runs none); "
        f"{time.perf_counter() - t_start:.1f} s so far")
    gc.collect()
    torch.cuda.empty_cache()
    feed = phase_dataplane(card)
    log(f"[n] launches on the fed training path: {feed}; "
        f"{time.perf_counter() - t_start:.1f} s so far")
    gc.collect()
    torch.cuda.empty_cache()
    ckpt, _ = phase_train_io(card)
    log(f"[o] launches on the checkpointed training path: {ckpt}; "
        f"{time.perf_counter() - t_start:.1f} s in all")

    sources = {"flash_fwd": ("ray_tpu_torch/ops/csrc/flash_fwd.cu", 45),
               "flash_bwd_dq": ("ray_tpu_torch/ops/csrc/flash_bwd.cu", 151),
               "flash_bwd_dkv": ("ray_tpu_torch/ops/csrc/flash_bwd.cu", 201)}
    kernels = []
    for name, (source, line) in sources.items():
        by_path = {"serve": serve[name], "train": train[name],
                   "train_compiled": compiled[name], "mixtral": zoo[name],
                   "spmd": spmd["spmd"][name],
                   "spmd_compiled": spmd["spmd_compiled"][name],
                   "zoo_mesh": spmd["zoo_mesh"][name], "feed": feed[name],
                   "checkpoint": ckpt[name]}
        check(all(v > 0 for path, v in by_path.items() if path != "serve"),
              f"a training path never launched {name}: {by_path}")
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": f"ray_tpu/ops/flash_attention.py:{line}",
            "launches": sum(by_path.values()),
            "design": fa.built_variant(name, torch.bfloat16, 128),
            "launches_by_path": by_path,
            "max_abs_err": max_err[name], **timing[name]})
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": info["platform"], "kind": info["kind"],
        "count": info["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
