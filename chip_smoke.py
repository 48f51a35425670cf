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
  (r) the serving benchmarks on the same 8B weights, through the
      in-process stand-in of the serving stack (`ray_tpu_torch.serve.
      LocalServingStack`: a thread a replica, each over its own
      PagedInferenceEngine on the one copy of the weights, streaming
      through serve_stream): (r-0) one prefill wave of 456 tokens and one
      of an 8-token tail at offset 448, each eagerly and as its CUDA
      graph in turns, the same first tokens, ms a wave; (r-1) `inference.benchmarks.benchmark_serving`
      at the reference's defaults (2 replicas, 24 requests of 8 tokens at
      8 Hz, 12 new tokens each): TTFT p50/p99, tokens/s, peak memory and
      the decode profiler's perf.phase_report fractions, every request
      streamed exactly 12 tokens and every engine drained; (r-2)
      `serve.run_prefix_ttft_benchmark` (a 448-token shared prefix, 6
      rounds): cold and hit p50, hit_over_cold below 1 and at least 6 hit
      and 6 missed requests; (r-3) the ray_tpu_kv_blocks{state} gauge
      summing to the live engines' pools, the phase histogram holding
      every phase of every recorded decode wave, and after (h-2) one
      compile.start and one compile.end a compile whose durations add up
      to compile_stats()'s seconds. `--only r` runs (r) alone after (a)
      and the 8B init. It launches none of the flash kernels;
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
      against their unsharded ones; the dense engine with mesh= at tp=1
      against the engine without it (the same greedy tokens); the
      collective report (`parallel.hlo_report`) of the compiled sharded
      step at the bench widths, read from the programs it compiled; and a
      world-1 "mesh" collective group (`util.collective`) with
      `bootstrap_mesh`: every collective the identity on a tensor on the
      card, eagerly and inside a fullgraph function (aot_eager); (l-2)
      with fewer than 4 cards, `graft_entry.dryrun_multichip(4,
      device="cpu")` and `cards_collective` on 4 gloo CPU ranks (NCCL
      takes one rank a card), as their lines say, on a thread of their
      own while (l-1) runs; (l-3) with 4 cards or
      more, one rank a card over NCCL, each part logged and the next one
      run if it fails (the phase then fails at its end): the dry run, the
      collective groups (mesh groups over dp=4, over tp of dp=2 x tp=2 and
      over both: each collective eagerly and compiled, exact against numpy
      on integer-valued fp32 and the bf16 sum, the typed errors, the host
      path on numpy with a send/recv ring by tag, and one 1 GiB bf16
      all-reduce's bus bandwidth), `spmd_bench` (fsdp=2 x tp=2 against
      the 1-GPU compiled step on one global batch, B=16 S=2048, the
      compiled and the eager sharded step side by side: step ms, tok/s and
      MFU per GPU, scaling efficiency, peak memory per GPU, NCCL ms against
      compute ms, rank 0's collective report of the compiled step beside
      its NCCL ms, the trajectories within 1e-2, the compiled step's first
      step within bf16 loss 1e-3 and grad norm 1e-2 of the eager one's),
      the ring step at sp=2 x fsdp=2 (the bench widths, B=4 S=2048) with
      each rank's flash launches (2L(c+1) / L(c+1) / L(c+1) at sp
      coordinate c) and its losses and grad norms against the same mesh
      without the ring (bf16 loss 1e-3, grad norm 1e-2), then compiled
      (its first step against the eager ring's, the same launches),
      Mixtral at 8x7B widths and 2 layers over ep=4 (B=4 S=2048, eager and
      compiled from the same state within 1e-3, MFU, peak memory and the
      all-to-all's device ms), ViT-B/16 over dp=4 against the one-card
      step on the same global batch (the first bf16 step's loss within
      1e-3 and gradient norm within 1e-2, after the dp reduction, and three
      fp32 steps' losses within 1e-3; the bf16 three-step gap a reading),
      T5-base over dp=2 x tp=2 against the one-card step (three steps,
      losses within 1e-3), a pp=4 pipeline of Llama-width SwiGLU
      stages (fp32: output and gradients within 1e-4 of the sequential
      composition on one card), the Llama-3-8B dense engine at tp=4
      against the one-card engine (prefill logits within 2e-2, the first
      token of every request equal, the tokens that agree before the first
      divergence), and Llama-3-8B at its full 32 layers over fsdp=4 (B=8
      S=2048, 3 steps), eager and then compiled from the same state, with
      rank 0's collective report of the compiled step (its all-gather
      bytes equal to the figure from the parameters' shapes and the remat
      policy).
      `--only l` runs (l) alone after (a); `python3 chip_smoke.py --only l`
      on a host with four cards is the four-card run, and `--only l
      --part NAME` runs one of its parts (collective, bench, ring, mixtral,
      vit, t5, pipeline, engine, llama8b, train_gang) alone. The ring's
      and Mixtral's compiled steps log rank 0's collective report beside
      their NCCL ms, as the bench's and Llama-3-8B's do;
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
      one compile per distinct bucket, images/s per batch; (o-3)
      `BatchPredictor` over the same ViT-B/16 saved as a checkpoint, 256
      seeded rows in batches of 64 through a stand-in dataset whose
      map_batches runs its blocks in this process: the outputs bit for bit
      those of `CompiledPredictor.predict` on the same rows, one load of
      the checkpoint in the process and one compile per bucket. Its numbers
      are printed beside the card's name and power limit. `--only o` runs
      (o) alone after (a), and (o-2) there also with inductor on the same
      batches, timed and held against eager beside the default (about a
      minute of compile a bucket);
  (p) the worker side of Train's gang (`ray_tpu_torch.train.backend`'s
      `TorchBackend`: `bind_card`, `join_gang`, `train.spmd.
      setup_worker_mesh`), in this process at world 1 as a runtime worker
      runs it (`parallel.train_gang_cases.train_run`): the card at local
      rank 0, the NCCL gang at this host's name and a port it serves, a world-1
      mesh built through a "mesh" collective group; the compiled bench
      step at the bench widths cut to 1 layer (B=4, S=2048, bf16, "dots")
      fed seeded numpy rows through the per-position feed
      (`iter_device_batches(local_rows=True)`): three steps, the whole
      state saved after two, the gang torn down (group and process group);
      then the join again, the state restored onto the mesh (`place_like`)
      bit for bit as saved, and step 3 again within 1e-4 of the first
      gang's, 2L / L / L launches a step (the join's and the mesh's
      seconds, the save and restore seconds). `--only p` runs (p) alone
      after (a). On four cards, `--only l --part train_gang` runs the same
      on four spawned ranks that see every card and bind themselves by
      local rank, over fsdp=2 x tp=2 (the bench widths cut to 2 layers,
      B=16): three steps, the state saved after two, every rank exits; a
      second gang restores it and runs step 3. Each rank on its own card
      (PCI bus id), the global batch each step assembles equal to the
      seeded one, the restored state bit for bit the saved one on every
      rank, step 3 within 1e-4 of the first gang's;
  (q) the work of RLlib's remote env runners and learners
      (`ray_tpu_torch.rllib.remote_cases`), in fp32 at the algorithms'
      default widths on CartPole, the runtime's actors stood in for by
      threads of this process that take their arguments by value through
      the port's pickler (the runtime half is held on the CPU by
      tests/test_torch_rl_remote*.py):
      (q-1) a `LearnerGroup` of two PPO learners, each bound to the card at
      its position, updates once on its half of a seeded 128-row batch and
      takes the parameter mean; the mean weights and the averaged metrics
      against the same steps on the CPU (1e-5 + 1e-4 |ref|); (q-2) the
      mean state dict through the typed tensor wire as the groups ship it
      (host copies), bit for bit, then bit for bit on each runner's card;
      two remote runners (worker_index 1 and 2) sample 64 steps each
      with it, their obs, actions and rewards equal to in-process runners'
      of the same index and weights; (q-3) IMPALA over two remote runners
      with two sample calls in flight each: 6 updates, each from one armed
      call, the runners on the learner's policy_version after every
      broadcast; then the runner of the oldest armed call fails with
      `RayActorError` after that call finished: the next step drops its
      fragment, replaces the slot and re-arms it to two, and two more
      updates follow. It logs one
      learner's update ms, the mean's gather / mean / set ms, the wire's
      ms for the state dict and each IMPALA iteration's seconds waiting
      for a fragment and learning, beside the card's name and power limit.
      `--only q` runs (q) alone after (a). It launches none of the flash
      kernels.
  (s) The decoupled RL dataflow and `lower_to_jit`, the actors stood in
      for as in (q): (s-1) IMPALA (fp32, CartPole at its default widths)
      with `dataflow(decoupled=True)` over two stand-in runners bound to
      the card, 8 updates; after a third of them one runner fails and the
      fleet respawns its slot, after two thirds the learner's version
      jumps past the staleness bound and the queued batches are dropped
      as stale; checked: no stale batch trained on, the `rl.*` events'
      counts against the dataflow's, and the first update against the
      same pulled batch on the CPU (1e-5 + 1e-4 |ref|); (s-2)
      `benchmark_decoupled` at JAX's widths (the 84x84x4 synthetic image
      env, convs (16,3,2),(32,3,2), hiddens 256, 4 envs a runner,
      fragments of 64, a queue of 8 n) at 1 and 2 runners, each for 4 s
      (JAX: 8 s): the env steps per second the learner consumes; (s-3)
      `lower_to_jit` of two DAGs (a shared subgraph; a diamond over an
      input dict) at 1024 x 1024 fp32, compiled by inductor, against the
      eager DAG (1e-5 + 1e-5 |ref|), each timed both ways. It logs the
      learner's seconds pulling against learning, the env steps per
      second at each runner count, beside the card's name and power
      limit. `--only s` runs (s) alone after (a). It launches none of the
      flash kernels.
  (t) the node's card advertisement and typed tensors through shared host
      pages: (t-1) `node_advertisement()` (its probe process) advertises
      `GPU` = `torch.cuda.device_count()` and the typed `GPU-<part>` at the
      same count, its part and label that of `nvidia-smi`'s name; (t-2) a
      stand-in for the object store's arena at the runtime's default
      capacity, a sparse 2 GiB memfd (as the store's arena is) written
      through a writable mapping and read through a read-only one (a
      read-only `memoryview`): fp32, bf16, int64 and bool tensors, an
      empty and a 0-d one, written by `write_into` from the card, come
      back exact on cuda:0, the arena scribbled over right after each get,
      with no get taking the pageable route (`typed_tensor_get_pageable`
      stays 0), and only the three 64 MiB windows that the objects span
      registered (`_private/pinned_pages.py`), the reading mapping's
      resident pages no more than those; then the 64 MiB int64 tensor's put and
      get GB/s through the arena, and its first get's seconds (the
      registration of its two windows), against a pinned host-to-device
      copy and the pageable copy from the arena that the wire made before,
      timed in the same run, and a 129 KiB tensor's get from the arena and
      from a bytes frame (the pageable route, counted, with no look at the
      process's mappings); each the least of 5, printed beside the
      card's name and power limit. `--only t` runs (t) alone after (a).
      It launches none of the flash kernels.
  (u) the port's own runtime core on the card (`ray_tpu_torch.init`,
      its GCS, raylet, core worker and native shm store): (u-1) `init()`
      as a user calls it advertises `GPU` = `torch.cuda.device_count()`,
      the typed `GPU-<part>` and its label (the raylet's probe process),
      and its native shm store is up; (u-2) a `num_gpus=1` actor holds the
      dense `InferenceEngine` at Llama-3-8B widths cut to RUNTIME_LAYERS
      layers, weights from RUNTIME_SEED, and answers RUNTIME_PROMPTS
      prompts of different lengths with RUNTIME_NEW greedy tokens each
      through actor calls: its tokens equal those of the driver's copy of
      the engine from the same seed on the same card; it reports its
      CUDA_VISIBLE_DEVICES, that it is a direct spawn of the raylet (never
      a zygote fork) and its launches of the flash forward kernel (set to
      0 when the actor is built, read after its calls: above 0, one a
      layer a prompt, all from `forward`, since the dense engine's cached
      attention in `generate` is the plain one; the kernels line's
      `runtime_actor_forward` launches); (u-3) a 64 MiB bf16 CUDA tensor
      goes from the driver to the actor and back through the native store,
      exact, both puts landing in the store and no get taking the pageable
      route;
      the GB/s each way (a put's seconds plus the other side's get's, the
      best of RUNTIME_ITERS), and the p50 ms of RUNTIME_CALLS no-op task
      round trips and actor-call round trips, beside the card's name and
      power limit; (u-4) on a node of two or more cards, two `num_gpus=1`
      actors report different card UUIDs (on one card it is logged as not
      run). `--only u` runs (u) alone after (a).

The launch counts are set to 0 just before each main path (serving: (d)
and (e); paged serving: (i), which runs no flash kernel; the serving
benchmarks: (r), which runs none either; training: (h); compiled
training: (h-2); Mixtral: (k-1) and (k-2); the SPMD path's eager sharded
steps, its compiled sharded steps and the zoo on the mesh:
(l), each on its own; the fed training path: (n-1)'s fed runs; the
checkpointed training path: (o-1); the gang's training path: (p); the
remote RL groups: (q), the decoupled dataflow with `lower_to_jit`: (s),
and typed tensors through shared pages: (t), which run no flash kernel;
the port's own runtime: (u), whose actor sets its own count to 0 when it
is built and reads it after its `forward` calls) and read just after it. Each phase's
seconds are logged at the end ("[phases]"). The last
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
import warnings

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
    import threading

    from ray_tpu_torch import _native
    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.ops import flash_attention as fa

    # the runtime's shm store (g++, for (u)) builds beside the kernels
    store = {}

    def build_store():
        t = time.perf_counter()
        try:
            store["path"] = _native.build_library("shm_store")
        except Exception as err:  # noqa: BLE001 — reported by the check
            store["error"] = err
        store["s"] = time.perf_counter() - t

    thread = threading.Thread(target=build_store, name="build-shm-store")
    thread.start()
    t0 = time.perf_counter()
    try:
        built = _build.build(*sorted(set(fa.KERNELS.values())))
    finally:
        thread.join()
    log(f"[a] built {sorted(built)} in {time.perf_counter() - t0:.2f} s")
    check("path" in store, f"the runtime's shm store did not build: "
          f"{store.get('error')}")
    log(f"[a] the runtime's shm store: {os.path.basename(store['path'])}, "
        f"g++ {store['s']:.2f} s beside nvcc")
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
# One card against itself: ViT-B/16's three bf16 steps on the same batch in
# another order moved the losses this far on an H100 (PERF.md). A bf16
# reading of the mesh against one card is printed beside it.
ONE_CARD_REORDER_SPREAD = 1.267e-03
SPMD_VIT = dict(plan={"dp": 4}, batch=32)
SPMD_T5 = dict(plan={"dp": 2, "tp": 2})
SPMD_PIPE = dict(m=8, mb=(2, 256), rel_tol=1e-4)   # fp32
# Train's gang ((p) and `cards_train_gang`): GANG_STEPS steps fed per
# data position, the state saved after GANG_SAVE_AFTER, the gang left and
# joined again, the state restored and the next step run again within
# GANG_REL_TOL of the first gang's ((o-1)'s bound on the compiled step's
# run-to-run drift). (p): the bench widths cut to GANG_LAYERS layer(s) at
# world 1, B and S of TRAIN_ATTN; four cards: GANG_CARDS.
GANG_STEPS = 3
GANG_SAVE_AFTER = 2
GANG_REL_TOL = 1e-4
GANG_LAYERS = 1
GANG_CARDS = dict(plan={"fsdp": 2, "tp": 2}, layers=2, batch=16, seq=2048)
SPMD_ENGINE = dict(prompts=4, prompt_len=(96, 400), new_tokens=32,
                   max_len=512, logits_rel_tol=2e-2)
# (l-3), the collective groups: one all-reduce of 1 GiB of bf16, timed.
COLLECTIVE_BUSBW_BYTES = 1 << 30
COLLECTIVE_BUSBW_ITERS = 5


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
    from ray_tpu_torch.parallel.hlo_report import collective_report
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
        # from the programs the steps compiled: no compile, nothing runs
        report = (collective_report(step, state, batch_in)
                  if compiled and mesh is not None else None)
        del state
        gc.collect()
        torch.cuda.empty_cache()
        return out, launches, total, report

    mesh = build_mesh(MeshConfig())
    sharded, launches, total, report = run(mesh)
    plain = plain_first if plain_first is not None else run(None)[0]
    return sharded, plain, launches, total, report


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
        got, want, _, tiny_total, _ = spmd_world1_runs(cfg, 2, 64, seed=5)
        rel = max(abs(a - b) / abs(b) for x, y in zip(got, want)
                  for a, b in zip(x, y))
        log(f"[l-1] tiny fp32, world-1 mesh, {SPMD_STEPS} steps: (loss, "
            f"grad norm) {got} vs unsharded {want}: rel {rel:.3e}")
        check(rel <= SPMD_TINY_REL_TOL, "the sharded tiny step on a world-1 "
              "mesh differs from the unsharded one")
        cfg = bench_config()
        t0 = time.perf_counter()
        got, want, launches, total, _ = spmd_world1_runs(
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
        phase_spmd_world1_collective(seed=23)
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
        got, want, _, tiny_total, _ = spmd_world1_runs(cfg, 2, 64, seed=5,
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
        got, want, launches, total, report = spmd_world1_runs(
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
    log(f"[l-1] collective report of the compiled sharded step at the bench "
        f"widths cut to {cfg.n_layers} layer(s), world-1 mesh (bytes of "
        f"result buffers a step, both programs): {json.dumps(report)}")
    check(report is not None and report["all-reduce"]["count"] >= 1,
          "the world-1 sharded step's report has no all-reduce (the global "
          "norm's)")
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


def phase_spmd_world1_collective(seed):
    """(l-1), the collective groups: a world-1 "mesh" group over the world-1
    gang, `bootstrap_mesh` of the 1 x ... x 1 mesh, and every mesh
    collective on a tensor on the card the identity (allreduce of each op,
    broadcast: x; allgather: x[None]; reducescatter of one chunk: the
    chunk), eagerly and inside one fullgraph function (aot_eager: a graph
    of functional collectives, no inductor compile); numpy values ride
    the host path."""
    from ray_tpu_torch.parallel import gang_cases
    from ray_tpu_torch.parallel.mesh import MeshConfig
    from ray_tpu_torch.util import collective as col

    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.integers(-8, 9, (64, 128)).astype(
        np.float32)).to(DEVICE)
    chunk = torch.from_numpy(rng.integers(-8, 9, (32, 128)).astype(
        np.float32)).to(DEVICE)
    col.init_collective_group(1, 0, "mesh", "world1")
    try:
        mesh = col.bootstrap_mesh(MeshConfig(), group_name="world1")
        t0 = time.perf_counter()
        forms = {form: gang_cases.mesh_collectives(
            "world1", x, [chunk], 0, form == "compiled")
            for form in ("eager", "compiled")}
        secs = time.perf_counter() - t0
        host = col.allreduce({"a": np.arange(3.0)}, "world1")
    finally:
        col.destroy_collective_group("world1")
    xs, cs = x.cpu().numpy(), chunk.cpu().numpy()
    want = {"sum": xs, "product": xs, "min": xs, "max": xs,
            "allgather": xs[None], "broadcast": xs, "reducescatter": cs,
            "reducescatter_tree_g": cs, "reducescatter_tree_h": 2 * cs,
            "bf16_sum": xs}
    same = {form: all(np.array_equal(got[k], w) for k, w in want.items())
            for form, got in forms.items()}
    log(f"[l-1] world-1 mesh collective group on {DEVICE}, mesh "
        f"{dict(zip(mesh.mesh_dim_names, mesh.shape))}: every collective the"
        f" identity eagerly {same['eager']}, compiled (aot_eager, fullgraph) "
        f"{same['compiled']} ({secs:.1f} s); numpy on the host path "
        f"{host['a'].tolist()}")
    check(all(same.values()) and np.array_equal(host["a"], np.arange(3.0)),
          "a world-1 mesh collective is not the identity")


def phase_spmd_cpu_ranks(n_cards):
    """(l-2): with fewer than SPMD_CARDS cards, the 4-rank dry run and
    `cards_collective` on gloo CPU ranks (NCCL takes one rank a card)."""
    from ray_tpu_torch import graft_entry

    log(f"[l-2] this machine has {n_cards} GPU(s); the {SPMD_CARDS}-rank "
        "dry run and the collective groups run on CPU ranks")
    t0 = time.perf_counter()
    lines = graft_entry.dryrun_multichip(SPMD_CARDS, device="cpu")
    check(lines[-1].endswith("all multichip checks passed"),
          "the CPU-rank dry run did not pass")
    log(f"[l-2] the CPU-rank dry run took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    cards_collective(SPMD_CARDS, None, device="cpu")
    log(f"[l-2] the collective groups on {SPMD_CARDS} gloo CPU ranks took "
        f"{time.perf_counter() - t0:.1f} s")


def collective_inputs(seed, n_chunks):
    """Per rank of SPMD_CARDS: x [64, 256] and n_chunks chunks [32, 256],
    integer-valued fp32 (every sum, product, min and max exact in fp32 and
    the sums in bf16)."""
    rng = np.random.default_rng(seed)
    xs = [rng.integers(-3, 4, (64, 256)).astype(np.float32)
          for _ in range(SPMD_CARDS)]
    chunks = [[rng.integers(-3, 4, (32, 256)).astype(np.float32)
               for _ in range(n_chunks)] for _ in range(SPMD_CARDS)]
    return xs, chunks


def collective_expected(xs, chunks, src, spans):
    """Rank r's results of `gang_cases.mesh_collectives` from numpy, where
    spans[r] lists the ranks of r's span in position order."""
    out = []
    for r, span in enumerate(spans):
        x = np.stack([xs[q] for q in span])
        mine = span.index(r)
        ch = np.stack([chunks[q][mine] for q in span])
        out.append({"sum": x.sum(0), "product": x.prod(0), "min": x.min(0),
                    "max": x.max(0), "allgather": x, "broadcast": x[src],
                    "reducescatter": ch.sum(0),
                    "reducescatter_tree_g": ch.sum(0),
                    "reducescatter_tree_h": 2 * ch.sum(0),
                    "bf16_sum": x.sum(0)})
    return out


def cards_collective(n, launches, device=None):
    """(l-3) the collective groups (`ray_tpu_torch.util.collective`) on n
    ranks over NCCL (gloo CPU ranks with device="cpu", (l-2)): mesh groups
    over dp=4, over tp of dp=2 x tp=2 and over both dims of dp=2 x tp=2,
    each collective eagerly and inside an aot_eager fullgraph function on
    tensors on the rank's device, exactly against numpy on integer-valued
    fp32 (and the bf16 sum); the typed errors; the host path on numpy
    values (the four reductions of a pytree, allgather, broadcast,
    reducescatter, a send/recv ring on one tag and two tags received in the
    other order); and, on the card, one 1 GiB bf16 all-reduce's bus
    bandwidth."""
    from ray_tpu_torch.parallel import gang_cases
    from ray_tpu_torch.train.backend import launch_gang

    device = device or DEVICE
    plans = {"dp4": ({"dp": 4}, None, [[0, 1, 2, 3]] * 4),
             "tp_of_2x2": ({"dp": 2, "tp": 2}, ("tp",),
                           [[0, 1], [0, 1], [2, 3], [2, 3]]),
             "2x2": ({"dp": 2, "tp": 2}, None, [[0, 1, 2, 3]] * 4)}
    groups, want = {}, {}
    for i, (name, (mesh_kw, axes, spans)) in enumerate(plans.items()):
        xs, chunks = collective_inputs(31 + i, len(spans[0]))
        groups[name] = (mesh_kw, axes, xs, chunks, 1)
        want[name] = collective_expected(xs, chunks, 1, spans)
    rng = np.random.default_rng(37)
    host = [{"tree": {"a": rng.normal(size=5), "b": [rng.normal(size=(2, 3)),
                                                     rng.integers(1, 5, 4)]},
             "gather": {"r": np.array([r])}, "payload": np.arange(4.0),
             "chunks": [rng.normal(size=3) for _ in range(n)]}
            for r in range(n)]
    cases = [("collective_cases", (groups, host, "dp4"))]
    on_card = torch.device(device).type == "cuda"
    if on_card:
        cases.append(("allreduce_busbw", (COLLECTIVE_BUSBW_BYTES,
                                          COLLECTIVE_BUSBW_ITERS)))
    where = (f"{n} ranks over NCCL" if on_card
             else f"{n} gloo CPU ranks, no GPU")
    res = launch_gang(gang_cases.run_cases, n, device, SPMD_TIMEOUT_S,
                      args=(cases,))
    bad = []
    for r, ranks in enumerate(res):
        got = ranks[0]
        for name in plans:
            for form in ("eager", "compiled"):
                for k, w in want[name][r].items():
                    if not np.array_equal(got["mesh"][name][form][k], w):
                        bad.append((r, name, form, k))
    log(f"[l-3] collective groups ({where}): mesh collectives eager and "
        f"compiled over {list(plans)}, exact against numpy on every rank: "
        f"{not bad} {bad[:8]}")
    check(not bad, f"mesh collectives differ from numpy: {bad[:8]}")
    errors = res[0][0]["errors"]
    keys = {"chunks_eager": "one chunk per",
            "chunks_compiled": "one chunk per",
            "src_eager": "out of range", "src_compiled": "out of range",
            "send_compiled": "custom operator",
            "recv_compiled": "custom operator",
            "noaxes_compiled": "no mesh axes", "dtensor_eager": "DTensor"}
    typed = {k: errors[k].startswith("MeshCollectiveError") and w in errors[k]
             for k, w in keys.items()}
    log(f"[l-3] collective groups: typed errors {typed}; a group of another"
        f" world: {res[0][0]['mismatch'][:60]}")
    check(all(typed.values())
          and res[0][0]["mismatch"].startswith("CollectiveGroupError"),
          f"a typed collective error is missing: {errors}")
    host_ok = _host_path_ok(host, [x[0] for x in res], n)
    log(f"[l-3] collective groups: the host path (numpy over gloo; a "
        f"'host' group and a mesh group's numpy path) against numpy, the "
        f"ring on tag 7 and tags 9 then 8: {host_ok}")
    check(host_ok, "the host path differs from numpy")
    if on_card:
        bw = res[0][1]
        log(f"[l-3] one NCCL all-reduce of {bw['bytes'] / 2**30:.0f} GiB of "
            f"bf16 over {bw['ranks']} GPUs ({nvidia_smi_line()}): "
            f"{bw['ms']:.3f} ms, algbw {bw['algbw'] / 1e9:.2f} GB/s, busbw "
            f"{bw['busbw'] / 1e9:.2f} GB/s")


def _host_path_ok(host, results, n) -> bool:
    """Every rank's host-path results (both groups) against numpy in rank
    order, as the coordinator reduces them."""
    def reduce(op, trees):
        out = trees[0]
        for t in trees[1:]:
            out = {"a": op(out["a"], t["a"]),
                   "b": [op(out["b"][0], t["b"][0]),
                         op(out["b"][1], t["b"][1])]}
        return out

    def same(a, b):
        if isinstance(a, dict):
            return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
        if isinstance(a, (list, tuple)):
            return len(a) == len(b) and all(map(same, a, b))
        return np.array_equal(np.asarray(a), np.asarray(b))

    trees = [v["tree"] for v in host]
    ops = {"sum": np.add, "product": np.multiply, "min": np.minimum,
           "max": np.maximum}
    reduced = {op: reduce(f, trees) for op, f in ops.items()}
    for r, got in enumerate(results):
        for path in ("host", "host_on_mesh"):
            g = got[path]
            want = dict(reduced)
            want.update({
                "allgather": [v["gather"] for v in host],
                "broadcast": host[2]["payload"],
                "reducescatter": functools.reduce(
                    np.add, [v["chunks"][r] for v in host]),
                "ring": (r - 1) % n,
                "tags": [{"tag": 9, "from": (r - 1) % n},
                         {"tag": 8, "from": (r - 1) % n}]})
            if not all(same(g[k], w) for k, w in want.items()):
                return False
    return True


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
    comp = det["sharded"]["compiled"]
    log_report(f"spmd_bench {det['mesh_axes']} compiled",
               comp["collectives_rank0"], comp["nccl_ms_rank0"])
    rel_loss, rel_norm = first_step_rel(det["sharded"]["compiled"],
                                        det["sharded"]["eager"])
    log(f"[l-3] compiled vs eager sharded step, first step from the same "
        f"state: rel loss {rel_loss:.3e}, grad norm {rel_norm:.3e}")
    check(rel_loss <= SPMD_LOSS_REL_TOL and rel_norm <= SPMD_NORM_REL_TOL,
          "the compiled sharded bench step differs from the eager one")


def log_report(tag, report, nccl_ms):
    """Rank 0's collective report of a compiled sharded step (result-buffer
    bytes by kind, a step), beside its NCCL ms and the bytes a second they
    make."""
    from ray_tpu_torch.train.spmd_bench import nccl_split

    if isinstance(nccl_ms, dict):
        nccl_ms = nccl_split(nccl_ms)[0]
    kinds = {k: (v["count"], v["bytes"]) for k, v in report.items()}
    rate = (f"{report['total']['bytes'] / (nccl_ms / 1e3) / 1e9:.2f} GB/s"
            if nccl_ms else "not measured")
    log(f"[l-3] {tag}, rank 0's collectives a step (count, result bytes) "
        f"{kinds}; NCCL {nccl_ms if nccl_ms is None else round(nccl_ms, 2)} "
        f"ms: {rate} ({nvidia_smi_line() if DEVICE == 'cuda' else DEVICE})")
    check(report["total"]["count"] > 0, f"{tag}: no collective reported")


def llama_fsdp_gather_bytes(cfg):
    """The all-gather bytes (result buffers) of one sharded Llama step over
    fsdp alone, from the parameters' shapes and the remat policy: each
    layer's seven matrices gathered in the forward and, under remat, again
    in the backward's rerun (the gathers sit inside the layer's
    checkpoint), the embedding and the lm_head once; the norms are not
    sharded."""
    d, hd = cfg.d_model, cfg.d_head
    layer = (2 * d * cfg.n_heads * hd + 2 * d * cfg.n_kv_heads * hd
             + 3 * d * cfg.d_ff)
    elems = ((2 if cfg.remat else 1) * cfg.n_layers * layer
             + 2 * cfg.vocab_size * d)
    return elems * torch.empty((), dtype=cfg.dtype).element_size()


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
    log_report(f"ring {r['plan']} compiled", comp[0]["collectives"],
               comp[0].get("collectives_ms"))
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
    log_report(f"Mixtral {x['plan']} compiled",
               forms["compiled"][0]["collectives"],
               forms["compiled"][0].get("collectives_ms"))
    rel = abs(forms["compiled"][0]["losses"][0]
              - forms["eager"][0]["losses"][0]) / abs(
        forms["eager"][0]["losses"][0])
    log(f"[l-3] Mixtral compiled vs eager, first step from the same state: "
        f"rel loss {rel:.3e}")
    check(rel <= SPMD_MIXTRAL_REL_TOL, "the compiled Mixtral ep step differs "
          "from the eager one")


def cards_versus_one(tag, family, cfg, plan, batch_np, logical, items,
                     first_step_and_fp32=False):
    """(l-3) `family`'s sharded eager step on the mesh `plan` against the
    one-card step on the same global batch: three steps each, their losses
    within SPMD_ZOO_REL_TOL. With first_step_and_fp32 the three bf16 steps
    are a reading, and the checks are (a) the first step in bf16, the loss
    and every gradient leaf after the data-parallel reduction, before any
    update (loss SPMD_LOSS_REL_TOL, global gradient norm SPMD_NORM_REL_TOL;
    the largest per-leaf relative L2 logged), and (b) the same three steps
    in fp32, TF32 off, within SPMD_ZOO_REL_TOL."""
    from ray_tpu_torch.train import spmd_bench
    from ray_tpu_torch.train.backend import launch_gang

    n = SPMD_CARDS
    res = launch_gang(spmd_bench.versus_one, n, DEVICE, SPMD_TIMEOUT_S,
                      args=(family, cfg, plan, batch_np, logical,
                            SPMD_ZOO_STEPS, 0, 3e-4, False,
                            first_step_and_fp32))
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
    if not first_step_and_fp32:
        check(rel <= SPMD_ZOO_REL_TOL, f"{tag} on the mesh differs from the "
              "one-card step")
        return
    log(f"[l-3] {tag} bf16, {len(one['losses'])} steps: rel gap {rel:.3e} "
        f"(a reading, not a check: one card fed the same batch in another "
        f"order moves {ONE_CARD_REORDER_SPREAD:.3e}, PERF.md)")
    first = res[0]["first"]
    log(f"[l-3] {tag} (a) first step, bf16, after the dp reduction: loss "
        f"{first['loss'][0]} vs {first['loss'][1]} (rel "
        f"{first['loss_rel']:.3e}, bound {SPMD_LOSS_REL_TOL}); global grad "
        f"norm {first['grad_norm'][0]} vs {first['grad_norm'][1]} (rel "
        f"{first['grad_norm_rel']:.3e}, bound {SPMD_NORM_REL_TOL}); largest "
        f"per-leaf rel L2 {first['leaf_rel_max']:.3e} ({first['leaf']})")
    check(first["loss_rel"] <= SPMD_LOSS_REL_TOL
          and first["grad_norm_rel"] <= SPMD_NORM_REL_TOL,
          f"{tag}'s first sharded step differs from the one-card step")
    f32 = res[0]["fp32"]
    rel32 = max(abs(a - b) / abs(b) for a, b in zip(
        f32["mesh"]["losses"], f32["one"]["losses"]))
    log(f"[l-3] {tag} (b) fp32, TF32 off, {len(f32['one']['losses'])} "
        f"steps: losses {f32['mesh']['losses']} vs {f32['one']['losses']}: "
        f"rel {rel32:.3e} (bound {SPMD_ZOO_REL_TOL}); "
        f"{max(r['fp32']['mesh']['step_s'] for r in res) * 1e3:.2f} ms a "
        f"step on {n} GPUs vs {f32['one']['step_s'] * 1e3:.2f} on one")
    check(rel32 <= SPMD_ZOO_REL_TOL, f"{tag}'s fp32 steps on the mesh differ "
          "from the one-card fp32 steps")


def cards_vit(n, launches):
    """(l-3) ViT-B/16 over dp=4 against the one-card step: the first bf16
    step's loss and gradients, and three fp32 steps."""
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
                      "labels": ("batch",)}, b, first_step_and_fp32=True)


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
    report = res[0]["compiled"]["collectives"]
    log_report(f"Llama-3-8B {f['plan']} compiled", report,
               res[0]["compiled"].get("collectives_ms"))
    want = llama_fsdp_gather_bytes(cfg)
    log(f"[l-3] Llama-3-8B {f['plan']}: all-gather bytes a step "
        f"{report['all-gather']['bytes']} vs {want} from the parameters' "
        f"shapes and remat {cfg.remat_policy!r}")
    check(report["all-gather"]["bytes"] == want, "the 8B step's all-gather "
          "bytes differ from its parameters' shapes and remat policy")
    check(rel_loss <= SPMD_LOSS_REL_TOL and rel_norm <= SPMD_NORM_REL_TOL,
          "the compiled Llama-3-8B step differs from the eager one")


def run_train_gang(n, cfg, mesh_kw, tokens, save_after, ckpt_dir, restore,
                   seed, compiled=True):
    """One gang of `parallel.train_gang_cases.train_run` on n ranks that
    join by themselves, as `TorchBackend.on_start` has its workers join:
    each sees every card of this host and binds the one at its local rank
    (all n on this node) and they build the mesh through a fresh "mesh"
    group, each step and then the train function on a thread of its own,
    as in a runtime worker. n == 1 runs in this process and meets at this
    host's name and a port it serves (`gang.gang_address`, as rank 0's
    worker does under `TorchBackend`); n > 1 spawned ranks meet at a file
    store, since this process is none of them. -> the ranks' results."""
    import socket
    import tempfile
    import uuid

    from ray_tpu_torch._private import gang
    from ray_tpu_torch.parallel import train_gang_cases
    from ray_tpu_torch.train import backend

    group = f"rt_train_mesh:{uuid.uuid4().hex[:8]}"
    args = (cfg, mesh_kw, tokens, tokens.shape[0], save_after, ckpt_dir,
            restore)
    kw = dict(seed=seed, device=DEVICE, compiled=compiled,
              timeout_s=SPMD_TIMEOUT_S)
    if n == 1:
        addr = gang.gang_address()
        init_method = f"tcp://{addr['hostname']}:{addr['port']}"
        return [train_gang_cases.train_run(0, 1, init_method, 0, 1, group,
                                           *args, **kw)]
    local = gang.local_ranks([socket.gethostname()] * n)
    with tempfile.TemporaryDirectory() as rendezvous:
        return backend.spawn_ranks(train_gang_cases.gang_ranks, n, DEVICE,
                                   SPMD_TIMEOUT_S, args=(
                                       n, f"file://{rendezvous}/store",
                                       local, [n] * n, group, args, kw))


def check_train_gang(tag, cfg, first, second, tokens):
    """Both gangs' checks: every rank on its own card, the train thread's
    state and batches on that card, the global batch each step assembled
    equal to the seeded one, the restored state (its step counts too) bit
    for bit the saved one on every rank, the restarted step within GANG_REL_TOL of
    the first gang's, 2L / L / L launches a step. -> rank 0's relative
    gap."""
    n = len(first)
    for res in (first, second):
        cards = [r["card"] for r in res]
        check(DEVICE != "cuda" or len(set(cards)) == n,
              f"{tag}: ranks share a card: {cards}")
        check(all(all(r["global_equal"]) for r in res),
              f"{tag}: an assembled global batch differs from the seeded "
              "one")
        # The train function runs on a thread of its own and names no
        # device: its state and batches must still be on the bound card.
        on = [r["step_cards"] for r in res]
        check(all(c == [str(r["card"])] for c, r in zip(on, res)),
              f"{tag}: the train thread's tensors lie on cards {on}, not "
              f"on the bound {cards}")
    same = [a["saved"] == b["restored"] for a, b in zip(first, second)]
    check(all(same), f"{tag}: the restored state differs from the saved "
          f"one on ranks {[r for r, ok in enumerate(same) if not ok]}")
    k = second[0]["first_step"]
    rel = [abs(b["losses"][0] - a["losses"][k]) / abs(a["losses"][k])
           for a, b in zip(first, second)]
    want = {"flash_fwd": 2 * cfg.n_layers, "flash_bwd_dq": cfg.n_layers,
            "flash_bwd_dkv": cfg.n_layers}
    launches = [x for res in (first, second) for r in res
                for x in r["launches"]]
    log(f"[{tag}] {n} rank(s) on cards {[r['card'] for r in first]} then "
        f"{[r['card'] for r in second]} ({nvidia_smi_line() if DEVICE == 'cuda' else DEVICE}); "
        f"mesh {first[0]['mesh']}, data positions "
        f"{[r['position'] for r in first]}; bind s (the first CUDA call) "
        f"{[round(r['bind_s'], 3) for r in first]} then "
        f"{[round(r['bind_s'], 3) for r in second]}, join s (the "
        f"rendezvous, waiting for the last rank) "
        f"{[round(r['join_s'], 3) for r in first]} then "
        f"{[round(r['join_s'], 3) for r in second]}, mesh bootstrap s "
        f"{[round(r['mesh_s'], 3) for r in first]} then "
        f"{[round(r['mesh_s'], 3) for r in second]}; save s "
        f"{round(first[0]['save_s'], 2)}, restore s "
        f"{[round(r['restore_s'], 2) for r in second]}; rank 0's step s (the "
        f"first with its compile) {[round(x, 4) for x in first[0]['step_s']]}"
        f" then {[round(x, 4) for x in second[0]['step_s']]}; losses "
        f"{first[0]['losses']}, restarted step {k + 1} "
        f"{[r['losses'][0] for r in second]}: rel {max(rel):.3e} (bound "
        f"{GANG_REL_TOL}); restored bit for bit on every rank {all(same)}; "
        f"launches a step {launches[0]}")
    check(max(rel) <= GANG_REL_TOL, f"{tag}: the restarted step {k + 1} "
          "differs from the first gang's")
    check(DEVICE != "cuda" or all(x == want for x in launches),
          f"{tag}: launches a step {launches}, not {want}")
    return max(rel)


def cards_train_gang(n, launches):
    """(l-3) Train's gang on n cards: two gangs of spawned ranks that join
    by themselves over fsdp=2 x tp=2, the second restoring the first's
    checkpoint (`check_train_gang`)."""
    import dataclasses
    import shutil
    import tempfile

    g = GANG_CARDS
    cfg = dataclasses.replace(bench_config(), n_layers=g["layers"])
    tokens = np.stack([spmd_tokens(cfg, g["batch"], g["seq"], 41 + i)
                       for i in range(GANG_STEPS)])
    root = tempfile.mkdtemp(prefix="chip_smoke_train_gang_")
    try:
        ckpt = os.path.join(root, "ckpt")
        first = run_train_gang(n, cfg, g["plan"], tokens, GANG_SAVE_AFTER,
                               ckpt, False, seed=43)
        second = run_train_gang(n, cfg, g["plan"], tokens, GANG_SAVE_AFTER,
                                ckpt, True, seed=44)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    check_train_gang("l-3 train_gang", cfg, first, second, tokens)
    add_launches(launches["spmd_compiled"], first + second)


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


CARDS_PARTS = (cards_collective, cards_bench, cards_ring, cards_mixtral,
               cards_vit, cards_t5, cards_pipeline, cards_engine,
               cards_llama8b, cards_train_gang)


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
    """(l): the SPMD path. -> the kernel launches of its main paths. With
    fewer than SPMD_CARDS cards, (l-2)'s CPU ranks, which use no card,
    run on a thread of their own while (l-1) runs on the card, and (l)
    ends when both have."""
    import threading

    n_cards = torch.cuda.device_count()
    branch = "(l-3)" if n_cards >= SPMD_CARDS else "(l-2)"
    log(f"[l] {n_cards} GPU(s) visible: (l-1), then {branch}")
    cpu_ranks, failed = None, []
    if n_cards < SPMD_CARDS:
        def run_cpu_ranks():
            try:
                phase_spmd_cpu_ranks(n_cards)
            except BaseException as e:  # noqa: BLE001 — raised at the join
                failed.append(e)

        cpu_ranks = threading.Thread(target=run_cpu_ranks, daemon=True,
                                     name="chip-smoke-l2")
        cpu_ranks.start()
    try:
        launches = phase_spmd_world1(eager_first)
    finally:
        if cpu_ranks is not None:
            cpu_ranks.join()
    if failed:
        raise failed[0]
    if n_cards >= SPMD_CARDS:
        for path, counts in phase_spmd_cards().items():
            for k, v in counts.items():
                launches[path][k] += v
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
# (o-3): BatchPredictor over ViT-B/16 (bf16) from a checkpoint, these rows
# in batches of this size through a stand-in dataset.
BATCH_PREDICT_ROWS = 256
BATCH_PREDICT_SIZE = 64


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


class InProcessDataset:
    """A stand-in for a dataset: `map_batches(fn, batch_size=)` runs `fn`
    on each block of `batch_size` rows in this process, in order, where
    the runtime's Dataset runs map tasks in its workers. Columns of numpy
    arrays."""

    def __init__(self, columns):
        self.columns = columns

    def map_batches(self, fn, batch_size=None):
        n = len(next(iter(self.columns.values())))
        size = batch_size or n
        outs = [fn({k: v[i:i + size] for k, v in self.columns.items()})
                for i in range(0, n, size)]
        return InProcessDataset({k: np.concatenate([o[k] for o in outs])
                                 for k in outs[0]})


def phase_batch_predictor(card, seed=31):
    """(o-3) BatchPredictor over ViT-B/16 (bf16) from a checkpoint:
    BATCH_PREDICT_ROWS seeded images in batches of BATCH_PREDICT_SIZE
    through `InProcessDataset`; its outputs against CompiledPredictor's
    predict on the same rows (bit for bit), one load of the checkpoint in
    the process and one compile per bucket. -> its numbers."""
    import shutil
    import tempfile

    from ray_tpu_torch.models import vit
    from ray_tpu_torch.train.checkpoint import Checkpoint
    from ray_tpu_torch.train import predictor as tp

    cfg = vit.ViTConfig.base_16()
    params = vit.init(cfg, torch.Generator(device=DEVICE).manual_seed(23),
                      device=DEVICE)
    apply_fn = functools.partial(vit.forward, config=cfg)
    loads = []

    class Counted(tp.CompiledPredictor):
        @classmethod
        def from_checkpoint(cls, checkpoint, **kwargs):
            loads.append(os.getpid())
            return super().from_checkpoint(checkpoint, **kwargs)

    x = np.random.default_rng(seed).standard_normal(
        (BATCH_PREDICT_ROWS, cfg.image_size, cfg.image_size,
         cfg.num_channels)).astype(np.float32)
    root = tempfile.mkdtemp(prefix="chip_smoke_batch_predict_")
    try:
        ckpt = Checkpoint.from_arrays(params, os.path.join(root, "vit"))
        del params
        tp._PREDICTOR_CACHE.clear()
        bp = tp.BatchPredictor(ckpt, Counted, apply_fn=apply_fn,
                               device=DEVICE)
        t0 = time.perf_counter()
        got = bp.predict(InProcessDataset({"inputs": x}),
                         batch_size=BATCH_PREDICT_SIZE).columns
        first_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        again = bp.predict(InProcessDataset({"inputs": x}),
                           batch_size=BATCH_PREDICT_SIZE).columns
        warm_s = time.perf_counter() - t0
        pred = tp._PREDICTOR_CACHE[bp.cache_key()]
        ref = tp.CompiledPredictor.from_checkpoint(ckpt, apply_fn=apply_fn,
                                                   device=DEVICE)
        want = np.concatenate([
            ref.predict({"inputs": x[i:i + BATCH_PREDICT_SIZE]})[
                "predictions"]
            for i in range(0, BATCH_PREDICT_ROWS, BATCH_PREDICT_SIZE)])
    finally:
        shutil.rmtree(root, ignore_errors=True)
        tp._PREDICTOR_CACHE.clear()
    same = (got["predictions"].shape == want.shape
            and np.array_equal(got["predictions"], want)
            and np.array_equal(again["predictions"], want))
    buckets = sorted({tp._bucket(min(BATCH_PREDICT_SIZE, BATCH_PREDICT_ROWS
                                     - i))
                      for i in range(0, BATCH_PREDICT_ROWS,
                                     BATCH_PREDICT_SIZE)})
    log(f"[o-3] ({card}) BatchPredictor ViT-B/16 bf16 from a checkpoint, "
        f"{BATCH_PREDICT_ROWS} rows in batches of {BATCH_PREDICT_SIZE} "
        f"through a stand-in dataset: outputs {want.shape} bit for bit "
        f"CompiledPredictor's {same}; checkpoint loads {len(loads)}, "
        f"compiles {pred.compiles} for buckets {sorted(pred.buckets)}; "
        f"{first_s:.2f} s the first pass (load and compile), {warm_s:.3f} s "
        f"the second ({BATCH_PREDICT_ROWS / warm_s:.1f} images/s)")
    check(same, "(o-3) the batch predictor's outputs differ from "
          "CompiledPredictor.predict on the same rows")
    check(len(loads) == 1, f"(o-3) {len(loads)} checkpoint loads in one "
          "process, not 1")
    check(sorted(pred.buckets) == buckets and pred.compiles == len(buckets),
          f"(o-3) {pred.compiles} compiles for buckets {pred.buckets}, not "
          f"one for each of {buckets}")
    return {"rows": BATCH_PREDICT_ROWS, "batch_size": BATCH_PREDICT_SIZE,
            "loads": len(loads), "compiles": pred.compiles,
            "first_s": first_s, "warm_s": warm_s,
            "images_per_s": BATCH_PREDICT_ROWS / warm_s}


def phase_train_io(card, compare=False):
    """(o): (o-1) the checkpoint of the compiled step's state, then (o-2)
    the compiled predictor (`compare`: beside COMPILE_BACKEND's) and (o-3)
    the batch predictor. -> the flash kernels' launches of (o-1), and the
    predictors' numbers."""
    t0 = time.perf_counter()
    reset_kernel_counts()
    with _recompiles():  # the script has compiled llama.loss_fn before
        launches = phase_checkpoint(card)
        gc.collect()
        torch.cuda.empty_cache()
        predict = phase_predictor(card, compare)
        gc.collect()
        torch.cuda.empty_cache()
        predict["batch_predictor"] = phase_batch_predictor(card)
    log(f"[o] Train's checkpoint and predictor: "
        f"{time.perf_counter() - t0:.1f} s")
    return launches, predict


# -- (p) Train's gang -----------------------------------------------------------

def phase_train_gang(card):
    """(p) The worker side of Train's gang at world 1 in this process
    (`run_train_gang`, `check_train_gang`): the compiled bench step at
    GANG_LAYERS layer(s), GANG_STEPS steps fed per data position, the state
    saved after GANG_SAVE_AFTER, the gang left, joined again, the state
    restored and the next step run again. -> the kernels' launches (set to
    0 just before, read just after)."""
    import dataclasses
    import shutil
    import tempfile

    cfg = dataclasses.replace(bench_config(), n_layers=GANG_LAYERS)
    b, s = TRAIN_ATTN[0], TRAIN_ATTN[1]
    tokens = np.stack([spmd_tokens(cfg, b, s, 51 + i)
                       for i in range(GANG_STEPS)])
    root = tempfile.mkdtemp(prefix="chip_smoke_gang_")
    t0 = time.perf_counter()
    reset_kernel_counts()
    try:
        ckpt = os.path.join(root, "ckpt")
        first = run_train_gang(1, cfg, {}, tokens, GANG_SAVE_AFTER, ckpt,
                               False, seed=53)
        second = run_train_gang(1, cfg, {}, tokens, GANG_SAVE_AFTER, ckpt,
                                True, seed=54)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    counts = kernel_counts()
    check_train_gang("p", cfg, first, second, tokens)
    steps = len(first[0]["losses"]) + len(second[0]["losses"])
    want = {"flash_fwd": 2 * cfg.n_layers * steps,
            "flash_bwd_dq": cfg.n_layers * steps,
            "flash_bwd_dkv": cfg.n_layers * steps}
    log(f"[p] ({card}) the gang's training path at world 1, {cfg.n_layers} "
        f"layer(s), B={b} S={s}: {steps} steps, launches {counts} (want "
        f"{want}); {time.perf_counter() - t0:.1f} s")
    check(DEVICE != "cuda" or counts == want,
          f"(p) launches {counts}, not {want}")
    gc.collect()
    torch.cuda.empty_cache()
    return counts


# -- (q) RLlib's remote env runners and learners --------------------------------

def phase_rl_remote(card):
    """(q) The remote RL groups' work on the card, through the stand-in
    actors of `rllib.remote_cases`: (q-1) the learners' update and
    parameter mean against the CPU, (q-2) the weights on the wire and two
    remote runners against in-process ones, (q-3) IMPALA's in-flight
    pipeline and a runner's failure. -> its numbers."""
    from ray_tpu_torch.rllib import remote_cases as rc

    t0 = time.perf_counter()
    learners = rc.learner_case(DEVICE)
    log(f"[q-1] ({card}) LearnerGroup of 2 PPO learners (fp32, CartPole at "
        f"PPO's default widths) on {rc.LEARNER_ROWS} seeded rows: the mean "
        f"weights and the averaged metrics against the CPU within "
        f"{rc.ATOL:g} + {rc.RTOL:g} |ref|, largest differences "
        f"{learners['max_abs_err_weights']:.3e} / "
        f"{learners['max_abs_err_metrics']:.3e}; one learner's update "
        f"{learners['update_ms']:.3f} ms; the mean: gather "
        f"{learners['gather_ms']:.3f} ms, mean {learners['mean_ms']:.3f} ms,"
        f" set {learners['set_ms']:.3f} ms")
    runners = rc.runner_case(DEVICE, learners["mean"])
    log(f"[q-2] ({card}) the mean state dict ({runners['tensors']} tensors, "
        f"{runners['bytes']} B) bit for bit through the typed tensor wire "
        f"({runners['wire_ms']:.3f} ms a round trip); 2 remote runners x "
        f"{rc.RUNNER_STEPS} steps: {runners['transitions']} transitions, "
        f"obs, actions and rewards equal to in-process runners', logp and "
        f"vf_preds within {runners['max_abs_err_logp_vf']:.3e}")
    pipeline = rc.pipeline_case(DEVICE)
    rows = pipeline["iterations"]
    log(f"[q-3] ({card}) IMPALA over 2 remote runners, {rc.IN_FLIGHT} calls "
        f"in flight each: {pipeline['updates']} updates from armed calls; "
        f"runner {pipeline['failed_slot']} failed with armed calls: "
        f"{pipeline['dropped']} failed calls dropped by the pipeline, slot "
        f"replaced and re-armed, policy_version "
        f"{pipeline['policy_version']}, membership {pipeline['membership']};"
        f" seconds per iteration (waiting for a fragment, learning): "
        f"{[(round(w, 6), round(l, 6)) for w, l in rows]}")
    log(f"[q] the remote RL groups: {time.perf_counter() - t0:.1f} s")
    return {"learners": {k: v for k, v in learners.items()
                         if k not in ("mean", "metrics")},
            "runners": runners,
            "pipeline": {"wait_s": [w for w, _ in rows],
                         "learn_s": [l for _, l in rows],
                         "updates": pipeline["updates"],
                         "dropped": pipeline["dropped"],
                         "failed_slot": pipeline["failed_slot"],
                         "membership": pipeline["membership"]}}


# -- (s) the decoupled RL dataflow and lower_to_jit -----------------------------

# (s-2): each runner count of `benchmark_decoupled` runs this many seconds
# (JAX's default: 8).
DATAFLOW_BENCH_S = 4.0
# (s-3): lower_to_jit's input, fp32, and the card's program against the
# eager DAG: |a - b| <= DAG_ATOL + DAG_RTOL |b|.
DAG_SHAPE = (1024, 1024)
DAG_ATOL, DAG_RTOL = 1e-5, 1e-5


def phase_dataflow(card):
    """(s) (s-1) decoupled IMPALA through the stand-in actors with a
    failed runner and a stale jump, (s-2) `benchmark_decoupled`, (s-3)
    `lower_to_jit` on the card against the eager DAG. -> its numbers."""
    from ray_tpu_torch.dag import evaluate, lower_to_jit
    from ray_tpu_torch.rllib import dataflow_cases as dc
    from ray_tpu_torch.rllib.benchmarks import benchmark_decoupled
    from ray_tpu_torch.rllib.remote_cases import LocalRuntime

    t0 = time.perf_counter()
    flow = dc.decoupled_case(DEVICE)
    pull_s = sum(w for w, _ in flow["updates"])
    learn_s = sum(l for _, l in flow["updates"])
    log(f"[s-1] ({card}) decoupled IMPALA over 2 stand-in runners, "
        f"{len(flow['updates'])} updates: runner {flow['failed_slot']} "
        f"failed and was respawned; the version jumped to "
        f"{flow['jumped_to']}: {flow['stale_dropped']} stale batches "
        f"dropped, {flow['stale_trained']} trained on; "
        f"{flow['discarded_dead']} batches of the dead runner discarded; "
        f"events {flow['events']}; the first update against the CPU's, "
        f"largest differences {flow['max_abs_err_first_update_metrics']:.3e}"
        f" (metrics) / {flow['max_abs_err_first_update_weights']:.3e} "
        f"(weights) within {dc.rc.ATOL:g} + {dc.rc.RTOL:g} |ref|; the "
        f"learner's seconds pulling {pull_s:.6f} against learning "
        f"{learn_s:.6f}; per update (pull, learn) "
        f"{[(round(w, 6), round(l, 6)) for w, l in flow['updates']]}")
    t1 = time.perf_counter()
    runtime = LocalRuntime()
    try:
        bench = benchmark_decoupled((1, 2), duration_s=DATAFLOW_BENCH_S,
                                    device=DEVICE, runtime=runtime)
    finally:
        runtime.shutdown()
    per = bench["detail"]["per_worker_counts"]
    check(set(per) == {"1", "2"} and all(v > 0 for v in per.values()),
          f"benchmark_decoupled consumed {per}")
    log(f"[s-2] ({card}) benchmark_decoupled at JAX's widths, 1 and 2 "
        f"runners x {DATAFLOW_BENCH_S:g} s: {per} env-steps/s consumed by "
        f"the learner (scaling {bench['detail']['scaling']:.3f}; "
        f"{bench['detail']['host_cpus']} host CPUs; stand-in actors: "
        f"threads of this process); {time.perf_counter() - t1:.1f} s")
    t2 = time.perf_counter()
    gen = torch.Generator(device="cpu").manual_seed(23)
    inputs = {n: torch.randn(DAG_SHAPE, generator=gen).to(DEVICE)
              for n in ("x", "y")}
    dags = {"workflow": (dc.workflow_dag, inputs["x"]),
            "diamond": (dc.diamond_dag, inputs)}
    out = {}
    for name, (build, x) in dags.items():
        dag = build(dc.remote, dc.InputNode, dc.MultiOutputNode)
        fn = lower_to_jit(dag, backend=COMPILE_BACKEND)
        tc = time.perf_counter()
        got = fn(x)
        torch.cuda.synchronize()
        compile_s = time.perf_counter() - tc
        want = evaluate(dag, x)
        err = 0.0
        for g, w in zip(got, want):
            check(g.shape == w.shape and bool(torch.all(
                (g - w).abs() <= DAG_ATOL + DAG_RTOL * w.abs())),
                f"lower_to_jit's {name} differs from the eager DAG")
            err = max(err, float((g - w).abs().max()))
        out[name] = {"max_abs_err": err, "compile_s": compile_s,
                     "ms": cuda_ms(lambda: fn(x)),
                     "eager_ms": cuda_ms(lambda: evaluate(dag, x))}
    log(f"[s-3] ({card}) lower_to_jit ({COMPILE_BACKEND}) on "
        f"{DAG_SHAPE} fp32 against the eager DAG within {DAG_ATOL:g} + "
        f"{DAG_RTOL:g} |ref|: " + "; ".join(
            f"{n}: largest difference {v['max_abs_err']:.3e}, first call "
            f"(compiles) {v['compile_s']:.2f} s, {v['ms']:.4f} ms a call "
            f"against {v['eager_ms']:.4f} ms eagerly"
            for n, v in out.items()) +
        f"; {time.perf_counter() - t2:.1f} s")
    log(f"[s] the decoupled dataflow and lower_to_jit: "
        f"{time.perf_counter() - t0:.1f} s")
    return {"impala": {k: v for k, v in flow.items() if k != "updates"},
            "pull_s": [w for w, _ in flow["updates"]],
            "learn_s": [l for _, l in flow["updates"]],
            "benchmark_decoupled": bench, "lower_to_jit": out}


# -- (t) the node's advertisement, typed tensors through shared pages ---------

# (t-2): the stand-in arena, at the runtime's default object store capacity
# (`object_store_memory_bytes`, 2 GiB), the timed payload (the data-plane
# bench's), and the rounds a rate is the least of.
STORE_ARENA_BYTES = 2 << 30
STORE_PAYLOAD_BYTES = 64 << 20
STORE_ITERS = 5


def store_cases():
    """(t-2)'s tensors on the card: every dtype kind the wire carries, an
    empty and a 0-d one."""
    g = torch.Generator(device=DEVICE).manual_seed(43)
    return {
        "fp32": torch.randn((257, 129), generator=g, device=DEVICE),
        "bf16": torch.randn((64, 96), generator=g, device=DEVICE).to(
            torch.bfloat16),
        "int64": torch.arange(-5000, 5000, device=DEVICE),
        "bool": torch.randn((1001,), generator=g, device=DEVICE) > 0,
        "empty": torch.empty((0, 7), device=DEVICE),
        "0-d": torch.tensor(2.75, device=DEVICE),
    }


def store_arena():
    """The stand-in arena, sparse as the store's: a STORE_ARENA_BYTES memfd
    (as the store's own arena is) mapped twice, shared: writable (the
    putting side) and read-only (the getting side, as an object-store
    reader sees a sealed object). -> (writer, reader)."""
    import mmap

    fd = os.memfd_create("chip_smoke_arena")
    try:
        os.ftruncate(fd, STORE_ARENA_BYTES)
        return (mmap.mmap(fd, STORE_ARENA_BYTES),
                mmap.mmap(fd, STORE_ARENA_BYTES, prot=mmap.PROT_READ))
    finally:
        os.close(fd)


def resident(addr):
    """The resident bytes of this process's mapping that holds `addr` (its
    Rss in /proc/self/smaps). The file's own blocks cannot stand in: the
    card's machine reports a memfd's every page as committed."""
    inside = False
    with open("/proc/self/smaps") as f:
        for line in f:
            head = line.split(maxsplit=1)[0]
            if not head.endswith(":"):
                lo, hi = (int(a, 16) for a in head.split("-"))
                inside = lo <= addr < hi
            elif inside and head == "Rss:":
                return int(line.split()[1]) * 1024
    raise RuntimeError(f"no mapping holds {addr:#x}")


def store_rates(src, n, dev):
    """GB/s of copying the n bytes of `src` (a CPU view of the read-only
    arena mapping) to the card, the least of STORE_ITERS: the pageable copy
    that the wire made before it registered the arena, then the yardstick,
    a pinned host buffer. Run before the wire registers the windows that
    hold `src`."""
    from ray_tpu_torch._private import pinned_pages as pp

    dst = torch.empty(n, dtype=torch.uint8, device=dev)
    pinned = torch.empty(n, dtype=torch.uint8, pin_memory=True)

    def pageable():
        dst.copy_(src)
        torch.cuda.synchronize(dev)

    designs = {"pageable": pageable,
               "pinned_h2d": lambda: pp.copy_pinned(dst, pinned)}
    out = {}
    for name, fn in designs.items():
        best = float("inf")
        for _ in range(STORE_ITERS):
            t0 = time.perf_counter()
            fn()
            best = min(best, time.perf_counter() - t0)
        if name != "pinned_h2d":
            check(torch.equal(dst.cpu(), src), f"(t-2) {name} changed bytes")
        out[name] = n / best / 1e9
    return out


def phase_store(card):
    """(t) (t-1) the node's advertisement against the card, (t-2) typed
    tensors through the stand-in arena. -> its numbers."""
    from ray_tpu_torch._private import pinned_pages as pp
    from ray_tpu_torch._private import serialization as ser
    from ray_tpu_torch._private.accelerators import nvidia

    t0 = time.perf_counter()
    resources, labels = nvidia.node_advertisement()
    count = torch.cuda.device_count()
    smi = nvidia.GpuInfo(1, (card.split(",")[0].strip(),), (0,))
    typed = nvidia.typed_resource(smi)
    check(resources.get("GPU") == count and resources.get(typed) == count
          and labels.get(nvidia.ACCELERATOR_TYPE_LABEL)
          == smi.accelerator_type,
          f"(t-1) the advertisement {resources}, {labels} against "
          f"{count} card(s) named {smi.names[0]!r} by nvidia-smi")
    log(f"[t-1] ({card}) node_advertisement(): resources {resources}, "
        f"labels {labels}: {count} card(s), typed {typed}; "
        f"{time.perf_counter() - t0:.1f} s (its probe process)")

    t1 = time.perf_counter()
    dev = torch.device(DEVICE, 0) if DEVICE == "cuda" else torch.device(
        DEVICE)
    writer, reader = store_arena()
    wview, rview = memoryview(writer), memoryview(reader)
    check(rview.readonly, "(t-2) the reading side is writable")
    base = np.frombuffer(reader, dtype=np.uint8).ctypes.data
    pageable0 = ser.COPY_STATS["typed_tensor_get_pageable"]
    n = STORE_PAYLOAD_BYTES
    try:
        # The 64 MiB tensor near the arena's end: its puts, then the
        # pageable copy and the yardstick, then its gets as the wire makes
        # them, the first registering the windows it spans.
        big = torch.arange(n // 8, dtype=torch.int64, device=dev)
        off = STORE_ARENA_BYTES - 2 * n
        puts = []
        for _ in range(STORE_ITERS):
            ts = time.perf_counter()
            size = ser.serialize(big).write_into(wview[off:])
            puts.append(time.perf_counter() - ts)
        obj = rview[off:off + size]
        payload = ser.SerializedObject.from_bytes(obj).buffers[0].raw()
        with warnings.catch_warnings():  # read-only pages
            warnings.simplefilter("ignore", UserWarning)
            src = torch.frombuffer(payload, dtype=torch.uint8)
        rates = store_rates(src, n, dev)
        del src, payload
        ser.install_tensor_wire()  # what a process's first get does first
        rss0 = resident(base)
        gets = []
        for _ in range(STORE_ITERS + 1):
            ts = time.perf_counter()
            got = ser.deserialize(ser.SerializedObject.from_bytes(obj))
            torch.cuda.synchronize(dev)
            gets.append(time.perf_counter() - ts)
            check(got.device == dev and torch.equal(got, big),
                  "(t-2) the 64 MiB get changed it")
            del got
        del obj
        # Every kind of tensor the wire carries, at the arena's start.
        off = 0
        for name, t in store_cases().items():
            size = ser.serialize(t).write_into(wview[off:])
            got = ser.deserialize(ser.SerializedObject.from_bytes(
                rview[off:off + size]))
            if got.is_cuda:  # the copy has landed: the arena may change
                wview[off:off + size] = b"\xff" * size
            check(got.device == dev and got.dtype == t.dtype
                  and got.shape == t.shape and torch.equal(got, t),
                  f"(t-2) {name}: the get through the arena changed it")
            off += -(-size // 4096) * 4096
            del got
        # A small tensor's get once its window is registered, and from a
        # bytes frame (the pageable route, with no look at the mappings).
        small = store_cases()["fp32"]
        size = ser.serialize(small).write_into(wview[off:])
        frame = ser.serialize(small).to_bytes()
        small_us = {}
        for route, data in (("arena", rview[off:off + size]),
                            ("bytes", frame)):
            best = float("inf")
            for _ in range(STORE_ITERS):
                ts = time.perf_counter()
                got = ser.deserialize(ser.SerializedObject.from_bytes(data))
                best = min(best, time.perf_counter() - ts)
                check(torch.equal(got, small), f"(t-2) the small {route} "
                      "get changed it")
            small_us[route] = best * 1e6
            del got, data
        check(ser.COPY_STATS["typed_tensor_get_pageable"] - pageable0
              == (STORE_ITERS if DEVICE == "cuda" else 0),
              "(t-2) the bytes frame's gets were not counted pageable")
        pageable0 += STORE_ITERS if DEVICE == "cuda" else 0
        windows = pp.pinned_windows()
        registered = sum(e - w for w, e, _ in windows)
        rss1 = resident(base)
        # The 64 MiB object spans two windows, the small ones the first.
        check(DEVICE != "cuda" or (
            len(windows) == 3 and registered == 3 * pp.WINDOW_BYTES
            and all(base <= w and e <= base + STORE_ARENA_BYTES
                    and not writable for w, e, writable in windows)),
              f"(t-2) the registered windows {windows}, not three "
              f"read-only windows of the reader's mapping at {base:#x}")
        check(DEVICE != "cuda" or rss1 <= registered,
              f"(t-2) {rss1} bytes of the reader's mapping resident after "
              f"the gets, more than the {registered} registered")
        pageable = ser.COPY_STATS["typed_tensor_get_pageable"] - pageable0
        check(pageable == 0, f"(t-2) {pageable} get(s) took the pageable "
              "route from the arena")
        rates.update({"put": n / min(puts) / 1e9,
                      "get": n / min(gets[1:]) / 1e9,
                      "first_get_s": gets[0], "registered_bytes": registered,
                      "small_get_us": small_us,
                      "rss": [rss0, rss1]})
    finally:
        pp.unpin_mapping(base)  # before the mapping goes
        del wview, rview, writer, reader  # unmapped once the views die
        gc.collect()
    mib = 1 << 20
    log(f"[t-2] ({card}) fp32, bf16, int64, bool, empty and 0-d tensors "
        f"through a {STORE_ARENA_BYTES >> 20} MiB memfd arena (read-only "
        f"reader mapping): exact on {dev}, 0 pageable gets. {n >> 20} MiB "
        f"int64: get {rates['get']:.2f} GB/s (the windows it spans "
        f"registered once; the first get, which registers them, "
        f"{rates['first_get_s']:.4f} s) against a pinned host-to-device "
        f"copy {rates['pinned_h2d']:.2f} GB/s; the pageable copy from the "
        f"arena {rates['pageable']:.2f} GB/s; put (pinned device-to-host, "
        f"then write_into) {rates['put']:.2f} GB/s; each the least of "
        f"{STORE_ITERS}. A {small.nbytes >> 10} KiB tensor's get "
        f"{rates['small_get_us']['arena']:.1f} us from the arena, "
        f"{rates['small_get_us']['bytes']:.1f} us from a bytes frame. "
        f"Registered {registered / mib:.0f} MiB in "
        f"{len(windows)} windows of {pp.WINDOW_BYTES >> 20} MiB; the reader "
        f"mapping's resident pages {rates['rss'][0] / mib:.1f} MiB before "
        f"the gets, {rates['rss'][1] / mib:.1f} MiB after; "
        f"{time.perf_counter() - t1:.1f} s")
    log(f"[t] the advertisement and the arena: "
        f"{time.perf_counter() - t0:.1f} s")
    return {"advertisement": {"resources": resources, "labels": labels},
            "gbps": {k: rates[k] for k in ("get", "pinned_h2d", "pageable",
                                           "put")},
            "first_get_s": rates["first_get_s"],
            "small_get_us": rates["small_get_us"],
            "arena_bytes": STORE_ARENA_BYTES,
            "registered_bytes": registered,
            "reader_resident_bytes": rates["rss"]}


# -- (r) the serving benchmarks ------------------------------------------------

# (r-1) `benchmark_serving` and (r-2) `run_prefix_ttft_benchmark`, at the
# reference's defaults.
SERVING_BENCH = dict(num_replicas=2, n_requests=24, arrival_rate_hz=8.0,
                     max_new_tokens=12, prompt_len=8)
PREFIX_BENCH = dict(n_requests=6, shared_prefix_len=448, tail_len=8)
# (r-0): one prefill wave at the prefix benchmark's engine settings, of
# these (tokens, offset): a cold prompt and a hit's tail.
PREFILL_WAVES = ((456, 0), (8, 448))
PREFILL_TIMED = 5


def _phase_counts(profiler):
    """{phase: observations} of the phase histogram for `profiler`."""
    from ray_tpu_torch._private import device_profiler

    hist = device_profiler._metrics()[0]
    with hist._lock:
        return {dict(k)["phase"]: n for k, n in hist._totals.items()
                if dict(k)["profiler"] == profiler}


def _new_events(prefix, seq):
    from ray_tpu_torch.util import metrics

    return [e for e in metrics.events(prefix) if e["seq"] > seq]


def prefill_graph_check(cfg, params, card, seed=41):
    """(r-0) One prefill wave (`PagedInferenceEngine._prefill`) at the
    prefix benchmark's engine settings, for each of PREFILL_WAVES, run
    eagerly and as its CUDA graph in turns (eager, graph, graph, eager):
    the first tokens equal, the ms a wave (host clock, synchronised) of
    each. -> {wave: {mode: [ms, ms]}}."""
    from ray_tpu_torch.inference import GenerationConfig
    from ray_tpu_torch.inference.paged_engine import PagedInferenceEngine

    max_len = 2 * PREFIX_BENCH["shared_prefix_len"]
    eng = PagedInferenceEngine(params, cfg, max_batch=4, max_len=max_len,
                               block_size=16, n_blocks=4 * (max_len // 16),
                               decode_chunk=4, device=DEVICE)
    graphs = eng._decoder.use_graph  # on the card; a rehearsal has none
    rng = np.random.default_rng(seed)
    rows = np.arange(1, 1 + eng.max_blocks_per_seq)[None]
    gen = GenerationConfig()
    out = {}
    for n_tok, offset in PREFILL_WAVES:
        bucket = eng._bucket_for(n_tok)
        toks = np.zeros((1, bucket), np.int64)
        toks[0, :n_tok] = rng.integers(1, cfg.vocab_size, n_tok)
        args = (toks, rows, np.array([n_tok]), np.array([offset]))
        ms, firsts = {}, {}
        for mode in (False, graphs, graphs, False):
            eng._decoder.use_graph = mode
            eng._prefill(*args, gen)  # the graph's capture, the first time
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(PREFILL_TIMED):
                first = eng._prefill(*args, gen)
            torch.cuda.synchronize()
            name = "graph" if mode else "eager"
            ms.setdefault(name, []).append(
                (time.perf_counter() - t0) / PREFILL_TIMED * 1e3)
            firsts.setdefault(name, []).append(first.tolist())
        eng._decoder.use_graph = graphs
        log(f"[r-0] ({card}) a prefill wave of {n_tok} tokens at offset "
            f"{offset} (bucket {bucket}), ms a wave in turns: "
            + ", ".join(f"{k} {[round(v, 3) for v in vs]}"
                        for k, vs in ms.items())
            + f"; first tokens {firsts}")
        check(all(f == firsts["eager"][0] for fs in firsts.values()
                  for f in fs),
              f"(r-0) the prefill graph's first tokens differ: {firsts}")
        out[f"{n_tok}@{offset}"] = ms
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_serving_bench(cfg, params, card):
    """(r) The serving benchmarks on the resident weights, through the
    in-process stand-in of the serving stack (`serve.LocalServingStack`:
    a thread a replica, each over its own PagedInferenceEngine on the one
    copy of the weights): (r-0) the prefill wave eagerly and as its graph;
    (r-1) `benchmark_serving`, every request's stream and every engine
    drained; (r-2) `run_prefix_ttft_benchmark`;
    (r-3) the KV gauge against the live engines' pools and the phase
    histogram against the recorded decode waves. -> its numbers."""
    from ray_tpu_torch._private import kv_registry
    from ray_tpu_torch._private.device_profiler import get_profiler
    from ray_tpu_torch.inference.benchmarks import benchmark_serving
    from ray_tpu_torch.serve import (LocalServingStack,
                                     run_prefix_ttft_benchmark)
    from ray_tpu_torch.util import metrics

    t0 = time.perf_counter()
    prefill_ms = prefill_graph_check(cfg, params, card)
    prof = get_profiler("decode", device=DEVICE)
    prof.reset()
    before = _phase_counts("decode")
    seq = max([e["seq"] for e in metrics.events()] or [0])
    stack = LocalServingStack()
    torch.cuda.reset_peak_memory_stats()
    res = benchmark_serving(cfg, stack=stack, device=DEVICE, params=params,
                            **SERVING_BENCH)
    peak = torch.cuda.max_memory_allocated()
    prof.report(recent=0)
    (event,) = [e for e in _new_events("perf.phase_report", seq)
                if e["data"]["profiler"] == "decode"]
    d = res["detail"]
    new = SERVING_BENCH["max_new_tokens"]
    n_req = SERVING_BENCH["n_requests"] + 2 * SERVING_BENCH["num_replicas"]
    streamed = sorted(n for r in stack.replicas for n in r.streamed)
    reps = [check_drained(r.engine, f"(r-1) replica {i}")
            for i, r in enumerate(stack.replicas)]
    log(f"[r-1] ({card}) benchmark_serving, Llama-3-8B bf16 at "
        f"{cfg.n_layers} layers, {SERVING_BENCH['num_replicas']} replicas "
        f"(engines of {reps[0]['n_blocks']} blocks of "
        f"{reps[0]['block_size']}), {SERVING_BENCH['n_requests']} requests "
        f"at {SERVING_BENCH['arrival_rate_hz']} Hz, {new} new tokens each: "
        f"TTFT p50 {res['value']} ms, p99 {d['ttft_p99_ms']} ms, "
        f"{d['tokens_per_sec']} tok/s; peak memory {peak / 2**30:.2f} GiB; "
        f"perf.phase_report of the decode waves {event['data']}")
    check(d["n_requests"] == SERVING_BENCH["n_requests"]
          and streamed == [new] * n_req,
          f"(r-1) {d['n_requests']} requests answered, streams of "
          f"{streamed} tokens, not {n_req} of {new}")

    prefix_stack = LocalServingStack()
    pre = run_prefix_ttft_benchmark(stack=prefix_stack, device=DEVICE,
                                    config=cfg, params=params,
                                    **PREFIX_BENCH)["llm_prefix_ttft"]
    check_drained(prefix_stack.replicas[0].engine, "(r-2)")
    c, n = pre["cache"], PREFIX_BENCH["n_requests"]
    log(f"[r-2] ({card}) run_prefix_ttft_benchmark, a "
        f"{PREFIX_BENCH['shared_prefix_len']}-token shared prefix and "
        f"{PREFIX_BENCH['tail_len']}-token tails, {n} rounds: cold p50 "
        f"{pre['cold_p50_ms']} ms, hit p50 {pre['hit_p50_ms']} ms, "
        f"hit_over_cold {pre['hit_over_cold']}; cache {c}")
    check(c["hit_requests"] >= n and c["miss_requests"] >= n
          and pre["hit_over_cold"] < 1,
          f"(r-2) cache {c}, hit_over_cold {pre['hit_over_cold']}")

    reports = kv_registry.report_all()
    gauge = metrics.get_metric("ray_tpu_kv_blocks")
    blocks = {dict(k)["state"]: v for k, v in gauge._values.items()}
    pools = sum(r["n_blocks"] - 1 for r in reports)
    rec = prof.report(recent=1 << 20, emit_event=False)
    waves = rec["recent_steps"]
    after = _phase_counts("decode")
    observed = sum(after.values()) - sum(before.values())
    recorded = sum(len(w["phases"]) for w in waves)
    log(f"[r-3] ({card}) ray_tpu_kv_blocks {blocks} over {len(reports)} "
        f"live engines of {pools} blocks in all (block 0 of each is "
        f"scratch); the decode histogram observed {observed} phases of "
        f"{rec['steps']} recorded waves, which hold {recorded}; "
        f"{time.perf_counter() - t0:.1f} s for (r)")
    check(len(reports) >= 3 and sum(blocks.values()) == pools
          and all(r["free_blocks"] + r["cached_blocks"] + r["active_blocks"]
                  == r["n_blocks"] - 1 for r in reports),
          f"(r-3) the KV gauge {blocks} against the pools {reports}")
    check(rec["steps"] == len(waves) and observed == recorded,
          f"(r-3) {observed} phases observed, {recorded} in "
          f"{len(waves)} of {rec['steps']} recorded waves")
    return {"prefill_ms": prefill_ms, "serving": res, "peak_memory_bytes": peak,
            "phase_report": event["data"], "prefix": pre,
            "kv_blocks": blocks, "phases_observed": observed}


def check_compile_events(card):
    """(r-3), after (h-2): the compile listener's events against its
    totals: one compile.start and one compile.end a compile, their
    durations summing to compile_stats()'s seconds. -> the totals."""
    from ray_tpu_torch._private.device_profiler import compile_stats
    from ray_tpu_torch.util import metrics

    stats = compile_stats()
    starts, ends = metrics.events("compile.start"), metrics.events(
        "compile.end")
    took = sum(e["data"]["duration_s"] for e in ends)
    ring = metrics.event_stats()
    log(f"[r-3] ({card}) compile events so far: {len(starts)} starts, "
        f"{len(ends)} ends, {took:.3f} s against compile_stats {stats}; "
        f"events {ring}")
    check(stats["compiles"] > 0 and len(starts) == len(ends)
          == stats["compiles"] and ring["evicted"] == 0
          and abs(took - stats["compile_s"]) <= 1e-9 * stats["compile_s"],
          f"(r-3) compile events ({len(starts)} / {len(ends)}, {took} s) "
          f"against compile_stats {stats}, ring {ring}")
    return stats


# (u): the port's own runtime. The actor's engine: Llama-3-8B widths cut in
# depth to RUNTIME_LAYERS (a layer is 0.218 B parameters; embedding and
# head 1.05 B), weights from RUNTIME_SEED as the driver's copy; prompts of
# RUNTIME_PROMPTS tokens, RUNTIME_NEW greedy tokens each. The tensor that
# goes to the actor and back (bf16), the best of RUNTIME_ITERS; the no-op
# round trips timed. RUNTIME_INIT: init()'s arguments (a user's: none; a
# rehearsal on the CPU fakes a card); RUNTIME_CONFIG: None for the 8B
# widths (a rehearsal gives a tiny LlamaConfig).
RUNTIME_CONFIG = None
RUNTIME_LAYERS = 4
RUNTIME_SEED = 51
RUNTIME_PROMPTS = (37, 300, 777, 1500)
RUNTIME_NEW = 16
RUNTIME_MAX_LEN = 2048
RUNTIME_TENSOR_BYTES = 64 << 20
RUNTIME_ITERS = 3
RUNTIME_CALLS = 1000
RUNTIME_INIT = {}


def runtime_config():
    """(u-2)'s engine config: Llama-3-8B widths at RUNTIME_LAYERS layers."""
    import dataclasses

    from ray_tpu_torch.models import llama

    if RUNTIME_CONFIG is not None:
        return RUNTIME_CONFIG
    return dataclasses.replace(llama.LlamaConfig.llama3_8b(),
                               n_layers=RUNTIME_LAYERS)


class RuntimeServer:
    """(u-2)'s serving path on `device`: the Llama weights from
    RUNTIME_SEED, `forward` (through the flash forward kernel, one launch a
    layer) and the dense engine over them (its cached attention is the
    plain one)."""

    def __init__(self, device):
        from ray_tpu_torch.inference import InferenceEngine
        from ray_tpu_torch.models import llama

        self.device = device
        self.cfg = runtime_config()
        self.params = llama.init(self.cfg, torch.Generator(
            device=device).manual_seed(RUNTIME_SEED), device=device)
        self.eng = InferenceEngine(self.params, self.cfg,
                                   max_batch=len(RUNTIME_PROMPTS),
                                   max_len=RUNTIME_MAX_LEN, device=device)

    def _sync(self):
        if self.device == "cuda":
            torch.cuda.synchronize()

    def score(self, prompts):
        """Each prompt's last-position logits from `forward`, on the CPU.
        -> (logits [P, vocab] fp32, seconds)."""
        from ray_tpu_torch.models import llama

        t0 = time.perf_counter()
        with torch.no_grad():
            rows = [llama.forward(self.params, torch.as_tensor(
                [p], device=self.device), self.cfg)[0, -1] for p in prompts]
        self._sync()
        dt = time.perf_counter() - t0
        return torch.stack(rows).cpu(), dt

    def generate(self, prompts, new):
        """RUNTIME_NEW greedy tokens a prompt. -> (tokens, seconds)."""
        from ray_tpu_torch.inference import GenerationConfig

        t0 = time.perf_counter()
        out = self.eng.generate(prompts,
                                GenerationConfig(max_new_tokens=new))
        self._sync()
        return out, time.perf_counter() - t0


def runtime_prompts():
    cfg = runtime_config()
    rng = np.random.default_rng(RUNTIME_SEED)
    return [rng.integers(0, cfg.vocab_size, n).tolist()
            for n in RUNTIME_PROMPTS]


def card_uuid(device) -> str:
    if torch.device(device).type != "cuda":
        return "cpu"
    return str(torch.cuda.get_device_properties(0).uuid)


class RuntimeEngineHost(RuntimeServer):
    """(u-2)'s actor: the serving path on the card its lease bound it to,
    the tensor of (u-3), and no-op calls. `settings` are the driver's
    RUNTIME_* constants, which the actor's module takes before it builds."""

    def __init__(self, settings, device):
        from ray_tpu_torch.ops import flash_attention as fa

        globals().update(settings)
        super().__init__(device)
        self.x = None
        # counted from here: the launches of its `forward` calls
        fa.flash_fwd_cuda.launches = 0

    def report(self):
        import ray_tpu_torch as rt
        from ray_tpu_torch._private import serialization as ser
        from ray_tpu_torch.ops import flash_attention as fa

        return {"visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
                "ids": rt.get_runtime_context().get_accelerator_ids(),
                "pid": os.getpid(), "ppid": os.getppid(),
                "uuid": card_uuid(self.device),
                "flash_fwd_launches": fa.flash_fwd_cuda.launches,
                "pageable_gets":
                    ser.COPY_STATS["typed_tensor_get_pageable"]}

    def take(self, refs):
        """Way 1's get: the driver's put, read from the store here."""
        import ray_tpu_torch as rt

        t0 = time.perf_counter()
        self.x = rt.get(refs[0])
        if self.device == "cuda":
            torch.cuda.synchronize()
        return time.perf_counter() - t0, str(self.x.device)

    def give(self):
        """Way 2's put: -> ([its ref], seconds, whether the store holds
        it)."""
        import ray_tpu_torch as rt
        from ray_tpu_torch._raylet import global_state

        t0 = time.perf_counter()
        ref = rt.put(self.x)
        dt = time.perf_counter() - t0
        entry = global_state.core_worker.memory_store.get_entry(
            ref.object_id())
        return [ref], dt, bool(entry is not None and entry.in_plasma)

    def noop(self):
        return None


class CardProbe:
    """(u-4): a card's UUID, as a `num_gpus=1` actor sees it."""

    def uuid(self):
        return card_uuid("cuda"), os.environ.get("CUDA_VISIBLE_DEVICES")


def runtime_noop():
    return None


def round_trip_p50_ms(call, n) -> float:
    for _ in range(20):  # warm: leases, workers, connections
        call()
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        call()
        times.append(time.perf_counter() - t0)
    return float(np.median(times) * 1e3)


def phase_runtime(card):
    """(u) the port's own runtime core on the card. -> its numbers."""
    import ray_tpu_torch as rt
    from ray_tpu_torch._private import serialization as ser
    from ray_tpu_torch._private.accelerators import nvidia
    from ray_tpu_torch._raylet import global_state

    # the workers import the package from this checkout
    here = os.path.dirname(os.path.abspath(__file__))
    os.environ["PYTHONPATH"] = os.pathsep.join(
        p for p in (here, os.environ.get("PYTHONPATH")) if p)
    t0 = time.perf_counter()
    rt.init(**RUNTIME_INIT)
    out = {}
    try:
        init_s = time.perf_counter() - t0
        # (u-1) the node
        res = rt.cluster_resources()
        (node,) = rt.nodes()
        count = torch.cuda.device_count()
        smi = nvidia.GpuInfo(1, (card.split(",")[0].strip(),), (0,))
        typed = nvidia.typed_resource(smi)
        check(res.get("GPU") == count and res.get(typed) == count
              and node["Labels"].get(nvidia.ACCELERATOR_TYPE_LABEL)
              == smi.accelerator_type,
              f"(u-1) the node advertises {res} and {node['Labels']} on "
              f"{count} card(s) named {card!r}")
        raylet = rt.api._global_node.raylet
        check(raylet._store_server is not None
              and global_state.core_worker.plasma is not None,
              "(u-1) the runtime's native shm store is not up")
        log(f"[u-1] init {init_s:.2f} s: GPU {res['GPU']:g}, {typed} "
            f"{res[typed]:g}, label {smi.accelerator_type!r}, the native "
            f"shm store at {raylet.store_socket}")

        # (u-2) the serving path in a GPU actor
        settings = {k: v for k, v in globals().items()
                    if k.startswith("RUNTIME_")}
        t0 = time.perf_counter()
        host = rt.remote(num_gpus=1)(RuntimeEngineHost).remote(settings,
                                                               DEVICE)
        prompts = runtime_prompts()
        cfg = runtime_config()
        # the driver's copy runs while the actor starts (spawn, imports,
        # weights); the actor's timed calls come after it
        copy = RuntimeServer(DEVICE)
        want_logits, driver_score_s = copy.score(prompts)
        want, driver_s = copy.generate(prompts, RUNTIME_NEW)
        del copy
        gc.collect()
        logits, score_s = rt.get(host.score.remote(prompts), timeout=600)
        tokens, gen_s = rt.get(host.generate.remote(prompts, RUNTIME_NEW),
                               timeout=600)
        actor_s = time.perf_counter() - t0
        rep = rt.get(host.report.remote(), timeout=60)
        check([len(t) for t in tokens] == [RUNTIME_NEW] * len(prompts),
              f"(u-2) token counts {[len(t) for t in tokens]}")
        check(tokens == want, "(u-2) the GPU actor's tokens differ from "
              "the driver's copy of the engine")
        check(torch.equal(logits, want_logits),
              f"(u-2) the GPU actor's forward logits differ from the "
              f"driver's copy: rel L2 {rel_l2(logits, want_logits):.3e}")
        check(rep["ppid"] == os.getpid(), "(u-2) the GPU actor is not a "
              "direct spawn of the raylet (a zygote fork?)")
        check(rep["visible"] is not None
              and rep["ids"] == {"GPU": [rep["visible"]]},
              f"(u-2) the GPU actor's binding: {rep}")
        launches = rep["flash_fwd_launches"]
        check(launches > 0, "(u-2) the GPU actor never launched flash_fwd")
        check(launches == cfg.n_layers * len(prompts),
              f"(u-2) the actor launched flash_fwd {launches} times, not "
              f"one a layer a prompt ({cfg.n_layers * len(prompts)})")
        log(f"[u-2] a num_gpus=1 actor (pid {rep['pid']}, direct spawn, "
            f"CUDA_VISIBLE_DEVICES={rep['visible']}, card {rep['uuid']}) "
            f"holds the engine at d_model {cfg.d_model}, {cfg.n_layers} "
            f"layers, {cfg.dtype}: "
            f"{len(prompts)} prompts of {list(RUNTIME_PROMPTS)} tokens: "
            f"`forward`'s last logits (flash kernel) and {RUNTIME_NEW} "
            f"greedy tokens each (the engine), both equal to the driver's "
            f"copy; its forward {score_s:.3f} s and generate {gen_s:.3f} s "
            f"(the driver's {driver_score_s:.3f} and {driver_s:.3f} s), "
            f"start to tokens {actor_s:.2f} s (the driver's copy ran in "
            f"it); flash_fwd launches in the actor since it was built, all "
            f"from its forward (generate's cached attention is plain): "
            f"{launches}")

        # (u-3) a CUDA tensor there and back through the native store
        n = RUNTIME_TENSOR_BYTES // 2
        x = torch.randn(n, generator=torch.Generator(device=DEVICE)
                        .manual_seed(RUNTIME_SEED), device=DEVICE).to(
                            torch.bfloat16)
        pageable = ser.COPY_STATS["typed_tensor_get_pageable"]
        ways = {"to_actor": [], "from_actor": []}
        for _ in range(RUNTIME_ITERS):
            t0 = time.perf_counter()
            ref = rt.put(x)
            put_s = time.perf_counter() - t0
            entry = global_state.core_worker.memory_store.get_entry(
                ref.object_id())
            check(entry is not None and entry.in_plasma,
                  "(u-3) the driver's put is not in the native store")
            get_s, where = rt.get(host.take.remote([ref]), timeout=120)
            ways["to_actor"].append(put_s + get_s)
            (back_ref,), aput_s, in_store = rt.get(host.give.remote(),
                                                   timeout=120)
            check(in_store, "(u-3) the actor's put is not in the native "
                  "store")
            t0 = time.perf_counter()
            back = rt.get(back_ref, timeout=120)
            if DEVICE == "cuda":
                torch.cuda.synchronize()
            ways["from_actor"].append(aput_s + time.perf_counter() - t0)
            check(back.device == x.device and back.dtype == x.dtype
                  and torch.equal(back, x),
                  f"(u-3) the tensor came back changed (on {back.device})")
            del ref, back_ref, back
        rep = rt.get(host.report.remote(), timeout=60)
        check(ser.COPY_STATS["typed_tensor_get_pageable"] == pageable
              and rep["pageable_gets"] == 0,
              "(u-3) a get from the store took the pageable route")
        rates = {k: RUNTIME_TENSOR_BYTES / min(v) / 1e9
                 for k, v in ways.items()}
        task = rt.remote(runtime_noop)
        task_ms = round_trip_p50_ms(lambda: rt.get(task.remote()),
                                    RUNTIME_CALLS)
        actor_ms = round_trip_p50_ms(lambda: rt.get(host.noop.remote()),
                                     RUNTIME_CALLS)
        log(f"[u-3] a {RUNTIME_TENSOR_BYTES >> 20} MiB bf16 CUDA tensor "
            f"through the native store, exact (on {where} in the actor): "
            f"driver to actor {rates['to_actor']:.2f} GB/s, actor to driver "
            f"{rates['from_actor']:.2f} GB/s (a put plus the other side's "
            f"get, the best of {RUNTIME_ITERS}); p50 of {RUNTIME_CALLS} "
            f"round trips: no-op task {task_ms:.3f} ms, actor call "
            f"{actor_ms:.3f} ms; on {card}")
        rt.kill(host)

        # (u-4) several cards
        uuids = None
        if count >= 2:
            probe = rt.remote(num_gpus=1)(CardProbe)
            probes = [probe.remote(), probe.remote()]
            uuids = rt.get([p.uuid.remote() for p in probes], timeout=300)
            check(len({u for u, _ in uuids}) == 2,
                  f"(u-4) two num_gpus=1 actors on one card: {uuids}")
            log(f"[u-4] two num_gpus=1 actors on cards {uuids}")
            for p in probes:
                rt.kill(p)
        else:
            log("[u-4] not run: a node of one card")
        out = {"init_s": init_s, "flash_fwd_launches": launches,
               "actor_forward_s": score_s, "actor_generate_s": gen_s,
               "driver_forward_s": driver_score_s,
               "driver_generate_s": driver_s,
               "to_actor_gb_s": rates["to_actor"],
               "from_actor_gb_s": rates["from_actor"],
               "task_round_trip_p50_ms": task_ms,
               "actor_call_round_trip_p50_ms": actor_ms,
               "card_uuids": uuids, "card": card}
    finally:
        rt.shutdown()
    return out


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
    parser.add_argument("--only", choices=("l", "m", "n", "o", "p", "q",
                                           "r", "s", "t", "u"),
                        default=None,
                        help="run phase (l), the SPMD path (with 4 cards its "
                        "4-card part), (m), RLlib's one-process path, (n), "
                        "the data plane, (o), Train's checkpoint and "
                        "predictors, (p), Train's gang at world 1, (q), "
                        "RLlib's remote groups, (r), the serving "
                        "benchmarks on the Llama-3-8B weights, (s), the "
                        "decoupled RL dataflow and lower_to_jit, (t), "
                        "the node's advertisement and typed tensors "
                        "through shared pages, or (u), the port's own "
                        "runtime with a GPU actor serving Llama, alone "
                        "after the kernel build")
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
    laps, t_lap = {}, [t_start]

    def lap(tag):
        """Note the seconds of the phase(s) `tag` that just ended."""
        now = time.perf_counter()
        laps[tag] = round(now - t_lap[0], 1)
        t_lap[0] = now

    def log_laps():
        log(f"[phases] seconds by phase {laps}; "
            f"{time.perf_counter() - t_start:.1f} s in all")

    phase_build()
    lap("a")
    if args.only == "l":
        spmd = (phase_spmd_part(args.part) if args.part is not None
                else phase_spmd())
        lap("l")
        log_laps()
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
        lap("m")
        log_laps()
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
        lap("o")
        log_laps()
        log(f"[o] launches on the checkpointed training path: {ckpt}; "
            f"{time.perf_counter() - t_start:.1f} s in all")
        print(card)
        print(json.dumps({"checkpoint_launches": ckpt,
                          "predictor": predict}))
        print(json.dumps({"ok": True, "device": {
            "platform": info["platform"], "kind": info["kind"],
            "count": info["count"]}}))
        return 0
    if args.only == "p":
        gang = phase_train_gang(card)
        lap("p")
        log_laps()
        print(card)
        print(json.dumps({"train_gang_launches": gang}))
        print(json.dumps({"ok": True, "device": {
            "platform": info["platform"], "kind": info["kind"],
            "count": info["count"]}}))
        return 0
    if args.only == "q":
        reset_kernel_counts()
        remote = phase_rl_remote(card)
        lap("q")
        log_laps()
        log(f"[q] launches of the flash kernels on the remote RL groups: "
            f"{kernel_counts()} (they run none)")
        print(card)
        print(json.dumps({"rl_remote": remote}))
        print(json.dumps({"ok": True, "device": {
            "platform": info["platform"], "kind": info["kind"],
            "count": info["count"]}}))
        return 0
    if args.only == "s":
        reset_kernel_counts()
        dataflow = phase_dataflow(card)
        lap("s")
        log_laps()
        log(f"[s] launches of the flash kernels on the decoupled dataflow "
            f"and lower_to_jit: {kernel_counts()} (they run none)")
        check(not any(kernel_counts().values()),
              "(s) launched a flash kernel")
        print(card)
        print(json.dumps({"dataflow": dataflow}))
        print(json.dumps({"ok": True, "device": {
            "platform": info["platform"], "kind": info["kind"],
            "count": info["count"]}}))
        return 0
    if args.only == "t":
        reset_kernel_counts()
        store = phase_store(card)
        lap("t")
        log_laps()
        check(not any(kernel_counts().values()),
              "(t) launched a flash kernel")
        print(card)
        print(json.dumps({"store": store}))
        print(json.dumps({"ok": True, "device": {
            "platform": info["platform"], "kind": info["kind"],
            "count": info["count"]}}))
        return 0
    if args.only == "u":
        runtime = phase_runtime(card)
        lap("u")
        log_laps()
        print(card)
        print(json.dumps({"runtime": runtime}))
        print(json.dumps({"ok": True, "device": {
            "platform": info["platform"], "kind": info["kind"],
            "count": info["count"]}}))
        return 0
    if args.only == "n":
        feed = phase_dataplane(card)
        lap("n")
        log_laps()
        log(f"[n] launches on the fed training path: {feed}; "
            f"{time.perf_counter() - t_start:.1f} s in all")
        print(card)
        print(json.dumps({"feed_launches": feed}))
        print(json.dumps({"ok": True, "device": {
            "platform": info["platform"], "kind": info["kind"],
            "count": info["count"]}}))
        return 0
    if args.only == "r":
        cfg = llama.LlamaConfig.llama3_8b()
        params = llama.init(cfg, torch.Generator(device=DEVICE).manual_seed(0),
                            device=DEVICE)
        reset_kernel_counts()
        bench = phase_serving_bench(cfg, params, card)
        lap("r")
        log_laps()
        log(f"[r] launches of the flash kernels on the serving benchmarks: "
            f"{kernel_counts()} (the paged engine attends through the cache "
            f"attention)")
        print(card)
        print(json.dumps({"serving_bench": bench}))
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
    lap("b+c+f+g")
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
    lap("d+e")
    log(f"[d+e] launches on the serving path: {serve}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
        f"{time.perf_counter() - t_start:.1f} s so far")

    reset_kernel_counts()
    phase_paged_forward(cfg, params, seed=6)
    phase_paged_serve(cfg, params, seed=8)
    phase_paged_tiny()
    lap("i")
    log(f"[i] launches on the paged serving path: {kernel_counts()} (it "
        f"attends through the cache attention, not the flash kernel); "
        f"{time.perf_counter() - t_start:.1f} s so far")
    reset_kernel_counts()
    phase_serving_bench(cfg, params, card)
    lap("r")
    log(f"[r] launches on the serving benchmarks: {kernel_counts()} (the "
        f"paged engine runs none); {time.perf_counter() - t_start:.1f} s so "
        "far")
    del params
    gc.collect()
    torch.cuda.empty_cache()

    cfg = bench_config()
    train, eager = phase_train(cfg, batch=TRAIN_ATTN[0], seq=TRAIN_ATTN[1],
                               steps=10, seed=3)
    lap("h")
    log(f"[h] launches on the training path: {train}; "
        f"{time.perf_counter() - t_start:.1f} s so far")
    gc.collect()
    torch.cuda.empty_cache()
    reset_kernel_counts()
    compiled = phase_train_compiled(cfg, batch=TRAIN_ATTN[0],
                                    seq=TRAIN_ATTN[1], steps=10, seed=3,
                                    eager=eager)
    lap("h-2")
    log(f"[h-2] launches on the compiled training path: {compiled}; "
        f"{time.perf_counter() - t_start:.1f} s so far")
    check_compile_events(card)
    phase_train_tiny()
    phase_bench()
    phase_entry()
    lap("h-2 tiny+bench+j")
    log(f"[bench+j] {time.perf_counter() - t_start:.1f} s so far")
    gc.collect()
    torch.cuda.empty_cache()
    zoo = phase_zoo(t_start)
    lap("k")
    log(f"[k] {time.perf_counter() - t_start:.1f} s so far")
    gc.collect()
    torch.cuda.empty_cache()
    spmd = phase_spmd(eager["first"])
    lap("l")
    log(f"[l] {time.perf_counter() - t_start:.1f} s so far")
    gc.collect()
    torch.cuda.empty_cache()
    reset_kernel_counts()
    phase_rl(card)
    lap("m")
    log(f"[m] launches of the flash kernels on the RL path: "
        f"{kernel_counts()} (it runs none); "
        f"{time.perf_counter() - t_start:.1f} s so far")
    gc.collect()
    torch.cuda.empty_cache()
    feed = phase_dataplane(card)
    lap("n")
    log(f"[n] launches on the fed training path: {feed}; "
        f"{time.perf_counter() - t_start:.1f} s so far")
    gc.collect()
    torch.cuda.empty_cache()
    ckpt, _ = phase_train_io(card)
    lap("o")
    log(f"[o] launches on the checkpointed training path: {ckpt}; "
        f"{time.perf_counter() - t_start:.1f} s so far")
    gc.collect()
    torch.cuda.empty_cache()
    gang = phase_train_gang(card)
    lap("p")
    log(f"[p] launches on the gang's training path: {gang}; "
        f"{time.perf_counter() - t_start:.1f} s so far")
    gc.collect()
    torch.cuda.empty_cache()
    reset_kernel_counts()
    phase_rl_remote(card)
    lap("q")
    log(f"[q] launches of the flash kernels on the remote RL groups: "
        f"{kernel_counts()} (they run none); "
        f"{time.perf_counter() - t_start:.1f} s so far")
    gc.collect()
    torch.cuda.empty_cache()
    reset_kernel_counts()
    phase_dataflow(card)
    lap("s")
    log(f"[s] launches of the flash kernels on the decoupled dataflow and "
        f"lower_to_jit: {kernel_counts()} (they run none); "
        f"{time.perf_counter() - t_start:.1f} s so far")
    gc.collect()
    torch.cuda.empty_cache()
    reset_kernel_counts()
    phase_store(card)
    lap("t")
    check(not any(kernel_counts().values()), "(t) launched a flash kernel")
    log(f"[t] launches of the flash kernels on the advertisement and the "
        f"arena: {kernel_counts()} (they run none); "
        f"{time.perf_counter() - t_start:.1f} s so far")
    gc.collect()
    torch.cuda.empty_cache()
    runtime = phase_runtime(card)
    lap("u")
    log(f"[u] the port's own runtime: flash_fwd launches in its GPU actor "
        f"{runtime['flash_fwd_launches']}; "
        f"{time.perf_counter() - t_start:.1f} s in all")
    log_laps()

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
                   "checkpoint": ckpt[name], "train_gang": gang[name]}
        check(all(v > 0 for path, v in by_path.items() if path != "serve"),
              f"a training path never launched {name}: {by_path}")
        if name == "flash_fwd":  # `forward` in the runtime's GPU actor
            by_path["runtime_actor_forward"] = runtime["flash_fwd_launches"]
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
