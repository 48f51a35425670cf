"""PagedInferenceEngine: continuous batching over a block-pool KV cache.

Counterpart of `ray_tpu/inference/paged_engine.py`, its host bookkeeping
kept line for line so that the same script gives the same block tables,
prefix statistics and preemptions. The dense engine (engine.py) reserves
[max_batch, max_len] KV rows; this one implements the PagedAttention
scheme:

  * KV lives in a BLOCK POOL ([L, n_blocks, block, kv, d], llama.py
    init_paged_kv_cache) on the device; a host-side allocator hands blocks
    to slots. Block 0 is scratch.
  * Memory is budgeted by tokens IN FLIGHT (pool size), not
    batch x max_len: ragged/long sequences share the same pool.
  * Admission control: a request admits only when the pool can hold its
    prompt plus one decode block.
  * Preemption by recomputation: if the pool runs dry mid-decode, the
    youngest request releases its blocks and is re-prefilled (prompt +
    already-emitted tokens) once space frees — emitted tokens stay
    emitted; generation resumes exactly where it stopped (vLLM's
    RECOMPUTE preemption mode).
  * PREFIX CACHING: blocks are content-addressed by a chain hash over
    their token prefix. A released request's full blocks stay in the pool
    as a ref-counted cache (LRU-evicted at refcount zero); a new request
    whose prompt shares a cached prefix attaches the matched blocks
    read-only and prefills ONLY the tail. The one block a matched request
    must write into (the sampling position when the whole prompt matched)
    is copied on write, never mutated in place.

The host's numpy block table is the source of truth; it goes to the
device once per prefill wave and once per decode wave. The pool is
updated in place where the JAX package donates it. A decode wave is the
shared `FusedDecode` loop (one CUDA graph per step on the card) with one
device-to-host copy of its token block and executed-step count. On the
card a prefill wave is also a CUDA graph, one per (rows, bucket,
sampling configuration), captured on first use where the JAX package
compiles a program per shape: the eager prefill of Llama-3-8B launches
about 3000 kernels, and on an H100 their launch takes longer than their
work (`chip_smoke.py` (r-0) times a wave both ways).
"""

from __future__ import annotations

import hashlib
import time
from collections import OrderedDict
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ray_tpu_torch._private import kv_registry
from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch._private.device_profiler import get_profiler
from ray_tpu_torch.inference.engine import (FusedDecode, GenerationConfig,
                                            InferenceEngine, _default_buckets,
                                            _tensors)
from ray_tpu_torch.inference.sampling import sample_token


class PagedInferenceEngine:
    def __init__(
        self,
        params: Any,
        config: Any,
        *,
        max_batch: int = 8,
        max_len: int = 1024,
        block_size: int = 64,
        n_blocks: Optional[int] = None,
        prefill_buckets: Optional[Tuple[int, ...]] = None,
        decode_chunk: int = 16,
        forward_with_paged_cache: Optional[Callable] = None,
        init_paged_kv_cache: Optional[Callable] = None,
        enable_prefix_cache: bool = True,
        device=None,
        mesh: Any = None,
    ):
        """`params` must already be on `device` (cuda unless "cpu").

        With `mesh`, decode runs tensor-parallel over its tp dim: `params`
        are DTensors in their tp layout (`shard_params_for_inference`),
        every rank of the gang runs the same engine on the same requests,
        each on its block of the weights (heads and MLP hidden units) and
        of the block pool (`pool_placements`: the KV-head dim over tp),
        and the row-parallel products end in a sum over tp. The host
        bookkeeping is the same on every rank. The decode loop runs
        eagerly (no CUDA graph around a collective)."""
        from ray_tpu_torch.models import llama

        fwd = forward_with_paged_cache or llama.forward_with_paged_cache
        init_pool = init_paged_kv_cache or llama.init_paged_kv_cache
        self.device = resolve_device(device)
        self.mesh = mesh
        self.pool_placements = None
        model_config = config
        if mesh is not None:
            import dataclasses
            import functools

            from ray_tpu_torch.parallel.sharding import ShardingContext
            from ray_tpu_torch.train.optim import tree_map

            ctx = ShardingContext(mesh)
            model_config = dataclasses.replace(
                config, n_heads=config.n_heads // ctx.tp,
                n_kv_heads=config.n_kv_heads // ctx.tp)
            with torch.no_grad():
                params = tree_map(ctx.local, params)
            # fp32 partial products, summed and rounded once (the prefill
            # and decode are latency-bound: the doubled bytes cost little).
            fwd = functools.partial(fwd, tp_sum=ctx.tp_sum_f32)
            self.pool_placements = ctx.placements(
                (None, None, None, "act_heads", None))
        for w in _tensors(params):
            if w.device.type != self.device.type:
                raise ValueError(f"a parameter is on {w.device}; the engine "
                                 f"runs on {self.device}")
        self.params = params
        self.config = config
        # What the model computes on this rank: its tp block's head counts.
        self._model_config = model_config
        self.max_batch = max_batch
        self.max_len = max_len
        self.block_size = block_size
        self.max_blocks_per_seq = -(-max_len // block_size)
        if n_blocks is None:
            # default: half the dense reservation, +1 for the scratch block
            n_blocks = 1 + max(
                self.max_blocks_per_seq,
                max_batch * self.max_blocks_per_seq // 2)
        self.n_blocks = n_blocks
        self.buckets = prefill_buckets or _default_buckets(max_len)
        self._fwd = fwd
        self.pool = init_pool(model_config, n_blocks, block_size,
                              device=self.device)
        # host state
        self.block_table = np.zeros(
            (max_batch, self.max_blocks_per_seq), np.int64)
        self.lengths = np.zeros(max_batch, np.int64)
        self.free_slots = list(range(max_batch))
        self.free_blocks = list(range(1, n_blocks))  # 0 = scratch
        self.slot_blocks: Dict[int, List[int]] = {}
        # -- prefix cache (content-addressed, ref-counted) -------------------
        self.enable_prefix_cache = enable_prefix_cache
        # tokens whose KV the pool holds per slot (== lengths[slot]); the
        # source of truth for promoting a released slot's blocks into the
        # content index
        self.slot_tokens: Dict[int, List[int]] = {}
        self.block_ref: Dict[int, int] = {}      # block -> attached slots
        self.block_hash: Dict[int, bytes] = {}   # block -> chain hash
        self.hash_index: Dict[bytes, int] = {}   # chain hash -> block
        # refcount-zero blocks still serving the index, oldest-released
        # first (eviction order); every non-scratch block is in exactly
        # one of free_blocks / cached_lru / block_ref(>0)
        self.cached_lru: "OrderedDict[int, None]" = OrderedDict()
        kv_bytes = sum(x.numel() * x.element_size()
                       for x in self.pool.values())
        self._bytes_per_token = kv_bytes // (n_blocks * block_size)
        self.prefix_stats = {
            "hit_requests": 0, "miss_requests": 0, "hit_tokens": 0,
            "evictions": 0, "bytes_saved": 0, "cow_copies": 0,
        }
        self._gen = torch.Generator(device=self.device).manual_seed(0)
        self.decode_chunk = max(1, decode_chunk)
        # Phase attribution: every decode wave records input_wait /
        # prefill / device_execute / reply into the shared "decode"
        # profiler, whose aggregate engine.stats() carries.
        self.profiler = get_profiler("decode", device=self.device,
                                     hbm_every=8)
        self.preemptions = 0  # observability: recompute-preemption count
        self.peak_active = 0  # high-water mark of concurrently-decoding
        # requests — the ground-truth continuous-batching signal
        # serve_stream: req_id -> reason for requests the loop aborted
        # (pool too small, prompt too long); read by the serving layer
        self.abort_reasons: Dict[Any, str] = {}
        # The block pool is a ref-counted memory plane: published through
        # the process's registry (weakly; a dropped engine vanishes).
        kv_registry.register(self)
        # A decode wave runs at most the next power of two >= max_len steps.
        max_steps = 1 << max(0, max_len - 1).bit_length()
        self._decoder = FusedDecode(
            lambda tok, lens, table: self._fwd(
                self.params, tok, self.pool, table, lens,
                self._model_config)[0],
            max_batch, max_steps, self._gen,
            table_shape=self.block_table.shape)
        if mesh is not None:
            self._decoder.use_graph = False
        # prefill graphs (`_prefill`) by (rows, bucket, sampling
        # configuration), in one memory pool: waves run one at a time and
        # each output is read before the next replay
        self._prefill_programs: Dict[Tuple, Any] = {}
        self._prefill_pool = None

    # -- device side -----------------------------------------------------------

    _tensor = InferenceEngine._tensor

    @torch.no_grad()
    def _prefill_batch(self, tokens, block_rows, true_lens, offsets, gen):
        """Batched admission wave: tokens [N, bucket], block_rows
        [N, max_blocks], true_lens [N], offsets [N]. Prefills every row's
        TAIL (tokens at positions offsets..offsets+true_lens) into its
        reserved blocks and samples each first token on the device.
        offsets are the prefix-cache hit lengths (0 for cold rows): matched
        positions already hold their KV, only the tail runs the model."""
        n, s = tokens.shape
        valid = (torch.arange(s, device=self.device)[None, :]
                 < true_lens[:, None])
        logits, _ = self._fwd(self.params, tokens, self.pool, block_rows,
                              offsets, self._model_config, valid=valid)
        last = logits[torch.arange(n, device=self.device), true_lens - 1]
        return sample_token(last, self._gen, temperature=gen.temperature,
                            top_k=gen.top_k, top_p=gen.top_p)

    def _prefill(self, toks, rows, true_lens, offsets, gen) -> np.ndarray:
        """`_prefill_batch` on host arrays -> the first tokens (numpy).
        Where the decode step runs as a CUDA graph, so does this: the
        replay of this shape's graph, captured on first use after a
        warm-up call on the real inputs (which writes the K/V the replay
        writes again); elsewhere, eagerly."""
        host = (toks, rows, true_lens, offsets)
        if not self._decoder.use_graph:
            return self._prefill_batch(*map(self._tensor, host),
                                       gen).cpu().numpy()
        key = (toks.shape, gen.temperature, gen.top_k, gen.top_p)
        program = self._prefill_programs.get(key)
        if program is None:
            statics = [self._tensor(x) for x in host]
            current = torch.cuda.current_stream(self.device)
            side = torch.cuda.Stream(self.device)
            side.wait_stream(current)
            with torch.cuda.stream(side):
                self._prefill_batch(*statics, gen)
            current.wait_stream(side)
            if self._prefill_pool is None:
                self._prefill_pool = torch.cuda.graph_pool_handle()
            graph = torch.cuda.CUDAGraph()
            if gen.temperature > 0:
                graph.register_generator_state(self._gen)
            with torch.cuda.graph(graph, pool=self._prefill_pool):
                out = self._prefill_batch(*statics, gen)
            program = self._prefill_programs[key] = (graph, statics, out)
        graph, statics, out = program
        for dst, src in zip(statics, host):
            dst.copy_(torch.from_numpy(np.ascontiguousarray(src)))
        graph.replay()
        return out.cpu().numpy()

    @torch.no_grad()
    def _copy_blocks(self, src, dst) -> None:
        """Copy-on-write: pool blocks src[i] -> dst[i] in every layer, one
        gather and one scatter over the block axis per wave. The gather
        reads all of src before any dst is written."""
        src, dst = self._tensor(src), self._tensor(dst)
        for x in self.pool.values():
            x[:, dst] = x[:, src]

    # -- block allocator -----------------------------------------------------

    def _blocks_for(self, n_tokens: int) -> int:
        return -(-n_tokens // self.block_size)

    def available_blocks(self) -> int:
        """Blocks allocatable right now: truly free + cached-evictable."""
        return len(self.free_blocks) + len(self.cached_lru)

    def _alloc_block(self) -> Optional[int]:
        """Claim a writable block: free list first, then evict the
        least-recently-released cached block from the content index."""
        if self.free_blocks:
            return self.free_blocks.pop()
        if self.cached_lru:
            b, _ = self.cached_lru.popitem(last=False)
            h = self.block_hash.pop(b, None)
            if h is not None and self.hash_index.get(h) == b:
                del self.hash_index[h]
            self.prefix_stats["evictions"] += 1
            return b
        return None

    def _unref_block(self, b: int) -> None:
        """Drop one slot's reference; at zero the block either stays
        cached (content-indexed -> LRU) or returns to the free list."""
        n = self.block_ref.get(b, 0) - 1
        if n > 0:
            self.block_ref[b] = n
            return
        self.block_ref.pop(b, None)
        h = self.block_hash.get(b)
        if h is not None and self.hash_index.get(h) == b:
            self.cached_lru[b] = None
        else:
            self.block_hash.pop(b, None)
            self.free_blocks.append(b)

    def _attach_block(self, b: int) -> None:
        """Add one slot's reference to a cached/shared block."""
        n = self.block_ref.get(b, 0)
        if n == 0:
            self.cached_lru.pop(b, None)
        self.block_ref[b] = n + 1

    def _chain_hashes(self, tokens: List[int]) -> List[bytes]:
        """Content identity per FULL block: hash k covers tokens
        [0, (k+1)*block_size) — position-dependent by construction, so
        equal hashes mean equal KV contents for the whole prefix."""
        bs = self.block_size
        out = []
        h = b""
        for k in range(len(tokens) // bs):
            m = hashlib.blake2b(h, digest_size=16)
            m.update(np.asarray(tokens[k * bs:(k + 1) * bs],
                                np.int32).tobytes())
            h = m.digest()
            out.append(h)
        return out

    def _promote(self, blocks: List[int], tokens: List[int]) -> None:
        """Index a released slot's full blocks by content so future
        prompts sharing the prefix can reuse their KV. Partial tail
        blocks are never indexed (their content is not a full block)."""
        if not self.enable_prefix_cache:
            return
        for k, h in enumerate(self._chain_hashes(tokens)):
            b = blocks[k]
            if b in self.block_hash:
                continue  # already indexed (attached from the cache)
            if h in self.hash_index:
                continue  # duplicate content: one copy serves the index
            self.hash_index[h] = b
            self.block_hash[b] = h

    def _match_prefix(self, prefix: List[int]) -> Tuple[List[int], int]:
        """Longest cached block run covering `prefix` -> (blocks,
        n_matched_tokens). Matched tokens are capped at len(prefix)-1:
        the last prompt position must be re-computed to produce the
        first sampling logits, and when that position falls inside the
        final matched block the admission path copies it on write."""
        if not self.enable_prefix_cache:
            return [], 0
        blocks = []
        for h in self._chain_hashes(prefix):
            b = self.hash_index.get(h)
            if b is None:
                break
            blocks.append(b)
        # cap: matched blocks never exceed len(prefix)//block_size, so the
        # cap only bites when the WHOLE prompt matched (len a multiple of
        # block_size) — then m = len(prefix)-1 lands inside the final
        # matched block and the caller copies it on write
        m = min(len(blocks) * self.block_size, len(prefix) - 1)
        if m <= 0:
            return [], 0
        return blocks, m

    def _ensure_capacity(self, slot: int, upto: int) -> bool:
        """Grow the slot's block list to cover `upto` tokens."""
        want = self._blocks_for(upto)
        blocks = self.slot_blocks.setdefault(slot, [])
        while len(blocks) < want:
            b = self._alloc_block()
            if b is None:
                return False
            self.block_ref[b] = 1
            self.block_table[slot, len(blocks)] = b
            blocks.append(b)
        return True

    def _release(self, slot: int) -> None:
        blocks = self.slot_blocks.pop(slot, [])
        tokens = self.slot_tokens.pop(slot, None)
        if tokens is not None and blocks:
            # promote BEFORE unref so a full block landing at refcount
            # zero parks in the cache LRU instead of the free list
            self._promote(blocks, tokens)
        for b in blocks:
            self._unref_block(b)
        self.block_table[slot, :] = 0
        self.lengths[slot] = 0
        self.free_slots.append(slot)

    def _shrink_capacity(self, slot: int, upto: int) -> None:
        """Return blocks beyond what `upto` tokens need to the free pool
        (undoes speculative growth when a decode chunk shrinks)."""
        want = max(self._blocks_for(upto), 1)
        blocks = self.slot_blocks.get(slot, [])
        while len(blocks) > want:
            b = blocks.pop()
            self.block_table[slot, len(blocks)] = 0
            self._unref_block(b)

    def _bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        raise ValueError(
            f"prompt of {n} tokens exceeds max_len={self.max_len}")

    # -- admission -----------------------------------------------------------

    def _reserve(self, prefix: List[int], match=None
                 ) -> Optional[Tuple[int, int, Optional[Tuple[int, int]]]]:
        """Claim a slot + blocks covering `prefix` plus one decode token,
        reusing cached blocks for any content-matched prefix. ->
        (slot, n_matched_tokens, cow_pair | None) or None (no capacity).
        cow_pair = (src, dst): the final matched block must be duplicated
        before the tail prefill writes into it (copy-on-write — the
        cached original may back other slots and stays immutable)."""
        if not self.free_slots:
            return None
        matched, m = match if match is not None else \
            self._match_prefix(prefix)
        # does the tail's first write land inside the matched region?
        cow = bool(matched) and m < len(matched) * self.block_size
        n_new = (self._blocks_for(len(prefix) + 1) - len(matched)
                 + (1 if cow else 0))
        # matched blocks at refcount zero sit in the LRU: attaching them
        # removes them from the evictable pool, so they must not count
        # toward the capacity that will serve the n_new fresh allocations
        lru_matched = sum(1 for b in matched if b in self.cached_lru)
        if self.available_blocks() - lru_matched < n_new:
            return None
        slot = self.free_slots.pop()
        cow_pair = None
        blocks = self.slot_blocks.setdefault(slot, [])
        for i, b in enumerate(matched):
            if cow and i == len(matched) - 1:
                dst = self._alloc_block()
                if dst is None:  # raced empty despite the pre-check
                    self._release(slot)
                    return None
                self.block_ref[dst] = 1
                cow_pair = (b, dst)
                b = dst
                self.prefix_stats["cow_copies"] += 1
            else:
                self._attach_block(b)
            self.block_table[slot, len(blocks)] = b
            blocks.append(b)
        if not self._ensure_capacity(slot, len(prefix) + 1):
            # raced out of blocks despite the pre-check above; _release
            # returns both the slot AND any blocks the partial allocation
            # already consumed
            self._release(slot)
            return None
        if m > 0:
            self.prefix_stats["hit_requests"] += 1
            self.prefix_stats["hit_tokens"] += m
            self.prefix_stats["bytes_saved"] += m * self._bytes_per_token
        else:
            self.prefix_stats["miss_requests"] += 1
        return slot, m, cow_pair

    # -- generation ----------------------------------------------------------

    def kv_block_report(self) -> Dict[str, Any]:
        """Block-pool occupancy + prefix stats for the memory_report RPC
        (kv_registry.report_all). Every non-scratch block is in exactly
        one of free / cached(LRU, refcount 0, still indexed) / active
        (attached to a decoding slot), so the three counts sum to
        n_blocks - 1 and a drift there is itself a leak signal."""
        active = sum(1 for n in self.block_ref.values() if n > 0)
        return {
            "n_blocks": self.n_blocks,
            "block_size": self.block_size,
            "free_blocks": len(self.free_blocks),
            "cached_blocks": len(self.cached_lru),
            "active_blocks": active,
            "bytes_per_token": self._bytes_per_token,
            "block_bytes": self._bytes_per_token * self.block_size,
            "active_slots": self.max_batch - len(self.free_slots),
            "max_batch": self.max_batch,
            "preemptions": self.preemptions,
            "peak_active": self.peak_active,
            "prefix_stats": dict(self.prefix_stats),
        }

    def stats(self) -> Dict[str, Any]:
        """Host-side engine occupancy snapshot (serving observability)."""
        return {
            "max_batch": self.max_batch,
            "active_slots": self.max_batch - len(self.free_slots),
            "free_blocks": len(self.free_blocks),
            "available_blocks": self.available_blocks(),
            "n_blocks": self.n_blocks,
            "preemptions": self.preemptions,
            "peak_active": self.peak_active,
            "prefix_cache": {
                **self.prefix_stats,
                "enabled": self.enable_prefix_cache,
                "cached_blocks": len(self.cached_lru),
                "indexed_blocks": len(self.hash_index),
            },
            # decode-wave phase attribution: is the engine input-starved
            # or device-bound?
            "device_phases": {
                k: v for k, v in self.profiler.report(
                    recent=0, include_hbm=False).items()
                if k not in ("recent_steps", "hbm")
            },
        }

    def serve_stream(
        self,
        feed: Callable[[bool], Tuple[list, list, bool]],
        gen: Optional[GenerationConfig] = None,
    ) -> Iterator[Tuple[Any, Optional[int], bool]]:
        """Continuous-batching SERVICE loop: requests arrive over time
        instead of as one fixed batch — the composition a serving replica
        needs (admission between decode chunks, not between generations).

        `feed(block)` is polled between device dispatches and returns
        `(new, cancelled, stop)`:

          * new: list of (req_id, prompt_tokens, max_new_tokens|None) —
            max_new defaults to gen.max_new_tokens. Admission order is
            FIFO (preempted requests re-admit ahead of new arrivals).
          * cancelled: req_ids to abort (consumer went away): their slots
            and blocks free immediately, nothing further is yielded.
          * stop: no more requests will ever arrive; the loop drains and
            returns.
          * block: hint that the engine is idle — feed may wait for work.

        Yields (req_id, token_id, done). A request the loop must reject
        (prompt longer than max_len, pool too small to ever hold it)
        yields (req_id, None, True) with the reason in
        `self.abort_reasons[req_id]` — one bad request never kills the
        service loop for its batch-mates.

        Sampling params (temperature/top_k/top_p/eos) come from `gen` and
        are shared by every request in the loop: each configuration is a
        captured decode graph of its own (serve one config per replica)."""
        gen = gen or GenerationConfig()
        active: Dict[int, dict] = {}
        try:
            yield from self._serve_stream_impl(feed, gen, active)
        finally:
            # The loop is dead (dispatch error, consumer closed the
            # generator, shutdown): release every slot still held so the
            # NEXT service loop starts with the full pool — without this
            # a single transient dispatch failure would permanently leak
            # the active requests' slots and KV blocks.
            for slot in list(active):
                del active[slot]
                self._release(slot)

    def _serve_stream_impl(self, feed, gen: GenerationConfig,
                           active: Dict[int, dict]
                           ) -> Iterator[Tuple[Any, Optional[int], bool]]:
        # pending: (req_id, prompt, emitted, max_new) — a preempted request
        # carries its already-emitted tokens so recompute RESUMES, never
        # re-emits
        pending: List[Tuple[Any, List[int], List[int], int]] = []
        failed: List[Any] = []  # rejected at admission; yielded as aborts
        stopped = False

        def poll(block: bool) -> None:
            nonlocal stopped
            if stopped:
                return
            new, cancelled, stop = feed(block)
            stopped = bool(stop)
            for item in new or ():
                req_id, prompt, max_new = item
                max_new = gen.max_new_tokens if max_new is None else max_new
                prompt = list(prompt)
                if not prompt:
                    self.abort_reasons[req_id] = "empty prompt"
                    failed.append(req_id)
                    continue
                if len(prompt) >= self.max_len:
                    self.abort_reasons[req_id] = (
                        f"prompt of {len(prompt)} tokens exceeds "
                        f"max_len={self.max_len}")
                    failed.append(req_id)
                    continue
                # FIFO: pending is a stack popped from the end
                pending.insert(0, (req_id, prompt, [], max_new))
            for req_id in cancelled or ():
                for i, item in enumerate(pending):
                    if item[0] == req_id:
                        del pending[i]
                        break
                for slot, st in list(active.items()):
                    if st["req"] == req_id:
                        del active[slot]
                        self._release(slot)

        def admit_all():
            """Admit pending requests in tail-bucket-grouped waves:
            match each prompt against the prefix cache, reserve
            slot+blocks host-side for as many as fit, run the batched
            COW block copies (one dispatch), then ONE batched prefill
            over the UNMATCHED tails samples every first token
            on-device. A full-prefix hit prefills one token."""
            while pending and self.free_slots:
                # wave rows: (req_id, prompt, emitted, max_new, slot,
                #             prefix, n_matched)
                wave = []
                cow_pairs = []
                bucket = None
                while pending:
                    req_id, prompt, emitted, max_new = pending[-1]
                    # cache must hold prompt + all emitted tokens EXCEPT
                    # the last (which is the next decode input)
                    prefix = prompt + emitted[:-1] if emitted else prompt
                    match = self._match_prefix(prefix)
                    b = self._bucket_for(len(prefix) - match[1])
                    if bucket is None:
                        bucket = b
                    elif b != bucket:
                        break
                    res = self._reserve(prefix, match=match)
                    if res is None:
                        break  # pool full: wait for frees/preemption
                    slot, n_matched, cow = res
                    if cow is not None:
                        cow_pairs.append(cow)
                    pending.pop()
                    wave.append((req_id, prompt, emitted, max_new, slot,
                                 prefix, n_matched))
                if not wave:
                    return
                n = len(wave)
                toks = np.zeros((n, bucket), np.int64)
                true_lens = np.zeros((n,), np.int64)
                offsets = np.zeros((n,), np.int64)
                rows = np.zeros((n, self.max_blocks_per_seq), np.int64)
                for i, (_, _, _, _, slot, prefix, m) in enumerate(wave):
                    tail = prefix[m:]
                    toks[i, :len(tail)] = tail
                    true_lens[i] = len(tail)
                    offsets[i] = m
                    rows[i] = self.block_table[slot]
                try:
                    if cow_pairs:
                        self._copy_blocks([s for s, _ in cow_pairs],
                                          [d for _, d in cow_pairs])
                    firsts = self._prefill(toks, rows, true_lens, offsets,
                                           gen)
                except Exception:
                    for _, _, _, _, slot, _, _ in wave:
                        self._release(slot)
                    raise
                # Bookkeep the WHOLE wave (register/release every slot)
                # before yielding anything: a consumer closing the
                # generator at a yield must find each reserved slot
                # either released or in `active` (which the outer
                # finally releases) — yielding mid-bookkeeping would
                # leak the not-yet-registered slots forever.
                first_tokens = []
                for (req_id, prompt, emitted, max_new, slot,
                     prefix, _m), first in zip(wave, firsts):
                    self.lengths[slot] = len(prefix)
                    self.slot_tokens[slot] = list(prefix)
                    tok = int(first)
                    fresh = not emitted
                    if fresh:
                        emitted = [tok]
                    else:
                        # recompute path: discard the re-sampled token;
                        # the request continues from its original last
                        # emission
                        tok = emitted[-1]
                    done = ((gen.eos_token_id is not None
                             and tok == gen.eos_token_id)
                            or len(emitted) >= max_new
                            or self.lengths[slot] + 1 >= self.max_len)
                    if fresh:
                        first_tokens.append((req_id, tok, done))
                    if done:
                        self._release(slot)
                        continue
                    active[slot] = {"req": req_id, "prompt": prompt,
                                    "emitted": emitted, "current": tok,
                                    "max_new": max_new}
                yield from first_tokens

        # per-wave phase accounting: input_wait = blocked on
        # feed, prefill = admission waves (batched prefill + first-token
        # handoff), device_execute = the fenced decode dispatch, reply =
        # token fan-out to the consumer. Accumulates across the host-side
        # bookkeeping of one wave, records one profiler step per dispatch.
        phase_acc = {"input_wait": 0.0, "prefill": 0.0}

        _t = time.perf_counter()
        poll(block=True)
        phase_acc["input_wait"] += time.perf_counter() - _t
        while True:
            while failed:
                yield failed.pop(), None, True
            _t = time.perf_counter()
            yield from admit_all()
            phase_acc["prefill"] += time.perf_counter() - _t
            self.peak_active = max(self.peak_active, len(active))
            if not active:
                if pending:
                    # admission made no progress with EVERY slot free: the
                    # head request alone exceeds the pool. Reject it
                    # instead of deadlocking the whole service loop.
                    req_id, prompt, emitted, _ = pending.pop()
                    self.abort_reasons[req_id] = (
                        f"paged pool too small for a {len(prompt)}-token "
                        f"prompt (n_blocks={self.n_blocks}); increase "
                        "n_blocks")
                    yield req_id, None, True
                    continue
                if stopped:
                    return
                _t = time.perf_counter()
                poll(block=True)
                phase_acc["input_wait"] += time.perf_counter() - _t
                continue
            # grow every active slot to cover the next chunk; preempt the
            # youngest request (fewest emitted tokens) until it fits.
            # The chunk covers each slot's full remaining budget when the
            # pool allows (one dispatch for the whole generation); the
            # pool-capacity loop below shrinks it if blocks run short.
            need = max(
                min(active[s]["max_new"] - len(active[s]["emitted"]),
                    self.max_len - 1 - int(self.lengths[s]))
                for s in active)
            # slots can free mid-chunk (EOS, budget variance): cap the
            # chunk whenever requests are waiting — or could still arrive
            # (live feed) — so admission stays responsive
            if pending or not stopped:
                need = min(need, self.decode_chunk)
            steps = 1
            while steps < max(1, need):
                steps *= 2
            while True:
                short_slot = None
                for slot in sorted(active):
                    if not self._ensure_capacity(
                            slot, int(self.lengths[slot]) + steps + 1):
                        short_slot = slot
                        break
                if short_slot is None:
                    break
                if steps > 1:
                    # shrink the chunk before resorting to preemption —
                    # smaller chunks cost extra dispatches, preemption
                    # costs a full re-prefill. Blocks grown for the
                    # larger probe go back to the pool.
                    steps //= 2
                    for slot in active:
                        self._shrink_capacity(
                            slot, int(self.lengths[slot]) + steps + 1)
                    continue
                if len(active) == 1:
                    # the lone request outgrew the whole pool mid-decode:
                    # abort it (a serving replica must survive this)
                    (slot, st), = active.items()
                    del active[slot]
                    self._release(slot)
                    self.abort_reasons[st["req"]] = (
                        "paged pool exhausted by a single request; "
                        "increase n_blocks or lower max_new_tokens")
                    yield st["req"], None, True
                    break
                victim = min(active, key=lambda s: len(active[s]["emitted"]))
                st = active.pop(victim)
                self.preemptions += 1
                pending.append((st["req"], st["prompt"], st["emitted"],
                                st["max_new"]))
                self._release(victim)
            if not active:
                continue
            tokens = np.zeros((self.max_batch, 1), np.int64)
            budget = np.zeros(self.max_batch, np.int64)
            act = np.zeros(self.max_batch, bool)
            for slot, st in active.items():
                tokens[slot, 0] = st["current"]
                budget[slot] = min(
                    st["max_new"] - len(st["emitted"]),
                    self.max_len - 1 - int(self.lengths[slot]))
                act[slot] = budget[slot] > 0
            eos = (gen.eos_token_id
                   if gen.eos_token_id is not None else -1)
            # n_steps is capped by the block capacity the host actually
            # reserved (`steps`), not just the remaining budget; the one
            # device-to-host copy of the token block inside run() is the
            # fence that ends the wave's device time
            _t = time.perf_counter()
            chunk, executed = self._decoder.run(
                tokens, self.lengths, budget, act, steps, eos, gen,
                table=self.block_table)
            phase_acc["device_execute"] = time.perf_counter() - _t
            n_emitted = 0
            _t = time.perf_counter()
            finished = []
            for step in range(int(executed)):
                if not active:
                    break
                for slot in list(active):
                    st = active[slot]
                    self.lengths[slot] += 1
                    # the KV just written belongs to the step's INPUT
                    # token (the previous current) — track it so release
                    # can promote full blocks into the prefix cache
                    self.slot_tokens[slot].append(st["current"])
                    token = int(chunk[step, slot])
                    st["emitted"].append(token)
                    st["current"] = token
                    done = ((gen.eos_token_id is not None
                             and token == gen.eos_token_id)
                            or len(st["emitted"]) >= st["max_new"]
                            or self.lengths[slot] + 1 >= self.max_len)
                    n_emitted += 1
                    yield st["req"], token, done
                    if done:
                        del active[slot]
                        finished.append(slot)
            for slot in finished:
                self._release(slot)
            # reply covers token fan-out INCLUDING consumer handoff (the
            # generator suspends at each yield): a slow consumer shows up
            # here, not hidden inside device time
            phase_acc["reply"] = time.perf_counter() - _t
            self.profiler.record_step(
                {k: v for k, v in phase_acc.items() if v > 0},
                tokens=n_emitted)
            phase_acc = {"input_wait": 0.0, "prefill": 0.0}
            poll(block=False)
            if finished or (pending and self.free_slots):
                _t = time.perf_counter()
                yield from admit_all()
                phase_acc["prefill"] += time.perf_counter() - _t

    def generate_stream(
        self,
        prompts: List[List[int]],
        gen: Optional[GenerationConfig] = None,
    ) -> Iterator[Tuple[int, int]]:
        """Yields (request_index, token_id) as tokens are produced
        (block-at-a-time: see InferenceEngine.generate_stream). One-shot
        wrapper over serve_stream with the whole batch fed up front."""
        gen = gen or GenerationConfig()
        for p in prompts:
            if not p:
                raise ValueError("cannot generate from an empty prompt")
            self._bucket_for(len(p))  # raises on prompts beyond max_len
        if not self.free_slots:
            raise RuntimeError(
                "no free engine slots (an earlier generate_stream was "
                "abandoned mid-stream?); create a fresh engine")
        batch = [(i, list(p), None) for i, p in enumerate(prompts)]

        def feed(_block: bool):
            out, batch[:] = list(batch), []
            return out, (), True

        for req_idx, token, _done in self.serve_stream(feed, gen):
            if token is None:
                raise RuntimeError(
                    self.abort_reasons.pop(req_idx, "request aborted"))
            yield req_idx, token

    def generate(self, prompts: List[List[int]],
                 gen: Optional[GenerationConfig] = None) -> List[List[int]]:
        out: List[List[int]] = [[] for _ in prompts]
        for req_idx, token in self.generate_stream(prompts, gen):
            out[req_idx].append(token)
        return out
