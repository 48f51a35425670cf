"""InferenceEngine: slot-based continuous batching over a dense KV cache.

Counterpart of `ray_tpu/inference/engine.py`, with its scheduling kept:

  * BUCKETED PREFILL — a wave of admitted prompts is padded to one size
    bucket (powers of two from 64 up to max_len) and prefilled together,
    each row's first token sampled on the device.
  * CONTINUOUS BATCHING — requests occupy slots of a fixed-size batch; a
    finished request frees its slot for the next admission without
    stopping decode for the others. Decode always steps all max_batch rows.
  * FUSED DECODE — the decode-sample-append loop runs up to n steps per
    call with on-device sampling and per-slot budget/EOS/length tracking,
    handing the host one [steps, B] token block at the end.

PyTorch runs eagerly, so the JAX package's compiled while-loop is a Python
loop here that reads one flag from the device per step (to stop when every
slot is done); the KV cache is updated in place where JAX donates it.

Model-agnostic: any model exposing `forward_with_cache(params, tokens,
cache, lengths, config)` and `init_kv_cache(config, batch, max_len,
device=...)` works (models/llama.py provides both).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch.inference.sampling import sample_token


@dataclasses.dataclass(frozen=True)
class GenerationConfig:
    max_new_tokens: int = 64
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    eos_token_id: Optional[int] = None


def _default_buckets(max_len: int) -> Tuple[int, ...]:
    out, b = [], 64
    while b < max_len:
        out.append(b)
        b *= 2
    out.append(max_len)
    return tuple(out)


class InferenceEngine:
    def __init__(
        self,
        params: Any,
        config: Any,
        *,
        forward_with_cache: Optional[Callable] = None,
        init_kv_cache: Optional[Callable] = None,
        max_batch: int = 8,
        max_len: int = 1024,
        prefill_buckets: Optional[Tuple[int, ...]] = None,
        decode_chunk: int = 16,
        device=None,
    ):
        """`params` must already be on `device` (cuda unless "cpu")."""
        if forward_with_cache is None or init_kv_cache is None:
            from ray_tpu_torch.models import llama

            forward_with_cache = forward_with_cache or llama.forward_with_cache
            init_kv_cache = init_kv_cache or llama.init_kv_cache
        self.device = resolve_device(device)
        for w in _tensors(params):
            if w.device.type != self.device.type:
                raise ValueError(f"a parameter is on {w.device}; the engine "
                                 f"runs on {self.device}")
        self.params = params
        self.config = config
        self.max_batch = max_batch
        self.max_len = max_len
        self.buckets = prefill_buckets or _default_buckets(max_len)
        self._fwd = forward_with_cache
        self.cache = init_kv_cache(config, max_batch, max_len,
                                   device=self.device)
        # slot state (host side)
        self.lengths = np.zeros(max_batch, dtype=np.int64)
        self.free_slots = list(range(max_batch))
        self._gen = torch.Generator(device=self.device).manual_seed(0)
        self.decode_chunk = max(1, decode_chunk)

    # -- device side --------------------------------------------------------

    def _tensor(self, array) -> torch.Tensor:
        return torch.as_tensor(np.asarray(array, np.int64),
                               device=self.device)

    @torch.no_grad()
    def _prefill_batch(self, tokens, slots, true_lens, gen):
        """Batched admission: tokens [N, bucket] padded prompts, slots [N]
        distinct slot indices, true_lens [N]. Prefills all N rows into a
        fresh cache, copies each row's first true_len positions into its
        slot (zeros after), and samples each row's first token."""
        n = tokens.shape[0]
        t = self.cache["k"].shape[2]
        row_cache = {name: torch.zeros((c.shape[0], n) + c.shape[2:],
                                       dtype=c.dtype, device=c.device)
                     for name, c in self.cache.items()}
        logits, row_cache = self._fwd(
            self.params, tokens, row_cache,
            torch.zeros(n, dtype=torch.int64, device=self.device),
            self.config)
        valid = (torch.arange(t, device=self.device)[None, :]
                 < true_lens[:, None])[None, :, :, None, None]
        for name, c in self.cache.items():
            c[:, slots] = torch.where(valid, row_cache[name], 0).to(c.dtype)
        last = logits[torch.arange(n, device=self.device), true_lens - 1]
        return sample_token(last, self._gen, temperature=gen.temperature,
                            top_k=gen.top_k, top_p=gen.top_p)

    @torch.no_grad()
    def _decode_full(self, tokens, lengths, budget, active, n_steps: int,
                     eos_id: int, gen):
        """Up to `n_steps` decode steps with on-device sampling, per-slot
        budget/EOS/length tracking, and an early exit when every slot is
        done. tokens [B,1]; budget [B] remaining new-token allowance;
        active [B] bool; eos_id -1 for none.
        -> (out [n_steps, B] tokens, -1 where inactive; executed steps)."""
        t_max = self.cache["k"].shape[2]
        out = torch.zeros((n_steps, tokens.shape[0]), dtype=torch.int64,
                          device=self.device)
        tok, lens, rem, act = tokens, lengths, budget, active
        i = 0
        while i < n_steps and bool(act.any()):
            logits, self.cache = self._fwd(self.params, tok, self.cache,
                                           lens, self.config)
            nxt = sample_token(logits[:, -1], self._gen,
                               temperature=gen.temperature,
                               top_k=gen.top_k, top_p=gen.top_p)
            out[i] = torch.where(act, nxt, -1)
            lens = torch.where(act, lens + 1, lens)
            rem = torch.where(act, rem - 1, rem)
            act = act & (rem > 0) & (nxt != eos_id) & (lens + 1 < t_max)
            tok = nxt[:, None]
            i += 1
        return out, i

    # -- internals ----------------------------------------------------------

    def _bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        raise ValueError(f"prompt of {n} tokens exceeds max_len={self.max_len}")

    def _release(self, slot: int) -> None:
        self.lengths[slot] = 0
        self.free_slots.append(slot)

    def _pack(self, batch, bucket):
        toks = np.zeros((len(batch), bucket), dtype=np.int64)
        true_lens = np.zeros((len(batch),), dtype=np.int64)
        for row, (_, prompt) in enumerate(batch):
            toks[row, :len(prompt)] = prompt
            true_lens[row] = len(prompt)
        return toks, true_lens

    def _consume_block(self, out, executed, active, gen) -> Iterator[
            Tuple[int, int]]:
        """Walk a [steps, B] token block from the fused decode, yielding
        (req_idx, token) and releasing slots as their host-side done
        conditions fire (mirrors the device's active-mask logic, so the
        -1 filler rows past a slot's completion are never read)."""
        for step in range(int(executed)):
            if not active:
                break
            for slot in list(active):
                st = active[slot]
                self.lengths[slot] += 1
                token = int(out[step, slot])
                st["produced"] += 1
                st["current"] = token
                done = (
                    (gen.eos_token_id is not None
                     and token == gen.eos_token_id)
                    or st["produced"] >= gen.max_new_tokens
                    or self.lengths[slot] + 1 >= self.max_len)
                yield st["req"], token
                if done:
                    del active[slot]
                    self._release(slot)

    def _run_wave(self, pending, active, gen) -> Iterator[Tuple[int, int]]:
        """Fresh same-bucket batch: prefill and first-token sampling, then
        the whole decode in one fused run, with one device-to-host copy of
        the first tokens and one of the token block."""
        batch = pending[::-1]  # original submission order
        n = len(batch)
        bucket = self._bucket_for(max(len(p) for _, p in batch))
        slots = [self.free_slots.pop() for _ in range(n)]
        toks, true_lens = self._pack(batch, bucket)
        need = max(max(1, min(gen.max_new_tokens - 1,
                              self.max_len - 1 - len(p)))
                   for _, p in batch)
        eos = gen.eos_token_id if gen.eos_token_id is not None else -1
        t_max = self.cache["k"].shape[2]
        try:
            slots_t, lens_t = self._tensor(slots), self._tensor(true_lens)
            firsts = self._prefill_batch(self._tensor(toks), slots_t,
                                         lens_t, gen)
            b = self.max_batch
            tok0 = torch.zeros((b, 1), dtype=torch.int64, device=self.device)
            tok0[slots_t, 0] = firsts
            lens0 = torch.zeros(b, dtype=torch.int64, device=self.device)
            lens0[slots_t] = lens_t
            bud0 = torch.zeros(b, dtype=torch.int64, device=self.device)
            bud0[slots_t] = gen.max_new_tokens - 1
            act0 = torch.zeros(b, dtype=torch.bool, device=self.device)
            act0[slots_t] = (firsts != eos) & (lens_t + 1 < t_max)
            act0 &= bud0 > 0
            out, executed = self._decode_full(tok0, lens0, bud0, act0, need,
                                              eos, gen)
            firsts, out = firsts.cpu().numpy(), out.cpu().numpy()
        except Exception:
            self.free_slots.extend(slots)
            raise
        for (req_idx, prompt), slot, first in zip(batch, slots, firsts):
            first = int(first)
            self.lengths[slot] = len(prompt)
            yield req_idx, first
            if ((gen.eos_token_id is not None
                 and first == gen.eos_token_id)
                    or self.lengths[slot] + 1 >= self.max_len):
                self._release(slot)
                continue
            active[slot] = {"req": req_idx, "produced": 1, "current": first}
        yield from self._consume_block(out, executed, active, gen)

    # -- public API ---------------------------------------------------------

    def generate_stream(
        self,
        prompts: List[List[int]],
        gen: Optional[GenerationConfig] = None,
    ) -> Iterator[Tuple[int, int]]:
        """Continuous-batching generation. Yields (request_index, token_id)
        pairs; requests are admitted as slots free up.

        Tokens arrive in BLOCKS: the fused decode runs a whole generation
        (or decode_chunk steps when requests are waiting) per call, and this
        iterator drains each block as it lands."""
        gen = gen or GenerationConfig()
        for p in prompts:
            if not p:
                raise ValueError("cannot generate from an empty prompt")
        if not self.free_slots:
            # All slots are occupied — only possible when a previous
            # generate_stream iterator was abandoned mid-stream; refuse
            # rather than silently serving nothing.
            raise RuntimeError(
                "no free engine slots (an earlier generate_stream was "
                "abandoned mid-stream?); create a fresh engine")
        pending = list(enumerate(prompts))[::-1]  # stack of (req_idx, prompt)
        active: Dict[int, dict] = {}  # slot -> {req, produced, current}

        # Fresh-batch path: when every prompt fits one admission wave (same
        # bucket, enough free slots), prefill and the whole decode run as
        # one wave.
        if (pending and len(pending) <= len(self.free_slots)
                and gen.max_new_tokens > 1
                and len({self._bucket_for(len(p)) for _, p in pending}) == 1):
            yield from self._run_wave(pending, active, gen)
            pending = []

        def admit_all():
            """Admit pending prompts in bucket-grouped WAVES: one batched
            prefill per (bucket, group-size) instead of one per request."""
            while pending and self.free_slots:
                bucket = self._bucket_for(len(pending[-1][1]))
                batch: List[Tuple[int, List[int]]] = []
                while (pending and len(batch) < len(self.free_slots)
                       and self._bucket_for(len(pending[-1][1])) == bucket):
                    batch.append(pending.pop())
                slots = [self.free_slots.pop() for _ in batch]
                toks, true_lens = self._pack(batch, bucket)
                try:
                    firsts = self._prefill_batch(
                        self._tensor(toks), self._tensor(slots),
                        self._tensor(true_lens), gen).cpu().numpy()
                except Exception:
                    self.free_slots.extend(slots)
                    raise
                for (req_idx, prompt), slot, first in zip(
                        batch, slots, firsts):
                    first = int(first)
                    self.lengths[slot] = len(prompt)
                    yield req_idx, first
                    # A prefill-sampled token can already terminate.
                    if ((gen.eos_token_id is not None
                         and first == gen.eos_token_id)
                            or gen.max_new_tokens <= 1
                            or self.lengths[slot] + 1 >= self.max_len):
                        self._release(slot)
                        continue
                    active[slot] = {"req": req_idx, "produced": 1,
                                    "current": first}

        yield from admit_all()
        while active:
            tokens = np.zeros((self.max_batch, 1), dtype=np.int64)
            budget = np.zeros(self.max_batch, dtype=np.int64)
            act = np.zeros(self.max_batch, dtype=bool)
            for slot, st in active.items():
                tokens[slot, 0] = st["current"]
                budget[slot] = gen.max_new_tokens - st["produced"]
                act[slot] = True
            # Run the WHOLE remaining generation in one call unless requests
            # are waiting for a slot — slots can free early via EOS, budget
            # variance across admission waves, or per-slot max_len caps, so
            # cap at decode_chunk to keep admission responsive whenever
            # anything is pending.
            need = max(
                min(gen.max_new_tokens - st["produced"],
                    self.max_len - 1 - self.lengths[slot])
                for slot, st in active.items())
            need = max(1, int(need))
            if pending:
                need = min(need, self.decode_chunk)
            eos = (gen.eos_token_id
                   if gen.eos_token_id is not None else -1)
            out, executed = self._decode_full(
                self._tensor(tokens), self._tensor(self.lengths),
                self._tensor(budget),
                torch.as_tensor(act, device=self.device), need, eos, gen)
            out = out.cpu().numpy()
            n_before = len(active)
            yield from self._consume_block(out, executed, active, gen)
            if pending and len(active) < n_before:
                yield from admit_all()

    def generate(self, prompts: List[List[int]],
                 gen: Optional[GenerationConfig] = None) -> List[List[int]]:
        """-> new tokens per prompt (prompt not included)."""
        out: List[List[int]] = [[] for _ in prompts]
        for req_idx, token in self.generate_stream(prompts, gen):
            out[req_idx].append(token)
        return out


def _tensors(tree) -> Iterator[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
