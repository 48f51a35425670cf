"""Llama-family decoder-only transformer in PyTorch: training and inference.

Counterpart of `ray_tpu/models/llama.py`: GQA attention (the hand-written
flash-attention kernels on CUDA, forward and backward), RMSNorm, SwiGLU and
RoPE over parameters kept as a plain dictionary of tensors, layers stacked
on a leading L axis as the JAX pytree stacks them. The casts sit where the
JAX package puts them, so bf16 rounds at the same points. The scan over
layers becomes a Python loop; its per-layer remat (`jax.checkpoint` with a
policy) becomes `torch.utils.checkpoint` with selective checkpointing.

The KV-cache paths update the cache in place where the JAX package donates
it and returns a new one. The paged cache and the mesh (sharding rules, ring
attention) are later slices.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch.ops.flash_attention import NEG_INF, flash_attention


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32_000
    d_model: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    d_head: int = 128
    d_ff: int = 14_336
    rope_theta: float = 500_000.0
    norm_eps: float = 1e-5
    max_seq_len: int = 8192
    dtype: torch.dtype = torch.bfloat16
    remat: bool = True
    # "full" recomputes everything; "dots" saves the outputs of the
    # un-batched matrix products and recomputes the rest (attention too).
    remat_policy: str = "dots"
    # >0: compute the training CE over sequence chunks of this size so the
    # full [B,S,V] fp32 logits tensor never materializes (chunked_ce).
    loss_chunk_size: int = 0

    @staticmethod
    def llama3_8b() -> "LlamaConfig":
        return LlamaConfig(
            vocab_size=128_256, d_model=4096, n_layers=32, n_heads=32,
            n_kv_heads=8, d_head=128, d_ff=14_336,
        )

    @staticmethod
    def tiny(vocab_size: int = 512) -> "LlamaConfig":
        return LlamaConfig(
            vocab_size=vocab_size, d_model=128, n_layers=2, n_heads=4,
            n_kv_heads=2, d_head=32, d_ff=256, max_seq_len=512,
        )

    @staticmethod
    def small_1b() -> "LlamaConfig":
        return LlamaConfig(
            vocab_size=32_000, d_model=2048, n_layers=16, n_heads=16,
            n_kv_heads=8, d_head=128, d_ff=5632,
        )

    def num_params(self) -> int:
        per_layer = (
            self.d_model * self.n_heads * self.d_head      # wq
            + 2 * self.d_model * self.n_kv_heads * self.d_head  # wk, wv
            + self.n_heads * self.d_head * self.d_model    # wo
            + 3 * self.d_model * self.d_ff                 # gate, up, down
            + 2 * self.d_model                             # norms
        )
        return (
            self.vocab_size * self.d_model                 # embed
            + self.n_layers * per_layer
            + self.d_model                                 # final norm
            + self.d_model * self.vocab_size               # lm head
        )


def param_shapes(config: LlamaConfig) -> Dict[str, Any]:
    """Shape of every parameter, in the JAX pytree's structure and layout."""
    c = config
    L, D, F_ = c.n_layers, c.d_model, c.d_ff
    return {
        "embed": (c.vocab_size, D),
        "layers": {
            "attn_norm": (L, D),
            "wq": (L, D, c.n_heads, c.d_head),
            "wk": (L, D, c.n_kv_heads, c.d_head),
            "wv": (L, D, c.n_kv_heads, c.d_head),
            "wo": (L, c.n_heads, c.d_head, D),
            "mlp_norm": (L, D),
            "w_gate": (L, D, F_),
            "w_up": (L, D, F_),
            "w_down": (L, F_, D),
        },
        "final_norm": (D,),
        "lm_head": (D, c.vocab_size),
    }


def init(config: LlamaConfig, generator: torch.Generator,
         device=None) -> Dict[str, Any]:
    """Random parameters with the JAX `init`'s shapes and fan-in scaling
    (normal * fan_in ** -0.5, norms at one). `generator` lives on `device`."""
    c = config
    dev = resolve_device(device)
    if generator.device.type != dev.type:
        raise ValueError(f"generator is on {generator.device}, "
                         f"parameters go to {dev}")
    fan_in = {"embed": c.d_model, "wq": c.d_model, "wk": c.d_model,
              "wv": c.d_model, "wo": c.n_heads * c.d_head,
              "w_gate": c.d_model, "w_up": c.d_model, "w_down": c.d_ff,
              "lm_head": c.d_model}

    def make(name, shape):
        if name.endswith("norm"):
            return torch.ones(shape, dtype=c.dtype, device=dev)
        w = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=dev)
        return w.mul_(fan_in[name] ** -0.5).to(c.dtype)

    shapes = param_shapes(c)
    return {
        name: ({n: make(n, s) for n, s in shape.items()}
               if name == "layers" else make(name, shape))
        for name, shape in shapes.items()
    }


def _layer_params(params, i: int) -> Dict[str, torch.Tensor]:
    return {name: w[i] for name, w in params["layers"].items()}


def _rms_norm(x, weight, eps):
    dtype = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps)).to(dtype) * weight


def _rope(x, positions, theta):
    # x: [B, S, H, D]; rotate pairs (d, d + D/2).
    d = x.shape[-1]
    half = d // 2
    freqs = 1.0 / (theta ** (
        torch.arange(half, dtype=torch.float32, device=x.device) / half))
    angles = positions[:, :, None].float() * freqs[None, None, :]
    cos = torch.cos(angles)[:, :, None, :]  # [B, S, 1, half]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def _proj_heads(h, w):
    """einsum("bsd,dhk->bshk", h, w) as one matrix product."""
    return (h @ w.reshape(w.shape[0], -1)).reshape(
        *h.shape[:-1], *w.shape[1:])


def _proj_out(attn, wo):
    """einsum("bshk,hkd->bsd", attn, wo) as one matrix product."""
    return attn.reshape(*attn.shape[:2], -1) @ wo.reshape(-1, wo.shape[-1])


def _qkv(x, params, positions, config: LlamaConfig):
    c = config
    h = _rms_norm(x, params["attn_norm"], c.norm_eps)
    q = _rope(_proj_heads(h, params["wq"]), positions, c.rope_theta)
    k = _rope(_proj_heads(h, params["wk"]), positions, c.rope_theta)
    v = _proj_heads(h, params["wv"])
    return q, k, v


def _attn_sublayer(x, params, positions, config: LlamaConfig,
                   kv_cache=None, lengths=None):
    """Pre-norm attention block. With kv_cache=(k_cache, v_cache), one
    layer's [B,T,kv,K] cache views, it adds the new K/V at `positions` into
    the cache in place (the JAX package's additive one-hot scatter, whose
    target slots are still zero) and attends over the cache; otherwise it
    attends over the block itself through flash attention."""
    c = config
    q, k, v = _qkv(x, params, positions, c)
    if kv_cache is not None:
        k_cache, v_cache = kv_cache
        _scatter_add(k_cache, positions, k)
        _scatter_add(v_cache, positions, v)
        attn = _cached_attention(q, k_cache, v_cache, lengths, c)
    else:
        attn = flash_attention(q, k, v, causal=True)
    return x + _proj_out(attn, params["wo"])


def _scatter_add(cache, positions, new):
    """cache[b, positions[b, s]] += new[b, s] in place; positions past the
    cache add nothing (JAX's one-hot of an out-of-range index is zero)."""
    t = cache.shape[1]
    keep = (positions < t)[..., None, None]
    rows = torch.arange(cache.shape[0], device=cache.device)[:, None]
    cache.index_put_((rows.expand_as(positions), positions.clamp(max=t - 1)),
                     torch.where(keep, new, 0).to(cache.dtype),
                     accumulate=True)


def _mlp_sublayer(x, params, config: LlamaConfig):
    """Pre-norm SwiGLU MLP block shared by the forward and decode paths."""
    c = config
    h = _rms_norm(x, params["mlp_norm"], c.norm_eps)
    gate = h @ params["w_gate"]
    up = h @ params["w_up"]
    return x + (F.silu(gate) * up) @ params["w_down"]


def _save_dots(ctx, op, *args, **kwargs):
    """`dots_with_no_batch_dims_saveable`: keep what an un-batched matrix
    product (aten.mm, which every projection here lowers to) returns;
    recompute the rest, batched products (aten.bmm) and the flash-attention
    kernel included, as the JAX policy recomputes its pallas_call."""
    return (CheckpointPolicy.MUST_SAVE if op == torch.ops.aten.mm.default
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat_context(config: LlamaConfig):
    """config.remat_policy -> the `context_fn` of torch.utils.checkpoint:
    "full" saves nothing; "dots" saves the matrix products' outputs.
    "dots_attn" (which also saves the flash output by name) is not ported."""
    name = config.remat_policy
    if name == "full":
        return None
    if name == "dots":
        return functools.partial(create_selective_checkpoint_contexts,
                                 _save_dots)
    raise ValueError(f"remat_policy {name!r} not in ('full', 'dots')")


def _layer(x, params, positions, config: LlamaConfig):
    x = _attn_sublayer(x, params, positions, config)
    return _mlp_sublayer(x, params, config)


def forward_hidden(params, tokens, config: LlamaConfig):
    """tokens [B,S] -> final-norm hidden states [B,S,D] (pre-lm_head).

    With config.remat and gradients enabled each layer is checkpointed under
    config.remat_policy; without gradients (serving) nothing is."""
    c = config
    b, s = tokens.shape
    positions = torch.arange(s, device=tokens.device).expand(b, s)
    x = params["embed"][tokens].to(c.dtype)
    remat = c.remat and torch.is_grad_enabled()
    if remat:
        context = _remat_context(c)
        kw = {} if context is None else {"context_fn": context}
    # unbind, not indexing: its backward stacks the L per-layer gradients in
    # one tensor instead of adding L full-size ones.
    layers = {name: w.unbind(0) for name, w in params["layers"].items()}
    for i in range(c.n_layers):
        lp = {name: ws[i] for name, ws in layers.items()}
        if remat:
            x = checkpoint(_layer, x, lp, positions, c, use_reentrant=False,
                           **kw)
        else:
            x = _layer(x, lp, positions, c)
    return _rms_norm(x, params["final_norm"], c.norm_eps)


def forward(params, tokens, config: LlamaConfig):
    """tokens: [B, S] integer -> logits [B, S, vocab] (cast to fp32)."""
    x = forward_hidden(params, tokens, config)
    return (x @ params["lm_head"]).float()


def _chunk_nll(hidden, lm_head, targets, mask):
    """Summed masked next-token NLL of one chunk, its logits in fp32."""
    logits = (hidden @ lm_head).float()
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, targets[..., None].long())[..., 0]
    return torch.sum(nll * mask)


def chunked_ce(hidden, lm_head, targets, mask=None, chunk: int = 256):
    """Cross-entropy without materializing full [B,S,V] fp32 logits: the
    sequence goes in chunks and each full chunk's logits are recomputed in
    the backward (checkpointed); a last partial chunk is taken as it is.
    Returns sum(nll * mask) / max(sum(mask), 1)."""
    b, s, _ = hidden.shape
    mask = (torch.ones((b, s), dtype=torch.float32, device=hidden.device)
            if mask is None else mask.to(torch.float32))
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for start in range(0, s, chunk):
        sl = slice(start, start + chunk)
        args = (hidden[:, sl], lm_head, targets[:, sl], mask[:, sl])
        if start + chunk <= s and torch.is_grad_enabled():
            total = total + checkpoint(_chunk_nll, *args, use_reentrant=False)
        else:
            total = total + _chunk_nll(*args)
    return total / torch.clamp(mask.sum(), min=1.0)


def loss_fn(params, batch, config: LlamaConfig):
    """Next-token cross-entropy. batch: {"tokens": [B, S]} (targets are the
    shifted tokens) or explicit {"inputs", "targets", "mask"}.
    With config.loss_chunk_size > 0 the CE is computed chunk by chunk over
    the sequence (see chunked_ce) so full-vocab logits never materialize."""
    if "inputs" in batch:
        inputs, targets = batch["inputs"], batch["targets"]
        mask = batch.get("mask")
    else:
        tokens = batch["tokens"]
        inputs, targets = tokens[:, :-1], tokens[:, 1:]
        mask = None
    hidden = forward_hidden(params, inputs, config)
    if config.loss_chunk_size:
        return chunked_ce(hidden, params["lm_head"], targets, mask,
                          chunk=config.loss_chunk_size)
    mask = (torch.ones(targets.shape, device=hidden.device)
            if mask is None else mask.to(torch.float32))
    return (_chunk_nll(hidden, params["lm_head"], targets, mask)
            / torch.clamp(mask.sum(), min=1.0))


def init_kv_cache(config: LlamaConfig, batch: int, max_len: int,
                  dtype: Optional[torch.dtype] = None,
                  device=None) -> Dict[str, torch.Tensor]:
    """Per-layer KV cache for incremental decoding: tensors shaped
    [n_layers, batch, max_len, n_kv_heads, d_head], zero-filled."""
    c = config
    dev = resolve_device(device)
    shape = (c.n_layers, batch, max_len, c.n_kv_heads, c.d_head)
    dtype = dtype or c.dtype
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


def _cached_attention(q, k_cache, v_cache, lengths, config: LlamaConfig):
    """q: [B,S,H,K] new queries at positions lengths..lengths+S;
    k/v_cache: [B,T,kv,K] full cache (already containing the new keys).
    Masks out cache positions >= lengths+S and enforces causality within
    the new block. Grouped-query aware (q as [B,S,kv,rep,K], no repeat of
    the cache); products accumulate in fp32 as the JAX package's
    preferred_element_type asks."""
    c = config
    b, s, h, d = q.shape
    t = k_cache.shape[1]
    rep = c.n_heads // c.n_kv_heads
    qg = q.reshape(b, s, c.n_kv_heads, rep, d)
    scores = torch.einsum("bsgrk,btgk->bgrst", qg.float(),
                          k_cache.float()) / (d ** 0.5)
    # position j is visible to query i (absolute pos lengths+i) iff j <= pos.
    q_pos = (lengths[:, None, None, None, None]
             + torch.arange(s, device=q.device)[None, None, None, :, None])
    j_pos = torch.arange(t, device=q.device)[None, None, None, None, :]
    scores = torch.where(j_pos <= q_pos, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bgrst,btgk->bsgrk",
                       probs.to(v_cache.dtype).float(), v_cache.float())
    return out.reshape(b, s, h, d).to(q.dtype)


def _decode_attention(q, k_new, v_new, k_cache, v_cache, lengths,
                      config: LlamaConfig):
    """Single-token attention where the current token's K/V is NOT yet in
    the cache: q/k_new/v_new [B,1,H|kv,K], k/v_cache [B,T,kv,K] holding
    positions 0..lengths-1. The self-attention term is computed directly
    from k_new/v_new, so the cache takes one scatter per decode step
    (forward_with_cache) instead of one per layer."""
    c = config
    b, s, h, d = q.shape
    t = k_cache.shape[1]
    rep = c.n_heads // c.n_kv_heads
    qg = q.reshape(b, s, c.n_kv_heads, rep, d).float()
    scores = torch.einsum("bsgrk,btgk->bgrst", qg,
                          k_cache.float()) / (d ** 0.5)
    j_pos = torch.arange(t, device=q.device)[None, None, None, None, :]
    valid = j_pos < lengths[:, None, None, None, None]
    scores = torch.where(valid, scores, NEG_INF)
    self_score = torch.einsum("bsgrk,bgk->bgrs", qg,
                              k_new[:, 0].float()) / (d ** 0.5)
    all_scores = torch.cat([scores, self_score[..., None]], dim=-1)
    probs = torch.softmax(all_scores, dim=-1)
    out = torch.einsum("bgrst,btgk->bsgrk",
                       probs[..., :t].to(v_cache.dtype).float(),
                       v_cache.float())
    out = out + torch.einsum("bgrs,bgk->bsgrk", probs[..., t],
                             v_new[:, 0].float())
    return out.reshape(b, s, h, d).to(q.dtype)


def _attn_sublayer_decode(x, params, positions, config: LlamaConfig,
                          k_cache, v_cache):
    """Decode-step (S=1) attention block: attends over the cache plus the
    new token's own K/V, returning (x, (k, v)) with the new K/V for the
    deferred cache scatter in forward_with_cache."""
    c = config
    q, k, v = _qkv(x, params, positions, c)
    attn = _decode_attention(q, k, v, k_cache, v_cache, positions[:, 0], c)
    x = x + _proj_out(attn, params["wo"])
    return x, (k.to(k_cache.dtype), v.to(v_cache.dtype))


def forward_with_cache(params, tokens, cache, lengths, config: LlamaConfig):
    """Incremental forward for generation (prefill when S>1, decode at S=1).

    tokens: [B, S] the NEW tokens, logically at positions lengths..lengths+S.
    cache:  dict from init_kv_cache, updated IN PLACE (the JAX package
            donates it and returns the new one; this returns the same dict).
    lengths: [B] integer — number of tokens already in the cache per row.
    -> (logits [B, S, vocab] fp32, cache)
    """
    c = config
    b, s = tokens.shape
    positions = lengths[:, None] + torch.arange(s, device=tokens.device)[None]
    x = params["embed"][tokens].to(c.dtype)

    if s == 1:
        # Layers only READ the cache; the new K/V of every layer lands in it
        # with one scatter after the loop.
        k_new, v_new = [], []
        for i in range(c.n_layers):
            lp = _layer_params(params, i)
            x, (k1, v1) = _attn_sublayer_decode(
                x, lp, positions, c, cache["k"][i], cache["v"][i])
            x = _mlp_sublayer(x, lp, c)
            k_new.append(k1[:, 0])
            v_new.append(v1[:, 0])
        t = cache["k"].shape[2]
        # JAX's mode="drop": a row whose length is already T writes nothing
        # (it rewrites its last slot with the value already there).
        keep = (lengths < t)[None, :, None, None]
        b_idx = torch.arange(b, device=tokens.device)
        pos = lengths.clamp(max=t - 1)
        for name, rows in (("k", k_new), ("v", v_new)):
            old = cache[name][:, b_idx, pos]
            cache[name][:, b_idx, pos] = torch.where(
                keep, torch.stack(rows), old)
    else:
        for i in range(c.n_layers):
            lp = _layer_params(params, i)
            x = _attn_sublayer(x, lp, positions, c,
                               kv_cache=(cache["k"][i], cache["v"][i]),
                               lengths=lengths)
            x = _mlp_sublayer(x, lp, c)
    x = _rms_norm(x, params["final_norm"], c.norm_eps)
    return (x @ params["lm_head"]).float(), cache


def flops_per_token(config: LlamaConfig, seq_len: int) -> float:
    """Approx training FLOPs/token (fwd+bwd ≈ 6N + attention term)."""
    c = config
    param_flops = 6.0 * c.num_params()
    # Causal attention: QK^T + PV = 2 matmuls × 2 flops × H·D × S/2 (causal
    # average) × 3 (fwd+bwd) = 6·H·D·S per layer per token.
    attn_flops = 6.0 * c.n_layers * c.n_heads * c.d_head * seq_len
    return param_flops + attn_flops
