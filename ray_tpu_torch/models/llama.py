"""Llama-family decoder-only transformer in PyTorch: training and inference.

Counterpart of `ray_tpu/models/llama.py`: GQA attention (the hand-written
flash-attention kernels on CUDA, forward and backward), RMSNorm, SwiGLU and
RoPE over parameters kept as a plain dictionary of tensors, layers stacked
on a leading L axis as the JAX pytree stacks them. The casts sit where the
JAX package puts them, so bf16 rounds at the same points. The scan over
layers becomes a Python loop; its per-layer remat (`jax.checkpoint` with a
policy) becomes `torch.utils.checkpoint` with selective checkpointing.

The KV-cache paths, dense and paged, update the cache in place where the
JAX package donates it and returns a new one, and contract the cache as it
is stored with fp32 accumulation (`_attend`; no fp32 copy of the cache).

With `mesh=` (a named DeviceMesh, `parallel.mesh`) `forward_hidden`,
`forward` and `loss_fn` take DTensor parameters in their logical shardings
(`param_logical_axes`, `parallel.sharding`) and a DTensor batch, and run
each rank's block of the same arithmetic, saying the collectives GSPMD
would insert (`ShardingContext`): a layer's weights are gathered over the
data dims right before use, inside the layer's checkpoint, so the backward
gathers them again and reduces their gradients (FSDP as GSPMD lowers it);
column-parallel products take their heads or hidden units of the tp split
and row-parallel ones end in the tp sum that JAX's act_embed constraint
asks for; the embedding and the cross-entropy are vocab-parallel; attention
runs through `flash_attention_sharded`, or the ring over sp
(`use_ring_attention`). With mesh=None everything is as it was.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch.ops.flash_attention import (NEG_INF, flash_attention,
                                               flash_attention_sharded)
from ray_tpu_torch.parallel import ring_attention  # noqa: F401 ring_fwd
from ray_tpu_torch.parallel.sharding import ShardingContext


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
    # un-batched matrix products and recomputes the rest (attention too);
    # "dots_attn" also saves the attention forward's outputs.
    remat_policy: str = "dots"
    # >0: compute the training CE over sequence chunks of this size so the
    # full [B,S,V] fp32 logits tensor never materializes (chunked_ce).
    loss_chunk_size: int = 0
    use_ring_attention: bool = False  # set when mesh sp-axis > 1

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


def param_logical_axes(config: LlamaConfig) -> Dict[str, Any]:
    """Logical axis names per parameter (layers stacked on 'layers')."""
    L = ("layers",)
    return {
        "embed": ("vocab", "embed"),
        "layers": {
            "attn_norm": L + (None,),
            "wq": L + ("embed", "heads", "kv"),
            "wk": L + ("embed", "heads", "kv"),
            "wv": L + ("embed", "heads", "kv"),
            "wo": L + ("heads", "kv", "embed"),
            "mlp_norm": L + (None,),
            "w_gate": L + ("embed", "mlp"),
            "w_up": L + ("embed", "mlp"),
            "w_down": L + ("mlp", "embed"),
        },
        "final_norm": (None,),
        "lm_head": ("embed", "vocab"),
    }


def init(config: LlamaConfig, generator: torch.Generator,
         device=None) -> Dict[str, Any]:
    """Random parameters with the JAX `init`'s shapes and fan-in scaling
    (normal * fan_in ** -0.5, norms at one). `generator` lives on `device`."""
    c = config
    fan_in = {"embed": c.d_model, "wq": c.d_model, "wk": c.d_model,
              "wv": c.d_model, "wo": c.n_heads * c.d_head,
              "w_gate": c.d_model, "w_up": c.d_model, "w_down": c.d_ff,
              "lm_head": c.d_model}
    return random_params(
        param_shapes(c), lambda name, shape: (
            None if name.endswith("norm") else fan_in[name] ** -0.5),
        generator, c.dtype, device)


def random_params(shapes, std: Callable[[str, tuple], Optional[float]],
                  generator: torch.Generator, dtype: torch.dtype,
                  device=None):
    """Nested dictionaries and lists of shapes -> tensors of `dtype` on
    `device`, drawn in the shapes' order: normal * std(name, shape), ones
    where std is None and zeros where it is 0. `generator` lives on
    `device`."""
    dev = resolve_device(device)
    if generator.device.type != dev.type:
        raise ValueError(f"generator is on {generator.device}, "
                         f"parameters go to {dev}")

    def make(name, shape):
        scale = std(name, shape)
        if scale is None:
            return torch.ones(shape, dtype=dtype, device=dev)
        if scale == 0:
            return torch.zeros(shape, dtype=dtype, device=dev)
        w = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=dev)
        return w.mul_(scale).to(dtype)

    def walk(name, node):
        if isinstance(node, dict):
            return {n: walk(n, v) for n, v in node.items()}
        if isinstance(node, list):
            return [walk(name, v) for v in node]
        return make(name, node)

    return walk("", shapes)


def unbind_layers(layers, n: int):
    """Parameters stacked on a leading L axis (nested dictionaries) -> the
    n per-layer dictionaries. unbind, not indexing: its backward stacks the
    L per-layer gradients in one tensor instead of adding L full-size
    ones."""
    per_layer = [{} for _ in range(n)]
    for name, w in layers.items():
        parts = unbind_layers(w, n) if isinstance(w, dict) else w.unbind(0)
        for i in range(n):
            per_layer[i][name] = parts[i]
    return per_layer


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


def _proj_out(attn, wo, tp_sum=None):
    """einsum("bshk,hkd->bsd", attn, wo) as one matrix product, summed over
    the tp ranks by tp_sum where wo holds this rank's heads (`_row_out`)."""
    return _row_out(attn.reshape(*attn.shape[:2], -1),
                    wo.reshape(-1, wo.shape[-1]), tp_sum)


def _row_out(h, w, tp_sum=None):
    """h @ w for a weight whose rows may be this rank's tp block; tp_sum
    (None off a mesh) sums the partial products over the tp ranks. Given
    `ShardingContext.tp_sum_f32` (the engines'), each partial is the
    product's fp32 accumulator (`_bmm_f32`) and the sum is rounded once to
    h's dtype, where one card rounds its whole product once."""
    if getattr(tp_sum, "__func__", None) is not ShardingContext.tp_sum_f32:
        return _maybe(tp_sum, h @ w)
    flat = _bmm_f32(h.reshape(1, -1, h.shape[-1]), w[None])
    return tp_sum(flat).reshape(*h.shape[:-1], w.shape[-1]).to(h.dtype)


def _qkv(x, params, positions, config: LlamaConfig, tp_copy=None):
    """tp_copy: where wq/wk/wv hold this rank's heads of a tp split, the
    identity whose backward sums the normed input's gradient over tp."""
    c = config
    h = _maybe(tp_copy, _rms_norm(x, params["attn_norm"], c.norm_eps))
    q = _rope(_proj_heads(h, params["wq"]), positions, c.rope_theta)
    k = _rope(_proj_heads(h, params["wk"]), positions, c.rope_theta)
    v = _proj_heads(h, params["wv"])
    return q, k, v


def _attn_sublayer(x, params, positions, config: LlamaConfig,
                   kv_cache=None, lengths=None, attention=flash_attention,
                   tp_copy=None, tp_sum=None):
    """Pre-norm attention block. With kv_cache=(k_cache, v_cache), one
    layer's [B,T,kv,K] cache views, it adds the new K/V at `positions` into
    the cache in place (the JAX package's additive one-hot scatter, whose
    target slots are still zero) and attends over the cache; otherwise it
    attends over the block itself through `attention` (flash attention; on
    a mesh, over the whole sequence from this rank's blocks). tp_copy and
    tp_sum: the tp collectives around the column- and row-parallel
    products (`_qkv`, `_mlp_sublayer`)."""
    c = config
    q, k, v = _qkv(x, params, positions, c, tp_copy)
    if kv_cache is not None:
        k_cache, v_cache = kv_cache
        _scatter_add(k_cache, positions, k)
        _scatter_add(v_cache, positions, v)
        attn = _cached_attention(q, k_cache, v_cache, lengths, c)
    else:
        attn = attention(q, k, v, causal=True)
    return x + _proj_out(attn, params["wo"], tp_sum)


def _scatter_add(cache, positions, new):
    """cache[b, positions[b, s]] += new[b, s] in place; positions past the
    cache add nothing (JAX's one-hot of an out-of-range index is zero)."""
    t = cache.shape[1]
    keep = (positions < t)[..., None, None]
    rows = torch.arange(cache.shape[0], device=cache.device)[:, None]
    cache.index_put_((rows.expand_as(positions), positions.clamp(max=t - 1)),
                     torch.where(keep, new, 0).to(cache.dtype),
                     accumulate=True)


def _mlp_sublayer(x, params, config: LlamaConfig, tp_copy=None,
                  tp_sum=None):
    """Pre-norm SwiGLU MLP block shared by the forward, decode and mesh
    paths. Where w_gate/w_up hold this rank's hidden units of a tp split and
    w_down the matching rows: tp_copy, the identity whose backward sums the
    normed input's gradient over the tp ranks, and tp_sum, the sum of the
    partial products over them."""
    c = config
    h = _maybe(tp_copy, _rms_norm(x, params["mlp_norm"], c.norm_eps))
    gate = h @ params["w_gate"]
    up = h @ params["w_up"]
    return x + _row_out(F.silu(gate) * up, params["w_down"], tp_sum)


def _maybe(fn, x):
    return x if fn is None else fn(x)


_ATTENTION_FORWARDS = (torch.ops.ray_tpu_torch.flash_fwd.default,
                       torch.ops.ray_tpu_torch.ring_fwd.default)


def _save_dots(ctx, op, *args, **kwargs):
    """`dots_with_no_batch_dims_saveable`: keep what an un-batched matrix
    product (aten.mm, which every projection here lowers to) returns;
    recompute the rest, batched products (aten.bmm) and the flash-attention
    forward included, as the JAX policy recomputes its pallas_call. The
    forward (or the ring's, which runs it block by block) is marked
    must-recompute, so a compiled step reruns it as the eager one does
    whatever the partitioner's cost model would choose."""
    if op == torch.ops.aten.mm.default:
        return CheckpointPolicy.MUST_SAVE
    if op in _ATTENTION_FORWARDS:
        return CheckpointPolicy.MUST_RECOMPUTE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _save_dots_attn(ctx, op, *args, **kwargs):
    """"dots" and the flash-attention forward's outputs, O and lse (the
    ring's too), so the backward reruns no attention forward. The JAX
    policy saves O by name ("attn_out") but not the custom_vjp's lse
    residual, so its backward still reruns the kernel (4 pallas_calls a
    layer, as under "dots"); this keeps the policy's stated purpose: one
    forward launch a layer."""
    if op == torch.ops.aten.mm.default or op in _ATTENTION_FORWARDS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


_REMAT_POLICIES = {"dots": _save_dots, "dots_attn": _save_dots_attn}


def _remat_context(config: LlamaConfig):
    """config.remat_policy -> the `context_fn` of torch.utils.checkpoint:
    "full" saves nothing; "dots" saves the matrix products' outputs;
    "dots_attn" those and the attention forward's (O and lse)."""
    name = config.remat_policy
    if name == "full":
        return None
    if name in _REMAT_POLICIES:
        return functools.partial(create_selective_checkpoint_contexts,
                                 _REMAT_POLICIES[name])
    raise ValueError(f"remat_policy {name!r} not in ('full', "
                     f"{', '.join(map(repr, _REMAT_POLICIES))})")


def layer_caller(config) -> Callable:
    """-> call(layer_fn, *args) = layer_fn(*args), checkpointed under
    config.remat_policy when config.remat and gradients are on (training);
    called as it is otherwise (serving)."""
    if not (config.remat and torch.is_grad_enabled()):
        return lambda fn, *args: fn(*args)
    context = _remat_context(config)
    kw = {} if context is None else {"context_fn": context}
    return lambda fn, *args: checkpoint(fn, *args, use_reentrant=False, **kw)


def _layer(x, params, positions, config: LlamaConfig):
    x = _attn_sublayer(x, params, positions, config)
    return _mlp_sublayer(x, params, config)


def forward_hidden(params, tokens, config: LlamaConfig, mesh=None,
                   rules=None):
    """tokens [B,S] -> final-norm hidden states [B,S,D] (pre-lm_head).

    With config.remat and gradients enabled each layer is checkpointed under
    config.remat_policy; without gradients (serving) nothing is. With a
    mesh, params and tokens are DTensors and so is the result (batch, seq,
    act_embed)."""
    if mesh is not None:
        ctx = ShardingContext(mesh, rules)
        x = _forward_hidden_sharded(params, tokens, config, ctx)
        return _as_dtensor(x, ctx, ("batch", "seq", "act_embed"))
    c = config
    b, s = tokens.shape
    positions = torch.arange(s, device=tokens.device).expand(b, s)
    x = params["embed"][tokens].to(c.dtype)
    call = layer_caller(c)
    for lp in unbind_layers(params["layers"], c.n_layers):
        x = call(_layer, x, lp, positions, c)
    return _rms_norm(x, params["final_norm"], c.norm_eps)


def forward(params, tokens, config: LlamaConfig, mesh=None, rules=None):
    """tokens: [B, S] integer -> logits [B, S, vocab] (cast to fp32); with a
    mesh, a DTensor (batch, seq, act_vocab)."""
    if mesh is not None:
        ctx = ShardingContext(mesh, rules)
        x = _forward_hidden_sharded(params, tokens, config, ctx)
        lm = ctx.gather(ctx.local(params["lm_head"]),
                        params["lm_head"].placements)
        logits = (ctx.tp_copy(x) @ lm).float()
        vocab = "act_vocab" if ctx.on_tp(params["lm_head"].placements, 1) \
            else None
        return _as_dtensor(logits, ctx, ("batch", "seq", vocab))
    x = forward_hidden(params, tokens, config)
    return (x @ params["lm_head"]).float()


def _chunk_nll(hidden, lm_head, targets, mask):
    """Summed masked next-token NLL of one chunk, its logits in fp32."""
    logits = (hidden @ lm_head).float()
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, targets[..., None].long())[..., 0]
    return torch.sum(nll * mask)


def chunked_ce(hidden, lm_head, targets, mask=None, chunk: int = 256,
               nll=_chunk_nll, count_sum=None):
    """Cross-entropy without materializing full [B,S,V] fp32 logits: the
    sequence goes in chunks and each full chunk's logits are recomputed in
    the backward (checkpointed); a last partial chunk is taken as it is.
    chunk 0 takes the sequence as one piece, not checkpointed. nll: one
    chunk's summed masked NLL (on a mesh with the vocab over tp, the
    vocab-parallel one); count_sum: the mask count divided by, from this
    rank's (on a mesh, its sum over the data dims).
    Returns sum(nll * mask) / max(count_sum(sum(mask)), 1)."""
    b, s, _ = hidden.shape
    mask = (torch.ones((b, s), dtype=torch.float32, device=hidden.device)
            if mask is None else mask.to(torch.float32))
    step = chunk or s
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for start in range(0, s, step):
        sl = slice(start, start + step)
        args = (hidden[:, sl], lm_head, targets[:, sl], mask[:, sl])
        if chunk and start + chunk <= s and torch.is_grad_enabled():
            total = total + checkpoint(nll, *args, use_reentrant=False)
        else:
            total = total + nll(*args)
    return total / torch.clamp(_maybe(count_sum, mask.sum()), min=1.0)


def _loss_inputs(batch):
    if "inputs" in batch:
        return batch["inputs"], batch["targets"], batch.get("mask")
    tokens = batch["tokens"]
    return tokens[:, :-1], tokens[:, 1:], None


def loss_fn(params, batch, config: LlamaConfig, mesh=None, rules=None):
    """Next-token cross-entropy. batch: {"tokens": [B, S]} (targets are the
    shifted tokens) or explicit {"inputs", "targets", "mask"}.
    With config.loss_chunk_size > 0 the CE is computed chunk by chunk over
    the sequence (see chunked_ce) so full-vocab logits never materialize.
    With a mesh, params and batch are DTensors in their shardings and the
    loss, the mean over the global batch, is on every rank."""
    if mesh is not None:
        return _loss_sharded(params, batch, config, ShardingContext(
            mesh, rules))
    inputs, targets, mask = _loss_inputs(batch)
    hidden = forward_hidden(params, inputs, config)
    if config.loss_chunk_size:
        return chunked_ce(hidden, params["lm_head"], targets, mask,
                          chunk=config.loss_chunk_size)
    mask = (torch.ones(targets.shape, device=hidden.device)
            if mask is None else mask.to(torch.float32))
    return (_chunk_nll(hidden, params["lm_head"], targets, mask)
            / torch.clamp(mask.sum(), min=1.0))


# -- the sharded path ----------------------------------------------------------

def _as_dtensor(local, ctx, logical_axes):
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(local, ctx.mesh, ctx.placements(logical_axes),
                              run_check=False)


def _layer_placements(stacked):
    """The placements of one layer's slice of a parameter stacked on a
    leading L axis (which no rule splits)."""
    from torch.distributed.tensor import Shard

    out = []
    for p in stacked:
        if isinstance(p, Shard):
            if p.dim == 0:
                raise ValueError("the stacked layer axis of a parameter is "
                                 "split; no rule of the port splits it")
            p = Shard(p.dim - 1)
        out.append(p)
    return tuple(out)


def _layer_sharded(x, lp, positions, config: LlamaConfig, ctx, placements):
    """`_layer` on this rank's blocks: lp holds the layer's local parameter
    blocks, gathered here, inside the layer's checkpoint, so the backward
    gathers them again instead of keeping them; the sublayers take the tp
    collectives where their products split over tp, and attention over the
    whole sequence."""
    w = {n: ctx.gather(t, placements[n]) for n, t in lp.items()}
    heads_tp = ctx.on_tp(placements["wq"], 1)
    if ctx.on_tp(placements["wo"], 0) != heads_tp:
        raise ValueError("wq and wo split their heads differently over tp")
    attention = functools.partial(_attention_sharded, config=config,
                                  ctx=ctx, heads_tp=heads_tp)
    x = _attn_sublayer(x, w, positions, config, attention=attention,
                       **_tp_hooks(ctx, heads_tp))
    return _mlp_sublayer(x, w, config,
                         **_tp_hooks(ctx, ctx.on_tp(placements["w_gate"], 1)))


def _tp_hooks(ctx, split: bool):
    """The sublayers' tp collectives where their products split over tp."""
    return {"tp_copy": ctx.tp_copy, "tp_sum": ctx.tp_sum} if split else {}


def _attention_sharded(q, k, v, causal: bool = True, *,
                       config: LlamaConfig, ctx, heads_tp: bool):
    """Attention of this rank's q/k/v blocks [B_loc,S_loc,H_loc,D] over the
    whole sequence: the blocks as DTensors (batch, seq, heads over tp when
    the projections split them), through the ring over sp or the sharded
    flash attention, the result back as this rank's block."""
    from torch.distributed.tensor import DTensor, Shard

    pl = ctx.placements(("batch", "seq", None, None))
    if heads_tp:
        pl = tuple(Shard(2) if n == "tp" else p
                   for n, p in zip(ctx.names, pl))
    q, k, v = (DTensor.from_local(t, ctx.mesh, pl, run_check=False)
               for t in (q, k, v))
    if config.use_ring_attention and ctx.sizes.get("sp", 1) > 1:
        from ray_tpu_torch.parallel.ring_attention import (
            ring_attention_sharded)

        out = ring_attention_sharded(q, k, v, ctx.mesh, causal=causal)
    else:
        out = flash_attention_sharded(q, k, v, ctx.mesh, causal=causal)
    return out.to_local()


def _embed_sharded(table, tokens, ctx, vocab_tp: bool):
    """Rows of the table's local block [V_loc, D] for the tokens; with the
    vocab split over tp, each rank looks up the tokens in its range and the
    tp sum assembles them (a vocab-parallel embedding)."""
    if not vocab_tp:
        return table[tokens]
    v_loc = table.shape[0]
    idx = tokens - ctx.coord["tp"] * v_loc
    inside = (idx >= 0) & (idx < v_loc)
    rows = table[idx.clamp(0, v_loc - 1)]
    return ctx.tp_sum(torch.where(inside[..., None], rows, 0))


def _embed_local(params, tokens, config, ctx):
    """This rank's token block [B_loc,S_loc] embedded (vocab-parallel where
    the table's vocab splits over tp), and the tokens' global positions."""
    tokens = ctx.local(tokens)
    b, s = tokens.shape
    start = ctx.block_start("seq", s)
    positions = torch.arange(start, start + s,
                             device=tokens.device).expand(b, s)
    table = params["embed"]
    x = _embed_sharded(ctx.gather(ctx.local(table), table.placements),
                       tokens, ctx, ctx.on_tp(table.placements, 0))
    return x.to(config.dtype), positions


def layers_local(stacked, n: int, ctx):
    """DTensor parameters stacked on a leading L axis (nested
    dictionaries) -> the n per-layer dictionaries of this rank's blocks,
    and the placements of one layer's slice of each."""
    from ray_tpu_torch.train.optim import tree_map

    placements = tree_map(lambda w: _layer_placements(w.placements), stacked)
    return unbind_layers(tree_map(ctx.local, stacked), n), placements


def _norm_local(x, weight, eps, ctx):
    """RMSNorm by a (replicated or gathered) DTensor weight."""
    return _rms_norm(x, ctx.gather(ctx.local(weight), weight.placements),
                     eps)


def _forward_hidden_sharded(params, tokens, config: LlamaConfig, ctx):
    """This rank's block of the final-norm hidden states [B_loc,S_loc,D]."""
    c = config
    x, positions = _embed_local(params, tokens, c, ctx)
    layers, placements = layers_local(params["layers"], c.n_layers, ctx)
    call = layer_caller(c)
    for lp in layers:
        x = call(_layer_sharded, x, lp, positions, c, ctx, placements)
    return _norm_local(x, params["final_norm"], c.norm_eps, ctx)


def vocab_parallel_nll(logits, targets, ctx):
    """Per-token NLL from each rank's fp32 logits of its vocab block [...,
    V_loc] (the vocab split over tp): the row max, the sum of exponentials
    and the target's logit assembled over tp."""
    import torch.distributed as dist

    v_loc = logits.shape[-1]
    m = logits.detach().amax(-1, keepdim=True)
    dist.all_reduce(m, op=dist.ReduceOp.MAX, group=ctx.mesh.get_group("tp"))
    sumexp = ctx.tp_sum(torch.exp(logits - m).sum(-1))
    idx = targets.long() - ctx.coord["tp"] * v_loc
    inside = (idx >= 0) & (idx < v_loc)
    picked = logits.gather(-1, idx.clamp(0, v_loc - 1)[..., None])[..., 0]
    target = ctx.tp_sum(torch.where(inside, picked, 0.0))
    return torch.log(sumexp) + m[..., 0] - target


def _chunk_nll_vocab_parallel(h, lm_head, targets, mask, ctx):
    """`_chunk_nll` with lm_head's vocab split over tp."""
    nll = vocab_parallel_nll((h @ lm_head).float(), targets, ctx)
    return torch.sum(nll * mask)


def ce_sharded(hidden, lm_dt, targets, mask, chunk: int, ctx):
    """The global masked mean next-token NLL of hidden [B_loc,S_loc,D]
    through the DTensor lm_head [D, V] (vocab-parallel where its vocab
    splits over tp), from each rank's tokens: `chunked_ce` of the rank's
    block over the global mask count, summed over the data dims."""
    lm = ctx.gather(ctx.local(lm_dt), lm_dt.placements)
    vocab_tp = ctx.on_tp(lm_dt.placements, 1)
    if vocab_tp:
        hidden = ctx.tp_copy(hidden)
    nll = (functools.partial(_chunk_nll_vocab_parallel, ctx=ctx) if vocab_tp
           else _chunk_nll)
    return ctx.data_sum(chunked_ce(hidden, lm, targets, mask, chunk,
                                   nll=nll, count_sum=ctx.data_sum))


def loss_inputs_local(batch, ctx):
    """(inputs, targets, mask) of a DTensor batch, as this rank's blocks."""
    return tuple(ctx.local(t) if t is not None else None
                 for t in _loss_inputs(batch))


def _loss_sharded(params, batch, config: LlamaConfig, ctx):
    """The global mean NLL from each rank's tokens."""
    inputs, targets, mask = loss_inputs_local(batch, ctx)
    hidden = _forward_hidden_sharded(params, inputs, config, ctx)
    return ce_sharded(hidden, params["lm_head"], targets, mask,
                      config.loss_chunk_size, ctx)


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


def _kv_major(cache):
    """[B,T,kv,K] cache -> [kv*B, T, K], the layout one batched matrix
    product takes. The cache's (B, kv) strides cannot fold into one batch
    stride, so this is one copy, in the cache's own dtype."""
    b, t, g, d = cache.shape
    return cache.permute(2, 0, 1, 3).reshape(g * b, t, d)


def _bmm_f32(a, b):
    """a @ b over a batch with an fp32 result. On the card bf16 operands
    are read as they are and cuBLAS accumulates in fp32 (bmm's out_dtype
    overload, as preferred_element_type=float32 asks in the JAX package);
    elsewhere, and for fp32 operands, both go through fp32 (the CPU has no
    kernel for that overload), which computes the same products."""
    if a.is_cuda and a.dtype != torch.float32:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def _attend(q, k, v, visible, config: LlamaConfig, self_kv=None):
    """Grouped-query attention of q [B,S,H,K] over kv-major k/v [kv*B,T,K]
    (`_kv_major`): no repeat of the KV heads and no fp32 copy of k or v;
    scores, softmax and the output accumulate in fp32. visible [B,S,T] is
    the mask. self_kv=(k_new, v_new), each [B,kv,K] (S=1), adds the
    current token's own key as one more visible column (decode)."""
    c = config
    b, s, h, d = q.shape
    g, rep, t = c.n_kv_heads, c.n_heads // c.n_kv_heads, k.shape[1]
    qg = q.reshape(b, s, g, rep, d).permute(2, 0, 3, 1, 4)  # [g,b,r,s,K]
    scores = _bmm_f32(qg.reshape(g * b, rep * s, d), k.transpose(1, 2))
    scores = scores.view(g, b, rep, s, t) / (d ** 0.5)
    scores = torch.where(visible[None, :, None], scores, NEG_INF)
    if self_kv is not None:
        k_new, v_new = (x.permute(1, 0, 2)[:, :, None, None].float()
                        for x in self_kv)  # [g,b,1,1,K]
        self_score = (qg.float() * k_new).sum(-1, keepdim=True) / (d ** 0.5)
        scores = torch.cat([scores, self_score], dim=-1)
    probs = torch.softmax(scores, dim=-1)
    out = _bmm_f32(probs[..., :t].to(v.dtype).reshape(g * b, rep * s, t), v)
    out = out.view(g, b, rep, s, d)
    if self_kv is not None:
        out = out + probs[..., t:] * v_new
    return out.permute(1, 3, 0, 2, 4).reshape(b, s, h, d).to(q.dtype)


def _cached_attention(q, k_cache, v_cache, lengths, config: LlamaConfig):
    """q: [B,S,H,K] new queries at positions lengths..lengths+S;
    k/v_cache: [B,T,kv,K] full cache (already containing the new keys).
    Masks out cache positions >= lengths+S and enforces causality within
    the new block. Grouped-query aware, products accumulate in fp32 from
    the cache as it is stored (`_attend`)."""
    s, t = q.shape[1], k_cache.shape[1]
    return _attend(q, _kv_major(k_cache), _kv_major(v_cache),
                   _causal_visible(lengths, s, t), config)


def _causal_visible(lengths, s, t):
    """[B,S,T]: key j is visible to query i (at lengths+i) iff j <= it."""
    dev = lengths.device
    q_pos = lengths[:, None, None] + torch.arange(s, device=dev)[None, :, None]
    return torch.arange(t, device=dev)[None, None, :] <= q_pos


def _decode_attention(q, k_new, v_new, k_cache, v_cache, lengths,
                      config: LlamaConfig):
    """Single-token attention where the current token's K/V is NOT yet in
    the cache: q/k_new/v_new [B,1,H|kv,K], k/v_cache [B,T,kv,K] holding
    positions 0..lengths-1. The self-attention term is computed directly
    from k_new/v_new, so the cache takes one scatter per decode step
    (forward_with_cache) instead of one per layer."""
    return _attend(q, _kv_major(k_cache), _kv_major(v_cache),
                   _prefix_visible(lengths, k_cache.shape[1]), config,
                   self_kv=(k_new[:, 0], v_new[:, 0]))


def _prefix_visible(lengths, t):
    """[B,1,T]: the cache positions below each row's length."""
    return (torch.arange(t, device=lengths.device)[None, None, :]
            < lengths[:, None, None])


def _cached_attention_plain(q, k_cache, v_cache, lengths,
                            config: LlamaConfig):
    """Plain version of `_cached_attention`: the cache copied to fp32 and
    contracted by einsum. The card check holds the repaired path to it."""
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


def _decode_attention_plain(q, k_new, v_new, k_cache, v_cache, lengths,
                            config: LlamaConfig):
    """Plain version of `_decode_attention`, the cache copied to fp32."""
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
                          k_cache, v_cache, tp_sum=None):
    """Decode-step (S=1) attention block: attends over the cache plus the
    new token's own K/V, returning (x, (k, v)) with the new K/V for the
    deferred cache scatter in forward_with_cache."""
    c = config
    q, k, v = _qkv(x, params, positions, c)
    attn = _decode_attention(q, k, v, k_cache, v_cache, positions[:, 0], c)
    x = x + _proj_out(attn, params["wo"], tp_sum)
    return x, (k.to(k_cache.dtype), v.to(v_cache.dtype))


def forward_with_cache(params, tokens, cache, lengths, config: LlamaConfig,
                       tp_sum=None):
    """Incremental forward for generation (prefill when S>1, decode at S=1).

    tokens: [B, S] the NEW tokens, logically at positions lengths..lengths+S.
    cache:  dict from init_kv_cache, updated IN PLACE (the JAX package
            donates it and returns the new one; this returns the same dict).
    lengths: [B] integer — number of tokens already in the cache per row.
    tp_sum: for a tensor-parallel engine (params this rank's tp blocks,
            config its head counts, the cache its KV heads), the sum over
            the tp ranks that ends each row-parallel product.
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
                x, lp, positions, c, cache["k"][i], cache["v"][i], tp_sum)
            x = _mlp_sublayer(x, lp, c, tp_sum=tp_sum)
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
                               lengths=lengths, tp_sum=tp_sum)
            x = _mlp_sublayer(x, lp, c, tp_sum=tp_sum)
    x = _rms_norm(x, params["final_norm"], c.norm_eps)
    return (x @ params["lm_head"]).float(), cache


def init_paged_kv_cache(config: LlamaConfig, n_blocks: int,
                        block_size: int, dtype: Optional[torch.dtype] = None,
                        device=None) -> Dict[str, torch.Tensor]:
    """Block-pool KV cache (PagedAttention layout): tensors [n_layers,
    n_blocks, block_size, n_kv_heads, d_head]. Sequences map logical
    positions onto blocks through a block table, so memory is budgeted by
    the tokens in flight instead of batch x max_len. Block 0 is scratch:
    masked writes land there and padding entries of a block table point at
    it. Zero-filled: masked positions enter P.V with P = 0, and 0 times a
    NaN left in uninitialised memory would be NaN."""
    c = config
    dev = resolve_device(device)
    shape = (c.n_layers, n_blocks, block_size, c.n_kv_heads, c.d_head)
    dtype = dtype or c.dtype
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


def _gather_kv_major(pool, block_table):
    """One layer's pool [n_blocks, bs, kv, K] through block_table [B, nb]
    -> [kv*B, nb*bs, K]: logical position t of row b lands at index t, in
    the layout `_attend` takes, by one gather (the JAX package's per-layer
    take, written straight into that layout)."""
    _, bs, g, d = pool.shape
    b, nb = block_table.shape
    rows = pool.permute(2, 0, 1, 3).index_select(1, block_table.reshape(-1))
    return rows.reshape(g * b, nb * bs, d)


def _flat_slots(block_table, positions, block_size, valid):
    """Pool row (block * block_size + offset) of each logical position, 0
    (the scratch block) where `valid` is False. A padded position past the
    table is clamped before the lookup; it is invalid, so it goes to 0."""
    nb = block_table.shape[1]
    blk = torch.gather(block_table, 1,
                       (positions // block_size).clamp(max=nb - 1))
    return torch.where(valid, blk * block_size + positions % block_size, 0)


def _attn_sublayer_paged(x, params, positions, config: LlamaConfig,
                         k_pool, v_pool, block_table, lengths, valid,
                         tp_sum=None):
    """Prefill attention over a paged pool for ONE layer: the new K/V go
    into the pool in place (invalid rows to the scratch block; duplicate
    targets there are harmless, block 0 is never read at a live position),
    then the queries attend over the per-layer gather of the table."""
    c = config
    q, k, v = _qkv(x, params, positions, c)
    n_blocks, bs, kvh, d = k_pool.shape
    flat = _flat_slots(block_table, positions, bs, valid).reshape(-1)
    for pool, new in ((k_pool, k), (v_pool, v)):
        pool.view(n_blocks * bs, kvh, d)[flat] = new.reshape(
            -1, kvh, d).to(pool.dtype)
    s, t = positions.shape[1], block_table.shape[1] * bs
    attn = _attend(q, _gather_kv_major(k_pool, block_table),
                   _gather_kv_major(v_pool, block_table),
                   _causal_visible(lengths, s, t), c)
    return x + _proj_out(attn, params["wo"], tp_sum)


def _attn_sublayer_paged_decode(x, params, positions, config: LlamaConfig,
                                k_pool, v_pool, block_table, tp_sum=None):
    """Decode-step (S=1) paged attention: reads each row's positions below
    its length from the pool (READ-ONLY here), adds the new token's own
    term directly, and returns the new K/V for the single deferred pool
    scatter in forward_with_paged_cache."""
    c = config
    q, k, v = _qkv(x, params, positions, c)
    k, v = k.to(k_pool.dtype), v.to(v_pool.dtype)
    t = block_table.shape[1] * k_pool.shape[1]
    attn = _attend(q, _gather_kv_major(k_pool, block_table),
                   _gather_kv_major(v_pool, block_table),
                   _prefix_visible(positions[:, 0], t), c,
                   self_kv=(k[:, 0], v[:, 0]))
    return (x + _proj_out(attn, params["wo"], tp_sum),
            (k[:, 0], v[:, 0]))


def forward_with_paged_cache(params, tokens, pool, block_table, lengths,
                             config: LlamaConfig, valid=None, tp_sum=None):
    """forward_with_cache over a paged pool (see init_paged_kv_cache).

    tokens: [B, S] new tokens at positions lengths..lengths+S; block_table
    [B, max_blocks] integer; valid: optional [B, S] bool for padded prefill
    tails (invalid positions write to the scratch block and are masked
    from attention by `lengths`). The pool is updated IN PLACE (the JAX
    package donates it and returns a new one); this returns the same dict.
    Tensor-parallel serving passes one tp rank's blocks (heads and MLP
    hidden units split, `config` with this rank's head counts, the pool's
    KV heads split) and tp_sum, the sum over the tp ranks that ends each
    row-parallel product. -> (logits [B, S, vocab] fp32, pool)"""
    c = config
    b, s = tokens.shape
    positions = lengths[:, None] + torch.arange(s, device=tokens.device)[None]
    if valid is None:
        valid = torch.ones((b, s), dtype=torch.bool, device=tokens.device)
    x = params["embed"][tokens].to(c.dtype)
    if s == 1:
        # The layers only READ the pool, so none sees this step's K/V in
        # it; every layer's new K/V lands with one scatter after the loop.
        k_new, v_new = [], []
        for i in range(c.n_layers):
            lp = _layer_params(params, i)
            x, (k1, v1) = _attn_sublayer_paged_decode(
                x, lp, positions, c, pool["k"][i], pool["v"][i], block_table,
                tp_sum)
            x = _mlp_sublayer(x, lp, c, tp_sum=tp_sum)
            k_new.append(k1)
            v_new.append(v1)
        n_layers, n_blocks, bs = pool["k"].shape[:3]
        flat = _flat_slots(block_table, positions, bs, valid)[:, 0]
        for name, rows in (("k", k_new), ("v", v_new)):
            pool[name].view(n_layers, n_blocks * bs,
                            *pool[name].shape[3:])[:, flat] = torch.stack(rows)
    else:
        for i in range(c.n_layers):
            lp = _layer_params(params, i)
            x = _attn_sublayer_paged(x, lp, positions, c, pool["k"][i],
                                     pool["v"][i], block_table, lengths,
                                     valid, tp_sum)
            x = _mlp_sublayer(x, lp, c, tp_sum=tp_sum)
    x = _rms_norm(x, params["final_norm"], c.norm_eps)
    return (x @ params["lm_head"]).float(), pool


def flops_per_token(config: LlamaConfig, seq_len: int) -> float:
    """Approx training FLOPs/token (fwd+bwd ≈ 6N + attention term)."""
    c = config
    param_flops = 6.0 * c.num_params()
    # Causal attention: QK^T + PV = 2 matmuls × 2 flops × H·D × S/2 (causal
    # average) × 3 (fwd+bwd) = 6·H·D·S per layer per token.
    attn_flops = 6.0 * c.n_layers * c.n_heads * c.d_head * seq_len
    return param_flops + attn_flops
