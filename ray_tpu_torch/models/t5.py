"""Encoder-decoder transformer (T5-v1.1-style) in PyTorch.

Counterpart of `ray_tpu/models/t5.py`: RMSNorm and gated-GELU (tanh) MLPs,
RoPE in the self-attention stacks and none in the cross-attention, additive
fp32 biases of -1e9 for padding and causality, attention in plain PyTorch
(the JAX package computes it in plain `jnp`, with no Pallas kernel): scores
in the compute dtype, then fp32, then the bias, then the softmax. Encoder
and decoder layers are stacked on leading axes, each checkpointed under
`llama._remat_context` when training. `greedy_decode` reruns the
teacher-forced decoder at every position, as the JAX function does.

With `mesh=`, `forward` and `loss_fn` take DTensor parameters in the
shardings of `param_logical_axes` and a DTensor batch split on its batch
dim, and compute on each rank's blocks as ViT's sharded path does: the
embedding and the cross-entropy vocab-parallel over tp, the attention
heads (self and cross) and the MLP's hidden units on their tp split, the
loss's sums over the data dims. The JAX function leaves this to GSPMD.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch
import torch.nn.functional as F

from ray_tpu_torch.models import llama
from ray_tpu_torch.models.llama import (_maybe, _proj_heads, _proj_out,
                                        _rms_norm, _rope)
from ray_tpu_torch.parallel.sharding import ShardingContext

NEG_BIAS = -1e9


@dataclasses.dataclass(frozen=True)
class T5Config:
    vocab_size: int = 32_128
    d_model: int = 768
    n_enc_layers: int = 12
    n_dec_layers: int = 12
    n_heads: int = 12
    d_ff: int = 2048
    norm_eps: float = 1e-6
    rope_theta: float = 10_000.0
    pad_id: int = 0
    dtype: torch.dtype = torch.bfloat16
    remat: bool = True
    remat_policy: str = "dots"

    @property
    def d_head(self) -> int:
        return self.d_model // self.n_heads

    @staticmethod
    def tiny(vocab_size: int = 512) -> "T5Config":
        return T5Config(vocab_size=vocab_size, d_model=64, n_enc_layers=2,
                        n_dec_layers=2, n_heads=4, d_ff=128,
                        dtype=torch.float32, remat=False)

    @staticmethod
    def base() -> "T5Config":
        return T5Config()  # t5-v1.1-base shapes

    def num_params(self) -> int:
        d, f = self.d_model, self.d_ff
        attn = 4 * d * d
        mlp = 3 * d * f  # gated
        enc = self.n_enc_layers * (attn + mlp + 2 * d)
        dec = self.n_dec_layers * (2 * attn + mlp + 3 * d)
        return (self.vocab_size * d * 2  # embed + head
                + enc + dec + 2 * d)


def param_shapes(config: T5Config) -> Dict[str, Any]:
    """Shape of every parameter, in the JAX pytree's structure and layout:
    wq/wk/wv [L, D, H, Dh], wo [L, H, Dh, D]."""
    c = config
    d, h, k, f = c.d_model, c.n_heads, c.d_head, c.d_ff

    def attn(n, prefix=""):
        return {f"{prefix}wq": (n, d, h, k), f"{prefix}wk": (n, d, h, k),
                f"{prefix}wv": (n, d, h, k), f"{prefix}wo": (n, h, k, d)}

    def mlp(n):
        return {"w_gate": (n, d, f), "w_up": (n, d, f), "w_down": (n, f, d)}

    ne, nd = c.n_enc_layers, c.n_dec_layers
    return {
        "embed": (c.vocab_size, d),
        "enc_layers": {"ln1": (ne, d), **attn(ne), "ln2": (ne, d),
                       **mlp(ne)},
        "dec_layers": {"ln1": (nd, d), **attn(nd, "self_"), "ln2": (nd, d),
                       **attn(nd, "cross_"), "ln3": (nd, d), **mlp(nd)},
        "enc_final_ln": (d,),
        "dec_final_ln": (d,),
        "lm_head": (d, c.vocab_size),
    }


def param_logical_axes(config: T5Config) -> Dict[str, Any]:
    """Logical axis names per parameter; no rule names 'enc_layers' or
    'dec_layers', so the stacked layer dims stay whole."""
    E, D = ("enc_layers",), ("dec_layers",)

    def attn(L, prefix=""):
        return {f"{prefix}wq": L + ("embed", "heads", "kv"),
                f"{prefix}wk": L + ("embed", "heads", "kv"),
                f"{prefix}wv": L + ("embed", "heads", "kv"),
                f"{prefix}wo": L + ("heads", "kv", "embed")}

    def mlp(L):
        return {"w_gate": L + ("embed", "mlp"), "w_up": L + ("embed", "mlp"),
                "w_down": L + ("mlp", "embed")}

    return {
        "embed": ("vocab", "embed"),
        "enc_layers": {"ln1": E + (None,), **attn(E), "ln2": E + (None,),
                       **mlp(E)},
        "dec_layers": {"ln1": D + (None,), **attn(D, "self_"),
                       "ln2": D + (None,), **attn(D, "cross_"),
                       "ln3": D + (None,), **mlp(D)},
        "enc_final_ln": (None,),
        "dec_final_ln": (None,),
        "lm_head": ("embed", "vocab"),
    }


def init(config: T5Config, generator: torch.Generator,
         device=None) -> Dict[str, Any]:
    """Random parameters with the JAX `init`'s scales (normal * fan_in **
    -0.5, norms at one). `generator` lives on `device`."""
    c = config
    fan_in = {"wq": c.d_model, "wk": c.d_model, "wv": c.d_model,
              "wo": c.d_model, "w_gate": c.d_model, "w_up": c.d_model,
              "w_down": c.d_ff, "embed": c.d_model, "lm_head": c.d_model}

    def std(name, shape):
        if "ln" in name:
            return None
        return fan_in[name.split("_", 1)[1] if name.startswith(
            ("self_", "cross_")) else name] ** -0.5

    return llama.random_params(param_shapes(c), std, generator, c.dtype,
                               device)


def _attend(q, k, v, bias, wo, config: T5Config):
    scores = torch.einsum("bnhk,bmhk->bhnm", q, k) / (config.d_head ** 0.5)
    attn = torch.softmax(scores.float() + bias, dim=-1).to(v.dtype)
    out = torch.einsum("bhnm,bmhk->bnhk", attn, v)
    return _proj_out(out, wo)


def _gated_mlp(x, p):
    gate = F.gelu(x @ p["w_gate"], approximate="tanh")
    return (gate * (x @ p["w_up"])) @ p["w_down"]


def _pad_bias(mask):
    """[B, M] keep-mask -> additive fp32 [B, 1, 1, M] bias."""
    bias = torch.where(mask, 0.0, NEG_BIAS).to(torch.float32)
    return bias[:, None, None, :]


def _stack(layer_fn, x, layers, n, config: T5Config, *args):
    """x through the n stacked layers, each checkpointed when training."""
    call = llama.layer_caller(config)
    for lp in llama.unbind_layers(layers, n):
        x = call(layer_fn, x, lp, *args)
    return x


_NO_TP = (None, None)


def _enc_layer(x, p, positions, bias, c: T5Config, attn_tp=_NO_TP,
               mlp_tp=_NO_TP):
    """attn_tp, mlp_tp: (tp_copy, tp_sum) where the heads or the hidden
    units hold this rank's tp split."""
    copy, total = attn_tp
    h = _maybe(copy, _rms_norm(x, p["ln1"], c.norm_eps))
    q = _rope(_proj_heads(h, p["wq"]), positions, c.rope_theta)
    k = _rope(_proj_heads(h, p["wk"]), positions, c.rope_theta)
    x = x + _maybe(total, _attend(q, k, _proj_heads(h, p["wv"]), bias,
                                  p["wo"], c))
    copy, total = mlp_tp
    h = _maybe(copy, _rms_norm(x, p["ln2"], c.norm_eps))
    return x + _maybe(total, _gated_mlp(h, p))


def _dec_layer(x, p, positions, causal, enc_hidden, cross_bias,
               c: T5Config, self_tp=_NO_TP, cross_tp=_NO_TP, mlp_tp=_NO_TP):
    copy, total = self_tp
    h = _maybe(copy, _rms_norm(x, p["ln1"], c.norm_eps))
    q = _rope(_proj_heads(h, p["self_wq"]), positions, c.rope_theta)
    k = _rope(_proj_heads(h, p["self_wk"]), positions, c.rope_theta)
    x = x + _maybe(total, _attend(q, k, _proj_heads(h, p["self_wv"]),
                                  causal, p["self_wo"], c))
    copy, total = cross_tp
    h = _maybe(copy, _rms_norm(x, p["ln2"], c.norm_eps))
    enc = _maybe(copy, enc_hidden)
    x = x + _maybe(total, _attend(_proj_heads(h, p["cross_wq"]),
                                  _proj_heads(enc, p["cross_wk"]),
                                  _proj_heads(enc, p["cross_wv"]),
                                  cross_bias, p["cross_wo"], c))
    copy, total = mlp_tp
    h = _maybe(copy, _rms_norm(x, p["ln3"], c.norm_eps))
    return x + _maybe(total, _gated_mlp(h, p))


def forward_encoder(params, src_tokens, config: T5Config):
    """src_tokens [B, S] integer -> (enc_hidden [B, S, D], src_mask
    [B, S])."""
    c = config
    mask = src_tokens != c.pad_id
    x = params["embed"].to(c.dtype)[src_tokens]
    # [1, S]: _rope broadcasts it over the batch, as the JAX function does.
    positions = torch.arange(src_tokens.shape[1],
                             device=src_tokens.device)[None, :]
    x = _stack(_enc_layer, x, params["enc_layers"], c.n_enc_layers, c,
               positions, _pad_bias(mask), c)
    return _rms_norm(x, params["enc_final_ln"], c.norm_eps), mask


def _causal_bias(t: int, device):
    tril = torch.tril(torch.ones((t, t), dtype=torch.bool, device=device))
    return torch.where(tril, 0.0, NEG_BIAS).to(torch.float32)[None, None]


def forward_decoder(params, enc_hidden, src_mask, tgt_tokens,
                    config: T5Config):
    """Teacher-forced decoder: tgt_tokens [B, T] -> logits [B, T, V]
    fp32."""
    c = config
    t = tgt_tokens.shape[1]
    dev = tgt_tokens.device
    positions = torch.arange(t, device=dev)[None, :]
    x = params["embed"].to(c.dtype)[tgt_tokens]
    x = _stack(_dec_layer, x, params["dec_layers"], c.n_dec_layers, c,
               positions, _causal_bias(t, dev), enc_hidden,
               _pad_bias(src_mask), c)
    x = _rms_norm(x, params["dec_final_ln"], c.norm_eps)
    return (x @ params["lm_head"]).float()


def forward(params, src_tokens, tgt_tokens, config: T5Config, mesh=None,
            rules=None):
    """-> logits [B, T, V] fp32; with a mesh, a DTensor (batch, None,
    act_vocab)."""
    if mesh is not None:
        ctx = _context(mesh, rules)
        x = _hidden_sharded(params, ctx.local(src_tokens),
                            ctx.local(tgt_tokens), config, ctx)
        lm_dt = params["lm_head"]
        vocab_tp = ctx.on_tp(lm_dt.placements, 1)
        logits = (_maybe(ctx.tp_copy if vocab_tp else None, x)
                  @ ctx.gather(ctx.local(lm_dt), lm_dt.placements)).float()
        return llama._as_dtensor(logits, ctx, (
            "batch", None, "act_vocab" if vocab_tp else None))
    enc, src_mask = forward_encoder(params, src_tokens, config)
    return forward_decoder(params, enc, src_mask, tgt_tokens, config)


def loss_fn(params, batch, config: T5Config, mesh=None, rules=None):
    """Seq2seq cross-entropy. batch: {"src" [B,S], "tgt" [B,T]}: tgt[:, :-1]
    feeds the decoder, tgt[:, 1:] are the labels; pad labels masked out.
    With a mesh, params and batch are DTensors and the loss is on every
    rank."""
    if mesh is not None:
        ctx = _context(mesh, rules)
        src, tgt = ctx.local(batch["src"]), ctx.local(batch["tgt"])
        labels = tgt[:, 1:]
        hidden = _hidden_sharded(params, src, tgt[:, :-1], config, ctx)
        return llama.ce_sharded(hidden, params["lm_head"], labels,
                                (labels != config.pad_id).float(), 0, ctx)
    src, tgt = batch["src"], batch["tgt"]
    logits = forward(params, src, tgt[:, :-1], config)
    labels = tgt[:, 1:]
    mask = (labels != config.pad_id).float()
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, labels[..., None].long())[..., 0]
    return torch.sum(nll * mask) / torch.clamp(mask.sum(), min=1.0)


# -- the sharded path ----------------------------------------------------------

def _context(mesh, rules):
    """The batch split on its batch dim only: sp ranks are replicas."""
    return ShardingContext(mesh, rules, data_axes=("batch",))


def _enc_layer_sharded(x, lp, positions, bias, c: T5Config, ctx,
                       placements):
    w = {n: ctx.gather(t, placements[n]) for n, t in lp.items()}
    return _enc_layer(x, w, positions, bias, c, ctx.tp_pair(placements["wq"]),
                      ctx.tp_pair(placements["w_gate"]))


def _dec_layer_sharded(x, lp, positions, causal, enc_hidden, cross_bias,
                       c: T5Config, ctx, placements):
    w = {n: ctx.gather(t, placements[n]) for n, t in lp.items()}
    return _dec_layer(x, w, positions, causal, enc_hidden, cross_bias, c,
                      ctx.tp_pair(placements["self_wq"]),
                      ctx.tp_pair(placements["cross_wq"]),
                      ctx.tp_pair(placements["w_gate"]))


def _hidden_sharded(params, src, tgt, config: T5Config, ctx):
    """This rank's block [B_loc, T, D] of the decoder's final-norm hidden
    states from its blocks of src [B_loc, S] and tgt [B_loc, T]."""
    c = config
    table_dt = params["embed"]
    table = ctx.gather(ctx.local(table_dt), table_dt.placements).to(c.dtype)
    vocab_tp = ctx.on_tp(table_dt.placements, 0)

    def embed(tokens):
        return llama._embed_sharded(table, tokens, ctx, vocab_tp)

    def stack(layer_fn, x, name, n, *args):
        layers, placements = llama.layers_local(params[name], n, ctx)
        call = llama.layer_caller(c)
        for lp in layers:
            x = call(layer_fn, x, lp, *args, c, ctx, placements)
        return x

    mask = src != c.pad_id
    enc = stack(_enc_layer_sharded, embed(src), "enc_layers",
                c.n_enc_layers,
                torch.arange(src.shape[1], device=src.device)[None, :],
                _pad_bias(mask))
    enc = llama._norm_local(enc, params["enc_final_ln"], c.norm_eps, ctx)
    t = tgt.shape[1]
    x = stack(_dec_layer_sharded, embed(tgt), "dec_layers", c.n_dec_layers,
              torch.arange(t, device=tgt.device)[None, :],
              _causal_bias(t, tgt.device), enc, _pad_bias(mask))
    return llama._norm_local(x, params["dec_final_ln"], c.norm_eps, ctx)


@torch.no_grad()
def greedy_decode(params, src_tokens, config: T5Config, max_len: int = 32,
                  bos_id: int = 1, eos_id: int = 2):
    """Batched greedy decoding, the teacher-forced decoder rerun at every
    position (a test and evaluation utility, as in the JAX package). A row
    that has emitted eos gets pad from then on; the loop stops once every
    row has (one host read a step). argmax takes the first maximum, as
    jnp.argmax does. -> [B, max_len] int64, bos first."""
    c = config
    enc, src_mask = forward_encoder(params, src_tokens, c)
    b = src_tokens.shape[0]
    dev = src_tokens.device
    tgt = torch.full((b, max_len), c.pad_id, dtype=torch.int64, device=dev)
    tgt[:, 0] = bos_id
    done = torch.zeros(b, dtype=torch.bool, device=dev)
    for i in range(1, max_len):
        logits = forward_decoder(params, enc, src_mask, tgt, c)
        nxt = logits.argmax(-1)[:, i - 1]
        nxt = torch.where(done, c.pad_id, nxt)
        tgt[:, i] = nxt
        done = done | (nxt == eos_id)
        if bool(done.all()):
            break
    return tgt
