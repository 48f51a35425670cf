"""Vision Transformer (encoder) in PyTorch.

Counterpart of `ray_tpu/models/vit.py`: patch embeddings of channels-last
[B, H, W, C] images with a CLS token and learned positions, pre-norm
bidirectional attention (plain PyTorch: the JAX package computes it in
plain `jnp`, with no Pallas kernel), a tanh-approximated GELU MLP, and the
classifier on the CLS row. Layers stacked on a leading L axis, each
checkpointed under `llama._remat_context` when training. The casts sit
where the JAX package puts them: scores in the compute dtype, softmax in
fp32, logits fp32.

With `mesh=`, `forward` and `loss_fn` take DTensor parameters in the
shardings of `param_logical_axes` and a DTensor batch split on its batch
dim, and compute on each rank's blocks (`parallel.sharding.
ShardingContext`, as Llama's sharded path does): a parameter is gathered
over the data dims before its use, the attention heads and the MLP's
hidden units take their tp split (`tp_copy` before the column-parallel
products, `tp_sum` after the row-parallel ones), the classifier is
vocab-parallel over tp, and the loss sums each rank's share over the data
dims. The JAX function leaves all of this to GSPMD, which shards from the
parameters' shardings alone.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch
import torch.nn.functional as F

from ray_tpu_torch.models import llama
from ray_tpu_torch.models.llama import _maybe, _proj_heads, _proj_out
from ray_tpu_torch.parallel.sharding import ShardingContext


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 16
    num_channels: int = 3
    d_model: int = 768
    n_layers: int = 12
    n_heads: int = 12
    d_ff: int = 3072
    num_classes: int = 1000
    norm_eps: float = 1e-6
    dtype: torch.dtype = torch.bfloat16
    remat: bool = True
    remat_policy: str = "dots"

    @property
    def n_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def d_head(self) -> int:
        return self.d_model // self.n_heads

    @staticmethod
    def tiny() -> "ViTConfig":
        return ViTConfig(image_size=32, patch_size=8, d_model=64, n_layers=2,
                         n_heads=4, d_ff=128, num_classes=10,
                         dtype=torch.float32, remat=False)

    @staticmethod
    def base_16() -> "ViTConfig":
        return ViTConfig()  # ViT-B/16

    def num_params(self) -> int:
        patch_dim = self.patch_size ** 2 * self.num_channels
        per_layer = (4 * self.d_model * self.d_model
                     + 2 * self.d_model * self.d_ff
                     + 5 * self.d_model + self.d_ff)  # 4 LN vecs + b1 + b2
        return (patch_dim * self.d_model + self.d_model  # patch proj
                + (self.n_patches + 1) * self.d_model    # pos emb (+cls)
                + self.d_model                           # cls token
                + self.n_layers * per_layer
                + 2 * self.d_model
                + self.d_model * self.num_classes + self.num_classes)


def param_shapes(config: ViTConfig) -> Dict[str, Any]:
    """Shape of every parameter, in the JAX pytree's structure and layout."""
    c = config
    d, h, k, f, L = c.d_model, c.n_heads, c.d_head, c.d_ff, c.n_layers
    return {
        "patch_proj": (c.patch_size ** 2 * c.num_channels, d),
        "patch_bias": (d,),
        "pos_embed": (c.n_patches + 1, d),
        "cls_token": (d,),
        "layers": {
            "ln1_scale": (L, d), "ln1_bias": (L, d),
            "wq": (L, d, h, k), "wk": (L, d, h, k), "wv": (L, d, h, k),
            "wo": (L, h, k, d),
            "ln2_scale": (L, d), "ln2_bias": (L, d),
            "w1": (L, d, f), "b1": (L, f),
            "w2": (L, f, d), "b2": (L, d),
        },
        "final_ln_scale": (d,), "final_ln_bias": (d,),
        "head_w": (d, c.num_classes), "head_b": (c.num_classes,),
    }


def param_logical_axes(config: ViTConfig) -> Dict[str, Any]:
    """Logical axis names per parameter (layers stacked on 'layers'; no rule
    names 'patch', so the patch dim stays whole)."""
    L = ("layers",)
    return {
        "patch_proj": ("patch", "embed"),
        "patch_bias": ("embed",),
        "pos_embed": (None, "embed"),
        "cls_token": ("embed",),
        "layers": {
            "ln1_scale": L + (None,), "ln1_bias": L + (None,),
            "wq": L + ("embed", "heads", "kv"),
            "wk": L + ("embed", "heads", "kv"),
            "wv": L + ("embed", "heads", "kv"),
            "wo": L + ("heads", "kv", "embed"),
            "ln2_scale": L + (None,), "ln2_bias": L + (None,),
            "w1": L + ("embed", "mlp"), "b1": L + ("mlp",),
            "w2": L + ("mlp", "embed"), "b2": L + (None,),
        },
        "final_ln_scale": (None,), "final_ln_bias": (None,),
        "head_w": ("embed", "vocab"), "head_b": ("vocab",),
    }


def init(config: ViTConfig, generator: torch.Generator,
         device=None) -> Dict[str, Any]:
    """Random parameters with the JAX `init`'s scales: products normal *
    fan_in ** -0.5, positions and the CLS token normal * 0.02, biases at
    zero, LayerNorm scales at one. `generator` lives on `device`."""
    c = config
    fan_in = {"patch_proj": c.patch_size ** 2 * c.num_channels,
              "wq": c.d_model, "wk": c.d_model, "wv": c.d_model,
              "wo": c.d_model, "w1": c.d_model, "w2": c.d_ff,
              "head_w": c.d_model}

    def std(name, shape):
        if name.endswith("scale"):
            return None
        if name.endswith("bias") or name in ("b1", "b2", "head_b"):
            return 0
        if name in ("pos_embed", "cls_token"):
            return 0.02
        return fan_in[name] ** -0.5

    return llama.random_params(param_shapes(c), std, generator, c.dtype,
                               device)


def _ln(x, scale, bias, eps):
    """LayerNorm with the biased variance, as `jnp.var` computes it."""
    return F.layer_norm(x, x.shape[-1:], scale, bias, eps)


def patchify(images, config: ViTConfig):
    """[B, H, W, C] -> [B, N, patch_dim] with one reshape/transpose chain."""
    c = config
    b, hh, ww, ch = images.shape
    p = c.patch_size
    x = images.reshape(b, hh // p, p, ww // p, p, ch)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, (hh // p) * (ww // p), p * p * ch)


def _layer(x, p, config: ViTConfig, attn_tp=(None, None),
           mlp_tp=(None, None)):
    """One encoder layer. attn_tp and mlp_tp: (tp_copy, tp_sum) where the
    heads or the hidden units hold this rank's tp split."""
    c = config
    copy, total = attn_tp
    h = _maybe(copy, _ln(x, p["ln1_scale"], p["ln1_bias"], c.norm_eps))
    q, k, v = (_proj_heads(h, p[w]) for w in ("wq", "wk", "wv"))
    scores = torch.einsum("bnhk,bmhk->bhnm", q, k) / (c.d_head ** 0.5)
    attn = torch.softmax(scores.float(), dim=-1)
    out = torch.einsum("bhnm,bmhk->bnhk", attn.to(v.dtype), v)
    x = x + _maybe(total, _proj_out(out, p["wo"]))
    copy, total = mlp_tp
    h = _maybe(copy, _ln(x, p["ln2_scale"], p["ln2_bias"], c.norm_eps))
    ff = _maybe(total, F.gelu(h @ p["w1"] + p["b1"], approximate="tanh")
                @ p["w2"]) + p["b2"]
    return x + ff


def forward(params, images, config: ViTConfig, mesh=None, rules=None):
    """images [B,H,W,C] float -> logits [B, num_classes] fp32; with a mesh,
    a DTensor (batch, act_vocab)."""
    if mesh is not None:
        ctx = _context(mesh, rules)
        logits, vocab_tp = _logits_sharded(params, images, config, ctx)
        return llama._as_dtensor(logits, ctx, (
            "batch", "act_vocab" if vocab_tp else None))
    c = config
    x = patchify(images.to(c.dtype), c) @ params["patch_proj"]
    x = x + params["patch_bias"]
    b = x.shape[0]
    cls = params["cls_token"].expand(b, 1, c.d_model)
    x = torch.cat([cls, x], dim=1) + params["pos_embed"]
    call = llama.layer_caller(c)
    for lp in llama.unbind_layers(params["layers"], c.n_layers):
        x = call(_layer, x, lp, c)
    x = _ln(x, params["final_ln_scale"], params["final_ln_bias"], c.norm_eps)
    logits = x[:, 0] @ params["head_w"] + params["head_b"]
    return logits.float()


def loss_fn(params, batch, config: ViTConfig, mesh=None, rules=None):
    """Softmax cross-entropy classification loss. batch: {"images",
    "labels"}. With a mesh, params and batch are DTensors and the loss, the
    mean over the global batch, is on every rank."""
    if mesh is not None:
        ctx = _context(mesh, rules)
        logits, vocab_tp = _logits_sharded(params, batch["images"], config,
                                           ctx)
        labels = ctx.local(batch["labels"])
        if vocab_tp:
            nll = llama.vocab_parallel_nll(logits, labels, ctx)
        else:
            logp = torch.log_softmax(logits, dim=-1)
            nll = -logp.gather(-1, labels[:, None].long())[:, 0]
        return ctx.data_sum(nll.sum() / batch["labels"].shape[0])
    logits = forward(params, batch["images"], config)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, batch["labels"][:, None].long())[:, 0]
    return torch.mean(nll)


# -- the sharded path ----------------------------------------------------------

def _context(mesh, rules):
    """The images split on their batch dim only: sp ranks are replicas."""
    return ShardingContext(mesh, rules, data_axes=("batch",))


def _layer_sharded(x, lp, config: ViTConfig, ctx, placements):
    """`_layer` on this rank's blocks, its weights gathered here (inside
    the layer's checkpoint)."""
    w = {n: ctx.gather(t, placements[n]) for n, t in lp.items()}
    return _layer(x, w, config, ctx.tp_pair(placements["wq"]),
                  ctx.tp_pair(placements["w1"]))


def _logits_sharded(params, images, config: ViTConfig, ctx):
    """This rank's fp32 logits [B_loc, C or C/tp], and whether the classes
    split over tp."""
    c = config

    def whole(name):
        w = params[name]
        return ctx.gather(ctx.local(w), w.placements)

    x = patchify(ctx.local(images).to(c.dtype), c) @ whole("patch_proj")
    x = x + whole("patch_bias")
    b = x.shape[0]
    cls = whole("cls_token").expand(b, 1, c.d_model)
    x = torch.cat([cls, x], dim=1) + whole("pos_embed")
    layers, placements = llama.layers_local(params["layers"], c.n_layers,
                                            ctx)
    call = llama.layer_caller(c)
    for lp in layers:
        x = call(_layer_sharded, x, lp, c, ctx, placements)
    x = _ln(x, whole("final_ln_scale"), whole("final_ln_bias"), c.norm_eps)
    vocab_tp = ctx.on_tp(params["head_w"].placements, 1)
    cls_row = ctx.tp_copy(x[:, 0]) if vocab_tp else x[:, 0]
    logits = cls_row @ whole("head_w") + whole("head_b")
    return logits.float(), vocab_tp
