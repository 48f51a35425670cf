"""Mixtral-family sparse-MoE decoder in PyTorch: training and the forward.

Counterpart of `ray_tpu/models/mixtral.py` on one device: the Llama
attention block of `models/llama.py` (the flash-attention kernels on CUDA)
followed by top-k routed SwiGLU experts (`parallel/moe.py`), layers stacked
on a leading L axis, the experts' weights on a second axis E. The experts
of a layer run as three `torch.bmm` over their [E, C, D] token buffers (the
JAX package's `jax.vmap` of one expert's FFN).

Remat follows `llama._remat_context`. Under "dots" the products that are
saved are the un-batched ones (aten.mm: the attention projections and the
fp32 gate logits); the expert products are batched (aten.bmm), so the
backward recomputes them, as JAX's `dots_with_no_batch_dims_saveable`
recomputes the batched expert `dot_general`s; the routing, the dispatch
gather and the combine are recomputed too.

With `mesh=`, `forward` and `loss_fn` take DTensor parameters in the
shardings of `param_logical_axes` and a DTensor batch, and run each rank's
blocks as Llama's sharded path does (`llama._layer_sharded`'s gathers, tp
collectives and sharded flash attention). The MoE block routes the tokens
as the JAX function partitions them: the whole flattened batch [B*S, D]
split over `ep` alone (replicated over the data dims), each shard's
capacity from its T / ep tokens, through `moe_shard_map` when `ep` > 1 and
`moe_layer` on every token otherwise; which tokens share a shard decides
the drops, so the port gathers the tokens and cuts them as JAX does.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict

import torch
import torch.nn.functional as F

from ray_tpu_torch.models import llama
from ray_tpu_torch.models.llama import LlamaConfig, _rms_norm
from ray_tpu_torch.parallel.moe import moe_layer, moe_shard_map
from ray_tpu_torch.parallel.sharding import ShardingContext


@dataclasses.dataclass(frozen=True)
class MixtralConfig(LlamaConfig):
    n_experts: int = 8
    experts_per_token: int = 2
    capacity_factor: float = 1.25
    aux_loss_coef: float = 0.01

    @staticmethod
    def tiny(vocab_size: int = 512) -> "MixtralConfig":
        return MixtralConfig(
            vocab_size=vocab_size, d_model=128, n_layers=2, n_heads=4,
            n_kv_heads=2, d_head=32, d_ff=256, max_seq_len=512,
            n_experts=4, experts_per_token=2,
        )

    def num_params(self) -> int:
        base = super().num_params()
        # the dense FFN count replaced by n_experts routed FFNs and the gate
        dense_ffn = self.n_layers * 3 * self.d_model * self.d_ff
        moe_ffn = self.n_layers * (
            self.n_experts * 3 * self.d_model * self.d_ff
            + self.d_model * self.n_experts)
        return base - dense_ffn + moe_ffn


def param_shapes(config: MixtralConfig) -> Dict[str, Any]:
    """Shape of every parameter, in the JAX pytree's structure and layout:
    Llama's without the dense FFN, plus moe_gate [L, D, E] and experts/w_*
    [L, E, D, F] ([L, E, F, D] for w_down)."""
    c = config
    shapes = llama.param_shapes(c)
    layers = shapes["layers"]
    for name in ("w_gate", "w_up", "w_down"):
        del layers[name]
    L, E, D, F_ = c.n_layers, c.n_experts, c.d_model, c.d_ff
    layers["moe_gate"] = (L, D, E)
    layers["experts"] = {"w_gate": (L, E, D, F_), "w_up": (L, E, D, F_),
                         "w_down": (L, E, F_, D)}
    return shapes


def param_logical_axes(config: MixtralConfig) -> Dict[str, Any]:
    """Logical axis names per parameter: Llama's without the dense FFN,
    the gate's experts and the experts' leading dim on 'expert'."""
    axes = llama.param_logical_axes(config)
    layer_axes = axes["layers"]
    for k in ("w_gate", "w_up", "w_down"):
        layer_axes.pop(k, None)
    L = ("layers",)
    layer_axes["moe_gate"] = L + ("embed", "expert")
    layer_axes["experts"] = {
        "w_gate": L + ("expert", "embed", "mlp"),
        "w_up": L + ("expert", "embed", "mlp"),
        "w_down": L + ("expert", "mlp", "embed"),
    }
    return axes


def init(config: MixtralConfig, generator: torch.Generator,
         device=None) -> Dict[str, Any]:
    """Random parameters with the JAX `init`'s shapes and scales: Llama's
    fan-in scaling, the gate normal * 0.02, the experts normal *
    (2 / (d_model + d_ff)) ** 0.5. `generator` lives on `device`."""
    c = config
    fan_in = {"embed": c.d_model, "wq": c.d_model, "wk": c.d_model,
              "wv": c.d_model, "wo": c.n_heads * c.d_head,
              "lm_head": c.d_model}
    expert_std = (2.0 / (c.d_model + c.d_ff)) ** 0.5

    def std(name, shape):
        if name.endswith("norm"):
            return None
        if name == "moe_gate":
            return 0.02
        if name.startswith("w_"):
            return expert_std
        return fan_in[name] ** -0.5

    return llama.random_params(param_shapes(c), std, generator, c.dtype,
                               device)


def _expert_ffn(p, x):
    """Every expert's SwiGLU FFN on its buffer. p: w_gate/w_up [E, D, F],
    w_down [E, F, D]; x: [E, C, D]."""
    gate = torch.bmm(x, p["w_gate"])
    up = torch.bmm(x, p["w_up"])
    return torch.bmm(F.silu(gate) * up, p["w_down"])


def _moe_block(h, layer_p, config: MixtralConfig):
    """h: [B,S,D] -> (out [B,S,D], aux_loss scalar). The capacity counts
    the tokens of the whole batch."""
    c = config
    b, s, d = h.shape
    out, aux = moe_layer(h.reshape(b * s, d), layer_p["moe_gate"],
                         _expert_ffn, layer_p["experts"],
                         k=c.experts_per_token,
                         capacity_factor=c.capacity_factor)
    return out.reshape(b, s, d), aux


def _layer(x, layer_p, positions, config: MixtralConfig):
    x = llama._attn_sublayer(x, layer_p, positions, config)
    h = _rms_norm(x, layer_p["mlp_norm"], config.norm_eps)
    out, aux = _moe_block(h, layer_p, config)
    return x + out, aux


def forward(params, tokens, config: MixtralConfig, mesh=None, rules=None):
    """tokens [B,S] -> (logits [B,S,V] fp32, aux_loss: the layers' mean).

    With config.remat and gradients enabled each layer is checkpointed
    under config.remat_policy. With a mesh, params and tokens are DTensors
    and so are the logits (batch, seq, act_vocab) and aux (replicated)."""
    if mesh is not None:
        ctx = ShardingContext(mesh, rules)
        x, aux = _forward_hidden_sharded(params, tokens, config, ctx)
        lm_dt = params["lm_head"]
        lm = ctx.gather(ctx.local(lm_dt), lm_dt.placements)
        vocab_tp = ctx.on_tp(lm_dt.placements, 1)
        logits = (ctx.tp_copy(x) @ lm).float()
        return (llama._as_dtensor(logits, ctx, (
            "batch", "seq", "act_vocab" if vocab_tp else None)),
            llama._as_dtensor(aux, ctx, ()))
    c = config
    b, s = tokens.shape
    positions = torch.arange(s, device=tokens.device).expand(b, s)
    x = params["embed"][tokens].to(c.dtype)
    call = llama.layer_caller(c)
    aux = []
    for lp in llama.unbind_layers(params["layers"], c.n_layers):
        x, a = call(_layer, x, lp, positions, c)
        aux.append(a)
    x = _rms_norm(x, params["final_norm"], c.norm_eps)
    return (x @ params["lm_head"]).float(), torch.stack(aux).mean()


def loss_fn(params, batch, config: MixtralConfig, mesh=None, rules=None):
    """Next-token cross-entropy plus aux_loss_coef times the load-balancing
    loss. batch: {"tokens": [B, S]} (targets are the shifted tokens) or
    explicit {"inputs", "targets", "mask"}. The log-softmax runs over the
    full fp32 [B, S, V] logits, as in the JAX function. With a mesh, params
    and batch are DTensors in their shardings and the loss is on every
    rank."""
    if mesh is not None:
        ctx = ShardingContext(mesh, rules)
        inputs, targets, mask = llama.loss_inputs_local(batch, ctx)
        hidden, aux = _forward_hidden_sharded(params, inputs, config, ctx)
        ce = llama.ce_sharded(hidden, params["lm_head"], targets, mask, 0,
                              ctx)
        return ce + config.aux_loss_coef * aux
    inputs, targets, mask = llama._loss_inputs(batch)
    logits, aux = forward(params, inputs, config)
    logp = torch.log_softmax(logits, dim=-1)
    ce = -logp.gather(-1, targets[..., None].long())[..., 0]
    if mask is not None:
        mask = mask.to(torch.float32)
        ce_mean = torch.sum(ce * mask) / torch.clamp(mask.sum(), min=1.0)
    else:
        ce_mean = torch.mean(ce)
    return ce_mean + config.aux_loss_coef * aux


# -- the sharded path ----------------------------------------------------------

def _forward_hidden_sharded(params, tokens, config: MixtralConfig, ctx):
    """This rank's block of the final-norm hidden states and the layers'
    mean aux loss (the same on every rank)."""
    c = config
    x, positions = llama._embed_local(params, tokens, c, ctx)
    layers, placements = llama.layers_local(params["layers"], c.n_layers,
                                            ctx)
    call = llama.layer_caller(c)
    aux = []
    for lp in layers:
        x, a = call(_layer_sharded, x, lp, positions, c, ctx, placements)
        aux.append(a)
    x = llama._norm_local(x, params["final_norm"], c.norm_eps, ctx)
    return x, torch.stack(aux).mean()


def _layer_sharded(x, lp, positions, config: MixtralConfig, ctx, placements):
    """`_layer` on this rank's blocks: Llama's sharded attention sublayer
    (its weights gathered here, inside the checkpoint), then the MoE block
    on JAX's token partition."""
    attn = {n: ctx.gather(t, placements[n]) for n, t in lp.items()
            if n not in ("moe_gate", "experts")}
    heads_tp = ctx.on_tp(placements["wq"], 1)
    attention = functools.partial(llama._attention_sharded, config=config,
                                  ctx=ctx, heads_tp=heads_tp)
    x = llama._attn_sublayer(x, attn, positions, config, attention=attention,
                             **llama._tp_hooks(ctx, heads_tp))
    h = _rms_norm(x, attn["mlp_norm"], config.norm_eps)
    out, aux = _moe_block_sharded(h, lp, placements, config, ctx)
    return x + out, aux


def _moe_block_sharded(h, lp, placements, config: MixtralConfig, ctx):
    """The MoE block of this rank's hidden block h [B_loc,S_loc,D] on the
    JAX function's token partition: the whole batch's flattened tokens
    (gathered), split over ep alone. Every rank of an ep shard computes
    the same thing, so the gradients of the tokens and of the MoE weights
    are the same on each and go back as its blocks (`ShardingContext.
    whole`), with no sum over the data dims. -> (this rank's block of the
    output, aux)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    c = config
    tok_pl = ctx.placements(("batch", "seq", None))
    tokens = ctx.whole(h, tok_pl)
    b, s, d = tokens.shape
    flat = tokens.reshape(b * s, d)
    k, cf = c.experts_per_token, c.capacity_factor
    ep = ctx.sizes.get("ep", 1)
    if ep > 1:
        mesh = ctx.mesh
        split = tuple(Shard(0) if n == "ep" else Replicate()
                      for n in ctx.names)

        def dt(local, pl, want):
            return DTensor.from_local(local, mesh, pl,
                                      run_check=False).redistribute(mesh,
                                                                    want)

        x = dt(flat, ctx._replicate, split)
        gate = dt(lp["moe_gate"], placements["moe_gate"], ctx._replicate)
        experts = {n: dt(w, placements["experts"][n], split)
                   for n, w in lp["experts"].items()}
        out, aux = moe_shard_map(x, gate, _expert_ffn, experts, mesh,
                                 k=k, capacity_factor=cf)
        out, aux = out.redistribute(mesh, ctx._replicate).to_local(), \
            aux.to_local()
    else:
        gate = ctx.whole(lp["moe_gate"], placements["moe_gate"])
        experts = {n: ctx.whole(w, placements["experts"][n])
                   for n, w in lp["experts"].items()}
        out, aux = moe_layer(flat, gate, _expert_ffn, experts, k=k,
                             capacity_factor=cf)
    out = DTensor.from_local(out.reshape(b, s, d), ctx.mesh, ctx._replicate,
                             run_check=False).redistribute(ctx.mesh, tok_pl)
    return out.to_local(), aux


def flops_per_token(config: MixtralConfig, seq_len: int) -> float:
    """6 * N_active + the attention term: a token multiplies through its k
    routed experts only, so the (n_experts - k) other expert FFNs of each
    layer are left out of the parameter count."""
    c = config
    inactive_ffn_params = (
        c.n_layers * (c.n_experts - c.experts_per_token)
        * 3 * c.d_model * c.d_ff)
    param_flops = 6.0 * (c.num_params() - inactive_ffn_params)
    attn_flops = 6.0 * c.n_layers * c.n_heads * c.d_head * seq_len
    return param_flops + attn_flops
