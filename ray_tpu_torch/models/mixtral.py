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
gather and the combine are recomputed too. The expert-parallel branch
(`moe_shard_map` over an `ep` mesh axis) waits for the multi-GPU slice.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch
import torch.nn.functional as F

from ray_tpu_torch.models import llama
from ray_tpu_torch.models.llama import LlamaConfig, _rms_norm
from ray_tpu_torch.parallel.moe import moe_layer


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


def forward(params, tokens, config: MixtralConfig):
    """tokens [B,S] -> (logits [B,S,V] fp32, aux_loss: the layers' mean).

    With config.remat and gradients enabled each layer is checkpointed
    under config.remat_policy."""
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


def loss_fn(params, batch, config: MixtralConfig):
    """Next-token cross-entropy plus aux_loss_coef times the load-balancing
    loss. batch: {"tokens": [B, S]} (targets are the shifted tokens) or
    explicit {"inputs", "targets", "mask"}. The log-softmax runs over the
    full fp32 [B, S, V] logits, as in the JAX function."""
    if "inputs" in batch:
        inputs, targets = batch["inputs"], batch["targets"]
        mask = batch.get("mask")
    else:
        tokens = batch["tokens"]
        inputs, targets = tokens[:, :-1], tokens[:, 1:]
        mask = None
    logits, aux = forward(params, inputs, config)
    logp = torch.log_softmax(logits, dim=-1)
    ce = -logp.gather(-1, targets[..., None].long())[..., 0]
    if mask is not None:
        mask = mask.to(torch.float32)
        ce_mean = torch.sum(ce * mask) / torch.clamp(mask.sum(), min=1.0)
    else:
        ce_mean = torch.mean(ce)
    return ce_mean + config.aux_loss_coef * aux


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
