"""Mixture-of-Experts routing and dispatch on one device.

Counterpart of `ray_tpu/parallel/moe.py`'s `top_k_gating` and `moe_layer`:
top-k routing over a softmax of the gate logits, a capacity of
`max(1, int(capacity_factor * T * k / E))` slots per expert over the T
tokens of the whole batch, slots given in priority order (every token's
first choice before any token's second choice, a running count per expert
carried between the passes, tokens in flat order within a pass), and the
choices past capacity dropped: that expert adds 0 to the token, whose
residual carries it.

`top_k_gating` returns the JAX function's [T, E, C] dispatch and combine
tensors. `moe_layer` computes the same function by index instead of by
einsum against them: every (expert, slot) holds at most one token, so a
gather into a fixed [E, C, D] buffer gives the dispatch einsum's values and
a gather of each token's k weighted expert outputs gives the combine's. A
dropped choice points at one spare row (zeros on the combine side), so the
shapes stay static and the layer traces with
`torch.compile(fullgraph=True, dynamic=False)`.

The expert-parallel form (`moe_shard_map`: experts sharded across devices,
token buffers exchanged by all_to_all) waits for the multi-GPU slice.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Tuple

import torch


class Route(NamedTuple):
    """Where each token's k choices go: expert [T, k] and slot [T, k]
    (position in that expert's buffer), gate [T, k] the choice's softmax
    probability (fp32, not renormalised over the k), keep [T, k] False for
    a choice past capacity; probs [T, E] fp32; aux the load-balancing loss."""
    expert: torch.Tensor
    slot: torch.Tensor
    gate: torch.Tensor
    keep: torch.Tensor
    probs: torch.Tensor
    aux: torch.Tensor


def capacity(n_tokens: int, n_experts: int, k: int,
             capacity_factor: float) -> int:
    """Slots per expert, in the JAX function's Python float arithmetic."""
    return max(1, int(capacity_factor * n_tokens * max(k, 1) / n_experts))


def route(logits: torch.Tensor, k: int, capacity: int) -> Route:
    """Top-k routing with capacity of logits [T, E]."""
    t, e = logits.shape
    probs = torch.softmax(logits.float(), dim=-1)
    # jax.lax.top_k puts the lower expert first among equal values; a
    # stable descending sort does too (torch.topk promises no order).
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, expert = vals[:, :k], idx[:, :k]
    experts = torch.arange(e, device=logits.device)
    # Switch-style load balancing: E * sum(mean prob * share of first
    # choices); gradients reach it through the probabilities only.
    top1 = (expert[:, :1] == experts).float()
    aux = e * torch.sum(probs.mean(0) * top1.mean(0))
    counts = torch.zeros(e, dtype=torch.int64, device=logits.device)
    slots = []
    for s in range(k):
        onehot = (expert[:, s:s + 1] == experts).long()          # [T, E]
        pos = (torch.cumsum(onehot, 0) - onehot + counts) * onehot
        slots.append(pos.sum(-1))
        counts = counts + onehot.sum(0)
    slot = torch.stack(slots, dim=1)
    return Route(expert, slot, gate, slot < capacity, probs, aux)


def top_k_gating(logits: torch.Tensor, k: int, capacity: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """logits [T, E] -> (dispatch [T, E, C] one-hot of each kept choice's
    (expert, slot), combine [T, E, C] the same weighted by its gate, aux),
    as the JAX function returns them."""
    t, e = logits.shape
    r = route(logits, k, capacity)
    flat = torch.where(r.keep, r.expert * capacity + r.slot, e * capacity)
    zeros = torch.zeros((t, e * capacity + 1), dtype=torch.float32,
                        device=logits.device)
    dispatch = zeros.scatter(1, flat, r.keep.float())
    combine = zeros.scatter(1, flat, r.gate * r.keep)
    return (dispatch[:, :-1].view(t, e, capacity),
            combine[:, :-1].view(t, e, capacity), r.aux)


def moe_layer(x: torch.Tensor, gate_w: torch.Tensor, expert_fn: Callable,
              expert_params: Any, k: int = 2, capacity_factor: float = 1.25
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [T, D], gate_w [D, E] -> ([T, D] in x's dtype, aux). expert_fn(
    expert_params, [E, C, D]) -> [E, C, D] computes every expert on its
    buffer at once (the JAX package's `jax.vmap(expert_fn)`); the leaves of
    expert_params lead with E. The gate logits are fp32, the experts see x's
    dtype, the combine is fp32 and cast at the end, as in the JAX layer."""
    t, d = x.shape
    e = gate_w.shape[1]
    cap = capacity(t, e, k, capacity_factor)
    xf = x.float()
    r = route(xf @ gate_w.float(), k, cap)
    # (expert, slot) of each choice as a row of the E*C buffer; a dropped
    # choice goes to the spare row E*C.
    flat = torch.where(r.keep, r.expert * cap + r.slot, e * cap).reshape(-1)
    # The token in each row: T (a row of zeros) where a slot stays empty.
    # Only the spare row can be written twice, and it is never read.
    tokens = torch.arange(t, device=x.device).repeat_interleave(k)
    owner = torch.full((e * cap + 1,), t, dtype=torch.int64, device=x.device)
    owner = owner.scatter(0, flat, tokens)[:-1]
    rows = torch.cat([xf, xf.new_zeros(1, d)])
    expert_in = rows.index_select(0, owner).view(e, cap, d).to(x.dtype)
    expert_out = expert_fn(expert_params, expert_in).reshape(e * cap, d)
    out_rows = torch.cat([expert_out, expert_out.new_zeros(1, d)])
    picked = out_rows.index_select(0, flat).view(t, k, d).float()
    out = (picked * r.gate[..., None]).sum(1)
    return out.to(x.dtype), r.aux
