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

The expert-parallel form, `moe_shard_map`, splits the experts over a mesh
dim and exchanges the token buffers with `all_to_all_single` around the
same routing. Its collectives are operators with their own gradients
(`all_to_all`, `group_mean`, `sum_grad`), so that a compiled step holds
them as nodes of its program.
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


def _dispatch(x, gate_w, k: int, cap: int):
    """Route x [T, D] over gate_w [D, E] with `cap` slots an expert ->
    (expert_in [E, C, D] in x's dtype, flat [T*k] each choice's buffer row
    (E*C for a dropped one), the Route)."""
    t, d = x.shape
    e = gate_w.shape[1]
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
    return expert_in, flat, r


def _combine(expert_out, flat, r, k: int):
    """Each token's k expert outputs (rows `flat` of expert_out [E, C, D];
    the spare row is zeros) weighted by their gates, summed in fp32."""
    e, cap, d = expert_out.shape
    rows = expert_out.reshape(e * cap, d)
    out_rows = torch.cat([rows, rows.new_zeros(1, d)])
    picked = out_rows.index_select(0, flat).view(-1, k, d).float()
    return (picked * r.gate[..., None]).sum(1)


def moe_layer(x: torch.Tensor, gate_w: torch.Tensor, expert_fn: Callable,
              expert_params: Any, k: int = 2, capacity_factor: float = 1.25
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [T, D], gate_w [D, E] -> ([T, D] in x's dtype, aux). expert_fn(
    expert_params, [E, C, D]) -> [E, C, D] computes every expert on its
    buffer at once (the JAX package's `jax.vmap(expert_fn)`); the leaves of
    expert_params lead with E. The gate logits are fp32, the experts see x's
    dtype, the combine is fp32 and cast at the end, as in the JAX layer."""
    t = x.shape[0]
    cap = capacity(t, gate_w.shape[1], k, capacity_factor)
    expert_in, flat, r = _dispatch(x, gate_w, k, cap)
    out = _combine(expert_fn(expert_params, expert_in), flat, r, k)
    return out.to(x.dtype), r.aux


def _group(name: str):
    from torch.distributed.distributed_c10d import _resolve_process_group

    return _resolve_process_group(name)


@torch.library.custom_op("ray_tpu_torch::all_to_all", mutates_args=())
def all_to_all(x: torch.Tensor, group: str) -> torch.Tensor:
    """Split x's leading dim into one part per rank of the group named
    `group`, send part i to rank i and stack what each rank sent here, in
    rank order. Its own transpose: the backward sends the gradients back
    the same way. An operator, so that a compiled program holds it."""
    x = x.contiguous()
    out = torch.empty_like(x)
    torch.distributed.all_to_all_single(out, x, group=_group(group))
    return out


@all_to_all.register_fake
def _(x, group):
    return torch.empty_like(x, memory_format=torch.contiguous_format)


def _all_to_all_setup_context(ctx, inputs, output):
    ctx.group = inputs[1]


def _all_to_all_backward(ctx, grad):
    return all_to_all(grad, ctx.group), None


all_to_all.register_autograd(_all_to_all_backward,
                             setup_context=_all_to_all_setup_context)


@torch.library.custom_op("ray_tpu_torch::all_reduce_sum", mutates_args=())
def all_reduce_sum(x: torch.Tensor, group: str) -> torch.Tensor:
    """The sum over the ranks of the group named `group` of each one's x,
    on each (no gradient: the MoE functions below say theirs)."""
    out = x.clone(memory_format=torch.contiguous_format)
    torch.distributed.all_reduce(out, group=_group(group))
    return out


@all_reduce_sum.register_fake
def _(x, group):
    return torch.empty_like(x, memory_format=torch.contiguous_format)


@torch.library.custom_op("ray_tpu_torch::group_mean", mutates_args=())
def group_mean(x: torch.Tensor, group: str) -> torch.Tensor:
    """The mean over the ranks of the group of each one's x, on each; the
    objective that uses it is the same on every rank and counts once, so
    each rank's x gets 1/n of its gradient."""
    n = torch.distributed.get_world_size(_group(group))
    return all_reduce_sum(x, group) / n


@group_mean.register_fake
def _(x, group):
    return torch.empty_like(x, memory_format=torch.contiguous_format)


def _group_mean_setup_context(ctx, inputs, output):
    ctx.n = torch.distributed.get_world_size(_group(inputs[1]))


def _group_mean_backward(ctx, grad):
    return grad / ctx.n, None


group_mean.register_autograd(_group_mean_backward,
                             setup_context=_group_mean_setup_context)


@torch.library.custom_op("ray_tpu_torch::sum_grad", mutates_args=())
def sum_grad(x: torch.Tensor, group: str) -> torch.Tensor:
    """x as it is (a copy), its gradient summed over the ranks of the
    group: the gradient of an input replicated over the group that each
    rank uses on its own tokens (JAX's transpose of a replicated shard_map
    input)."""
    return x.clone()


@sum_grad.register_fake
def _(x, group):
    return torch.empty_like(x)


def _sum_grad_setup_context(ctx, inputs, output):
    ctx.group = inputs[1]


def _sum_grad_backward(ctx, grad):
    return all_reduce_sum(grad, ctx.group), None


sum_grad.register_autograd(_sum_grad_backward,
                           setup_context=_sum_grad_setup_context)


def moe_shard_map(x, gate_w, expert_fn, expert_params, mesh,
                  axis_name: str = "ep", k: int = 2,
                  capacity_factor: float = 1.25):
    """Experts split over the mesh dim `axis_name`, token buffers exchanged
    with `all_to_all_single`: the counterpart of the JAX function's
    shard_map with `lax.all_to_all`. DTensors in: x [T, D] split on T over
    `axis_name`, gate_w [D, E] replicated, expert_params' leaves [E, ...]
    split on E. Each rank routes its own tokens with a capacity from its T
    (as the JAX shard does), by index (no [T, E, C] tensor); its [E, C, D]
    buffer goes out as n parts of E/n experts each, every rank runs its
    experts on the n * C tokens it received, and the outputs go back the
    same way. -> (out [T, D] split like x, aux: the mean over the ranks of
    their aux, replicated). gate_w's gradient is summed over the ranks,
    each of which routed only its own tokens with it."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    from ray_tpu_torch.parallel.pipeline import _flatten

    names = tuple(mesh.mesh_dim_names)
    split = tuple(Shard(0) if n == axis_name else Replicate() for n in names)
    replicated = tuple(Replicate() for _ in names)
    group = mesh.get_group(axis_name).group_name
    n = mesh.size(names.index(axis_name))
    n_exp = gate_w.shape[1]
    if n_exp % n:
        raise ValueError(f"{n_exp} experts do not split over {n} ranks")
    leaves, rebuild = _flatten(expert_params)

    def local(x_loc, gate_full, *param_leaves):
        t, d = x_loc.shape
        cap = capacity(t, n_exp, k, capacity_factor)
        gate_full = sum_grad(gate_full, group)
        buf, flat, r = _dispatch(x_loc, gate_full, k, cap)
        e_loc = n_exp // n
        # [E, C, D] -> [n(dst), E_loc, C, D] out; in: [n(src), E_loc, C, D]
        got = all_to_all(buf.view(n, e_loc, cap, d), group)
        got = got.transpose(0, 1).reshape(e_loc, n * cap, d)
        out = expert_fn(rebuild(list(param_leaves)), got)
        out = out.reshape(e_loc, n, cap, d).transpose(0, 1)
        back = all_to_all(out, group).reshape(n_exp, cap, d)
        y = _combine(back, flat, r, k).to(x_loc.dtype)
        aux = group_mean(r.aux, group)
        return y, aux

    fn = local_map(local, out_placements=(split, replicated),
                   in_placements=(split, replicated) + (split,) * len(leaves),
                   device_mesh=mesh)
    return fn(x, gate_w, *leaves)
