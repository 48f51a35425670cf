"""Ring attention: exact attention over Q/K/V sharded on the sequence.

Counterpart of `ray_tpu/parallel/ring_attention.py`. K/V blocks travel
around the `sp` group by point-to-point sends (`batch_isend_irecv`) while
each rank keeps its Q block, so a rank holds O(S / sp) of the sequence.
Where the JAX ring is jnp arithmetic (`_block_attn_update`) that autodiff
differentiates through `ppermute`, this one runs the port's flash kernels
block by block, forward and backward:

  * forward: at ring step s a rank holds the K/V block of rank (my - s)
    mod n. Its own block (s = 0) goes through the forward kernel with
    causal=True, an earlier rank's with causal=False, and a later rank's
    launches nothing (under causal). The partial (O, lse) pairs merge in
    fp32 by their lse: lse = logaddexp of the parts, each O weighted by
    exp(lse_part - lse). A part whose rows saw no key (lse ~ -1e30) gets
    weight 0, so the kernel's contract for such rows needs no case here.
  * backward: `flash_bwd` per visited block with the final O, the merged
    lse and dO, so each block's P is its share of the global softmax and
    Delta = rowsum(dO * O) is the global one; dQ accumulates locally in
    fp32, and each block's partial dK/dV (fp32) travel with it and one step
    further, which brings them home to the rank that owns the block.

Under causal a rank launches each kernel my + 1 times a call, (n + 1) / 2
on average over the ring. The forward and the backward are the operators
`ray_tpu_torch::ring_fwd` / `ring_bwd`: a compiled step holds each whole
ring as one node, so every rank's program keeps every send and receive in
one order, whatever blocks its own rank skips (as nodes of their own, a
rotate whose result a rank does not use would be dead code to the
compiler, and its peer would wait for it). `_block_attn_update_plain` is the JAX package's
per-block arithmetic in torch, the plain version the ring is held to.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from ray_tpu_torch.ops import flash_attention as fa
from ray_tpu_torch.ops.flash_attention import NEG_INF


def _rotate(tensors, group, shift: int = 1):
    """Send each tensor to the rank `shift` places on in `group` (a
    ProcessGroup) and receive those of the rank `shift` places back, all in
    one batch of point-to-point operations (every rank posts its sends,
    then its receives, in the tensors' order). Its transpose is the rotate
    by -shift, as that of JAX's ppermute is the inverse permutation (the
    pipeline's backward takes it so)."""
    n, my = dist.get_world_size(group), dist.get_rank(group)
    nxt = dist.get_global_rank(group, (my + shift) % n)
    prv = dist.get_global_rank(group, (my - shift) % n)
    recv = [torch.empty_like(t) for t in tensors]
    ops = ([dist.P2POp(dist.isend, t.contiguous(), nxt, group)
            for t in tensors]
           + [dist.P2POp(dist.irecv, r, prv, group) for r in recv])
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return recv


def merge_partials(o_acc, lse_acc, o, lse):
    """Merge two partial attention results over disjoint key sets: o
    [B,S,H,D] (o_acc fp32), lse [B,H,S] fp32 -> (o fp32, lse). None for
    o_acc starts the merge with (o, lse)."""
    if o_acc is None:
        return o.float(), lse
    lse_new = torch.logaddexp(lse_acc, lse)
    w_acc = torch.exp(lse_acc - lse_new).transpose(1, 2)[..., None]
    w_new = torch.exp(lse - lse_new).transpose(1, 2)[..., None]
    return o_acc * w_acc + o.float() * w_new, lse_new


def _visible(causal: bool, src: int, my: int) -> Optional[bool]:
    """The kernel's causal flag for the block of rank `src` seen from rank
    `my`, or None where it sees none of it."""
    if not causal:
        return False
    if src == my:
        return True
    return False if src < my else None


def _group(name: str):
    from torch.distributed.distributed_c10d import _resolve_process_group

    group = _resolve_process_group(name)
    return group, dist.get_world_size(group), dist.get_rank(group)


@torch.library.custom_op("ray_tpu_torch::ring_fwd", mutates_args=())
def ring_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, group: str,
             causal: bool, scale: float
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ring's forward over the group named `group`: (o like q, the
    merged lse [B,H,S_loc] fp32). An operator, so that a compiled program
    holds the whole ring, its sends and receives in their order, as one
    node that every rank runs, whatever blocks its own rank skips."""
    pg, n, my = _group(group)
    o_acc = lse_acc = None
    kc, vc = k.contiguous(), v.contiguous()
    for s in range(n):
        flag = _visible(causal, (my - s) % n, my)
        if flag is not None:
            o, lse = fa.flash_fwd(q, kc, vc, flag, scale)
            o_acc, lse_acc = merge_partials(o_acc, lse_acc, o, lse)
        if s < n - 1:
            kc, vc = _rotate([kc, vc], pg)
    return o_acc.to(q.dtype), lse_acc


@ring_fwd.register_fake
def _(q, k, v, group, causal, scale):
    b, s_q, h, _ = q.shape
    return (q.new_empty(q.shape),
            q.new_empty((b, h, s_q), dtype=torch.float32))


@torch.library.custom_op("ray_tpu_torch::ring_bwd", mutates_args=())
def ring_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
             group: str, causal: bool, scale: float
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The ring's backward: (dq, dk, dv) like q, k and v."""
    pg, n, my = _group(group)
    do = do.contiguous()
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    kc, vc = k.contiguous(), v.contiguous()
    dkc = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dvc = torch.zeros_like(dkc)
    for s in range(n):
        flag = _visible(causal, (my - s) % n, my)
        if flag is not None:
            dq_s, dk_s, dv_s = fa.flash_bwd(q, kc, vc, o, lse, do, flag,
                                            scale)
            dq += dq_s.float()
            dkc += dk_s.float()
            dvc += dv_s.float()
        if n == 1:
            break
        # K/V move on while another step needs them; the partial dK/dV
        # move once more, to the block's owner.
        if s < n - 1:
            kc, vc, dkc, dvc = _rotate([kc, vc, dkc, dvc], pg)
        else:
            dkc, dvc = _rotate([dkc, dvc], pg)
    return (dq.to(q.dtype).contiguous(), dkc.to(k.dtype).contiguous(),
            dvc.to(v.dtype).contiguous())


@ring_bwd.register_fake
def _(q, k, v, o, lse, do, group, causal, scale):
    return q.new_empty(q.shape), k.new_empty(k.shape), v.new_empty(v.shape)


def _ring_fwd_setup_context(ctx, inputs, output):
    q, k, v, group, causal, scale = inputs
    o, lse = output
    ctx.save_for_backward(q, k, v, o, lse)
    ctx.group, ctx.causal, ctx.scale = group, causal, scale
    ctx.mark_non_differentiable(lse)


def _ring_fwd_backward(ctx, do, _dlse):
    q, k, v, o, lse = ctx.saved_tensors
    dq, dk, dv = ring_bwd(q, k, v, o, lse, do, ctx.group, ctx.causal,
                          ctx.scale)
    return dq, dk, dv, None, None, None


ring_fwd.register_autograd(_ring_fwd_backward,
                           setup_context=_ring_fwd_setup_context)


def ring_attention(q, k, v, group=None, causal: bool = True,
                   scale: Optional[float] = None) -> torch.Tensor:
    """Exact attention where q, k, v are this rank's sequence block of the
    `group` ranks (the sp group; default the whole gang), blocks in rank
    order. q [B,S_loc,H,D], k/v [B,S_loc,H_kv,D] (GQA: the kernels sum the
    group; no repeat needed) -> [B,S_loc,H,D]. Differentiable in q, k, v."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    group = dist.group.WORLD if group is None else group
    return ring_fwd(q, k, v, group.group_name, causal, scale)[0]


def _block_attn_update_plain(q, k, v, o, m, l, q_pos, k_pos, scale, causal):
    """The JAX package's `_block_attn_update` in torch, fp32: one
    online-softmax step of q [B,Sq,H,D] against a K/V block [B,Sk,H,D]
    (KV heads repeated); o [B,Sq,H,D], m, l [B,H,Sq] running max and sum;
    *_pos the global positions."""
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if causal:
        mask = q_pos[:, None] >= k_pos[None, :]
        scores = torch.where(mask[None, None], scores, NEG_INF)
    m_new = torch.maximum(m, scores.amax(-1))
    m_safe = torch.where(m_new <= NEG_INF / 2, 0.0, m_new)
    p = torch.exp(scores - m_safe[..., None])
    p = torch.where(scores <= NEG_INF / 2, 0.0, p)
    correction = torch.exp(torch.where(m <= NEG_INF / 2, NEG_INF, m) - m_safe)
    correction = torch.where(m <= NEG_INF / 2, 0.0, correction)
    l_new = l * correction + p.sum(-1)
    pv = torch.einsum("bhqk,bkhd->bqhd", p, v)
    o_new = o * correction.transpose(1, 2)[..., None] + pv
    return o_new, m_new, l_new


def ring_attention_plain(q, k, v, n: int, causal: bool = True,
                         scale: Optional[float] = None) -> torch.Tensor:
    """The ring's function on whole tensors [B,S,H|H_kv,D], S cut into n
    blocks, by `_block_attn_update_plain` over the blocks each rank would
    visit, in ring order: what `ring_attention` on n ranks must return,
    concatenated."""
    b, s, h, d = q.shape
    scale = d ** -0.5 if scale is None else scale
    rep = h // k.shape[2]
    qf = q.float()
    kf, vf = (t.float().repeat_interleave(rep, dim=2) for t in (k, v))
    blk = s // n
    outs = []
    for my in range(n):
        sl = slice(my * blk, (my + 1) * blk)
        q_pos = torch.arange(my * blk, (my + 1) * blk, device=q.device)
        o = torch.zeros_like(qf[:, sl])
        m = torch.full((b, h, blk), NEG_INF, device=q.device)
        l = torch.zeros((b, h, blk), device=q.device)
        for step in range(n):
            src = (my - step) % n
            if causal and src > my:
                continue
            ks = slice(src * blk, (src + 1) * blk)
            k_pos = torch.arange(src * blk, (src + 1) * blk, device=q.device)
            o, m, l = _block_attn_update_plain(qf[:, sl], kf[:, ks],
                                               vf[:, ks], o, m, l, q_pos,
                                               k_pos, scale, causal)
        outs.append(o / l.clamp_min(1e-20).transpose(1, 2)[..., None])
    return torch.cat(outs, dim=1).to(q.dtype)


def ring_attention_sharded(q, k, v, mesh, axis_name: str = "sp",
                           causal: bool = True,
                           scale: Optional[float] = None):
    """`local_map`-wrapped ring attention over DTensors [B, S, H, D] whose
    S is sharded on `axis_name`: batch over every data-parallel dim of the
    mesh (dcn, dp, fsdp) where it divides, heads over tp where they divide
    (KV heads too where they divide, else repeated first, as the JAX
    wrapper repeats them), S over `axis_name`."""
    from ray_tpu_torch.ops.flash_attention import _local_map_attention

    fn = functools.partial(ring_attention, group=mesh.get_group(axis_name),
                           causal=causal, scale=scale)
    return _local_map_attention(fn, q, k, v, mesh, seq_axis=axis_name)
