"""Pipeline parallelism: the GPipe microbatch schedule over the `pp` dim.

Counterpart of `ray_tpu/parallel/pipeline.py`. The stages are the ranks of
the mesh's pp dim, each holding its slice of parameters stacked on a
leading stage axis; microbatch activations move from stage to stage by
point-to-point sends (`batch_isend_irecv`), a ring as JAX's ppermute is
(the last stage's send to stage 0 is received and dropped), and after
M + n - 1 steps the last stage's outputs are summed over the pp group from
a mask, so every stage returns them, as the JAX schedule's psum does.

The schedule is the forward only: the JAX one is differentiable through
ppermute, this one is not (no autograd through the sends), so it raises
where autograd would record it.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
import torch.distributed as dist


def pipeline_apply(stage_fn: Callable, stage_params: Any, microbatches,
                   group=None):
    """Run the GPipe schedule on this rank's stage: stage_fn(stage_params,
    x) -> y of x's shape; microbatches [M, mb, ...], the same on every
    stage. -> [M, mb, ...] the last stage's outputs, on every stage.
    Raises NotImplementedError under autograd (gradients enabled and a
    stage parameter or the microbatches requiring one): the backward of the
    schedule is not ported, and every stage but the last would get none."""
    from ray_tpu_torch.parallel.ring_attention import _rotate

    leaves, _ = _flatten(stage_params)
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad
            for t in leaves + [microbatches]):
        raise NotImplementedError(
            "pipeline_apply runs the forward only; its backward is not "
            "ported (call it under torch.no_grad() or on tensors that do "
            "not require grad)")

    group = dist.group.WORLD if group is None else group
    n, stage = dist.get_world_size(group), dist.get_rank(group)
    m = microbatches.shape[0]
    buf = torch.zeros_like(microbatches[0])
    outputs = torch.zeros_like(microbatches)
    for t in range(m + n - 1):
        # Stage 0 takes microbatch t (clamped, as JAX's index is); the
        # others the activation that came from the left last step.
        x = microbatches[min(t, m - 1)] if stage == 0 else buf
        y = stage_fn(stage_params, x)
        out_index = t - n + 1
        if 0 <= out_index < m and stage == n - 1:
            outputs[out_index] = y
        buf = _rotate([y], group)[0] if n > 1 else y
    if n > 1:
        dist.all_reduce(outputs, group=group)  # only the last stage's != 0
    return outputs


def pipeline_sharded(stage_fn: Callable, mesh, axis_name: str = "pp"):
    """-> wrapped(stacked_params, microbatches): `local_map` of
    `pipeline_apply` over DTensors, the parameters' leaves stacked on a
    leading [pp, ...] stage axis split over `axis_name`, the microbatches
    and the result replicated."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    names = tuple(mesh.mesh_dim_names)
    replicated = tuple(Replicate() for _ in names)
    staged = tuple(Shard(0) if n == axis_name else Replicate()
                   for n in names)
    group = mesh.get_group(axis_name)

    def wrapped(stacked_params, microbatches):
        leaves, rebuild = _flatten(stacked_params)

        def local(mb, *local_leaves):
            return pipeline_apply(stage_fn, rebuild(list(local_leaves)), mb,
                                  group)

        fn = local_map(local, out_placements=(replicated,),
                       in_placements=(replicated,) + (staged,) * len(leaves),
                       device_mesh=mesh)
        return fn(microbatches, *leaves)

    return wrapped


def _flatten(tree):
    """Leaves of nested dictionaries (or a single tensor) in order, and the
    function that puts a list of leaves back in that structure."""
    if isinstance(tree, dict):
        keys = list(tree)
        parts = [_flatten(tree[k]) for k in keys]
        leaves = [x for p in parts for x in p[0]]

        def rebuild(xs):
            out, i = {}, 0
            for k, (ls, rb) in zip(keys, parts):
                out[k] = rb(xs[i:i + len(ls)])
                i += len(ls)
            return out

        return leaves, rebuild
    return [tree], lambda xs: xs[0]
