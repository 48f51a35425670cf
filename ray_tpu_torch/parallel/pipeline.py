"""Pipeline parallelism: the GPipe microbatch schedule over the `pp` dim.

Counterpart of `ray_tpu/parallel/pipeline.py`. The stages are the ranks of
the mesh's pp dim, each holding its slice of parameters stacked on a
leading stage axis; microbatch activations move from stage to stage by
point-to-point sends (`_rotate`), a ring as JAX's ppermute is (the last
stage's send to stage 0 is received and dropped), and after M + n - 1
steps the last stage's outputs are summed over the pp group from a mask,
so every stage returns them, as the JAX schedule's psum does.

The schedule is differentiable, as the JAX scan over ppermute is: its
backward is that scan transposed, the steps in reverse, each rotate's
transpose the rotate the other way (ppermute's inverse permutation), and
each step's stage_fn differentiated at the input it took (recomputed from
the saved input, as a remat would). The cotangent of the summed outputs is
the same on every rank, as the replicated result's is, and each rank takes
it as it is: the last stage turns it into its outputs' gradient and the
others' masked outputs have none. The gradient that reaches the
microbatches is stage 0's (zero on the other stages: a partial sum over
pp); that of the stage parameters is each stage's own.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
import torch.distributed as dist

from ray_tpu_torch.parallel.ring_attention import _rotate


def pipeline_apply(stage_fn: Callable, stage_params: Any, microbatches,
                   group=None):
    """Run the GPipe schedule on this rank's stage: stage_fn(stage_params,
    x) -> y of x's shape; microbatches [M, mb, ...], the same on every
    stage. -> [M, mb, ...] the last stage's outputs, on every stage;
    differentiable in the stage parameters and the microbatches."""
    group = dist.group.WORLD if group is None else group
    leaves, rebuild = _flatten(stage_params)
    return _Pipeline.apply(stage_fn, rebuild, group, microbatches, *leaves)


class _Pipeline(torch.autograd.Function):

    @staticmethod
    def forward(ctx, stage_fn, rebuild, group, microbatches, *leaves):
        n, stage = dist.get_world_size(group), dist.get_rank(group)
        params = rebuild(list(leaves))
        m = microbatches.shape[0]
        buf = torch.zeros_like(microbatches[0])
        outputs = torch.zeros_like(microbatches)
        inputs = []
        for t in range(m + n - 1):
            # Stage 0 takes microbatch t (clamped, as JAX's index is); the
            # others the activation that came from the left last step.
            x = microbatches[min(t, m - 1)] if stage == 0 else buf
            inputs.append(x)
            y = stage_fn(params, x)
            out_index = t - n + 1
            if 0 <= out_index < m and stage == n - 1:
                outputs[out_index] = y
            if n > 1 and t < m + n - 2:   # the last step's send is dropped
                buf = _rotate([y], group)[0]
        if n > 1:
            dist.all_reduce(outputs, group=group)  # only the last stage's != 0
        ctx.save_for_backward(microbatches, *leaves, *inputs)
        ctx.stage_fn, ctx.rebuild, ctx.group = stage_fn, rebuild, group
        ctx.n_leaves = len(leaves)
        return outputs

    @staticmethod
    def backward(ctx, d_outputs):
        group = ctx.group
        n, stage = dist.get_world_size(group), dist.get_rank(group)
        saved = ctx.saved_tensors
        microbatches = saved[0]
        leaves = saved[1:1 + ctx.n_leaves]
        inputs = saved[1 + ctx.n_leaves:]
        m = microbatches.shape[0]
        d_mb = torch.zeros_like(microbatches)
        d_leaves = [torch.zeros_like(w) for w in leaves]
        d_buf = None   # the cotangent of the activation step t + 1 took
        for t in reversed(range(m + n - 1)):
            d_y = torch.zeros_like(inputs[t])
            if d_buf is not None:
                # ppermute's transpose: the rotate the other way
                d_y = _rotate([d_buf], group, -1)[0]
            out_index = t - n + 1
            if 0 <= out_index < m and stage == n - 1:
                d_y = d_y + d_outputs[out_index]
            with torch.enable_grad():
                ws = [w.detach().requires_grad_(True) for w in leaves]
                x = inputs[t].detach().requires_grad_(True)
                y = ctx.stage_fn(ctx.rebuild(ws), x)
                grads = torch.autograd.grad(y, ws + [x], d_y,
                                            allow_unused=True)
            for acc, g in zip(d_leaves, grads[:-1]):
                if g is not None:
                    acc += g
            d_x = torch.zeros_like(x) if grads[-1] is None else grads[-1]
            if stage == 0:
                d_mb[min(t, m - 1)] += d_x
                d_x = torch.zeros_like(d_x)
            d_buf = d_x if n > 1 and t > 0 else None
        return (None, None, None, d_mb, *d_leaves)


def pipeline_sharded(stage_fn: Callable, mesh, axis_name: str = "pp"):
    """-> wrapped(stacked_params, microbatches): `local_map` of
    `pipeline_apply` over DTensors, the parameters' leaves stacked on a
    leading [pp, ...] stage axis split over `axis_name`, the microbatches
    and the result replicated. The microbatches' gradient is a partial sum
    over `axis_name` (stage 0's block; the other stages add zero)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    names = tuple(mesh.mesh_dim_names)
    replicated = tuple(Replicate() for _ in names)
    staged = tuple(Shard(0) if n == axis_name else Replicate()
                   for n in names)
    mb_grad = tuple(Partial() if n == axis_name else Replicate()
                    for n in names)
    group = mesh.get_group(axis_name)

    def wrapped(stacked_params, microbatches):
        leaves, rebuild = _flatten(stacked_params)

        def local(mb, *local_leaves):
            return pipeline_apply(stage_fn, rebuild(list(local_leaves)), mb,
                                  group)

        fn = local_map(local, out_placements=(replicated,),
                       in_placements=(replicated,) + (staged,) * len(leaves),
                       in_grad_placements=(mb_grad,) + (staged,) * len(leaves),
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
