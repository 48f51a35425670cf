"""AdamW with optax's signature, defaults and update, over dictionaries of
tensors.

Counterpart of the `optax.adamw` the JAX package trains with. Its defaults
are optax's, not `torch.optim.AdamW`'s: weight_decay is 1e-4 (torch: 0.01).
The update is optax's: mu and nu are moving averages of the gradient and
its square, bias-corrected by 1 - b**count; eps is added after
sqrt(nu_hat); the decay is decoupled and applied to the parameter before the
update. The moments are kept in the parameter's dtype, as optax keeps them.
Where the JAX package returns new arrays (and donates the old ones), this
updates parameters and moments in place, with PyTorch's multi-tensor
(`_foreach`) operations, eagerly or as one compiled program (`updater`).
Over DTensor parameters (the sharded step) each rank updates its local
blocks, eagerly or compiled the same way, and the global norm counts every
block once, its all-reduce inside the program.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch


def tree_leaves(tree) -> List[torch.Tensor]:
    """The tensors of nested dictionaries, lists and tuples, depth first in
    insertion order."""
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def tree_map(fn: Callable, tree):
    """Nested dictionaries and lists of the same structure with fn(leaf) as
    leaves."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def _local(x) -> torch.Tensor:
    return x.to_local() if _is_dtensor(x) else x


def local_leaves(tree) -> List[torch.Tensor]:
    """The leaves, each DTensor as its rank's local block (the tensor
    itself, so an in-place update of it updates the DTensor)."""
    with torch.no_grad():
        return [_local(x) for x in tree_leaves(tree)]


def _first_replica(x) -> bool:
    """Whether this rank holds the first copy of a DTensor's block:
    coordinate 0 on every mesh dim (of size > 1) it is replicated on."""
    from torch.distributed.tensor import Replicate

    coord = x.device_mesh.get_coordinate()
    return all(c == 0 for i, (c, p) in enumerate(zip(coord, x.placements))
               if p == Replicate() and x.device_mesh.size(i) > 1)


def global_norm(grads) -> torch.Tensor:
    """sqrt(sum of squares) over every leaf, accumulated in fp32 on the
    leaves' device: the counterpart of `optax.global_norm`. Over DTensors
    each block counts once: the first replica of a block adds its squares,
    and one all-reduce over the gang sums them, so a replicated parameter
    is not counted once per copy."""
    leaves = tree_leaves(grads)
    if not any(_is_dtensor(g) for g in leaves):
        norms = [torch.linalg.vector_norm(g, dtype=torch.float32)
                 for g in leaves]
        return torch.linalg.vector_norm(torch.stack(norms))
    return _blocks_norm(local_leaves(grads), _counted(leaves))


def _counted(leaves) -> Tuple[bool, ...]:
    """Per leaf, whether this rank's block adds to the global norm: a plain
    tensor always, a DTensor's block on its first replica."""
    return tuple(not _is_dtensor(g) or _first_replica(g) for g in leaves)


def _blocks_norm(blocks, counted) -> torch.Tensor:
    """The global norm from each rank's blocks: the squares of the blocks
    `counted` marks, summed over the gang by one all-reduce (a functional
    collective, so that a compiled update holds it)."""
    import torch.distributed as dist
    from torch.distributed import _functional_collectives as funcol

    squares = torch.stack([
        torch.linalg.vector_norm(x, dtype=torch.float32) ** 2 if c else
        torch.zeros((), dtype=torch.float32, device=x.device)
        for x, c in zip(blocks, counted)]).sum()
    return torch.sqrt(funcol.all_reduce(squares, "sum", dist.group.WORLD))


def _zeros_like(x):
    """torch.zeros_like, for a DTensor made from its local block (no
    sharding propagation, no communication)."""
    if not _is_dtensor(x):
        return torch.zeros_like(x)
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(torch.zeros_like(x.to_local()), x.device_mesh,
                              x.placements, run_check=False, shape=x.shape,
                              stride=x.stride())


@dataclasses.dataclass
class AdamWState:
    """optax's ScaleByAdamState: the number of updates taken and the first
    and second moments, in the parameters' structure."""
    count: int
    mu: Dict[str, Any]
    nu: Dict[str, Any]


@torch.no_grad()
def _adamw_(p, g, mu, nu, count, lr, b1, b2, eps, weight_decay) -> None:
    """One AdamW update of the lists p, mu and nu in place from g. count is
    the update's number as a 0-d fp32 tensor on the parameters' device, so
    the bias corrections are computed there in fp32, as optax computes them,
    and a compiled update takes every step with one program."""
    bc1, bc2 = 1.0 - b1 ** count, 1.0 - b2 ** count
    torch._foreach_lerp_(mu, g, 1.0 - b1)
    torch._foreach_mul_(nu, b2)
    torch._foreach_addcmul_(nu, g, g, 1.0 - b2)
    if weight_decay:
        torch._foreach_mul_(p, 1.0 - lr * weight_decay)
    # p -= lr * (mu / bc1) / (sqrt(nu / bc2) + eps), as p += mu / denom with
    # denom = (sqrt(nu / bc2) + eps) * (-bc1 / lr): the step size folded
    # into the denominator, so eagerly it takes as many passes over the
    # parameters as with a number for the step size.
    denom = torch._foreach_sqrt(nu)
    torch._foreach_mul_(denom, -bc1 / (lr * torch.sqrt(bc2)))
    # tensor by tensor: the list-and-tensor _foreach_add_ reads its tensor
    # on the host, which a CUDA graph's capture refuses (DreamerV3's step)
    shift = -eps * bc1 / lr
    for d in denom:
        d.add_(shift)
    torch._foreach_addcdiv_(p, mu, denom)


def _norm_and_adamw_(p, g, mu, nu, count, counted, *hyper) -> torch.Tensor:
    """The global norm of g, then `_adamw_`: the optimizer's half of a
    step. counted None: g holds whole gradients (`global_norm`); else
    each rank's local blocks of DTensor gradients, and counted marks the
    blocks that add to the norm (`_blocks_norm`): the update of a block is
    the update of the whole tensor's elements; only the norm needs the
    gang."""
    norm = global_norm(g) if counted is None else _blocks_norm(g, counted)
    _adamw_(p, g, mu, nu, count, *hyper)
    return norm


@dataclasses.dataclass(frozen=True)
class AdamW:
    """`optax.adamw`'s signature and defaults (weight_decay 1e-4)."""
    learning_rate: float
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 1e-4

    def init(self, params) -> AdamWState:
        """Zero moments in the parameters' structure; a DTensor
        parameter's moments are DTensors in its placements."""
        return AdamWState(0, tree_map(_zeros_like, params),
                          tree_map(_zeros_like, params))

    def updater(self, backend: Optional[str] = None
                ) -> Callable[[Any, AdamWState, Any], torch.Tensor]:
        """-> update(grads, state, params) -> global_norm(grads): one AdamW
        update of `params` and `state` in place. With a backend the norm
        and the update run as one program that torch.compile builds with
        it (fullgraph, static shapes); without one they run eagerly. The
        function's `lower(grads, state, params)` hands the collectives of
        the compiled program to `parallel.hlo_report`."""
        hyper = (self.learning_rate, self.b1, self.b2, self.eps,
                 self.weight_decay)
        fn = _norm_and_adamw_
        programs: list = []  # per compile, its collectives
        if backend is not None:
            from ray_tpu_torch.parallel.hlo_report import recording

            # Inductor's loop reordering after fusion fails an internal
            # assertion on this program at some shapes (torch 2.11, the tiny
            # fp32 config); it only picks loop orders, so it is turned off.
            fn = torch.compile(fn, backend=recording(
                backend, programs, {"loop_ordering_after_fusion": False}),
                fullgraph=True, dynamic=False)

        def run(grads, state: AdamWState, params, count: int, copy):
            p, g = tree_leaves(params), tree_leaves(grads)
            count = torch.full((), count, dtype=torch.float32,
                               device=_local(p[0]).device)
            if any(_is_dtensor(x) for x in p):
                return fn(copy(local_leaves(p)), local_leaves(g),
                          copy(local_leaves(state.mu)),
                          copy(local_leaves(state.nu)), count, _counted(p),
                          *hyper)
            return fn(copy(p), g, copy(tree_leaves(state.mu)),
                      copy(tree_leaves(state.nu)), count, None, *hyper)

        def update(grads, state: AdamWState, params) -> torch.Tensor:
            state.count += 1
            return run(grads, state, params, state.count, lambda xs: xs)

        def lower(grads, state: AdamWState, params) -> list:
            """The collectives of the compiled program (none eagerly),
            compiled first on copies of the parameters and moments if it
            has not been: `params` and `state` stay as they were."""
            if backend is not None and not programs:
                with torch.no_grad():
                    run(grads, state, params, state.count + 1,
                        lambda xs: [x.clone() for x in xs])
            return programs[-1] if programs else []

        update.programs, update.lower = programs, lower
        return update

    def update_(self, grads, state: AdamWState, params) -> None:
        """One eager AdamW update of `params` (and of `state`) in place;
        `grads` holds the parameters' gradients in their order (a tree like
        params, or the list of its leaves)."""
        self.updater()(grads, state, params)


adamw = AdamW  # called by optax's name: adamw(learning_rate, ...)
