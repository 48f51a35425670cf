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
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional

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


def global_norm(grads) -> torch.Tensor:
    """sqrt(sum of squares) over every leaf, accumulated in fp32 on the
    leaves' device: the counterpart of `optax.global_norm`."""
    norms = [torch.linalg.vector_norm(g, dtype=torch.float32)
             for g in tree_leaves(grads)]
    return torch.linalg.vector_norm(torch.stack(norms))


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
    torch._foreach_add_(denom, -eps * bc1 / lr)
    torch._foreach_addcdiv_(p, mu, denom)


def _norm_and_adamw_(p, g, mu, nu, count, *hyper) -> torch.Tensor:
    """global_norm(g), then `_adamw_`: the optimizer's half of a step."""
    norm = global_norm(g)
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
        return AdamWState(0, tree_map(torch.zeros_like, params),
                          tree_map(torch.zeros_like, params))

    def updater(self, backend: Optional[str] = None
                ) -> Callable[[Any, AdamWState, Any], torch.Tensor]:
        """-> update(grads, state, params) -> global_norm(grads): one AdamW
        update of `params` and `state` in place. With a backend the norm
        and the update run as one program that torch.compile builds with
        it (fullgraph, static shapes); without one they run eagerly."""
        hyper = (self.learning_rate, self.b1, self.b2, self.eps,
                 self.weight_decay)
        fn = _norm_and_adamw_
        if backend is not None:
            # Inductor's loop reordering after fusion fails an internal
            # assertion on this program at some shapes (torch 2.11, the tiny
            # fp32 config); it only picks loop orders, so it is turned off.
            options = ({"loop_ordering_after_fusion": False}
                       if backend == "inductor" else None)
            fn = torch.compile(fn, backend=backend, fullgraph=True,
                               dynamic=False, options=options)

        def update(grads, state: AdamWState, params) -> torch.Tensor:
            p, g = tree_leaves(params), tree_leaves(grads)
            state.count += 1
            count = torch.full((), state.count, dtype=torch.float32,
                               device=p[0].device)
            return fn(p, g, tree_leaves(state.mu), tree_leaves(state.nu),
                      count, *hyper)

        return update

    def update_(self, grads, state: AdamWState, params) -> None:
        """One eager AdamW update of `params` (and of `state`) in place;
        `grads` holds the parameters' gradients in their order (a tree like
        params, or the list of its leaves)."""
        self.updater()(grads, state, params)


adamw = AdamW  # called by optax's name: adamw(learning_rate, ...)
