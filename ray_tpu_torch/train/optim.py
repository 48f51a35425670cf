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
(`_foreach`) operations.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List

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
    """A nested dictionary of the same structure with fn(leaf) as leaves."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
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

    @torch.no_grad()
    def update_(self, grads, state: AdamWState, params) -> None:
        """One AdamW update of `params` (and of `state`) in place; `grads`
        holds the parameters' gradients in their order (a tree like params,
        or the list of its leaves)."""
        p, g = tree_leaves(params), tree_leaves(grads)
        mu, nu = tree_leaves(state.mu), tree_leaves(state.nu)
        state.count += 1
        bc1 = 1.0 - self.b1 ** state.count
        bc2 = 1.0 - self.b2 ** state.count
        torch._foreach_lerp_(mu, g, 1.0 - self.b1)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_addcmul_(nu, g, g, 1.0 - self.b2)
        if self.weight_decay:
            torch._foreach_mul_(p, 1.0 - self.learning_rate * self.weight_decay)
        # p -= lr * (mu / bc1) / (sqrt(nu / bc2) + eps)
        denom = torch._foreach_sqrt(nu)
        torch._foreach_div_(denom, math.sqrt(bc2))
        torch._foreach_add_(denom, self.eps)
        torch._foreach_addcdiv_(p, mu, denom, -self.learning_rate / bc1)


adamw = AdamW  # called by optax's name: adamw(learning_rate, ...)
