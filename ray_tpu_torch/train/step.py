"""One-device training step: parameters, optimizer state and an AdamW step.

Counterpart of `ray_tpu/train/step.py` on one device (the mesh shardings
of the JAX package are a later slice). Where the JAX step is one jitted
program that donates the state's buffers, this runs eagerly and updates the
parameter and moment tensors in place: the state a step returns holds the
same tensors as the state it was given. Metrics stay on the device; nothing
in the step waits for the card.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import torch

from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch.train.optim import AdamW, global_norm, tree_leaves


@dataclasses.dataclass
class TrainState:
    params: Any
    opt_state: Any
    step: torch.Tensor  # int32 scalar on the parameters' device


def init_train_state(init_fn: Callable[[torch.device], Any],
                     optimizer: AdamW, device=None) -> TrainState:
    """init_fn(device) -> params (e.g. functools.partial(llama.init, config,
    generator)); returns the state with fresh optimizer moments and step 0.
    The device defaults to cuda and raises without it."""
    dev = resolve_device(device)
    params = init_fn(dev)
    for leaf in tree_leaves(params):
        if leaf.device.type != dev.type:
            raise ValueError(f"init_fn put a parameter on {leaf.device}, "
                             f"not {dev}")
    return TrainState(params, optimizer.init(params),
                      torch.zeros((), dtype=torch.int32, device=dev))


def make_train_step(loss_fn: Callable[[Any, Any], torch.Tensor],
                    optimizer: AdamW):
    """loss_fn(params, batch) -> scalar loss; returns step(state, batch) ->
    (state, {"loss", "grad_norm", "step"}), the metrics device tensors."""

    def step(state: TrainState, batch) -> Tuple[TrainState, Dict[str, Any]]:
        leaves = tree_leaves(state.params)
        for p in leaves:
            p.requires_grad_(True)
        try:
            with torch.enable_grad():
                loss = loss_fn(state.params, batch)
                grads = torch.autograd.grad(loss, leaves)
        finally:
            for p in leaves:
                p.requires_grad_(False)
        grad_norm = global_norm(grads)
        optimizer.update_(grads, state.opt_state, state.params)
        new_step = state.step + 1
        return (TrainState(state.params, state.opt_state, new_step),
                {"loss": loss.detach(), "grad_norm": grad_norm,
                 "step": new_step})

    return step
