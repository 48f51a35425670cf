"""Training step: parameters, optimizer state and an AdamW step.

Counterpart of `ray_tpu/train/step.py`. On one device the JAX step is one
jitted program
that donates the state's buffers; here the step is two programs that
`torch.compile` builds, with eager glue between them: the loss with its
backward (AOTAutograd compiles the backward; the flash kernels are custom
operators inside both) and the global norm with the AdamW update. The
update writes the parameter and moment tensors in place: the state a step
returns holds the same tensors as the state it was given. The sharded step
(DTensor parameters on a mesh) is compiled the same way. The eager step
stays as an explicit choice. Metrics stay on the device; nothing in the
step waits for the card.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import torch

from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch.parallel import hlo_report
from ray_tpu_torch.train.optim import AdamW, tree_leaves


@dataclasses.dataclass
class TrainState:
    params: Any
    opt_state: Any
    step: torch.Tensor  # int32 scalar on the parameters' device


def init_train_state(init_fn: Callable[[torch.device], Any],
                     optimizer: AdamW, device=None, *,
                     param_logical_axes=None, mesh=None,
                     rules=None) -> TrainState:
    """init_fn(device) -> params (e.g. functools.partial(llama.init, config,
    generator)); returns the state with fresh optimizer moments and step 0.
    The device defaults to cuda and raises without it.

    With a mesh the parameters become DTensors in the shardings that
    `param_logical_axes` and `rules` give them (init_fn must give every
    rank the same values, as one seed does), and so do the moments."""
    dev = resolve_device(device)
    params = init_fn(dev)
    for leaf in tree_leaves(params):
        if leaf.device.type != dev.type:
            raise ValueError(f"init_fn put a parameter on {leaf.device}, "
                             f"not {dev}")
    if mesh is not None:
        if param_logical_axes is None:
            raise ValueError("a sharded state needs param_logical_axes")
        from ray_tpu_torch.parallel.sharding import shard_params

        params = shard_params(params, param_logical_axes, mesh, rules)
    return TrainState(params, optimizer.init(params),
                      torch.zeros((), dtype=torch.int32, device=dev))


def make_train_step(loss_fn: Callable[[Any, Any], torch.Tensor],
                    optimizer: AdamW, *, compiled: bool = True,
                    backend: str = "inductor"):
    """loss_fn(params, batch) -> scalar loss; returns step(state, batch) ->
    (state, {"loss", "grad_norm", "step"}), the metrics device tensors.

    compiled (the default, as the JAX step is always jitted): the loss and
    its backward, and the norm and update, each one torch.compile program
    (fullgraph, static shapes) built by `backend` on the first step; a
    failure to compile raises. Over a state of DTensors (the sharded step)
    the first program takes the DTensor parameters and holds the
    collectives the sharded loss says, and the second updates each rank's
    local blocks, the global norm's all-reduce inside it. compiled=False
    runs the same functions eagerly. The compiled step's `lower(state,
    batch)` hands `parallel.hlo_report` the collectives of its programs."""
    programs: list = []  # per compile of the loss, its collectives
    if compiled:
        loss_fn = torch.compile(loss_fn, backend=hlo_report.recording(
            backend, programs), fullgraph=True, dynamic=False)
    update = optimizer.updater(backend if compiled else None)

    def loss_and_grads(state: TrainState, batch):
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
        return loss, grads

    def step(state: TrainState, batch) -> Tuple[TrainState, Dict[str, Any]]:
        loss, grads = loss_and_grads(state, batch)
        grad_norm = update(grads, state.opt_state, state.params)
        new_step = state.step + 1
        return (TrainState(state.params, state.opt_state, new_step),
                {"loss": loss.detach(), "grad_norm": grad_norm,
                 "step": new_step})

    def lower(state: TrainState, batch) -> list:
        """The collectives of the step's two compiled programs on (state,
        batch) (`parallel.hlo_report.collectives`), as their last compile
        noted them; a program the step has not compiled yet is compiled
        here on a run that leaves the state as it was (the loss and its
        gradients; the update on copies of the state)."""
        if not compiled:
            raise ValueError("a collective report reads the compiled "
                             "step's programs; this step is eager")
        grads = None
        if not programs or not update.programs:
            grads = loss_and_grads(state, batch)[1]
        return programs[-1] + update.lower(grads, state.opt_state,
                                           state.params)

    step.lower = lower
    return step
