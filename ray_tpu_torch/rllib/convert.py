"""Carry the JAX RL modules' parameters and optax Adam state into the port.

`jax.random` cannot be reproduced in torch, so a parity check makes the
parameters with a JAX module's `init`, pulls the pytree to numpy
(`jax.device_get`) and hands it here. The JAX pytree's keys name the
port's submodules (`torso/0/w` is `torso.0.weight`); dense weights are
[in, out] in JAX and [out, in] in `nn.Linear`, conv kernels HWIO in JAX
and OIHW in `nn.Conv2d`. Other leaves (SAC's `log_alpha`) keep their name
and layout. The Adam state (`count`, `mu`, `nu` of optax's
ScaleByAdamState) comes across the same way, so a resumed update matches.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch
from torch import nn

from ray_tpu_torch.train.optim import AdamWState


def _torch_layout(key: str, arr: np.ndarray) -> Tuple[str, np.ndarray]:
    if key == "w":
        if arr.ndim == 2:
            return "weight", arr.T
        if arr.ndim == 4:
            return "weight", arr.transpose(3, 2, 0, 1)
        raise ValueError(f"a weight of shape {arr.shape}")
    if key == "b":
        return "bias", arr
    return key, arr


def _jax_layout(key: str, arr: np.ndarray) -> Tuple[str, np.ndarray]:
    if key == "weight":
        return "w", arr.T if arr.ndim == 2 else arr.transpose(2, 3, 1, 0)
    if key == "bias":
        return "b", arr
    return key, arr


def _leaves(tree, path=()) -> Iterator[Tuple[tuple, Any]]:
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (str(i),))
    else:
        yield path, tree


def state_from_jax_numpy(tree) -> Dict[str, np.ndarray]:
    """A JAX module's params pytree (numpy) -> {parameter name: fp32 array
    in the port's layout}."""
    out = {}
    for path, leaf in _leaves(tree):
        key, arr = _torch_layout(path[-1], np.asarray(leaf, np.float32))
        out[".".join(path[:-1] + (key,))] = np.array(arr, order="C")
    return out


def load_jax_numpy(module: nn.Module, tree) -> nn.Module:
    """Copy a JAX params pytree into `module`'s parameters (on its device);
    every parameter must be given, with its shape."""
    state = state_from_jax_numpy(tree)
    params = dict(module.named_parameters())
    if set(state) != set(params):
        raise ValueError(f"parameters {sorted(set(params) ^ set(state))} "
                         "are in only one of the module and the pytree")
    with torch.no_grad():
        for name, arr in state.items():
            p = params[name]
            if tuple(arr.shape) != tuple(p.shape):
                raise ValueError(f"{name}: shape {arr.shape}, module has "
                                 f"{tuple(p.shape)}")
            p.copy_(torch.from_numpy(arr))
    return module


def to_jax_layout(named) -> Dict[str, Any]:
    """{name: tensor} (a module's `named_parameters()`, or a state dict) ->
    the JAX pytree of numpy arrays: the inverse of `state_from_jax_numpy`."""
    tree: Dict[str, Any] = {}
    for name, t in dict(named).items():
        *path, key = name.split(".")
        key, arr = _jax_layout(key, t.detach().cpu().numpy())
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[key] = arr
    return _lists(tree)


def _lists(node):
    """Dicts keyed 0..n-1 (ModuleLists) become lists, as in the pytree."""
    if not isinstance(node, dict):
        return node
    node = {k: _lists(v) for k, v in node.items()}
    if node and all(k.isdigit() for k in node):
        return [node[str(i)] for i in range(len(node))]
    return node


def _adam_state(opt_state):
    """optax's ScaleByAdamState (count, mu, nu) in a chain's state."""
    if hasattr(opt_state, "mu") and hasattr(opt_state, "nu"):
        return opt_state
    if isinstance(opt_state, (list, tuple)):
        found = [s for s in (_adam_state(x) for x in opt_state)
                 if s is not None]
        if len(found) > 1:
            raise ValueError("more than one Adam state in the chain")
        return found[0] if found else None
    return None


def adam_state_from_jax_numpy(module: nn.Module, opt_state) -> AdamWState:
    """A numpy optax state of `optax.adam` (alone or in a chain after
    `clip_by_global_norm`) over a module's params -> the port's AdamWState,
    its moments listed in `module.parameters()` order on its device."""
    adam = _adam_state(opt_state)
    if adam is None:
        raise ValueError("no ScaleByAdamState (count, mu, nu) in the "
                         f"optimizer state {type(opt_state).__name__}")
    names = [n for n, _ in module.named_parameters()]
    device = next(module.parameters()).device

    def moments(tree):
        state = state_from_jax_numpy(tree)
        return [torch.from_numpy(state[n]).to(device) for n in names]

    return AdamWState(count=int(np.asarray(adam.count)),
                      mu=moments(adam.mu), nu=moments(adam.nu))


def adam_state_to_jax_layout(module: nn.Module, state: AdamWState):
    """-> (count, mu, nu) with the moments as JAX pytrees of numpy."""
    names = [n for n, _ in module.named_parameters()]
    return (state.count, to_jax_layout(zip(names, state.mu)),
            to_jax_layout(zip(names, state.nu)))
