"""Carry the JAX package's Llama weights and AdamW state into the port.

`jax.random` cannot be reproduced in torch, so a parity check makes weights
with the JAX `llama.init`, pulls the pytree to numpy (`jax.device_get`) and
hands it here. The layouts already agree: layers stacked on the leading L
axis, `wq/wk/wv` as [d_model, H, D] and `wo` as [H, D, d_model]. A JAX
training state resumes in the port with the weights and the `optax.adamw`
state carried across.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch.models.llama import LlamaConfig, param_shapes
from ray_tpu_torch.train.optim import AdamWState


def params_from_jax_numpy(tree: Dict[str, Any], config: LlamaConfig,
                          device=None) -> Dict[str, Any]:
    """numpy pytree of `ray_tpu.models.llama.init` -> the port's parameters
    in `config.dtype` on `device`. bf16 arrives as ml_dtypes' bfloat16 and
    goes through fp32, which holds every bf16 value exactly."""
    dev = resolve_device(device)

    def convert(path, arr, shape):
        arr = np.asarray(arr)
        if arr.shape != shape:
            raise ValueError(f"{path}: shape {arr.shape}, config wants {shape}")
        return torch.from_numpy(np.array(arr, dtype=np.float32, order="C")
                                ).to(device=dev, dtype=config.dtype)

    shapes = param_shapes(config)
    return {
        name: ({n: convert(f"layers/{n}", tree["layers"][n], s)
                for n, s in shape.items()}
               if name == "layers" else convert(name, tree[name], shape))
        for name, shape in shapes.items()
    }


def adamw_state_from_jax_numpy(opt_state_tree, config: LlamaConfig,
                               device=None) -> AdamWState:
    """numpy `optax.adamw` state of Llama parameters -> the port's
    AdamWState on `device`, so a JAX run resumes in the port. Takes the
    whole chain state (scale_by_adam, add_decayed_weights,
    scale_by_learning_rate) or its ScaleByAdamState alone; count, mu and
    nu are carried, the moments in config.dtype as optax keeps them in the
    parameters' dtype."""
    adam = opt_state_tree
    if not hasattr(adam, "mu"):
        found = [s for s in adam if hasattr(s, "mu") and hasattr(s, "nu")]
        if len(found) != 1:
            raise ValueError("no single ScaleByAdamState (count, mu, nu) in "
                             f"the optimizer state {type(adam).__name__}")
        adam = found[0]
    return AdamWState(
        count=int(np.asarray(adam.count)),
        mu=params_from_jax_numpy(adam.mu, config, device),
        nu=params_from_jax_numpy(adam.nu, config, device))
