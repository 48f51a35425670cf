"""Carry the JAX package's weights and AdamW state into the port.

`jax.random` cannot be reproduced in torch, so a parity check makes weights
with a JAX model's `init`, pulls the pytree to numpy (`jax.device_get`) and
hands it here with the port's config of the same model: Llama, Mixtral,
ViT, T5 or the MLP. The layouts already agree: layers stacked on the
leading L axis (Mixtral's experts on a second axis E: experts/w_* [L, E, D,
F], moe_gate [L, D, E]), `wq/wk/wv` as [d_model, H, D] and `wo` as [H, D,
d_model], the MLP's layers a list. A JAX training state resumes in the
port with the weights and the `optax.adamw` state carried across.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch.train.optim import AdamWState


def param_shapes(config) -> Dict[str, Any]:
    """The parameter shapes of the model whose config this is."""
    from ray_tpu_torch.models import llama, mixtral, mlp, t5, vit

    # Mixtral's config is a Llama config: it is looked up first.
    for cls, module in ((mixtral.MixtralConfig, mixtral),
                        (llama.LlamaConfig, llama), (vit.ViTConfig, vit),
                        (t5.T5Config, t5), (mlp.MLPConfig, mlp)):
        if isinstance(config, cls):
            return module.param_shapes(config)
    raise TypeError(f"no model of the port takes a {type(config).__name__}")


def params_from_jax_numpy(tree: Dict[str, Any], config,
                          device=None) -> Dict[str, Any]:
    """numpy pytree of the JAX model's `init` -> the port's parameters in
    `config.dtype` on `device`. bf16 arrives as ml_dtypes' bfloat16 and
    goes through fp32, which holds every bf16 value exactly."""
    dev = resolve_device(device)

    def convert(path, node, shape):
        if isinstance(shape, dict):
            return {n: convert(f"{path}/{n}", node[n], s)
                    for n, s in shape.items()}
        if isinstance(shape, list):
            if len(node) != len(shape):
                raise ValueError(f"{path}: {len(node)} entries, config "
                                 f"wants {len(shape)}")
            return [convert(f"{path}/{i}", n, s)
                    for i, (n, s) in enumerate(zip(node, shape))]
        arr = np.asarray(node)
        if arr.shape != shape:
            raise ValueError(f"{path}: shape {arr.shape}, config wants "
                             f"{shape}")
        return torch.from_numpy(np.array(arr, dtype=np.float32, order="C")
                                ).to(device=dev, dtype=config.dtype)

    return {name: convert(name, tree[name], shape)
            for name, shape in param_shapes(config).items()}


def adamw_state_from_jax_numpy(opt_state_tree, config,
                               device=None) -> AdamWState:
    """numpy `optax.adamw` state of a model's parameters -> the port's
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
