"""Carry the JAX package's Llama weights into the port.

`jax.random` cannot be reproduced in torch, so a parity check makes weights
with the JAX `llama.init`, pulls the pytree to numpy (`jax.device_get`) and
hands it here. The layouts already agree: layers stacked on the leading L
axis, `wq/wk/wv` as [d_model, H, D] and `wo` as [H, D, d_model].
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch.models.llama import LlamaConfig, param_shapes


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
