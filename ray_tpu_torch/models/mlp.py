"""Minimal MLP (MNIST-class) in PyTorch.

Counterpart of `ray_tpu/models/mlp.py`: ReLU between the layers, none
after the last; the layers a list of {"w", "b"} as in the JAX pytree.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Sequence

import torch

from ray_tpu_torch.models import llama


@dataclasses.dataclass(frozen=True)
class MLPConfig:
    in_dim: int = 784
    hidden: Sequence[int] = (256, 256)
    out_dim: int = 10
    dtype: torch.dtype = torch.float32


def param_shapes(config: MLPConfig) -> Dict[str, Any]:
    dims = [config.in_dim, *config.hidden, config.out_dim]
    return {"layers": [{"w": (d_in, d_out), "b": (d_out,)}
                       for d_in, d_out in zip(dims[:-1], dims[1:])]}


def init(config: MLPConfig, generator: torch.Generator,
         device=None) -> Dict[str, Any]:
    """Weights normal * fan_in ** -0.5, biases at zero. `generator` lives
    on `device`."""
    return llama.random_params(
        param_shapes(config),
        lambda name, shape: shape[0] ** -0.5 if name == "w" else 0,
        generator, config.dtype, device)


def forward(params, x, config: MLPConfig):
    layers = params["layers"]
    for i, layer in enumerate(layers):
        x = x @ layer["w"] + layer["b"]
        if i < len(layers) - 1:
            x = torch.relu(x)
    return x


def loss_fn(params, batch, config: MLPConfig):
    """Softmax cross-entropy. batch: {"x": [B, in_dim], "y": [B]}."""
    logits = forward(params, batch["x"], config)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, batch["y"][:, None].long())[:, 0]
    return torch.mean(nll)


def accuracy(params, batch, config: MLPConfig):
    logits = forward(params, batch["x"], config)
    return torch.mean((torch.argmax(logits, -1) == batch["y"]).float())
