"""RL modules: the policy and value networks as `nn.Module`s.

Counterpart of `ray_tpu/rllib/rl_module.py`, whose modules are functions
over a params pytree. Here each module owns its parameters on an explicit
device and keeps the JAX module's API: `forward`, and for the actor-critic
modules `forward_inference` / `forward_exploration` / `forward_train`.
Sampling takes a `torch.Generator` on the module's device (torch cannot
reproduce `jax.random`'s draws; everything downstream of the actions is
the same function). The submodules are named as the JAX pytree's keys
(`torso.0`, `pi`, `vf`, `convs.1`, `layers.2`, `mu`, `log_std`), so
`rllib/convert.py` maps `torso/0/w` to `torso.0.weight`.

The conv module takes NHWC observations, as the JAX module does, and
flattens its last feature map in NHWC order, so the first torso weight's
rows are the JAX rows. uint8 observations ship raw and are divided by 255
on the device.

Precision: fp32, as in JAX. The port sets no global flag, so on the card
the matrix products run in full fp32 (torch's default) and the
convolutions follow `torch.backends.cudnn.allow_tf32` (torch's default:
TF32); `chip_smoke.py` turns TF32 off for both before it holds the card
against the CPU.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ray_tpu_torch._private.device import resolve_device

DEFAULT_CONV_FILTERS = ((32, 8, 4), (64, 4, 2), (64, 3, 1))


def _linear(in_dim: int, out_dim: int, gen: torch.Generator,
            scale: Optional[float] = None) -> nn.Linear:
    """JAX's `_dense_init`: weights normal * scale (default sqrt(2 / in)),
    biases zero."""
    layer = nn.Linear(in_dim, out_dim)
    scale = scale if scale is not None else math.sqrt(2.0 / in_dim)
    with torch.no_grad():
        layer.weight.copy_(torch.randn((out_dim, in_dim), generator=gen)
                           * scale)
        layer.bias.zero_()
    return layer


def _init_generator(generator: Optional[torch.Generator]) -> torch.Generator:
    """Parameters are drawn on the CPU and then moved, so one seed gives
    the same weights on every device."""
    return generator if generator is not None else torch.Generator()


class _Module(nn.Module):
    """Moves the built parameters to the resolved device."""

    def _place(self, device) -> None:
        self.to(resolve_device(device))


class _ActorCritic(_Module):
    """A torso, a policy logits head `pi` and a value head `vf`, with the
    RLModule API over them."""

    def _heads(self, dims, gen: torch.Generator) -> None:
        """The dense torso over dims and the two heads on its output."""
        self.torso = nn.ModuleList(_linear(a, b, gen)
                                   for a, b in zip(dims[:-1], dims[1:]))
        self.pi = _linear(dims[-1], self.num_actions, gen, scale=0.01)
        self.vf = _linear(dims[-1], 1, gen, scale=1.0)

    def forward(self, obs) -> Tuple[torch.Tensor, torch.Tensor]:
        """-> (logits [B, A], value [B])"""
        x = self._torso(obs)
        return self.pi(x), self.vf(x)[..., 0]

    def forward_inference(self, batch: Dict[str, Any]):
        logits, _ = self(batch["obs"])
        return {"actions": torch.argmax(logits, dim=-1)}

    def forward_exploration(self, batch: Dict[str, Any],
                            generator: Optional[torch.Generator] = None):
        """A categorical draw by the Gumbel-max trick, as
        `jax.random.categorical` draws."""
        logits, value = self(batch["obs"])
        u = torch.rand(logits.shape, generator=generator,
                       device=logits.device).clamp_(min=1e-20)
        actions = torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)
        logp = torch.log_softmax(logits, dim=-1).gather(
            -1, actions[:, None])[:, 0]
        return {"actions": actions, "logp": logp, "vf_preds": value}

    def forward_train(self, batch: Dict[str, Any]):
        logits, value = self(batch["obs"])
        logp_all = torch.log_softmax(logits, dim=-1)
        logp = logp_all.gather(-1, batch["actions"].long()[:, None])[:, 0]
        entropy = -torch.sum(torch.exp(logp_all) * logp_all, dim=-1)
        return {"logp": logp, "vf_preds": value, "entropy": entropy,
                "logits": logits}


class DiscreteActorCriticModule(_ActorCritic):
    """MLP torso (tanh) + policy logits head + value head."""

    def __init__(self, obs_dim: int, num_actions: int,
                 hiddens: Sequence[int] = (64, 64), *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.obs_dim = obs_dim
        self.num_actions = num_actions
        self.hiddens = tuple(hiddens)
        self._heads([obs_dim] + list(self.hiddens),
                    _init_generator(generator))
        self._place(device)

    def _torso(self, obs):
        x = obs
        for layer in self.torso:
            x = torch.tanh(layer(x))
        return x


class ConvActorCriticModule(_ActorCritic):
    """Conv torso (the Nature-CNN family) + policy/value heads for image
    observations [B, H, W, C], uint8 or float; conv_filters are (out_ch,
    kernel, stride) triples with VALID padding."""

    def __init__(self, obs_shape: Sequence[int], num_actions: int,
                 conv_filters: Sequence[Tuple[int, int, int]] = (
                     DEFAULT_CONV_FILTERS),
                 hiddens: Sequence[int] = (512,), *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.obs_shape = tuple(obs_shape)
        self.num_actions = num_actions
        self.conv_filters = tuple(tuple(f) for f in conv_filters)
        self.hiddens = tuple(hiddens)
        h, w, c = self.obs_shape
        for _out, k, s in self.conv_filters:
            h = (h - k) // s + 1
            w = (w - k) // s + 1
            if h <= 0 or w <= 0:
                raise ValueError(
                    f"conv_filters {conv_filters} reduce a {self.obs_shape}"
                    " observation below 1x1; use smaller kernels/strides")
        self._flat_dim = h * w * self.conv_filters[-1][0]
        gen = _init_generator(generator)
        convs, in_ch = [], c
        for out_ch, k, s in self.conv_filters:
            conv = nn.Conv2d(in_ch, out_ch, k, stride=s)
            with torch.no_grad():
                conv.weight.copy_(torch.randn((out_ch, in_ch, k, k),
                                              generator=gen)
                                  * math.sqrt(2.0 / (k * k * in_ch)))
                conv.bias.zero_()
            convs.append(conv)
            in_ch = out_ch
        self.convs = nn.ModuleList(convs)
        self._heads([self._flat_dim] + list(self.hiddens), gen)
        self._place(device)

    def _torso(self, obs):
        x = obs.float()
        if obs.dtype == torch.uint8:
            x = x / 255.0
        # NHWC viewed as NCHW: a channels-last tensor, which cuDNN takes
        # as it is; the last map goes back to NHWC for the JAX flatten.
        x = x.permute(0, 3, 1, 2)
        for conv in self.convs:
            x = F.relu(conv(x))
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        for layer in self.torso:
            x = F.relu(layer(x))
        return x


class QModule(_Module):
    """MLP Q-network (tanh) for DQN-family algorithms."""

    def __init__(self, obs_dim: int, num_actions: int,
                 hiddens: Sequence[int] = (64, 64), *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.obs_dim = obs_dim
        self.num_actions = num_actions
        self.hiddens = tuple(hiddens)
        gen = _init_generator(generator)
        dims = [obs_dim] + list(self.hiddens) + [num_actions]
        self.layers = nn.ModuleList(_linear(a, b, gen)
                                    for a, b in zip(dims[:-1], dims[1:]))
        self._place(device)

    def forward(self, obs) -> torch.Tensor:
        x = obs
        for layer in self.layers[:-1]:
            x = torch.tanh(layer(x))
        return self.layers[-1](x)


class GaussianActorModule(_Module):
    """Squashed-Gaussian policy for continuous actions (SAC's actor)."""

    def __init__(self, obs_dim: int, act_dim: int,
                 hiddens: Sequence[int] = (256, 256),
                 log_std_bounds=(-10.0, 2.0), *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.obs_dim = obs_dim
        self.act_dim = act_dim
        self.hiddens = tuple(hiddens)
        self.log_std_bounds = log_std_bounds
        gen = _init_generator(generator)
        dims = [obs_dim] + list(self.hiddens)
        self.torso = nn.ModuleList(_linear(a, b, gen)
                                   for a, b in zip(dims[:-1], dims[1:]))
        self.mu = _linear(dims[-1], act_dim, gen, scale=0.01)
        self.log_std = _linear(dims[-1], act_dim, gen, scale=0.01)
        self._place(device)

    def dist(self, obs) -> Tuple[torch.Tensor, torch.Tensor]:
        """-> (mean, log_std clipped to log_std_bounds)"""
        x = obs
        for layer in self.torso:
            x = F.relu(layer(x))
        lo, hi = self.log_std_bounds
        return self.mu(x), torch.clamp(self.log_std(x), lo, hi)

    def forward(self, obs, eps: torch.Tensor):
        """-> (action in [-1, 1], log_prob) for the standard-normal noise
        `eps` [B, act_dim], with the tanh squash correction."""
        mu, log_std = self.dist(obs)
        pre = mu + torch.exp(log_std) * eps
        act = torch.tanh(pre)
        logp = torch.sum(
            -0.5 * (eps ** 2 + 2 * log_std + math.log(2 * math.pi))
            - torch.log(torch.clamp(1 - act ** 2, min=1e-6)), dim=-1)
        return act, logp

    def sample(self, obs, generator: Optional[torch.Generator] = None):
        """-> (action, log_prob) with the noise drawn from `generator`."""
        eps = torch.randn((obs.shape[0], self.act_dim), generator=generator,
                          device=obs.device)
        return self(obs, eps)

    def forward_exploration(self, batch, generator=None):
        act, logp = self.sample(batch["obs"], generator)
        return {"actions": act, "logp": logp,
                "vf_preds": torch.zeros(act.shape[0], device=act.device)}

    def forward_inference(self, batch):
        mu, _ = self.dist(batch["obs"])
        return {"actions": torch.tanh(mu)}


class ContinuousQModule(_Module):
    """Q(s, a) for continuous control (SAC's critics)."""

    def __init__(self, obs_dim: int, act_dim: int,
                 hiddens: Sequence[int] = (256, 256), *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.obs_dim = obs_dim
        self.act_dim = act_dim
        self.hiddens = tuple(hiddens)
        gen = _init_generator(generator)
        dims = [obs_dim + act_dim] + list(self.hiddens) + [1]
        self.layers = nn.ModuleList(_linear(a, b, gen)
                                    for a, b in zip(dims[:-1], dims[1:]))
        self._place(device)

    def forward(self, obs, act) -> torch.Tensor:
        x = torch.cat([obs, act], dim=-1)
        for layer in self.layers[:-1]:
            x = F.relu(layer(x))
        return self.layers[-1](x)[..., 0]


def apply_encoder(enc: Dict[str, Any], obs):
    """The catalog's observation encoders (flatten / one-hot / dict- or
    tuple-concat) -> a [B, D] float tensor."""
    kind = enc["kind"]
    if kind == "mlp":
        return obs
    if kind == "flatten":
        return obs.reshape(obs.shape[0], -1).float()
    if kind == "onehot":
        return F.one_hot(obs.long(), enc["n"]).float()
    if kind == "concat":
        parts = []
        for key, leaf in enc["leaves"]:
            sub = obs[key] if enc["container"] == "dict" else obs[int(key)]
            parts.append(apply_encoder(leaf, sub))
        return torch.cat(parts, dim=-1)
    raise ValueError(f"unknown encoder kind {kind!r}")


class EncodedActorCriticModule(DiscreteActorCriticModule):
    """Actor-critic over a catalog encoder."""

    def __init__(self, encoder_spec: Dict[str, Any], num_actions: int,
                 hiddens: Sequence[int] = (64, 64), *, device=None,
                 generator: Optional[torch.Generator] = None):
        from ray_tpu_torch.rllib.catalog import Catalog

        self.encoder_spec = encoder_spec
        super().__init__(Catalog.encoded_dim(encoder_spec), num_actions,
                         hiddens, device=device, generator=generator)

    def _torso(self, obs):
        return super()._torso(apply_encoder(self.encoder_spec, obs))


class EncodedQModule(QModule):
    """Q-network over a catalog encoder."""

    def __init__(self, encoder_spec: Dict[str, Any], num_actions: int,
                 hiddens: Sequence[int] = (64, 64), *, device=None,
                 generator: Optional[torch.Generator] = None):
        from ray_tpu_torch.rllib.catalog import Catalog

        self.encoder_spec = encoder_spec
        super().__init__(Catalog.encoded_dim(encoder_spec), num_actions,
                         hiddens, device=device, generator=generator)

    def forward(self, obs) -> torch.Tensor:
        return super().forward(apply_encoder(self.encoder_spec, obs))


def _resolve_class(cls):
    """A class, or "module:ClassName" of the port. A spec naming a module
    of the JAX package is refused: its class would build a JAX module."""
    if not isinstance(cls, str):
        return cls
    import importlib

    mod, _, name = cls.rpartition(":")
    if mod == "ray_tpu" or mod.startswith("ray_tpu."):
        raise ValueError(
            f"module spec {cls!r} names the JAX package; the port builds "
            f"its own modules (ray_tpu_torch.rllib.rl_module:{name})")
    return getattr(importlib.import_module(mod or __name__), name)


def resolve_module(module_spec: Dict[str, Any], *, device=None,
                   generator: Optional[torch.Generator] = None):
    """Build the module named by module_spec['module_class'] (default
    DiscreteActorCriticModule) on `device`, its parameters drawn from
    `generator` (a CPU generator; None draws from a fresh one)."""
    cls = _resolve_class(module_spec.get("module_class",
                                         DiscreteActorCriticModule))
    kw = {"device": device, "generator": generator}
    kwargs = dict(module_spec.get("module_kwargs") or {})
    if cls is ConvActorCriticModule:
        return cls(module_spec["obs_shape"], module_spec["num_actions"],
                   module_spec.get("conv_filters", DEFAULT_CONV_FILTERS),
                   module_spec.get("hiddens", (512,)), **kw)
    if cls is DiscreteActorCriticModule:
        return cls(module_spec["obs_dim"], module_spec["num_actions"],
                   module_spec.get("hiddens", (64, 64)), **kw)
    if kwargs:
        return cls(**kwargs, **kw)
    args = [module_spec["obs_dim"],
            module_spec.get("num_actions") or module_spec["act_dim"]]
    if module_spec.get("hiddens"):
        args.append(tuple(module_spec["hiddens"]))
    return cls(*args, **kw)
