"""Learner / LearnerGroup: the port's counterpart of `ray_tpu/rllib/learner.py`.

A `TorchLearner` owns a module (an `nn.Module` on its device), optax's
`adam(lr)` (b1 0.9, b2 0.999, eps 1e-8: the port's AdamW at weight decay 0,
`train/optim.py`), behind `clip_by_global_norm(grad_clip)` when the config
sets one, and the policy version. An update is eager PyTorch: the loss,
`backward`, the clip, then Adam. The clip is optax's formula: the
gradients are scaled by max_norm / ‖g‖ only where ‖g‖ ≥ max_norm (it is
not `clip_grad_norm_`, which divides by ‖g‖ + 1e-6 and always
multiplies).

`LearnerGroup` holds one local learner, or `num_learners` learner actors
of the runtime, built with the actor decorator the config carries
(`AlgorithmConfig.runtime(remote=...)`), each on the card at its position
among the group's learners on its node (`_private/actors.py`). An update
cuts the batch into contiguous shards, one an actor; the driver then sets
the parameter mean of their weights (`parameter_mean`, over host copies,
so that learners on different cards meet on the CPU) on every actor and
averages the metrics, as JAX's group does (`ray_tpu/rllib/learner.py:
89-165`). Each actor keeps its own Adam moments: only the parameters are
averaged.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ray_tpu_torch._private import actors
from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch._private.serialization import install_tensor_wire
from ray_tpu_torch.rllib.algorithm_config import check_local
from ray_tpu_torch.train.optim import AdamW, AdamWState, global_norm


def clip_by_global_norm_(grads, max_norm: float) -> torch.Tensor:
    """optax.clip_by_global_norm in place: where ‖g‖ ≥ max_norm each
    gradient becomes (g / ‖g‖) * max_norm; -> ‖g‖ before the clip. No
    host read: the choice is a `where` on the device."""
    norm = global_norm(grads)
    keep = norm < max_norm
    one = torch.ones_like(norm)
    with torch.no_grad():
        torch._foreach_div_(grads, torch.where(keep, one, norm))
        torch._foreach_mul_(grads, torch.where(keep, one, one * max_norm))
    return norm


def to_tensor(value, device) -> torch.Tensor:
    """A batch column on the device; uint8 images stay uint8 (the module
    divides by 255 there), integer actions become int64 (torch indexes
    with int64), floats fp32."""
    arr = np.asarray(value)
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if arr.dtype == np.float64:
        t = t.float()
    elif arr.dtype.kind in "iu" and arr.dtype != np.uint8:
        t = t.long()
    return t.to(device, non_blocking=True)


def batch_to_device(batch: Dict[str, Any], device) -> Dict[str, Any]:
    return {k: to_tensor(v, device) for k, v in batch.items()}


def metrics_to_host(metrics: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """One device-to-host read for every scalar metric."""
    keys = list(metrics)
    values = torch.stack([metrics[k].detach().float().reshape(())
                          for k in keys]).tolist()
    return dict(zip(keys, values))


class TorchLearner:
    """Owns a module and its optimizer; subclasses define `loss_fn`.

    config: lr (3e-4), grad_clip (None), seed (0), device (None = cuda).
    The module comes built (on any device) and is moved to the learner's.
    """

    def __init__(self, module: nn.Module, config: Dict[str, Any]):
        self.config = config
        self.device = resolve_device(config.get("device"))
        self.module = module.to(self.device)
        self.optimizer = AdamW(config.get("lr", 3e-4), weight_decay=0.0)
        self._update_ = self.optimizer.updater()
        self.grad_clip = config.get("grad_clip")
        self.opt_state = self.optimizer.init(self._params())
        # bumped per update and stamped onto every weight broadcast
        self.policy_version = 0

    @staticmethod
    def init_generator(config: Dict[str, Any]) -> torch.Generator:
        """The CPU generator a learner's module is drawn from."""
        return torch.Generator().manual_seed(config.get("seed") or 0)

    def _params(self):
        return list(self.module.parameters())

    # -- to be overridden ----------------------------------------------------

    def loss_fn(self, batch: Dict[str, torch.Tensor]
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        raise NotImplementedError

    # -- API -----------------------------------------------------------------

    def apply_gradients(self, loss: torch.Tensor) -> None:
        """backward, optax's clip when configured, then one Adam step."""
        params = self._params()
        for p in params:
            p.grad = None
        loss.backward()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params]
        if self.grad_clip:
            clip_by_global_norm_(grads, self.grad_clip)
        self._update_(grads, self.opt_state, params)
        for p in params:
            p.grad = None

    def compute_metrics(self, batch: Dict[str, Any]):
        """-> (loss, metrics) of `batch` on the device."""
        loss, metrics = self.loss_fn(batch_to_device(batch, self.device))
        metrics = dict(metrics)
        metrics["total_loss"] = loss
        return loss, metrics

    def update_from_batch(self, batch: Dict[str, Any]) -> Dict[str, float]:
        loss, metrics = self.compute_metrics(batch)
        self.apply_gradients(loss)
        self.policy_version += 1
        return metrics_to_host(metrics)

    def get_weights(self) -> Dict[str, torch.Tensor]:
        """The module's state dict (the live tensors: a reader copies)."""
        return self.module.state_dict()

    def get_host_weights(self) -> Dict[str, torch.Tensor]:
        """CPU copies of the module's state dict: what a group ships
        between processes. A CUDA tensor on the wire is rebuilt on the
        sender's card index, so each receiver takes host tensors and copies
        them onto its own card (`set_weights`)."""
        return {k: v.detach().to("cpu", copy=True)
                for k, v in self.module.state_dict().items()}

    def set_weights(self, weights) -> None:
        self.module.load_state_dict(weights)

    def get_state(self) -> Dict[str, Any]:
        """Parameters and Adam state as CPU copies, and the version."""
        cpu = lambda t: t.detach().to("cpu", copy=True)  # noqa: E731
        return {"params": {k: cpu(v) for k, v in
                           self.module.state_dict().items()},
                "opt_state": AdamWState(self.opt_state.count,
                                        [cpu(m) for m in self.opt_state.mu],
                                        [cpu(v) for v in self.opt_state.nu]),
                "policy_version": self.policy_version}

    def set_state(self, state: Dict[str, Any]) -> None:
        self.module.load_state_dict(state["params"])
        opt = state["opt_state"]
        self.opt_state = AdamWState(
            opt.count, [m.to(self.device) for m in opt.mu],
            [v.to(self.device) for v in opt.nu])
        self.policy_version = int(state.get("policy_version", 0))


def parameter_mean(weights: Sequence[Dict[str, torch.Tensor]]
                   ) -> Dict[str, torch.Tensor]:
    """The mean of the learners' state dicts, key by key, summed in the
    learners' order as JAX's `sum(xs) / len(xs)` sums, on the device of the
    first learner's leaf (the group's are host copies)."""
    return {k: sum(w[k].to(weights[0][k].device) for w in weights)
            / len(weights) for k in weights[0]}


class LearnerGroup:
    """One local learner (num_learners = 0), or `num_learners` learner
    actors of the runtime, built with its actor decorator `remote`, with
    the parameter mean after every update. `policy_version` is the
    driver's mirror of the update count."""

    def __init__(self, learner_cls, module_spec: Dict[str, Any],
                 config: Dict[str, Any], remote=None):
        self.num_remote = config.get("num_learners", 0) or 0
        self._version = 0
        if self.num_remote == 0:
            self.local = learner_cls(module_spec, config)
            self.remotes = []
            return
        check_local({"num_learners": self.num_remote}, remote,
                    ("num_learners",))
        self.local = None
        install_tensor_wire()
        cls = remote(actors.CardActor).options(num_cpus=1)
        self.remotes = [cls.remote(learner_cls, module_spec, config)
                        for _ in range(self.num_remote)]
        actors.place_actors(self.remotes, config.get("device"))

    def update_from_batch(self, batch: Dict[str, Any]) -> Dict[str, float]:
        if self.local is not None:
            return self.local.update_from_batch(batch)
        n = len(self.remotes)
        size = len(next(iter(batch.values())))
        shards = [{k: v[i * size // n:(i + 1) * size // n]
                   for k, v in batch.items()} for i in range(n)]
        metrics = actors.results([w.update_from_batch.remote(s)
                                  for w, s in zip(self.remotes, shards)])
        self._version += 1
        mean = parameter_mean(actors.results(
            [w.get_host_weights.remote() for w in self.remotes]))
        actors.results([w.set_weights.remote(mean) for w in self.remotes])
        out: Dict[str, float] = {}
        for m in metrics:
            for k, v in m.items():
                out[k] = out.get(k, 0.0) + v / len(metrics)
        return out

    def get_weights(self):
        if self.local is not None:
            return self.local.get_weights()
        return actors.results([self.remotes[0].get_host_weights.remote()])[0]

    @property
    def policy_version(self) -> int:
        if self.local is not None:
            return self.local.policy_version
        return self._version

    def get_state(self):
        if self.local is not None:
            return self.local.get_state()
        return actors.results([self.remotes[0].get_state.remote()])[0]

    def set_state(self, state) -> None:
        if self.local is not None:
            self.local.set_state(state)
            return
        actors.results([w.set_state.remote(state) for w in self.remotes])
        self._version = int(state.get("policy_version", 0))

    def stop(self) -> None:
        for w in self.remotes:
            actors.terminate(w)
