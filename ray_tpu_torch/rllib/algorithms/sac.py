"""SAC, the port's counterpart of `ray_tpu/rllib/algorithms/sac.py`: a
squashed-Gaussian actor, twin Q critics with Polyak-averaged targets and
the entropy temperature tuned to a target entropy, all under one Adam.

JAX draws the reparameterisation noise inside its jitted update (the
critic target's from the update key, the actor's from `fold_in(key, 1)`).
Here the losses take the two noise tensors as arguments; the learner draws
them from its generator unless the caller passes them (a parity check
passes JAX's draws).
"""

from __future__ import annotations

import copy
import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ray_tpu_torch.rllib.algorithm import Algorithm
from ray_tpu_torch.rllib.algorithm_config import AlgorithmConfig
from ray_tpu_torch.rllib.envs import make_env
from ray_tpu_torch.rllib.learner import (TorchLearner, batch_to_device,
                                         metrics_to_host)
from ray_tpu_torch.rllib.replay_buffer import ReplayBuffer
from ray_tpu_torch.rllib.rl_module import (ContinuousQModule,
                                           GaussianActorModule)


class SACConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__(algo_class=SAC)
        self.lr = 3e-4
        self.train_batch_size = 256
        self.num_steps_per_iteration = 1000
        self.tau = 0.005                      # polyak target rate
        self.initial_alpha = 1.0
        self.target_entropy = "auto"          # -act_dim
        self.num_steps_sampled_before_learning_starts = 1500
        self.model = {"fcnet_hiddens": [256, 256]}


class SACModules(nn.Module):
    """The actor, the two critics and log_alpha: JAX's params dict
    {"actor", "q1", "q2", "log_alpha"} as one module."""

    def __init__(self, obs_dim: int, act_dim: int, hiddens,
                 initial_alpha: float, generator: torch.Generator):
        super().__init__()
        kw = {"device": "cpu", "generator": generator}
        self.actor = GaussianActorModule(obs_dim, act_dim, hiddens, **kw)
        self.q1 = ContinuousQModule(obs_dim, act_dim, hiddens, **kw)
        self.q2 = ContinuousQModule(obs_dim, act_dim, hiddens, **kw)
        self.log_alpha = nn.Parameter(torch.tensor(
            math.log(initial_alpha), dtype=torch.float32))


def _frozen(module: nn.Module, *args):
    """module(*args) with its parameters cut from the graph (JAX's
    stop_gradient of the critic params in the actor loss)."""
    params = {n: p.detach() for n, p in module.named_parameters()}
    return torch.func.functional_call(module, params, args)


class SACLearner(TorchLearner):
    """config: lr, gamma, tau, initial_alpha, target_entropy, seed,
    device."""

    def __init__(self, obs_dim: int, act_dim: int, hiddens,
                 config: Dict[str, Any]):
        super().__init__(SACModules(
            obs_dim, act_dim, tuple(hiddens),
            config.get("initial_alpha", 1.0), self.init_generator(config)),
            config)
        self.act_dim = act_dim
        self.grad_clip = None  # SAC's optimizer is optax.adam alone
        self.target = nn.ModuleDict({
            "q1": copy.deepcopy(self.module.q1),
            "q2": copy.deepcopy(self.module.q2)}).requires_grad_(False)
        te = config.get("target_entropy", "auto")
        self.target_entropy = -float(act_dim) if te == "auto" else float(te)
        self.generator = torch.Generator(device=self.device).manual_seed(
            (config.get("seed") or 0) + 1)

    def draw_noise(self, batch_size: int) -> Tuple[torch.Tensor,
                                                   torch.Tensor]:
        """(noise of the critic target's action, of the actor loss's)."""
        shape = (batch_size, self.act_dim)
        return tuple(torch.randn(shape, generator=self.generator,
                                 device=self.device) for _ in range(2))

    def losses(self, batch, eps_next, eps_cur):
        m = self.module
        gamma = self.config.get("gamma", 0.99)
        obs, act, next_obs = batch["obs"], batch["actions"], batch["next_obs"]
        alpha = torch.exp(m.log_alpha)
        with torch.no_grad():
            # critic targets from the current policy at next_obs
            next_act, next_logp = m.actor(next_obs, eps_next)
            tq = torch.minimum(self.target["q1"](next_obs, next_act),
                               self.target["q2"](next_obs, next_act))
            backup = batch["rewards"] + gamma * (
                1 - batch["terminateds"]) * (tq - alpha * next_logp)
        q1_pred = m.q1(obs, act)
        q2_pred = m.q2(obs, act)
        critic_loss = (torch.mean((q1_pred - backup) ** 2)
                       + torch.mean((q2_pred - backup) ** 2))
        # actor: maximise Q - alpha * logp on a fresh reparameterised draw
        new_act, logp = m.actor(obs, eps_cur)
        q_new = torch.minimum(_frozen(m.q1, obs, new_act),
                              _frozen(m.q2, obs, new_act))
        actor_loss = torch.mean(alpha.detach() * logp - q_new)
        # alpha: drive the entropy toward the target
        alpha_loss = -torch.mean(
            m.log_alpha * (logp + self.target_entropy).detach())
        total = critic_loss + actor_loss + alpha_loss
        return total, {"critic_loss": critic_loss, "actor_loss": actor_loss,
                       "alpha": alpha, "entropy": -torch.mean(logp),
                       "qf_mean": torch.mean(q1_pred)}

    def update_from_batch(self, batch: Dict[str, Any],
                          noise: Optional[Tuple[Any, Any]] = None
                          ) -> Dict[str, float]:
        """One Adam step on the three losses, then the Polyak update of
        the targets. noise: (eps_next, eps_cur), numpy [B, act_dim], else
        drawn from the learner's generator."""
        b = batch_to_device(batch, self.device)
        if noise is None:
            eps = self.draw_noise(len(b["obs"]))
        else:
            eps = [torch.from_numpy(np.array(n, np.float32)).to(self.device)
                   for n in noise]
        loss, metrics = self.losses(b, *eps)
        self.apply_gradients(loss)
        tau = self.config.get("tau", 0.005)
        with torch.no_grad():
            for name in ("q1", "q2"):
                target = list(self.target[name].parameters())
                online = list(getattr(self.module, name).parameters())
                torch._foreach_mul_(target, 1 - tau)
                torch._foreach_add_(target, online, alpha=tau)
        self.policy_version += 1
        return metrics_to_host(metrics)


class SAC(Algorithm):
    def setup(self, config: AlgorithmConfig) -> None:
        from ray_tpu_torch.rllib.catalog import Catalog

        env = make_env(config.env, config.env_config)
        spec = Catalog(env.observation_space, env.action_space,
                       config.model).sac_specs()
        self._act_low = np.asarray(env.action_space.low, np.float32)
        self._act_high = np.asarray(env.action_space.high, np.float32)
        self.env = env
        self.learner = SACLearner(spec["obs_dim"], spec["act_dim"],
                                  spec["hiddens"], config.to_dict())
        self.buffer = ReplayBuffer(
            capacity=config.replay_buffer_config.get("capacity", 100_000))
        self._obs, _ = env.reset(seed=config.seed)
        self._ep_return = 0.0
        self._rng = np.random.default_rng(config.seed)

    @torch.no_grad()
    def _actor_action(self, obs, explore: bool) -> np.ndarray:
        x = torch.from_numpy(np.asarray(obs, np.float32)[None, :]).to(
            self.learner.device)
        actor = self.learner.module.actor
        if explore:
            act, _ = actor.sample(x, self.learner.generator)
        else:
            act = actor.forward_inference({"obs": x})["actions"]
        return act[0].cpu().numpy()

    def compute_single_action(self, obs, explore: bool = False):
        """The deterministic (tanh-mean) or sampled action in env units."""
        return self._env_action(self._actor_action(obs, explore))

    def _env_action(self, act):
        return (act * (self._act_high - self._act_low) / 2.0
                + (self._act_high + self._act_low) / 2.0)

    def training_step(self) -> Dict[str, Any]:
        cfg = self.config
        metrics: Dict[str, Any] = {}
        warmup = cfg.num_steps_sampled_before_learning_starts
        for _ in range(cfg.num_steps_per_iteration):
            if self._num_env_steps_sampled_lifetime < warmup:
                act = self._rng.uniform(
                    -1, 1, size=self._act_low.shape).astype(np.float32)
            else:
                act = self._actor_action(self._obs, explore=True)
            next_obs, reward, term, trunc, _ = self.env.step(
                self._env_action(act))
            self.buffer.add({
                "obs": self._obs.astype(np.float32),
                "next_obs": np.asarray(next_obs, np.float32),
                "actions": act.astype(np.float32),
                "rewards": np.float32(reward),
                "terminateds": np.float32(term),
            })
            self._num_env_steps_sampled_lifetime += 1
            self._ep_return += float(reward)
            if term or trunc:
                self._episode_returns.append(self._ep_return)
                self._ep_return = 0.0
                self._obs, _ = self.env.reset()
            else:
                self._obs = next_obs

            if (self._num_env_steps_sampled_lifetime >= warmup
                    and len(self.buffer) >= cfg.train_batch_size):
                metrics = self.learner.update_from_batch(
                    self.buffer.sample(cfg.train_batch_size))
        metrics["buffer_size"] = len(self.buffer)
        return metrics

    def stop(self) -> None:
        self.env.close()
