"""IMPALA's and APPO's V-trace update and their synchronous loop, the
port's counterpart of `ray_tpu/rllib/algorithms/impala.py`
(`make_vtrace_update` :39-123, `IMPALA` with num_env_runners = 0,
:291-295, and `APPOConfig` / `APPO`, :370-381).

V-trace (Espeholt et al. 2018): JAX runs the recursion as a `lax.scan`
over the reversed time axis; here it is a reversed loop over T computing
the same recursion, vs_t - V(x_t) = delta_t + gamma_t c_t (vs_{t+1} -
V(x_{t+1})). APPO (`appo_clip`) takes PPO's clipped surrogate on the
V-trace advantages in place of the plain policy gradient. The
asynchronous in-flight pipeline and the decoupled dataflow need the actor
runtime and are not ported (ROADMAP.md queue 1, item 5); neither is the
`rl.learner_step` event, which waits for the port of the event log.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ray_tpu_torch.rllib.algorithm import Algorithm
from ray_tpu_torch.rllib.algorithm_config import AlgorithmConfig
from ray_tpu_torch.rllib.env_runner import EnvRunnerGroup, obs_to_device
from ray_tpu_torch.rllib.learner import TorchLearner
from ray_tpu_torch.rllib.rl_module import resolve_module


class IMPALAConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__(algo_class=IMPALA)
        self.lr = 5e-4
        self.rollout_fragment_length = 50
        # The JAX config defaults to 2 remote runners; the port runs the
        # synchronous path only.
        self.num_env_runners = 0
        self.vtrace_clip_rho_threshold = 1.0
        self.vtrace_clip_c_threshold = 1.0
        self.vf_loss_coeff = 0.5
        self.entropy_coeff = 0.01
        self.broadcast_interval = 1   # learner steps between weight pushes
        self.normalize_advantages = True


def vtrace_returns(values, bootstrap, rewards, discounts, clipped_rho,
                   clipped_c) -> torch.Tensor:
    """vs [B, T] from the [B, T] values, rewards, discounts and clipped
    importance weights and the [B] bootstrap values."""
    values_t_plus_1 = torch.cat([values[:, 1:], bootstrap[:, None]], dim=1)
    deltas = clipped_rho * (rewards + discounts * values_t_plus_1 - values)
    acc = torch.zeros_like(bootstrap)
    vs_minus_v = []
    for t in reversed(range(values.shape[1])):
        acc = deltas[:, t] + discounts[:, t] * clipped_c[:, t] * acc
        vs_minus_v.append(acc)
    return values + torch.stack(vs_minus_v[::-1], dim=1)


class VTraceLearner(TorchLearner):
    """The V-trace actor-critic update on [B, T] trajectories (batch keys:
    obs, actions, rewards, logp (behaviour), terminateds, mask,
    bootstrap_value), under optax.adam(lr) as in JAX (no clip). With
    config["appo_clip"], APPO's clipped surrogate (clip_param)."""

    def __init__(self, module_spec: Dict[str, Any], config: Dict[str, Any]):
        super().__init__(resolve_module(
            module_spec, device="cpu",
            generator=self.init_generator(config)), config)
        self.grad_clip = None

    def loss_fn(self, batch):
        cfg = self.config
        b, t = batch["actions"].shape
        # flatten the [B, T] rows only: images keep their [H, W, C] tail
        obs = batch["obs"].reshape((b * t,) + tuple(batch["obs"].shape[2:]))
        out = self.module.forward_train(
            {"obs": obs, "actions": batch["actions"].reshape(-1)})
        logp = out["logp"].reshape(b, t)
        values = out["vf_preds"].reshape(b, t)
        entropy = out["entropy"].reshape(b, t)
        mask = batch["mask"]
        denom = torch.clamp(torch.sum(mask), min=1.0)
        rhos = torch.exp(logp - batch["logp"])
        discounts = cfg.get("gamma", 0.99) * (1.0 - batch["terminateds"])
        bootstrap = batch["bootstrap_value"]
        with torch.no_grad():
            clipped_rho = torch.clamp(
                rhos, max=cfg.get("vtrace_clip_rho_threshold", 1.0))
            clipped_c = torch.clamp(
                rhos, max=cfg.get("vtrace_clip_c_threshold", 1.0))
            v = values.detach()
            vs = vtrace_returns(v, bootstrap, batch["rewards"], discounts,
                                clipped_rho, clipped_c)
            vs_t_plus_1 = torch.cat([vs[:, 1:], bootstrap[:, None]], dim=1)
            pg_adv = clipped_rho * (batch["rewards"] + discounts * vs_t_plus_1
                                    - v)
            if cfg.get("normalize_advantages", True):
                adv_mean = torch.sum(pg_adv * mask) / denom
                adv_var = torch.sum(mask * (pg_adv - adv_mean) ** 2) / denom
                pg_adv = (pg_adv - adv_mean) * torch.rsqrt(adv_var + 1e-8)
        if cfg.get("appo_clip", False):
            clip = cfg.get("clip_param", 0.2)
            surr = torch.minimum(
                rhos * pg_adv, torch.clamp(rhos, 1 - clip, 1 + clip) * pg_adv)
            pg_loss = -torch.sum(surr * mask) / denom
        else:
            pg_loss = -torch.sum(logp * pg_adv * mask) / denom
        vf_loss = 0.5 * torch.sum(mask * (values - vs) ** 2) / denom
        ent = torch.sum(entropy * mask) / denom
        total = (pg_loss + cfg.get("vf_loss_coeff", 0.5) * vf_loss
                 - cfg.get("entropy_coeff", 0.01) * ent)
        return total, {"pg_loss": pg_loss, "vf_loss": vf_loss,
                       "entropy": ent,
                       "mean_rho": torch.sum(rhos * mask) / denom}


class IMPALA(Algorithm):
    def setup(self, config: AlgorithmConfig) -> None:
        self.module_spec = self._actor_critic_spec(config)
        cfg = config.to_dict()
        self.learner = VTraceLearner(self.module_spec, cfg)
        self.policy_version = 0
        self.runner_group = EnvRunnerGroup(cfg, self.module_spec)
        self.runner_group.sync_weights(self.learner.get_weights(),
                                       self.policy_version)
        self._steps_since_broadcast = 0

    @torch.no_grad()
    def _values(self, obs: np.ndarray) -> np.ndarray:
        _, v = self.learner.module(obs_to_device(obs, self.learner.device))
        return v.cpu().numpy()

    def _episodes_to_batch(self, episodes) -> Dict[str, np.ndarray]:
        """Pack fragments densely into rows of exactly T =
        rollout_fragment_length ([B_bucket, T], B padded to a multiple of
        4 with masked dead rows). Every fragment ends with terminateds=1,
        a truncated one with gamma * V(boundary obs) folded into its last
        reward, so V-trace targets never cross rows; a row that splits a
        fragment bootstraps from V(first obs of the next row)."""
        t_len = self.config.rollout_fragment_length
        stream = {k: [] for k in
                  ("obs", "actions", "rewards", "logp", "terminateds")}
        for ep in episodes:
            rews = np.asarray(ep.rewards, np.float32).copy()
            terms = np.zeros(len(ep), np.float32)
            terms[-1] = 1.0
            if not ep.is_done:
                last_obs = np.asarray(ep.obs[-1])
                rews[-1] += self.config.gamma * float(
                    self._values(last_obs[None])[0])
            stream["obs"].append(np.asarray(ep.obs[:-1]))
            stream["actions"].append(np.asarray(ep.actions, np.int64))
            stream["rewards"].append(rews)
            stream["logp"].append(
                np.asarray(ep.extra.get("logp"), np.float32))
            stream["terminateds"].append(terms)
        flat = {k: np.concatenate(v) for k, v in stream.items()}
        n = len(flat["actions"])
        mask = np.ones(n, np.float32)
        pad = (-n) % t_len
        if pad:
            flat = {k: np.concatenate(
                [v, np.repeat(v[-1:], pad, axis=0)]) for k, v in flat.items()}
            flat["rewards"][n:] = 0
            flat["terminateds"][n:] = 1
            mask = np.concatenate([mask, np.zeros(pad, np.float32)])
        b = (n + pad) // t_len
        b_bucket = ((b + 3) // 4) * 4
        batch = {}
        for k, v in flat.items():
            v = v.reshape((b, t_len) + v.shape[1:])
            dead = np.zeros(((b_bucket - b), t_len) + v.shape[2:], v.dtype)
            if k == "terminateds":
                dead = dead + 1
            batch[k] = np.concatenate([v, dead])
        m = mask.reshape(b, t_len)
        batch["mask"] = np.concatenate(
            [m, np.zeros((b_bucket - b, t_len), np.float32)])
        boots = np.zeros(b_bucket, np.float32)
        flat_terms = batch["terminateds"].reshape(-1)
        need = [i for i in range(b - 1)
                if flat_terms[(i + 1) * t_len - 1] == 0]
        if need:
            next_obs = batch["obs"].reshape((-1,) + batch["obs"].shape[2:])[
                [(i + 1) * t_len for i in need]]
            for i, v in zip(need, self._values(next_obs)):
                boots[i] = v
        batch["bootstrap_value"] = boots
        return batch

    def training_step(self) -> Dict[str, Any]:
        cfg = self.config
        episodes = self.runner_group.sample(
            num_steps=cfg.rollout_fragment_length)
        if not episodes:
            return {"num_episodes": 0}
        self._record_episodes(episodes)
        out = self.learner.update_from_batch(self._episodes_to_batch(episodes))
        self.policy_version += 1
        self._steps_since_broadcast += 1
        if self._steps_since_broadcast >= cfg.broadcast_interval:
            self.runner_group.sync_weights(self.learner.get_weights(),
                                           self.policy_version)
            self._steps_since_broadcast = 0
        out["num_episodes"] = len(episodes)
        out["policy_version"] = self.policy_version
        return out

    def stop(self) -> None:
        self.runner_group.stop()


class APPOConfig(IMPALAConfig):
    def __init__(self):
        super().__init__()
        self.algo_class = APPO
        self.appo_clip = True
        self.clip_param = 0.2


class APPO(IMPALA):
    """Asynchronous PPO (reference: ray rllib/algorithms/appo/appo.py):
    IMPALA's loop with the PPO clipped surrogate on the V-trace-corrected
    advantages. Here it runs IMPALA's synchronous path (num_env_runners =
    0); the asynchronous one waits for the actor runtime."""
