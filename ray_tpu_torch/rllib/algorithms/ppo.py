"""PPO, the port's counterpart of `ray_tpu/rllib/algorithms/ppo.py`.

Synchronous sample -> GAE per episode fragment on the host -> minibatch
Adam epochs -> weight broadcast to the runners: the inline one, or
`num_env_runners` runner actors, with one learner or `num_learners` learner
actors under the parameter mean (the groups of `env_runner` and
`learner`). The loss (clipped surrogate
+ value loss - entropy bonus, advantages normalised per minibatch) is the
JAX learner's, computed eagerly on the learner's device. The minibatch
permutations come from `np.random.default_rng(iteration)`, as in JAX, so
the same episodes give the same minibatches.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List

import numpy as np
import torch

from ray_tpu_torch.rllib.algorithm import Algorithm
from ray_tpu_torch.rllib.algorithm_config import AlgorithmConfig
from ray_tpu_torch.rllib.env_runner import EnvRunnerGroup
from ray_tpu_torch.rllib.learner import LearnerGroup, TorchLearner
from ray_tpu_torch.rllib.rl_module import resolve_module


class PPOConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__(algo_class=PPO)
        self.lr = 5e-5
        self.train_batch_size = 4000
        self.minibatch_size = 128
        self.num_epochs = 8


def compute_gae(rewards: np.ndarray, values: np.ndarray,
                dones: np.ndarray, last_value: float,
                gamma: float, lam: float):
    """Host-side GAE over one episode fragment."""
    T = len(rewards)
    adv = np.zeros(T, dtype=np.float32)
    last_gae = 0.0
    next_value = last_value
    for t in reversed(range(T)):
        nonterminal = 0.0 if dones[t] else 1.0
        delta = rewards[t] + gamma * next_value * nonterminal - values[t]
        last_gae = delta + gamma * lam * nonterminal * last_gae
        adv[t] = last_gae
        next_value = values[t]
    return adv, adv + values


class PPOLearner(TorchLearner):
    def __init__(self, module_spec: Dict[str, Any], config: Dict[str, Any]):
        super().__init__(resolve_module(
            module_spec, device="cpu",
            generator=self.init_generator(config)), config)

    def loss_fn(self, batch):
        out = self.module.forward_train(batch)
        logp, vf, entropy = out["logp"], out["vf_preds"], out["entropy"]
        ratio = torch.exp(logp - batch["logp"])
        adv = batch["advantages"]
        # jnp.std is the population deviation
        adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
        clip = self.config.get("clip_param", 0.2)
        surrogate = torch.minimum(ratio * adv,
                                  torch.clamp(ratio, 1 - clip, 1 + clip) * adv)
        pi_loss = -torch.mean(surrogate)
        vf_loss = torch.mean((vf - batch["value_targets"]) ** 2)
        ent = torch.mean(entropy)
        loss = (pi_loss + self.config.get("vf_loss_coeff", 0.5) * vf_loss
                - self.config.get("entropy_coeff", 0.0) * ent)
        return loss, {"policy_loss": pi_loss, "vf_loss": vf_loss,
                      "entropy": ent, "kl": torch.mean(batch["logp"] - logp)}


class PPO(Algorithm):
    remote_options = ("num_env_runners", "num_learners")

    def setup(self, config: AlgorithmConfig) -> None:
        self.module_spec = self._actor_critic_spec(config)
        cfg = config.to_dict()
        self.env_runner_group = EnvRunnerGroup(cfg, self.module_spec,
                                               config.remote)
        self.learner_group = LearnerGroup(PPOLearner, self.module_spec, cfg,
                                          config.remote)
        self.env_runner_group.sync_weights(
            self.learner_group.get_weights(),
            self.learner_group.policy_version)

    def training_step(self) -> Dict[str, Any]:
        cfg = self.config
        t0 = time.perf_counter()
        # 1. sample
        episodes: List = []
        steps = 0
        runners = max(1, cfg.num_env_runners) * cfg.num_envs_per_env_runner
        per_runner = max(1, cfg.train_batch_size // runners)
        while steps < cfg.train_batch_size:
            new_eps = self.env_runner_group.sample(num_steps=per_runner)
            episodes.extend(new_eps)
            steps += sum(len(e) for e in new_eps)
        self._record_episodes(episodes)
        t1 = time.perf_counter()

        # 2. GAE per episode fragment, concatenated
        batches = []
        for ep in episodes:
            b = ep.to_batch()
            if len(b["rewards"]) == 0:
                continue
            # bootstrap: 0 after a termination, else the last vf_pred
            last_value = 0.0 if ep.is_done else float(b["vf_preds"][-1])
            adv, targets = compute_gae(
                b["rewards"], b["vf_preds"], b["terminateds"], last_value,
                cfg.gamma, cfg.lambda_)
            b["advantages"] = adv
            b["value_targets"] = targets
            batches.append(b)
        keys = ("obs", "actions", "logp", "advantages", "value_targets")

        def cast(k, v):
            if k == "actions":
                return v.astype(np.int32)
            if k == "obs":
                return v  # uint8 images are normalised on the device
            return v.astype(np.float32)

        train_batch = {
            k: cast(k, np.concatenate([b[k] for b in batches]))
            for k in keys}

        # 3. minibatch epochs
        n = len(train_batch["obs"])
        metrics: Dict[str, Any] = {}
        rng = np.random.default_rng(self.iteration)
        updates = 0
        for _ in range(cfg.num_epochs):
            perm = rng.permutation(n)
            for s in range(0, n - cfg.minibatch_size + 1, cfg.minibatch_size):
                idx = perm[s:s + cfg.minibatch_size]
                mb = {k: v[idx] for k, v in train_batch.items()}
                metrics = self.learner_group.update_from_batch(mb)
                updates += 1

        # 4. broadcast, stamped with the policy version
        self.env_runner_group.sync_weights(
            self.learner_group.get_weights(),
            self.learner_group.policy_version)
        metrics["num_env_steps_sampled"] = steps
        # the port's loop timings (host clock; each update ends in a host
        # read of its metrics)
        metrics["sample_seconds"] = t1 - t0
        metrics["learn_seconds"] = time.perf_counter() - t1
        metrics["num_learner_updates"] = updates
        return metrics

    def get_state(self) -> Dict[str, Any]:
        state = super().get_state()
        state["learner"] = self.learner_group.get_state()
        return state

    def set_state(self, state: Dict[str, Any]) -> None:
        super().set_state(state)
        if "learner" in state:
            self.learner_group.set_state(state["learner"])
            self.env_runner_group.sync_weights(
                self.learner_group.get_weights(),
                self.learner_group.policy_version)

    def stop(self) -> None:
        self.env_runner_group.stop()
        self.learner_group.stop()
