"""MARWIL and BC, the port's counterpart of
`ray_tpu/rllib/algorithms/marwil.py`: imitation re-weighted by
exp(beta * advantage normalised by its RMS), the value head regressing
Monte-Carlo returns; BC is the case beta = 0."""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ray_tpu_torch.rllib.algorithm import Algorithm
from ray_tpu_torch.rllib.algorithm_config import AlgorithmConfig
from ray_tpu_torch.rllib.algorithms.cql import greedy_returns
from ray_tpu_torch.rllib.envs import make_env
from ray_tpu_torch.rllib.learner import TorchLearner
from ray_tpu_torch.rllib.rl_module import DiscreteActorCriticModule


class MARWILConfig(AlgorithmConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class=algo_class or MARWIL)
        self.beta = 1.0
        self.vf_coeff = 1.0
        self.train_batch_size = 2000
        self.minibatch_size = 256
        self.num_updates_per_iteration = 20
        self.lr = 1e-3


class BCConfig(MARWILConfig):
    def __init__(self):
        super().__init__(algo_class=BC)
        self.beta = 0.0  # pure imitation: no advantage weighting


class MARWILLearner(TorchLearner):
    def __init__(self, module_spec: Dict[str, Any], config: Dict[str, Any]):
        super().__init__(DiscreteActorCriticModule(
            module_spec["obs_dim"], module_spec["num_actions"],
            module_spec.get("hiddens", (64, 64)), device="cpu",
            generator=self.init_generator(config)), config)

    def loss_fn(self, batch):
        beta = self.config.get("beta", 1.0)
        vf_coeff = self.config.get("vf_coeff", 1.0)
        logits, values = self.module(batch["obs"])
        logp = torch.log_softmax(logits, dim=-1).gather(
            -1, batch["actions"].long()[:, None])[:, 0]
        returns = batch["returns"]
        vf_loss = torch.mean((values - returns) ** 2)
        if beta > 0:
            adv = returns - values.detach()
            # normalised by its RMS, as the reference's ma_adv_norm
            adv = adv / torch.sqrt(torch.mean(adv ** 2) + 1e-8)
            weight = torch.exp(torch.clamp(beta * adv, -10.0, 10.0))
        else:
            weight = torch.ones_like(logp)
        policy_loss = -torch.mean(weight * logp)
        total = policy_loss + vf_coeff * vf_loss
        return total, {"policy_loss": policy_loss, "vf_loss": vf_loss,
                       "mean_weight": torch.mean(weight)}


def compute_mc_returns(batch: Dict[str, np.ndarray],
                       gamma: float) -> np.ndarray:
    r = np.asarray(batch["rewards"], dtype=np.float32)
    out = np.zeros_like(r)
    acc = 0.0
    for t in range(len(r) - 1, -1, -1):
        acc = r[t] + gamma * acc
        out[t] = acc
    return out


class MARWIL(Algorithm):
    def setup(self, config: AlgorithmConfig) -> None:
        from ray_tpu_torch.rllib.offline import load_episode_batches

        obs_dim, num_actions = self._env_spaces(config.env, config.env_config)
        self.module_spec = {
            "obs_dim": obs_dim, "num_actions": num_actions,
            "hiddens": tuple(config.model.get("fcnet_hiddens", (64, 64))),
        }
        self.learner = MARWILLearner(self.module_spec, config.to_dict())
        episodes = load_episode_batches(config.input_)
        obs, actions, returns = [], [], []
        for ep in episodes:
            obs.append(np.asarray(ep["obs"], dtype=np.float32))
            actions.append(np.asarray(ep["actions"], dtype=np.int32))
            returns.append(compute_mc_returns(ep, config.gamma))
        self._obs = np.concatenate(obs)
        self._actions = np.concatenate(actions)
        self._returns = np.concatenate(returns)
        self._rng = np.random.default_rng(config.seed)
        self._eval_env = None

    def training_step(self) -> Dict[str, Any]:
        cfg = self.config
        n = len(self._obs)
        metrics: Dict[str, Any] = {}
        for _ in range(cfg.num_updates_per_iteration):
            idx = self._rng.integers(0, n, size=min(cfg.minibatch_size, n))
            metrics = self.learner.update_from_batch({
                "obs": self._obs[idx],
                "actions": self._actions[idx],
                "returns": self._returns[idx],
            })
        metrics["num_offline_transitions"] = n
        if (cfg.evaluation_interval
                and self.iteration % cfg.evaluation_interval == 0):
            metrics["evaluation"] = self.evaluate()
        return metrics

    def evaluate(self) -> Dict[str, Any]:
        """Greedy rollouts in the env (the argmax of the logits)."""
        cfg = self.config
        if self._eval_env is None:
            self._eval_env = make_env(cfg.env, cfg.env_config)
        return greedy_returns(self._eval_env, self.learner,
                              cfg.evaluation_duration, lambda out: out[0])

    def get_state(self) -> Dict[str, Any]:
        state = super().get_state()
        state["learner"] = self.learner.get_state()
        return state

    def set_state(self, state: Dict[str, Any]) -> None:
        super().set_state(state)
        if "learner" in state:
            self.learner.set_state(state["learner"])

    def stop(self) -> None:
        if self._eval_env is not None:
            self._eval_env.close()


class BC(MARWIL):
    """Behavior cloning: MARWIL with beta = 0."""
