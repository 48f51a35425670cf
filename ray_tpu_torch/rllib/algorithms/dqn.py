"""DQN, the port's counterpart of `ray_tpu/rllib/algorithms/dqn.py`:
epsilon-greedy sampling into a (prioritized) replay buffer, the double-Q
TD loss against a target network, and a periodic target sync."""

from __future__ import annotations

import copy
from typing import Any, Dict

import numpy as np
import torch

from ray_tpu_torch.rllib.algorithm import Algorithm
from ray_tpu_torch.rllib.algorithm_config import AlgorithmConfig
from ray_tpu_torch.rllib.envs import make_env
from ray_tpu_torch.rllib.learner import TorchLearner, metrics_to_host
from ray_tpu_torch.rllib.replay_buffer import (PrioritizedReplayBuffer,
                                               ReplayBuffer)
from ray_tpu_torch.rllib.rl_module import resolve_module


class DQNConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__(algo_class=DQN)
        self.lr = 5e-4
        self.train_batch_size = 32
        self.num_steps_per_iteration = 1000


def _pick(values: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """values[i, index[i]]"""
    return values.gather(-1, index.long()[:, None])[:, 0]


class DQNLearner(TorchLearner):
    def __init__(self, module_spec: Dict[str, Any], config: Dict[str, Any]):
        # Q-learners default to QModule (resolve_module's default is the
        # actor-critic module)
        module_spec = dict(module_spec)
        module_spec.setdefault("module_class",
                               "ray_tpu_torch.rllib.rl_module:QModule")
        super().__init__(resolve_module(
            module_spec, device="cpu",
            generator=self.init_generator(config)), config)
        self.target = copy.deepcopy(self.module).requires_grad_(False)

    def td_terms(self, batch):
        """-> (q [B, A], Q(s, a_data), the double-Q target)."""
        gamma = self.config.get("gamma", 0.99)
        q = self.module(batch["obs"])
        q_data = _pick(q, batch["actions"])
        with torch.no_grad():
            best = torch.argmax(self.module(batch["next_obs"]), dim=-1)
            q_best = _pick(self.target(batch["next_obs"]), best)
            target = batch["rewards"] + gamma * q_best * (
                1.0 - batch["terminateds"])
        return q, q_data, target

    def loss_fn(self, batch):
        _q, q_sel, target = self.td_terms(batch)
        td = q_sel - target
        weights = batch.get("weights")
        sq = td ** 2 if weights is None else weights * td ** 2
        return torch.mean(sq), {"td_error": torch.abs(td).detach(),
                                "qf_mean": torch.mean(q_sel)}

    def update_from_batch(self, batch: Dict[str, np.ndarray]
                          ) -> Dict[str, Any]:
        loss, metrics = self.compute_metrics(batch)
        td = metrics.pop("td_error")
        self.apply_gradients(loss)
        out = metrics_to_host(metrics)
        out["td_error"] = td.cpu().numpy()
        return out

    def sync_target(self) -> None:
        self.target.load_state_dict(self.module.state_dict())


class DQN(Algorithm):
    def setup(self, config: AlgorithmConfig) -> None:
        from ray_tpu_torch.rllib.exploration import (EpsilonGreedy,
                                                     make_exploration)

        self.module_spec = self._q_module_spec(config)
        enc = (self.module_spec.get("module_kwargs") or {}).get(
            "encoder_spec") or {}
        if enc.get("kind") == "concat":
            raise NotImplementedError(
                "DQN's sampling loop supports Box/Discrete observations; "
                "Dict/Tuple observation spaces are not wired here yet "
                "(PPO's connector path handles them)")
        num_actions = self.module_spec["num_actions"]
        cfg = config.to_dict()
        expl_cfg = cfg.get("exploration_config")
        if expl_cfg:
            self.exploration = make_exploration(expl_cfg,
                                                default="EpsilonGreedy")
        else:
            self.exploration = EpsilonGreedy(schedule=config.epsilon)
        self.learner = DQNLearner(self.module_spec, cfg)
        buf_cfg = config.replay_buffer_config
        buf_cls = PrioritizedReplayBuffer \
            if buf_cfg.get("type") == "PrioritizedReplayBuffer" \
            else ReplayBuffer
        self.buffer = buf_cls(capacity=buf_cfg.get("capacity", 50_000))
        self._rng = np.random.default_rng(config.seed)
        self.env = make_env(config.env, config.env_config)
        self._obs, _ = self.env.reset(seed=config.seed)
        self._ep_return = 0.0
        self._num_actions = num_actions
        self._steps_since_target_sync = 0

    def _epsilon(self) -> float:
        if hasattr(self.exploration, "epsilon"):
            return self.exploration.epsilon(
                self._num_env_steps_sampled_lifetime)
        return 0.0

    @torch.no_grad()
    def _greedy(self) -> int:
        obs = torch.from_numpy(np.asarray(self._obs, np.float32)[None, ...])
        return int(torch.argmax(self.learner.module(
            obs.to(self.learner.device))[0]))

    def training_step(self) -> Dict[str, Any]:
        cfg = self.config
        metrics: Dict[str, Any] = {}
        for _ in range(cfg.num_steps_per_iteration):
            action = self.exploration.select_discrete(
                self._num_env_steps_sampled_lifetime, self._greedy,
                self._num_actions, self._rng)
            next_obs, reward, term, trunc, _ = self.env.step(action)
            self.buffer.add({
                "obs": np.asarray(self._obs, np.float32),
                "next_obs": np.asarray(next_obs, dtype=np.float32),
                "actions": np.int32(action),
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

            if (self._num_env_steps_sampled_lifetime
                    >= cfg.num_steps_sampled_before_learning_starts
                    and len(self.buffer) >= cfg.train_batch_size):
                batch = self.buffer.sample(cfg.train_batch_size)
                out = self.learner.update_from_batch(batch)
                td = out.pop("td_error")
                if isinstance(self.buffer, PrioritizedReplayBuffer):
                    self.buffer.update_priorities(
                        batch["batch_indexes"], td)
                metrics = out
                self._steps_since_target_sync += 1
                if (self._steps_since_target_sync
                        >= cfg.target_network_update_freq):
                    self.learner.sync_target()
                    self._steps_since_target_sync = 0
        metrics["buffer_size"] = len(self.buffer)
        metrics["epsilon"] = self._epsilon()
        return metrics

    def stop(self) -> None:
        self.env.close()
