"""CQL, the port's counterpart of `ray_tpu/rllib/algorithms/cql.py`:
discrete-action CQL(H) on offline data, DQN's double-Q TD loss plus
alpha * E[logsumexp_a Q(s, a) - Q(s, a_data)]."""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ray_tpu_torch.rllib.algorithm import Algorithm
from ray_tpu_torch.rllib.algorithm_config import AlgorithmConfig
from ray_tpu_torch.rllib.algorithms.dqn import DQNLearner
from ray_tpu_torch.rllib.envs import make_env
from ray_tpu_torch.rllib.learner import metrics_to_host


class CQLConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__(algo_class=CQL)
        self.cql_alpha = 1.0
        self.lr = 5e-4
        self.train_batch_size = 256
        self.num_updates_per_iteration = 200
        self.target_network_update_freq = 100


class CQLLearner(DQNLearner):
    def loss_fn(self, batch):
        q, q_data, target = self.td_terms(batch)
        td_loss = torch.mean((q_data - target) ** 2)
        cql_penalty = torch.mean(torch.logsumexp(q, dim=-1) - q_data)
        loss = td_loss + self.config.get("cql_alpha", 1.0) * cql_penalty
        return loss, {"td_loss": td_loss, "cql_penalty": cql_penalty,
                      "qf_mean": torch.mean(q_data)}

    def update_from_batch(self, batch: Dict[str, np.ndarray]
                          ) -> Dict[str, Any]:
        loss, metrics = self.compute_metrics(batch)
        self.apply_gradients(loss)
        return metrics_to_host(metrics)


class CQL(Algorithm):
    def setup(self, config: AlgorithmConfig) -> None:
        from ray_tpu_torch.rllib.offline import load_episode_batches

        obs_dim, num_actions = self._env_spaces(config.env, config.env_config)
        self.module_spec = {
            "obs_dim": obs_dim, "num_actions": num_actions,
            "hiddens": tuple(config.model.get("fcnet_hiddens", (64, 64))),
        }
        self.learner = CQLLearner(self.module_spec, config.to_dict())
        episodes = load_episode_batches(config.input_)
        cols = {"obs": [], "next_obs": [], "actions": [], "rewards": [],
                "terminateds": []}
        dtypes = {"actions": np.int32}
        for ep in episodes:
            for k in cols:
                cols[k].append(np.asarray(ep[k], dtype=dtypes.get(
                    k, np.float32)))
        self._data = {k: np.concatenate(v) for k, v in cols.items()}
        self._rng = np.random.default_rng(config.seed)
        self._steps_since_sync = 0
        self._eval_env = None

    def training_step(self) -> Dict[str, Any]:
        cfg = self.config
        n = len(self._data["obs"])
        metrics: Dict[str, Any] = {}
        for _ in range(cfg.num_updates_per_iteration):
            idx = self._rng.integers(0, n,
                                     size=min(cfg.train_batch_size, n))
            metrics = self.learner.update_from_batch(
                {k: v[idx] for k, v in self._data.items()})
            self._steps_since_sync += 1
            if self._steps_since_sync >= cfg.target_network_update_freq:
                self.learner.sync_target()
                self._steps_since_sync = 0
        metrics["num_offline_transitions"] = n
        if (cfg.evaluation_interval
                and self.iteration % cfg.evaluation_interval == 0):
            metrics["evaluation"] = self.evaluate()
        return metrics

    def evaluate(self) -> Dict[str, Any]:
        """Greedy rollouts in the env."""
        cfg = self.config
        if self._eval_env is None:
            self._eval_env = make_env(cfg.env, cfg.env_config)
        return greedy_returns(self._eval_env, self.learner,
                              cfg.evaluation_duration,
                              lambda out: out)

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


@torch.no_grad()
def greedy_returns(env, learner, episodes: int, scores) -> Dict[str, Any]:
    """Returns of `episodes` greedy rollouts: each step takes the argmax of
    scores(learner.module(obs)) (Q values, or an actor-critic's logits)."""
    returns = []
    for _ in range(episodes):
        obs, _ = env.reset()
        done = trunc = False
        total = 0.0
        while not (done or trunc):
            x = torch.from_numpy(np.asarray(obs, dtype=np.float32)[None, :])
            out = scores(learner.module(x.to(learner.device)))
            action = int(torch.argmax(out[0]))
            obs, r, done, trunc, _ = env.step(action)
            total += float(r)
        returns.append(total)
    return {"episode_return_mean": float(np.mean(returns)),
            "num_episodes": len(returns)}
