"""Multi-agent RL: episodes, sampling, and multi-agent PPO, the port's
counterpart of `ray_tpu/rllib/multi_agent.py`.

Reference counterparts: ray rllib/env/multi_agent_episode.py
(MultiAgentEpisode), rllib/core/rl_module/multi_rl_module.py (one RLModule
per policy id), and the multi-agent paths of
rllib/algorithms/ppo/ppo.py — AlgorithmConfig.multi_agent(policies=...,
policy_mapping_fn=...) routes each agent's experience to its module's
learner; shared policies train on all mapped agents' data.

Where the JAX runner jits one forward per module, the port's runs each
policy's module (the learner's own, on the learner's device) on one agent's
observation and reads its logits and value back once per agent step; the
action is drawn on the host from the float64 softmax with
`np.random.default_rng(seed).choice`, as in JAX, so equal logits give
equal actions.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ray_tpu_torch.rllib.algorithm import Algorithm
from ray_tpu_torch.rllib.algorithms.ppo import (PPOConfig, PPOLearner,
                                                compute_gae)
from ray_tpu_torch.rllib.env_runner import obs_to_device
from ray_tpu_torch.rllib.episode import SingleAgentEpisode


class MultiAgentEpisode:
    """Per-agent SingleAgentEpisodes plus env-level bookkeeping."""

    def __init__(self):
        self.agent_episodes: Dict[Any, SingleAgentEpisode] = {}
        self.is_done = False

    def agent(self, agent_id) -> SingleAgentEpisode:
        ep = self.agent_episodes.get(agent_id)
        if ep is None:
            ep = self.agent_episodes[agent_id] = SingleAgentEpisode()
        return ep

    def __len__(self) -> int:
        return sum(len(ep) for ep in self.agent_episodes.values())

    @property
    def total_reward(self) -> float:
        return float(sum(ep.total_reward
                         for ep in self.agent_episodes.values()))


class MultiAgentEnvRunner:
    """Samples MultiAgentEpisodes from one MultiAgentEnv with one module
    per policy id, in the calling process (the reference's local-worker
    mode). The modules are the learners' own, so an update reaches the
    runner without a copy."""

    def __init__(self, env, modules: Dict[str, torch.nn.Module],
                 policy_mapping_fn: Callable[[Any], str],
                 seed: Optional[int] = None):
        self.env = env
        self.modules = modules
        self.policy_mapping_fn = policy_mapping_fn
        self._rng = np.random.default_rng(seed)
        self._obs: Optional[Dict] = None
        self._episode: Optional[MultiAgentEpisode] = None

    @torch.no_grad()
    def _act(self, agent_id, obs):
        """-> (action, logp, value) sampled from the agent's module."""
        module = self.modules[self.policy_mapping_fn(agent_id)]
        device = next(module.parameters()).device
        logits, value = module(obs_to_device(
            np.asarray(obs, np.float32)[None, :], device))
        out = torch.cat([logits[0], value]).cpu().numpy()  # one host read
        logits = out[:-1].astype(np.float64)
        logits = logits - logits.max()
        probs = np.exp(logits)
        probs /= probs.sum()
        action = int(self._rng.choice(len(probs), p=probs))
        return action, float(np.log(probs[action] + 1e-12)), float(out[-1])

    def sample(self, num_steps: int) -> List[MultiAgentEpisode]:
        out: List[MultiAgentEpisode] = []
        steps = 0
        if self._obs is None:
            self._obs, _ = self.env.reset(
                seed=int(self._rng.integers(1 << 31)))
            self._episode = MultiAgentEpisode()
            for aid, ob in self._obs.items():
                self._episode.agent(aid).add_env_reset(ob)
        while steps < num_steps:
            actions, logps, values = {}, {}, {}
            for aid, ob in self._obs.items():
                a, lp, v = self._act(aid, ob)
                actions[aid], logps[aid], values[aid] = a, lp, v
            obs, rewards, terms, truncs, _infos = self.env.step(actions)
            done_all = terms.get("__all__", False) or \
                truncs.get("__all__", False)
            for aid in actions:
                ep = self._episode.agent(aid)
                if not ep.obs:
                    # agent entered mid-episode (dynamic-entry envs):
                    # its first observation plays the reset role
                    ep.add_env_reset(self._obs[aid])
                next_ob = obs.get(aid, self._obs[aid])
                ep.add_env_step(
                    next_ob, actions[aid], rewards.get(aid, 0.0),
                    terminated=bool(terms.get(aid, False)
                                    or terms.get("__all__", False)),
                    truncated=bool(truncs.get(aid, False)
                                   or truncs.get("__all__", False)),
                    logp=logps[aid], vf_preds=values[aid])
                steps += 1
            self._obs = {aid: ob for aid, ob in obs.items()
                         if not (terms.get(aid) or truncs.get(aid))}
            if done_all or not self._obs:
                self._episode.is_done = True
                out.append(self._episode)
                self._obs, _ = self.env.reset(
                    seed=int(self._rng.integers(1 << 31)))
                self._episode = MultiAgentEpisode()
                for aid, ob in self._obs.items():
                    self._episode.agent(aid).add_env_reset(ob)
        if self._episode is not None and len(self._episode):
            # cut the in-progress fragment so its data trains this round
            out.append(self._episode)
            self._episode = MultiAgentEpisode()
            for aid, ob in self._obs.items():
                self._episode.agent(aid).add_env_reset(ob)
        return out


class MultiAgentPPOConfig(PPOConfig):
    def __init__(self):
        super().__init__()
        self.algo_class = MultiAgentPPO
        self.policies: Optional[List[str]] = None
        self.policy_mapping_fn: Callable[[Any], str] = (
            lambda agent_id: "default_policy")

    def multi_agent(self, *, policies: Optional[List[str]] = None,
                    policy_mapping_fn: Optional[Callable] = None,
                    **_kw) -> "MultiAgentPPOConfig":
        if policies is not None:
            self.policies = list(policies)
        if policy_mapping_fn is not None:
            self.policy_mapping_fn = policy_mapping_fn
        return self


class MultiAgentPPO(Algorithm):
    """PPO over a MultiAgentEnv: one PPOLearner per policy id; each
    agent's experience routes to its mapped policy's learner."""

    def setup(self, config) -> None:
        env = config.env
        if isinstance(env, type):
            env = env(**(config.env_config or {}))
        self.env = env
        policies = config.policies or ["default_policy"]
        # fail fast on an inconsistent mapping: every agent must map into
        # the declared policy set (a bad fn would otherwise surface as a
        # KeyError deep inside sampling)
        for aid in env.possible_agents:
            mapped = config.policy_mapping_fn(aid)
            if mapped not in policies:
                raise ValueError(
                    f"policy_mapping_fn({aid!r}) -> {mapped!r}, which is "
                    f"not in policies {policies}")
        self.learners: Dict[str, PPOLearner] = {}
        for pid in policies:
            # spaces from any agent mapped to this policy
            agents = [a for a in env.possible_agents
                      if config.policy_mapping_fn(a) == pid]
            if not agents:
                raise ValueError(f"no agents map to policy {pid!r}")
            obs_space = env.observation_space(agents[0])
            act_space = env.action_space(agents[0])
            spec = {
                "obs_dim": int(obs_space.shape[0]),
                "num_actions": int(act_space.n),
                "hiddens": tuple(
                    config.model.get("fcnet_hiddens", (64, 64))),
            }
            self.learners[pid] = PPOLearner(spec, config.to_dict())
        self.runner = MultiAgentEnvRunner(
            env, {pid: lr.module for pid, lr in self.learners.items()},
            config.policy_mapping_fn, seed=config.seed)

    def training_step(self) -> Dict[str, Any]:
        cfg = self.config
        episodes: List[MultiAgentEpisode] = []
        steps = 0
        while steps < cfg.train_batch_size:
            new = self.runner.sample(
                num_steps=cfg.train_batch_size - steps)
            episodes.extend(new)
            steps += sum(len(e) for e in new)
        self._record_episodes(
            [ep for mae in episodes for ep in mae.agent_episodes.values()])

        # group agent fragments by policy, GAE per fragment
        per_policy: Dict[str, List[Dict[str, np.ndarray]]] = {
            pid: [] for pid in self.learners}
        for mae in episodes:
            for aid, ep in mae.agent_episodes.items():
                if not len(ep):
                    continue
                b = ep.to_batch()
                last_value = 0.0 if ep.is_done else float(b["vf_preds"][-1])
                adv, targets = compute_gae(
                    b["rewards"], b["vf_preds"], b["terminateds"],
                    last_value, cfg.gamma, cfg.lambda_)
                b["advantages"] = adv
                b["value_targets"] = targets
                per_policy[cfg.policy_mapping_fn(aid)].append(b)

        keys = ("obs", "actions", "logp", "advantages", "value_targets")
        metrics: Dict[str, Any] = {"num_env_steps_sampled": steps}
        rng = np.random.default_rng(self.iteration)
        for pid, batches in per_policy.items():
            if not batches:
                continue
            train_batch = {
                k: np.concatenate([b[k] for b in batches]).astype(
                    np.float32 if k != "actions" else np.int32)
                for k in keys}
            n = len(train_batch["obs"])
            learner = self.learners[pid]
            mbs = min(cfg.minibatch_size, n)
            for _ in range(cfg.num_epochs):
                perm = rng.permutation(n)
                for s in range(0, n - mbs + 1, mbs):
                    idx = perm[s:s + mbs]
                    out = learner.update_from_batch(
                        {k: v[idx] for k, v in train_batch.items()})
                    metrics[pid] = out
        return metrics

    def get_state(self) -> Dict[str, Any]:
        state = super().get_state()
        state["learners"] = {pid: lr.get_state()
                             for pid, lr in self.learners.items()}
        return state

    def set_state(self, state: Dict[str, Any]) -> None:
        super().set_state(state)
        for pid, s in state.get("learners", {}).items():
            if pid in self.learners:
                self.learners[pid].set_state(s)

    def stop(self) -> None:
        self.env.close()
