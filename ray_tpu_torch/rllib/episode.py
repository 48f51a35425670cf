"""Episode container (reference: ray rllib/env/single_agent_episode.py —
append-per-step storage, cut on done, to-batch conversion).

The port's copy of `ray_tpu/rllib/episode.py` (which imports no JAX; the
port imports nothing of `ray_tpu`).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np


class SingleAgentEpisode:
    def __init__(self):
        self.obs: List[np.ndarray] = []
        self.actions: List[Any] = []
        self.rewards: List[float] = []
        self.infos: List[dict] = []
        self.extra: Dict[str, List[Any]] = {}
        self.is_done = False
        self.is_truncated = False
        # True for fragments cut at a sample() boundary (the episode keeps
        # running in the env) — distinct from ENV truncation (TimeLimit),
        # whose return is complete and counts toward episode_return_mean.
        self.is_boundary_fragment = False

    def add_env_reset(self, obs) -> None:
        self.obs.append(np.asarray(obs))

    def add_env_step(self, obs, action, reward, *, terminated=False,
                     truncated=False, info=None, **extra) -> None:
        self.obs.append(np.asarray(obs))
        self.actions.append(action)
        self.rewards.append(float(reward))
        self.infos.append(info or {})
        for k, v in extra.items():
            self.extra.setdefault(k, []).append(v)
        self.is_done = bool(terminated)
        self.is_truncated = bool(truncated)

    def __len__(self) -> int:
        return len(self.actions)

    @property
    def total_reward(self) -> float:
        return float(sum(self.rewards))

    def to_batch(self) -> Dict[str, np.ndarray]:
        batch = {
            "obs": np.stack(self.obs[:-1]) if len(self.obs) > 1
            else np.empty((0,)),
            "next_obs": np.stack(self.obs[1:]) if len(self.obs) > 1
            else np.empty((0,)),
            "actions": np.asarray(self.actions),
            "rewards": np.asarray(self.rewards, dtype=np.float32),
            "terminateds": np.zeros(len(self.actions), dtype=bool),
            "truncateds": np.zeros(len(self.actions), dtype=bool),
        }
        if self.actions:
            batch["terminateds"][-1] = self.is_done
            batch["truncateds"][-1] = self.is_truncated
        for k, v in self.extra.items():
            batch[k] = np.asarray(v)
        return batch
