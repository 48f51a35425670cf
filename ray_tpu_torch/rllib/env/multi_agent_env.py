"""MultiAgentEnv API (reference: ray rllib/env/multi_agent_env.py —
dict-keyed reset/step with the "__all__" terminated/truncated convention).

Subclasses define `possible_agents` and per-agent spaces
(`observation_spaces` / `action_spaces` dicts), then:

    obs, infos = env.reset(seed=...)
    obs, rewards, terminateds, truncateds, infos = env.step(action_dict)

Each returned dict is keyed by agent id and includes only agents alive that
step; `terminateds["__all__"]` / `truncateds["__all__"]` end the episode.

The port's copy of `ray_tpu/rllib/env/multi_agent_env.py`
(which imports no JAX; the port imports nothing of `ray_tpu`).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple


class MultiAgentEnv:
    possible_agents: List[Any] = []
    observation_spaces: Dict[Any, Any] = {}
    action_spaces: Dict[Any, Any] = {}

    def reset(self, *, seed: Optional[int] = None,
              options: Optional[dict] = None
              ) -> Tuple[Dict[Any, Any], Dict[Any, dict]]:
        raise NotImplementedError

    def step(self, action_dict: Dict[Any, Any]):
        raise NotImplementedError

    def observation_space(self, agent_id) -> Any:
        return self.observation_spaces[agent_id]

    def action_space(self, agent_id) -> Any:
        return self.action_spaces[agent_id]

    def close(self) -> None:
        pass
