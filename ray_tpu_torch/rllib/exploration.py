"""Exploration strategies (reference: ray rllib/utils/exploration/ —
EpsilonGreedy, GaussianNoise, OrnsteinUhlenbeckNoise, StochasticSampling;
configured via ``exploration_config={"type": ...}``).

Strategies are small stateful objects the sampling side consults per env
step: ``get_action(t, greedy_action_fn, action_space_n_or_shape, rng)``.
They hold schedules, not network state, so they stay picklable across
env-runner actors.

The port's copy of `ray_tpu/rllib/exploration.py` (which imports no JAX; the
port imports nothing of `ray_tpu`).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np


class Exploration:
    def select_discrete(self, t: int, greedy_fn, num_actions: int,
                        rng: np.random.Generator) -> int:
        """greedy_fn() -> int action; t = lifetime env steps."""
        raise NotImplementedError

    def perturb_continuous(self, t: int, action: np.ndarray,
                           rng: np.random.Generator) -> np.ndarray:
        raise NotImplementedError

    def get_state(self) -> Dict[str, Any]:
        return {}

    def set_state(self, state: Dict[str, Any]) -> None:
        pass


class EpsilonGreedy(Exploration):
    """Linear (or piecewise) epsilon schedule over env steps."""

    def __init__(self,
                 initial_epsilon: float = 1.0,
                 final_epsilon: float = 0.05,
                 epsilon_timesteps: int = 10_000,
                 schedule: Optional[Sequence[Tuple[int, float]]] = None):
        if schedule is not None:
            self.schedule = [(int(t), float(e)) for t, e in schedule]
        else:
            self.schedule = [(0, initial_epsilon),
                             (epsilon_timesteps, final_epsilon)]

    def epsilon(self, t: int) -> float:
        sched = self.schedule
        if t <= sched[0][0]:
            return sched[0][1]
        for (t0, e0), (t1, e1) in zip(sched, sched[1:]):
            if t < t1:
                frac = (t - t0) / max(1, t1 - t0)
                return e0 + frac * (e1 - e0)
        return sched[-1][1]

    def select_discrete(self, t, greedy_fn, num_actions, rng):
        if rng.random() < self.epsilon(t):
            return int(rng.integers(num_actions))
        return greedy_fn()


class StochasticSampling(Exploration):
    """Sample from the policy distribution (the PPO-family default): the
    module's forward_exploration already samples, so discrete selection
    just defers to it; provided for config parity."""

    def select_discrete(self, t, greedy_fn, num_actions, rng):
        return greedy_fn()

    def perturb_continuous(self, t, action, rng):
        return action


class GaussianNoise(Exploration):
    """Additive Gaussian action noise with linear stddev decay (continuous
    control)."""

    def __init__(self, initial_scale: float = 1.0,
                 final_scale: float = 0.02,
                 scale_timesteps: int = 10_000,
                 stddev: float = 0.1):
        self.initial_scale = initial_scale
        self.final_scale = final_scale
        self.scale_timesteps = scale_timesteps
        self.stddev = stddev

    def _scale(self, t: int) -> float:
        frac = min(1.0, t / max(1, self.scale_timesteps))
        return self.initial_scale + frac * (
            self.final_scale - self.initial_scale)

    def perturb_continuous(self, t, action, rng):
        noise = rng.normal(0.0, self.stddev, size=np.shape(action))
        return np.clip(action + self._scale(t) * noise, -1.0, 1.0)


class OrnsteinUhlenbeckNoise(Exploration):
    """Temporally-correlated OU noise (DDPG-style continuous
    exploration)."""

    def __init__(self, ou_theta: float = 0.15, ou_sigma: float = 0.2,
                 ou_base_scale: float = 0.1):
        self.theta = ou_theta
        self.sigma = ou_sigma
        self.base_scale = ou_base_scale
        self._state: Optional[np.ndarray] = None

    def perturb_continuous(self, t, action, rng):
        if self._state is None or self._state.shape != np.shape(action):
            self._state = np.zeros(np.shape(action))
        self._state = (self._state - self.theta * self._state
                       + self.sigma * rng.normal(size=np.shape(action)))
        return np.clip(action + self.base_scale * self._state, -1.0, 1.0)

    def get_state(self):
        return {"ou_state": self._state}

    def set_state(self, state):
        self._state = state.get("ou_state")


_TYPES = {
    "EpsilonGreedy": EpsilonGreedy,
    "StochasticSampling": StochasticSampling,
    "GaussianNoise": GaussianNoise,
    "OrnsteinUhlenbeckNoise": OrnsteinUhlenbeckNoise,
}


def make_exploration(config: Optional[Dict[str, Any]],
                     default: str = "StochasticSampling") -> Exploration:
    """Build from ``exploration_config`` ({"type": name, **kwargs}); the
    type may also be a class."""
    config = dict(config or {})
    typ = config.pop("type", default)
    if isinstance(typ, str):
        if typ not in _TYPES:
            raise ValueError(f"unknown exploration type {typ!r}; "
                             f"available: {sorted(_TYPES)}")
        typ = _TYPES[typ]
    return typ(**config)
