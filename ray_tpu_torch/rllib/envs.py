"""The environments the port's RL path runs, in numpy, without gymnasium.

The card's machine has no gymnasium, so the port keeps its own copies of
what its tests and `chip_smoke.py` step: CartPole-v1 (500-step limit) and
Pendulum-v1 (200-step limit), copied from gymnasium 1.x's classic-control
envs step for step; `SyntheticImageEnv` (`ray_tpu/rllib/atari.py`); the
`Discrete` and `Box` spaces they declare; a `TimeLimit`; and a synchronous
vector env. `make_env` maps those ids to the copies and imports gymnasium
only for any other id (raising if it is absent).

Seeding is gymnasium's: `reset(seed=s)` draws from
`np.random.default_rng(s)` (what `gymnasium.utils.seeding.np_random(s)`
builds), and the vector env seeds env i with s + i.

`SyncVectorEnv` autoresets as gymnasium 1.x's does by default
(`AutoresetMode.NEXT_STEP`): the step after a sub-env's termination or
truncation ignores its action and returns that env's reset observation
with reward 0 and both flags false. The env runner records that step as
the first transition of the next episode, as the JAX runner does over
gymnasium's vector env; the port keeps this as a contract.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

# The JAX package's id for the synthetic image env, so its configs carry over.
SYNTHETIC_ENV_ID = "ray_tpu/SyntheticImage-v0"


class Space:
    """What the port's envs and runner use of a gymnasium space."""

    def __init__(self, shape, dtype, seed: Optional[int] = None):
        self.shape = tuple(shape)
        self.dtype = np.dtype(dtype)
        self._np_random = (None if seed is None
                           else np.random.default_rng(seed))

    @property
    def np_random(self) -> np.random.Generator:
        if self._np_random is None:
            self._np_random = np.random.default_rng()
        return self._np_random


class Discrete(Space):
    """{0, ..., n - 1}."""

    def __init__(self, n: int, seed: Optional[int] = None):
        super().__init__((), np.int64, seed)
        self.n = int(n)

    def sample(self) -> np.int64:
        return self.np_random.integers(self.n)

    def contains(self, x) -> bool:
        x = np.asarray(x)
        return (x.shape == () and np.issubdtype(x.dtype, np.integer)
                and 0 <= int(x) < self.n)

    def __repr__(self) -> str:
        return f"Discrete({self.n})"


class Box(Space):
    """A box in R^shape (or an integer box, as uint8 images are)."""

    def __init__(self, low, high, shape: Optional[Sequence[int]] = None,
                 dtype=np.float32, seed: Optional[int] = None):
        dtype = np.dtype(dtype)
        if shape is None:
            shape = np.shape(low) if np.ndim(low) else np.shape(high)
        super().__init__(shape, dtype, seed)
        self.low = np.broadcast_to(np.asarray(low, dtype), self.shape).copy()
        self.high = np.broadcast_to(np.asarray(high, dtype),
                                    self.shape).copy()

    def sample(self) -> np.ndarray:
        if self.dtype.kind == "f":
            bounded = np.isfinite(self.low) & np.isfinite(self.high)
            out = self.np_random.normal(size=self.shape)
            out[bounded] = self.np_random.uniform(
                self.low[bounded], self.high[bounded])
            return out.astype(self.dtype)
        return self.np_random.integers(
            self.low.astype(np.int64), self.high.astype(np.int64) + 1,
            size=self.shape).astype(self.dtype)

    def __repr__(self) -> str:
        return f"Box({self.shape}, {self.dtype})"


class Env:
    """gymnasium.Env's seeding: reset(seed=s) reseeds `np_random`."""

    observation_space: Space
    action_space: Space
    _np_random: Optional[np.random.Generator] = None

    @property
    def np_random(self) -> np.random.Generator:
        if self._np_random is None:
            self._np_random = np.random.default_rng()
        return self._np_random

    def reset(self, *, seed: Optional[int] = None,
              options: Optional[dict] = None):
        if seed is not None:
            self._np_random = np.random.default_rng(seed)

    def close(self) -> None:
        pass


class CartPoleEnv(Env):
    """gymnasium's CartPoleEnv (classic_control/cartpole.py), euler
    integration, float64 state, float32 observations."""

    def __init__(self, sutton_barto_reward: bool = False):
        self._sutton_barto_reward = sutton_barto_reward
        self.gravity = 9.8
        self.masscart = 1.0
        self.masspole = 0.1
        self.total_mass = self.masspole + self.masscart
        self.length = 0.5  # half the pole's length
        self.polemass_length = self.masspole * self.length
        self.force_mag = 10.0
        self.tau = 0.02
        self.theta_threshold_radians = 12 * 2 * math.pi / 360
        self.x_threshold = 2.4
        high = np.array([self.x_threshold * 2, np.inf,
                         self.theta_threshold_radians * 2, np.inf],
                        dtype=np.float32)
        self.action_space = Discrete(2)
        self.observation_space = Box(-high, high, dtype=np.float32)
        self.state: Optional[np.ndarray] = None
        self.steps_beyond_terminated = None

    def step(self, action):
        if not self.action_space.contains(action):
            raise ValueError(f"{action!r} ({type(action)}) invalid")
        if self.state is None:
            raise RuntimeError("Call reset before using step method.")
        x, x_dot, theta, theta_dot = self.state
        force = self.force_mag if action == 1 else -self.force_mag
        costheta = np.cos(theta)
        sintheta = np.sin(theta)
        temp = (force + self.polemass_length * np.square(theta_dot)
                * sintheta) / self.total_mass
        thetaacc = (self.gravity * sintheta - costheta * temp) / (
            self.length * (4.0 / 3.0 - self.masspole * np.square(costheta)
                           / self.total_mass))
        xacc = temp - self.polemass_length * thetaacc * costheta \
            / self.total_mass
        x = x + self.tau * x_dot
        x_dot = x_dot + self.tau * xacc
        theta = theta + self.tau * theta_dot
        theta_dot = theta_dot + self.tau * thetaacc
        self.state = np.array((x, x_dot, theta, theta_dot), dtype=np.float64)
        terminated = bool(x < -self.x_threshold or x > self.x_threshold
                          or theta < -self.theta_threshold_radians
                          or theta > self.theta_threshold_radians)
        if not terminated:
            reward = 0.0 if self._sutton_barto_reward else 1.0
        elif self.steps_beyond_terminated is None:
            self.steps_beyond_terminated = 0
            reward = -1.0 if self._sutton_barto_reward else 1.0
        else:
            self.steps_beyond_terminated += 1
            reward = -1.0 if self._sutton_barto_reward else 0.0
        return (np.array(self.state, dtype=np.float32), reward, terminated,
                False, {})

    def reset(self, *, seed=None, options=None):
        super().reset(seed=seed)
        low, high = _reset_bounds(options, "low", "high", -0.05, 0.05)
        self.state = self.np_random.uniform(low=low, high=high, size=(4,))
        self.steps_beyond_terminated = None
        return np.array(self.state, dtype=np.float32), {}


def _reset_bounds(options, lo_key, hi_key, lo, hi):
    if options is None:
        return lo, hi
    return float(options.get(lo_key, lo)), float(options.get(hi_key, hi))


class PendulumEnv(Env):
    """gymnasium's PendulumEnv (classic_control/pendulum.py)."""

    def __init__(self, g: float = 10.0):
        self.max_speed = 8
        self.max_torque = 2.0
        self.dt = 0.05
        self.g = g
        self.m = 1.0
        self.l = 1.0  # noqa: E741 — gymnasium's name
        high = np.array([1.0, 1.0, self.max_speed], dtype=np.float32)
        self.action_space = Box(-self.max_torque, self.max_torque, (1,),
                                np.float32)
        self.observation_space = Box(-high, high, dtype=np.float32)
        self.state: Optional[np.ndarray] = None

    def step(self, u):
        th, thdot = self.state
        g, m, length, dt = self.g, self.m, self.l, self.dt
        u = np.clip(u, -self.max_torque, self.max_torque)[0]
        costs = (_angle_normalize(th) ** 2 + 0.1 * thdot ** 2
                 + 0.001 * (u ** 2))
        newthdot = thdot + (3 * g / (2 * length) * np.sin(th)
                            + 3.0 / (m * length ** 2) * u) * dt
        newthdot = np.clip(newthdot, -self.max_speed, self.max_speed)
        newth = th + newthdot * dt
        self.state = np.array([newth, newthdot])
        return self._get_obs(), -costs, False, False, {}

    def reset(self, *, seed=None, options=None):
        super().reset(seed=seed)
        x, y = _reset_bounds(options, "x_init", "y_init", np.pi, 1.0)
        high = np.array([x, y])
        self.state = self.np_random.uniform(low=-high, high=high)
        return self._get_obs(), {}

    def _get_obs(self):
        theta, thetadot = self.state
        return np.array([np.cos(theta), np.sin(theta), thetadot],
                        dtype=np.float32)


def _angle_normalize(x):
    return ((x + np.pi) % (2 * np.pi)) - np.pi


class SyntheticImageEnv(Env):
    """`ray_tpu/rllib/atari.py`'s image env with a learnable policy: each
    step shows a [size, size, 1] uint8 image with one bright quadrant; the
    action naming the quadrant scores +1. Episodes truncate after
    episode_len steps."""

    def __init__(self, size: int = 16, episode_len: int = 32,
                 seed: Optional[int] = None):
        self.size = size
        self.episode_len = episode_len
        self.observation_space = Box(0, 255, (size, size, 1), np.uint8)
        self.action_space = Discrete(4)
        self._rng = np.random.default_rng(seed)
        self._t = 0
        self._target = 0

    def _obs(self):
        img = np.zeros((self.size, self.size, 1), np.uint8)
        h = self.size // 2
        r, c = divmod(self._target, 2)
        img[r * h:(r + 1) * h, c * h:(c + 1) * h, 0] = 255
        return img

    def reset(self, *, seed=None, options=None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._t = 0
        self._target = int(self._rng.integers(4))
        return self._obs(), {}

    def step(self, action):
        reward = 1.0 if int(action) == self._target else 0.0
        self._t += 1
        self._target = int(self._rng.integers(4))
        return self._obs(), reward, False, self._t >= self.episode_len, {}


class TimeLimit:
    """Truncate after max_episode_steps steps (gymnasium's TimeLimit)."""

    def __init__(self, env, max_episode_steps: int):
        self.env = env
        self.max_episode_steps = max_episode_steps
        self.observation_space = env.observation_space
        self.action_space = env.action_space
        self._elapsed_steps = None

    def step(self, action):
        obs, reward, terminated, truncated, info = self.env.step(action)
        self._elapsed_steps += 1
        if self._elapsed_steps >= self.max_episode_steps:
            truncated = True
        return obs, reward, terminated, truncated, info

    def reset(self, *, seed=None, options=None):
        self._elapsed_steps = 0
        return self.env.reset(seed=seed, options=options)

    def close(self) -> None:
        self.env.close()


def _stack(space, items: List[Any]):
    """gymnasium's `concatenate`: a batch in the space's dtype; dict and
    tuple spaces leaf by leaf."""
    spaces = getattr(space, "spaces", None)
    if isinstance(spaces, dict):
        return {k: _stack(s, [it[k] for it in items])
                for k, s in spaces.items()}
    if spaces is not None:
        return tuple(_stack(s, [it[i] for it in items])
                     for i, s in enumerate(spaces))
    return np.stack([np.asarray(it) for it in items]).astype(space.dtype)


class SyncVectorEnv:
    """n envs stepped in turn, with NEXT_STEP autoreset (module
    docstring)."""

    def __init__(self, env_fns: Sequence[Callable[[], Any]]):
        self.envs = [fn() for fn in env_fns]
        self.num_envs = len(self.envs)
        self.single_observation_space = self.envs[0].observation_space
        self.single_action_space = self.envs[0].action_space
        n = self.num_envs
        self._obs: List[Any] = [None] * n
        self._rewards = np.zeros(n, np.float64)
        self._terminations = np.zeros(n, np.bool_)
        self._truncations = np.zeros(n, np.bool_)
        self._autoreset_envs = np.zeros(n, np.bool_)

    def reset(self, *, seed=None, options=None):
        n = self.num_envs
        if seed is None:
            seeds = [None] * n
        elif isinstance(seed, int):
            seeds = [seed + i for i in range(n)]
        else:
            seeds = list(seed)
        self._terminations[:] = False
        self._truncations[:] = False
        self._autoreset_envs[:] = False
        for i, (env, s) in enumerate(zip(self.envs, seeds)):
            self._obs[i], _ = env.reset(seed=s, options=options)
        return _stack(self.single_observation_space, self._obs), {}

    def step(self, actions):
        for i, env in enumerate(self.envs):
            if self._autoreset_envs[i]:
                self._obs[i], _ = env.reset()
                self._rewards[i] = 0.0
                self._terminations[i] = False
                self._truncations[i] = False
            else:
                (self._obs[i], self._rewards[i], self._terminations[i],
                 self._truncations[i], _) = env.step(actions[i])
        self._autoreset_envs = np.logical_or(self._terminations,
                                             self._truncations)
        return (_stack(self.single_observation_space, self._obs),
                self._rewards.copy(), self._terminations.copy(),
                self._truncations.copy(), {})

    def close(self) -> None:
        for env in self.envs:
            env.close()


# id -> (env class, step limit or None)
_BUILTIN: Dict[str, Any] = {
    "CartPole-v1": (CartPoleEnv, 500),
    "Pendulum-v1": (PendulumEnv, 200),
    SYNTHETIC_ENV_ID: (SyntheticImageEnv, None),
}


def make_env(env_id, env_config: Optional[dict] = None):
    """env_id: an env-creator callable, one of the port's own ids
    (CartPole-v1, Pendulum-v1, the synthetic image env), or any other
    gymnasium id ("ALE/..." through the Atari pipeline), which needs
    gymnasium."""
    cfg = dict(env_config or {})
    if callable(env_id):
        return env_id(**cfg)
    if env_id in _BUILTIN:
        cls, limit = _BUILTIN[env_id]
        limit = cfg.pop("max_episode_steps", limit)
        env = cls(**cfg)
        return TimeLimit(env, limit) if limit else env
    try:
        import gymnasium as gym
    except ImportError as e:
        raise ImportError(
            f"env {env_id!r} is not one of the port's own envs "
            f"({sorted(_BUILTIN)}) and gymnasium is not installed") from e
    if isinstance(env_id, str) and env_id.startswith("ALE/"):
        pipeline = {k: cfg.pop(k)
                    for k in ("frame_stack", "screen_size", "frameskip")
                    if k in cfg}
        return make_atari_env(env_id, **pipeline, env_config=cfg)
    return gym.make(env_id, **cfg)


def make_atari_env(env_id: str, *, frame_stack: int = 4,
                   screen_size: int = 84, frameskip: int = 4,
                   env_config: Optional[dict] = None):
    """The Atari pipeline of `ray_tpu/rllib/atari.py` (gymnasium and
    ale_py): AtariPreprocessing + frame stack -> uint8 [screen_size,
    screen_size, frame_stack]."""
    import gymnasium as gym

    try:
        import ale_py
        gym.register_envs(ale_py)
    except ImportError as e:
        raise ImportError(
            "Atari environments require the 'ale-py' package") from e
    env = gym.make(env_id, frameskip=1, **(env_config or {}))
    env = gym.wrappers.AtariPreprocessing(
        env, frame_skip=frameskip, screen_size=screen_size,
        grayscale_obs=True, grayscale_newaxis=False, scale_obs=False)
    env = gym.wrappers.FrameStackObservation(env, stack_size=frame_stack)
    return gym.wrappers.TransformObservation(
        env, lambda obs: np.moveaxis(obs, 0, -1),
        observation_space=gym.spaces.Box(
            0, 255, (screen_size, screen_size, frame_stack), np.uint8))
