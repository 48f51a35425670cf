"""The port's numpy envs against gymnasium's, and its env runner against the
JAX package's, on the CPU.

From the same seed and the same action sequence, CartPole-v1,
Pendulum-v1 and the synthetic image env give the same observations,
rewards and flags step by step as `gymnasium.make` (and as
`ray_tpu.rllib.atari.SyntheticImageEnv`); the port's vector env matches
`gymnasium.vector.SyncVectorEnv` in its default NEXT_STEP autoreset; and
the port's EnvRunner builds the JAX runner's episodes from a given action
sequence.
"""

import sys
from functools import partial

import gymnasium as gym
import numpy as np
import pytest

from ray_tpu.rllib.atari import SyntheticImageEnv as JaxSyntheticImageEnv
from ray_tpu_torch.rllib import envs as tenvs
from ray_tpu_torch.rllib.envs import SyncVectorEnv, make_env


def _balance(obs):
    """A controller that keeps the pole up for the whole 500 steps."""
    return int(obs[2] + 0.5 * obs[3] > 0)


def _run_pair(ref, port, actions_fn, n_steps, seed):
    """Step both envs n_steps from reset(seed); reset (without a seed)
    after each end. -> number of episode ends, truncations."""
    o_ref, _ = ref.reset(seed=seed)
    o_port, _ = port.reset(seed=seed)
    np.testing.assert_array_equal(o_port, o_ref)
    assert o_port.dtype == o_ref.dtype
    ends = truncs = 0
    for t in range(n_steps):
        action = actions_fn(t, o_ref)
        r_ref = ref.step(action)
        r_port = port.step(action)
        np.testing.assert_array_equal(r_port[0], r_ref[0], err_msg=str(t))
        assert r_port[0].dtype == r_ref[0].dtype
        assert float(r_port[1]) == float(r_ref[1])
        assert (bool(r_port[2]), bool(r_port[3])) == (bool(r_ref[2]),
                                                      bool(r_ref[3]))
        if r_ref[2] or r_ref[3]:
            ends += 1
            truncs += bool(r_ref[3])
            o_ref, _ = ref.reset()
            o_port, _ = port.reset()
            np.testing.assert_array_equal(o_port, o_ref)
        else:
            o_ref = r_ref[0]
    return ends, truncs


@pytest.mark.parametrize("seed", [0, 7])
def test_cartpole_matches_gymnasium(seed):
    rng = np.random.default_rng(seed)
    # random actions for 300 steps, then a balancing controller, which
    # reaches the 500-step limit
    ends, truncs = _run_pair(
        gym.make("CartPole-v1"), make_env("CartPole-v1"),
        lambda t, obs: int(rng.integers(2)) if t < 300 else _balance(obs),
        1400, seed)
    assert ends > 5 and truncs >= 1


def test_pendulum_matches_gymnasium():
    rng = np.random.default_rng(3)
    ends, truncs = _run_pair(
        gym.make("Pendulum-v1"), make_env("Pendulum-v1"),
        lambda t, obs: rng.uniform(-2.5, 2.5, (1,)).astype(np.float32),
        450, 11)
    assert ends == truncs == 2


@pytest.mark.parametrize("size", [16, 84])
def test_synthetic_image_env_matches_the_jax_package(size):
    rng = np.random.default_rng(size)
    ends, truncs = _run_pair(
        JaxSyntheticImageEnv(size=size, episode_len=10),
        make_env(tenvs.SYNTHETIC_ENV_ID, {"size": size, "episode_len": 10}),
        lambda t, obs: int(rng.integers(4)), 35, 4)
    assert ends == truncs == 3


@pytest.mark.parametrize("env_id", ["CartPole-v1", "Pendulum-v1"])
def test_spaces_match_gymnasium(env_id):
    ref, port = gym.make(env_id), make_env(env_id)
    for a, b in ((ref.observation_space, port.observation_space),
                 (ref.action_space, port.action_space)):
        assert (a.shape, a.dtype) == (b.shape, b.dtype)
        if hasattr(a, "n"):
            assert a.n == b.n
        else:
            np.testing.assert_array_equal(a.low, b.low)
            np.testing.assert_array_equal(a.high, b.high)


def test_spaces_sample_inside():
    d = tenvs.Discrete(3, seed=1)
    draws = [d.sample() for _ in range(50)]
    assert set(int(x) for x in draws) == {0, 1, 2}
    assert all(d.contains(x) for x in draws) and not d.contains(3)
    box = tenvs.Box(-2.0, 2.0, (2,), np.float32, seed=2)
    x = box.sample()
    assert x.dtype == np.float32 and (np.abs(x) <= 2).all()
    img = tenvs.Box(0, 255, (4, 4, 1), np.uint8, seed=3)
    assert img.sample().dtype == np.uint8
    np.testing.assert_array_equal(
        tenvs.Box(-2.0, 2.0, (2,), np.float32, seed=2).sample(), x)


@pytest.mark.parametrize("env_id,n", [("CartPole-v1", 3), ("Pendulum-v1", 2)])
def test_vector_env_matches_next_step_autoreset(env_id, n):
    """The step after an end ignores its action and returns the reset
    observation with reward 0 and both flags false, as gymnasium 1.x's
    SyncVectorEnv does by default."""
    from gymnasium.vector import AutoresetMode

    ref = gym.vector.SyncVectorEnv([partial(gym.make, env_id)] * n)
    assert ref.metadata["autoreset_mode"] == AutoresetMode.NEXT_STEP
    port = SyncVectorEnv([partial(make_env, env_id)] * n)
    o_ref, _ = ref.reset(seed=5)
    o_port, _ = port.reset(seed=5)
    np.testing.assert_array_equal(o_port, o_ref)
    rng = np.random.default_rng(0)
    autoresets = 0
    for t in range(420):
        if env_id == "CartPole-v1":
            actions = rng.integers(0, 2, n)
        else:
            actions = rng.uniform(-2, 2, (n, 1)).astype(np.float32)
        before = port._autoreset_envs.copy()
        out_ref = ref.step(actions)
        out_port = port.step(actions)
        for a, b in zip(out_port[:4], out_ref[:4]):
            np.testing.assert_array_equal(a, b, err_msg=str(t))
            assert a.dtype == b.dtype
        autoresets += int(before.sum())
        assert (out_port[1][before] == 0).all()
        assert not (out_port[2][before] | out_port[3][before]).any()
    assert autoresets >= 2


def test_make_env_needs_gymnasium_only_for_other_ids(monkeypatch):
    monkeypatch.setitem(sys.modules, "gymnasium", None)
    assert isinstance(make_env("CartPole-v1"), tenvs.TimeLimit)
    assert make_env("CartPole-v1", {"max_episode_steps": 7}) \
        .max_episode_steps == 7
    assert isinstance(make_env(tenvs.SYNTHETIC_ENV_ID),
                      tenvs.SyntheticImageEnv)
    assert make_env(lambda size: tenvs.SyntheticImageEnv(size),
                    {"size": 8}).size == 8
    with pytest.raises(ImportError, match="gymnasium is not installed"):
        make_env("MountainCar-v0")


def test_make_env_takes_other_ids_from_gymnasium():
    env = make_env("MountainCar-v0")
    assert env.observation_space.shape == (2,)
    env.close()


class _Actions:
    """A fixed action sequence in place of the policy's draws: the same
    actions, logp and vf_preds on both runners."""

    def __init__(self, n_envs, num_actions, seed):
        self.rng = np.random.default_rng(seed)
        self.n, self.a = n_envs, num_actions

    def __call__(self):
        return {"actions": self.rng.integers(0, self.a, self.n),
                "logp": self.rng.standard_normal(self.n).astype(np.float32),
                "vf_preds": self.rng.standard_normal(self.n)
                .astype(np.float32)}


def _episode_rows(episodes):
    return [(np.stack(ep.obs), np.asarray(ep.actions), ep.rewards,
             ep.is_done, ep.is_truncated, ep.is_boundary_fragment,
             {k: np.asarray(v) for k, v in ep.extra.items()})
            for ep in episodes]


@pytest.mark.parametrize("n_envs", [1, 3])
def test_runner_builds_the_jax_runners_episodes(n_envs):
    """Same seed, same injected actions: the same episodes (through the
    NEXT_STEP autoreset's first transitions) on both runners."""
    from ray_tpu.rllib.env_runner import EnvRunner as JaxEnvRunner
    from ray_tpu_torch.rllib.env_runner import EnvRunner

    config = {"env": "CartPole-v1", "num_envs_per_env_runner": n_envs,
              "seed": 3, "device": "cpu"}
    spec = {"obs_dim": 4, "num_actions": 2}
    jax_runner = JaxEnvRunner(config, spec)
    src_j, src_t = _Actions(n_envs, 2, 1), _Actions(n_envs, 2, 1)
    jax_runner.params = {}
    jax_runner._act = lambda params, obs, key: src_j()
    runner = EnvRunner(config, spec)
    runner.set_weights(runner.get_weights())
    runner.act = lambda obs, explore=True: src_t()
    for steps in (40, 150):
        want = _episode_rows(jax_runner.sample(num_steps=steps))
        got = _episode_rows(runner.sample(num_steps=steps))
        assert len(got) == len(want)
        assert sum(len(r[1]) for r in got) == n_envs * steps
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[0], w[0])
            np.testing.assert_array_equal(g[1], w[1])
            assert g[2] == w[2] and g[3:6] == w[3:6]
            assert g[6].keys() == w[6].keys()
            for k in w[6]:
                np.testing.assert_array_equal(g[6][k], w[6][k])
    assert any(r[3] for r in want)  # some episode terminated


def test_runner_continuous_actions_rescaled_at_the_env():
    """Episodes keep module-space actions in [-1, 1]; the env gets them
    scaled into [-2, 2]."""
    from ray_tpu_torch.rllib.env_runner import EnvRunner

    runner = EnvRunner({"env": "Pendulum-v1", "seed": 0, "device": "cpu"},
                       {"module_class":
                        "ray_tpu_torch.rllib.rl_module:GaussianActorModule",
                        "obs_dim": 3, "act_dim": 1, "hiddens": (8,)})
    runner.set_weights(runner.get_weights())
    sent = []
    step = runner.envs.envs[0].step
    runner.envs.envs[0].step = lambda a: (sent.append(a), step(a))[1]
    episodes = runner.sample(num_steps=20)
    actions = np.concatenate([np.asarray(e.actions) for e in episodes])
    assert np.abs(actions).max() <= 1
    np.testing.assert_allclose(np.stack(sent), actions * 2.0, rtol=1e-6)
