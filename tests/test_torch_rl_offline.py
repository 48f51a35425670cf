"""The port's copies of RLlib's JAX-free pieces against the JAX package's
originals, on the CPU: the off-policy estimators, the connector pipelines
and the `MultiAgentEnv` base give equal results on the same seeded numpy
inputs (the copies are numpy, so equal means identical)."""

import numpy as np
import pytest

from ray_tpu.rllib import connectors as jconn
from ray_tpu.rllib.env import MultiAgentEnv as JaxMultiAgentEnv
from ray_tpu.rllib.offline import estimators as jest
from ray_tpu_torch.rllib import MultiAgentEnv, connectors as tconn
from ray_tpu_torch.rllib.offline import (DirectMethod, ImportanceSampling,
                                         WeightedImportanceSampling)


def _episodes(seed, n=6):
    r = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        t = int(r.integers(3, 12))
        out.append({"obs": r.standard_normal((t, 4)).astype(np.float32),
                    "actions": r.integers(0, 2, t),
                    "rewards": r.standard_normal(t).astype(np.float32),
                    "action_logp": np.log(r.uniform(0.2, 0.8, t))})
    return out


def _target_logp(obs, actions):
    p = 1.0 / (1.0 + np.exp(-obs[:, 0]))
    return np.log(np.where(actions == 1, p, 1.0 - p))


@pytest.mark.parametrize("name,gamma", [
    ("ImportanceSampling", 1.0), ("ImportanceSampling", 0.9),
    ("WeightedImportanceSampling", 1.0),
    ("WeightedImportanceSampling", 0.95)])
def test_estimators_equal_jax(name, gamma):
    port = {"ImportanceSampling": ImportanceSampling,
            "WeightedImportanceSampling": WeightedImportanceSampling}[name]
    eps = _episodes(3)
    assert port(gamma).estimate(eps, _target_logp) == \
        getattr(jest, name)(gamma).estimate(eps, _target_logp)


def test_direct_method_equals_jax():
    eps = _episodes(4)

    def v_fn(starts):
        return starts.sum(-1) * 2.0
    assert DirectMethod(v_fn).estimate(eps) == \
        jest.DirectMethod(v_fn).estimate(eps)


def test_connector_pipelines_equal_jax():
    r = np.random.default_rng(5)
    batches = [{"obs": {"pos": r.standard_normal((8, 2, 3)),
                        "vel": r.standard_normal((8, 3))},
                "rewards": 4 * r.standard_normal(8)} for _ in range(3)]
    pipes = []
    for mod in (jconn, tconn):
        pipe = mod.ConnectorPipelineV2([mod.FlattenObservations()])
        pipe.append(mod.NormalizeObservations(clip=2.0)).append(
            mod.ClipRewards(0.5))
        pipes.append(pipe)
    for b in batches:
        want = pipes[0]({k: (dict(v) if isinstance(v, dict) else v.copy())
                         for k, v in b.items()})
        got = pipes[1]({k: (dict(v) if isinstance(v, dict) else v.copy())
                        for k, v in b.items()})
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
            assert got[k].dtype == want[k].dtype
    jstate, tstate = pipes[0].get_state(), pipes[1].get_state()
    assert jstate.keys() == tstate.keys()
    np.testing.assert_array_equal(tstate[1]["mean"], jstate[1]["mean"])
    assert tstate[1]["count"] == jstate[1]["count"] == 24


def test_multi_agent_env_base_follows_jax():
    for name in ("reset", "step", "observation_space", "action_space",
                 "close"):
        assert hasattr(MultiAgentEnv, name) and hasattr(JaxMultiAgentEnv,
                                                        name)

    class Env(MultiAgentEnv):
        possible_agents = ["a"]
        observation_spaces = {"a": "box"}
        action_spaces = {"a": "discrete"}

    env = Env()
    assert env.observation_space("a") == "box"
    assert env.action_space("a") == "discrete"
    with pytest.raises(NotImplementedError):
        env.reset()
