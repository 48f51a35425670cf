"""Multi-agent PPO in the port against the JAX package's, on the CPU.

Both packages run `MultiAgentPPO` on the same two-agent env (`TargetMatch`,
as `tests/test_rllib_multi_agent.py` defines it) from the same learner
states (each JAX learner's parameters and Adam state converted into the
port's): the runners draw on the host from the same float64 softmax with
the same generator, so the sampled episodes are the same (actions,
rewards and observations equal; logp and values to 1e-5), and each
policy's learner metrics agree at 1e-5 after one and two training steps.
The fail-fast check on the policy mapping, the episode bookkeeping and a
state round trip are held as in the JAX tests.
"""

import jax
import numpy as np
import pytest
import torch

from ray_tpu.rllib import multi_agent as jma
from ray_tpu_torch.rllib import MultiAgentEnv, MultiAgentEpisode
from ray_tpu_torch.rllib import multi_agent as tma
from ray_tpu_torch.rllib.convert import (adam_state_from_jax_numpy,
                                         load_jax_numpy, to_jax_layout)

from test_torch_rl_learners import assert_metrics_close, assert_trees_close


class _Box:
    def __init__(self, dim):
        self.shape = (dim,)


class _Discrete:
    def __init__(self, n):
        self.n = n


class TargetMatch(MultiAgentEnv):
    """Two agents; each observes a one-hot target in {0,1} and gets +1 for
    picking the matching action, -1 otherwise (the JAX test's env)."""

    possible_agents = ["a0", "a1"]

    def __init__(self, horizon: int = 16):
        self.observation_spaces = {a: _Box(2) for a in self.possible_agents}
        self.action_spaces = {a: _Discrete(2) for a in self.possible_agents}
        self.horizon = horizon
        self._rng = np.random.default_rng(0)

    def _obs(self):
        self._targets = {a: int(self._rng.integers(2))
                         for a in self.possible_agents}
        return {a: np.eye(2, dtype=np.float32)[t]
                for a, t in self._targets.items()}

    def reset(self, *, seed=None, options=None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._t = 0
        return self._obs(), {a: {} for a in self.possible_agents}

    def step(self, action_dict):
        rewards = {a: (1.0 if action_dict[a] == self._targets[a] else -1.0)
                   for a in action_dict}
        self._t += 1
        done = self._t >= self.horizon
        obs = self._obs()
        terms = {a: False for a in action_dict}
        terms["__all__"] = done
        truncs = {a: False for a in action_dict}
        truncs["__all__"] = False
        return obs, rewards, terms, truncs, {a: {} for a in action_dict}


def _config(cls, policies, mapping, **extra):
    cfg = (cls().environment(TargetMatch)
           .training(lr=3e-3, train_batch_size=96, minibatch_size=32,
                     num_epochs=2, entropy_coeff=0.01, gamma=0.9)
           .multi_agent(policies=policies, policy_mapping_fn=mapping)
           .debugging(seed=0))
    for k, v in extra.items():
        setattr(cfg, k, v)
    return cfg


def _pair(policies, mapping):
    j = _config(jma.MultiAgentPPOConfig, policies, mapping).build()
    t = _config(tma.MultiAgentPPOConfig, policies, mapping,
                device="cpu").build()
    for pid, jl in j.learners.items():
        tl = t.learners[pid]
        load_jax_numpy(tl.module, jax.device_get(jl.params))
        tl.opt_state = adam_state_from_jax_numpy(
            tl.module, jax.device_get(jl.opt_state))
    return j, t


def _recording(algo):
    seen = []
    sample = algo.runner.sample

    def record(num_steps):
        out = sample(num_steps)
        seen.extend(out)
        return out
    algo.runner.sample = record
    return seen


def _assert_episodes_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.is_done == w.is_done
        assert g.agent_episodes.keys() == w.agent_episodes.keys()
        for aid, wep in w.agent_episodes.items():
            gb, wb = g.agent_episodes[aid].to_batch(), wep.to_batch()
            assert gb.keys() == wb.keys()
            for k in wb:
                if k in ("logp", "vf_preds"):
                    np.testing.assert_allclose(gb[k], wb[k], rtol=1e-5,
                                               atol=1e-6, err_msg=k)
                else:
                    np.testing.assert_array_equal(gb[k], wb[k], err_msg=k)


@pytest.mark.parametrize("policies,mapping", [
    (["shared"], lambda aid: "shared"),
    (["p0", "p1"], lambda aid: "p0" if aid == "a0" else "p1"),
], ids=["shared", "per_agent"])
def test_multi_agent_training_steps_match_jax(policies, mapping):
    j, t = _pair(policies, mapping)
    jeps, teps = _recording(j), _recording(t)
    for _ in range(2):
        want, got = j.train(), t.train()
        _assert_episodes_equal(teps, jeps)
        assert got["num_env_steps_sampled"] == want["num_env_steps_sampled"]
        for pid in policies:
            assert_metrics_close(got[pid], {k: float(v) for k, v in
                                            want[pid].items()})
            assert_trees_close(to_jax_layout(
                t.learners[pid].module.named_parameters()),
                j.learners[pid].params, f"{pid} params")
        np.testing.assert_allclose(got["episode_return_mean"],
                                   want["episode_return_mean"], rtol=1e-6)
    j.stop()
    t.stop()


def test_policy_mapping_fails_fast_as_on_jax():
    for cls, kw in ((jma.MultiAgentPPOConfig, {}),
                    (tma.MultiAgentPPOConfig, {"device": "cpu"})):
        cfg = _config(cls, ["p0"], lambda aid: "p0" if aid == "a0" else "pX",
                      **kw)
        with pytest.raises(ValueError, match="not in policies"):
            cfg.build()
        cfg = _config(cls, ["p0", "p1"], lambda aid: "p0", **kw)
        with pytest.raises(ValueError, match="no agents map to policy"):
            cfg.build()


def test_multi_agent_episode_bookkeeping():
    mae = MultiAgentEpisode()
    mae.agent("a0").add_env_reset(np.zeros(2))
    mae.agent("a0").add_env_step(np.ones(2), 1, 0.5)
    mae.agent("a1").add_env_reset(np.zeros(2))
    assert len(mae) == 1
    assert mae.total_reward == 0.5


def test_multi_agent_checkpoint_round_trip(tmp_path):
    cfg = _config(tma.MultiAgentPPOConfig, ["shared"], lambda aid: "shared",
                  device="cpu")
    algo = cfg.build()
    algo.train()
    ck = algo.save(str(tmp_path / "ma"))
    algo2 = cfg.build()
    algo2.restore(ck)
    for p, q in zip(algo.learners["shared"].module.parameters(),
                    algo2.learners["shared"].module.parameters()):
        assert torch.equal(p, q)
    # the runner acts with the learner's (restored) module
    assert algo2.runner.modules["shared"] is algo2.learners["shared"].module
    algo.stop()
    algo2.stop()


def test_multi_agent_ppo_needs_cuda_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _config(tma.MultiAgentPPOConfig, ["shared"], lambda aid: "shared")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cfg.build()
