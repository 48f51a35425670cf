"""The port's algorithms against the JAX package's, on the CPU.

`PPO.training_step` and IMPALA's synchronous step take the same injected
episodes on both sides (torch cannot draw jax.random's actions) and must
leave the same metrics and weights; DQN runs its own sampling loop on the
two CartPoles (the port's copy and gymnasium's), and CQL, MARWIL and BC
train on the same numpy-seeded offline episodes, from the same weights.
PPO learns CartPole as `tests/test_rllib.py::test_ppo_learns_cartpole`
does. The entry points need CUDA unless asked for the CPU, and the
runtime-only options raise.
"""

import jax
import numpy as np
import pytest
import torch

from ray_tpu.rllib import algorithms as jalgos
from ray_tpu.rllib.episode import SingleAgentEpisode as JaxEpisode
from ray_tpu_torch.rllib import algorithms as talgos
from ray_tpu_torch.rllib.convert import (adam_state_from_jax_numpy,
                                         load_jax_numpy, to_jax_layout)
from ray_tpu_torch.rllib.episode import SingleAgentEpisode

from test_torch_rl_learners import assert_metrics_close, assert_trees_close


def _episodes(cls, seed, lengths=(50, 40, 60), obs_dim=4):
    """A terminated episode, an env-truncated one and a boundary fragment
    with logp and vf_preds, from a numpy seed."""
    rng = np.random.default_rng(seed)
    out = []
    for i, n in enumerate(lengths):
        ep = cls()
        ep.add_env_reset(rng.standard_normal(obs_dim).astype(np.float32))
        for t in range(n):
            last = t == n - 1
            ep.add_env_step(
                rng.standard_normal(obs_dim).astype(np.float32),
                np.int64(rng.integers(2)), float(rng.random()),
                terminated=last and i == 0, truncated=last and i > 0,
                logp=np.float32(-0.7 + 0.1 * rng.standard_normal()),
                vf_preds=np.float32(rng.standard_normal()))
        if i == 2:
            ep.is_boundary_fragment = True
        out.append(ep)
    return out


def _injected(algo, group, cls):
    """Each sample() returns the next seeded set of episodes."""
    calls = iter(range(100))
    group.sample = lambda **kw: _episodes(cls, next(calls))


def _ppo_pair(**training):
    def build(config_cls, **extra):
        cfg = (config_cls().environment("CartPole-v1")
               .env_runners(num_env_runners=0, num_envs_per_env_runner=2)
               .training(lr=1e-3, train_batch_size=128, minibatch_size=32,
                         num_epochs=2, entropy_coeff=0.01, **training)
               .debugging(seed=0))
        for k, v in extra.items():
            setattr(cfg, k, v)
        return cfg.build()

    j = build(jalgos.PPOConfig)
    t = build(talgos.PPOConfig, device="cpu")
    jl, tl = j.learner_group.local, t.learner_group.local
    load_jax_numpy(tl.module, jax.device_get(jl.params))
    tl.opt_state = adam_state_from_jax_numpy(
        tl.module, jax.device_get(jl.opt_state))
    t.env_runner_group.sync_weights(tl.get_weights())
    _injected(j, j.env_runner_group, JaxEpisode)
    _injected(t, t.env_runner_group, SingleAgentEpisode)
    return j, t


@pytest.mark.parametrize("grad_clip", [None, 0.05])
def test_ppo_training_step_matches_jax(grad_clip):
    j, t = _ppo_pair(grad_clip=grad_clip)
    for _ in range(2):
        want, got = j.train(), t.train()
        assert set(want) <= set(got)
        assert_metrics_close(got, {k: v for k, v in want.items()
                                   if isinstance(v, (int, float))})
        assert_trees_close(to_jax_layout(
            t.learner_group.local.module.named_parameters()),
            j.learner_group.local.params, "params")
    assert got["num_learner_updates"] == 8  # 150 // 32 minibatches x 2
    runner = t.env_runner_group.local
    for (n, p), (_, q) in zip(runner.module.named_parameters(),
                              t.learner_group.local.module.named_parameters()):
        assert torch.equal(p, q), n
    assert runner.get_weights_version() == t.learner_group.policy_version
    j.stop()
    t.stop()


def test_ppo_state_round_trip(tmp_path):
    j, t = _ppo_pair()
    t.train()
    state = t.get_state()
    t2 = (talgos.PPOConfig().environment("CartPole-v1")
          .resources(device="cpu").debugging(seed=5).build())
    t2.set_state(state)
    assert t2.iteration == 1
    for p, q in zip(t2.learner_group.local.module.parameters(),
                    t.learner_group.local.module.parameters()):
        assert torch.equal(p, q)
    assert t.save(str(tmp_path)) == str(tmp_path)
    for a in (j, t, t2):
        a.stop()


def test_impala_training_step_matches_jax():
    def build(config_cls, **extra):
        cfg = (config_cls().environment("CartPole-v1")
               .env_runners(num_env_runners=0, rollout_fragment_length=32)
               .debugging(seed=0))
        for k, v in extra.items():
            setattr(cfg, k, v)
        return cfg.build()

    j = build(jalgos.IMPALAConfig)
    t = build(talgos.IMPALAConfig, device="cpu")
    load_jax_numpy(t.learner.module, jax.device_get(j.params))
    t.runner_group.sync_weights(t.learner.get_weights())
    _injected(j, j.runner_group, JaxEpisode)
    _injected(t, t.runner_group, SingleAgentEpisode)
    episodes = _episodes(SingleAgentEpisode, 99)
    jb = j._episodes_to_batch(_episodes(JaxEpisode, 99))
    tb = t._episodes_to_batch(episodes)
    assert jb.keys() == tb.keys()
    for k in jb:
        np.testing.assert_allclose(tb[k], jb[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    for _ in range(2):
        want, got = j.train(), t.train()
        assert_metrics_close(got, {k: v for k, v in want.items()
                                   if isinstance(v, (int, float))})
        assert_trees_close(to_jax_layout(t.learner.module.named_parameters()),
                           j.params, "params")
    j.stop()
    t.stop()


def _same_start(jlearner, tlearner):
    load_jax_numpy(tlearner.module, jax.device_get(jlearner.params))
    tlearner.opt_state = adam_state_from_jax_numpy(
        tlearner.module, jax.device_get(jlearner.opt_state))
    if hasattr(tlearner, "sync_target"):
        tlearner.sync_target()


@pytest.mark.parametrize("buffer", ["ReplayBuffer", "PrioritizedReplayBuffer"])
def test_dqn_iterations_match_jax(buffer):
    """DQN's loop on the two CartPoles: epsilon-greedy draws from the same
    numpy generator, greedy actions from the same Q values, the same
    replay draws, the same updates and target syncs."""
    def build(config_cls, **extra):
        cfg = (config_cls().environment("CartPole-v1")
               .training(num_steps_per_iteration=120,
                         num_steps_sampled_before_learning_starts=64,
                         target_network_update_freq=40,
                         epsilon=[(0, 1.0), (150, 0.1)],
                         replay_buffer_config={"type": buffer,
                                               "capacity": 1000})
               .debugging(seed=3))
        for k, v in extra.items():
            setattr(cfg, k, v)
        return cfg.build()

    j = build(jalgos.DQNConfig)
    t = build(talgos.DQNConfig, device="cpu")
    _same_start(j.learner, t.learner)
    j.buffer._rng = np.random.default_rng(1)
    t.buffer._rng = np.random.default_rng(1)
    for _ in range(2):
        want, got = j.train(), t.train()
        assert set(want) == set(got)
        assert_metrics_close(got, want)
    assert want["epsilon"] < 1.0
    assert_trees_close(to_jax_layout(t.learner.module.named_parameters()),
                       j.learner.params, "params")
    assert_trees_close(to_jax_layout(t.learner.target.named_parameters()),
                       j.learner.target_params, "target")
    j.stop()
    t.stop()


def _offline_episodes(seed, n_episodes=6):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_episodes):
        n = int(rng.integers(10, 40))
        obs = rng.standard_normal((n + 1, 4)).astype(np.float32)
        terms = np.zeros(n, bool)
        terms[-1] = rng.random() < 0.7
        out.append({"obs": obs[:-1].tolist(), "next_obs": obs[1:].tolist(),
                    "actions": rng.integers(0, 2, n).tolist(),
                    "rewards": rng.random(n).tolist(),
                    "terminateds": terms.tolist(),
                    "truncateds": np.zeros(n, bool).tolist()})
    return out


@pytest.mark.parametrize("algo", ["CQL", "MARWIL", "BC"])
def test_offline_iterations_match_jax(algo):
    data = _offline_episodes(4)

    def build(pkg, **extra):
        cfg = (getattr(pkg, f"{algo}Config")().environment("CartPole-v1")
               .offline_data(input_=data)
               .training(num_updates_per_iteration=15, train_batch_size=48,
                         minibatch_size=48, **({"target_network_update_freq":
                                                 10} if algo == "CQL" else {}))
               .debugging(seed=2))
        for k, v in extra.items():
            setattr(cfg, k, v)
        return cfg.build()

    j, t = build(jalgos), build(talgos, device="cpu")
    _same_start(j.learner, t.learner)
    for _ in range(2):
        want, got = j.train(), t.train()
        assert set(want) == set(got)
        assert_metrics_close(got, want)
    assert_trees_close(to_jax_layout(t.learner.module.named_parameters()),
                       j.learner.params, "params")
    t.config.evaluation_duration = 1
    assert t.evaluate()["num_episodes"] == 1
    j.stop()
    t.stop()


def test_ppo_learns_cartpole():
    """PPO on the port's CartPole under tests/test_rllib.py's settings."""
    algo = (talgos.PPOConfig()
            .environment("CartPole-v1")
            .env_runners(num_env_runners=0, num_envs_per_env_runner=4,
                         rollout_fragment_length=128)
            .training(lr=1e-3, train_batch_size=1024, minibatch_size=256,
                      num_epochs=8, entropy_coeff=0.01)
            .debugging(seed=0)
            .resources(device="cpu")).build()
    first_return = None
    best = 0.0
    for _ in range(15):
        ret = algo.train().get("episode_return_mean", 0.0)
        if first_return is None and ret > 0:
            first_return = ret
        best = max(best, ret)
    algo.stop()
    assert best > 60.0, f"PPO failed to learn: best return {best}"
    assert best > first_return


def test_sac_trains_on_pendulum_smoke():
    algo = (talgos.SACConfig().environment("Pendulum-v1")
            .training(num_steps_per_iteration=120, train_batch_size=32,
                      num_steps_sampled_before_learning_starts=64,
                      model={"fcnet_hiddens": [32, 32]})
            .debugging(seed=0).resources(device="cpu")).build()
    out = algo.train()
    assert out["buffer_size"] == 120
    assert np.isfinite([out[k] for k in ("critic_loss", "actor_loss",
                                         "alpha")]).all()
    act = algo.compute_single_action(np.zeros(3, np.float32))
    assert act.shape == (1,) and abs(float(act[0])) <= 2.0
    algo.stop()


def test_entry_points_need_cuda_unless_asked_for_cpu(monkeypatch):
    from ray_tpu_torch.rllib.benchmarks import benchmark_env_steps
    from ray_tpu_torch.rllib.env_runner import EnvRunner
    from ray_tpu_torch.rllib.rl_module import resolve_module

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = {"obs_dim": 4, "num_actions": 2}
    for call in (
            lambda: resolve_module(spec),
            lambda: talgos.PPOConfig().environment("CartPole-v1").build(),
            lambda: talgos.DQNConfig().environment("CartPole-v1").build(),
            lambda: talgos.SACConfig().environment("Pendulum-v1").build(),
            lambda: EnvRunner({"env": "CartPole-v1"}, spec),
            lambda: benchmark_env_steps(num_envs=1, steps=2)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert next(resolve_module(spec, device="cpu").parameters()
                ).device.type == "cpu"


@pytest.mark.parametrize("option", ["num_env_runners", "num_learners"])
@pytest.mark.parametrize("name", ["PPO", "IMPALA", "DQN"])
def test_runtime_options_raise(name, option):
    cfg = (getattr(talgos, f"{name}Config")().environment("CartPole-v1")
           .resources(device="cpu"))
    setattr(cfg, option, 2)
    with pytest.raises(NotImplementedError, match="queue 1, item 5"):
        cfg.build()


FLEET_KEYS = ("restart_failed_env_runners", "max_env_runner_restarts",
              "decoupled", "sample_queue_size", "sample_queue_resources",
              "max_sample_staleness", "elastic_min_env_runners",
              "elastic_max_env_runners")


def test_fault_tolerance_and_dataflow_chain_as_on_jax():
    """A config written for the JAX package, with its fleet options, builds
    on the port with the same stored values (defaults included), and with
    0 runners it trains."""
    def chain(config_cls):
        return (config_cls().environment("CartPole-v1")
                .fault_tolerance(restart_failed_env_runners=False,
                                 max_env_runner_restarts=3, unknown=1)
                .dataflow(decoupled=True, sample_queue_size=8,
                          sample_queue_resources={"head": 0.01},
                          max_sample_staleness=1, elastic_min_env_runners=1,
                          elastic_max_env_runners=4)
                .training(train_batch_size=64, minibatch_size=32,
                          num_epochs=1))

    jdef, tdef = jalgos.PPOConfig(), talgos.PPOConfig()
    assert ({k: getattr(jdef, k) for k in FLEET_KEYS}
            == {k: getattr(tdef, k) for k in FLEET_KEYS})
    jcfg, tcfg = chain(jalgos.PPOConfig), chain(talgos.PPOConfig)
    want = {k: getattr(jcfg, k) for k in FLEET_KEYS}
    assert {k: getattr(tcfg, k) for k in FLEET_KEYS} == want
    assert want["max_env_runner_restarts"] == 3 and want["decoupled"]
    algo = tcfg.resources(device="cpu").build()
    result = algo.train()
    assert result["num_env_steps_sampled_lifetime"] >= 64
    algo.stop()


def test_registry_names_the_ported_algorithms():
    from ray_tpu.rllib.algorithms.registry import ALGORITHMS as JAX_ALGORITHMS
    from ray_tpu_torch.rllib.algorithms.registry import (ALGORITHMS,
                                                         get_algorithm_class)

    assert get_algorithm_class("PPO") is talgos.PPO
    assert ALGORITHMS == JAX_ALGORITHMS
    for name in ALGORITHMS:
        assert get_algorithm_class(name) is getattr(talgos, name)
    with pytest.raises(ValueError, match="unknown algorithm"):
        get_algorithm_class("A3C")


def test_benchmark_env_steps_on_the_cpu():
    from ray_tpu_torch.rllib.benchmarks import benchmark_env_steps

    out = benchmark_env_steps(num_envs=2, steps=8, device="cpu")
    assert out["metric"] == "rllib_env_steps_per_sec" and out["value"] > 0
    assert out["detail"]["obs_shape"] == [16, 16, 1]


def test_chip_smoke_phase_m_rehearsed_on_the_cpu(monkeypatch, capsys,
                                                 tmp_path, request):
    """`chip_smoke.py --only m` at tiny sizes with the card stubbed (as
    tests/test_torch_flash_sm90.py rehearses main()): (m-1)'s and (m-2)'s
    checks of every learner, (m-3)'s CartPole run at its real settings and
    the image run and benchmark at tiny ones, (m-4)'s APPO and DreamerV3
    checks and DreamerV3 run at tiny sizes and its multi-agent PPO run at
    its real settings; the last line is the ok object."""
    import json

    from test_torch_flash_sm90 import rehearse_on_the_cpu

    smoke = rehearse_on_the_cpu(monkeypatch, tmp_path, request)
    monkeypatch.setattr(smoke, "RL_OBS_SHAPE", (36, 36, 4))
    monkeypatch.setattr(smoke, "RL_MINIBATCH", 8)
    monkeypatch.setattr(smoke, "RL_IMAGE", dict(
        size=36, num_envs=2, iterations=1,
        training={"train_batch_size": 32, "minibatch_size": 16,
                  "num_epochs": 1}))
    monkeypatch.setattr(smoke, "RL_BENCH", dict(num_envs=2, steps=4))
    # (m-4): DreamerV3 at tiny dims for one iteration (its learning run is
    # tests/test_torch_rl_dreamerv3.py's slow test); multi-agent PPO at its
    # real settings.
    monkeypatch.setattr(smoke, "RL_APPO_ROWS", (2, 4))
    monkeypatch.setattr(smoke, "RL_DREAMER", dict(
        iterations=1, target=0.0, training=dict(
            num_steps_per_iteration=48, train_ratio=1, batch_size_B=2,
            batch_length_T=8, horizon_H=3, deter_dim=16, stoch_groups=2,
            stoch_classes=4, embed_dim=8, hidden_dim=16,
            num_steps_sampled_before_learning_starts=48)))

    def profile_rl(fn, n):
        for _ in range(n):
            fn()
        return 2.0, 1.0, [("aten::mm", 0.5)]

    monkeypatch.setattr(smoke, "profile_rl", profile_rl)
    assert smoke.main(["--only", "m"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    for tag in ("[m-1]", "[m-2]", "[m-3]", "[m] (m-2) SAC", "[m] (m-2) V-trace",
                "[m] (m-4) APPO", "[m-4]", "[m] RLlib"):
        assert any(line.startswith(tag) for line in lines), tag
    assert lines[-3] == "NVIDIA H100 80GB HBM3, 700.00 W"
    rl = json.loads(lines[-2])["rl"]
    assert max(rl["loop"]["cartpole_returns"]) > 60
    assert max(rl["more"]["multi_agent_returns"]) > 8
    assert rl["more"]["dreamer"]["train_step_share"] > 0
    assert rl["module"]["bound_ms"] > 0
    assert json.loads(lines[-1]) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}}


@pytest.mark.parametrize("name,peak", [
    ("NVIDIA H100 80GB HBM3", 67e12), ("NVIDIA H100 PCIe", 51e12),
    ("NVIDIA H100 NVL", 60e12)])
def test_fp32_peak_of_the_h100_parts(name, peak):
    """Phase (m-1)'s bound is taken at the fp32 peak without tensor cores;
    an unknown card raises."""
    from ray_tpu_torch._private.accelerators.nvidia import (
        fp32_peak_flops_per_device)

    assert fp32_peak_flops_per_device(name) == peak
    with pytest.raises(ValueError, match="no peak rates"):
        fp32_peak_flops_per_device("NVIDIA A100-SXM4-80GB")
