"""The port's remote env runners and learners on the runtime's actors, on
the CPU, against in-process runners and against the JAX package's groups.

- (a) Two remote runners return, runner by runner, what in-process
  `EnvRunner(config, spec, worker_index=i + 1)` with the same weights
  returns: obs, actions and rewards exactly, logp and vf_preds within
  1e-6; a `sample` gives as many transitions as JAX's `EnvRunnerGroup`
  with two runners on the same config.
- (b) The port's `LearnerGroup(PPOLearner, ..., num_learners=2)` against
  JAX's on the runtime, from the same converted weights and Adam state, on
  the same batches: the averaged metrics to METRIC_RTOL / METRIC_ATOL,
  every actor holding the mean, and the mean weights to STATE_TOL of the
  scale each learner's own weights are held to: the leaf's largest
  magnitude over the learners before the mean (where two learners step a
  leaf apart, as the policy bias of two actions, its mean is their
  difference's rounding, and its own magnitude no scale).
- (c) PPO over two remote runners (and over two remote learners) with
  `tests/test_rllib.py::test_ppo_with_remote_env_runners`'s settings:
  num_env_steps_sampled at least 128 and equal to JAX's.
- The default device, the card, fails the actor's construction on a host
  without CUDA.

The actors run with device="cpu"; the port's groups take the runtime's
decorator from `runtime(remote=rt.remote)`.
"""

import jax
import numpy as np
import pytest
import torch

import ray_tpu as rt
from ray_tpu.rllib import algorithms as jalgos
from ray_tpu.rllib.algorithms import ppo as jppo
from ray_tpu.rllib.catalog import Catalog as JaxCatalog
from ray_tpu.rllib.env_runner import EnvRunnerGroup as JaxEnvRunnerGroup
from ray_tpu.rllib.learner import LearnerGroup as JaxLearnerGroup
from ray_tpu.rllib.rl_module import resolve_module as jax_resolve_module
from ray_tpu_torch._private import actors, serialization
from ray_tpu_torch.rllib import remote_cases as rc
from ray_tpu_torch.rllib.algorithms import PPOConfig
from ray_tpu_torch.rllib.algorithms import ppo as tppo
from ray_tpu_torch.rllib.convert import (adam_state_from_jax_numpy,
                                         state_from_jax_numpy, to_jax_layout)
from ray_tpu_torch.rllib.env_runner import EnvRunner, EnvRunnerGroup
from ray_tpu_torch.rllib.learner import LearnerGroup
from ray_tpu_torch.rllib.rl_module import resolve_module
from ray_tpu_torch.util import metrics

from test_torch_rl_learners import (MLP_SPEC, STATE_TOL, _flat,
                                    assert_metrics_close, ppo_batch)

STEPS = 32


@pytest.fixture(scope="module")
def cluster():
    rt.init(num_cpus=4)
    yield
    rt.shutdown()


@pytest.fixture(autouse=True)
def _wire_uninstalled():
    """The groups install the typed tensor wire in this process; take it
    out again for the tests that follow."""
    yield
    serialization.uninstall_tensor_wire()


def _config(config_cls, **runners):
    return (config_cls().environment("CartPole-v1")
            .env_runners(**runners).debugging(seed=4))


def test_remote_runners_sample_as_in_process_runners(cluster):
    runners = dict(num_env_runners=2, num_envs_per_env_runner=2)
    config = _config(PPOConfig, **runners).resources(device="cpu").to_dict()
    spec = rc.cartpole_spec()
    weights = resolve_module(spec, device="cpu").state_dict()
    seq = max([e["seq"] for e in metrics.events()] or [0])
    group = EnvRunnerGroup(config, spec, rt.remote)
    try:
        group.sync_weights(weights, version=3)
        assert actors.results([h.get_weights_version.remote()
                               for h in group.remotes]) == [3, 3]
        got = [actors.results([h.sample.remote(num_steps=STEPS)])[0]
               for h in group.remotes]
        together = group.sample(num_steps=STEPS)
    finally:
        group.stop()
    local = dict(config, num_env_runners=0)
    for index, episodes in enumerate(got, start=1):
        runner = EnvRunner(local, spec, worker_index=index)
        runner.set_weights(weights, 3)
        want = runner.sample(num_steps=STEPS)
        a, b = rc.episode_arrays(episodes), rc.episode_arrays(want)
        for k in ("obs", "actions", "rewards"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        for k in ("logp", "vf_preds"):
            np.testing.assert_allclose(a[k], b[k], rtol=0, atol=1e-6,
                                       err_msg=k)
    assert group.restarts == 0
    assert not [e for e in metrics.events("rl.") if e["seq"] > seq]

    jconfig = _config(jalgos.PPOConfig, **runners).to_dict()
    jspec = JaxCatalog.from_env("CartPole-v1", {},
                                jconfig["model"]).actor_critic_spec()
    jgroup = JaxEnvRunnerGroup(jconfig, jspec)
    try:
        jgroup.sync_weights(jax_resolve_module(jspec).init(
            jax.random.PRNGKey(0)), version=3)
        jtogether = jgroup.sample(num_steps=STEPS)
    finally:
        jgroup.stop()
    steps = sum(len(e) for e in together)
    assert steps == sum(len(e) for e in jtogether) == 2 * 2 * STEPS


def _learner_scales(start, batches, config, n=2):
    """Per update, each leaf's largest magnitude over the n learners'
    weights before the mean, from JAX learners in this process that take
    the group's steps."""
    import jax.numpy as jnp

    learners = [jppo.PPOLearner(MLP_SPEC, dict(config, num_learners=0))
                for _ in range(n)]
    params = start["params"]
    opt = [start["opt_state"]] * n
    scales = []
    for batch in batches:
        size = len(batch["obs"])
        for i, learner in enumerate(learners):
            learner.params = jax.tree.map(jnp.array, params)
            learner.opt_state = jax.tree.map(jnp.array, opt[i])
            learner.update_from_batch({k: v[i * size // n:(i + 1) * size // n]
                                       for k, v in batch.items()})
            opt[i] = learner.opt_state
        flat = [_flat(l.params) for l in learners]
        scales.append({k: max(float(np.abs(f[k]).max()) for f in flat)
                       for k in flat[0]})
        params = jax.tree.map(lambda *xs: sum(xs) / len(xs),
                              *[l.params for l in learners])
    return scales


def _assert_mean_close(got, want, scales, what):
    got, want = _flat(to_jax_layout(got)), _flat(jax.device_get(want))
    assert got.keys() == want.keys() == scales.keys(), what
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, rtol=0,
                                   atol=STATE_TOL * (scales[name] or 1.0),
                                   err_msg=f"{what} {name}")


def test_learner_group_matches_jax_on_the_runtime(cluster):
    config = {"lr": 1e-3, "grad_clip": None, "seed": 0,
              "entropy_coeff": 0.01, "num_learners": 2}
    jgroup = JaxLearnerGroup(jppo.PPOLearner, MLP_SPEC, config)
    tgroup = None
    try:
        start = jax.device_get(jgroup.get_state())
        layout = tppo.PPOLearner(MLP_SPEC, dict(config, device="cpu",
                                                num_learners=0))
        tgroup = LearnerGroup(tppo.PPOLearner, MLP_SPEC,
                              dict(config, device="cpu"), rt.remote)
        tgroup.set_state({
            "params": {k: torch.from_numpy(v) for k, v in
                       state_from_jax_numpy(start["params"]).items()},
            "opt_state": adam_state_from_jax_numpy(layout.module,
                                                   start["opt_state"]),
            "policy_version": 0})
        batches = [ppo_batch(seed, n=128) for seed in range(2)]
        scales = _learner_scales(start, batches, config)
        for i, batch in enumerate(batches):
            want = jgroup.update_from_batch(batch)
            got = tgroup.update_from_batch(batch)
            assert set(got) == set(want)
            assert_metrics_close(got, want)
            mean = tgroup.get_weights()
            _assert_mean_close(mean, jgroup.get_weights(), scales[i],
                               f"mean after update {i + 1}")
            for w in actors.results([h.get_weights.remote()
                                     for h in tgroup.remotes]):
                for k, v in mean.items():
                    assert torch.equal(w[k], v), k
        assert tgroup.policy_version == jgroup.policy_version == 2
        # each actor keeps its own Adam moments: only parameters are averaged
        states = actors.results([h.get_state.remote()
                                 for h in tgroup.remotes])
        assert not all(torch.equal(a, b) for a, b in zip(
            states[0]["opt_state"].mu, states[1]["opt_state"].mu))
    finally:
        jgroup.stop()
        if tgroup is not None:
            tgroup.stop()


@pytest.mark.parametrize("num_learners", [0, 2])
def test_ppo_over_remote_runners_matches_jax_steps(cluster, num_learners):
    def build(config_cls, **extra):
        cfg = (config_cls().environment("CartPole-v1")
               .env_runners(num_env_runners=2, num_envs_per_env_runner=1,
                            rollout_fragment_length=64)
               .training(train_batch_size=128, minibatch_size=64,
                         num_epochs=2)
               .learners(num_learners=num_learners)
               .debugging(seed=0))
        for k, v in extra.items():
            setattr(cfg, k, v)
        return cfg.build()

    algo = build(PPOConfig, device="cpu", remote=rt.remote)
    try:
        result = algo.train()
        versions = actors.results(
            [h.get_weights_version.remote()
             for h in algo.env_runner_group.remotes])
    finally:
        algo.stop()
    assert result["num_env_steps_sampled"] >= 128
    assert np.isfinite(result["total_loss"])
    assert versions == [algo.learner_group.policy_version] * 2
    assert result["num_learner_updates"] == 4    # 2 epochs x 128 // 64
    jalgo = build(jalgos.PPOConfig)
    try:
        want = jalgo.train()
    finally:
        jalgo.stop()
    assert result["num_env_steps_sampled"] == want["num_env_steps_sampled"]


def test_the_default_device_fails_the_actors_construction(cluster):
    assert not torch.cuda.is_available()
    config = rc.runner_config(None, num_env_runners=1)
    with pytest.raises(Exception, match="no CUDA device"):
        EnvRunnerGroup(config, rc.cartpole_spec(), rt.remote)
