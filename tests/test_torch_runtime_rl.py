"""The port's RLlib on the port's own runtime, on the CPU.

`tests/test_torch_rl_remote.py::test_ppo_over_remote_runners_matches_jax_steps`
with the port's runtime in place of the JAX package's: the port's PPO over
two remote env runners and one remote learner, its actors started by
`ray_tpu_torch` (`AlgorithmConfig.runtime(ray_tpu_torch)`), against JAX's
PPO over `ray_tpu` on the same config. One runtime after the other, never
both at once. The steps sampled must be equal, as in that test.
"""

import numpy as np

import ray_tpu
import ray_tpu_torch
from ray_tpu.rllib import algorithms as jalgos
from ray_tpu_torch._private import actors, serialization
from ray_tpu_torch.rllib.algorithms import PPOConfig

NUM_LEARNERS = 1


def _build(config_cls, **extra):
    cfg = (config_cls().environment("CartPole-v1")
           .env_runners(num_env_runners=2, num_envs_per_env_runner=1,
                        rollout_fragment_length=64)
           .training(train_batch_size=128, minibatch_size=64, num_epochs=2)
           .learners(num_learners=NUM_LEARNERS)
           .debugging(seed=0))
    for k, v in extra.items():
        setattr(cfg, k, v)
    return cfg


def test_ppo_over_the_ports_own_runtime_matches_jax_steps():
    ray_tpu_torch.init(num_cpus=4)
    try:
        algo = _build(PPOConfig, device="cpu").runtime(ray_tpu_torch).build()
        try:
            result = algo.train()
            versions = actors.results(
                [h.get_weights_version.remote()
                 for h in algo.env_runner_group.remotes])
            learners = len(algo.learner_group.remotes)
        finally:
            algo.stop()
    finally:
        ray_tpu_torch.shutdown()
        serialization.uninstall_tensor_wire()
    assert learners == NUM_LEARNERS
    assert result["num_env_steps_sampled"] >= 128
    assert np.isfinite(result["total_loss"])
    assert versions == [algo.learner_group.policy_version] * 2
    assert result["num_learner_updates"] == 4    # 2 epochs x 128 // 64

    ray_tpu.init(num_cpus=4)
    try:
        jalgo = _build(jalgos.PPOConfig).build()
        try:
            want = jalgo.train()
        finally:
            jalgo.stop()
    finally:
        ray_tpu.shutdown()
    assert result["num_env_steps_sampled"] == want["num_env_steps_sampled"]
