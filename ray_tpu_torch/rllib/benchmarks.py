"""RLlib sampling benchmark of the port (counterpart of
`ray_tpu/rllib/benchmarks.py` `benchmark_env_steps`): env steps per second
through `EnvRunner.sample` with the conv policy's forward on the device.
Run: python -m ray_tpu_torch.rllib.benchmarks [env_id] [--device cpu]."""

from __future__ import annotations

import json
import time
from typing import Optional

import torch

from ray_tpu_torch._private.device import resolve_device


def benchmark_env_steps(env_id: Optional[str] = None, *, num_envs: int = 8,
                        steps: int = 256, conv_filters=None,
                        hiddens=(256,), env_config: Optional[dict] = None,
                        device=None) -> dict:
    """env-steps/s through EnvRunner.sample (the synthetic image env and
    small convs by default, as in the JAX benchmark)."""
    from ray_tpu_torch.rllib.env_runner import EnvRunner
    from ray_tpu_torch.rllib.envs import SYNTHETIC_ENV_ID, make_env
    from ray_tpu_torch.rllib.rl_module import resolve_module

    dev = resolve_device(device)
    if env_id is None:
        env_id = SYNTHETIC_ENV_ID
        conv_filters = conv_filters or ((16, 3, 2), (32, 3, 2))
    conv_filters = conv_filters or ((32, 8, 4), (64, 4, 2), (64, 3, 1))
    probe = make_env(env_id, env_config)
    obs_shape = tuple(probe.observation_space.shape)
    num_actions = int(probe.action_space.n)
    probe.close()
    spec = {"obs_shape": obs_shape, "num_actions": num_actions,
            "module_class":
                "ray_tpu_torch.rllib.rl_module:ConvActorCriticModule",
            "conv_filters": conv_filters, "hiddens": tuple(hiddens)}
    runner = EnvRunner({"env": env_id, "env_config": env_config,
                        "num_envs_per_env_runner": num_envs,
                        "rollout_fragment_length": steps, "seed": 0,
                        "device": str(dev)}, spec)
    runner.set_weights(resolve_module(
        spec, device=dev, generator=torch.Generator().manual_seed(0))
        .state_dict())
    runner.sample(num_steps=8)  # warm-up: cuDNN picks its algorithms
    t0 = time.perf_counter()
    runner.sample(num_steps=steps)
    dt = time.perf_counter() - t0
    runner.stop()
    return {
        "metric": "rllib_env_steps_per_sec",
        "value": num_envs * steps / dt,
        "unit": "env-steps/s",
        "detail": {"env": env_id, "num_envs": num_envs,
                   "obs_shape": list(obs_shape), "device": str(dev),
                   "device_name": (torch.cuda.get_device_name(dev)
                                   if dev.type == "cuda" else "cpu")},
    }


def main(argv) -> dict:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("env_id", nargs="?", default=None)
    parser.add_argument("--device", default=None)
    args = parser.parse_args(argv)
    return benchmark_env_steps(args.env_id, device=args.device)


if __name__ == "__main__":
    import sys

    print(json.dumps(main(sys.argv[1:])))
