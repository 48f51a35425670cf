"""RLlib benchmarks of the port (counterparts of
`ray_tpu/rllib/benchmarks.py`): `benchmark_env_steps`, env steps per
second through `EnvRunner.sample` with the conv policy's forward on the
device, and `benchmark_decoupled`, the env steps per second the learner
consumes from the decoupled dataflow at each rollout-runner count.

Run: python -m ray_tpu_torch.rllib.benchmarks [env_id] [--device cpu], or
python -m ray_tpu_torch.rllib.benchmarks decoupled [--device cpu]
[--duration S], which runs the dataflow's actors as threads of this
process (`rllib.remote_cases.LocalRuntime`); on the runtime, call
`benchmark_decoupled(runtime=...)` with the runtime as one value (README,
"The runtime boundary")."""

from __future__ import annotations

import json
import os
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


def benchmark_decoupled(worker_counts=(1, 2), *, env_id: Optional[str] = None,
                        num_envs: int = 4, fragment: int = 64,
                        duration_s: float = 8.0, device=None,
                        runtime=None) -> dict:
    """The decoupled dataflow's env steps per second against the number of
    rollout runners: the fleet pushes through the bounded sample queue
    while a learner-side consumer drains it, and the number is the steps
    CONSUMED at the learner per second, what training sees, not the raw
    sampling rate; at two or more counts, so it carries a scaling curve.
    `runtime` is `DecoupledDataflow`'s (required)."""
    from ray_tpu_torch.rllib.dataflow import DecoupledDataflow
    from ray_tpu_torch.rllib.envs import SYNTHETIC_ENV_ID, make_env
    from ray_tpu_torch.rllib.rl_module import resolve_module

    dev = resolve_device(device)
    if env_id is None:
        env_id = SYNTHETIC_ENV_ID
    conv_filters = ((16, 3, 2), (32, 3, 2))
    probe = make_env(env_id)
    obs_shape = tuple(probe.observation_space.shape)
    num_actions = int(probe.action_space.n)
    probe.close()
    spec = {"obs_shape": obs_shape, "num_actions": num_actions,
            "module_class":
                "ray_tpu_torch.rllib.rl_module:ConvActorCriticModule",
            "conv_filters": conv_filters, "hiddens": (256,)}
    weights = resolve_module(
        spec, device="cpu", generator=torch.Generator().manual_seed(0)
    ).state_dict()
    per_worker = {}
    for n in worker_counts:
        cfg = {"env": env_id, "num_envs_per_env_runner": num_envs,
               "rollout_fragment_length": fragment, "seed": 0,
               "num_env_runners": n,
               "max_requests_in_flight_per_env_runner": 2,
               "sample_queue_size": 8 * n, "device": str(dev)}
        flow = DecoupledDataflow(cfg, spec, weights, version=0,
                                 runtime=runtime)
        try:
            # warm: the first pulls cover the actors' start and cuDNN's
            # first choices
            deadline = time.perf_counter() + 60.0
            warmed = 0
            while warmed < 2 * n and time.perf_counter() < deadline:
                warmed += len(flow.pull(current_version=0))
                time.sleep(0.02)
            steps = 0
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < duration_s:
                for entry, _eps in flow.pull(current_version=0):
                    steps += int(entry.get("env_steps", 0))
                time.sleep(0.005)
            dt = time.perf_counter() - t0
            per_worker[str(n)] = steps / dt
        finally:
            flow.stop()
    counts = [str(n) for n in worker_counts]
    base = per_worker.get(counts[0]) or 1.0
    top = per_worker.get(counts[-1]) or 0.0
    return {
        "metric": "rllib_decoupled_env_steps_per_sec",
        "value": top,
        "unit": "env-steps/s",
        "detail": {
            "env": env_id,
            "per_worker_counts": per_worker,
            "scaling": top / base if base else None,
            "worker_counts": list(worker_counts),
            "num_envs_per_runner": num_envs,
            "duration_s": duration_s,
            # a host of few cores time-slices the fleet: flat scaling there
            # is the host, not the dataflow
            "host_cpus": os.cpu_count(),
            "device": str(dev),
            "device_name": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu"),
        },
    }


def main(argv) -> dict:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("env_id", nargs="?", default=None,
                        help="an env id, or 'decoupled'")
    parser.add_argument("--device", default=None)
    parser.add_argument("--duration", type=float, default=8.0,
                        help="decoupled: seconds of each runner count")
    args = parser.parse_args(argv)
    if args.env_id == "decoupled":
        from ray_tpu_torch.rllib.remote_cases import LocalRuntime

        runtime = LocalRuntime()
        try:
            out = benchmark_decoupled(duration_s=args.duration,
                                      device=args.device, runtime=runtime)
        finally:
            runtime.shutdown()
        out["detail"]["runtime"] = "stand-in: threads of one process"
        return out
    return benchmark_env_steps(args.env_id, device=args.device)


if __name__ == "__main__":
    import sys

    print(json.dumps(main(sys.argv[1:])))
