"""Env APIs (reference: ray rllib/env/ — MultiAgentEnv multi_agent_env.py;
single-agent runners live in ray_tpu_torch.rllib.env_runner).

The port's copy of `ray_tpu/rllib/env/__init__.py`
(which imports no JAX; the port imports nothing of `ray_tpu`).
"""

from ray_tpu_torch.rllib.env.multi_agent_env import MultiAgentEnv  # noqa: F401

__all__ = ["MultiAgentEnv"]
