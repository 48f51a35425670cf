"""Reinforcement learning in the port: the counterpart of `ray_tpu.rllib`'s
one-process path (num_env_runners = 0, num_learners = 0).

RL modules are `nn.Module`s on an explicit device (`rl_module`); a
learner's update is eager PyTorch with optax's Adam and global-norm clip
(`learner`); the env runner steps the port's own numpy envs (`envs`) with
the policy's forward on the device (`env_runner`); the algorithms
(`algorithms`) are PPO, APPO, IMPALA's V-trace update, DQN, CQL,
MARWIL/BC, SAC and DreamerV3; `multi_agent` runs PPO over a
`MultiAgentEnv`, one learner per policy. `convert` carries the JAX
modules' parameters and Adam state across. Remote env runners and
learners, and the decoupled dataflow, wait for the actor runtime and
raise (ROADMAP.md queue 1, item 5).
"""

from ray_tpu_torch.rllib.algorithm import Algorithm  # noqa: F401
from ray_tpu_torch.rllib.algorithm_config import AlgorithmConfig  # noqa: F401
from ray_tpu_torch.rllib.env import MultiAgentEnv  # noqa: F401
from ray_tpu_torch.rllib.episode import SingleAgentEpisode  # noqa: F401
from ray_tpu_torch.rllib.multi_agent import (  # noqa: F401
    MultiAgentEpisode,
    MultiAgentPPO,
    MultiAgentPPOConfig,
)
from ray_tpu_torch.rllib.replay_buffer import (  # noqa: F401
    PrioritizedReplayBuffer,
    ReplayBuffer,
)

__all__ = ["Algorithm", "AlgorithmConfig", "MultiAgentEnv",
           "MultiAgentEpisode", "MultiAgentPPO", "MultiAgentPPOConfig",
           "PrioritizedReplayBuffer", "ReplayBuffer", "SingleAgentEpisode"]
