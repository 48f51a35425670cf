"""Reinforcement learning in the port: the counterpart of `ray_tpu.rllib`.

RL modules are `nn.Module`s on an explicit device (`rl_module`); a
learner's update is eager PyTorch with optax's Adam and global-norm clip
(`learner`); the env runner steps the port's own numpy envs (`envs`) with
the policy's forward on the device (`env_runner`). `EnvRunnerGroup` and
`LearnerGroup` run one runner and one learner in this process, or remote
runners and learners as actors of the runtime, built with the actor
decorator that `AlgorithmConfig.runtime(remote=ray_tpu.remote)` hands in
(PPO runs both; IMPALA and APPO run runners, pipelined). The algorithms
(`algorithms`) are PPO, APPO, IMPALA's V-trace update, DQN, CQL,
MARWIL/BC, SAC and DreamerV3; `multi_agent` runs PPO over a
`MultiAgentEnv`, one learner per policy. `convert` carries the JAX
modules' parameters and Adam state across. `dataflow` is the decoupled,
crashable rollout/learner dataflow (`SampleQueueActor`, `RolloutFleet`,
`DecoupledDataflow`), which IMPALA and APPO run with
`dataflow(decoupled=True)` over the runtime as one value
(`AlgorithmConfig.runtime(api)`).
"""

from ray_tpu_torch.rllib.algorithm import Algorithm  # noqa: F401
from ray_tpu_torch.rllib.algorithm_config import AlgorithmConfig  # noqa: F401
from ray_tpu_torch.rllib.dataflow import (  # noqa: F401
    DecoupledDataflow,
    RolloutFleet,
    SampleQueueActor,
)
from ray_tpu_torch.rllib.env import MultiAgentEnv  # noqa: F401
from ray_tpu_torch.rllib.env_runner import (  # noqa: F401
    EnvRunner,
    EnvRunnerGroup,
)
from ray_tpu_torch.rllib.episode import SingleAgentEpisode  # noqa: F401
from ray_tpu_torch.rllib.learner import LearnerGroup  # noqa: F401
from ray_tpu_torch.rllib.multi_agent import (  # noqa: F401
    MultiAgentEpisode,
    MultiAgentPPO,
    MultiAgentPPOConfig,
)
from ray_tpu_torch.rllib.replay_buffer import (  # noqa: F401
    PrioritizedReplayBuffer,
    ReplayBuffer,
)

__all__ = ["Algorithm", "AlgorithmConfig", "DecoupledDataflow", "EnvRunner",
           "EnvRunnerGroup", "LearnerGroup", "MultiAgentEnv",
           "MultiAgentEpisode", "MultiAgentPPO", "MultiAgentPPOConfig",
           "PrioritizedReplayBuffer", "ReplayBuffer", "RolloutFleet",
           "SampleQueueActor", "SingleAgentEpisode"]
