"""The port's algorithms: PPO, APPO and IMPALA (the synchronous V-trace
path), DQN, CQL, MARWIL/BC, SAC and DreamerV3."""

from ray_tpu_torch.rllib.algorithms.cql import CQL, CQLConfig  # noqa: F401
from ray_tpu_torch.rllib.algorithms.dqn import DQN, DQNConfig  # noqa: F401
from ray_tpu_torch.rllib.algorithms.dreamerv3 import (  # noqa: F401
    DreamerV3,
    DreamerV3Config,
)
from ray_tpu_torch.rllib.algorithms.impala import (  # noqa: F401
    APPO,
    APPOConfig,
    IMPALA,
    IMPALAConfig,
)
from ray_tpu_torch.rllib.algorithms.marwil import (  # noqa: F401
    BC,
    BCConfig,
    MARWIL,
    MARWILConfig,
)
from ray_tpu_torch.rllib.algorithms.ppo import PPO, PPOConfig  # noqa: F401
from ray_tpu_torch.rllib.algorithms.sac import SAC, SACConfig  # noqa: F401

__all__ = ["APPO", "APPOConfig", "BC", "BCConfig", "CQL", "CQLConfig",
           "DQN", "DQNConfig", "DreamerV3", "DreamerV3Config", "IMPALA",
           "IMPALAConfig", "MARWIL", "MARWILConfig", "PPO", "PPOConfig",
           "SAC", "SACConfig"]
