"""The port's algorithms: PPO, DQN, CQL, MARWIL/BC, SAC and IMPALA's
synchronous V-trace path. APPO and DreamerV3 wait (ROADMAP.md queue 1,
item 8)."""

from ray_tpu_torch.rllib.algorithms.cql import CQL, CQLConfig  # noqa: F401
from ray_tpu_torch.rllib.algorithms.dqn import DQN, DQNConfig  # noqa: F401
from ray_tpu_torch.rllib.algorithms.impala import (  # noqa: F401
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

__all__ = ["BC", "BCConfig", "CQL", "CQLConfig", "DQN", "DQNConfig",
           "IMPALA", "IMPALAConfig", "MARWIL", "MARWILConfig", "PPO",
           "PPOConfig", "SAC", "SACConfig"]
