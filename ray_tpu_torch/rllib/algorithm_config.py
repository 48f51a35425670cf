"""Config-as-object (reference: ray
rllib/algorithms/algorithm_config.py — AlgorithmConfig with chained
.environment()/.env_runners()/.training()/.evaluation() setters and
.build()).

The port's copy of `ray_tpu/rllib/algorithm_config.py` (which imports no
JAX; the port imports nothing of `ray_tpu`), without the runner resources
and with the port's `device`. `fault_tolerance()` and `dataflow()` store
what the JAX config stores, so a config written for the JAX package builds
here; both act only with remote env runners, which `check_local` refuses.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, Optional, Type

# What the port's one-process path cannot run yet: remote env runners and
# learners are actors of the runtime, which the port has not ported.
RUNTIME_ITEM = ("ROADMAP.md queue 1, item 1: remote env runners and "
                "learners wait for the port of the actor runtime")


def check_local(config: Dict[str, Any]) -> None:
    """Raise NotImplementedError for num_env_runners > 0 or num_learners
    > 0 (never fall back to sampling or learning in this process)."""
    for key in ("num_env_runners", "num_learners"):
        if (config.get(key) or 0) > 0:
            raise NotImplementedError(
                f"{key}={config[key]}: the port runs the one-process path "
                f"only ({key}=0); {RUNTIME_ITEM}")


class AlgorithmConfig:
    def __init__(self, algo_class: Optional[Type] = None):
        self.algo_class = algo_class
        # environment
        self.env: Optional[str] = None
        self.env_config: Dict[str, Any] = {}
        # env runners
        self.num_env_runners: int = 0  # 0 = sample in this process
        self.num_envs_per_env_runner: int = 1
        self.rollout_fragment_length: int = 200
        # the decoupled dataflow and the crashable fleet, as the JAX config
        # stores them (read only by remote env runners)
        self.decoupled: bool = False
        self.sample_queue_size: Optional[int] = None
        self.sample_queue_resources: Optional[Dict[str, float]] = None
        self.max_sample_staleness: int = 2
        self.restart_failed_env_runners: bool = True
        self.max_env_runner_restarts: int = 20
        self.elastic_min_env_runners: Optional[int] = None
        self.elastic_max_env_runners: Optional[int] = None
        # training
        self.lr: float = 3e-4
        self.gamma: float = 0.99
        self.train_batch_size: int = 4000
        self.minibatch_size: int = 128
        self.num_epochs: int = 8
        self.grad_clip: Optional[float] = None
        self.model: Dict[str, Any] = {"fcnet_hiddens": [64, 64]}
        # PPO
        self.lambda_: float = 0.95
        self.clip_param: float = 0.2
        self.vf_loss_coeff: float = 0.5
        self.entropy_coeff: float = 0.0
        # DQN
        self.epsilon: list = [(0, 1.0), (10_000, 0.05)]
        self.target_network_update_freq: int = 500
        self.replay_buffer_config: Dict[str, Any] = {
            "type": "ReplayBuffer", "capacity": 50_000}
        self.num_steps_sampled_before_learning_starts: int = 1000
        # learners
        self.num_learners: int = 0
        # offline (BC/MARWIL/CQL: input_ = episode-JSON paths/dirs)
        self.input_: Optional[Any] = None
        self.beta: float = 1.0  # MARWIL advantage coefficient (0 == BC)
        self.cql_alpha: float = 1.0  # CQL conservative penalty weight
        # evaluation
        self.evaluation_interval: Optional[int] = None
        self.evaluation_duration: int = 5
        # misc
        self.seed: Optional[int] = None
        self.explore: bool = True
        self.callbacks_class = None  # RLlibCallback subclass/instance
        # the port's device for modules and learners: None = cuda (raises
        # without CUDA), "cpu" only when asked for by name
        self.device: Optional[str] = None

    # -- chained setters -----------------------------------------------------

    def environment(self, env: Optional[str] = None, *,
                    env_config: Optional[dict] = None) -> "AlgorithmConfig":
        if env is not None:
            self.env = env
        if env_config is not None:
            self.env_config = env_config
        return self

    def env_runners(self, *, num_env_runners: Optional[int] = None,
                    num_envs_per_env_runner: Optional[int] = None,
                    rollout_fragment_length: Optional[int] = None,
                    **_kw) -> "AlgorithmConfig":
        if num_env_runners is not None:
            self.num_env_runners = num_env_runners
        if num_envs_per_env_runner is not None:
            self.num_envs_per_env_runner = num_envs_per_env_runner
        if rollout_fragment_length is not None:
            self.rollout_fragment_length = rollout_fragment_length
        return self

    def fault_tolerance(
            self, *, restart_failed_env_runners: Optional[bool] = None,
            max_env_runner_restarts: Optional[int] = None,
            **_kw) -> "AlgorithmConfig":
        """Crashable-fleet policy (reference: algorithm_config.py
        fault_tolerance()); stored for remote env runners."""
        if restart_failed_env_runners is not None:
            self.restart_failed_env_runners = restart_failed_env_runners
        if max_env_runner_restarts is not None:
            self.max_env_runner_restarts = max_env_runner_restarts
        return self

    def dataflow(self, *, decoupled: Optional[bool] = None,
                 sample_queue_size: Optional[int] = None,
                 sample_queue_resources: Optional[dict] = None,
                 max_sample_staleness: Optional[int] = None,
                 elastic_min_env_runners: Optional[int] = None,
                 elastic_max_env_runners: Optional[int] = None,
                 **_kw) -> "AlgorithmConfig":
        """The decoupled rollout/learner dataflow's settings (JAX:
        rllib/dataflow.py); stored for remote env runners."""
        if decoupled is not None:
            self.decoupled = decoupled
        if sample_queue_size is not None:
            self.sample_queue_size = sample_queue_size
        if sample_queue_resources is not None:
            self.sample_queue_resources = dict(sample_queue_resources)
        if max_sample_staleness is not None:
            self.max_sample_staleness = max_sample_staleness
        if elastic_min_env_runners is not None:
            self.elastic_min_env_runners = elastic_min_env_runners
        if elastic_max_env_runners is not None:
            self.elastic_max_env_runners = elastic_max_env_runners
        return self

    def training(self, **kwargs) -> "AlgorithmConfig":
        for k, v in kwargs.items():
            key = "lambda_" if k == "lambda" else k
            if not hasattr(self, key):
                raise ValueError(f"unknown training option {k!r}")
            setattr(self, key, v)
        return self

    def offline_data(self, *, input_: Optional[Any] = None,
                     **_kw) -> "AlgorithmConfig":
        if input_ is not None:
            self.input_ = input_
        return self

    def evaluation(self, *, evaluation_interval: Optional[int] = None,
                   evaluation_duration: Optional[int] = None,
                   **_kw) -> "AlgorithmConfig":
        if evaluation_interval is not None:
            self.evaluation_interval = evaluation_interval
        if evaluation_duration is not None:
            self.evaluation_duration = evaluation_duration
        return self

    def learners(self, *, num_learners: Optional[int] = None,
                 **_kw) -> "AlgorithmConfig":
        if num_learners is not None:
            self.num_learners = num_learners
        return self

    def callbacks(self, callbacks_class) -> "AlgorithmConfig":
        """Install an RLlibCallback (reference:
        algorithm_config.py callbacks())."""
        self.callbacks_class = callbacks_class
        return self

    def debugging(self, *, seed: Optional[int] = None,
                  **_kw) -> "AlgorithmConfig":
        if seed is not None:
            self.seed = seed
        return self

    def resources(self, *, device: Optional[str] = None,
                  **_kw) -> "AlgorithmConfig":
        """The port's device ("cuda", "cuda:1", "cpu"; None = cuda)."""
        if device is not None:
            self.device = device
        return self

    def copy(self) -> "AlgorithmConfig":
        return copy.deepcopy(self)

    def to_dict(self) -> Dict[str, Any]:
        return {k: v for k, v in self.__dict__.items()
                if k != "algo_class"}

    def build(self):
        if self.algo_class is None:
            raise ValueError(
                "use PPOConfig()/DQNConfig() or pass algo_class")
        return self.algo_class(config=self.copy())
