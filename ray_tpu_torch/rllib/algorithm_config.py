"""Config-as-object (reference: ray
rllib/algorithms/algorithm_config.py — AlgorithmConfig with chained
.environment()/.env_runners()/.training()/.evaluation() setters and
.build()).

The port's copy of `ray_tpu/rllib/algorithm_config.py` (which imports no
JAX; the port imports nothing of `ray_tpu`), with the port's `device` and
one setter the JAX config lacks: `runtime(...)`, which hands the port the
runtime as values. Remote env runners (PPO, IMPALA, APPO) and
remote learners (PPO) are the runtime's actors, so they need its actor
decorator; `check_local` refuses them without it, and refuses them for an
algorithm that runs no actors. IMPALA's and APPO's decoupled dataflow
(`dataflow(decoupled=True)` with remote env runners) takes the runtime as
one value, with its put, runtime context and event cursor as well
(`rllib/dataflow.py`);
PPO and a group built directly ignore `decoupled`, as JAX's do.
`fault_tolerance()` acts on the remote env runners.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, Optional, Type

from ray_tpu_torch._private.actors import NEEDS_RUNTIME

def check_local(options: Dict[str, Any], remote=None,
                remote_options=("num_env_runners", "num_learners")) -> None:
    """Refuse what the caller cannot run, the same from every entry point
    (`Algorithm`, `EnvRunnerGroup`, `LearnerGroup`): in `options` (a
    config's `to_dict()`, or the share of it a group reads)
    num_env_runners > 0 or num_learners > 0 without the runtime's actor
    decorator `remote` (ValueError naming `runtime(remote=...)`), and either
    of them where the caller does not run that group as actors
    (`remote_options`; NotImplementedError). Nothing falls back to sampling
    or learning in this process."""
    for key in ("num_env_runners", "num_learners"):
        n = options.get(key) or 0
        if n <= 0:
            continue
        if remote is None:
            raise ValueError(f"{key}={n} {NEEDS_RUNTIME}")
        if key not in remote_options:
            raise NotImplementedError(
                f"{key}={n}: this algorithm samples and learns in this "
                f"process only (the JAX package's ignores {key}); set "
                f"{key}=0")


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
        self.num_cpus_per_env_runner: float = 1.0
        self.custom_resources_per_env_runner: Dict[str, float] = {}
        # the runtime's actor decorator and the runtime as one value
        # (`runtime()`), never sent to actors
        self.remote = None
        self.runtime_api = None
        # the decoupled dataflow (IMPALA and APPO with remote env runners)
        # and the crashable fleet of remote env runners
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
                    num_cpus_per_env_runner: Optional[float] = None,
                    custom_resources_per_env_runner: Optional[dict] = None,
                    **_kw) -> "AlgorithmConfig":
        if num_env_runners is not None:
            self.num_env_runners = num_env_runners
        if num_envs_per_env_runner is not None:
            self.num_envs_per_env_runner = num_envs_per_env_runner
        if rollout_fragment_length is not None:
            self.rollout_fragment_length = rollout_fragment_length
        if num_cpus_per_env_runner is not None:
            self.num_cpus_per_env_runner = num_cpus_per_env_runner
        if custom_resources_per_env_runner is not None:
            self.custom_resources_per_env_runner = dict(
                custom_resources_per_env_runner)
        return self

    def runtime(self, api=None, *, remote=None) -> "AlgorithmConfig":
        """The runtime, as values. `remote`: its actor decorator
        (`ray_tpu.remote`), all that remote env runners and learners need.
        `api`: the runtime as one value with `remote`, `put`,
        `get_runtime_context` and `event_cursor` (its EventCursor class),
        which the decoupled dataflow needs (`rllib/dataflow.py`); its
        `remote` is then the decorator too. The JAX config has no such
        setter: the JAX package calls its runtime directly, and the port
        imports nothing of it. Both are kept out of `to_dict()`, which is
        what the actors receive."""
        if api is not None:
            self.runtime_api = api
            self.remote = api.remote
        if remote is not None:
            self.remote = remote
        return self

    def fault_tolerance(
            self, *, restart_failed_env_runners: Optional[bool] = None,
            max_env_runner_restarts: Optional[int] = None,
            **_kw) -> "AlgorithmConfig":
        """Crashable-fleet policy (reference: algorithm_config.py
        fault_tolerance()): a dead remote env runner is replaced, carrying
        the last weights, until max_env_runner_restarts; with
        restart_failed_env_runners=False the loop fails at once."""
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
        """The decoupled rollout/learner dataflow's settings
        (`rllib/dataflow.py`): IMPALA and APPO with remote env runners run
        it; the others ignore it, as in JAX."""
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
        """A deep copy that shares the runtime's values."""
        return copy.deepcopy(self, {id(self.remote): self.remote,
                                    id(self.runtime_api): self.runtime_api})

    def to_dict(self) -> Dict[str, Any]:
        return {k: v for k, v in self.__dict__.items()
                if k not in ("algo_class", "remote", "runtime_api")}

    def build(self):
        if self.algo_class is None:
            raise ValueError(
                "use PPOConfig()/DQNConfig() or pass algo_class")
        return self.algo_class(config=self.copy())
