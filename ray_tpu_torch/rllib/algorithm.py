"""Algorithm base (reference: ray rllib/algorithms/algorithm.py:213 —
a Tune Trainable whose step() (:818) runs one training_step and returns a
result dict; save/restore via checkpoint dirs).

The port's copy of `ray_tpu/rllib/algorithm.py` (which imports no JAX; the
port imports nothing of `ray_tpu`). `remote_options` names the groups an
algorithm runs as actors of the runtime; `check_local` refuses the rest.
"""

from __future__ import annotations

import os
import pickle
from collections import deque
from typing import Any, Dict, Optional

from ray_tpu_torch.rllib.algorithm_config import AlgorithmConfig


class Algorithm:
    # the config options whose actors this algorithm runs (num_env_runners,
    # num_learners); the others must be 0
    remote_options: tuple = ()

    def __init__(self, config: AlgorithmConfig):
        from ray_tpu_torch.rllib.algorithm_config import check_local
        from ray_tpu_torch.rllib.callbacks import make_callbacks

        check_local(config.to_dict(), config.remote, self.remote_options)
        self.config = config
        self.iteration = 0
        self._num_env_steps_sampled_lifetime = 0
        self._episode_returns = deque(maxlen=100)
        self.callbacks = make_callbacks(
            getattr(config, "callbacks_class", None))
        self.setup(config)
        if self.callbacks is not None:
            self.callbacks.on_algorithm_init(algorithm=self)

    # -- subclass API --------------------------------------------------------

    def setup(self, config: AlgorithmConfig) -> None:
        raise NotImplementedError

    def training_step(self) -> Dict[str, Any]:
        raise NotImplementedError

    # -- Trainable-style API -------------------------------------------------

    def train(self) -> Dict[str, Any]:
        self.iteration += 1
        result = self.training_step()
        result.setdefault("training_iteration", self.iteration)
        result.setdefault("num_env_steps_sampled_lifetime",
                          self._num_env_steps_sampled_lifetime)
        if self._episode_returns:
            result.setdefault(
                "episode_return_mean",
                sum(self._episode_returns) / len(self._episode_returns))
        if self.callbacks is not None:
            self.callbacks.on_train_result(algorithm=self, result=result)
        return result

    def _record_episodes(self, episodes) -> None:
        for ep in episodes:
            if self.callbacks is not None and (
                    ep.is_done or (getattr(ep, "is_truncated", False)
                                   and not getattr(ep,
                                                   "is_boundary_fragment",
                                                   False))):
                # boundary fragments are still-running episodes cut at a
                # sample() edge — not ends
                self.callbacks.on_episode_end(episode=ep, algorithm=self)
            self._num_env_steps_sampled_lifetime += len(ep)
            # terminated AND env-truncated (TimeLimit) episodes have a
            # complete return; boundary fragments do not
            if ep.is_done or (ep.is_truncated
                              and not getattr(ep, "is_boundary_fragment",
                                              False)):
                self._episode_returns.append(ep.total_reward)

    def get_state(self) -> Dict[str, Any]:
        return {"iteration": self.iteration,
                "num_env_steps_sampled_lifetime":
                    self._num_env_steps_sampled_lifetime,
                "policy_version": getattr(self, "policy_version", 0)}

    def set_state(self, state: Dict[str, Any]) -> None:
        self.iteration = state.get("iteration", 0)
        self._num_env_steps_sampled_lifetime = state.get(
            "num_env_steps_sampled_lifetime", 0)
        if hasattr(self, "policy_version"):
            # restored learner progress keeps its version monotonic so a
            # checkpoint-restart can't re-accept pre-restart-stale batches
            self.policy_version = state.get("policy_version",
                                            self.policy_version)

    def save(self, checkpoint_dir: str) -> str:
        os.makedirs(checkpoint_dir, exist_ok=True)
        with open(os.path.join(checkpoint_dir, "algo_state.pkl"), "wb") as f:
            pickle.dump(self.get_state(), f)
        if self.callbacks is not None:
            self.callbacks.on_checkpoint_saved(
                algorithm=self, checkpoint_dir=checkpoint_dir)
        return checkpoint_dir

    def restore(self, checkpoint_dir: str) -> None:
        with open(os.path.join(checkpoint_dir, "algo_state.pkl"), "rb") as f:
            self.set_state(pickle.load(f))
        if self.callbacks is not None:
            self.callbacks.on_checkpoint_loaded(
                algorithm=self, checkpoint_dir=checkpoint_dir)

    def stop(self) -> None:
        pass

    @staticmethod
    def _env_spaces(env_id: str, env_config: Optional[dict] = None):
        """(obs, num_actions) for a discrete-action env — obs is a flat dim
        (int) for vector observations or a shape tuple for image (ndim>1)
        observations."""
        from ray_tpu_torch.rllib.envs import make_env

        env = make_env(env_id, env_config)
        try:
            shape = env.observation_space.shape
            obs = tuple(int(d) for d in shape) if len(shape) > 1 \
                else int(shape[0])
            num_actions = int(env.action_space.n)
        finally:
            env.close()
        return obs, num_actions

    def _actor_critic_spec(self, config) -> dict:
        """Module spec for actor-critic algorithms, built by the model
        catalog from the env's observation/action spaces (reference:
        rllib core/models/catalog.py — MLP/CNN/flatten/one-hot/dict-concat
        encoder selection)."""
        from ray_tpu_torch.rllib.catalog import Catalog

        return Catalog.from_env(config.env, config.env_config,
                                config.model).actor_critic_spec()

    def _q_module_spec(self, config) -> dict:
        """Module spec for Q-learning algorithms, via the catalog."""
        from ray_tpu_torch.rllib.catalog import Catalog

        return Catalog.from_env(config.env, config.env_config,
                                config.model).q_spec()
