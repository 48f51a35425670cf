"""EnvRunner: samples episodes from the port's vector env with the policy
on the device.

Counterpart of `ray_tpu/rllib/env_runner.py`'s EnvRunner (:47-218) and
of its EnvRunnerGroup with no remote runners. Each env step is one
`forward_exploration` of the module on the device (eval mode, no
autograd), its actions drawn from the runner's `torch.Generator`, seeded
seed * 1000 + worker_index as the JAX runner seeds its key; the actions,
logp and value predictions come back to the host for the envs. Continuous
actions stay in module space ([-1, 1]) in the episodes and are rescaled
into the action space's bounds at the env boundary.

`num_env_runners > 0` (runner actors) needs the actor runtime and raises.
"""

from __future__ import annotations

from functools import partial
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch.rllib.algorithm_config import check_local
from ray_tpu_torch.rllib.envs import SyncVectorEnv, make_env
from ray_tpu_torch.rllib.episode import SingleAgentEpisode
from ray_tpu_torch.rllib.rl_module import resolve_module

__all__ = ["EnvRunner", "EnvRunnerGroup", "make_env"]


def obs_to_device(obs, device):
    """Observations for the module: uint8 images ship raw (1 byte a pixel;
    the module divides by 255 on the device), everything else fp32; dict
    and tuple observations leaf by leaf."""
    if isinstance(obs, dict):
        return {k: obs_to_device(v, device) for k, v in obs.items()}
    if isinstance(obs, tuple):
        return tuple(obs_to_device(v, device) for v in obs)
    arr = np.asarray(obs)
    if arr.dtype != np.uint8:
        arr = arr.astype(np.float32)
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


class EnvRunner:
    """One sampling worker in the algorithm's own process."""

    def __init__(self, config: Dict[str, Any], module_spec: Dict[str, Any],
                 worker_index: int = 0):
        self.config = config
        self.worker_index = worker_index
        self.device = resolve_device(config.get("device"))
        n_envs = config.get("num_envs_per_env_runner", 1)
        self.envs = SyncVectorEnv(
            [partial(make_env, config["env"], config.get("env_config"))
             for _ in range(n_envs)])
        self.n_envs = n_envs
        self.module = resolve_module(module_spec, device=self.device).eval()
        space = self.envs.single_action_space
        self._act_scale = None
        if hasattr(space, "low") and hasattr(space, "high"):
            low = np.asarray(space.low, np.float32)
            high = np.asarray(space.high, np.float32)
            self._act_scale = ((high - low) / 2.0, (high + low) / 2.0)
        seed = (config.get("seed") or 0) * 1000 + worker_index
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self._has_weights = False
        self._obs, _ = self.envs.reset(seed=seed)
        self._episodes = [SingleAgentEpisode() for _ in range(n_envs)]
        for i, ep in enumerate(self._episodes):
            ep.add_env_reset(self._obs[i])
        self._weights_version = 0

    def set_weights(self, weights, version: Optional[int] = None) -> None:
        """Copy a state dict into the runner's module."""
        self.module.load_state_dict(weights)
        self._has_weights = True
        if version is not None:
            self._weights_version = int(version)

    def get_weights(self):
        return self.module.state_dict()

    def get_weights_version(self) -> int:
        return self._weights_version

    @torch.no_grad()
    def act(self, obs, explore: bool = True) -> Dict[str, np.ndarray]:
        """The module's actions (and logp, vf_preds when exploring) for a
        batch of observations, on the host."""
        batch = {"obs": obs_to_device(obs, self.device)}
        if explore:
            out = self.module.forward_exploration(batch, self.generator)
        else:
            out = self.module.forward_inference(batch)
        return {k: v.cpu().numpy() for k, v in out.items()}

    def sample(self, *, num_steps: Optional[int] = None,
               explore: bool = True,
               random_actions: bool = False) -> List[SingleAgentEpisode]:
        """Collect num_steps env steps per vector env slot; -> completed
        episodes and the in-progress fragments (boundary fragments)."""
        if not (self._has_weights or random_actions):
            raise RuntimeError("set_weights first")
        num_steps = num_steps or self.config.get(
            "rollout_fragment_length", 200)
        done_episodes: List[SingleAgentEpisode] = []
        for _ in range(num_steps):
            env_actions = None
            if random_actions:
                sampled = np.stack([
                    self.envs.single_action_space.sample()
                    for _ in range(self.n_envs)])
                if self._act_scale is not None:
                    scale, offset = self._act_scale
                    actions = (sampled - offset) / np.where(scale == 0, 1,
                                                            scale)
                    env_actions = sampled
                else:
                    actions = sampled
                extra: Dict[str, np.ndarray] = {}
            else:
                out = self.act(self._obs, explore)
                actions = out.pop("actions")
                extra = out if explore else {}
            if env_actions is None:
                env_actions = actions
                if self._act_scale is not None:
                    scale, offset = self._act_scale
                    env_actions = actions * scale + offset
            next_obs, rewards, terms, truncs, _ = self.envs.step(env_actions)
            for i in range(self.n_envs):
                self._episodes[i].add_env_step(
                    next_obs[i], actions[i], rewards[i],
                    terminated=bool(terms[i]), truncated=bool(truncs[i]),
                    **{k: v[i] for k, v in extra.items()})
                if terms[i] or truncs[i]:
                    done_episodes.append(self._episodes[i])
                    self._episodes[i] = SingleAgentEpisode()
                    self._episodes[i].add_env_reset(next_obs[i])
            self._obs = next_obs
        # In-progress fragments too, so the learner sees exactly
        # n_envs * num_steps transitions.
        for i in range(self.n_envs):
            if len(self._episodes[i]) > 0:
                frag = self._episodes[i]
                frag.is_truncated = True
                frag.is_boundary_fragment = True
                done_episodes.append(frag)
                self._episodes[i] = SingleAgentEpisode()
                self._episodes[i].add_env_reset(self._obs[i])
        return done_episodes

    def stop(self) -> None:
        self.envs.close()


class EnvRunnerGroup:
    """The one inline runner (num_env_runners = 0)."""

    def __init__(self, config: Dict[str, Any], module_spec: Dict[str, Any]):
        check_local({"num_env_runners": config.get("num_env_runners", 0)})
        self.local = EnvRunner(config, module_spec, worker_index=0)

    def sync_weights(self, weights, version: Optional[int] = None) -> None:
        self.local.set_weights(weights, version)

    def sample(self, **kw) -> List[SingleAgentEpisode]:
        return self.local.sample(**kw)

    def stop(self) -> None:
        self.local.stop()
