"""EnvRunner: samples episodes from the port's vector env with the policy
on the device.

Counterpart of `ray_tpu/rllib/env_runner.py`'s EnvRunner (:47-218) and
EnvRunnerGroup (:223-369). Each env step is one
`forward_exploration` of the module on the device (eval mode, no
autograd), its actions drawn from the runner's `torch.Generator`, seeded
seed * 1000 + worker_index as the JAX runner seeds its key; the actions,
logp and value predictions come back to the host for the envs. Continuous
actions stay in module space ([-1, 1]) in the episodes and are rescaled
into the action space's bounds at the env boundary.

With `num_env_runners > 0` the group runs its runners as actors of the
runtime, built with the actor decorator the config carries
(`AlgorithmConfig.runtime(remote=...)`): each on the card at its position
among the group's runners on its node (`_private/actors.py`), the weights
shipped by value on the typed tensor wire, a dead runner replaced in
place. The sync group emits its membership changes as JAX's does
(`rl.runner_dead` / `rl.runner_respawn`, through `util.metrics`).
`EnvRunner.sample_and_push` is a runner's turn in the decoupled dataflow
(`rllib/dataflow.py`).
"""

from __future__ import annotations

import time
from functools import partial
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ray_tpu_torch._private import actors
from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch._private.serialization import install_tensor_wire
from ray_tpu_torch.rllib.algorithm_config import check_local
from ray_tpu_torch.rllib.envs import SyncVectorEnv, make_env
from ray_tpu_torch.rllib.episode import SingleAgentEpisode
from ray_tpu_torch.rllib.rl_module import resolve_module
from ray_tpu_torch.util import metrics

__all__ = ["EnvRunner", "EnvRunnerGroup", "make_env"]

# How long a runner waits for the sample queue's ack of a push.
PUSH_TIMEOUT_S = 60.0


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
    """One sampling worker: in the algorithm's own process, or in an actor
    of an EnvRunnerGroup."""

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

    def get_node_id(self, runtime_context=None) -> str:
        """The runtime's id of this runner's node, which the fleet's
        preempt sweep matches notices on: `runtime_context` is the
        runtime's `get_runtime_context` (JAX's runner calls it itself);
        "" for a runner given none."""
        if runtime_context is None:
            return ""
        return runtime_context().get_node_id()

    def sample_and_push(self, queue, put, *, num_steps: Optional[int] = None,
                        runner_index: int = 0, incarnation: int = 0,
                        explore: bool = True) -> Dict[str, Any]:
        """One turn of the decoupled dataflow: sample a fragment, `put` it
        (the runtime's put, so this runner owns the payload: if it dies,
        the learner reads the runtime's OwnerDiedError and discards the
        batch), push the stamped entry to the sample queue `queue`, and
        return a small ack. A shed push drops the batch and paces this
        runner by the queue's retry-after hint, so the fleet's pump never
        waits."""
        episodes = self.sample(num_steps=num_steps, explore=explore)
        steps = sum(len(e) for e in episodes)
        version = self._weights_version
        ref = put(episodes)
        entry = {"ref": ref, "env_steps": steps, "policy_version": version,
                 "runner": runner_index, "incarnation": incarnation}
        ack = queue.push.remote(entry).future().result(
            timeout=PUSH_TIMEOUT_S)
        if ack.get("retry_later"):
            time.sleep(min(float(ack.get("retry_after_s", 0.05)), 0.5))
            return {"pushed": False, "shed": True, "env_steps": steps,
                    "version": version}
        if ack.get("rejected"):
            return {"pushed": False, "rejected": ack["rejected"],
                    "env_steps": steps, "version": version}
        return {"pushed": True, "env_steps": steps, "version": version,
                "depth": ack.get("depth")}

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
    """The one inline runner (num_env_runners = 0), or `num_env_runners`
    runner actors of the runtime, built with its actor decorator `remote`.

    Fault-tolerant as JAX's: a runner that dies during a weight push or a
    `sample` (its future raises one of `actors.RUNNER_GONE`) is replaced
    in place, carrying the last weights pushed, while the restart budget
    lasts; its fragment is dropped and the caller's batch-size loop tops
    up. With restart_failed_env_runners=False, or the budget spent, the
    runtime's own exception is raised again. Any other exception is the
    runner's own error and propagates. Each change is emitted
    (`rl.runner_dead`, `rl.runner_respawn`: the runner slot, its
    incarnation, the reason, and the actor's id)."""

    def __init__(self, config: Dict[str, Any], module_spec: Dict[str, Any],
                 remote=None):
        self.num_remote = config.get("num_env_runners", 0) or 0
        self._config = config
        self._module_spec = module_spec
        self._restart = config.get("restart_failed_env_runners", True)
        self._restart_budget = int(config.get("max_env_runner_restarts", 20))
        self.restarts = 0
        self._last_weights = None
        if self.num_remote == 0:
            self.local = EnvRunner(config, module_spec, worker_index=0)
            self.remotes = []
            return
        check_local({"num_env_runners": self.num_remote}, remote,
                    ("num_env_runners",))
        self.local = None
        self._cls = remote(actors.CardActor)
        self.remotes = [self._spawn(i + 1) for i in range(self.num_remote)]
        self._nodes = actors.place_actors(self.remotes, config.get("device"))
        self._incarnations = [0] * self.num_remote

    def _spawn(self, worker_index: int):
        opts: Dict[str, Any] = {
            "num_cpus": self._config.get("num_cpus_per_env_runner", 1)}
        custom = self._config.get("custom_resources_per_env_runner")
        if custom:
            opts["resources"] = dict(custom)
        return self._cls.options(**opts).remote(
            EnvRunner, self._config, self._module_spec, worker_index)

    def _call_each(self, method: str, *args, **kwargs) -> List[Any]:
        """`method` on every runner; -> the values of those that answered.
        A runner gone before or during the call is replaced in place."""
        calls, dead = [], []
        for w in self.remotes:
            try:
                calls.append((w, getattr(w, method).remote(*args, **kwargs)))
            except Exception as err:  # noqa: BLE001 — dead at submit
                actors.check_gone(err)
                dead.append((w, err))
        out = []
        for w, ref in calls:
            try:
                out.append(ref.future().result())
            except Exception as err:  # noqa: BLE001
                actors.check_gone(err)
                dead.append((w, err))
        for w, err in dead:
            self.replace_runner(w, "actor_died", err)
        return out

    def sync_weights(self, weights, version: Optional[int] = None) -> None:
        """Push `weights` (a state dict) to every runner; a runner that
        dies during the push is replaced carrying them. They travel as host
        copies, which each runner copies onto its own card: a CUDA tensor
        on the wire would be rebuilt on the sender's card index."""
        if self.local is not None:
            self.local.set_weights(weights, version)
            return
        install_tensor_wire()
        # a copy that the learner's next updates leave as it is, for the
        # replacements
        weights = {k: v.detach().to("cpu", copy=True)
                   for k, v in weights.items()}
        self._last_weights = (weights, version)
        self._call_each("set_weights", weights, version)

    def replace_runner(self, handle, reason: str = "actor_died",
                       error: Optional[BaseException] = None):
        """Replace the dead runner `handle` in place; -> the replacement,
        which carries the last weights pushed, or None when the handle has
        already left the fleet. With restarts off or the budget spent,
        raise `error` (the runtime's exception that told of the death).
        The old actor is stopped first: a lost object can be reported while
        its actor lives on, holding its CPUs and its card."""
        try:
            index = self.remotes.index(handle)
        except ValueError:
            return None
        self._member("rl.runner_dead", handle, index,
                     self._incarnations[index], reason)
        if not self._restart or self.restarts >= self._restart_budget:
            if error is not None:
                raise error
            raise RuntimeError(f"env runner {index} died ({reason}) and "
                               "restarts are off or spent")
        actors.terminate(handle)
        replacement = self._spawn(index + 1)
        try:
            (node,) = actors.results([replacement.bind_slot.remote(
                self._nodes, index, self._config.get("device"))])
        except BaseException:
            actors.terminate(replacement)
            raise
        self._nodes[index] = node
        if self._last_weights is not None:
            replacement.set_weights.remote(*self._last_weights
                                           ).future().result()
        self.remotes[index] = replacement
        self.restarts += 1
        self._incarnations[index] = self.restarts
        self._member("rl.runner_respawn", replacement, index, self.restarts,
                     reason)
        return replacement

    def _member(self, etype: str, handle, index: int, incarnation: int,
                reason: str) -> None:
        metrics.emit(etype, actor_id=handle._actor_id.hex(), runner=index,
                     incarnation=incarnation, reason=reason)

    def sample(self, **kw) -> List[SingleAgentEpisode]:
        """Every runner's episodes; a dead runner's fragment is dropped and
        its slot replaced."""
        if self.local is not None:
            return self.local.sample(**kw)
        return [ep for eps in self._call_each("sample", **kw) for ep in eps]

    def stop(self) -> None:
        if self.local is not None:
            self.local.stop()
        for w in self.remotes:
            actors.terminate(w)
