"""IMPALA's and APPO's V-trace update and their loop, the port's
counterpart of `ray_tpu/rllib/algorithms/impala.py` (`make_vtrace_update`
:39-123, `IMPALA` :126-367, and `APPOConfig` / `APPO`, :370-381).

V-trace (Espeholt et al. 2018): JAX runs the recursion as a `lax.scan`
over the reversed time axis; here it is a reversed loop over T computing
the same recursion, vs_t - V(x_t) = delta_t + gamma_t c_t (vs_{t+1} -
V(x_{t+1})). APPO (`appo_clip`) takes PPO's clipped surrogate on the
V-trace advantages in place of the plain policy gradient.

With remote env runners (the default, two, as in JAX) the loop is JAX's
in-flight pipeline: `max_requests_in_flight_per_env_runner` sample calls
stay armed per runner, each step learns on the first fragment that comes
back (the oldest armed call among those done), a dead runner's fragment is
dropped and its slot replaced, every runner is re-armed by its deficit, and
the weights are broadcast every `broadcast_interval` updates. With
num_env_runners = 0 it samples inline. With `dataflow(decoupled=True)`
and remote env runners (JAX :150-160, :268-365) the runners feed a
`DecoupledDataflow` (`rllib/dataflow.py`): each step pulls whatever
version-safe batches are queued and learns on them, an empty pull returns
at once, a pull that only dropped stale batches re-broadcasts the weights
(else the loop livelocks: no update, so no interval-gated broadcast), and
each update emits one `rl.learner_step`.
"""

from __future__ import annotations

import collections
import concurrent.futures
import time
from typing import Any, Dict, List

import numpy as np
import torch

from ray_tpu_torch._private import actors
from ray_tpu_torch.rllib.algorithm import Algorithm
from ray_tpu_torch.rllib.algorithm_config import AlgorithmConfig
from ray_tpu_torch.rllib.dataflow import DecoupledDataflow
from ray_tpu_torch.rllib.env_runner import EnvRunnerGroup, obs_to_device
from ray_tpu_torch.rllib.learner import TorchLearner
from ray_tpu_torch.rllib.rl_module import resolve_module
from ray_tpu_torch.util import metrics


class IMPALAConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__(algo_class=IMPALA)
        self.lr = 5e-4
        self.rollout_fragment_length = 50
        self.num_env_runners = 2
        self.vtrace_clip_rho_threshold = 1.0
        self.vtrace_clip_c_threshold = 1.0
        self.vf_loss_coeff = 0.5
        self.entropy_coeff = 0.01
        self.broadcast_interval = 1   # learner steps between weight pushes
        self.max_requests_in_flight_per_env_runner = 2
        self.normalize_advantages = True


def vtrace_returns(values, bootstrap, rewards, discounts, clipped_rho,
                   clipped_c) -> torch.Tensor:
    """vs [B, T] from the [B, T] values, rewards, discounts and clipped
    importance weights and the [B] bootstrap values."""
    values_t_plus_1 = torch.cat([values[:, 1:], bootstrap[:, None]], dim=1)
    deltas = clipped_rho * (rewards + discounts * values_t_plus_1 - values)
    acc = torch.zeros_like(bootstrap)
    vs_minus_v = []
    for t in reversed(range(values.shape[1])):
        acc = deltas[:, t] + discounts[:, t] * clipped_c[:, t] * acc
        vs_minus_v.append(acc)
    return values + torch.stack(vs_minus_v[::-1], dim=1)


class VTraceLearner(TorchLearner):
    """The V-trace actor-critic update on [B, T] trajectories (batch keys:
    obs, actions, rewards, logp (behaviour), terminateds, mask,
    bootstrap_value), under optax.adam(lr) as in JAX (no clip). With
    config["appo_clip"], APPO's clipped surrogate (clip_param)."""

    def __init__(self, module_spec: Dict[str, Any], config: Dict[str, Any]):
        super().__init__(resolve_module(
            module_spec, device="cpu",
            generator=self.init_generator(config)), config)
        self.grad_clip = None

    def loss_fn(self, batch):
        cfg = self.config
        b, t = batch["actions"].shape
        # flatten the [B, T] rows only: images keep their [H, W, C] tail
        obs = batch["obs"].reshape((b * t,) + tuple(batch["obs"].shape[2:]))
        out = self.module.forward_train(
            {"obs": obs, "actions": batch["actions"].reshape(-1)})
        logp = out["logp"].reshape(b, t)
        values = out["vf_preds"].reshape(b, t)
        entropy = out["entropy"].reshape(b, t)
        mask = batch["mask"]
        denom = torch.clamp(torch.sum(mask), min=1.0)
        rhos = torch.exp(logp - batch["logp"])
        discounts = cfg.get("gamma", 0.99) * (1.0 - batch["terminateds"])
        bootstrap = batch["bootstrap_value"]
        with torch.no_grad():
            clipped_rho = torch.clamp(
                rhos, max=cfg.get("vtrace_clip_rho_threshold", 1.0))
            clipped_c = torch.clamp(
                rhos, max=cfg.get("vtrace_clip_c_threshold", 1.0))
            v = values.detach()
            vs = vtrace_returns(v, bootstrap, batch["rewards"], discounts,
                                clipped_rho, clipped_c)
            vs_t_plus_1 = torch.cat([vs[:, 1:], bootstrap[:, None]], dim=1)
            pg_adv = clipped_rho * (batch["rewards"] + discounts * vs_t_plus_1
                                    - v)
            if cfg.get("normalize_advantages", True):
                adv_mean = torch.sum(pg_adv * mask) / denom
                adv_var = torch.sum(mask * (pg_adv - adv_mean) ** 2) / denom
                pg_adv = (pg_adv - adv_mean) * torch.rsqrt(adv_var + 1e-8)
        if cfg.get("appo_clip", False):
            clip = cfg.get("clip_param", 0.2)
            surr = torch.minimum(
                rhos * pg_adv, torch.clamp(rhos, 1 - clip, 1 + clip) * pg_adv)
            pg_loss = -torch.sum(surr * mask) / denom
        else:
            pg_loss = -torch.sum(logp * pg_adv * mask) / denom
        vf_loss = 0.5 * torch.sum(mask * (values - vs) ** 2) / denom
        ent = torch.sum(entropy * mask) / denom
        total = (pg_loss + cfg.get("vf_loss_coeff", 0.5) * vf_loss
                 - cfg.get("entropy_coeff", 0.01) * ent)
        return total, {"pg_loss": pg_loss, "vf_loss": vf_loss,
                       "entropy": ent,
                       "mean_rho": torch.sum(rhos * mask) / denom}


# How long a pipelined step waits for a fragment before it returns empty.
FRAGMENT_WAIT_S = 60


class IMPALA(Algorithm):
    remote_options = ("num_env_runners",)

    def setup(self, config: AlgorithmConfig) -> None:
        self.module_spec = self._actor_critic_spec(config)
        cfg = config.to_dict()
        self.learner = VTraceLearner(self.module_spec, cfg)
        self.policy_version = 0
        self._updates = 0
        self._stale_seen = 0  # stale-drop watermark for the livelock escape
        self.dataflow = None
        self.runner_group = None
        # the armed sample calls: future -> the runner handle it went to
        self._inflight: Dict[Any, Any] = {}
        self._steps_since_broadcast = 0
        if config.decoupled and config.num_env_runners:
            self.dataflow = DecoupledDataflow(
                cfg, self.module_spec, self.learner.get_host_weights(),
                version=self.policy_version, runtime=config.runtime_api)
            return
        self.runner_group = EnvRunnerGroup(cfg, self.module_spec,
                                           config.remote)
        self.runner_group.sync_weights(self.learner.get_weights(),
                                       self.policy_version)
        if self.runner_group.remotes:
            self._replenish_pipeline()

    def _replenish_pipeline(self) -> None:
        """Keep max_requests_in_flight_per_env_runner sample calls armed
        per runner of the fleet as it stands: the deficit counted per live
        handle, so a slot replaced by any path (the broadcast's repair
        included) is re-armed to its full count. A runner dead at submit is
        replaced in place and its replacement armed."""
        per = max(1, self.config.max_requests_in_flight_per_env_runner)
        n = self.config.rollout_fragment_length
        counts = collections.Counter(id(h) for h in self._inflight.values())
        for slot in range(len(self.runner_group.remotes)):
            h = self.runner_group.remotes[slot]
            deficit = per - counts[id(h)]
            while deficit > 0:
                try:
                    ref = h.sample.remote(num_steps=n)
                except Exception as err:  # noqa: BLE001 — dead at submit
                    actors.check_gone(err)
                    h = self.runner_group.replace_runner(h, "actor_died",
                                                         err)
                    if h is None:
                        break
                    deficit = per
                    continue
                self._inflight[ref.future()] = h
                deficit -= 1

    def _next_fragment(self):
        """The pipelined path's episodes: the oldest armed call among those
        done within FRAGMENT_WAIT_S (none: an empty list). A dead runner's
        fragment is dropped and its slot replaced; then every runner is
        re-armed."""
        done, _ = concurrent.futures.wait(
            list(self._inflight), timeout=FRAGMENT_WAIT_S,
            return_when=concurrent.futures.FIRST_COMPLETED)
        episodes = []
        ready = next((f for f in self._inflight if f in done), None)
        if ready is not None:
            runner = self._inflight.pop(ready)
            try:
                episodes = ready.result()
            except Exception as err:  # noqa: BLE001
                actors.check_gone(err)
                self.runner_group.replace_runner(runner, "actor_died", err)
        self._replenish_pipeline()
        return episodes

    def _pull_decoupled(self) -> Dict[str, Any]:
        """One decoupled pull: whatever version-safe batches are queued.
        -> {"episodes": [...], "min_batch_version": ...}; no episodes means
        the fleet is (re)filling the queue, and the step returns to its
        caller instead of waiting on any runner."""
        pulled = self.dataflow.pull(self.policy_version)
        episodes: List = []
        versions = []
        for entry, eps in pulled:
            episodes.extend(eps)
            versions.append(int(entry.get("policy_version", 0)))
        return {"episodes": episodes,
                "min_batch_version": min(versions) if versions else None}

    def _broadcast(self) -> None:
        if self.dataflow is not None:
            self.dataflow.broadcast(self.learner.get_host_weights(),
                                    self.policy_version)
        else:
            self.runner_group.sync_weights(self.learner.get_weights(),
                                           self.policy_version)
        self._steps_since_broadcast = 0

    @torch.no_grad()
    def _values(self, obs: np.ndarray) -> np.ndarray:
        _, v = self.learner.module(obs_to_device(obs, self.learner.device))
        return v.cpu().numpy()

    def _episodes_to_batch(self, episodes) -> Dict[str, np.ndarray]:
        """Pack fragments densely into rows of exactly T =
        rollout_fragment_length ([B_bucket, T], B padded to a multiple of
        4 with masked dead rows). Every fragment ends with terminateds=1,
        a truncated one with gamma * V(boundary obs) folded into its last
        reward, so V-trace targets never cross rows; a row that splits a
        fragment bootstraps from V(first obs of the next row)."""
        t_len = self.config.rollout_fragment_length
        stream = {k: [] for k in
                  ("obs", "actions", "rewards", "logp", "terminateds")}
        for ep in episodes:
            rews = np.asarray(ep.rewards, np.float32).copy()
            terms = np.zeros(len(ep), np.float32)
            terms[-1] = 1.0
            if not ep.is_done:
                last_obs = np.asarray(ep.obs[-1])
                rews[-1] += self.config.gamma * float(
                    self._values(last_obs[None])[0])
            stream["obs"].append(np.asarray(ep.obs[:-1]))
            stream["actions"].append(np.asarray(ep.actions, np.int64))
            stream["rewards"].append(rews)
            stream["logp"].append(
                np.asarray(ep.extra.get("logp"), np.float32))
            stream["terminateds"].append(terms)
        flat = {k: np.concatenate(v) for k, v in stream.items()}
        n = len(flat["actions"])
        mask = np.ones(n, np.float32)
        pad = (-n) % t_len
        if pad:
            flat = {k: np.concatenate(
                [v, np.repeat(v[-1:], pad, axis=0)]) for k, v in flat.items()}
            flat["rewards"][n:] = 0
            flat["terminateds"][n:] = 1
            mask = np.concatenate([mask, np.zeros(pad, np.float32)])
        b = (n + pad) // t_len
        b_bucket = ((b + 3) // 4) * 4
        batch = {}
        for k, v in flat.items():
            v = v.reshape((b, t_len) + v.shape[1:])
            dead = np.zeros(((b_bucket - b), t_len) + v.shape[2:], v.dtype)
            if k == "terminateds":
                dead = dead + 1
            batch[k] = np.concatenate([v, dead])
        m = mask.reshape(b, t_len)
        batch["mask"] = np.concatenate(
            [m, np.zeros((b_bucket - b, t_len), np.float32)])
        boots = np.zeros(b_bucket, np.float32)
        flat_terms = batch["terminateds"].reshape(-1)
        need = [i for i in range(b - 1)
                if flat_terms[(i + 1) * t_len - 1] == 0]
        if need:
            next_obs = batch["obs"].reshape((-1,) + batch["obs"].shape[2:])[
                [(i + 1) * t_len for i in need]]
            for i, v in zip(need, self._values(next_obs)):
                boots[i] = v
        batch["bootstrap_value"] = boots
        return batch

    def training_step(self) -> Dict[str, Any]:
        cfg = self.config
        t0 = time.perf_counter()
        min_batch_version = None
        if self.dataflow is not None:
            pulled = self._pull_decoupled()
            episodes = pulled["episodes"]
            min_batch_version = pulled["min_batch_version"]
        elif self.runner_group.remotes:
            episodes = self._next_fragment()
        else:
            episodes = self.runner_group.sample(
                num_steps=cfg.rollout_fragment_length)
        t1 = time.perf_counter()
        if not episodes:
            if self.dataflow is not None \
                    and self.dataflow.stale_dropped > self._stale_seen:
                # an empty pull that dropped stale batches: the fleet
                # stamps versions the learner no longer takes (a restored
                # checkpoint, an interval wider than the bound);
                # re-broadcast now, or no update ever fires the
                # interval-gated broadcast again
                self._stale_seen = self.dataflow.stale_dropped
                self._broadcast()
            return {"num_episodes": 0, "wait_seconds": t1 - t0}
        if self.dataflow is not None:
            self._stale_seen = self.dataflow.stale_dropped
        self._record_episodes(episodes)
        env_steps = sum(len(e) for e in episodes)
        out = self.learner.update_from_batch(self._episodes_to_batch(episodes))
        self.policy_version += 1
        self._updates += 1
        self._steps_since_broadcast += 1
        if self._steps_since_broadcast >= cfg.broadcast_interval:
            self._broadcast()
        out["num_episodes"] = len(episodes)
        out["num_env_steps_sampled"] = env_steps
        out["policy_version"] = self.policy_version
        if self.dataflow is not None:
            # one rl.learner_step per update that happened: the step
            # cadence, the staleness proof (version, oldest batch version,
            # bound) and monotonic progress derive from these
            # (drills/slo.rl_slo)
            df = self.dataflow.stats()
            metrics.emit(
                "rl.learner_step", step=self._updates,
                version=self.policy_version, env_steps=env_steps,
                min_batch_version=min_batch_version,
                staleness_bound=self.dataflow.max_staleness,
                stale_dropped=df["stale_dropped"],
                discarded_dead=df["discarded_dead"],
                runners=df["fleet_runners"])
            out["dataflow"] = df
        # the port's loop timings (host clock): waiting for the episodes
        # (the pull, the fragment, or sampling inline), then learning and
        # the broadcast
        out["wait_seconds"] = t1 - t0
        out["learn_seconds"] = time.perf_counter() - t1
        return out

    def stop(self) -> None:
        if self.dataflow is not None:
            self.dataflow.stop()
        if self.runner_group is not None:
            self.runner_group.stop()


class APPOConfig(IMPALAConfig):
    def __init__(self):
        super().__init__()
        self.algo_class = APPO
        self.appo_clip = True
        self.clip_param = 0.2


class APPO(IMPALA):
    """Asynchronous PPO (reference: ray rllib/algorithms/appo/appo.py):
    IMPALA's loop, the in-flight pipeline included, with the PPO clipped
    surrogate on the V-trace-corrected advantages."""
