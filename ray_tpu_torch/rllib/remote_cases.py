"""The remote RL groups' work on one device without the runtime:
`chip_smoke.py`'s phase (q) and its CPU rehearsal.

The runtime's actors cannot run on a machine without its dependencies, so
`LocalRuntime` stands in for its actor decorator: each "actor" is the
object on a thread of its own, its calls run in order on that thread,
their arguments and results travel by value through the port's pickler
(`serialization.serialize` into one buffer, then `deserialize`: the typed
tensor wire), and
`.remote` returns a ref whose `future()` holds the result. `fail()`
makes every call of an actor raise `RayActorError`, a class named as the
runtime's exception for a dead actor (`actors.RUNNER_GONE`): the calls it
has not yet run, and those whose results wait unread, as if the node went
with the objects it held. So a failure can reach an armed call that has
already finished.
The package itself never reaches this module: the groups take the
decorator they are given.

The cases, each on `device` ("cuda" on the card, "cpu" in the rehearsal):

- `learner_case`: two PPO learners built as the group's actors build them
  update once on their shards of a seeded batch; the parameter mean is set
  on both. Held against the same steps on the CPU.
- `runner_case`: the mean weights through the wire as host copies, bit
  for bit, and on each runner's card; two remote runners sample with them,
  against in-process runners of the same index and weights.
- `pipeline_case`: IMPALA over two remote runners with its in-flight
  pipeline; every update from an armed call, the runners on the learner's
  version after each broadcast; then the runner of the oldest armed call
  fails: the next step reads that call, drops its fragment, replaces the
  slot and re-arms it in full, and two more updates follow.
"""

from __future__ import annotations

import collections
import concurrent.futures
import functools
import itertools
import time
from typing import Any, Dict, List

import numpy as np
import torch

from ray_tpu_torch._private import actors, serialization
from ray_tpu_torch.rllib.algorithms.impala import IMPALAConfig
from ray_tpu_torch.rllib.algorithms.ppo import PPOConfig, PPOLearner
from ray_tpu_torch.rllib.catalog import Catalog
from ray_tpu_torch.rllib.env_runner import EnvRunner, EnvRunnerGroup
from ray_tpu_torch.rllib.learner import LearnerGroup, parameter_mean

# (q): the cases' sizes. Every module is fp32 at its algorithm's default
# widths on CartPole.
LEARNER_ROWS = 128           # the batch the two learners split
RUNNER_STEPS = 64            # each runner's sample
PIPELINE_ITERATIONS = 6      # IMPALA's updates before the failure
PIPELINE_AFTER_FAILURE = 2   # and after it
PIPELINE_MAX_STEPS = 40      # training steps allowed to reach them
IN_FLIGHT = 2                # max_requests_in_flight_per_env_runner
# The card against the CPU: |a - b| <= ATOL + RTOL |b| ((m)'s rule).
ATOL, RTOL = 1e-5, 1e-4


class RayActorError(RuntimeError):
    """What a failed stand-in actor's calls raise: named as the runtime's
    exception for an actor that is gone."""


def by_value(value):
    """`value` as a receiver gets it: through the port's pickler into one
    buffer of its own, as the object store holds it."""
    wire = serialization.serialize(value).to_bytes()
    return serialization.deserialize(
        serialization.SerializedObject.from_bytes(wire))


class LocalFuture(concurrent.futures.Future):
    """A stand-in call's future: once its actor has failed, reading it
    raises the failure, whether the call ran or not."""

    def __init__(self, actor: "LocalActor"):
        super().__init__()
        self._actor = actor

    def result(self, timeout=None):
        value = super().result(timeout)
        if self._actor._failed is not None:
            raise self._actor._failed
        return value


class LocalRef:
    def __init__(self, future: concurrent.futures.Future):
        self._future = future

    def future(self) -> concurrent.futures.Future:
        return self._future


def _settle(out: concurrent.futures.Future,
            done: concurrent.futures.Future) -> None:
    """Give `out` the outcome of `done`."""
    if done.cancelled():
        out.cancel()
    elif done.exception() is not None:
        out.set_exception(done.exception())
    else:
        out.set_result(done.result())


class LocalActor:
    """A stand-in actor handle: the instance lives on one thread."""

    def __init__(self, cls, args, kwargs, options):
        self.options = options
        self.calls: List[str] = []
        self.terminated = False
        self._failed = None
        self._pool = concurrent.futures.ThreadPoolExecutor(
            1, thread_name_prefix=f"local-actor-{cls.__name__}")
        args, kwargs = by_value((args, kwargs))
        self._instance = self._pool.submit(lambda: cls(*args, **kwargs))

    def _run(self, name, args, kwargs):
        if self._failed is not None:
            raise self._failed
        return by_value(getattr(self._instance.result(), name)(
            *args, **kwargs))

    def _submit(self, name, args, kwargs) -> LocalRef:
        if name == "__ray_terminate__":
            self.terminated = True
            self._pool.shutdown(wait=False, cancel_futures=True)
            done = concurrent.futures.Future()
            done.set_result(None)
            return LocalRef(done)
        self.calls.append(name)
        args, kwargs = by_value((args, kwargs))
        out = LocalFuture(self)
        self._pool.submit(self._run, name, args, kwargs).add_done_callback(
            functools.partial(_settle, out))
        return LocalRef(out)

    def fail(self, message: str = "the stand-in failed this actor") -> None:
        """Every call raises RayActorError: those not yet run, and those
        whose results have not been read."""
        self._failed = RayActorError(message)

    def __getattr__(self, name: str):
        if name.startswith("__") and name != "__ray_terminate__":
            raise AttributeError(name)
        handle = self

        class _Method:
            def remote(self, *args, **kwargs) -> LocalRef:
                return handle._submit(name, args, kwargs)

        return _Method()


class LocalActorClass:
    def __init__(self, runtime: "LocalRuntime", cls, options):
        self._runtime, self._cls, self._options = runtime, cls, options

    def options(self, **overrides) -> "LocalActorClass":
        return LocalActorClass(self._runtime, self._cls,
                               dict(self._options, **overrides))

    def remote(self, *args, **kwargs) -> LocalActor:
        handle = LocalActor(self._cls, args, kwargs, self._options)
        self._runtime.actors.append(handle)
        return handle


class LocalRuntime:
    """The stand-in for the runtime: `remote` is its actor decorator."""

    def __init__(self):
        self.actors: List[LocalActor] = []

    def remote(self, cls) -> LocalActorClass:
        return LocalActorClass(self, cls, {})

    def shutdown(self) -> None:
        for a in self.actors:
            a._pool.shutdown(wait=True, cancel_futures=True)


# -- the cases ------------------------------------------------------------------

def cartpole_spec(model=None) -> Dict[str, Any]:
    """The actor-critic spec of CartPole at PPO's default widths."""
    cfg = PPOConfig()
    return Catalog.from_env("CartPole-v1", {},
                            model or cfg.model).actor_critic_spec()


def learner_batch(seed: int, rows: int = LEARNER_ROWS) -> Dict[str, Any]:
    """A seeded PPO batch of CartPole's shapes."""
    r = np.random.default_rng(seed)
    return {"obs": r.standard_normal((rows, 4)).astype(np.float32),
            "actions": r.integers(0, 2, rows).astype(np.int32),
            "logp": (np.log(0.5)
                     + 0.2 * r.standard_normal(rows)).astype(np.float32),
            "advantages": r.standard_normal(rows).astype(np.float32),
            "value_targets": r.standard_normal(rows).astype(np.float32)}


def learner_config(device, **extra) -> Dict[str, Any]:
    cfg = PPOConfig().debugging(seed=3).resources(device=device)
    for k, v in extra.items():
        setattr(cfg, k, v)
    return cfg.to_dict()


def cpu_reference(spec, batch, n: int = 2):
    """The group's update on the CPU, learner by learner in this process:
    -> (mean weights, averaged metrics)."""
    config = learner_config("cpu")
    learners = [PPOLearner(spec, config) for _ in range(n)]
    size = len(batch["obs"])
    metrics = [l.update_from_batch({k: v[i * size // n:(i + 1) * size // n]
                                    for k, v in batch.items()})
               for i, l in enumerate(learners)]
    mean = parameter_mean([l.get_weights() for l in learners])
    return mean, {k: sum(m[k] for m in metrics) / n for k in metrics[0]}


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def close(got, want) -> float:
    """Largest |a - b|; raises where |a - b| > ATOL + RTOL |b|."""
    worst = 0.0
    for k, w in want.items():
        a = np.asarray(got[k].detach().cpu() if torch.is_tensor(got[k])
                       else got[k], np.float64)
        b = np.asarray(w.detach().cpu() if torch.is_tensor(w) else w,
                       np.float64)
        err = float(np.max(np.abs(a - b))) if a.size else 0.0
        if a.shape != b.shape or not np.all(np.abs(a - b)
                                            <= ATOL + RTOL * np.abs(b)):
            raise AssertionError(f"{k}: {a.ravel()[:4]} against "
                                 f"{b.ravel()[:4]}")
        worst = max(worst, err)
    return worst


def learner_case(device, seed: int = 21, timed: int = 10) -> Dict[str, Any]:
    """(q-1) Two PPO learners of a LearnerGroup over the stand-in, each
    bound to its card by position, update once on their shards of a seeded
    batch; the parameter mean is set on both. -> the mean weights, the
    largest differences from the CPU's steps, and the timings (ms): one
    learner's update, and the mean's gather, mean and set."""
    runtime = LocalRuntime()
    spec = cartpole_spec()
    batch = learner_batch(seed)
    try:
        group = LearnerGroup(PPOLearner, spec,
                             learner_config(device, num_learners=2),
                             runtime.remote)
        metrics = group.update_from_batch(batch)
        mean = group.get_weights()
        weights = actors.results([w.get_host_weights.remote()
                                  for w in group.remotes])
        for w in weights[1:]:
            for k in mean:
                if not torch.equal(w[k], weights[0][k]):
                    raise AssertionError(f"the learners hold different {k} "
                                         "after the mean")
        want_w, want_m = cpu_reference(spec, batch)
        err_w = close(mean, want_w)
        err_m = close(metrics, want_m)

        # one learner's update, in this process on the device
        learner = PPOLearner(spec, learner_config(device))
        shard = {k: v[:len(v) // 2] for k, v in batch.items()}
        learner.update_from_batch(shard)
        sync(device)
        t0 = time.perf_counter()
        for _ in range(timed):
            learner.update_from_batch(shard)
        sync(device)
        update_ms = (time.perf_counter() - t0) * 1e3 / timed

        # the mean: gather the actors' weights, take it, set it on each
        t0 = time.perf_counter()
        gathered = actors.results([w.get_host_weights.remote()
                                   for w in group.remotes])
        t1 = time.perf_counter()
        m = parameter_mean(gathered)
        sync(device)
        t2 = time.perf_counter()
        actors.results([w.set_weights.remote(m) for w in group.remotes])
        t3 = time.perf_counter()
        group.stop()
    finally:
        runtime.shutdown()
    return {"mean": mean, "metrics": metrics, "max_abs_err_weights": err_w,
            "max_abs_err_metrics": err_m, "update_ms": update_ms,
            "gather_ms": (t1 - t0) * 1e3, "mean_ms": (t2 - t1) * 1e3,
            "set_ms": (t3 - t2) * 1e3}


def runner_config(device, **extra) -> Dict[str, Any]:
    cfg = (PPOConfig().environment("CartPole-v1")
           .env_runners(num_envs_per_env_runner=1)
           .debugging(seed=5).resources(device=device))
    for k, v in extra.items():
        setattr(cfg, k, v)
    return cfg.to_dict()


def episode_arrays(episodes):
    """obs, actions, rewards, logp and vf_preds of `episodes`, in order."""
    out = collections.defaultdict(list)
    for ep in episodes:
        out["obs"].append(np.asarray(ep.obs))
        out["actions"].append(np.asarray(ep.actions))
        out["rewards"].append(np.asarray(ep.rewards, np.float32))
        for k in ("logp", "vf_preds"):
            out[k].append(np.asarray(ep.extra[k], np.float32))
    return {k: np.concatenate(v) for k, v in out.items()}


def runner_case(device, weights, steps: int = RUNNER_STEPS,
                timed: int = 10) -> Dict[str, Any]:
    """(q-2) `weights` through the wire as the group ships them (host
    copies, bit for bit), then on each of two remote runners (worker_index
    1 and 2) bit for bit on the runner's device; the runners sample `steps`
    each with them, against in-process runners of the same index and
    weights: obs, actions and rewards exactly. -> the wire's ms for the
    state dict, the transitions, and the largest logp / vf_preds
    difference."""
    dev = torch.device(device)
    host = {k: v.detach().to("cpu", copy=True) for k, v in weights.items()}
    got = by_value(host)
    for k, v in host.items():
        if not (got[k].device.type == "cpu" and got[k].dtype == v.dtype
                and torch.equal(got[k], v)):
            raise AssertionError(f"{k} changed on the wire")
    t0 = time.perf_counter()
    for _ in range(timed):
        by_value(host)
    wire_ms = (time.perf_counter() - t0) * 1e3 / timed

    spec = cartpole_spec()
    runtime = LocalRuntime()
    try:
        group = EnvRunnerGroup(runner_config(device, num_env_runners=2),
                               spec, runtime.remote)
        group.sync_weights(weights, version=1)
        held = actors.results([h.get_weights.remote()
                               for h in group.remotes])
        for runner_weights in held:
            for k, v in host.items():
                if not (runner_weights[k].device.type == dev.type
                        and torch.equal(runner_weights[k].cpu(), v)):
                    raise AssertionError(f"a runner holds another {k}, or "
                                         "holds it off its device")
        remote = group.sample(num_steps=steps)
        group.stop()
    finally:
        runtime.shutdown()
    local = []
    for index in (1, 2):
        runner = EnvRunner(runner_config(device), spec, worker_index=index)
        runner.set_weights(got, 1)
        local.extend(runner.sample(num_steps=steps))
    a, b = episode_arrays(remote), episode_arrays(local)
    for k in ("obs", "actions", "rewards"):
        if not np.array_equal(a[k], b[k]):
            raise AssertionError(f"remote runners' {k} differ from the "
                                 "in-process runners'")
    err = max(float(np.max(np.abs(a[k] - b[k]))) for k in ("logp",
                                                           "vf_preds"))
    return {"wire_ms": wire_ms, "transitions": int(len(a["actions"])),
            "max_abs_err_logp_vf": err,
            "tensors": len(host),
            "bytes": sum(v.numel() * v.element_size()
                         for v in host.values())}


def pipeline_config(device, runtime, **extra):
    cfg = (IMPALAConfig().environment("CartPole-v1")
           .env_runners(num_env_runners=2)
           .debugging(seed=7).resources(device=device)
           .runtime(remote=runtime.remote))
    cfg.max_requests_in_flight_per_env_runner = IN_FLIGHT
    for k, v in extra.items():
        setattr(cfg, k, v)
    return cfg


def _armed(algo) -> Dict[int, int]:
    counts = collections.Counter(id(h) for h in algo._inflight.values())
    return {slot: counts[id(h)]
            for slot, h in enumerate(algo.runner_group.remotes)}


def pipeline_case(device, iterations: int = PIPELINE_ITERATIONS,
                  after: int = PIPELINE_AFTER_FAILURE) -> Dict[str, Any]:
    """(q-3) IMPALA on CartPole over two stand-in runners with IN_FLIGHT
    sample calls armed each: `iterations` updates, each from one armed
    call (never the group's synchronous sample), every runner on the
    learner's policy_version after each broadcast. Then the runner of the
    oldest armed call fails once that call has finished: the next step
    reads the call, drops its fragment, and replaces the slot and re-arms
    it to IN_FLIGHT itself (no broadcast reaches the failed runner first);
    `after` more updates follow. -> per iteration (wait s, learn s), the
    failed slot, the fragments dropped, and the membership changes."""
    runtime = LocalRuntime()
    algo = pipeline_config(device, runtime).build()
    sync_calls = itertools.count()
    sync_sample = algo.runner_group.sample
    algo.runner_group.sample = lambda **kw: (next(sync_calls),
                                             sync_sample(**kw))[1]
    rows = []
    count = collections.Counter()
    fragment = algo.config.rollout_fragment_length
    try:
        def step():
            fleet = list(algo.runner_group.remotes)
            r = algo.train()
            if not r.get("num_episodes", 0):
                # a step that read a failed call (it waits up to 60 s for
                # a fragment, and the stand-in's come in milliseconds)
                count["dropped"] += 1
            else:
                count["updates"] += 1
                if r["num_env_steps_sampled"] != fragment:
                    raise AssertionError(
                        f"an update on {r['num_env_steps_sampled']} steps, "
                        f"not one fragment of {fragment}")
                versions = actors.results(
                    [h.get_weights_version.remote()
                     for h in algo.runner_group.remotes])
                if versions != [algo.policy_version] * len(versions):
                    raise AssertionError(f"runners on versions {versions} "
                                         "after the broadcast of "
                                         f"{algo.policy_version}")
                rows.append((r["wait_seconds"], r["learn_seconds"]))
            # a runner replaced by this step's broadcast is armed by the
            # next step's replenish; every other one is armed in full
            for h, n in zip(algo.runner_group.remotes, _armed(algo).values()):
                if n != IN_FLIGHT and (h in fleet or n != 0):
                    raise AssertionError(f"a runner armed {n} times, not "
                                         f"{IN_FLIGHT}")

        while count["updates"] < iterations:
            if sum(count.values()) >= PIPELINE_MAX_STEPS:
                raise AssertionError(f"{dict(count)} in "
                                     f"{PIPELINE_MAX_STEPS} steps")
            step()
        group = algo.runner_group
        oldest = next(iter(algo._inflight))
        concurrent.futures.wait([oldest])
        failed = algo._inflight[oldest]
        slot = group.remotes.index(failed)
        failed.fail()
        step()
        if not (count["dropped"] == 1 and group.restarts == 1
                and group.remotes[slot] is not failed
                and _armed(algo)[slot] == IN_FLIGHT):
            raise AssertionError(
                f"the step after the failure: {dict(count)}, restarts "
                f"{group.restarts}, armed {_armed(algo)}: the pipeline did "
                "not drop the failed call and re-arm a replacement")
        before = count["updates"]
        while count["updates"] - before < after:
            if sum(count.values()) >= 2 * PIPELINE_MAX_STEPS:
                raise AssertionError(
                    f"after the failure: {dict(count)}, restarts "
                    f"{group.restarts}, armed {_armed(algo)}")
            step()
        if group.restarts != 1 or set(_armed(algo).values()) != {IN_FLIGHT}:
            raise AssertionError(f"{group.restarts} restarts, not 1; armed "
                                 f"{_armed(algo)}")
        if not failed.terminated:
            raise AssertionError("the failed runner was not stopped")
        # every sample call the runners took was armed by the pipeline and
        # has been consumed by an update, dropped with its failed runner,
        # or is still in flight; the synchronous sample never ran
        calls = sum(a.calls.count("sample") for a in runtime.actors)
        if next(sync_calls) != 0 or calls != (
                count["updates"] + count["dropped"] + len(algo._inflight)):
            raise AssertionError(f"{calls} sample calls against "
                                 f"{dict(count)} and "
                                 f"{len(algo._inflight)} in flight")
        membership = list(group.membership)
    finally:
        algo.stop()
        runtime.shutdown()
    return {"iterations": rows, "membership": membership, "failed_slot": slot,
            "updates": count["updates"], "dropped": count["dropped"],
            "policy_version": algo.policy_version}
