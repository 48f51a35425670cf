"""The remote RL groups' work on one device without the runtime:
`chip_smoke.py`'s phase (q) and its CPU rehearsal.

The runtime's actors cannot run on a machine without its dependencies, so
`LocalRuntime` stands in for its actor decorator: each "actor" is the
object on a thread of its own, its calls run in order on that thread,
their arguments and results travel by value through the port's pickler
into one buffer and out again (`by_value`: the typed tensor wire), and
`.remote` returns a ref whose `future()` holds the result. `fail()`
makes every call of an actor raise `RayActorError`, a class named as the
runtime's exception for a dead actor (`actors.RUNNER_GONE`): the calls it
has not yet run, and those whose results wait unread, as if the node went
with the objects it held. So a failure can reach an armed call that has
already finished.
For the decoupled dataflow the stand-in is the runtime as one value: it
also has a `put` (the object is owned by the stand-in actor whose call
made it, and once that actor has failed or stopped, reading it raises
`OwnerDiedError`, a class named as the runtime's), a
`get_runtime_context` (its one node's id) and an `event_cursor` (over the
notices `preempt` posts). Handles and refs travel by identity, and a
call's top-level refs are read before it runs, as the runtime does. It is
a fixture, not a runtime: it has what the cases need and no more.
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
import io
import itertools
import pickle
import threading
import time
import types
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ray_tpu_torch._private import actors, serialization
from ray_tpu_torch.rllib.algorithms.impala import IMPALAConfig
from ray_tpu_torch.rllib.algorithms.ppo import PPOConfig, PPOLearner
from ray_tpu_torch.rllib.catalog import Catalog
from ray_tpu_torch.rllib.env_runner import EnvRunner, EnvRunnerGroup
from ray_tpu_torch.rllib.learner import LearnerGroup, parameter_mean
from ray_tpu_torch.util import metrics

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


class ObjectLostError(RuntimeError):
    """Named as the runtime's exception for an object that is gone."""


class OwnerDiedError(ObjectLostError):
    """What reading an object of a failed or stopped stand-in actor
    raises: named as the runtime's."""


# the stand-in actor whose call runs on this thread: what its `put` makes
# it owns
_current = threading.local()
_actor_ids = itertools.count(1)


class LocalObjectRef:
    """What the stand-in's `put` returns: the value, read as
    OwnerDiedError once its owner (a stand-in actor) has failed or
    stopped."""

    def __init__(self, value, owner: Optional["LocalActor"]):
        self._value, self._owner = value, owner

    def value(self):
        owner = self._owner
        if owner is not None and (owner._failed is not None
                                  or owner.terminated):
            raise OwnerDiedError("the owner of this object is gone")
        return self._value

    def future(self) -> concurrent.futures.Future:
        out = concurrent.futures.Future()
        try:
            out.set_result(self.value())
        except OwnerDiedError as err:
            out.set_exception(err)
        return out


class LocalEventCursor:
    """The stand-in's EventCursor: each of its runtime's notices of type
    `etype` posted after the cursor was made, once."""

    def __init__(self, runtime: "LocalRuntime", etype: str):
        self._runtime, self.etype = runtime, etype
        self._seen = len(runtime.notices)

    def poll(self, limit: int = 100) -> List[dict]:
        new = self._runtime.notices[self._seen:self._seen + limit]
        self._seen += len(new)
        return [e for e in new if e["type"] == self.etype]


class _StandInPickler(serialization._TensorPickler):
    """The port's pickler, with the stand-in's handles, refs and runtime
    kept by identity, as the runtime's handles and refs travel."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.kept: List[Any] = []

    def persistent_id(self, obj):
        if isinstance(obj, (LocalActor, LocalObjectRef, LocalRuntime)):
            self.kept.append(obj)
            return len(self.kept) - 1
        return None


def by_value(value):
    """`value` as a receiver gets it: through the port's pickler into one
    buffer of its own, as the object store holds it (the stand-in's
    handles, refs and runtime by identity)."""
    buffers: List[pickle.PickleBuffer] = []
    sink = io.BytesIO()
    pickler = _StandInPickler(sink, protocol=5,
                              buffer_callback=buffers.append)
    pickler.dump(value)
    wire = serialization.SerializedObject.from_bytes(
        serialization.SerializedObject(sink.getvalue(), buffers).to_bytes())
    unpickler = pickle.Unpickler(io.BytesIO(wire.inband),
                                 buffers=wire.buffers)
    unpickler.persistent_load = pickler.kept.__getitem__
    return unpickler.load()


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


def _read_refs(args, kwargs):
    """A call's top-level refs read, as the runtime passes them."""
    def read(a):
        return a.value() if isinstance(a, LocalObjectRef) else a

    return ([read(a) for a in args], {k: read(v) for k, v in kwargs.items()})


class LocalActor:
    """A stand-in actor handle: the instance lives on one thread."""

    def __init__(self, cls, args, kwargs, options):
        self.options = options
        self.calls: List[str] = []
        self.terminated = False
        self._failed = None
        # read as the runtime's: `handle._actor_id.hex()`
        self._actor_id = next(_actor_ids).to_bytes(16, "big")
        self._pool = concurrent.futures.ThreadPoolExecutor(
            1, thread_name_prefix=f"local-actor-{cls.__name__}")
        args, kwargs = by_value((args, kwargs))
        self._instance = self._pool.submit(lambda: cls(*args, **kwargs))

    def _run(self, name, args, kwargs):
        _current.actor = self
        if self._failed is not None:
            raise self._failed
        args, kwargs = _read_refs(args, kwargs)
        return by_value(getattr(self._instance.result(), name)(
            *args, **kwargs))

    def _submit(self, name, args, kwargs) -> LocalRef:
        if self.terminated:
            raise RayActorError("the stand-in actor was stopped")
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
    """The stand-in for the runtime, as one value (`rllib/dataflow.py`):
    `remote` is its actor decorator, `put` and `get_runtime_context` its
    put and runtime context, `event_cursor` its EventCursor class. Its
    actors sit on one node, `node_id`. It is a fixture for the cases and
    `chip_smoke.py`, not a runtime: it has what they need and no more."""

    def __init__(self, node_id: str = "stand-in-node"):
        self.actors: List[LocalActor] = []
        self.node_id = node_id
        self.notices: List[dict] = []

    def remote(self, cls) -> LocalActorClass:
        return LocalActorClass(self, cls, {})

    def put(self, value) -> LocalObjectRef:
        """`value` by value, owned by the stand-in actor whose call runs
        this (none: the calling process itself)."""
        return LocalObjectRef(by_value(value),
                              getattr(_current, "actor", None))

    def get_runtime_context(self) -> types.SimpleNamespace:
        return types.SimpleNamespace(get_node_id=lambda: self.node_id)

    def event_cursor(self, etype: str) -> LocalEventCursor:
        return LocalEventCursor(self, etype)

    def preempt(self, node_id: Optional[str] = None,
                deadline_s: float = 30.0) -> None:
        """Post a node.preempt_notice for `node_id` (this runtime's node),
        as the runtime's raylet emits one."""
        self.notices.append({"type": "node.preempt_notice",
                             "node_id": node_id or self.node_id,
                             "data": {"deadline_s": deadline_s,
                                      "reason": "stand-in"}})

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
    failed slot, the fragments dropped, and the membership changes as
    (event, slot, incarnation, reason), from the events emitted."""
    seq = max([e["seq"] for e in metrics.events()] or [0])
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
        membership = [(e["type"], e["data"]["runner"],
                       e["data"]["incarnation"], e["data"]["reason"])
                      for e in metrics.events("rl.runner_")
                      if e["seq"] > seq]
    finally:
        algo.stop()
        runtime.shutdown()
    return {"iterations": rows, "membership": membership, "failed_slot": slot,
            "updates": count["updates"], "dropped": count["dropped"],
            "policy_version": algo.policy_version}
