"""The decoupled, crashable RL dataflow: the port's counterpart of
`ray_tpu/rllib/dataflow.py` (`SampleQueueActor` :69-158, `_Slot` /
`RolloutFleet` :160-442, `DecoupledDataflow` :445-570), with its names and
behaviour.

A fleet of rollout `EnvRunner` actors pushes sample batches into a bounded
sample queue while the learner pulls asynchronously: sampling never blocks
on learning, and the learner never waits on any one runner.

* `SampleQueueActor`: the bounded queue. Entries are small (a ref, the
  policy version and the runner's incarnation); the payloads stay in the
  object store, owned by the runner that put them, so a dead runner's
  batches reach the learner as the runtime's ObjectLostError /
  OwnerDiedError and are counted discarded, never trained on. A push to a
  full queue is shed back to the runner with a retry-after hint
  (`rl.sample_shed`); a push from a superseded incarnation is rejected
  (`rl.zombie_push`); installing an incarnation discards the older
  incarnations' entries.
* `RolloutFleet`: the learner process's side of the fleet. It keeps
  `max_requests_in_flight_per_env_runner` `sample_and_push` calls armed per
  runner, finds deaths from the acks and `node.preempt_notice` events,
  respawns a dead runner with the current weights without a blocking call
  on the learner's path (while the respawn budget lasts), resizes itself
  on 5 starved or 5 backlogged pumps, and broadcasts versioned weights
  with one put and N refs (`rl.runner_dead`, `rl.runner_respawn`,
  `rl.fleet_scale`, `rl.weights_broadcast`).
* `DecoupledDataflow`: the learner side. One round trip a pull; a batch
  older than `max_sample_staleness` versions is dropped, counted and
  never trained on (`rl.stale_drop`); the five `ray_tpu_rl_*` families
  are exported through `util.metrics.backend()`.

The runtime comes in as one value (README, "The runtime boundary"), never
as an import: an object with four attributes.

- `remote`: the actor decorator (`ray_tpu.remote`). Runners are
  `CardActor`s bound to their cards as the sync group's are; a respawn
  takes its slot's position.
- `put`: `ray_tpu.put`. Each runner calls it on its own episodes, so that
  it owns them, and the broadcast calls it once on host copies of the
  weights (the wire rebuilds a CUDA tensor on its sender's card index).
- `get_runtime_context`: `ray_tpu.get_runtime_context`, called in each
  runner for the runtime's id of its node, which a preempt notice carries
  (`CardActor.node()` is the host's name, another thing).
- `event_cursor`: the runtime's `EventCursor` class
  (`ray_tpu._private.event_watch`); the fleet polls
  `event_cursor("node.preempt_notice")`.

For the runtime that is `types.SimpleNamespace(remote=ray_tpu.remote,
put=ray_tpu.put, get_runtime_context=ray_tpu.get_runtime_context,
event_cursor=EventCursor)`; `remote_cases.LocalRuntime` is one as it is.

Refs are read through their own `future()`. Events go through
`util.metrics`: the learner process's after `use_runtime(emit=...)`; the
queue, an actor in a process of its own, is handed the emitter installed
in its creator's process when it is built.
"""

from __future__ import annotations

import concurrent.futures
import logging
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

from ray_tpu_torch._private import actors
from ray_tpu_torch._private.serialization import install_tensor_wire
from ray_tpu_torch.rllib.env_runner import EnvRunner
from ray_tpu_torch.util import metrics

logger = logging.getLogger(__name__)

# The queue's bound where the config names none (the runtime's
# CONFIG.rl_sample_queue_max).
SAMPLE_QUEUE_MAX = 64
# How long the learner waits for the queue's reply and for a payload.
PULL_TIMEOUT_S = 30.0

NEEDS_RUNTIME_VALUE = (
    "the decoupled dataflow runs on the runtime: pass it as one value with "
    "config.runtime(SimpleNamespace(remote=ray_tpu.remote, put=ray_tpu.put, "
    "get_runtime_context=ray_tpu.get_runtime_context, "
    "event_cursor=EventCursor)) (EventCursor from "
    "ray_tpu._private.event_watch)")


def retry_after_hint(depth: int, per_item_s: float = 0.001,
                     floor_s: float = 0.5, cap_s: float = 5.0) -> float:
    """The retry-after hint of a bounded queue's pushback (the runtime's
    `backoff.retry_after_hint`): the backlog's drain time (depth x
    per-item cost), floored so a just-full queue is not hammered at once,
    capped so a deep one does not park its callers for minutes."""
    return min(cap_s, max(floor_s, depth * per_item_s))


def host_weights(weights) -> Dict[str, Any]:
    """The state dict `weights` on the host, for the wire."""
    return {k: v.detach().to("cpu") for k, v in weights.items()}


class SampleQueueActor:
    """Bounded sample queue between the rollout fleet and the learner.

    `maxsize` entries; an entry carries a ref, never a payload. `emit`:
    the runtime's event emitter for this actor's events (None: the route
    `util.metrics.use_runtime` installed in this process)."""

    def __init__(self, maxsize: int, emit: Optional[Callable] = None):
        self._maxsize = int(maxsize)
        self._emit = emit
        self._items: List[dict] = []  # bounded by _maxsize in push()
        # runner slot -> current incarnation; pushes below it are zombies
        self._incarnations: Dict[int, int] = {}
        self._stats = {"pushed": 0, "popped": 0, "shed": 0,
                       "zombie_rejected": 0, "discarded_dead": 0}

    def set_incarnation(self, runner: int, incarnation: int) -> int:
        """Install a runner slot's current incarnation (spawn, respawn,
        retirement) and discard the queued entries of its older
        incarnations. -> how many were discarded."""
        runner = int(runner)
        cur = self._incarnations.get(runner, -1)
        if incarnation < cur:
            return 0  # an installer that arrives out of order
        self._incarnations[runner] = int(incarnation)
        keep = []
        dropped = 0
        for e in self._items:
            if e.get("runner") == runner \
                    and e.get("incarnation", 0) < incarnation:
                dropped += 1
            else:
                keep.append(e)
        if dropped:
            self._items = keep
            self._stats["discarded_dead"] += dropped
        return dropped

    def push(self, entry: dict) -> dict:
        runner = int(entry.get("runner", 0))
        incarnation = int(entry.get("incarnation", 0))
        current = self._incarnations.get(runner, -1)
        if incarnation < current:
            # a superseded incarnation still pushing: never queued
            self._stats["zombie_rejected"] += 1
            metrics.emit_to(self._emit, "rl.zombie_push", runner=runner,
                            incarnation=incarnation, current=current)
            return {"rejected": "zombie", "current": current}
        if incarnation > current:
            # a replacement's first push can beat the fleet's install
            self._incarnations[runner] = incarnation
        if len(self._items) >= self._maxsize:
            self._stats["shed"] += 1
            metrics.emit_to(self._emit, "rl.sample_shed", runner=runner,
                            depth=len(self._items))
            # refused (not queued, not lost): retry after one fragment's
            # train time per queued entry, floored
            return {"retry_later": True,
                    "retry_after_s": retry_after_hint(
                        len(self._items), per_item_s=0.01, floor_s=0.05,
                        cap_s=1.0)}
        self._items.append(entry)
        self._stats["pushed"] += 1
        return {"ok": True, "depth": len(self._items)}

    def pop_batch(self, max_items: int) -> dict:
        """Pop up to `max_items` entries with a stats snapshot in one
        reply: a second round trip that failed would strand entries
        already popped."""
        out, self._items = (self._items[:max_items],
                            self._items[max_items:])
        self._stats["popped"] += len(out)
        return {"entries": out, **self.stats()}

    def depth(self) -> int:
        return len(self._items)

    def stats(self) -> dict:
        return {"depth": len(self._items), "maxsize": self._maxsize,
                "incarnations": dict(self._incarnations), **self._stats}


class _Slot:
    """One rollout-fleet slot: a runner actor and its incarnation."""

    def __init__(self, index: int, incarnation: int, handle):
        self.index = index
        self.incarnation = incarnation
        self.handle = handle
        self.node_future = None     # get_node_id in flight
        self.node_id: Optional[str] = None
        self.host_future = None     # a respawn's bind_slot in flight
        self.inflight: set = set()  # futures of armed sample_and_push
        self.actor_id = handle._actor_id.hex()


class RolloutFleet:
    """The learner process's manager of a crashable, elastic rollout
    fleet."""

    def __init__(self, config: Dict[str, Any], module_spec: Dict[str, Any],
                 queue_handle, runtime):
        self._config = config
        self._module_spec = module_spec
        self._queue = queue_handle
        self._cls = runtime.remote(actors.CardActor)
        self._put = runtime.put
        self._runtime_context = runtime.get_runtime_context
        self._device = config.get("device")
        self._num_steps = config.get("rollout_fragment_length", 200)
        self._per_runner_inflight = max(
            1, int(config.get("max_requests_in_flight_per_env_runner", 2)))
        self._restart = config.get("restart_failed_env_runners", True)
        self._restart_budget = int(
            config.get("max_env_runner_restarts", 20))
        self._elastic_min = config.get("elastic_min_env_runners")
        self._elastic_max = config.get("elastic_max_env_runners")
        self._lock = threading.Lock()   # snapshot() is read cross-thread
        self.slots: Dict[int, _Slot] = {}
        # each slot index's host (None: not known yet, or retired): what
        # a respawn's card position is counted from
        self._nodes: List[Optional[str]] = []
        self._next_index = 0
        self._weights_ref = None
        self._version = 0
        self.restarts = 0
        self.deaths = 0
        self._acks = {"pushed": 0, "shed": 0, "env_steps": 0}
        # starvation/backlog windows for the elastic policy
        self._starved_pumps = 0
        self._backlogged_pumps = 0
        # preempt notices, each taken once
        self._preempt_cursor = runtime.event_cursor("node.preempt_notice")

    # -- lifecycle -----------------------------------------------------------

    def start(self, weights, version: int = 0) -> None:
        """Put the weights, then build `num_env_runners` runners, each
        bound to the card at its position on its node, and arm them."""
        install_tensor_wire()
        self._weights_ref = self._put(host_weights(weights))
        self._version = int(version)
        n = int(self._config.get("num_env_runners", 0))
        handles = [self._new_actor(i) for i in range(n)]
        self._nodes = actors.place_actors(handles, self._device)
        self._next_index = n
        for i, handle in enumerate(handles):
            self._start_slot(i, 0, handle)

    def stop(self) -> None:
        with self._lock:
            slots = list(self.slots.values())
            self.slots = {}
        for s in slots:
            actors.terminate(s.handle)

    # -- spawning ------------------------------------------------------------

    def _actor_options(self) -> dict:
        opts: Dict[str, Any] = {
            "num_cpus": self._config.get("num_cpus_per_env_runner", 1)}
        custom = self._config.get("custom_resources_per_env_runner")
        if custom:
            opts["resources"] = dict(custom)
        return opts

    def _new_actor(self, index: int):
        return self._cls.options(**self._actor_options()).remote(
            EnvRunner, self._config, self._module_spec, index + 1)

    def _start_slot(self, index: int, incarnation: int, handle) -> _Slot:
        """Send a bound runner the versioned weights, install its
        incarnation at the queue (older queued pushes of the slot are
        discarded), ask its node, arm it, and enter it in the fleet."""
        slot = _Slot(index, incarnation, handle)
        handle.set_weights.remote(self._weights_ref, self._version)
        self._queue.set_incarnation.remote(index, incarnation)
        slot.node_future = handle.get_node_id.remote(
            self._runtime_context).future()
        for _ in range(self._per_runner_inflight):
            self._arm(slot)
        with self._lock:
            self.slots[index] = slot
        return slot

    def _spawn_slot(self, index: Optional[int] = None,
                    incarnation: int = 0) -> _Slot:
        """A runner for `index` (a fresh slot when None), armed. Every
        call is a submission: the actor binds its card at its slot's
        position itself (`CardActor.bind_slot`) before the calls queued
        after it, so a respawn takes none of the learner's time."""
        if index is None:
            index = self._next_index
            self._next_index += 1
        while len(self._nodes) <= index:
            self._nodes.append(None)
        handle = self._new_actor(index)
        host = handle.bind_slot.remote(list(self._nodes), index,
                                       self._device)
        slot = self._start_slot(index, incarnation, handle)
        slot.host_future = host.future()
        return slot

    def _arm(self, slot: _Slot) -> None:
        ref = slot.handle.sample_and_push.remote(
            self._queue, self._put, num_steps=self._num_steps,
            runner_index=slot.index, incarnation=slot.incarnation)
        slot.inflight.add(ref.future())

    # -- death / preemption / respawn ----------------------------------------

    def _on_runner_gone(self, slot: _Slot, reason: str) -> None:
        """A runner died (a gone-runner error on an ack) or its node got a
        preempt notice: stop it, discard its queued batches through the
        incarnation bump, and respawn the slot with the current
        weights."""
        with self._lock:
            live = self.slots.get(slot.index)
            if live is None or live.incarnation != slot.incarnation:
                return  # already replaced (a death raced the preempt path)
            del self.slots[slot.index]
        self.deaths += 1
        metrics.emit("rl.runner_dead", actor_id=slot.actor_id,
                     runner=slot.index, reason=reason,
                     incarnation=slot.incarnation)
        # a preempted runner may run on through the notice window, and a
        # lost object can be reported while its actor lives: stop it (its
        # pushes would be rejected as a zombie's anyway)
        actors.terminate(slot.handle)
        if not self._restart:
            return
        if self.restarts >= self._restart_budget:
            logger.warning(
                "rollout runner %d died (%s) but the respawn budget "
                "(max_env_runner_restarts=%d) is spent; fleet degrades "
                "to %d runner(s)", slot.index, reason,
                self._restart_budget, len(self.slots))
            return
        self.restarts += 1
        new = self._spawn_slot(slot.index, slot.incarnation + 1)
        metrics.emit("rl.runner_respawn", actor_id=new.actor_id,
                     runner=new.index, incarnation=new.incarnation,
                     reason=reason)

    def _check_preempt_notices(self) -> None:
        for ev in self._preempt_cursor.poll(limit=100):
            node = ev.get("node_id")
            if not node:
                continue
            with self._lock:
                victims = [s for s in self.slots.values()
                           if s.node_id == node]
            for slot in victims:
                self._on_runner_gone(slot, "preempt_notice")

    # -- the pump ------------------------------------------------------------

    def pump(self, timeout: float = 0.0) -> Dict[str, int]:
        """Collect the acks that are in, re-arm their runners, note the
        runners' nodes, and react to deaths and preempt notices. Does not
        wait unless `timeout` > 0: this runs on the learner's path."""
        self._check_preempt_notices()
        with self._lock:
            slots = list(self.slots.values())
        for slot in slots:
            if slot.host_future is not None and slot.host_future.done():
                try:
                    self._nodes[slot.index] = slot.host_future.result()
                except Exception as err:  # noqa: BLE001
                    # a bind that failed for another reason than a dead
                    # actor (no card) is raised here, not as the
                    # unbound actor's errors on every armed call
                    actors.check_gone(err)
                slot.host_future = None
            if slot.node_id is None and slot.node_future is not None \
                    and slot.node_future.done():
                try:
                    slot.node_id = slot.node_future.result()
                except Exception as err:  # noqa: BLE001
                    actors.check_gone(err)
                    self._on_runner_gone(slot, "actor_died")
                slot.node_future = None
        by_future: Dict[Any, _Slot] = {
            f: slot for slot in slots for f in slot.inflight}
        if not by_future:
            return dict(self._acks)
        if timeout > 0:
            concurrent.futures.wait(list(by_future), timeout=timeout)
        dead: Dict[int, Tuple[_Slot, str]] = {}
        for f, slot in by_future.items():
            if not f.done():
                continue
            slot.inflight.discard(f)
            try:
                ack = f.result()
            except Exception as err:  # noqa: BLE001 — a sampling bug raises
                actors.check_gone(err)
                dead.setdefault(slot.index, (slot, type(err).__name__))
                continue
            self._acks["env_steps"] += int(ack.get("env_steps", 0))
            if ack.get("pushed"):
                self._acks["pushed"] += 1
            elif ack.get("shed"):
                self._acks["shed"] += 1
            # re-arm (the runner paced itself on a shed); a runner dead
            # between the ack and the re-arm raises at the submission
            if self.slots.get(slot.index) is slot:
                try:
                    self._arm(slot)
                except Exception as err:  # noqa: BLE001
                    actors.check_gone(err)
                    dead.setdefault(slot.index, (slot, type(err).__name__))
        for slot, reason in dead.values():
            self._on_runner_gone(slot, reason)
        return dict(self._acks)

    # -- weights -------------------------------------------------------------

    def broadcast(self, weights, version: int) -> None:
        """Versioned weights to every live runner: one put of host copies,
        N refs. Nothing waits: a runner that dies meanwhile is found by the
        next pump."""
        self._weights_ref = self._put(host_weights(weights))
        self._version = int(version)
        with self._lock:
            slots = list(self.slots.values())
        for slot in slots:
            try:
                slot.handle.set_weights.remote(self._weights_ref, version)
            except Exception as err:  # noqa: BLE001 — dead at submit
                actors.check_gone(err)
                self._on_runner_gone(slot, "actor_died")
        metrics.emit("rl.weights_broadcast", version=version,
                     runners=len(slots))

    # -- elastic scaling -----------------------------------------------------

    def maybe_autoscale(self, queue_depth: int, shed_delta: int) -> None:
        """Elastic fleet size from the signals the metrics export: a queue
        empty for 5 pumps starves the learner (one more runner, up to
        elastic_max_env_runners); sheds for 5 pumps mean the rollouts
        outpace it (one fewer, down to the minimum)."""
        if self._elastic_max is None:
            return
        lo = int(self._elastic_min if self._elastic_min is not None
                 else self._config.get("num_env_runners", 1))
        hi = int(self._elastic_max)
        n = len(self.slots)
        self._starved_pumps = self._starved_pumps + 1 \
            if queue_depth == 0 and shed_delta == 0 else 0
        self._backlogged_pumps = self._backlogged_pumps + 1 \
            if shed_delta > 0 else 0
        if self._starved_pumps >= 5 and n < hi:
            self._starved_pumps = 0
            self._spawn_slot()
            metrics.emit("rl.fleet_scale", from_runners=n, to_runners=n + 1,
                         reason="learner_starved")
        elif self._backlogged_pumps >= 5 and n > lo:
            self._backlogged_pumps = 0
            with self._lock:
                idx = max(self.slots)
                slot = self.slots.pop(idx)
            # retire the slot: the bumped incarnation discards its queued
            # entries, and the actor is stopped
            self._queue.set_incarnation.remote(idx, slot.incarnation + 1)
            actors.terminate(slot.handle)
            self._nodes[idx] = None
            metrics.emit("rl.fleet_scale", from_runners=n, to_runners=n - 1,
                         reason="queue_backlogged")

    # -- introspection -------------------------------------------------------

    def snapshot(self) -> Dict[int, Dict[str, Any]]:
        """The fleet, read under its lock (a drill picks its victims from
        it on another thread)."""
        with self._lock:
            return {
                i: {"actor_id": s.actor_id, "incarnation": s.incarnation,
                    "node_id": s.node_id, "handle": s.handle}
                for i, s in self.slots.items()
            }

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            n = len(self.slots)
        return {"runners": n, "deaths": self.deaths,
                "restarts": self.restarts, "version": self._version,
                **self._acks}


class DecoupledDataflow:
    """The learner's side of the queue and the fleet. `runtime` (the
    module's docstring) is required: without it this raises ValueError,
    and nothing runs in this process in its place."""

    def __init__(self, config: Dict[str, Any], module_spec: Dict[str, Any],
                 weights, version: int = 0, *, runtime=None):
        if runtime is None:
            raise ValueError(NEEDS_RUNTIME_VALUE)
        bound = int(config.get("sample_queue_size") or SAMPLE_QUEUE_MAX)
        qopts: Dict[str, Any] = {"num_cpus": 0.05}
        if config.get("sample_queue_resources"):
            # e.g. the head node, while the fleet rides preemptible ones
            qopts["resources"] = dict(config["sample_queue_resources"])
        self.queue = runtime.remote(SampleQueueActor).options(**qopts).remote(
            bound, metrics.runtime()["emit"])
        self.fleet = RolloutFleet(config, module_spec, self.queue, runtime)
        try:
            self.fleet.start(weights, version)
        except BaseException:
            self.fleet.stop()
            actors.terminate(self.queue)
            raise
        self.max_staleness = int(config.get("max_sample_staleness", 2))
        self.stale_dropped = 0
        self.discarded_dead = 0
        self.env_steps_trained = 0
        self._last_shed = 0
        self._exported: Optional[Dict[str, int]] = None

    def pull(self, current_version: int,
             max_batches: Optional[int] = None,
             ) -> List[Tuple[dict, list]]:
        """Pump the fleet, pop the queued entries, drop those past the
        staleness bound, and read the rest. -> [(entry, episodes), ...],
        the batches safe to train on. Waits on no runner."""
        self.fleet.pump()
        if max_batches is None:
            max_batches = max(2, 2 * len(self.fleet.slots))
        try:
            # one round trip: the entries and the stats together, so a
            # failure here loses nothing (the entries stay queued)
            qstats = self.queue.pop_batch.remote(max_batches).future(
            ).result(timeout=PULL_TIMEOUT_S)
            entries = qstats["entries"]
        except Exception:  # noqa: BLE001 — the queue actor's blip
            logger.warning("sample queue unreachable this pull; retrying "
                           "next step", exc_info=True)
            return []
        out: List[Tuple[dict, list]] = []
        for e in entries:
            version = int(e.get("policy_version", 0))
            if current_version - version > self.max_staleness:
                # the off-policy staleness bound: dropped, counted, never
                # trained on
                self.stale_dropped += 1
                metrics.emit("rl.stale_drop", version=current_version,
                             batch_version=version, bound=self.max_staleness,
                             runner=e.get("runner"))
                continue
            try:
                episodes = e["ref"].future().result(timeout=PULL_TIMEOUT_S)
            except Exception as err:  # noqa: BLE001
                # the runner that put this batch died with it
                actors.check_gone(err)
                self.discarded_dead += 1
                continue
            self.env_steps_trained += int(e.get("env_steps", 0))
            out.append((e, episodes))
        shed_delta = qstats["shed"] - self._last_shed
        self._last_shed = qstats["shed"]
        self.fleet.maybe_autoscale(qstats["depth"], shed_delta)
        self._export_metrics(qstats)
        return out

    def broadcast(self, weights, version: int) -> None:
        self.fleet.broadcast(weights, version)

    def stats(self) -> Dict[str, Any]:
        return {"stale_dropped": self.stale_dropped,
                "discarded_dead": self.discarded_dead,
                "env_steps_trained": self.env_steps_trained,
                **{f"fleet_{k}": v for k, v in self.fleet.stats().items()}}

    def stop(self) -> None:
        self.fleet.stop()
        actors.terminate(self.queue)

    # -- metrics (the autoscaler's and the dashboard's) ----------------------

    def _export_metrics(self, qstats: dict) -> None:
        try:
            m = metrics.backend()
            m.get_or_create_gauge(
                "ray_tpu_rl_queue_depth",
                "Sample-queue depth (entries)").set(qstats["depth"])
            m.get_or_create_gauge(
                "ray_tpu_rl_rollout_runners",
                "Live rollout runners").set(len(self.fleet.slots))
            counters = (
                ("ray_tpu_rl_samples_shed_total",
                 "Sample batches shed by the bounded queue", "shed",
                 qstats["shed"]),
                ("ray_tpu_rl_stale_dropped_total",
                 "Batches dropped by the staleness bound", "stale",
                 self.stale_dropped),
                ("ray_tpu_rl_runner_restarts_total",
                 "Rollout runners respawned after death", "restarts",
                 self.fleet.restarts))
            if self._exported is None:
                # the counters exist from the first export, so dashboards
                # see zeros rather than gaps
                for name, desc, _, _ in counters:
                    m.get_or_create_counter(name, desc)
                self._exported = {"shed": 0, "stale": 0, "restarts": 0}
            for name, desc, key, total in counters:
                d = total - self._exported[key]
                if d > 0:
                    m.get_or_create_counter(name, desc).inc(d)
                    self._exported[key] = total
        except Exception:  # noqa: BLE001 — metrics never fail training
            logger.debug("rl metric export failed", exc_info=True)
