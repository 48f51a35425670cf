"""Request router: long-poll-pushed replica sets + probe-free
power-of-two-choices scheduling.

Reference: ray python/ray/serve/_private/router.py:312 Router +
replica_scheduler/pow_2_scheduler.py:49-64 with the long-poll host
(serve/_private/long_poll.py:173). Two changes vs the probing design:

  * REPLICA SET BY PUSH — a daemon thread parks a listen_for_change()
    long-poll on the controller; scale-up/down/health flips reach the
    router in one RPC latency instead of a refresh interval.
  * PROBE-FREE CHOICE — choose_replica never issues a queue-length RPC.
    Each replica's load estimate = this router's own in-flight count
    (incremented on assign, released by DeploymentResponse when the
    caller resolves the result — zero extra threads or RPCs on the
    request path — with a lazy sweep for abandoned refs) + the
    controller-reported ongoing count piggybacked on long-poll replies
    (covers OTHER routers' load at metric-refresh staleness).
"""

from __future__ import annotations

import random
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import ray_tpu_torch
from ray_tpu_torch._private import tracing as _tracing
from ray_tpu_torch._private.backoff import BackoffPolicy

_LONG_POLL_TIMEOUT_S = 30.0


class PowerOfTwoChoicesReplicaScheduler:
    def __init__(self):
        self._replicas: List[Tuple[str, Any]] = []  # (replica_id, handle)
        self._base_load: Dict[str, int] = {}   # controller-reported
        self._local_load: Dict[str, int] = {}  # this router's in-flight
        self._lock = threading.Lock()
        self._rng = random.Random()

    def update_replicas(self, replicas: List[Tuple[str, Any]],
                        metrics: Optional[Dict[str, int]] = None) -> None:
        with self._lock:
            self._replicas = list(replicas)
            live = {rid for rid, _ in self._replicas}
            if metrics:
                self._base_load = {rid: metrics.get(rid, 0) for rid in live}
            else:
                self._base_load = {rid: self._base_load.get(rid, 0)
                                   for rid in live}
            self._local_load = {rid: self._local_load.get(rid, 0)
                                for rid in live}

    def _score(self, replica_id: str) -> int:
        return (self._local_load.get(replica_id, 0)
                + self._base_load.get(replica_id, 0))

    def choose_replica(self) -> Optional[Tuple[str, Any]]:
        """Pick the less-loaded of two random replicas and charge one
        in-flight unit to it (request_done releases)."""
        with self._lock:
            replicas = list(self._replicas)
            if not replicas:
                return None
            if len(replicas) == 1:
                choice = replicas[0]
            else:
                a, b = self._rng.sample(replicas, 2)
                choice = a if self._score(a[0]) <= self._score(b[0]) else b
            self._local_load[choice[0]] = (
                self._local_load.get(choice[0], 0) + 1)
            return choice

    def request_done(self, replica_id: str) -> None:
        with self._lock:
            n = self._local_load.get(replica_id, 0)
            if n > 0:
                self._local_load[replica_id] = n - 1

    def evict(self, replica_id: str) -> None:
        """Drop a replica this router OBSERVED dead (actor-death error on
        submit or reply). The controller's next long-poll push re-syncs
        the authoritative set; until then a dead replica must not keep
        winning the power-of-two choice — with its errored requests
        released it would look like the LEAST loaded candidate."""
        with self._lock:
            self._replicas = [(rid, h) for rid, h in self._replicas
                              if rid != replica_id]
            self._base_load.pop(replica_id, None)
            self._local_load.pop(replica_id, None)


class Router:
    """Per-handle router; replica set maintained by a controller
    long-poll thread, response completions tracked for load scoring."""

    def __init__(self, controller, deployment_name: str, app_name: str = ""):
        self._controller = controller
        self._deployment = deployment_name
        self._app = app_name
        self._key = (f"{app_name}#{deployment_name}" if app_name
                     else deployment_name)
        self._scheduler = PowerOfTwoChoicesReplicaScheduler()
        self._version = -1  # first long-poll returns immediately
        # newest controller incarnation observed: pushes from an OLDER
        # incarnation (a zombie controller after a recovery) are dropped
        self._incarnation = 0
        # controller-down degradation: long-poll failures pace
        # out exponentially instead of hammering a restarting controller
        # at a fixed 0.5s — jittered so a fleet of routers doesn't
        # reconnect in lockstep when it comes back
        self._poll_backoff = BackoffPolicy(base_s=0.2, max_s=5.0,
                                           jitter=0.25)
        self._have_replicas = threading.Event()
        self._stopped = threading.Event()
        # outstanding response refs; resolution decrements local load
        self._outstanding: Dict[Any, str] = {}
        # ref -> replica id of recently RELEASED charges (bounded FIFO):
        # the sweep can release a dead replica's refs before the awaiting
        # caller observes the actor-death error, and its later
        # notify_replica_death must still be able to evict the corpse
        self._recently_done: Dict[Any, str] = {}
        self._out_lock = threading.Lock()
        self._sweep_at = 512
        threading.Thread(target=self._long_poll_loop, daemon=True,
                         name=f"serve-router-poll-{self._key}").start()

    # -- background threads --------------------------------------------------

    def _long_poll_loop(self) -> None:
        failures = 0
        while not self._stopped.is_set():
            try:
                update = ray_tpu_torch.get(
                    self._controller.listen_for_change.remote(
                        self._key, self._version,
                        timeout=_LONG_POLL_TIMEOUT_S),
                    timeout=_LONG_POLL_TIMEOUT_S + 10.0)
            except Exception:  # noqa: BLE001 — controller down/restarting
                # NONSTOP data plane: the cached replica set keeps
                # serving untouched — never evict healthy replicas on a
                # listen_for_change failure; just pace the re-resolve
                failures += 1
                if self._stopped.wait(self._poll_backoff.delay(failures)):
                    return
                continue
            failures = 0
            incarnation = int(update.get("incarnation") or 0)
            if incarnation < self._incarnation:
                # stale push from a zombie incarnation after a recovery:
                # the recovered controller's route state wins
                continue
            self._incarnation = incarnation
            self._version = update["version"]
            self._scheduler.update_replicas(update["replicas"],
                                            update.get("metrics"))
            if update["replicas"]:
                self._have_replicas.set()
            else:
                self._have_replicas.clear()

    def _track(self, ref, replica_id: str):
        with self._out_lock:
            self._outstanding[ref] = replica_id
            sweep = (list(self._outstanding.keys())
                     if len(self._outstanding) >= self._sweep_at else None)
        if sweep:
            # Abandoned-response backstop: callers normally release their
            # charge via notify_done (DeploymentResponse.result); refs
            # dropped without resolving would pin load forever, so sweep
            # completed ones when the table grows. The threshold doubles
            # with the surviving table so a service that LEGITIMATELY
            # holds many in-flight requests doesn't pay an O(n) scan per
            # request — the sweep stays amortized O(1).
            try:
                done, _ = ray_tpu_torch.wait(
                    sweep, num_returns=len(sweep), timeout=0,
                    fetch_local=False)
            except Exception:  # noqa: BLE001
                done = []
            for d in done:
                self.notify_done(d)
            with self._out_lock:
                self._sweep_at = max(512, 2 * len(self._outstanding))
        return ref

    def notify_done(self, ref) -> None:
        """Release the in-flight charge for a resolved response ref
        (idempotent)."""
        with self._out_lock:
            rid = self._outstanding.pop(ref, None)
            if rid is not None:
                self._recently_done[ref] = rid
                while len(self._recently_done) > 1024:
                    self._recently_done.pop(
                        next(iter(self._recently_done)))
        if rid is not None:
            self._scheduler.request_done(rid)

    def notify_replica_death(self, ref) -> None:
        """A response resolved to an actor-death error: release its
        charge AND locally evict the replica so retries stop landing on
        it before the controller's long-poll update arrives. Eviction is
        a fact the caller observed — it must happen even when the sweep
        already released this ref's charge (the _recently_done lookup),
        or the corpse sits in the set at zero load and power-of-two
        keeps feeding it retries."""
        with self._out_lock:
            rid = self._outstanding.pop(ref, None)
            charged = rid is not None
            if rid is None:
                rid = self._recently_done.pop(ref, None)
        if rid is not None:
            if charged:
                self._scheduler.request_done(rid)
            self._scheduler.evict(rid)

    # -- request path --------------------------------------------------------

    def _choose(self):
        choice = self._scheduler.choose_replica()
        if choice is not None:
            return choice
        # cold start / scale-from-zero: wait for the long-poll to deliver
        if not self._have_replicas.wait(timeout=30.0):
            raise RuntimeError(
                f"no replicas available for deployment "
                f"{self._deployment!r} after 30s")
        choice = self._scheduler.choose_replica()
        if choice is None:
            raise RuntimeError(
                f"no replicas available for deployment {self._deployment!r}")
        return choice

    def _submit(self, replica_id: str, handle, method_name: str,
                args: tuple, kwargs: dict):
        """Submit to the chosen replica; a KNOWN-dead actor raises right
        at submit, so release the charge and evict before re-raising —
        otherwise the leaked charge pins load on a corpse and retries
        keep picking it (it looks idle). Any other submit-time error
        (bad payload, transient RPC failure) releases the charge but
        keeps the replica routable — evicting a healthy replica on a
        caller-side error would drain the set one malformed request at
        a time until the next long-poll resync."""
        ctx = _tracing.current_trace()
        t_pick = time.time() if ctx is not None else 0.0
        try:
            ref = handle.handle_request.remote(method_name, args, kwargs)
            if ctx is not None:
                # the routing decision of a traced request: which replica
                # won the power-of-two choice (submission is a child span
                # of the same context via the spec's own trace_ctx)
                _tracing.record_span(
                    "router.pick", ctx, t_pick, time.time(),
                    attrs={"deployment": self._deployment,
                           "replica": replica_id})
        except ray_tpu_torch.exceptions.ActorDiedError:
            self._scheduler.request_done(replica_id)
            self._scheduler.evict(replica_id)
            raise
        except Exception:
            self._scheduler.request_done(replica_id)
            raise
        return self._track(ref, replica_id)

    def assign_request(self, method_name: str, args: tuple, kwargs: dict):
        """Returns an ObjectRef for the response."""
        replica_id, handle = self._choose()
        return self._submit(replica_id, handle, method_name, args, kwargs)

    def try_assign_request(self, method_name: str, args: tuple,
                           kwargs: dict):
        """Non-blocking assign_request: None when no replica is known yet
        (cold start / scale-from-zero) instead of parking the caller.
        The proxy's async handlers use this so the event loop never waits
        on replica availability."""
        choice = self._scheduler.choose_replica()
        if choice is None:
            return None
        replica_id, handle = choice
        return self._submit(replica_id, handle, method_name, args, kwargs)

    def assign_request_streaming(self, method_name: str, args: tuple,
                                 kwargs: dict):
        """Returns an ObjectRefGenerator of response chunks."""
        ctx = _tracing.current_trace()
        t_pick = time.time() if ctx is not None else 0.0
        replica_id, handle = self._choose()
        gen = handle.handle_request_streaming.options(
            num_returns="streaming").remote(method_name, args, kwargs)
        if ctx is not None:
            _tracing.record_span(
                "router.pick", ctx, t_pick, time.time(),
                attrs={"deployment": self._deployment,
                       "replica": replica_id, "streaming": True})
        # Streams aren't completion-tracked (their lifetime is the whole
        # generator); release the local charge and let the controller's
        # piggybacked ongoing counts carry streaming load.
        self._scheduler.request_done(replica_id)
        return gen

    def stop(self) -> None:
        self._stopped.set()


_shared_routers: Dict[Tuple[Any, str], Router] = {}
_shared_lock = threading.Lock()


def shutdown_routers() -> None:
    """Stop every shared router (serve.shutdown): without this, each
    router's long-poll thread would retry the dead controller forever and
    the registry would leak an entry per controller incarnation."""
    with _shared_lock:
        routers = list(_shared_routers.values())
        _shared_routers.clear()
    for r in routers:
        r.stop()


def shared_router(controller, deployment_name: str,
                  app_name: str = "") -> Router:
    """One Router (and long-poll thread) per (controller, deployment) per
    process. Handles are created freely — per composing replica, per
    proxy route rebuild — and each Router parks a controller thread, so
    per-handle routers would leak pollers and saturate the controller's
    concurrency slots."""
    actor_key = getattr(controller, "_actor_id", None)
    key = (actor_key, f"{app_name}#{deployment_name}")
    with _shared_lock:
        router = _shared_routers.get(key)
        if router is None or router._stopped.is_set():
            router = Router(controller, deployment_name, app_name)
            _shared_routers[key] = router
        return router
