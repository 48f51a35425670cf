"""ServeController actor.

Reference: ray python/ray/serve/_private/controller.py:86 — owns target
state; run_control_loop (:369) reconciles: deployment state machines
(deployment_state.py:1226,2309) start/stop ReplicaActors toward the target
replica count, health-check them, and apply autoscaling decisions
(autoscaling_state.py:262 get_decision_num_replicas over replica queue
metrics).

The controller is a plain threaded actor: a daemon reconcile thread runs
~5Hz. Replica gangs per deployment; handles are served to routers from the
live-replica table.

Routers learn about replica-set changes through LONG-POLL PUSH
(reference: serve/_private/long_poll.py:173 LongPollHost): they park a
`listen_for_change(key, last_version)` call on the controller, which
returns the moment the key's version moves (replica started/stopped/
health flip) — scale-downs reach routers in one RPC latency instead of a
poll interval. Replies piggyback the controller's latest per-replica
ongoing-request counts so routers never probe queue lengths on the
request path.

CRASH TOLERANCE: the controller is a named actor with
max_restarts=-1, and every reconcile-relevant mutation write-throughs a
schema-versioned checkpoint into the GCS internal KV (reference: ray's
serve controller snapshots into the GCS-backed KV and recovers from it,
arXiv:1712.05889 §4.3). A restarted incarnation loads the checkpoint and
ADOPTS its live, named replicas and proxy shards — health-check, not
restart — so a controller crash never touches the data plane: routers
keep serving from cached replica sets while it is down (paced re-resolve
in router.py), and the recovered controller's pushes carry a bumped
incarnation so a zombie's stale pushes are rejected. Preempt/drain
bookkeeping is NOT checkpointed per tick; it rebuilds from the event log
(node.preempt_notice replay via EventCursor) so a death mid-preemption
cannot leak a draining replica.
"""

from __future__ import annotations

import logging
import math
import pickle
import threading
import time
from typing import Any, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch._private import event_log
from ray_tpu_torch._private.event_watch import EventCursor
from ray_tpu_torch.serve._private.replica import ReplicaActor

logger = logging.getLogger(__name__)

RECONCILE_INTERVAL_S = 0.2
HEALTH_CHECK_INTERVAL_S = 2.0
# A replica is STARTING until its constructor finishes (first
# check_health reply); user __init__ may compile models for minutes, so
# init gets its own generous deadline and is NOT health-checked
# (reference: deployment_state.py replica startup vs health-check split —
# probing during init killed LLM replicas mid-compile).
REPLICA_INIT_TIMEOUT_S = 300.0
HEALTH_CHECK_FAILURE_THRESHOLD = 3

# -- controller checkpoint (GCS internal KV) ---------------------------------
#
# One envelope, write-through on every mutation (the _checkpoint helper —
# CONTRIBUTING: controller state mutations MUST route through it; a
# fixture test in tests/test_serve_controller_ft.py enforces the list).
# The envelope is schema-versioned so OLD checkpoints decode forward: the
# restore path reads every field with a default, and unknown future
# fields are ignored, so a rolling upgrade never bricks recovery.
CKPT_SCHEMA = "ray_tpu_torch.serve_controller_ckpt"
CKPT_VERSION = 1
CKPT_NAMESPACE = b"serve"
CKPT_KEY = b"controller_checkpoint"
# replica actor-name prefix: adoption resolves these as named actors
REPLICA_NAME_PREFIX = "SERVE_REPLICA:"


def proxy_shard_name(port: int, idx: int) -> str:
    """THE proxy-shard actor name (creation and adoption both resolve
    through this): format drift between the two would silently turn
    every recovery into a full proxy-fleet restart."""
    return f"SERVE_PROXY:{port}:{idx}"
# how far back a recovered controller replays node.preempt_notice events
# to rebuild _preempted_nodes (covers the longest drain window plus the
# cursor's own clock-skew slack)
PREEMPT_REPLAY_WINDOW_S = 45.0


def encode_checkpoint(state: Dict[str, Any]) -> bytes:
    # cloudpickle, not stdlib pickle: deployment configs legitimately
    # carry local closures (serve.llm app builders, user init args) that
    # stdlib pickle refuses
    import cloudpickle

    env = {"schema": CKPT_SCHEMA, "version": CKPT_VERSION}
    env.update(state)
    return cloudpickle.dumps(env, protocol=5)


def decode_checkpoint(blob: Optional[bytes]) -> Optional[Dict[str, Any]]:
    """Decode a checkpoint envelope; None for missing/foreign/torn blobs.
    Version gate is FORWARD-compatible: any version <= CKPT_VERSION
    decodes (fields read with defaults), a NEWER version is refused —
    an old controller must not half-apply state it doesn't understand."""
    if not blob:
        return None
    try:
        env = pickle.loads(blob)  # cloudpickle emits pickle-loadable blobs
    except Exception:  # noqa: BLE001 — torn/garbage blob: start fresh
        return None
    if not isinstance(env, dict) or env.get("schema") != CKPT_SCHEMA:
        return None
    if int(env.get("version", 0)) > CKPT_VERSION:
        logger.warning(
            "serve controller checkpoint is version %s (> understood %s); "
            "ignoring it", env.get("version"), CKPT_VERSION)
        return None
    return env


class _ReplicaState:
    STARTING = "STARTING"
    RUNNING = "RUNNING"
    DRAINING = "DRAINING"  # deregistered from routers, kill pending
    UNHEALTHY = "UNHEALTHY"

    def __init__(self, handle, replica_id: str, version: str = ""):
        self.handle = handle
        self.replica_id = replica_id
        self.version = version
        self.state = _ReplicaState.STARTING
        self.started_at = time.monotonic()
        self.drain_since = 0.0
        # a DRAINING replica is killed once idle (in-flight requests and
        # streams finished) or at this deadline, whichever comes first
        self.drain_deadline = 0.0
        # where the replica landed (filled on promotion to RUNNING) — the
        # preemption path drains replicas by node
        self.node_id: Optional[str] = None
        # check_health queued behind __init__: resolves iff init succeeded
        self.init_ref = None
        self.consecutive_failures = 0

    @property
    def healthy(self) -> bool:
        return self.state == _ReplicaState.RUNNING


class _DeploymentState:
    def __init__(self, app: str, name: str, config: Dict[str, Any]):
        self.app = app
        self.name = name
        self.config = config
        self.target_num_replicas = config.get("num_replicas", 1)
        self.replicas: List[_ReplicaState] = []
        self.next_replica_idx = 0
        self.last_health_check = 0.0
        self.autoscaling = config.get("autoscaling_config")
        if self.autoscaling:
            self.target_num_replicas = self.autoscaling.get(
                "initial_replicas", self.autoscaling.get("min_replicas", 1))

    @property
    def full_name(self) -> str:
        return f"{self.app}#{self.name}" if self.app else self.name


class ServeController:
    def __init__(self):
        self._deployments: Dict[str, _DeploymentState] = {}
        self._apps: Dict[str, Dict[str, Any]] = {}
        self._lock = threading.RLock()
        # long-poll state: per-deployment change versions + parked waiters
        self._versions: Dict[str, int] = {}
        self._change_cv = threading.Condition()
        # replica_id -> last reported num_ongoing_requests (piggybacked
        # to routers on long-poll replies) and the monotonic time its
        # probe was sent
        self._replica_metrics: Dict[str, int] = {}
        self._replica_metrics_at: Dict[str, float] = {}
        # HTTP proxy shards: the controller owns shard
        # lifecycle — spawn, health-check/restart, route pushes.
        # proxy shard index -> actor handle; config survives restarts
        self._proxy_shards: Dict[int, Any] = {}
        self._proxy_started_at: Dict[int, float] = {}
        self._proxy_config: Optional[Dict[str, Any]] = None
        # shard indexes mid-rolling-restart: _check_proxies' missing-shard
        # sweep must not respawn these — between the roll's pop and kill,
        # get_if_exists would re-adopt the OLD still-named actor, the roll
        # would then kill the "fresh" handle, and its ready() barrier
        # would probe a corpse while the next shard goes down too
        self._proxy_rolling: set = set()
        # node_id -> monotonic drain expiry for nodes under an active
        # preemption notice: a replica that finishes STARTING on one of
        # these after the notice sweep must drain immediately, not serve
        # until the raylet's hard deadline kills it mid-request
        self._preempted_nodes: Dict[str, float] = {}
        self._shutdown = threading.Event()
        # -- crash tolerance --------------------------------------------
        # monotonic across controller incarnations: stamped on every
        # long-poll reply and route push so routers/shards reject a
        # zombie's stale pushes after a recovery
        self._incarnation = 1
        self._ckpt_lock = threading.Lock()
        self._ckpt_seq = 0          # snapshot counter (under self._lock)
        self._ckpt_written_seq = 0  # newest seq persisted (ckpt lock)
        self._ckpt_count = 0
        self._last_checkpoint_at = 0.0
        self._recovered_at = 0.0
        self._adopted_replicas = 0
        self._restarted_replicas = 0
        self._adopted_proxies = 0
        preempt_since: Optional[float] = None
        ckpt = self._load_checkpoint()
        if ckpt is not None:
            self._restore(ckpt)
            # a death mid-preemption must not leak a draining replica:
            # replay recent notices so _preempted_nodes (and the by-node
            # drains) rebuild from the event log, with the REMAINING
            # window computed from each notice's emit time
            preempt_since = time.time() - PREEMPT_REPLAY_WINDOW_S
        # node.preempt_notice watcher (shared event-log poll protocol)
        self._preempt_cursor = EventCursor("node.preempt_notice",
                                           since=preempt_since)
        # the reconcile thread starts only after adoption settled, so it
        # cannot race recovery into starting replacement replicas
        self._reconcile_thread = threading.Thread(
            target=self._run_control_loop, name="serve-controller",
            daemon=True)
        self._reconcile_thread.start()

    # -- checkpoint / recovery ----------------------------------------------

    def _load_checkpoint(self) -> Optional[Dict[str, Any]]:
        from ray_tpu_torch.experimental.internal_kv import internal_kv_get

        try:
            blob = internal_kv_get(CKPT_KEY, namespace=CKPT_NAMESPACE)
        except Exception:  # noqa: BLE001 — KV unreachable: start fresh
            logger.exception("serve controller checkpoint load failed")
            return None
        return decode_checkpoint(blob)

    def _checkpoint(self, reason: str) -> None:
        """THE write-through helper: serialize the reconcile-relevant
        state and persist it in the GCS internal KV (append-log backed).
        Called on every mutation — deploy/delete/scale/roll/replica
        start-stop/shard change — never on a timer, so the checkpoint is
        at most one mutation behind the live state. Per-snapshot seq +
        a write lock keep concurrent writers from persisting an older
        snapshot over a newer one. Failures are logged, never raised:
        losing one checkpoint write degrades recovery, not serving."""
        from ray_tpu_torch.experimental.internal_kv import internal_kv_put

        if self._shutdown.is_set():
            return
        with self._lock:
            self._ckpt_seq += 1
            seq = self._ckpt_seq
            blob = encode_checkpoint(self._snapshot_state())
        try:
            with self._ckpt_lock:
                if seq <= self._ckpt_written_seq:
                    return  # a newer snapshot already landed
                if self._shutdown.is_set():
                    # shutdown deletes the checkpoint; a write racing
                    # past the entry check must not resurrect it (the
                    # delete happens-after the shutdown flag is set, so
                    # this re-check under the write lock is sufficient)
                    return
                internal_kv_put(CKPT_KEY, blob, namespace=CKPT_NAMESPACE)
                self._ckpt_written_seq = seq
                self._ckpt_count += 1
                self._last_checkpoint_at = time.time()
        except Exception:  # noqa: BLE001 — must not break the control loop
            logger.exception("serve controller checkpoint write failed "
                             "(reason=%s)", reason)
            return
        event_log.emit("serve.controller_checkpoint",
                       incarnation=self._incarnation, reason=reason,
                       bytes=len(blob))

    def _snapshot_state(self) -> Dict[str, Any]:
        """Reconcile-relevant state only (caller holds self._lock).
        Replica HANDLES are never serialized — adoption re-resolves each
        replica's named actor (REPLICA_NAME_PREFIX + replica_id)."""
        deployments = {}
        for key, s in self._deployments.items():
            deployments[key] = {
                "app": s.app,
                "name": s.name,
                "config": s.config,
                "target_num_replicas": s.target_num_replicas,
                "next_replica_idx": s.next_replica_idx,
                "replicas": [
                    {"replica_id": r.replica_id, "version": r.version,
                     "state": r.state, "node_id": r.node_id}
                    for r in s.replicas
                    if r.state in (_ReplicaState.STARTING,
                                   _ReplicaState.RUNNING,
                                   _ReplicaState.DRAINING)],
            }
        return {
            "incarnation": self._incarnation,
            "saved_at": time.time(),
            "seq": self._ckpt_seq,
            "apps": dict(self._apps),
            "deployments": deployments,
            "versions": dict(self._versions),
            "proxy": {"config": (dict(self._proxy_config)
                                 if self._proxy_config else None),
                      "shards": sorted(self._proxy_shards)},
        }

    def _restore(self, ckpt: Dict[str, Any]) -> None:
        """Recovery with ADOPTION: rebuild target state from the
        checkpoint, then resolve each recorded replica / proxy shard as a
        named actor and health-check it. Healthy replicas are adopted
        as-is (same actor, same PID — never restarted); missing or
        unhealthy ones are dropped here and reconciled normally by the
        control loop. Every field reads with a default so an OLD envelope
        (earlier schema version) decodes forward."""
        self._incarnation = int(ckpt.get("incarnation", 0) or 0) + 1
        self._apps = dict(ckpt.get("apps") or {})
        self._versions = dict(ckpt.get("versions") or {})
        adopted, lost = 0, 0
        for key, rec in (ckpt.get("deployments") or {}).items():
            state = _DeploymentState(rec.get("app", ""),
                                     rec.get("name", ""),
                                     rec.get("config") or {})
            state.target_num_replicas = int(
                rec.get("target_num_replicas",
                        state.target_num_replicas))
            state.next_replica_idx = int(rec.get("next_replica_idx", 0))
            self._deployments[key] = state
            a, l = self._adopt_replicas(state, rec.get("replicas") or [])
            adopted += a
            lost += l
        self._adopted_replicas = adopted
        self._restarted_replicas = lost
        self._reap_orphan_replicas(ckpt)
        self._restore_proxies(ckpt.get("proxy") or {})
        # wake every parked/reconnecting router with a fresh snapshot;
        # versions continue monotonically from the checkpoint, so a
        # router's last_version stays meaningful across the recovery
        for key in list(self._deployments):
            self._bump(key)
        self._recovered_at = time.time()
        event_log.emit("serve.controller_recover",
                       incarnation=self._incarnation,
                       adopted_replicas=adopted,
                       restarted_replicas=lost,
                       adopted_proxies=self._adopted_proxies)
        logger.warning(
            "serve controller recovered (incarnation %d): adopted %d "
            "replica(s) + %d proxy shard(s), %d lost to reconcile",
            self._incarnation, adopted, self._adopted_proxies, lost)
        # recovery is itself a mutation of record: persist the bumped
        # incarnation immediately so a crash loop cannot reuse one
        self._checkpoint("recover")

    def _adopt_replicas(self, state: _DeploymentState,
                        records: List[Dict[str, Any]]) -> tuple:
        """Resolve + health-check one deployment's checkpointed replicas.
        Fan out the probes, harvest with one bounded wait (recovery must
        not serialize on a wedged replica). Returns (adopted, lost).

        STARTING records are special: their check_health is queued behind
        a possibly-minutes-long user __init__ (REPLICA_INIT_TIMEOUT_S is
        300s for a reason), so probing them on the adoption clock would
        kill every mid-compile LLM replica a controller crash overlaps.
        They re-adopt as STARTING with a fresh init deadline and the
        usual init_ref; _check_starting promotes or times them out.

        The probe is a LIVENESS gate, not a health verdict: only a
        provably dead actor is dropped here. A probe that times out
        (replica saturated with long streams — its mailbox is
        max_ongoing deep) or raises a user health-check error adopts
        the replica with ONE strike and lets the steady-state health
        loop apply its usual 3-consecutive-failures rule — adoption
        must never be stricter than the health checking it resumes."""
        probes = []
        adopted, lost = 0, 0
        for rec in records:
            rid = rec.get("replica_id", "")
            try:
                handle = ray_tpu_torch.get_actor(REPLICA_NAME_PREFIX + rid)
                if rec.get("state") == _ReplicaState.STARTING:
                    r = _ReplicaState(handle, rid,
                                      version=rec.get("version", ""))
                    r.node_id = rec.get("node_id")
                    r.init_ref = handle.check_health.remote()
                    state.replicas.append(r)
                    adopted += 1
                    event_log.emit("serve.replica_adopted",
                                   replica_id=rid,
                                   incarnation=self._incarnation,
                                   deployment=state.full_name,
                                   state=r.state)
                    continue
                probes.append((rec, handle,
                               handle.check_health.remote()))
            except Exception:  # noqa: BLE001 — dead at resolve OR at
                # first-contact submit (DEAD actors raise synchronously
                # from .remote()): reconcile a replacement
                probes.append((rec, None, None))
        refs = [ref for _, _, ref in probes if ref is not None]
        done_set = set()
        if refs:
            try:
                done, _ = ray_tpu_torch.wait(refs, num_returns=len(refs),
                                       timeout=10.0)
                done_set = set(done)
            except Exception:  # noqa: BLE001
                pass
        for rec, handle, ref in probes:
            dead = ref is None
            strikes = 0
            if not dead and ref in done_set:
                try:
                    ray_tpu_torch.get(ref, timeout=0.5)
                except ray_tpu_torch.exceptions.RayActorError:
                    dead = True
                except Exception:  # noqa: BLE001 — live actor, failing
                    # user check: one strike, the health loop decides
                    strikes = 1
            elif not dead:
                # probe timed out: busy (long streams queue ahead of
                # it), not dead — one strike, never a one-shot kill
                strikes = 1
            if dead:
                lost += 1
                logger.warning("replica %s not adoptable; will reconcile",
                               rec.get("replica_id"))
                continue
            r = _ReplicaState(handle, rec.get("replica_id", ""),
                              version=rec.get("version", ""))
            r.consecutive_failures = strikes
            if rec.get("state") == _ReplicaState.DRAINING:
                # resume the drain (deadline re-capped; a preempt-notice
                # replay may tighten it to the remaining notice window)
                r.state = _ReplicaState.DRAINING
                r.drain_since = time.monotonic()
                r.drain_deadline = r.drain_since + self.DRAIN_DEADLINE_S
            else:
                r.state = _ReplicaState.RUNNING
            r.node_id = rec.get("node_id")
            state.replicas.append(r)
            adopted += 1
            event_log.emit("serve.replica_adopted",
                           replica_id=r.replica_id,
                           incarnation=self._incarnation,
                           deployment=state.full_name, state=r.state)
        return adopted, lost

    def _reap_orphan_replicas(self, ckpt: Dict[str, Any]) -> None:
        """Kill SERVE_REPLICA-named actors the checkpoint does not know:
        a crash between actor creation and the id-reserving checkpoint
        write leaves a live, unrecorded replica — unsupervised, holding
        its name and resources forever if nothing reaps it."""
        from ray_tpu_torch._raylet import get_core_worker

        known = {REPLICA_NAME_PREFIX + r.get("replica_id", "")
                 for rec in (ckpt.get("deployments") or {}).values()
                 for r in rec.get("replicas") or []}
        try:
            named = get_core_worker()._gcs.call(
                "list_named_actors", {"namespace": ""}, timeout=10.0)
        except Exception:  # noqa: BLE001 — listing is best-effort
            logger.debug("orphan replica sweep: listing failed",
                         exc_info=True)
            return
        for entry in named or []:
            name = entry.get("name", "")
            if not name.startswith(REPLICA_NAME_PREFIX) or name in known:
                continue
            logger.warning("reaping orphan replica actor %s "
                           "(not in the recovered checkpoint)", name)
            try:
                ray_tpu_torch.kill(ray_tpu_torch.get_actor(name))
            except Exception:  # noqa: BLE001 — already gone
                pass

    def _restore_proxies(self, rec: Dict[str, Any]) -> None:
        """Adopt live proxy shards by name; missing ones are respawned by
        _check_proxies' missing-shard sweep on the first health tick."""
        cfg = rec.get("config")
        if not cfg:
            return
        self._proxy_config = dict(cfg)
        now = time.monotonic()
        for idx in rec.get("shards") or []:
            try:
                shard = ray_tpu_torch.get_actor(proxy_shard_name(cfg["port"],
                                                           idx))
            except Exception:  # noqa: BLE001 — sweep respawns it
                logger.warning("proxy shard %s not adoptable; will respawn",
                               idx)
                continue
            self._proxy_shards[idx] = shard
            self._proxy_started_at[idx] = now
            self._adopted_proxies += 1
        # re-push routes with the bumped incarnation so shards drop any
        # stale push a zombie incarnation might still have in flight —
        # fire-and-forget, NO harvest: the shard's update_routes pulls
        # list_applications back from THIS actor, which cannot serve the
        # call until __init__ returns, so waiting here (as
        # update_proxy_routes does) would deterministically burn its
        # full timeout into every recovery's MTTR
        for shard in self._proxy_shards.values():
            try:
                shard.update_routes.remote(incarnation=self._incarnation)
            except Exception:  # noqa: BLE001 — dead shard: sweep respawns
                pass

    def get_recovery_info(self) -> Dict[str, Any]:
        """Control-plane FT observability (the CLI's status, dashboard,
        drills): incarnation, checkpoint freshness, adoption counts."""
        now = time.time()
        with self._lock:
            return {
                "incarnation": self._incarnation,
                "recovered_at": self._recovered_at or None,
                "adopted_replicas": self._adopted_replicas,
                "restarted_replicas": self._restarted_replicas,
                "adopted_proxies": self._adopted_proxies,
                "checkpoints_written": self._ckpt_count,
                "last_checkpoint_at": self._last_checkpoint_at or None,
                "last_checkpoint_age_s": (
                    round(now - self._last_checkpoint_at, 3)
                    if self._last_checkpoint_at else None),
            }

    # -- API called by serve.run / handles ----------------------------------

    def deploy_application(self, app_name: str,
                           deployments: List[Dict[str, Any]],
                           ingress: str, route_prefix: str,
                           ingress_flags: Optional[Dict[str, Any]] = None,
                           ) -> None:
        with self._lock:
            self._apps[app_name] = {
                "ingress": ingress,
                "route_prefix": route_prefix,
                "deployments": [d["name"] for d in deployments],
                # proxy behavior switches: {"asgi": bool, "streaming": bool}
                "ingress_flags": ingress_flags or {},
            }
            for cfg in deployments:
                key = f"{app_name}#{cfg['name']}"
                existing = self._deployments.get(key)
                if existing is not None:
                    same_version = (existing.config.get("version")
                                    == cfg.get("version"))
                    user_cfg_changed = (existing.config.get("user_config")
                                        != cfg.get("user_config"))
                    existing.config = cfg
                    if not existing.autoscaling:
                        existing.target_num_replicas = cfg.get(
                            "num_replicas", 1)
                    existing.autoscaling = cfg.get("autoscaling_config")
                    if (same_version and user_cfg_changed
                            and cfg.get("user_config") is not None):
                        # same code, new user_config: reconfigure the
                        # live replicas in place (reference semantics —
                        # only a code/option change rolls replicas)
                        for r in existing.replicas:
                            try:
                                r.handle.reconfigure.remote(
                                    cfg["user_config"])
                            except Exception:  # noqa: BLE001
                                pass
                    # a version change needs no action here: _reconcile
                    # rolls outdated replicas one at a time
                else:
                    self._deployments[key] = _DeploymentState(
                        app_name, cfg["name"], cfg)
        # persist BEFORE the ready wait: a crash while replicas start
        # must recover the deploy, not forget it
        self._checkpoint("deploy")
        self._wait_for_ready(app_name)
        self.update_proxy_routes()

    def _wait_for_ready(self, app_name: str,
                        timeout: float = REPLICA_INIT_TIMEOUT_S) -> None:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._lock:
                states = [d for d in self._deployments.values()
                          if d.app == app_name]
                if states and all(
                        len([r for r in d.replicas if r.healthy])
                        >= min(1, d.target_num_replicas)
                        for d in states):
                    return
            time.sleep(0.1)
        raise TimeoutError(f"application {app_name!r} failed to become ready")

    def delete_application(self, app_name: str) -> None:
        with self._lock:
            app = self._apps.pop(app_name, None)
            if not app:
                return
            for dep in app["deployments"]:
                state = self._deployments.pop(f"{app_name}#{dep}", None)
                if state:
                    for r in state.replicas:
                        self._stop_replica(r)
                    self._bump(state.full_name)
        self._checkpoint("delete")
        self.update_proxy_routes()

    def _bump(self, key: str) -> None:
        """Mark `key`'s replica set changed; wakes parked long-polls."""
        with self._change_cv:
            self._versions[key] = self._versions.get(key, 0) + 1
            self._change_cv.notify_all()

    def listen_for_change(self, key: str, last_version: int,
                          timeout: float = 30.0) -> Dict[str, Any]:
        """Long-poll endpoint: parks until the deployment's replica set
        changes from `last_version` (or timeout), then returns the fresh
        snapshot. key = "<app>#<deployment>"."""
        deadline = time.monotonic() + timeout
        with self._change_cv:
            while (self._versions.get(key, 0) == last_version
                   and not self._shutdown.is_set()):
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._change_cv.wait(remaining)
            version = self._versions.get(key, 0)
        with self._lock:
            state = self._deployments.get(key)
            replicas = ([(r.replica_id, r.handle)
                         for r in state.replicas if r.healthy]
                        if state is not None else [])
            metrics = {rid: self._replica_metrics.get(rid, 0)
                       for rid, _ in replicas}
            now = time.monotonic()
            metrics_age_s = {rid: now - self._replica_metrics_at[rid]
                             for rid, _ in replicas
                             if rid in self._replica_metrics_at}
            incarnation = self._incarnation
        # incarnation rides every reply: routers reject pushes from an
        # older incarnation (zombie controller) after a recovery;
        # metrics_age_s says how old each replica's count is, so a router
        # can take out its own requests of that moment
        return {"version": version, "replicas": replicas,
                "metrics": metrics, "metrics_age_s": metrics_age_s,
                "incarnation": incarnation}

    def list_replica_nodes(self) -> Dict[str, str]:
        """replica_id -> node_id attribution for every live replica
        (preemption drills pick victims from this; empty node ids are
        replicas still starting)."""
        with self._lock:
            return {r.replica_id: r.node_id or ""
                    for s in self._deployments.values()
                    for r in s.replicas
                    if r.state in (_ReplicaState.STARTING,
                                   _ReplicaState.RUNNING)}

    def get_replica_handles(self, app_name: str,
                            deployment_name: str) -> List[Any]:
        with self._lock:
            state = self._deployments.get(f"{app_name}#{deployment_name}")
            if state is None:
                return []
            return [r.handle for r in state.replicas if r.healthy]

    def get_app_info(self, app_name: str) -> Optional[Dict[str, Any]]:
        with self._lock:
            return self._apps.get(app_name)

    def list_applications(self) -> Dict[str, Dict[str, Any]]:
        with self._lock:
            return dict(self._apps)

    def get_deployment_status(self, app_name: str,
                              deployment_name: str) -> Dict[str, Any]:
        with self._lock:
            state = self._deployments.get(f"{app_name}#{deployment_name}")
            if state is None:
                return {"status": "NOT_FOUND"}
            healthy = sum(1 for r in state.replicas if r.healthy)
            return {
                "status": "HEALTHY" if healthy >= state.target_num_replicas
                else "UPDATING",
                "replicas": healthy,
                "target_replicas": state.target_num_replicas,
            }

    def shutdown(self) -> None:
        # serve-ckpt: exempt — intentional teardown DELETES the
        # checkpoint: the next controller must start fresh, not adopt
        # replicas this shutdown is about to kill
        from ray_tpu_torch.experimental.internal_kv import internal_kv_del

        self._shutdown.set()
        try:
            # under _ckpt_lock: a writer already inside the lock finishes
            # its put BEFORE this delete; any writer arriving after will
            # re-check the (already set) shutdown flag under the same
            # lock and skip — no write can land after the delete
            with self._ckpt_lock:
                internal_kv_del(CKPT_KEY, namespace=CKPT_NAMESPACE)
        except Exception:  # noqa: BLE001 — best-effort teardown
            logger.debug("checkpoint delete failed", exc_info=True)
        with self._change_cv:
            self._change_cv.notify_all()
        with self._lock:
            for state in self._deployments.values():
                for r in state.replicas:
                    self._stop_replica(r)
            self._deployments.clear()
            self._apps.clear()
            shards = list(self._proxy_shards.values())
            self._proxy_shards.clear()
            self._proxy_config = None
        for shard in shards:
            try:
                ray_tpu_torch.kill(shard)
            except Exception:  # noqa: BLE001 — best-effort teardown
                pass

    def ping(self) -> str:
        return "pong"

    # -- preemptible-node semantics ------------------------------------------

    def preempt_node(self, node_id: str,
                     deadline_s: Optional[float] = None) -> int:
        """Advance notice of node loss: deregister-then-drain every
        replica on the node. Routers stop routing to them in one
        long-poll latency, in-flight requests/streams finish inside the
        notice window (_reap_draining kills on idle or deadline), and the
        reconcile loop starts replacements — which the scheduler places
        off the draining node. Returns the number of replicas drained."""
        # serve-ckpt: exempt — _preempted_nodes rebuilds from the event
        # log on recovery (node.preempt_notice replay); the per-replica
        # DRAINING flips below checkpoint via _drain_replica
        n = 0
        with self._lock:
            states = list(self._deployments.values())
            # remember the notice for replicas still STARTING (node_id
            # unknown until promotion): _check_starting drains them the
            # moment their attribution lands on this node
            self._preempted_nodes[node_id] = time.monotonic() + (
                deadline_s if deadline_s is not None
                else self.DRAIN_DEADLINE_S)
        for state in states:
            with self._lock:
                targets = [
                    r for r in state.replicas
                    if r.node_id == node_id
                    and r.state in (_ReplicaState.STARTING,
                                    _ReplicaState.RUNNING)]
            for r in targets:
                self._drain_replica(state, r, deadline_s=deadline_s)
                n += 1
        if n:
            logger.warning(
                "preempt notice for node %s: drained %d replica(s)",
                node_id[:12], n)
        return n

    def _check_preempt_notices(self) -> None:
        """Watch the cluster event log for node.preempt_notice (the GCS
        advance-notice path) so serve reacts to announced node loss
        without any operator wiring. Runs on the control thread at the
        health-check cadence; each notice is handled once (EventCursor
        holds the dedup/anchor protocol)."""
        # prune expiries for nodes that never saw a late attribution —
        # preempted nodes leave the cluster, so nothing else removes
        # them (under the lock: preempt_node inserts from RPC threads)
        now = time.monotonic()
        with self._lock:
            for nid in [n for n, exp in self._preempted_nodes.items()
                        if now >= exp]:
                self._preempted_nodes.pop(nid, None)
        for ev in self._preempt_cursor.poll(limit=100):
            if not ev.get("node_id"):
                continue
            deadline = float((ev.get("data") or {}).get("deadline_s",
                                                        self.DRAIN_DEADLINE_S))
            # The raylet armed its hard kill at EMIT time; drain with
            # what's left of the window at poll time, minus a skew margin
            # (emit time is the raylet host's wall clock) — draining a
            # little early is safe, a replica still streaming when the
            # raylet's deadline fires is not.
            elapsed = max(0.0, time.time() - float(ev.get("time")
                                                   or time.time()))
            remaining = deadline - elapsed - self.PREEMPT_SKEW_MARGIN_S
            self.preempt_node(ev["node_id"],
                              deadline_s=max(0.0, remaining))

    # -- HTTP proxy shard lifecycle ------------------------------------------

    def ensure_http_proxies(self, host: str = "127.0.0.1", port: int = 8000,
                            num_shards: Optional[int] = None) -> int:
        """Start (or adopt) the HTTP ingress: `num_shards` proxy shard
        actors sharing one listen port via SO_REUSEPORT. Idempotent; a
        later call can only grow the shard count (shrinking would strand
        kernel-balanced connections). Returns the live shard count."""
        from ray_tpu_torch.serve._private.proxy import default_num_shards

        with self._lock:
            if self._proxy_config is not None:
                host = self._proxy_config["host"]
                port = self._proxy_config["port"]
                num_shards = max(num_shards or 0,
                                 self._proxy_config["num_shards"])
            elif num_shards is None:
                num_shards = default_num_shards()
            num_shards = max(1, num_shards)
            self._proxy_config = {"host": host, "port": port,
                                  "num_shards": num_shards}
        self._checkpoint("proxy_config")
        for idx in range(num_shards):
            self._start_proxy_shard(idx)
        # bind failures surface here, not on the first request
        for idx, shard in sorted(self._proxy_shards.items()):
            ray_tpu_torch.get(shard.ready.remote(), timeout=30)
        return len(self._proxy_shards)

    def _start_proxy_shard(self, idx: int) -> None:
        from ray_tpu_torch.serve._private.proxy import ProxyActor

        cfg = self._proxy_config
        if cfg is None:
            return
        with self._lock:
            if idx in self._proxy_shards:
                return
        try:
            shard = ray_tpu_torch.remote(ProxyActor).options(
                name=proxy_shard_name(cfg["port"], idx),
                lifetime="detached", num_cpus=0.1,
                get_if_exists=True, max_concurrency=256,
            ).remote(host=cfg["host"], port=cfg["port"], shard_index=idx,
                     num_shards=cfg["num_shards"])
        except Exception:  # noqa: BLE001 — retried by _check_proxies
            logger.exception("failed to start proxy shard %d", idx)
            return
        with self._lock:
            self._proxy_shards[idx] = shard
            self._proxy_started_at[idx] = time.monotonic()
        self._checkpoint("proxy_shard")

    def get_http_proxy_handles(self) -> Dict[int, Any]:
        with self._lock:
            return dict(self._proxy_shards)

    def update_proxy_routes(self) -> None:
        """Push the current route table to every shard (deploys/deletes).
        Fan-out then harvest: a dead shard must not stall the rest (it
        gets fresh routes when _check_proxies restarts it)."""
        with self._lock:
            shards = list(self._proxy_shards.values())
            incarnation = self._incarnation
        refs = []
        for shard in shards:
            try:
                # incarnation-stamped: a shard ignores pushes older than
                # the newest incarnation it has seen (zombie rejection)
                refs.append(shard.update_routes.remote(
                    incarnation=incarnation))
            except Exception:  # noqa: BLE001 — dead shard, restarted later
                pass
        if refs:
            try:
                ray_tpu_torch.wait(refs, num_returns=len(refs), timeout=10.0)
            except Exception:  # noqa: BLE001
                pass

    def rolling_restart_proxies(self) -> int:
        """Restart every HTTP proxy shard ONE at a time (config rollout /
        resilience drill scenario): kill shard i, start its replacement,
        wait until it binds and pulls routes, then move to the next. The
        shared SO_REUSEPORT listen set keeps the other N-1 shards
        accepting throughout, so ingress availability never drops to
        zero. Returns the number of shards restarted."""
        with self._lock:
            idxs = sorted(self._proxy_shards)
        for idx in idxs:
            fresh = self._respawn_shard(idx)
            if fresh is None:
                continue  # _check_proxies retries the spawn next tick
            try:
                # barrier: the replacement must be serving before the
                # next shard goes down, or a 2-shard roll would briefly
                # drop the whole listen set
                ray_tpu_torch.get(fresh.ready.remote(), timeout=60)
            except Exception:  # noqa: BLE001 — health loop will retry it
                logger.warning("proxy shard %d slow to return after "
                               "rolling restart", idx)
        return len(idxs)

    def _respawn_shard(self, idx: int, missing_only: bool = False,
                       expected=None):
        """The one respawn stanza (missing-shard sweep, unhealthy
        restart, rolling restart all use it): mark the slot mid-respawn
        so _check_proxies' missing sweep cannot re-adopt the OLD
        still-named actor between pop and kill, kill whatever held the
        slot, start the replacement, push it routes. Returns the fresh
        handle, or None when the spawn failed (the health loop retries
        next tick).

        `missing_only` / `expected` re-check the slot ATOMICALLY with
        claiming it: the sweep's missing-list and health-probe snapshots
        race the rolling restart, and acting on a stale snapshot would
        kill the replacement the roll just started (its ready() barrier
        then probes a corpse while the next shard goes down — a full
        listen-set outage on 2 shards). `expected` claims the slot only
        while it still holds the exact handle whose probe failed."""
        with self._lock:
            if missing_only and (idx in self._proxy_shards
                                 or idx in self._proxy_rolling):
                return self._proxy_shards.get(idx)
            if expected is not None and (
                    self._proxy_shards.get(idx) is not expected):
                return self._proxy_shards.get(idx)
            self._proxy_rolling.add(idx)
            shard = self._proxy_shards.pop(idx, None)
        try:
            if shard is not None:
                try:
                    ray_tpu_torch.kill(shard)
                except Exception:  # noqa: BLE001 — already dead
                    pass
            self._start_proxy_shard(idx)
        finally:
            with self._lock:
                self._proxy_rolling.discard(idx)
        with self._lock:
            fresh = self._proxy_shards.get(idx)
        if fresh is not None:
            try:
                fresh.update_routes.remote(incarnation=self._incarnation)
            except Exception:  # noqa: BLE001 — dead already; health loop
                pass
        return fresh

    def _check_proxies(self) -> None:
        """Health-check shards; restart dead ones (control loop). Young
        shards get an init grace period — their ping is queued behind a
        cold __init__ (imports + route pull), and killing them for that
        would churn startup forever."""
        now = time.monotonic()
        with self._lock:
            cfg = self._proxy_config
            missing = ([i for i in range(cfg["num_shards"])
                        if i not in self._proxy_shards
                        and i not in self._proxy_rolling] if cfg else [])
        # a shard whose spawn failed outright (rolling restart or a prior
        # unhealthy-restart) has no entry to health-check — without this
        # sweep the listen set would silently stay at N-1 forever
        for idx in missing:
            logger.warning("proxy shard %d missing; respawning", idx)
            self._respawn_shard(idx, missing_only=True)
        with self._lock:
            shards = [(i, s) for i, s in self._proxy_shards.items()
                      if now - self._proxy_started_at.get(i, 0.0) > 20.0]
        if not shards:
            return
        probes = []
        for idx, shard in shards:
            try:
                probes.append((idx, shard, shard.ping.remote()))
            except Exception:  # noqa: BLE001 — already dead
                probes.append((idx, shard, None))
        refs = [r for _, _, r in probes if r is not None]
        done_set = set()
        if refs:
            try:
                done, _ = ray_tpu_torch.wait(refs, num_returns=len(refs),
                                       timeout=5.0)
                done_set = set(done)
            except Exception:  # noqa: BLE001
                pass
        for idx, shard, ref in probes:
            ok = ref is not None and ref in done_set
            if ok:
                try:
                    ok = bool(ray_tpu_torch.get(ref, timeout=0.1))
                except Exception:  # noqa: BLE001 — shard crashed
                    ok = False
            if ok:
                continue
            logger.warning("proxy shard %d unhealthy; restarting", idx)
            self._respawn_shard(idx, expected=shard)

    # -- reconcile loop ------------------------------------------------------

    def _run_control_loop(self) -> None:
        last_health = 0.0
        while not self._shutdown.is_set():
            try:
                self._reconcile()
                now = time.monotonic()
                self._health_check()  # self-gated per deployment period
                if now - last_health > HEALTH_CHECK_INTERVAL_S:
                    self._autoscale()
                    self._check_proxies()
                    self._check_preempt_notices()
                    last_health = now
            except Exception:  # noqa: BLE001 — loop must survive
                logger.exception("reconcile error")
            self._shutdown.wait(RECONCILE_INTERVAL_S)

    def _check_starting(self, state: _DeploymentState) -> None:
        """Promote STARTING replicas whose constructor finished; fail the
        ones whose init raised or overran REPLICA_INIT_TIMEOUT_S."""
        with self._lock:
            starting = [r for r in state.replicas
                        if r.state == _ReplicaState.STARTING]
        promoted = []
        for r in starting:
            try:
                done, _ = ray_tpu_torch.wait([r.init_ref], timeout=0)
            except Exception:  # noqa: BLE001 — owner died etc.
                done = [r.init_ref]
            if done:
                try:
                    ray_tpu_torch.get(r.init_ref, timeout=1.0)
                    r.state = _ReplicaState.RUNNING
                    promoted.append(r)
                    self._bump(state.full_name)
                except Exception:  # noqa: BLE001 — init raised
                    logger.warning("replica %s failed to initialize",
                                   r.replica_id)
                    r.state = _ReplicaState.UNHEALTHY
            elif time.monotonic() - r.started_at > REPLICA_INIT_TIMEOUT_S:
                logger.warning("replica %s init timed out", r.replica_id)
                r.state = _ReplicaState.UNHEALTHY
        if promoted:
            self._checkpoint("promote")
            self._attribute_node_ids(state, promoted)

    def _attribute_node_ids(self, state: _DeploymentState,
                            replicas: list) -> None:
        """Node attribution for preemption drains: fan out one
        get_node_id RPC per replica with a single bounded wait for the
        whole sweep — a wedged replica must cost the control loop 5s
        once, not 5s serially per replica (health checks, drain reaping
        and preempt-notice polling all share this thread). Replicas the
        sweep misses stay node_id=None and are retried from _reconcile:
        an unattributed replica is invisible to preempt_node's by-node
        drain and would serve straight into the raylet's deadline kill.
        A replica that resolves onto a node under an active preemption
        notice drains immediately with whatever window remains."""
        node_refs = []
        for r in replicas:
            try:
                node_refs.append((r, r.handle.get_node_id.remote()))
            except Exception:  # noqa: BLE001 — attribution only
                r.node_id = None
        if node_refs:
            try:
                ray_tpu_torch.wait([ref for _, ref in node_refs],
                             num_returns=len(node_refs), timeout=5.0)
            except Exception:  # noqa: BLE001 — attribution only
                pass
            attributed = 0
            for r, ref in node_refs:
                try:
                    r.node_id = ray_tpu_torch.get(ref, timeout=0)
                    attributed += r.node_id is not None
                except Exception:  # noqa: BLE001 — attribution only
                    r.node_id = None
            if attributed:
                # persisted so a recovered controller can drain adopted
                # replicas by node without re-probing first
                self._checkpoint("attribute")
        for r in replicas:
            # lock the expiry lookup (preempt_node mutates the dict from
            # RPC threads); _drain_replica runs outside the lock
            with self._lock:
                expiry = self._preempted_nodes.get(r.node_id or "")
                if expiry is not None and time.monotonic() >= expiry:
                    self._preempted_nodes.pop(r.node_id or "", None)
                    expiry = None
            if expiry is not None:
                self._drain_replica(state, r,
                                    deadline_s=expiry - time.monotonic())

    def _reconcile(self) -> None:
        with self._lock:
            states = list(self._deployments.values())
        for state in states:
            self._check_starting(state)
            with self._lock:
                unattributed = [r for r in state.replicas
                                if r.state == _ReplicaState.RUNNING
                                and r.node_id is None]
            if unattributed:
                # promotion-time attribution missed these (slow RPC,
                # transient failure) — keep retrying at reconcile cadence
                self._attribute_node_ids(state, unattributed)
            self._reap_draining(state)
            with self._lock:
                alive = [r for r in state.replicas
                         if r.state in (_ReplicaState.STARTING,
                                        _ReplicaState.RUNNING)]
                want = state.target_num_replicas
                to_start = want - len(alive)
                dead = [r for r in state.replicas
                        if r.state == _ReplicaState.UNHEALTHY]
            for r in dead:
                self._stop_replica(r)
                with self._lock:
                    state.replicas.remove(r)
            if dead:
                self._bump(state.full_name)
                self._checkpoint("remove_dead")
            want_v = state.config.get("version", "")
            with self._lock:
                rolling = any(r.version != want_v for r in state.replicas
                              if r.state in (_ReplicaState.STARTING,
                                             _ReplicaState.RUNNING))
            if rolling:
                # version change in progress: the roll manages the count
                # (incl. its +1 surge and any simultaneous scale-down) —
                # neither the start loop nor the trim below may fight it
                self._roll_outdated(state)
                continue
            for _ in range(max(0, to_start)):
                self._start_replica(state)
            if to_start < 0:
                with self._lock:
                    # prefer stopping still-starting replicas: nothing is
                    # routed to them yet
                    ranked = sorted(
                        (r for r in state.replicas
                         if r.state in (_ReplicaState.STARTING,
                                        _ReplicaState.RUNNING)),
                        key=lambda r: r.state == _ReplicaState.RUNNING)
                    excess = ranked[:-to_start]
                    for r in excess:
                        state.replicas.remove(r)
                for r in excess:
                    self._stop_replica(r)
                if excess:
                    self._bump(state.full_name)
                    self._checkpoint("scale_down")

    def _roll_outdated(self, state: _DeploymentState) -> None:
        """Rolling code update (reference: deployment_state.py versioned
        replica replacement): when the deployment's version changed, surge
        ONE new-version replica at a time and retire an outdated one only
        after a new-version replica is RUNNING — the replica set never
        dips below target, so updates are zero-downtime. Retirement
        drains first (deregister from routers, kill after a grace tick).
        A simultaneous count decrease retires outdated replicas directly
        down to the new target."""
        want_v = state.config.get("version", "")
        with self._lock:
            alive = [r for r in state.replicas
                     if r.state in (_ReplicaState.STARTING,
                                    _ReplicaState.RUNNING)]
            outdated = [r for r in alive if r.version != want_v]
            updated = [r for r in alive if r.version == want_v]
            want = state.target_num_replicas
            updated_running = [r for r in updated
                               if r.state == _ReplicaState.RUNNING]
        if not outdated:
            return
        if len(alive) > want:
            # excess capacity: above want+1 it's a count decrease riding
            # the roll (retire outdated freely); at exactly the surge
            # slot, retire only once a new-version replica is serving
            if len(alive) > want + 1 or updated_running or not updated:
                self._drain_replica(state, outdated[0])
            return
        if (len(updated) < want
                and not any(r.state == _ReplicaState.STARTING
                            for r in updated)):
            self._start_replica(state)  # the surge replica (new version)

    # routers assigned requests from the previous long-poll snapshot for
    # up to one RPC latency after a drain deregisters the replica; the
    # grace floor lets those land before the idle check can pass
    DRAIN_GRACE_S = 1.0
    DRAIN_DEADLINE_S = 30.0
    # budget for raylet-vs-controller wall-clock skew when computing the
    # remaining preempt-drain window from an event's emit time
    PREEMPT_SKEW_MARGIN_S = 2.0

    def _drain_replica(self, state: _DeploymentState,
                       replica: _ReplicaState,
                       deadline_s: Optional[float] = None) -> None:
        """Deregister-then-drain: the replica leaves the routers' set NOW
        (long-poll bump) but is killed only once its in-flight requests
        and streams finish (_reap_draining polls its ongoing count) or at
        the drain deadline — announced node loss must not truncate live
        token streams."""
        replica.state = _ReplicaState.DRAINING
        replica.drain_since = time.monotonic()
        replica.drain_deadline = replica.drain_since + (
            deadline_s if deadline_s is not None else self.DRAIN_DEADLINE_S)
        try:
            replica.handle.prepare_shutdown.remote()
        except Exception:  # noqa: BLE001
            pass
        self._bump(state.full_name)
        # DRAINING is persisted so a controller death mid-drain resumes
        # the reap instead of re-serving a deregistered replica
        self._checkpoint("drain")

    def _reap_draining(self, state: _DeploymentState) -> None:
        now = time.monotonic()
        with self._lock:
            draining = [r for r in state.replicas
                        if r.state == _ReplicaState.DRAINING
                        and now - r.drain_since > self.DRAIN_GRACE_S]
        if not draining:
            return
        # idle probe: fan out, harvest with one bounded wait (a wedged
        # draining replica must not stall the control loop)
        probes = []
        for r in draining:
            try:
                probes.append((r, r.handle.get_metrics.remote()))
            except Exception:  # noqa: BLE001 — already dead: reap now
                probes.append((r, None))
        refs = [ref for _, ref in probes if ref is not None]
        done_set = set()
        if refs:
            try:
                done, _ = ray_tpu_torch.wait(refs, num_returns=len(refs),
                                       timeout=1.0)
                done_set = set(done)
            except Exception:  # noqa: BLE001
                pass
        expired = []
        for r, ref in probes:
            ongoing = None
            if ref is not None and ref in done_set:
                try:
                    ongoing = int(ray_tpu_torch.get(ref, timeout=0.1)
                                  .get("num_ongoing_requests", 0))
                except Exception:  # noqa: BLE001 — replica died draining
                    ongoing = 0
            if ref is None or ongoing == 0 or now > r.drain_deadline:
                expired.append(r)
        with self._lock:
            for r in expired:
                if r in state.replicas:
                    state.replicas.remove(r)
        for r in expired:
            self._stop_replica(r)
        if expired:
            self._checkpoint("reap")

    def _start_replica(self, state: _DeploymentState) -> None:
        cfg = state.config
        replica_id = f"{state.full_name}#{state.next_replica_idx}"
        state.next_replica_idx += 1
        actor_opts = dict(cfg.get("ray_actor_options") or {})
        actor_opts.setdefault("num_cpus", 0.1)
        actor_opts["max_concurrency"] = cfg.get("max_ongoing_requests", 8)
        # NAMED so a recovered controller incarnation can re-resolve and
        # adopt the live actor (checkpoint stores only the replica id;
        # next_replica_idx is persisted, so ids never collide across
        # incarnations)
        actor_opts["name"] = REPLICA_NAME_PREFIX + replica_id
        # reserve the id BEFORE creating the named actor: a crash in the
        # create-then-persist window must not recover a checkpoint whose
        # next idx re-issues this name ("already taken" forever); the
        # unrecorded actor itself is reaped by _restore's orphan sweep
        self._checkpoint("reserve_replica_id")
        try:
            handle = ray_tpu_torch.remote(ReplicaActor).options(
                **actor_opts).remote({
                    "callable": cfg["callable"],
                    "init_args": cfg.get("init_args", ()),
                    "init_kwargs": cfg.get("init_kwargs", {}),
                    "deployment": state.name,
                    "app": state.app,
                    "replica_id": replica_id,
                })
            if cfg.get("user_config") is not None:
                handle.reconfigure.remote(cfg["user_config"])
            replica = _ReplicaState(handle, replica_id,
                                    version=cfg.get("version", ""))
            # queued behind __init__: resolves exactly when init completes
            replica.init_ref = handle.check_health.remote()
            with self._lock:
                state.replicas.append(replica)
            self._checkpoint("start_replica")
        except Exception:  # noqa: BLE001
            logger.exception("failed to start replica for %s",
                             state.full_name)

    def _stop_replica(self, replica: _ReplicaState) -> None:
        try:
            replica.handle.prepare_shutdown.remote()
            ray_tpu_torch.kill(replica.handle)
        except Exception:  # noqa: BLE001 — best-effort
            pass

    def _health_check(self) -> None:
        now = time.monotonic()
        with self._lock:
            # per-deployment period/timeout (reference: @serve.deployment
            # health_check_period_s / health_check_timeout_s)
            due = [s for s in self._deployments.values()
                   if now - s.last_health_check
                   >= s.config.get("health_check_period_s",
                                   HEALTH_CHECK_INTERVAL_S)]
            for s in due:
                s.last_health_check = now
            all_replicas = [(s, r) for s in due for r in s.replicas
                            if r.state == _ReplicaState.RUNNING]
        if not all_replicas:
            return
        # Fan out ALL probes, then harvest with ONE bounded wait (same
        # pattern as _autoscale): probing serially would let one wedged
        # replica stall the reconcile thread — and every other
        # deployment's checks — for its full timeout, every tick.
        probes = []
        for s, r in all_replicas:
            try:
                probes.append((s, r, r.handle.check_health.remote()))
            except Exception:  # noqa: BLE001 — actor already dead:
                probes.append((s, r, None))  # counts as a failed probe
        max_timeout = max(s.config.get("health_check_timeout_s", 5.0)
                          for s, _ in all_replicas)
        refs = [ref for _, _, ref in probes if ref is not None]
        done_set = set()
        if refs:
            try:
                done, _ = ray_tpu_torch.wait(refs, num_returns=len(refs),
                                       timeout=max_timeout)
                done_set = set(done)
            except Exception:  # noqa: BLE001
                pass
        for state, replica, ref in probes:
            ok = ref is not None and ref in done_set
            if ok:
                try:
                    ray_tpu_torch.get(ref, timeout=0.1)
                except Exception:  # noqa: BLE001 — user check raised
                    ok = False
            if ok:
                replica.consecutive_failures = 0
                continue
            replica.consecutive_failures += 1
            logger.warning(
                "replica %s failed health check (%d/%d)",
                replica.replica_id, replica.consecutive_failures,
                HEALTH_CHECK_FAILURE_THRESHOLD)
            if (replica.consecutive_failures
                    >= HEALTH_CHECK_FAILURE_THRESHOLD):
                replica.state = _ReplicaState.UNHEALTHY
                self._bump(state.full_name)

    def _autoscale(self) -> None:
        """Default policy (reference: serve/autoscaling_policy.py:12):
        target = ceil(total_load / target_ongoing_requests), clamped.
        Per-replica load = max(ongoing requests, `queue_depth` reported
        by the replica's callable via get_autoscaling_metrics) — an LLM
        engine's admission backlog is demand the request counter can
        undercount, but the two overlap (a queued streaming request IS
        an ongoing call parked on its first token), so max, not sum:
        summing would double-count every queued stream and persistently
        over-scale. The per-replica loads are also cached for the
        long-poll metrics piggyback (probe-free routing). Metric RPCs
        fan out and are harvested with ONE bounded wait so a single
        wedged replica cannot stall the control loop 2s at a time."""
        with self._lock:
            all_states = list(self._deployments.values())
            probed_at = time.monotonic()
            probes = [(s, r, r.handle.get_metrics.remote())
                      for s in all_states
                      for r in s.replicas if r.healthy]
        ongoing: Dict[str, int] = {}
        if probes:
            refs = [ref for _, _, ref in probes]
            try:
                done, _ = ray_tpu_torch.wait(refs, num_returns=len(refs),
                                       timeout=2.0)
            except Exception:  # noqa: BLE001
                done = []
            done_set = set(done)
            for _, r, ref in probes:
                if ref not in done_set:
                    continue
                try:
                    m = ray_tpu_torch.get(ref, timeout=0.1)
                    ongoing[r.replica_id] = max(
                        m["num_ongoing_requests"],
                        int(m.get("queue_depth", 0) or 0))
                except Exception:  # noqa: BLE001
                    pass
        live_ids = {r.replica_id for s in all_states for r in s.replicas}
        self._replica_metrics = {
            rid: n for rid, n in {**self._replica_metrics, **ongoing}.items()
            if rid in live_ids}  # prune churned replicas: no slow leak
        self._replica_metrics_at = {
            rid: t for rid, t in {**self._replica_metrics_at,
                                  **{rid: probed_at for rid in ongoing}}.items()
            if rid in live_ids}
        states = [s for s in all_states if s.autoscaling]
        for state in states:
            cfg = state.autoscaling
            total = sum(ongoing.get(r.replica_id, 0)
                        for r in list(state.replicas) if r.healthy)
            target_per = cfg.get("target_ongoing_requests", 2)
            desired = math.ceil(total / max(target_per, 1)) if total else \
                cfg.get("min_replicas", 1)
            desired = max(cfg.get("min_replicas", 1),
                          min(cfg.get("max_replicas", 10), desired))
            with self._lock:
                changed = state.target_num_replicas != desired
                state.target_num_replicas = desired
            if changed:
                self._checkpoint("autoscale")
