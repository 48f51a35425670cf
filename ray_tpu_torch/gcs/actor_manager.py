"""GCS actor lifecycle management.

Role of the reference's GcsActorManager + GcsActorScheduler
(ray: src/ray/gcs/gcs_server/gcs_actor_manager.h:251-281 — the lifecycle FSM
DEPENDENCIES_UNREADY -> PENDING_CREATION -> ALIVE -> (RESTARTING ->
PENDING_CREATION)* -> DEAD — and gcs_actor_scheduler.cc, which leases a
worker from a raylet and pushes the creation task).

Creation is asynchronous: `register_actor` returns immediately; callers learn
the address via the ACTOR pubsub channel or `get_actor_info`.
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Dict, List, Optional, Tuple

from ray_tpu_torch._private import backoff as _backoff
from ray_tpu_torch._private import tracing as _tracing
from ray_tpu_torch._private.config import CONFIG
from ray_tpu_torch._private.ids import ActorID, NodeID
from ray_tpu_torch._private.rpc import ClientPool, ConnectionLost
from ray_tpu_torch._private.specs import (
    ActorInfo,
    ActorState,
    Address,
    TaskSpec,
)
from ray_tpu_torch.gcs import pubsub as ps
from ray_tpu_torch._private import event_log

logger = logging.getLogger(__name__)
_elog = event_log.logger_for("gcs")


class GcsActorManager:
    def __init__(self, node_view, publisher: ps.Publisher,
                 client_pool: ClientPool, store=None):
        # node_view: GcsNodeManager (cluster resource view + raylet addresses)
        self._nodes = node_view
        self._pub = publisher
        self._pool = client_pool
        self._store = store
        self._actors: Dict[ActorID, ActorInfo] = {}
        self._creation_specs: Dict[ActorID, TaskSpec] = {}
        # Actors awaiting their FIRST creation (the bounded registration
        # queue; restarts bypass it — they already hold capacity budget).
        self._pending_creation: set = set()
        # traced creations: registration wall time, closed into a
        # gcs.actor_admission span when the worker reports ALIVE (popped
        # there / on DEAD — only traced creations ever enter)
        self._register_wall: Dict[ActorID, float] = {}
        # (namespace, name) -> actor_id
        self._named: Dict[Tuple[str, str], ActorID] = {}
        # node_id -> set of actor ids placed there
        self._by_node: Dict[NodeID, set] = {}
        self._lock = asyncio.Lock()
        self._load_persisted()

    # ---- persistence (reference: gcs_table_storage.cc actor table over the
    # Redis store client; here the append-log store) ------------------------

    def _persist(self, actor_id: ActorID) -> None:
        if self._store is None:
            return
        import pickle

        info = self._actors.get(actor_id)
        if info is None:
            return
        spec = self._creation_specs.get(actor_id)
        self._store.put("actors", actor_id.binary(),
                        pickle.dumps((info, spec), protocol=5))

    def _load_persisted(self) -> None:
        if self._store is None:
            return
        import pickle

        for key in self._store.keys("actors"):
            try:
                info, spec = pickle.loads(self._store.get("actors", key))
            except Exception:  # noqa: BLE001 — skip torn records
                logger.warning("actor recovery: skipping torn record %r", key)
                continue
            self._actors[info.actor_id] = info
            if spec is not None:
                self._creation_specs[info.actor_id] = spec
            if info.state == ActorState.PENDING_CREATION:
                self._pending_creation.add(info.actor_id)
            if info.name and info.state != ActorState.DEAD:
                self._named[(info.namespace or "", info.name)] = info.actor_id
            if info.address is not None and info.state == ActorState.ALIVE:
                self._by_node.setdefault(
                    info.address.node_id, set()).add(info.actor_id)

    def recover(self) -> None:
        """Called once after a GCS restart: actors persisted mid-creation
        (or mid-restart) resume scheduling; ALIVE actors keep serving at
        their recorded addresses untouched."""
        for actor_id, info in list(self._actors.items()):
            if info.state in (ActorState.PENDING_CREATION,
                              ActorState.RESTARTING):
                asyncio.ensure_future(self._schedule_actor(actor_id))

    # ---- RPC handlers -------------------------------------------------------

    async def handle_register_actor(self, payload):
        spec: TaskSpec = payload["spec"]
        get_if_exists: bool = payload.get("get_if_exists", False)
        creation = spec.actor_creation
        name = creation.name
        namespace = creation.namespace or ""
        async with self._lock:
            # Idempotent: actor ids are client-generated, so a retried
            # registration (lost reply / timeout on a pipelined register)
            # must NOT re-schedule — rerunning __init__ in a second
            # worker would double side effects and leak a lease.
            existing = self._actors.get(creation.actor_id)
            if existing is not None:
                return {"status": "registered", "info": existing}
            # Bounded creation queue (gcs_actor_creation_queue_max): a
            # registration burst beyond the bound gets typed retry_later
            # pushback (the owner re-registers with paced backoff) instead
            # of an unbounded PENDING_CREATION backlog each running its
            # own scheduling loop against the same full raylets.
            bound = CONFIG.gcs_actor_creation_queue_max
            pending = len(self._pending_creation)
            if bound > 0 and pending >= bound:
                trace_id = _tracing.trace_id_of(spec)
                _elog.emit("task.shed", actor_id=creation.actor_id.hex(),
                           trace_id=trace_id,
                           layer="gcs_actor_creation",
                           reason="creation queue full",
                           class_name=spec.function_name)
                _backoff.count_shed("gcs_actor_creation")
                _tracing.force_trace(trace_id, "task.shed:gcs_actor_creation")
                return {
                    "status": "retry_later",
                    # creations are heavier than leases: 2ms/item, 10s cap
                    "retry_after_s": _backoff.retry_after_hint(
                        pending, per_item_s=0.002, cap_s=10.0),
                }
            if name:
                existing_id = self._named.get((namespace, name))
                if existing_id is not None:
                    existing = self._actors.get(existing_id)
                    if existing is not None and existing.state != ActorState.DEAD:
                        if get_if_exists:
                            return {"status": "exists", "info": existing}
                        return {
                            "status": "error",
                            "message": f"Actor name '{name}' already taken in "
                                       f"namespace '{namespace}'",
                        }
                self._named[(namespace, name)] = creation.actor_id
            info = ActorInfo(
                actor_id=creation.actor_id,
                state=ActorState.PENDING_CREATION,
                name=name,
                namespace=namespace,
                is_detached=creation.is_detached,
                max_restarts=creation.max_restarts,
                class_name=spec.function_name,
                job_id=spec.job_id,
            )
            self._actors[creation.actor_id] = info
            self._creation_specs[creation.actor_id] = spec
            self._pending_creation.add(creation.actor_id)
            self._persist(creation.actor_id)
        if getattr(spec, "trace_ctx", None) is not None:
            # admission-span anchor: report_actor_alive closes it
            self._register_wall[creation.actor_id] = time.time()
        _elog.emit("actor.pending", actor_id=creation.actor_id.hex(),
                   class_name=spec.function_name, name=name)
        asyncio.ensure_future(self._schedule_actor(creation.actor_id))
        return {"status": "registered", "info": info}

    async def handle_get_actor_info(self, payload):
        return self._actors.get(payload["actor_id"])

    async def handle_list_actors(self, payload):
        return list(self._actors.values())

    async def handle_get_named_actor(self, payload):
        key = (payload.get("namespace") or "", payload["name"])
        actor_id = self._named.get(key)
        if actor_id is None:
            return None
        return self._actors.get(actor_id)

    async def handle_list_named_actors(self, payload):
        all_namespaces = payload.get("all_namespaces", False)
        namespace = payload.get("namespace") or ""
        out = []
        for (ns, name), actor_id in self._named.items():
            info = self._actors.get(actor_id)
            if info is None or info.state == ActorState.DEAD:
                continue
            if all_namespaces or ns == namespace:
                out.append({"namespace": ns, "name": name})
        return out

    async def handle_kill_actor(self, payload):
        actor_id: ActorID = payload["actor_id"]
        no_restart: bool = payload.get("no_restart", True)
        info = self._actors.get(actor_id)
        if info is None:
            return False
        if info.state == ActorState.ALIVE and info.address is not None:
            client = self._pool.get(info.address.rpc_address)
            try:
                await client.send_async(
                    "kill_actor", {"actor_id": actor_id, "no_restart": no_restart}
                )
            except (ConnectionLost, OSError):
                pass
        if no_restart:
            await self._mark_dead(actor_id, "ray_tpu_torch.kill() was called")
        return True

    async def handle_report_actor_alive(self, payload):
        """Called by the worker once the creation task (__init__) succeeds."""
        actor_id: ActorID = payload["actor_id"]
        address: Address = payload["address"]
        info = self._actors.get(actor_id)
        if info is None:
            return False
        info.state = ActorState.ALIVE
        info.address = address
        info.pid = payload.get("pid", 0)
        self._pending_creation.discard(actor_id)
        self._by_node.setdefault(address.node_id, set()).add(actor_id)
        self._persist(actor_id)
        self._pub.publish(ps.ACTOR_CHANNEL, actor_id, info)
        registered_at = self._register_wall.pop(actor_id, None)
        if registered_at is not None:
            spec = self._creation_specs.get(actor_id)
            ctx = getattr(spec, "trace_ctx", None) if spec is not None \
                else None
            if ctx is not None:
                # GCS-side admission span of a traced actor creation:
                # register -> ALIVE (scheduling + lease + __init__)
                _tracing.record_span(
                    "gcs.actor_admission", ctx, registered_at, time.time(),
                    proc="gcs",
                    attrs={"actor_id": actor_id.hex(),
                           "restarts": info.num_restarts})
        _elog.emit("actor.alive", actor_id=actor_id.hex(),
                   node_id=(address.node_id.hex()
                            if address.node_id else None),
                   address=address.rpc_address, restarts=info.num_restarts)
        return True

    async def handle_report_actor_death(self, payload):
        """Called by a raylet when an actor's worker process exits."""
        actor_id: ActorID = payload["actor_id"]
        reason: str = payload.get("reason", "worker process died")
        intended: bool = payload.get("intended", False)
        await self._on_actor_failure(actor_id, reason, intended)
        return True

    # ---- internals ----------------------------------------------------------

    async def on_node_death(self, node_id: NodeID):
        for actor_id in list(self._by_node.get(node_id, ())):
            await self._on_actor_failure(
                actor_id, f"node {node_id.hex()[:8]} died", intended=False
            )

    async def on_job_finished(self, job_id):
        """Non-detached actors die with their job (owner lifetime)."""
        for actor_id, info in list(self._actors.items()):
            if info.job_id == job_id and not info.is_detached and (
                info.state != ActorState.DEAD
            ):
                await self.handle_kill_actor(
                    {"actor_id": actor_id, "no_restart": True}
                )

    async def _on_actor_failure(self, actor_id: ActorID, reason: str, intended: bool):
        info = self._actors.get(actor_id)
        if info is None or info.state == ActorState.DEAD:
            return
        if info.address is not None:
            self._by_node.get(info.address.node_id, set()).discard(actor_id)
        restarts_left = (
            info.max_restarts == -1 or info.num_restarts < info.max_restarts
        )
        if not intended and restarts_left:
            info.state = ActorState.RESTARTING
            info.num_restarts += 1
            info.address = None
            self._persist(actor_id)
            self._pub.publish(ps.ACTOR_CHANNEL, actor_id, info)
            # THE restart decision: failure observed, budget allows another
            # incarnation — the record chaos post-mortems pivot on
            _elog.emit("actor.restarting", actor_id=actor_id.hex(),
                       reason=reason, restarts=info.num_restarts)
            await asyncio.sleep(CONFIG.actor_restart_delay_ms / 1000.0)
            asyncio.ensure_future(self._schedule_actor(actor_id))
        else:
            await self._mark_dead(actor_id, reason)

    async def _mark_dead(self, actor_id: ActorID, reason: str):
        info = self._actors.get(actor_id)
        if info is None:
            return
        info.state = ActorState.DEAD
        info.death_cause = reason
        self._pending_creation.discard(actor_id)
        self._register_wall.pop(actor_id, None)
        if info.address is not None:
            self._by_node.get(info.address.node_id, set()).discard(actor_id)
            info.address = None
        if info.name:
            self._named.pop((info.namespace, info.name), None)
        self._creation_specs.pop(actor_id, None)
        self._persist(actor_id)
        self._pub.publish(ps.ACTOR_CHANNEL, actor_id, info)
        _elog.emit("actor.dead", actor_id=actor_id.hex(), reason=reason)

    async def _schedule_actor(self, actor_id: ActorID):
        """Lease a worker somewhere and push the creation task to it."""
        spec = self._creation_specs.get(actor_id)
        info = self._actors.get(actor_id)
        if spec is None or info is None or info.state == ActorState.DEAD:
            return
        attempt = 0
        refunds = 0
        failures = 0  # consecutive lease failures, drives the backoff
        policy = _backoff.BackoffPolicy(base_s=0.2, multiplier=1.5,
                                        max_s=2.0, jitter=0.2)
        pacer = _backoff.AIMDPacer(base_s=0.2, max_s=5.0)
        target_node: Optional[NodeID] = None
        while attempt < 60:
            info = self._actors.get(actor_id)
            if info is None or info.state == ActorState.DEAD:
                return
            candidates = self._nodes.pick_nodes_for(spec)
            if target_node is not None:
                candidates = [target_node] + [c for c in candidates if c != target_node]
                target_node = None
            if not candidates:
                # No feasible node RIGHT NOW (cluster scaling, PG bundles
                # re-placing after a drain, ...): stay PENDING without
                # burning the attempt budget — the reference keeps
                # pending actors queued until resources appear. The
                # budget guards against failing LEASES, not missing
                # capacity.
                await asyncio.sleep(0.25)
                continue
            attempt += 1
            node_id = candidates[0]
            raylet_addr = self._nodes.raylet_address(node_id)
            if raylet_addr is None:
                await asyncio.sleep(0.1)
                continue
            client = self._pool.get(raylet_addr)
            try:
                reply = await client.call_async(
                    "request_worker_lease",
                    {"spec": spec, "grant_or_reject": False},
                    timeout=CONFIG.worker_register_timeout_s,
                )
            except ConnectionLost as e:
                if not e.maybe_delivered and refunds < 120:
                    # The lease request provably never reached the raylet
                    # (connect refused): nothing leased, nothing executed —
                    # refund the attempt instead of burning the budget on
                    # a raylet that is restarting (the health checker
                    # removes a truly dead node from `candidates` long
                    # before the bounded refund pool drains).
                    attempt -= 1
                    refunds += 1
                failures += 1
                await asyncio.sleep(policy.delay(failures))
                continue
            except (OSError, asyncio.TimeoutError):
                failures += 1
                await asyncio.sleep(policy.delay(failures))
                continue
            if reply.get("retry_later"):
                # typed pushback from a full raylet lease queue: pace the
                # re-ask (AIMD) and refund the attempt — shed work is not
                # a failed lease, and burning the budget on it would turn
                # an overloaded-but-healthy cluster into dead actors
                if refunds < 120:
                    attempt -= 1
                    refunds += 1
                await asyncio.sleep(
                    pacer.on_pushback(reply.get("retry_after_s")))
                continue
            if reply.get("rejected"):
                if reply.get("runtime_env_error"):
                    # permanent env misconfiguration — the actor can never
                    # be placed on this (or likely any) node
                    await self._mark_dead(actor_id,
                                          reply["runtime_env_error"])
                    return
                failures += 1
                await asyncio.sleep(policy.delay(failures))
                continue
            if reply.get("retry_at"):
                target_node = reply["retry_at_node_id"]
                continue
            failures = 0
            pacer.on_success()
            worker_addr: Address = reply["worker_address"]
            ok = await self._push_creation_task(actor_id, spec, worker_addr, raylet_addr)
            if ok:
                return
            await asyncio.sleep(0.2)
        await self._mark_dead(actor_id, "actor creation could not be scheduled")

    async def _push_creation_task(
        self, actor_id: ActorID, spec: TaskSpec, worker_addr: Address, raylet_addr: str
    ) -> bool:
        client = self._pool.get(worker_addr.rpc_address)
        try:
            reply = await client.call_async(
                "push_task", {"spec": spec}, timeout=CONFIG.rpc_call_timeout_s * 10
            )
        except ConnectionLost as e:
            if not e.maybe_delivered:
                return False  # provably never started: re-lease freely
            # The connection died with the push possibly delivered: the
            # worker MAY be running __init__ right now and will report
            # itself ALIVE when it finishes (handle_report_actor_alive
            # comes over the worker's own GCS connection, not this one).
            # Re-leasing immediately would run __init__ a second time in
            # another worker — double side effects for a creation that
            # actually succeeded (flushed out by chaos `disconnect` on
            # push_task). Wait for the actor to RESOLVE before declaring
            # the push failed. "Resolved" must be judged against the
            # state at push time: a restart-path push starts from
            # RESTARTING (not PENDING_CREATION), so the test is
            # ALIVE/DEAD/another-restart-cycle — NOT merely "state
            # changed from PENDING_CREATION", which is instantly true
            # mid-restart and would abandon the actor forever.
            info = self._actors.get(actor_id)
            restarts_at_push = info.num_restarts if info is not None else -1
            deadline = (asyncio.get_event_loop().time()
                        + CONFIG.worker_register_timeout_s)
            while asyncio.get_event_loop().time() < deadline:
                info = self._actors.get(actor_id)
                if info is None or info.state in (ActorState.ALIVE,
                                                  ActorState.DEAD):
                    return True  # __init__ reported in, or a death path
                    # terminally resolved it — nothing left to push
                if info.num_restarts != restarts_at_push:
                    # the worker died and _on_actor_failure already
                    # spawned the next restart cycle's _schedule_actor:
                    # that task owns scheduling now; bowing out prevents
                    # two schedulers racing __init__ pushes
                    return True
                await asyncio.sleep(0.25)
            return False
        except (OSError, asyncio.TimeoutError):
            return False
        if reply.get("status") == "ok":
            # Worker reports itself alive (handle_report_actor_alive) with its
            # serving address; nothing more to do here.
            return True
        # __init__ raised: the actor is dead on arrival; propagate the error.
        await self._mark_dead(
            actor_id,
            reply.get("error_str", "actor constructor failed"),
        )
        info = self._actors.get(actor_id)
        if info is not None:
            info.death_cause = reply.get("error_str", "actor constructor failed")
            self._pub.publish(ps.ACTOR_CHANNEL, actor_id, info)
        # Return the leased worker to the pool.
        try:
            await self._pool.get(raylet_addr).send_async(
                "return_worker",
                {"worker_address": worker_addr, "disconnect": True},
            )
        except (ConnectionLost, OSError):
            pass
        return True
