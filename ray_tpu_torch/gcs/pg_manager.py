"""GCS placement group manager: gang resource reservation with 2PC.

Role of the reference's GcsPlacementGroupManager + two-phase scheduler
(ray: src/ray/gcs/gcs_server/gcs_placement_group_manager.h:230,
gcs_placement_group_scheduler.h:274): choose nodes for every bundle per the
strategy (PACK / SPREAD / STRICT_PACK / STRICT_SPREAD), PREPARE resources on
each raylet, then COMMIT all-or-nothing; failed prepares roll back and the
group re-queues. A STRICT_PACK gang of `GPU` bundles lands on one host,
so it maps onto one NVLink domain.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Dict, List, Optional

from ray_tpu_torch._private.ids import NodeID, PlacementGroupID
from ray_tpu_torch._private.rpc import ClientPool, ConnectionLost
from ray_tpu_torch._private.specs import (
    PlacementGroupInfo,
    PlacementGroupSpec,
    PlacementGroupState,
    Resources,
    resources_fit,
    subtract_resources,
)
from ray_tpu_torch.gcs import pubsub as ps
from ray_tpu_torch._private import event_log

logger = logging.getLogger(__name__)
_elog = event_log.logger_for("gcs")


class GcsPlacementGroupManager:
    def __init__(self, node_view, publisher: ps.Publisher,
                 client_pool: ClientPool, store=None):
        self._nodes = node_view
        self._pub = publisher
        self._pool = client_pool
        self._store = store
        self._groups: Dict[PlacementGroupID, PlacementGroupInfo] = {}
        self._ready_events: Dict[PlacementGroupID, asyncio.Event] = {}
        self._named: Dict[str, PlacementGroupID] = {}
        self._load_persisted()

    # ---- persistence (append-log store; reference: PG table in
    # gcs_table_storage.cc) --------------------------------------------------

    def _persist(self, pg_id) -> None:
        if self._store is None:
            return
        import pickle

        info = self._groups.get(pg_id)
        if info is None:
            self._store.delete("pgs", pg_id.binary())
        else:
            self._store.put("pgs", pg_id.binary(),
                            pickle.dumps(info, protocol=5))

    def _load_persisted(self) -> None:
        if self._store is None:
            return
        import pickle

        for key in self._store.keys("pgs"):
            try:
                info = pickle.loads(self._store.get("pgs", key))
            except Exception:  # noqa: BLE001 — skip torn records
                logger.warning("pg recovery: skipping torn record %r", key)
                continue
            pg_id = info.spec.placement_group_id
            self._groups[pg_id] = info
            ev = asyncio.Event()
            if info.state == PlacementGroupState.CREATED:
                ev.set()
            self._ready_events[pg_id] = ev
            if info.spec.name and info.state != PlacementGroupState.REMOVED:
                self._named[info.spec.name] = pg_id

    def recover(self) -> None:
        """After a GCS restart: placed groups keep their reservations
        (the raylets still hold the bundles); groups caught mid-placement
        resume scheduling."""
        for pg_id, info in list(self._groups.items()):
            if info.state in (PlacementGroupState.PENDING,
                              PlacementGroupState.RESCHEDULING):
                asyncio.ensure_future(self._schedule(pg_id))

    def pending_bundle_shapes(self):
        """Bundle resource shapes of PGs not yet fully placed — gang demand
        for the autoscaler (reference: pending PGs in the autoscaler state
        from gcs_autoscaler_state_manager.cc)."""
        out = []
        for info in self._groups.values():
            if info.state in (PlacementGroupState.PENDING,
                              PlacementGroupState.RESCHEDULING):
                placed = set(info.bundle_locations)
                for i, b in enumerate(info.spec.bundles):
                    if i not in placed:
                        out.append(dict(b))
        return out

    # ---- RPC handlers -------------------------------------------------------

    async def handle_create_placement_group(self, payload):
        spec: PlacementGroupSpec = payload["spec"]
        if spec.name and spec.name in self._named:
            return {"status": "error",
                    "message": f"placement group name '{spec.name}' already taken"}
        info = PlacementGroupInfo(spec=spec, state=PlacementGroupState.PENDING)
        self._groups[spec.placement_group_id] = info
        self._ready_events[spec.placement_group_id] = asyncio.Event()
        if spec.name:
            self._named[spec.name] = spec.placement_group_id
        self._persist(spec.placement_group_id)
        asyncio.ensure_future(self._schedule(spec.placement_group_id))
        return {"status": "ok"}

    async def handle_remove_placement_group(self, payload):
        pg_id: PlacementGroupID = payload["placement_group_id"]
        info = self._groups.get(pg_id)
        if info is None:
            return False
        info.state = PlacementGroupState.REMOVED
        _elog.emit("pg.state", state="REMOVED", pg=pg_id.hex())
        if info.spec.name:
            self._named.pop(info.spec.name, None)
        self._persist(pg_id)
        # Release bundle reservations on every involved raylet.
        for node_id in set(info.bundle_locations.values()):
            addr = self._nodes.raylet_address(node_id)
            if addr is None:
                continue
            try:
                await self._pool.get(addr).send_async(
                    "cancel_bundles", {"placement_group_id": pg_id}
                )
            except (ConnectionLost, OSError):
                pass
        self._pub.publish(ps.PG_CHANNEL, pg_id, info)
        return True

    async def handle_wait_placement_group_ready(self, payload):
        pg_id: PlacementGroupID = payload["placement_group_id"]
        timeout = payload.get("timeout", -1)
        ev = self._ready_events.get(pg_id)
        info = self._groups.get(pg_id)
        if info is None:
            return {"status": "error", "message": "no such placement group"}
        if info.state == PlacementGroupState.CREATED:
            return {"status": "ready", "info": info}
        if ev is None:
            return {"status": "error", "message": "placement group removed"}
        try:
            if timeout is None or timeout < 0:
                await ev.wait()
            else:
                await asyncio.wait_for(ev.wait(), timeout)
        except asyncio.TimeoutError:
            return {"status": "timeout"}
        info = self._groups.get(pg_id)
        if info is None or info.state != PlacementGroupState.CREATED:
            return {"status": "error", "message": "placement group removed"}
        return {"status": "ready", "info": info}

    async def handle_get_placement_group(self, payload):
        pg_id = payload.get("placement_group_id")
        if pg_id is None:
            name = payload.get("name")
            pg_id = self._named.get(name)
            if pg_id is None:
                return None
        return self._groups.get(pg_id)

    async def handle_list_placement_groups(self, payload):
        return list(self._groups.values())

    # ---- internals ----------------------------------------------------------

    async def on_node_death(self, node_id: NodeID):
        """Reschedule bundles that lived on a dead node."""
        for pg_id, info in list(self._groups.items()):
            if info.state != PlacementGroupState.CREATED:
                continue
            lost = [i for i, n in info.bundle_locations.items() if n == node_id]
            if not lost:
                continue
            info.state = PlacementGroupState.RESCHEDULING
            _elog.emit("pg.state", state="RESCHEDULING",
                       node_id=node_id.hex(), pg=pg_id.hex())
            self._ready_events[pg_id] = asyncio.Event()
            for i in lost:
                info.bundle_locations.pop(i, None)
            self._pub.publish(ps.PG_CHANNEL, pg_id, info)
            asyncio.ensure_future(self._schedule(pg_id, partial=True))

    def _place_bundles(
        self, bundles: Dict[int, Resources], strategy: str
    ) -> Optional[Dict[int, NodeID]]:
        """Pick a node per bundle. Pure function over the GCS resource view."""
        view = self._nodes.resource_view()  # node_id -> available Resources (copy)
        if not view:
            return None
        placement: Dict[int, NodeID] = {}

        def nodes_sorted(prefer_packed: bool):
            # Most-available-first for spread; least-available-first for pack.
            items = sorted(
                view.items(),
                key=lambda kv: sum(kv[1].values()),
                reverse=not prefer_packed,
            )
            return [k for k, _ in items]

        if strategy == "STRICT_PACK":
            # A gang of cards: STRICT_PACK is one host, one NVLink domain.
            total: Resources = {}
            for b in bundles.values():
                for k, v in b.items():
                    total[k] = total.get(k, 0.0) + v
            for node_id, avail in view.items():
                if resources_fit(avail, total):
                    return {i: node_id for i in bundles}
            return None

        used_nodes: Dict[NodeID, int] = {}
        for index, demand in sorted(bundles.items()):
            chosen = None
            if strategy == "STRICT_SPREAD":
                for node_id in nodes_sorted(prefer_packed=False):
                    if node_id in used_nodes:
                        continue
                    if resources_fit(view[node_id], demand):
                        chosen = node_id
                        break
            elif strategy == "SPREAD":
                fresh = [n for n in nodes_sorted(False) if n not in used_nodes]
                reused = [n for n in nodes_sorted(False) if n in used_nodes]
                for node_id in fresh + reused:
                    if resources_fit(view[node_id], demand):
                        chosen = node_id
                        break
            else:  # PACK (default)
                packed = [n for n in nodes_sorted(True) if n in used_nodes]
                fresh = [n for n in nodes_sorted(True) if n not in used_nodes]
                for node_id in packed + fresh:
                    if resources_fit(view[node_id], demand):
                        chosen = node_id
                        break
            if chosen is None:
                return None
            placement[index] = chosen
            used_nodes[chosen] = used_nodes.get(chosen, 0) + 1
            subtract_resources(view[chosen], demand)
        return placement

    async def _schedule(self, pg_id: PlacementGroupID, partial: bool = False):
        info = self._groups.get(pg_id)
        if info is None:
            return
        attempt = 0
        while attempt < 240:
            attempt += 1
            info = self._groups.get(pg_id)
            if info is None or info.state == PlacementGroupState.REMOVED:
                return
            bundles = {
                i: b
                for i, b in enumerate(info.spec.bundles)
                if i not in info.bundle_locations
            }
            if not bundles:
                break
            placement = self._place_bundles(bundles, info.spec.strategy)
            if placement is None:
                await asyncio.sleep(0.25)
                continue
            ok = await self._prepare_and_commit(pg_id, placement, bundles)
            if ok:
                info.bundle_locations.update(placement)
                break
            await asyncio.sleep(0.25)
        info = self._groups.get(pg_id)
        if info is None:
            return
        if len(info.bundle_locations) == len(info.spec.bundles):
            info.state = PlacementGroupState.CREATED
            _elog.emit("pg.state", state="CREATED", pg=pg_id.hex())
            self._persist(pg_id)
            ev = self._ready_events.get(pg_id)
            if ev is not None:
                ev.set()
            self._pub.publish(ps.PG_CHANNEL, pg_id, info)
        else:
            logger.warning("placement group %s could not be scheduled", pg_id)

    async def _prepare_and_commit(
        self,
        pg_id: PlacementGroupID,
        placement: Dict[int, NodeID],
        bundles: Dict[int, Resources],
    ) -> bool:
        # Group bundle indices per node.
        per_node: Dict[NodeID, Dict[int, Resources]] = {}
        for index, node_id in placement.items():
            per_node.setdefault(node_id, {})[index] = bundles[index]

        # Phase 1: PREPARE on each raylet.
        prepared: List[NodeID] = []
        for node_id, node_bundles in per_node.items():
            addr = self._nodes.raylet_address(node_id)
            if addr is None:
                break
            try:
                ok = await self._pool.get(addr).call_async(
                    "prepare_bundles",
                    {"placement_group_id": pg_id, "bundles": node_bundles},
                )
            except (ConnectionLost, OSError):
                ok = False
            if not ok:
                break
            prepared.append(node_id)
        if len(prepared) != len(per_node):
            for node_id in prepared:
                addr = self._nodes.raylet_address(node_id)
                if addr is None:
                    continue
                try:
                    await self._pool.get(addr).send_async(
                        "cancel_bundles", {"placement_group_id": pg_id}
                    )
                except (ConnectionLost, OSError):
                    pass
            return False

        # Phase 2: COMMIT everywhere.
        for node_id, node_bundles in per_node.items():
            addr = self._nodes.raylet_address(node_id)
            if addr is None:
                continue
            try:
                await self._pool.get(addr).call_async(
                    "commit_bundles",
                    {"placement_group_id": pg_id, "indices": list(node_bundles)},
                )
            except (ConnectionLost, OSError):
                pass  # node died post-prepare; node-death path reschedules
        return True
