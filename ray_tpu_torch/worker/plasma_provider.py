"""Worker-side provider for the node-local C++ shared-memory object store.

Equivalent of the reference's CoreWorkerPlasmaStoreProvider
(ray: src/ray/core_worker/store_provider/plasma_store_provider.h:88): puts
objects above the inline threshold into the node's shm store and reads them
back zero-copy.  Restore-on-miss goes through the raylet, which owns disk
spilling (reference: raylet/local_object_manager.h:41).

Zero-copy discipline: a deserialized value may alias the shm arena (pickle5
out-of-band numpy buffers).  StoreClient.get ties the store ref to the GC
lifetime of the mapped view, so the slot stays pinned exactly as long as any
user value aliases it — a delete() while values are alive defers server-side
until the last view dies (plasma's pinning semantics).
"""

from __future__ import annotations

import logging
from typing import Optional

from ray_tpu_torch._private import serialization as ser
from ray_tpu_torch._private.ids import ObjectID
from ray_tpu_torch._private.shm_store import ShmStoreError, ShmStoreFull, StoreClient

logger = logging.getLogger(__name__)


class PlasmaProvider:
    def __init__(self, socket_path: str, raylet_call=None):
        """raylet_call(method, payload) -> reply; used for spill/restore."""
        self._client = StoreClient(socket_path)
        self._raylet_call = raylet_call

    def prefault(self) -> None:
        """See StoreClient.prefault: warm this process's arena mapping."""
        self._client.prefault()

    # -- write --------------------------------------------------------------

    def _create_with_spill_retry(self, oid: ObjectID, size: int,
                                 primary: bool):
        """Allocate a writable view, asking the raylet to spill cold
        primaries once on ShmStoreFull. None when it still doesn't fit."""
        key = oid.binary()
        for attempt in (0, 1):
            try:
                return self._client.create(key, size, primary=primary)
            except ShmStoreFull:
                if attempt == 0 and self._raylet_call is not None:
                    try:
                        self._raylet_call("spill_objects", {"need": size})
                        continue
                    except Exception:  # noqa: BLE001 — spill best-effort
                        return None
                return None
            except ShmStoreError:
                return None
        return None

    def put_serialized(self, oid: ObjectID, s: ser.SerializedObject,
                       primary: bool = True) -> bool:
        """Write the flat payload into shm. Returns False when it doesn't fit
        (caller falls back to in-memory bytes)."""
        size = s.wire_size()
        view = self._create_with_spill_retry(oid, size, primary)
        if view is None:
            return False
        try:
            s.write_into(view)
        finally:
            del view
        key = oid.binary()
        self._client.seal(key)
        self._client.release(key)
        return True

    # -- read ---------------------------------------------------------------

    def get_serialized(self, oid: ObjectID,
                       restore: bool = True) -> Optional[ser.SerializedObject]:
        """Zero-copy read; the underlying slot stays pinned while any
        deserialized value aliases it (GC-tied ref, see StoreClient.get)."""
        view = self.get_raw_view(oid, restore=restore)
        if view is None:
            return None
        return ser.SerializedObject.from_bytes(view)

    def contains(self, oid: ObjectID) -> bool:
        return self._client.contains(oid.binary())

    # -- chunked transfer support -------------------------------------------

    def get_raw_view(self, oid: ObjectID, restore: bool = True):
        """Pinned zero-copy view of the FLAT wire payload (for serving
        chunk ranges). Same pinning contract as get_serialized."""
        key = oid.binary()
        view = self._client.get(key, timeout_ms=0)
        if view is None and restore and self._raylet_call is not None:
            try:
                ok = self._raylet_call("restore_object", {"object_id": oid})
            except Exception:  # noqa: BLE001 — raylet down ⇒ treat as miss
                ok = False
            if ok:
                view = self._client.get(key, timeout_ms=1000)
        return view

    def create_for_receive(self, oid: ObjectID, size: int):
        """Writable shm view for a chunked fetch to land into (secondary
        copy: evictable). None when it doesn't fit — caller falls back to
        heap bytes. seal_received()/abort_receive() finish the protocol."""
        return self._create_with_spill_retry(oid, size, primary=False)

    def seal_received(self, oid: ObjectID) -> None:
        key = oid.binary()
        self._client.seal(key)
        self._client.release(key)

    def abort_receive(self, oid: ObjectID) -> None:
        try:
            self._client.abort(oid.binary())
        except Exception:  # noqa: BLE001 — nothing was created to abort
            logger.debug("plasma abort failed for %s", oid, exc_info=True)

    # -- lifecycle ----------------------------------------------------------

    def free_local(self, oid: ObjectID) -> None:
        """Delete the local store copy only (server defers the slot free
        until the last pinned reader view dies). Safe from the event loop:
        one non-blocking UDS message, no RPC round trip — the caller is
        responsible for notifying the raylet about spilled copies."""
        self._client.delete(oid.binary())

    def free(self, oid: ObjectID) -> None:
        """Delete the object and drop any spilled copy. Blocking (raylet
        round trip): never call from an event-loop thread."""
        self.free_local(oid)
        if self._raylet_call is not None:
            try:
                self._raylet_call("free_spilled", {"object_ids": [oid]})
            except Exception:  # noqa: BLE001 — raylet gone; spill GC'd with it
                logger.debug("free_spilled failed for %s", oid,
                             exc_info=True)

    def close(self) -> None:
        """Deliberately leave the store connection OPEN: disconnecting would
        drop this process's pinned refs while user code may still hold
        zero-copy arrays aliasing those slots (the server would then reuse
        them — silent corruption). Process exit severs the socket, at which
        point no Python value can alias the arena anymore."""
