"""Per-worker in-memory object store.

Role of the reference's CoreWorkerMemoryStore
(ray: src/ray/core_worker/store_provider/memory_store/memory_store.h:43):
holds inlined task returns, `put` values and borrower-side caches, with
blocking and async waiters. Entries are serialized payloads plus a lazily
cached deserialized value (zero-copy buffers preserved end to end).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Set

from ray_tpu_torch._private.ids import ObjectID
from ray_tpu_torch._private.serialization import SerializedObject


_SENTINEL = object()


@dataclass
class StoreEntry:
    serialized: Optional[SerializedObject] = None
    value: Any = _SENTINEL          # cached deserialized value
    is_exception: bool = False
    # object is not here; it lives at this worker address (secondary copy holder)
    location: Optional[str] = None
    freed: bool = False
    # payload lives in a node-local shm store (plasma); when the holder is a
    # remote node, plasma_node says which node's store has the primary copy.
    in_plasma: bool = False
    plasma_node: Optional[str] = None
    # wall time the entry landed — ages memory-report rows and lets the
    # leak detector skip freshly-stored entries mid-registration
    created_at: float = field(default_factory=time.time)


class MemoryStore:
    def __init__(self):
        self._entries: Dict[ObjectID, StoreEntry] = {}
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        # async waiters: object_id -> list of callbacks (called off-lock)
        self._callbacks: Dict[ObjectID, List[Callable[[StoreEntry], None]]] = {}

    def put_serialized(
        self,
        object_id: ObjectID,
        serialized: Optional[SerializedObject],
        *,
        value: Any = _SENTINEL,
        is_exception: bool = False,
        location: Optional[str] = None,
        in_plasma: bool = False,
        plasma_node: Optional[str] = None,
    ) -> None:
        entry = StoreEntry(
            serialized=serialized,
            value=value,
            is_exception=is_exception,
            location=location,
            in_plasma=in_plasma,
            plasma_node=plasma_node,
        )
        with self._lock:
            self._entries[object_id] = entry
            cbs = self._callbacks.pop(object_id, [])
            self._cv.notify_all()
        for cb in cbs:
            cb(entry)

    def mark_freed(self, object_id: ObjectID) -> None:
        entry = StoreEntry(freed=True)
        with self._lock:
            self._entries[object_id] = entry
            cbs = self._callbacks.pop(object_id, [])
            self._cv.notify_all()
        for cb in cbs:
            cb(entry)

    def contains(self, object_id: ObjectID) -> bool:
        with self._lock:
            return object_id in self._entries

    def get_entry(self, object_id: ObjectID) -> Optional[StoreEntry]:
        with self._lock:
            return self._entries.get(object_id)

    def cache_value(self, object_id: ObjectID, value: Any) -> None:
        with self._lock:
            entry = self._entries.get(object_id)
            if entry is not None:
                entry.value = value

    def wait_entry(self, object_id: ObjectID, timeout: Optional[float]) -> Optional[StoreEntry]:
        """Block until the object is present (or timeout). Returns the entry."""
        with self._lock:
            if object_id in self._entries:
                return self._entries[object_id]
            self._cv.wait_for(lambda: object_id in self._entries, timeout)
            return self._entries.get(object_id)

    def add_callback(self, object_id: ObjectID, cb: Callable[[StoreEntry], None]) -> bool:
        """Invoke cb(entry) when the object arrives. Returns True if already
        present (cb invoked synchronously)."""
        with self._lock:
            entry = self._entries.get(object_id)
            if entry is None:
                self._callbacks.setdefault(object_id, []).append(cb)
                return False
        cb(entry)
        return True

    def delete(self, object_ids) -> None:
        with self._lock:
            for oid in object_ids:
                self._entries.pop(oid, None)

    def ready_ids(self, object_ids) -> Set[ObjectID]:
        with self._lock:
            return {oid for oid in object_ids if oid in self._entries}

    def size(self) -> int:
        with self._lock:
            return len(self._entries)

    def total_bytes(self) -> int:
        with self._lock:
            return sum(
                e.serialized.total_bytes()
                for e in self._entries.values()
                if e.serialized is not None
            )

    def entries_snapshot(self) -> List[tuple]:
        """(object_id, bytes, created_at, in_plasma, freed, is_exception)
        per entry — the memory_report RPC's store-resident view (sizes
        computed under the lock; the caller formats off-lock)."""
        with self._lock:
            return [
                (oid,
                 e.serialized.total_bytes() if e.serialized is not None else 0,
                 e.created_at, e.in_plasma, e.freed, e.is_exception)
                for oid, e in self._entries.items()
            ]
