"""Distributed reference counting (ownership model).

Role of the reference's ReferenceCounter
(ray: src/ray/core_worker/reference_count.h:59-61, .cc ~1.7k LoC): every
object has exactly one owner — the worker that created it (task submitter for
returns, putter for puts). The owner tracks:
  - its own local Python refcount (ObjectRef __init__/__del__ hooks),
  - the number of pending submitted tasks using the ref as an argument,
  - the set of remote borrowers (workers that deserialized the ref),
  - lineage: the TaskSpec that produced the object (for reconstruction).
Borrowers track local counts and notify the owner on first borrow / last
release. When all counts reach zero the owner frees the object everywhere.

Simplification vs the reference: borrower registration is an eager one-way
message at first deserialization instead of being piggybacked on task replies;
nested-borrow forwarding (a borrower passing the ref onward) is handled by the
new holder registering with the owner directly.
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Set

from ray_tpu_torch._private.ids import ObjectID

logger = logging.getLogger(__name__)


@dataclass
class Reference:
    owned: bool = False
    owner_address: Optional[object] = None  # Address
    local_refs: int = 0
    submitted_task_refs: int = 0
    borrowers: Set[str] = field(default_factory=set)  # worker rpc addresses
    # Where the primary (large-object) copy lives, if not inline at the owner.
    location: Optional[str] = None
    # Additional full-copy holders (chunked-fetch receivers that registered
    # back) — extra pull sources and broadcast fan-out points.
    locations: Set[str] = field(default_factory=set)
    lineage_task = None     # TaskSpec that produces this object (owned only)
    pinned: bool = False    # e.g. detached-actor handles, named refs
    freed: bool = False
    # Memory observability (`ray-tpu memory` / memory_report RPC): payload
    # size when the tracker saw it (0 = unknown, e.g. a remote return not
    # yet fetched) and the wall time the entry was created — age drives
    # the leak detector's over-age pin/borrow verdicts.
    size_bytes: int = 0
    created_at: float = field(default_factory=time.time)


class ReferenceCounter:
    def __init__(
        self,
        free_callback: Callable[[ObjectID, Optional[str]], None],
        notify_owner_release: Callable[[ObjectID, object], None],
    ):
        """free_callback(object_id, locations: list): owner-side, actually
        frees the primary and every registered replica.
        notify_owner_release(object_id, owner_address): borrower-side."""
        self._refs: Dict[ObjectID, Reference] = {}
        self._lock = threading.RLock()
        self._free_cb = free_callback
        self._notify_release = notify_owner_release

    # ---- registration -------------------------------------------------------

    def add_owned(self, object_id: ObjectID, owner_address, *, lineage_task=None,
                  location: Optional[str] = None, initial_local_refs: int = 0):
        with self._lock:
            ref = self._refs.get(object_id)
            if ref is None:
                ref = Reference(owned=True, owner_address=owner_address)
                self._refs[object_id] = ref
            ref.owned = True
            ref.owner_address = owner_address
            if lineage_task is not None:
                ref.lineage_task = lineage_task
            if location is not None:
                ref.location = location
            ref.local_refs += initial_local_refs

    def add_borrowed(self, object_id: ObjectID, owner_address) -> bool:
        """Register knowledge of a non-owned ref. Returns True if this is the
        first time (caller should notify the owner)."""
        with self._lock:
            ref = self._refs.get(object_id)
            if ref is None:
                self._refs[object_id] = Reference(owned=False, owner_address=owner_address)
                return True
            if ref.owner_address is None:
                ref.owner_address = owner_address
            return False

    def set_location(self, object_id: ObjectID, location: Optional[str]):
        with self._lock:
            ref = self._refs.get(object_id)
            if ref is not None:
                ref.location = location

    def get_location(self, object_id: ObjectID) -> Optional[str]:
        with self._lock:
            ref = self._refs.get(object_id)
            return ref.location if ref else None

    def add_location(self, object_id: ObjectID, location: str):
        """A chunked-fetch receiver now holds a full copy."""
        with self._lock:
            ref = self._refs.get(object_id)
            if ref is not None and location != ref.location:
                ref.locations.add(location)

    def drop_location(self, object_id: ObjectID, location: str):
        with self._lock:
            ref = self._refs.get(object_id)
            if ref is not None:
                ref.locations.discard(location)

    def get_all_locations(self, object_id: ObjectID) -> list:
        """Primary first, then replicas (pull sources, in preference order)."""
        with self._lock:
            ref = self._refs.get(object_id)
            return [] if ref is None else self._locations_of(ref)

    def get_lineage(self, object_id: ObjectID):
        with self._lock:
            ref = self._refs.get(object_id)
            return ref.lineage_task if ref else None

    def pin(self, object_id: ObjectID):
        with self._lock:
            ref = self._refs.get(object_id)
            if ref is not None:
                ref.pinned = True

    def set_size(self, object_id: ObjectID, size_bytes: int):
        """Record the payload size for the memory report (put / stored
        return paths — borrowers learn it from their fetched copy)."""
        with self._lock:
            ref = self._refs.get(object_id)
            if ref is not None:
                ref.size_bytes = int(size_bytes)

    # ---- local count hooks (from ObjectRef lifecycle) -----------------------

    def add_local_ref(self, object_id: ObjectID):
        with self._lock:
            ref = self._refs.get(object_id)
            if ref is None:
                ref = Reference()
                self._refs[object_id] = ref
            ref.local_refs += 1

    def remove_local_ref(self, object_id: ObjectID):
        self._decrement(object_id, "local_refs")

    def add_submitted_task_ref(self, object_id: ObjectID):
        with self._lock:
            ref = self._refs.get(object_id)
            if ref is None:
                ref = Reference()
                self._refs[object_id] = ref
            ref.submitted_task_refs += 1

    def remove_submitted_task_ref(self, object_id: ObjectID):
        self._decrement(object_id, "submitted_task_refs")

    def _decrement(self, object_id: ObjectID, attr: str):
        to_free = None
        notify = None
        with self._lock:
            ref = self._refs.get(object_id)
            if ref is None:
                return
            setattr(ref, attr, max(0, getattr(ref, attr) - 1))
            if ref.local_refs == 0 and ref.submitted_task_refs == 0 and not ref.pinned:
                if ref.owned:
                    if not ref.borrowers and not ref.freed:
                        ref.freed = True
                        to_free = (object_id, self._locations_of(ref))
                        del self._refs[object_id]
                else:
                    notify = (object_id, ref.owner_address)
                    del self._refs[object_id]
        if to_free is not None:
            try:
                self._free_cb(*to_free)
            except Exception:
                logger.exception("free callback failed")
        if notify is not None and notify[1] is not None:
            try:
                self._notify_release(*notify)
            except Exception:  # noqa: BLE001 — owner may already be gone
                logger.debug("borrow-release notification failed",
                             exc_info=True)

    @staticmethod
    def _locations_of(ref: Reference) -> list:
        out = [] if ref.location is None else [ref.location]
        out.extend(sorted(ref.locations - {ref.location}))
        return out

    # ---- borrower bookkeeping (owner side) ----------------------------------

    def add_borrower(self, object_id: ObjectID, borrower_address: str):
        with self._lock:
            ref = self._refs.get(object_id)
            if ref is None or not ref.owned:
                return
            ref.borrowers.add(borrower_address)

    def remove_borrower(self, object_id: ObjectID, borrower_address: str):
        to_free = None
        with self._lock:
            ref = self._refs.get(object_id)
            if ref is None or not ref.owned:
                return
            ref.borrowers.discard(borrower_address)
            if (
                ref.local_refs == 0
                and ref.submitted_task_refs == 0
                and not ref.borrowers
                and not ref.pinned
                and not ref.freed
            ):
                ref.freed = True
                to_free = (object_id, self._locations_of(ref))
                del self._refs[object_id]
        if to_free is not None:
            try:
                self._free_cb(*to_free)
            except Exception:
                logger.exception("free callback failed")

    def remove_borrower_everywhere(self, borrower_address: str):
        """A borrower process died: drop it from every owned ref."""
        with self._lock:
            ids = [oid for oid, r in self._refs.items() if borrower_address in r.borrowers]
        for oid in ids:
            self.remove_borrower(oid, borrower_address)

    # ---- introspection ------------------------------------------------------

    def get_owner_address(self, object_id: ObjectID):
        with self._lock:
            ref = self._refs.get(object_id)
            return ref.owner_address if ref else None

    def holds_borrow(self, object_id: ObjectID) -> bool:
        """True when this worker currently BORROWS the object (not owner)
        and still pins it with a local or submitted-task ref — i.e. the
        executor retained a nested arg ref past the task body and must
        report it in the reply (executor._attach_retained_borrows)."""
        with self._lock:
            ref = self._refs.get(object_id)
            return (ref is not None and not ref.owned
                    and (ref.local_refs > 0 or ref.submitted_task_refs > 0))

    def owns(self, object_id: ObjectID) -> bool:
        with self._lock:
            ref = self._refs.get(object_id)
            return bool(ref and ref.owned)

    def num_tracked(self) -> int:
        with self._lock:
            return len(self._refs)

    def summary(self) -> dict:
        with self._lock:
            return {
                "num_refs": len(self._refs),
                "num_owned": sum(1 for r in self._refs.values() if r.owned),
                "num_borrowed": sum(1 for r in self._refs.values() if not r.owned),
                "num_pinned": sum(1 for r in self._refs.values() if r.pinned),
                "tracked_bytes": sum(r.size_bytes for r in self._refs.values()),
            }

    def snapshot(self) -> dict:
        """object_id -> Reference copy (for `ray memory` / state API)."""
        import copy

        with self._lock:
            return {oid: copy.copy(ref) for oid, ref in self._refs.items()}
