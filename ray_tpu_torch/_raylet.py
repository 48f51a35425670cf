"""ObjectRef / ObjectRefGenerator and the process-global worker slot.

Named after the reference's Cython binding (ray: python/ray/_raylet.pyx) —
this module hosts the types the binding exposes there: `ObjectRef`
(_raylet.pyx ObjectRef, with reference-counting lifecycle hooks) and
`ObjectRefGenerator` (_raylet.pyx:273) for streaming returns. Refs are
awaitable (``await ref``), picklable (serialization registers borrows on the
receiving side), and hash/compare by binary id.
"""

from __future__ import annotations

import asyncio
import gc
import threading
from typing import Optional

from ray_tpu_torch._private.ids import ObjectID
from ray_tpu_torch._private.serialization import note_object_ref


class _GlobalState:
    """Holds the process-wide CoreWorker (reference: worker.global_worker)."""

    def __init__(self):
        self.core_worker = None  # CoreWorker | None
        self.lock = threading.RLock()


global_state = _GlobalState()


# The garbage collector finalises a ref held in a cycle inside whatever
# allocation set it off, perhaps while this thread holds the memory store's
# or the reference counter's lock; releasing the ref there would take that
# lock again and deadlock. While a collection runs, releases go to the core
# worker's loop, which runs them between its callbacks.
_collections = 0


def _note_collection(phase, info):
    global _collections
    _collections = _collections + 1 if phase == "start" else max(
        0, _collections - 1)


gc.callbacks.append(_note_collection)


def get_core_worker():
    cw = global_state.core_worker
    if cw is None:
        raise RuntimeError(
            "ray_tpu_torch has not been initialized; call ray_tpu_torch.init() first."
        )
    return cw


def _reconstruct_ref(id_bytes: bytes, owner_address):
    ref = ObjectRef(
        ObjectID(id_bytes), owner_address=owner_address, _deserializing=True
    )
    return ref


class ObjectRef:
    _mutable = ("_id", "_owner_address", "_registered", "call_site")

    def __init__(self, object_id: ObjectID, owner_address=None, *,
                 skip_adding_local_ref: bool = False, _deserializing: bool = False):
        self._id = object_id
        self._owner_address = owner_address
        self._registered = False
        self.call_site = ""
        cw = global_state.core_worker
        if cw is not None and not skip_adding_local_ref:
            if _deserializing:
                cw.register_deserialized_ref(self)
            else:
                cw.reference_counter.add_local_ref(object_id)
            self._registered = True

    # -- identity --
    def object_id(self) -> ObjectID:
        return self._id

    def binary(self) -> bytes:
        return self._id.binary()

    def hex(self) -> str:
        return self._id.hex()

    @property
    def owner_address(self):
        return self._owner_address

    def __eq__(self, other):
        return isinstance(other, ObjectRef) and other._id == self._id

    def __hash__(self):
        return hash(self._id)

    def __repr__(self):
        return f"ObjectRef({self._id.hex()})"

    # -- lifecycle --
    def __del__(self):
        cw = global_state.core_worker
        if cw is not None and self._registered:
            try:
                if _collections:
                    cw._lt.loop.call_soon_threadsafe(
                        cw.reference_counter.remove_local_ref, self._id)
                else:
                    cw.reference_counter.remove_local_ref(self._id)
            except Exception:
                pass

    def __reduce__(self):
        note_object_ref(self)
        return (_reconstruct_ref, (self._id.binary(), self._owner_address))

    # -- sugar --
    def future(self):
        """Return a concurrent.futures.Future resolved with the value."""
        return get_core_worker().as_future(self)

    def __await__(self):
        return get_core_worker().as_asyncio_future(self).__await__()

    def _on_completed(self, callback):
        get_core_worker().on_completed(self, callback)


class ObjectRefGenerator:
    """Iterator over the streamed returns of a generator task
    (reference: _raylet.pyx:273 ObjectRefGenerator / ObjectRefStream in
    task_manager.h:94-98). Yields ObjectRefs as the executor reports items."""

    def __init__(self, task_id, owner_is_self: bool = True):
        self._task_id = task_id
        self._consumed = 0

    def __iter__(self):
        return self

    def __next__(self) -> "ObjectRef":
        cw = get_core_worker()
        ref = cw.next_generator_item(self._task_id, self._consumed, timeout=None)
        if ref is None:
            raise StopIteration
        # raylint: disable=cross-domain-mutation — single-consumer
        # invariant: a generator is drained by exactly one of __next__
        # (caller's thread) or __anext__ (its loop), never both
        self._consumed += 1
        return ref

    def __aiter__(self):
        return self

    async def __anext__(self) -> "ObjectRef":
        cw = get_core_worker()
        loop = asyncio.get_event_loop()
        ref = await loop.run_in_executor(
            None, cw.next_generator_item, self._task_id, self._consumed, None
        )
        if ref is None:
            raise StopAsyncIteration
        self._consumed += 1
        return ref

    def completed(self):
        return self

    def close(self):
        """Stop the producing task AND release owner-side stream state:
        cancel the task so it stops generating items nobody will consume
        (reference: ObjectRefGenerator cancellation via ray.cancel on the
        generator task), then free the reported-but-unconsumed return
        objects and the stream bookkeeping — an abandoned stream must not
        leak its _generators entry, reference-counter rows, or buffered
        values (tests/test_serve_llm.py hygiene test)."""
        try:
            cw = get_core_worker()
        except Exception:  # noqa: BLE001 — ray already shut down
            return
        try:
            cw.cancel_task_by_id(self._task_id, force=False)
        except Exception:  # noqa: BLE001 — best-effort on teardown
            pass
        try:
            cw.release_generator(self._task_id, self._consumed)
        except Exception:  # noqa: BLE001 — best-effort on teardown
            pass

DynamicObjectRefGenerator = ObjectRefGenerator
