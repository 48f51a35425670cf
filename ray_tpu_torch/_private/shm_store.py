"""ctypes binding for the C++ shared-memory object store.

Python face of ray_tpu_torch/_native/src/shm_store.cc — the node-local plasma
equivalent (reference: ray src/ray/object_manager/plasma/client.cc, store
protocol plasma/protocol.cc).  `StoreClient.get` returns a zero-copy
memoryview over the shared arena; `SerializedObject.from_bytes` keeps that
zero-copy end to end, so a large numpy array or CPU tensor read from the
store is a view of the arena, and a CUDA tensor is one host-to-device copy
from it at the pinned rate (`serialization._to_card`).
"""

from __future__ import annotations

import ctypes
import threading
import weakref
from typing import List, Optional, Tuple

from ray_tpu_torch._native import try_build_library

# Status codes (shm_store.cc enum Status).
ST_OK = 0
ST_FULL = -1
ST_EXISTS = -2
ST_NOT_FOUND = -3
ST_TIMEOUT = -4
ST_NOT_SEALED = -5
ST_ERR = -6

FLAG_PRIMARY = 1

_lib = None
_lib_failed = False


class ShmStoreError(RuntimeError):
    pass


class ShmStoreFull(ShmStoreError):
    pass


def _load():
    global _lib, _lib_failed
    if _lib is not None or _lib_failed:
        return _lib
    path = try_build_library("shm_store")
    if path is None:
        _lib_failed = True
        return None
    lib = ctypes.CDLL(path)
    lib.rtps_server_start.restype = ctypes.c_void_p
    lib.rtps_server_start.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
    lib.rtps_server_stop.argtypes = [ctypes.c_void_p]
    lib.rtps_client_connect.restype = ctypes.c_void_p
    lib.rtps_client_connect.argtypes = [ctypes.c_char_p]
    lib.rtps_client_disconnect.argtypes = [ctypes.c_void_p]
    lib.rtps_client_close_socket.argtypes = [ctypes.c_void_p]
    lib.rtps_client_prefault.argtypes = [ctypes.c_void_p]
    lib.rtps_client_base.restype = ctypes.POINTER(ctypes.c_ubyte)
    lib.rtps_client_base.argtypes = [ctypes.c_void_p]
    u64p = ctypes.POINTER(ctypes.c_uint64)
    lib.rtps_create.restype = ctypes.c_int64
    lib.rtps_create.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                ctypes.c_uint64, ctypes.c_uint64, u64p]
    lib.rtps_seal.restype = ctypes.c_int64
    lib.rtps_seal.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.rtps_get.restype = ctypes.c_int64
    lib.rtps_get.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                             ctypes.c_uint64, u64p, u64p]
    for fn in ("rtps_release", "rtps_delete", "rtps_abort"):
        getattr(lib, fn).restype = ctypes.c_int64
        getattr(lib, fn).argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.rtps_contains.restype = ctypes.c_int64
    lib.rtps_contains.argtypes = [ctypes.c_void_p, ctypes.c_char_p, u64p]
    lib.rtps_stats.restype = ctypes.c_int64
    lib.rtps_stats.argtypes = [ctypes.c_void_p, u64p, u64p]
    lib.rtps_list.restype = ctypes.c_int64
    lib.rtps_list.argtypes = [ctypes.c_void_p, ctypes.c_uint64,
                              ctypes.c_uint64, ctypes.c_char_p]
    lib.rtps_free_info.restype = ctypes.c_int64
    lib.rtps_free_info.argtypes = [ctypes.c_void_p, u64p, u64p]
    # SPSC channels (client-side atomics; see shm_store.cc ChanHeader)
    lib.rtps_chan_region_size.restype = ctypes.c_uint64
    lib.rtps_chan_region_size.argtypes = [ctypes.c_uint64, ctypes.c_uint64]
    lib.rtps_chan_init.restype = ctypes.c_int64
    lib.rtps_chan_init.argtypes = [ctypes.c_void_p, ctypes.c_uint64,
                                   ctypes.c_uint64, ctypes.c_uint64]
    lib.rtps_chan_send.restype = ctypes.c_int64
    lib.rtps_chan_send.argtypes = [ctypes.c_void_p, ctypes.c_uint64,
                                   ctypes.c_uint64, ctypes.c_char_p,
                                   ctypes.c_uint64, ctypes.c_uint64]
    lib.rtps_chan_recv.restype = ctypes.c_int64
    lib.rtps_chan_recv.argtypes = [ctypes.c_void_p, ctypes.c_uint64,
                                   ctypes.c_uint64, ctypes.c_char_p,
                                   ctypes.c_uint64, u64p, u64p, u64p]
    lib.rtps_chan_recv_acquire.restype = ctypes.c_int64
    lib.rtps_chan_recv_acquire.argtypes = [ctypes.c_void_p, ctypes.c_uint64,
                                           ctypes.c_uint64, u64p, u64p]
    lib.rtps_chan_recv_release.restype = ctypes.c_int64
    lib.rtps_chan_recv_release.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.rtps_chan_close.restype = ctypes.c_int64
    lib.rtps_chan_close.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.rtps_chan_geometry.restype = ctypes.c_int64
    lib.rtps_chan_geometry.argtypes = [ctypes.c_void_p, ctypes.c_uint64,
                                       u64p, u64p]
    _lib = lib
    return lib


def native_store_available() -> bool:
    return _load() is not None


def _pad_id(object_id: bytes) -> bytes:
    """Store ids are exactly 16 bytes; ray_tpu_torch ObjectIDs are 28 bytes
    (task_id(24) + return index(4), SURVEY §2.1 id layout) so a prefix is NOT
    unique — map through a 16-byte keyed digest, deterministic across
    processes."""
    if len(object_id) == 16:
        return bytes(object_id)
    import hashlib

    return hashlib.blake2b(bytes(object_id), digest_size=16).digest()


class StoreServer:
    """In-process store server (hosted by the raylet, like plasma inside the
    raylet process — reference: plasma/store_runner.cc)."""

    def __init__(self, socket_path: str, capacity: int):
        lib = _load()
        if lib is None:
            raise ShmStoreError("native store unavailable (no toolchain)")
        self._lib = lib
        self._handle = lib.rtps_server_start(
            socket_path.encode(), ctypes.c_uint64(capacity))
        if not self._handle:
            raise ShmStoreError(f"failed to start store at {socket_path}")
        self.socket_path = socket_path
        self.capacity = capacity

    def stop(self):
        if self._handle:
            self._lib.rtps_server_stop(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.stop()
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass


class StoreClient:
    def __init__(self, socket_path: str):
        lib = _load()
        if lib is None:
            raise ShmStoreError("native store unavailable (no toolchain)")
        self._lib = lib
        self._handle = lib.rtps_client_connect(socket_path.encode())
        if not self._handle:
            raise ShmStoreError(f"failed to connect to store {socket_path}")
        self._base = lib.rtps_client_base(self._handle)
        self._closed = False

    def prefault(self) -> None:
        """Fault the whole arena into this process's page table
        (background thread, idempotent). Zero-fill of fresh shmem pages
        runs at ~1 GB/s regardless of mechanism, so the only real win is
        paying it ONCE per long-lived process — after which big puts run
        at memcpy speed (~5-6 GB/s vs ~1.2 cold). Opt-in by design
        (RT_STORE_PREFAULT=1 drives the callers): populating the full
        capacity on every cluster init melts a farm of short-lived test
        clusters."""
        if self._handle and not self._closed:
            self._lib.rtps_client_prefault(self._handle)

    def disconnect(self):
        """Close the control socket. The server then releases every ref this
        client held — so ONLY disconnect when no zero-copy views are alive
        (process teardown, test fixtures): a released slot can be reused and
        silently mutate a still-alive aliasing array. Long-lived runtimes
        should leave the connection open (see PlasmaProvider.close) and let
        process exit sever it. The arena stays mapped and the native handle
        is intentionally leaked so late pin-finalizer calls stay safe."""
        if self._handle and not self._closed:
            self._closed = True
            self._lib.rtps_client_close_socket(self._handle)

    close_socket = disconnect

    def __del__(self):
        try:
            self.disconnect()
        except Exception:  # noqa: BLE001
            pass

    # -- object ops ---------------------------------------------------------

    @staticmethod
    def _release_pin(client: "StoreClient", key: bytes) -> None:
        """GC finalizer: the last zero-copy view of an object died; drop the
        server-side ref so the slot becomes evictable/deletable."""
        try:
            if not client._closed:
                client._lib.rtps_release(client._handle, key)
        except Exception:  # noqa: BLE001 — GC context, never raise
            pass

    def _view(self, offset: int, size: int, readonly: bool,
              pin_key: Optional[bytes] = None) -> memoryview:
        buf_t = ctypes.c_ubyte * size
        buf = buf_t.from_address(
            ctypes.addressof(self._base.contents) + offset)
        if pin_key is not None:
            # Tie the store ref to the buffer object's lifetime: numpy views
            # deserialized zero-copy keep `buf` alive through their .base
            # chain, so the ref is released exactly when the last user value
            # dies — never before (use-after-free) nor later (arena leak).
            weakref.finalize(buf, StoreClient._release_pin, self, pin_key)
        view = memoryview(buf).cast("B")
        return view.toreadonly() if readonly else view

    def create(self, object_id: bytes, size: int,
               primary: bool = True) -> memoryview:
        """Allocate a writable buffer; must be followed by seal()."""
        off = ctypes.c_uint64()
        st = self._lib.rtps_create(
            self._handle, _pad_id(object_id), ctypes.c_uint64(size),
            ctypes.c_uint64(FLAG_PRIMARY if primary else 0),
            ctypes.byref(off))
        if st == ST_FULL:
            raise ShmStoreFull(f"store full creating {size} bytes")
        if st == ST_EXISTS:
            raise ShmStoreError("object already exists")
        if st != ST_OK:
            raise ShmStoreError(f"create failed: {st}")
        return self._view(off.value, size, readonly=False)

    def create_raw(self, object_id: bytes, size: int,
                   primary: bool = True) -> int:
        """Like create() but returns the arena OFFSET of the writable
        region (channel setup needs the offset before sealing)."""
        off = ctypes.c_uint64()
        st = self._lib.rtps_create(
            self._handle, _pad_id(object_id), ctypes.c_uint64(size),
            ctypes.c_uint64(FLAG_PRIMARY if primary else 0),
            ctypes.byref(off))
        if st == ST_FULL:
            raise ShmStoreFull(f"store full creating {size} bytes")
        if st == ST_EXISTS:
            raise ShmStoreError("object already exists")
        if st != ST_OK:
            raise ShmStoreError(f"create failed: {st}")
        return int(off.value)

    def seal(self, object_id: bytes) -> None:
        st = self._lib.rtps_seal(self._handle, _pad_id(object_id))
        if st != ST_OK:
            raise ShmStoreError(f"seal failed: {st}")

    def put(self, object_id: bytes, data, primary: bool = True) -> None:
        view = self.create(object_id, len(data), primary=primary)
        view[:] = data
        self.seal(object_id)
        self.release(object_id)

    def get(self, object_id: bytes,
            timeout_ms: Optional[int] = 0) -> Optional[memoryview]:
        """Zero-copy read-only view, or None on timeout/absent.

        The store ref is auto-released when the returned view (and anything
        aliasing it, e.g. zero-copy numpy arrays) is garbage collected; an
        earlier explicit release(id) is allowed and idempotent.
        """
        off = ctypes.c_uint64()
        size = ctypes.c_uint64()
        t = (2**64 - 1) if timeout_ms is None else int(timeout_ms)
        key = _pad_id(object_id)
        st = self._lib.rtps_get(
            self._handle, key, ctypes.c_uint64(t),
            ctypes.byref(off), ctypes.byref(size))
        if st in (ST_TIMEOUT, ST_NOT_FOUND):
            return None
        if st != ST_OK:
            raise ShmStoreError(f"get failed: {st}")
        return self._view(off.value, size.value, readonly=True, pin_key=key)

    def get_raw(self, object_id: bytes,
                timeout_ms: Optional[int] = 0
                ) -> Optional[Tuple[int, int]]:
        """Like get() but returns the (arena_offset, size) of the object
        instead of a view, holding a store ref until an explicit
        release(id). Channel endpoints use this: the offset feeds the
        rtps_chan_* client-side ops."""
        off = ctypes.c_uint64()
        size = ctypes.c_uint64()
        t = (2**64 - 1) if timeout_ms is None else int(timeout_ms)
        st = self._lib.rtps_get(
            self._handle, _pad_id(object_id), ctypes.c_uint64(t),
            ctypes.byref(off), ctypes.byref(size))
        if st in (ST_TIMEOUT, ST_NOT_FOUND):
            return None
        if st != ST_OK:
            raise ShmStoreError(f"get failed: {st}")
        return int(off.value), int(size.value)

    def view_at(self, offset: int, size: int,
                readonly: bool = True) -> memoryview:
        """Raw arena view (channel slot access); no ref management."""
        return self._view(offset, size, readonly=readonly)

    # -- channel ops (SPSC rings inside sealed objects) ---------------------

    def chan_region_size(self, slot_size: int, n_slots: int) -> int:
        return int(self._lib.rtps_chan_region_size(
            ctypes.c_uint64(slot_size), ctypes.c_uint64(n_slots)))

    def chan_init(self, offset: int, slot_size: int, n_slots: int) -> None:
        st = self._lib.rtps_chan_init(
            self._handle, ctypes.c_uint64(offset),
            ctypes.c_uint64(slot_size), ctypes.c_uint64(n_slots))
        if st != ST_OK:
            raise ShmStoreError(f"chan_init failed: {st}")

    def chan_send(self, offset: int, kind: int, data,
                  timeout_ms: Optional[int]) -> int:
        t = (2**64 - 1) if timeout_ms is None else int(timeout_ms)
        return int(self._lib.rtps_chan_send(
            self._handle, ctypes.c_uint64(offset), ctypes.c_uint64(kind),
            bytes(data), ctypes.c_uint64(len(data)), ctypes.c_uint64(t)))

    def chan_recv_acquire(self, offset: int, timeout_ms: Optional[int]
                          ) -> Tuple[int, Optional[Tuple[int, int]]]:
        """-> (status, (payload_offset, length) | None)."""
        t = (2**64 - 1) if timeout_ms is None else int(timeout_ms)
        poff = ctypes.c_uint64()
        plen = ctypes.c_uint64()
        st = int(self._lib.rtps_chan_recv_acquire(
            self._handle, ctypes.c_uint64(offset), ctypes.c_uint64(t),
            ctypes.byref(poff), ctypes.byref(plen)))
        if st != ST_OK:
            return st, None
        return st, (int(poff.value), int(plen.value))

    def chan_recv(self, offset: int, buf, timeout_ms: Optional[int]
                  ) -> Tuple[int, int, int, int]:
        """One-call receive into `buf` (a ctypes char buffer):
        -> (status, length, kind, released). released=0 means the caller
        must chan_recv_release() after consuming (spilled messages)."""
        t = (2**64 - 1) if timeout_ms is None else int(timeout_ms)
        ln = ctypes.c_uint64()
        kind = ctypes.c_uint64()
        rel = ctypes.c_uint64()
        st = int(self._lib.rtps_chan_recv(
            self._handle, ctypes.c_uint64(offset), ctypes.c_uint64(t),
            buf, ctypes.c_uint64(len(buf)), ctypes.byref(ln),
            ctypes.byref(kind), ctypes.byref(rel)))
        return st, int(ln.value), int(kind.value), int(rel.value)

    def chan_recv_release(self, offset: int) -> None:
        self._lib.rtps_chan_recv_release(
            self._handle, ctypes.c_uint64(offset))

    def chan_close(self, offset: int) -> None:
        self._lib.rtps_chan_close(self._handle, ctypes.c_uint64(offset))

    def chan_geometry(self, offset: int) -> Tuple[int, int]:
        """-> (slot_size, n_slots) from the ring header."""
        ss = ctypes.c_uint64()
        ns = ctypes.c_uint64()
        st = self._lib.rtps_chan_geometry(
            self._handle, ctypes.c_uint64(offset),
            ctypes.byref(ss), ctypes.byref(ns))
        if st != ST_OK:
            raise ShmStoreError(f"chan_geometry failed: {st}")
        return int(ss.value), int(ns.value)

    def release(self, object_id: bytes) -> None:
        self._lib.rtps_release(self._handle, _pad_id(object_id))

    def delete(self, object_id: bytes) -> None:
        self._lib.rtps_delete(self._handle, _pad_id(object_id))

    def abort(self, object_id: bytes) -> None:
        self._lib.rtps_abort(self._handle, _pad_id(object_id))

    def contains(self, object_id: bytes) -> bool:
        size = ctypes.c_uint64()
        return self._lib.rtps_contains(
            self._handle, _pad_id(object_id), ctypes.byref(size)) == ST_OK

    def size_of(self, object_id: bytes) -> Optional[int]:
        """Sealed object's byte size, or None when absent (the CONTAINS
        reply already carries it — no pin, unlike get)."""
        size = ctypes.c_uint64()
        if self._lib.rtps_contains(
                self._handle, _pad_id(object_id), ctypes.byref(size)) != ST_OK:
            return None
        return int(size.value)

    def stats(self) -> Tuple[int, int, int]:
        """-> (num_objects, bytes_used, bytes_capacity)."""
        used = ctypes.c_uint64()
        cap = ctypes.c_uint64()
        n = self._lib.rtps_stats(self._handle, ctypes.byref(used),
                                 ctypes.byref(cap))
        return int(n), int(used.value), int(cap.value)

    def list_ids(self, max_ids: int = 4096,
                 primaries: bool = True) -> List[bytes]:
        """Sealed, unreferenced object ids, LRU-first (spill candidates when
        primaries=True; evictable caches when False)."""
        buf = ctypes.create_string_buffer(max_ids * 16)
        n = self._lib.rtps_list(
            self._handle, ctypes.c_uint64(max_ids),
            ctypes.c_uint64(1 if primaries else 0), buf)
        if n < 0:
            raise ShmStoreError(f"list failed: {n}")
        return [buf.raw[i * 16:(i + 1) * 16] for i in range(n)]

    def free_info(self) -> Tuple[int, int, int]:
        """Arena free-list shape -> (num_holes, largest_hole_bytes,
        total_free_bytes). Fragmentation = 1 - largest/total: a put needs
        ONE contiguous hole, so a full-looking arena with many small holes
        rejects large creates while stats() still shows headroom."""
        largest = ctypes.c_uint64()
        total = ctypes.c_uint64()
        n = self._lib.rtps_free_info(self._handle, ctypes.byref(largest),
                                     ctypes.byref(total))
        if n < 0:
            raise ShmStoreError(f"free_info failed: {n}")
        return int(n), int(largest.value), int(total.value)
