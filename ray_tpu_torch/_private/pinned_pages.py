"""Host pages that a copy to the card reads at the pinned rate.

A get of a CUDA tensor from the object store copies it from the store's
arena: shared host pages that CUDA sees as pageable, so the driver stages
the copy through a bounce buffer of its own at a fraction of the pinned
rate. `pin_range` registers with CUDA (`cudaHostRegister`) the windows of
the mapping that hold a buffer, fixed WINDOW_BYTES ranges counted from the
mapping's start, each once per process, read-only where the mapping's
pages are (`cudaHostRegisterReadOnly`); `copy_pinned` copies through them
at the pinned rate, one copy a window. A get registers only the windows
its object spans: the store keeps its arena sparse (its capacity is
committed only where objects are written), and registering a window
commits and locks that window's pages, so registering the whole mapping
would commit all of it. On the card (`chip_smoke.py` (t-2), `PERF.md`)
registration beat the two other designs measured there: registering each
object's pages around its copy, and a pinned ring of chunks that the host
copy out of the shared pages holds back.

Only shared mappings of shared memory (the store's memfd arena, a file
under /dev/shm) are registered: a private mapping (the heap, anonymous
memory) is reused by the allocator, and a registration of it would outlive
what it covered. A mapping registered here must stay mapped while it is
registered: the runtime's store never unmaps its arena; whoever maps one
of their own calls `unpin_mapping` before unmapping it. A mapping is found
in /proc/self/maps the first time one of its buffers is pinned, and
remembered. CUDA is reached through `torch.cuda.cudart()`, only when a
copy is made.
"""

from __future__ import annotations

import bisect
import threading
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

# cudaHostRegister flags (cuda_runtime_api.h): portable to every device of
# the process; read-only pages.
HOST_REGISTER_PORTABLE = 0x01
HOST_REGISTER_READ_ONLY = 0x08


class Mapping(NamedTuple):
    """The address range of a mapping of this process, as /proc/self/maps
    lists it (adjacent entries of one file merged)."""
    start: int
    end: int
    shared: bool
    writable: bool
    path: str


def parse_maps(text: str) -> List[Mapping]:
    """The lines of a /proc/<pid>/maps text, in address order, each entry
    of a file's mapping merged with the next when they are adjacent and of
    one file, permissions and sharing."""
    out: List[Mapping] = []
    keys: List[Tuple[str, str, str]] = []
    for line in text.splitlines():
        fields = line.split(maxsplit=5)
        if len(fields) < 5:
            continue
        lo, hi = (int(a, 16) for a in fields[0].split("-"))
        perms, dev, inode = fields[1], fields[3], fields[4]
        path = fields[5].strip() if len(fields) > 5 else ""
        m = Mapping(lo, hi, perms[3] == "s", perms[1] == "w", path)
        key = (dev, inode, perms)
        if (out and inode != "0" and keys[-1] == key
                and out[-1].end == lo):
            out[-1] = out[-1]._replace(end=hi)
            continue
        out.append(m)
        keys.append(key)
    return out


def mapping_of(addr: int, nbytes: int, text: Optional[str] = None
               ) -> Optional[Mapping]:
    """The mapping of this process (or of the maps `text`) that holds all
    of [addr, addr + nbytes), or None."""
    if text is None:
        with open("/proc/self/maps") as f:
            text = f.read()
    for m in parse_maps(text):
        if m.start <= addr and addr + nbytes <= m.end:
            return m
    return None


# Where shared memory is mapped from: a file under /dev/shm, or a memfd
# (the store's arena is "/memfd:ray_tpu_store (deleted)").
SHMEM_PATHS = ("/dev/shm/", "/memfd:")


def registrable(m: Optional[Mapping]) -> bool:
    """Whether `m` is a shared mapping of shared memory: the only kind this
    module registers (CUDA's own mappings of its device files, and file
    pages on disk, are not)."""
    return m is not None and m.shared and m.path.startswith(SHMEM_PATHS)


def _check(err, what: str) -> None:
    cudart = torch.cuda.cudart()
    if err != cudart.cudaError.success:
        raise RuntimeError(f"{what} failed: "
                           f"{cudart.cudaGetErrorString(err)}")


def _register(start: int, size: int, writable: bool) -> None:
    """cudaHostRegister the `size` bytes at `start` (page-aligned),
    read-only unless `writable`; raises on an error."""
    flags = HOST_REGISTER_PORTABLE | (0 if writable else
                                      HOST_REGISTER_READ_ONLY)
    _check(torch.cuda.cudart().cudaHostRegister(start, size, flags),
           f"cudaHostRegister of {size} bytes at {start:#x}")


def _unregister(start: int) -> None:
    """cudaHostUnregister the range registered at `start`."""
    _check(torch.cuda.cudart().cudaHostUnregister(start),
           f"cudaHostUnregister at {start:#x}")


# The size of a registered window: a get of an object commits and locks at
# most this much of the mapping beyond the object's own pages on each side.
WINDOW_BYTES = 64 << 20

# The registrable mappings this process has seen (by start, sorted), and
# the windows registered in each (window start -> end).
_lock = threading.Lock()
_starts: List[int] = []
_mappings: Dict[int, Mapping] = {}
_windows: Dict[int, Dict[int, int]] = {}


def _known(addr: int, nbytes: int) -> Optional[Mapping]:
    i = bisect.bisect_right(_starts, addr) - 1
    if i >= 0:
        m = _mappings[_starts[i]]
        if addr + nbytes <= m.end:
            return m
    return None


def pin_range(addr: int, nbytes: int, find: bool = True
              ) -> Optional[List[Tuple[int, int]]]:
    """[addr, addr + nbytes) (nbytes > 0) split at the window edges of its
    mapping, as (start, end) spans, each in a window registered with CUDA,
    registering the windows not registered yet; None where the range is
    not in a shared mapping of shared memory (`registrable`: nothing
    registered), or, unless `find`, not in one this process has pinned a
    range of before (/proc/self/maps is not read). A registration that
    fails raises."""
    with _lock:
        m = _known(addr, nbytes)
        if m is None:
            if not find:
                return None
            m = mapping_of(addr, nbytes)
            if not registrable(m):
                return None
            bisect.insort(_starts, m.start)
            _mappings[m.start] = m
            _windows[m.start] = {}
        windows = _windows[m.start]
        spans = []
        lo, end = addr, addr + nbytes
        while lo < end:
            w = m.start + (lo - m.start) // WINDOW_BYTES * WINDOW_BYTES
            w_end = min(w + WINDOW_BYTES, m.end)
            if w not in windows:
                _register(w, w_end - w, m.writable)
                windows[w] = w_end
            spans.append((lo, min(end, w_end)))
            lo = w_end
        return spans


def unpin_mapping(addr: int) -> bool:
    """Unregister every registered window of the mapping that holds
    `addr`, and forget the mapping, before it is unmapped. -> whether this
    process had pinned a buffer of it."""
    with _lock:
        m = _known(addr, 1)
        if m is None:
            return False
        for w in sorted(_windows.pop(m.start)):
            _unregister(w)
        _starts.remove(m.start)
        del _mappings[m.start]
        return True


def pinned_windows() -> List[Tuple[int, int, bool]]:
    """(start, end, writable) of the windows registered through
    `pin_range` and not unpinned, in address order."""
    with _lock:
        return [(w, e, _mappings[s].writable) for s in _starts
                for w, e in sorted(_windows[s].items())]


def copy_pinned(dst: torch.Tensor, src: torch.Tensor,
                spans: Optional[List[Tuple[int, int]]] = None
                ) -> torch.Tensor:
    """dst.copy_(src) from pinned memory, or from the registered `spans`
    that cover the contiguous `src` (`pin_range`), one copy a span (a
    single copy across two registrations fails), finished before this
    returns (the host pages may be reused as soon as it has)."""
    if spans is None or len(spans) == 1:
        dst.copy_(src, non_blocking=True)
    else:
        out = dst.reshape(-1).view(torch.uint8)
        host = src.reshape(-1).view(torch.uint8)
        base = src.data_ptr()
        for lo, hi in spans:
            out[lo - base:hi - base].copy_(host[lo - base:hi - base],
                                           non_blocking=True)
    torch.cuda.current_stream(dst.device).synchronize()
    return dst
