"""Runtime lock-order / blocking-call sanitizer (TSan's Python stand-in).

The static half of this invariant lives in tools/raylint (RTL002
lock-order, RTL001 blocking-in-handler); this module watches what the
process actually DOES. When `RAY_TPU_SANITIZE=1` is set before ray_tpu_torch is
imported, `threading.Lock` / `RLock` / `Condition` created from ray_tpu_torch
(or test) code are transparently wrapped so every acquisition is recorded:

* per-thread acquisition stacks — acquiring B while holding A adds the
  edge A->B to a process-global lock-order graph, keyed by the lock's
  CREATION SITE (file:line), so all instances of one lock attribute
  collapse onto a single node like a TSan lock class;
* cycle formation (an edge that closes a path back to the new edge's
  source) raises RuntimeError by default — the acquisition order that
  deadlocks under a different interleaving fails loudly under the test
  that exercised it (`RAY_TPU_SANITIZE_MODE=log` records instead);
* blocking calls on event-loop threads — a CONTENDED `lock.acquire()` or
  a `time.sleep()` while this thread has a running asyncio loop stalls a
  whole component's RPC dispatch; logged + recorded by default
  (`RAY_TPU_SANITIZE_BLOCKING=raise` upgrades to an exception).

Locks created by foreign code (jax, stdlib internals, user libraries) are
NOT wrapped: the factory inspects the creating frame and passes anything
outside ray_tpu_torch/tools/tests/__main__ straight through, so arming the
sanitizer never changes third-party behavior. Known limit of site keying:
two locks created on the SAME source line share one node (acquiring one
inside the other reads as re-entry, not an edge) — create locks on
separate lines, which the codebase already does everywhere.

Zero cost when disarmed: nothing is patched unless install() runs.
"""

from __future__ import annotations

import logging
import os
import sys
import threading
import time
from typing import Dict, List, Optional, Set, Tuple

logger = logging.getLogger(__name__)

ENV_VAR = "RAY_TPU_SANITIZE"
ENV_MODE = "RAY_TPU_SANITIZE_MODE"           # raise (default) | log
ENV_BLOCKING = "RAY_TPU_SANITIZE_BLOCKING"   # log (default) | raise

# original factories (captured at import; install() swaps threading's)
_ORIG_LOCK = threading.Lock
_ORIG_RLOCK = threading.RLock
_ORIG_CONDITION = threading.Condition
_ORIG_SLEEP = time.sleep

# __main__: the user's driver script is part of the system under test —
# its locks participate in the same graph as ray_tpu_torch's (foreign LIBRARY
# modules stay excluded)
_WRAP_MODULE_PREFIXES = ("ray_tpu_torch", "tools.", "tests", "test_", "conftest",
                         "__main__")
_SKIP_FRAME_MODULES = ("threading", "dataclasses", "contextlib",
                       "ray_tpu_torch._private.lock_sanitizer")

_installed = False
_tls = threading.local()   # .held: List[Tuple[site, count]]

# process-global lock-order graph; guarded by a REAL (never-wrapped) lock,
# which is a strict leaf: nothing else is ever acquired under it.
_graph_mu = _ORIG_LOCK()
_edges: Dict[Tuple[str, str], str] = {}       # (a, b) -> first thread name
_adjacency: Dict[str, Set[str]] = {}
_violations: List[dict] = []
# acquire-in-A/release-in-B handoffs (legal for plain Locks): the release
# can't reach A's thread-local stack, so it parks here and A purges the
# phantom entry lazily — without this, A's stack grows a permanent hold
# that fabricates edges and eventually a false cycle.
_orphan_releases: Dict[int, int] = {}         # id(inner lock) -> count


class LockOrderViolation(RuntimeError):
    pass


class BlockingCallViolation(RuntimeError):
    pass


def enabled() -> bool:
    return os.environ.get(ENV_VAR, "") not in ("", "0", "false", "False")


def _mode() -> str:
    return os.environ.get(ENV_MODE, "raise")


def _blocking_mode() -> str:
    return os.environ.get(ENV_BLOCKING, "log")


def is_installed() -> bool:
    return _installed


def violations() -> List[dict]:
    with _graph_mu:
        return list(_violations)


def edges() -> Dict[Tuple[str, str], str]:
    with _graph_mu:
        return dict(_edges)


def reset() -> None:
    """Clear the graph and recorded violations (test isolation)."""
    with _graph_mu:
        _edges.clear()
        _adjacency.clear()
        _violations.clear()
        _orphan_releases.clear()


def held_sites() -> List[str]:
    """Creation sites of the locks the CURRENT thread holds (tests +
    debugging: a phantom entry here means a wrapper missed a release)."""
    return [entry[0] for entry in _held()]


# ---------------------------------------------------------------- internals

def _held() -> List[List]:
    held = getattr(_tls, "held", None)
    if held is None:
        held = _tls.held = []
    return held


def _on_loop_thread() -> bool:
    """True when this thread currently runs an asyncio event loop (i.e. we
    are inside a coroutine/callback on an EventLoopThread)."""
    try:
        import asyncio

        return asyncio.events._get_running_loop() is not None
    except Exception:  # noqa: BLE001 — detection must never break locking
        return False


def _caller_site() -> str:
    """file:line of the first frame outside threading/dataclasses/this
    module — the lock's creation site, its identity in the order graph."""
    f = sys._getframe(2)
    for _ in range(8):
        if f is None:
            break
        mod = f.f_globals.get("__name__", "")
        # empty __name__: dataclass-generated __init__ (exec namespace);
        # keep walking to the real instantiation site
        if mod and not mod.startswith(_SKIP_FRAME_MODULES):
            fn = f.f_code.co_filename
            parts = fn.replace(os.sep, "/").split("/")
            short = "/".join(parts[-2:])
            return f"{short}:{f.f_lineno}"
        f = f.f_back
    return "<unknown>"


def _should_wrap() -> bool:
    f = sys._getframe(2)
    for _ in range(8):
        if f is None:
            return False
        mod = f.f_globals.get("__name__", "")
        if not mod or mod.startswith(_SKIP_FRAME_MODULES):
            f = f.f_back
            continue
        return mod.startswith(_WRAP_MODULE_PREFIXES)
    return False


def _record_violation(kind: str, message: str) -> None:
    with _graph_mu:
        _violations.append({
            "kind": kind,
            "message": message,
            "thread": threading.current_thread().name,
        })


def _purge_orphaned(held: List[List]) -> None:
    """Drop held entries whose lock was released by ANOTHER thread (legal
    handoff for plain Locks); see _orphan_releases."""
    if not _orphan_releases:
        return
    with _graph_mu:
        for i in range(len(held) - 1, -1, -1):
            lock_id = held[i][2]
            pending = _orphan_releases.get(lock_id, 0)
            while pending and held[i][1] > 0:
                held[i][1] -= 1
                pending -= 1
            if pending:
                _orphan_releases[lock_id] = pending
            else:
                _orphan_releases.pop(lock_id, None)
            if held[i][1] <= 0:
                del held[i]


def _note_acquired(site: str, lock_id: int = 0) -> Optional[str]:
    """Update the thread stack + order graph after a successful acquire.
    Returns a cycle message when this acquisition closed a lock-order
    cycle (the caller decides whether to raise — never raises itself, so
    bookkeeping and the OS lock stay consistent)."""
    held = _held()
    _purge_orphaned(held)
    for entry in held:
        if entry[0] == site:   # reentrant (RLock): no new edges
            entry[1] += 1
            return None
    cycle_msg = None
    if held:
        with _graph_mu:
            for outer, _count, _lid in held:
                edge = (outer, site)
                if edge in _edges or outer == site:
                    continue
                # does site already reach outer? then this edge closes a
                # cycle: some other path acquires in the opposite order.
                path = _find_path(site, outer)
                _edges[edge] = threading.current_thread().name
                _adjacency.setdefault(outer, set()).add(site)
                _adjacency.setdefault(site, set())
                if path is not None:
                    chain = " -> ".join([outer, site] + path[1:])
                    cycle_msg = (
                        f"lock-order cycle formed: acquiring {site} while "
                        f"holding {outer}, but the reverse order "
                        f"({chain}) was already observed "
                        f"(thread {threading.current_thread().name!r})")
                    _violations.append({
                        "kind": "lock-order-cycle",
                        "message": cycle_msg,
                        "thread": threading.current_thread().name,
                    })
    held.append([site, 1, lock_id])
    if cycle_msg is not None:
        logger.error("RAY_TPU_SANITIZE: %s", cycle_msg)
    return cycle_msg


def _find_path(src: str, dst: str) -> Optional[List[str]]:
    """BFS path src->dst in the current graph (caller holds _graph_mu)."""
    if src == dst:
        return [src]
    seen = {src}
    frontier = [[src]]
    while frontier:
        nxt = []
        for path in frontier:
            for n in _adjacency.get(path[-1], ()):
                if n == dst:
                    return path + [n]
                if n not in seen:
                    seen.add(n)
                    nxt.append(path + [n])
        frontier = nxt
    return None


def _note_released(site: str, lock_id: int = 0) -> None:
    held = _held()
    for i in range(len(held) - 1, -1, -1):
        if held[i][0] == site:
            held[i][1] -= 1
            if held[i][1] <= 0:
                del held[i]
            return
    # released by a thread that never acquired it: a cross-thread handoff.
    # Park it so the acquiring thread purges its phantom entry lazily.
    if lock_id:
        with _graph_mu:
            _orphan_releases[lock_id] = _orphan_releases.get(lock_id, 0) + 1


def _note_blocking(site: str, what: str) -> None:
    msg = (f"blocking {what} on an event-loop thread "
           f"({threading.current_thread().name!r}) at lock {site}: this "
           f"stalls every RPC the component's loop is multiplexing")
    _record_violation("blocking-on-loop", msg)
    logger.warning("RAY_TPU_SANITIZE: %s", msg)
    if _blocking_mode() == "raise":
        raise BlockingCallViolation(msg)


# ------------------------------------------------------------------ wrappers

class _SanLock:
    """threading.Lock/RLock wrapper feeding the sanitizer. Supports the
    full lock protocol incl. the private hooks Condition needs.
    (Reentrancy needs no flag here: _note_acquired counts repeat
    acquisitions of the same site instead of adding edges.)"""

    __slots__ = ("_inner", "site")

    def __init__(self, inner, site: str):
        self._inner = inner
        self.site = site

    def acquire(self, blocking: bool = True, timeout: float = -1):
        if not blocking:
            ok = self._inner.acquire(False)
            if ok:
                self._post_acquire()
            return ok
        got = self._inner.acquire(False)
        if not got:
            # contended: a blocking wait is about to happen — on an
            # event-loop thread that is the sanitized crime itself
            if _on_loop_thread():
                _note_blocking(self.site, "lock.acquire()")
            if timeout == -1:
                got = self._inner.acquire(True)
            else:
                got = self._inner.acquire(True, timeout)
        if got:
            self._post_acquire()
        return got

    def _post_acquire(self):
        cycle_msg = _note_acquired(self.site, id(self._inner))
        if cycle_msg is not None and _mode() == "raise":
            # back out completely so the failure is a clean exception,
            # not a wedged lock (the `with` block's __exit__ never runs)
            self._inner.release()
            _note_released(self.site)
            raise LockOrderViolation(cycle_msg)

    def release(self):
        self._inner.release()
        _note_released(self.site, id(self._inner))

    def locked(self):
        return self._inner.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def __repr__(self):
        return f"<SanLock {self.site} wrapping {self._inner!r}>"


class _SanCondition:
    """threading.Condition wrapper: acquisition bookkeeping goes through
    the shared _SanLock; wait() reflects the lock's release/re-acquire in
    the thread's stack so the sanitizer never sees phantom holds."""

    def __init__(self, lock=None, site: Optional[str] = None):
        if site is None:
            site = _caller_site()
        if lock is None:
            self._sl = _SanLock(_ORIG_RLOCK(), site)
        elif isinstance(lock, _SanLock):
            self._sl = lock
        else:  # a raw lock from unwrapped code
            self._sl = _SanLock(lock, site)
        self._cv = _ORIG_CONDITION(self._sl._inner)
        self.site = self._sl.site

    # lock protocol (delegates through the sanitized lock)
    def acquire(self, *a, **kw):
        return self._sl.acquire(*a, **kw)

    def release(self):
        self._sl.release()

    def __enter__(self):
        self._sl.acquire()
        return self

    def __exit__(self, *exc):
        self._sl.release()
        return False

    def wait(self, timeout: Optional[float] = None):
        # the OS lock drops during the wait
        _note_released(self._sl.site, id(self._sl._inner))
        try:
            return self._cv.wait(timeout)
        finally:
            _note_acquired(self._sl.site, id(self._sl._inner))

    def wait_for(self, predicate, timeout: Optional[float] = None):
        end = None if timeout is None else time.monotonic() + timeout
        result = predicate()
        while not result:
            remaining = None
            if end is not None:
                remaining = end - time.monotonic()
                if remaining <= 0:
                    break
            self.wait(remaining)
            result = predicate()
        return result

    def notify(self, n: int = 1):
        self._cv.notify(n)

    def notify_all(self):
        self._cv.notify_all()

    def __repr__(self):
        return f"<SanCondition {self.site}>"


# ----------------------------------------------------------------- factories

def _lock_factory():
    if _should_wrap():
        return _SanLock(_ORIG_LOCK(), _caller_site())
    return _ORIG_LOCK()


def _rlock_factory():
    if _should_wrap():
        return _SanLock(_ORIG_RLOCK(), _caller_site())
    return _ORIG_RLOCK()


def _condition_factory(lock=None):
    if _should_wrap() or isinstance(lock, _SanLock):
        return _SanCondition(lock, site=_caller_site())
    return _ORIG_CONDITION(lock)


def _sleep_wrapper(seconds):
    # same scoping promise as the lock factories: only ray_tpu_torch/tools/tests
    # callers are sanitized — a foreign library sleeping on its own loop
    # thread is not ours to police (and must never see our exception)
    if seconds > 0 and _on_loop_thread() and _should_wrap():
        msg = (f"time.sleep({seconds!r}) on an event-loop thread "
               f"({threading.current_thread().name!r}): use asyncio.sleep")
        _record_violation("sleep-on-loop", msg)
        logger.warning("RAY_TPU_SANITIZE: %s", msg)
        if _blocking_mode() == "raise":
            raise BlockingCallViolation(msg)
    return _ORIG_SLEEP(seconds)


# ------------------------------------------------------------------- control

def install() -> None:
    """Arm the sanitizer (idempotent). Locks created BEFORE install keep
    their raw types — arm before building any cluster component (the
    ray_tpu_torch import hook does this when RAY_TPU_SANITIZE=1)."""
    global _installed
    if _installed:
        return
    threading.Lock = _lock_factory
    threading.RLock = _rlock_factory
    threading.Condition = _condition_factory
    time.sleep = _sleep_wrapper
    _installed = True
    logger.info("RAY_TPU_SANITIZE armed: lock-order=%s, blocking=%s",
                _mode(), _blocking_mode())


def uninstall() -> None:
    global _installed
    if not _installed:
        return
    threading.Lock = _ORIG_LOCK
    threading.RLock = _ORIG_RLOCK
    threading.Condition = _ORIG_CONDITION
    time.sleep = _ORIG_SLEEP
    _installed = False


def maybe_install_from_env() -> None:
    if enabled():
        install()
