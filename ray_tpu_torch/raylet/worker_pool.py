"""Raylet worker pool: spawn, register, lease, reap worker processes.

Role of the reference's WorkerPool (ray: src/ray/raylet/worker_pool.h:155):
starts `default_worker` subprocesses, matches lease requests to idle workers,
prestarts spares, kills workers idle beyond the timeout, and watches child
exits so the raylet can report worker/actor deaths.

A worker's flavour is the set of cards it is bound to (`cards`, indices
into the node's allotment; () for a plain worker). A card worker is a fresh
spawn with CUDA_VISIBLE_DEVICES naming exactly its cards, since the first
CUDA call fixes what a process sees and a CUDA context does not survive a
fork; it serves only leases granted the same cards. Plain workers fork from
the zygote.
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import signal
import subprocess
import sys
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Mapping, Optional, Tuple

from ray_tpu_torch._private import event_log
from ray_tpu_torch._private.config import CONFIG
from ray_tpu_torch._private.ids import WorkerID
from ray_tpu_torch._private.specs import Address

logger = logging.getLogger(__name__)


class _ForkedProc:
    """Popen-like shim for zygote-forked workers. They are the ZYGOTE's
    children, not ours, so poll() probes liveness with signal 0; the real
    exit code arrives via the zygote's exit report (reader sets
    `returncode`). A just-died worker stays a zombie until the zygote
    reaps it, so the probe flips only at/after the report — the grace
    window below covers a zygote that died without reporting."""

    def __init__(self, pid: int):
        self.pid = pid
        self.returncode: Optional[int] = None
        self._gone_since = 0.0
        # Flipped off once the zygote is gone (pool shutdown, zygote
        # crash): no exit report can arrive anymore, so the grace window
        # below would only stall every waiter by 0.5s per worker — the
        # dominant cost of cluster shutdown before this flag existed.
        self.report_expected = True

    def poll(self) -> Optional[int]:
        if self.returncode is not None:
            return self.returncode
        try:
            os.kill(self.pid, 0)
            return None
        except ProcessLookupError:
            if not self.report_expected:
                self.returncode = -1
                return self.returncode
            now = time.monotonic()
            if not self._gone_since:
                self._gone_since = now
                return None
            if now - self._gone_since < 0.5:
                return None  # give the exit report time to land
            self.returncode = -1
            return self.returncode
        except PermissionError:  # pid reused by another user: treat alive
            return None

    def terminate(self):
        try:
            os.kill(self.pid, signal.SIGTERM)
        except ProcessLookupError:
            pass

    def kill(self):
        try:
            os.kill(self.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass

    def wait(self, timeout: Optional[float] = None) -> Optional[int]:
        deadline = None if timeout is None else time.monotonic() + timeout
        while self.poll() is None:
            if deadline is not None and time.monotonic() >= deadline:
                raise subprocess.TimeoutExpired("zygote-forked worker",
                                                timeout)
            time.sleep(0.02)
        return self.returncode


@dataclass
class WorkerHandle:
    worker_id: Optional[WorkerID] = None
    pid: int = 0
    address: Optional[Address] = None
    proc: Optional[subprocess.Popen] = None
    state: str = "starting"  # starting | idle | leased | actor | dead
    idle_since: float = field(default_factory=time.monotonic)
    actor_id = None
    lease_task_id = None
    is_driver: bool = False
    # card indices this worker is bound to (its CUDA_VISIBLE_DEVICES); ()
    # for a plain worker. Fixed at spawn: it serves only leases of these.
    cards: Tuple[int, ...] = ()
    log_path: str = ""  # stdout+stderr file (tailed by the raylet monitor)
    last_job_hex: Optional[str] = None  # job of the latest lease
    # (file_offset, job_hex) marks appended when the leased job CHANGES:
    # log attribution is by WRITE position, so a re-leased worker's old
    # output still goes to the job that produced it.
    job_marks: list = field(default_factory=list)
    marks_lock: threading.Lock = field(default_factory=threading.Lock)
    dead_since: float = 0.0  # monotonic time the reaper saw the exit

    def mark_job(self, job_hex: Optional[str]) -> None:
        if job_hex == self.last_job_hex:
            return
        self.last_job_hex = job_hex
        offset = 0
        if self.log_path:
            try:
                offset = os.path.getsize(self.log_path)
            except OSError:
                pass
        with self.marks_lock:
            self.job_marks.append((offset, job_hex))
            # Bounded: the log monitor prunes consumed marks; if 64+ job
            # switches pile up between scans (GCS publish outage), collapse
            # the two OLDEST marks into one unattributed (job=None) region.
            # The monitor skips None regions rather than shipping them —
            # bounded loss of the oldest unshipped lines, never a cross-job
            # misattribution.
            while len(self.job_marks) > 64:
                self.job_marks[0:2] = [(self.job_marks[0][0], None)]

    def prune_job_marks(self, base_off: int) -> None:
        """Drop marks strictly older than the last one at/below
        ``base_off`` (the log monitor's uncommitted read offset). The
        monitor calls this from a worker thread while mark_job mutates on
        the event loop — marks_lock serializes both."""
        with self.marks_lock:
            marks = self.job_marks
            keep = 0
            for i in range(len(marks)):
                if marks[i][0] <= base_off:
                    keep = i
                else:
                    break
            if keep > 0:
                del marks[:keep]
    # Registration rendezvous: a zygote fork registers before its pid
    # reaches the pool, so registration matches on this token (passed via
    # RT_SPAWN_TOKEN) where the pid misses.
    spawn_token: str = ""
    # True for fresh interpreter spawns (card workers, zygote down);
    # False for zygote forks. Startup caps are per-mechanism: forks are
    # ~ms-cheap, full boots are not.
    direct_spawn: bool = True
    # Set when the RAYLET kills this worker to reclaim resources (bundle
    # cancel, drain deadline, OOM policy): the death report must read as
    # UNINTENDED so the GCS restart FSM re-places the actor, even though
    # SIGTERM makes the worker exit 0.
    evicted: bool = False


class WorkerPool:
    def __init__(
        self,
        node_id_hex: str,
        raylet_address: str,
        gcs_address: str,
        loop: asyncio.AbstractEventLoop,
        max_workers: int,
        log_dir: str,
        on_worker_death: Callable,
        env: Optional[dict] = None,
        accelerator_env: Optional[Mapping[str, str]] = None,
    ):
        self._node_id_hex = node_id_hex
        self._elog = event_log.logger_for("raylet", node_id_hex[:12])
        self._raylet_address = raylet_address
        self._gcs_address = gcs_address
        self._loop = loop
        self._max_workers = max_workers
        self._log_dir = log_dir
        self._on_worker_death = on_worker_death
        self._extra_env = env or {}
        # whose CUDA_VISIBLE_DEVICES allots the node its cards (None: the
        # workers' own environment)
        self._accelerator_env = accelerator_env
        self._workers: Dict[int, WorkerHandle] = {}  # pid -> handle
        self._registered: Dict[WorkerID, WorkerHandle] = {}
        self._pop_waiters = 0
        self._plain_waiters = 0
        # one waiter per in-flight pop_worker: bounded upstream by the
        # raylet lease queue bound (raylet_lease_queue_max)
        self._waiters: "deque[asyncio.Future]" = deque()  # raylint: disable=unbounded-queue
        self._monitor_task: Optional[asyncio.Task] = None
        self._closed = False
        # fork-server for plain workers (see workers/zygote.py)
        self._zygote: Optional[subprocess.Popen] = None
        self._pending_forks: Dict[str, WorkerHandle] = {}  # token -> handle
        self._zygote_failures = 0  # crash-looping zygote disables itself
        # set by the raylet once the shm store is up: spawned workers read
        # it from RT_STORE_SOCKET and register one-way (no reply needed)
        self.store_socket: Optional[str] = None
        os.makedirs(log_dir, exist_ok=True)

    def _emit_state(self, handle: "WorkerHandle", **extra) -> None:
        """Record a worker-handle FSM transition in the lifecycle event
        log (idle/leased/actor/dead — the states post-mortems need to tie
        a task's worker to its fate)."""
        self._elog.emit(
            "worker.state", node_id=self._node_id_hex,
            actor_id=handle.actor_id.hex() if handle.actor_id else None,
            state=handle.state, pid=handle.pid,
            worker_id=handle.worker_id.hex() if handle.worker_id else "",
            **extra)

    def start(self):
        self._monitor_task = self._loop.create_task(self._monitor_loop())
        for _ in range(CONFIG.worker_pool_prestart):
            self._spawn()

    @property
    def num_alive(self) -> int:
        return sum(1 for w in self._workers.values() if w.state != "dead")

    @property
    def num_poolable(self) -> int:
        """Workers that can (eventually) serve future leases. Workers
        dedicated to a live actor leave the pool accounting — like the
        reference's soft limit, which bounds spare/idle workers, not
        actor-dedicated processes (worker_pool.h:155 num_workers_soft_limit);
        otherwise a node could host at most max_workers actors."""
        return sum(1 for w in self._workers.values()
                   if w.state in ("starting", "idle", "leased")
                   and not w.is_driver)

    # ----------------------------------------------------- zygote fork-server
    def _worker_base_env(self, cards: Tuple[int, ...] = ()) -> dict:
        env = dict(os.environ)
        # Let spawned processes cache bytecode: with the flag inherited
        # from a CI environment, every direct-spawn worker re-parses the
        # whole package (~40ms of compile per process at 1k-worker scale).
        env.pop("PYTHONDONTWRITEBYTECODE", None)
        # head-process diagnostics only: profiling every worker's loops
        # would smother a busy host
        env.pop("RT_LOOP_PROFILE_DIR", None)
        env.update(self._extra_env)
        # bound before the worker's first CUDA call: a card worker sees its
        # cards as cuda:0, cuda:1, ... and no other; a plain worker (and
        # the zygote, whose forks are plain) sees none, so it cannot reach
        # a card outside the lease accounting
        from ray_tpu_torch._private.accelerators import nvidia

        env["CUDA_VISIBLE_DEVICES"] = nvidia.visible_devices_env(
            cards, self._accelerator_env or env)["CUDA_VISIBLE_DEVICES"]
        env["RT_SYSTEM_CONFIG"] = CONFIG.serialized_overrides()
        return env

    def _ensure_zygote(self) -> bool:
        if self._zygote is not None and self._zygote.poll() is None:
            return True
        if not CONFIG.enable_worker_zygote or self._closed:
            return False
        if self._zygote_failures >= 3:
            # crash-looping (bad install, import error): stop restarting it
            # every spawn attempt and let direct spawns carry the node
            return False
        cmd = [
            sys.executable, "-m", "ray_tpu_torch._private.workers.zygote",
            "--raylet-address", self._raylet_address,
            "--gcs-address", self._gcs_address,
            "--node-id", self._node_id_hex,
        ]
        zlog = open(os.path.join(self._log_dir, "zygote.log"), "ab")
        try:
            self._zygote = subprocess.Popen(
                cmd, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                stderr=zlog, env=self._worker_base_env(),
                start_new_session=True)
        except Exception:  # noqa: BLE001 — fall back to direct spawns
            logger.exception("zygote start failed; using direct spawns")
            self._zygote = None
            return False
        finally:
            zlog.close()
        self._loop.create_task(self._zygote_reader(self._zygote))
        return True

    async def _zygote_reader(self, z: subprocess.Popen):
        """Consume spawn/exit reports from one zygote process."""
        while True:
            try:
                line = await asyncio.to_thread(z.stdout.readline)
            except RuntimeError:
                # loop's default executor already shut down (raylet
                # teardown racing this reader): nothing left to read for
                return
            if not line:
                break
            try:
                msg = json.loads(line)
            except ValueError:
                continue
            if "spawned" in msg:
                self._zygote_failures = 0  # forking ⇒ healthy zygote
                handle = self._pending_forks.pop(msg.get("token", ""), None)
                if handle is None:
                    continue
                handle.proc = _ForkedProc(msg["spawned"])
                handle.pid = msg["spawned"]
                for key, h in list(self._workers.items()):
                    if h is handle and key != handle.pid:
                        # raylint: disable=cross-domain-mutation —
                        # loop-confined: every _workers mutation runs on
                        # the raylet loop (reader/monitor/finish
                        # coroutines, register_* from raylet handlers);
                        # shutdown() on the driver thread only snapshots
                        # values and terminates processes
                        del self._workers[key]
                        break
                self._workers[handle.pid] = handle
                if self._closed:
                    handle.proc.terminate()
            elif "exited" in msg:
                handle = self._workers.get(msg["exited"])
                if handle is not None and isinstance(handle.proc,
                                                    _ForkedProc):
                    # monitor loop picks this up and runs death handling
                    handle.proc.returncode = msg.get("status", -1)
        # zygote gone: drop pending forks so their waiters respawn direct
        if self._zygote is z:
            # raylint: disable=cross-domain-mutation — benign converging
            # check-then-set: the only other writer is shutdown() (driver
            # thread), and both racers write None; terminate() on an
            # already-dead zygote is caught there
            self._zygote = None
            for h in self._workers.values():
                # Its exit reports die with it; see _ForkedProc.poll.
                if isinstance(h.proc, _ForkedProc):
                    h.proc.report_expected = False
        if not self._closed:
            self._zygote_failures += 1
            if self._zygote_failures >= 3:
                logger.error(
                    "worker zygote died %d times; disabling the "
                    "fork-server for this node (direct spawns only)",
                    self._zygote_failures)
        for token, handle in list(self._pending_forks.items()):
            del self._pending_forks[token]
            for key, h in list(self._workers.items()):
                if h is handle:
                    del self._workers[key]
                    break
        self._wake_waiters()

    def _spawn_via_zygote(self, token: str, log_path: str,
                          handle: WorkerHandle) -> bool:
        if not self._ensure_zygote():
            return False
        spawn_env = {"RT_SPAWN_TOKEN": token,
                     "RT_SYSTEM_CONFIG": CONFIG.serialized_overrides()}
        if self.store_socket:
            spawn_env["RT_STORE_SOCKET"] = self.store_socket
        req = {"spawn": {"token": token, "log_path": log_path,
                         "env": spawn_env}}
        try:
            self._zygote.stdin.write((json.dumps(req) + "\n").encode())
            self._zygote.stdin.flush()
        except Exception:  # noqa: BLE001 — broken pipe etc.
            logger.warning("zygote write failed; using direct spawn")
            return False
        self._pending_forks[token] = handle
        return True

    def _spawn(self, cards: Tuple[int, ...] = ()):
        if self._closed:
            return
        token = f"{self._node_id_hex[:8]}-{time.monotonic_ns()}"
        log_path = os.path.join(
            self._log_dir, f"worker-{time.monotonic_ns()}.log")
        # The placeholder handle keeps spawn gating exact (_num_starting
        # counts it immediately); it is re-keyed to the real pid once the
        # process exists.
        placeholder_key = -time.monotonic_ns()
        handle = WorkerHandle(
            pid=0, proc=None, state="starting", cards=tuple(cards),
            log_path=log_path, spawn_token=token,
        )
        self._workers[placeholder_key] = handle

        # Plain workers fork from the preimported zygote (~10-30ms); card
        # workers are fresh spawns below: CUDA_VISIBLE_DEVICES must be set
        # before the process's first CUDA call, and a CUDA context does
        # not survive a fork.
        if not cards and self._spawn_via_zygote(token, log_path, handle):
            handle.direct_spawn = False
            return

        env = self._worker_base_env(cards)
        env["RT_SPAWN_TOKEN"] = token
        env["RT_WORKER_LOG_PATH"] = log_path  # for self-rotation
        if self.store_socket:
            env["RT_STORE_SOCKET"] = self.store_socket
        # Keep worker start light: no torch or CUDA init at import time.
        cmd = [
            sys.executable,
            "-m",
            "ray_tpu_torch._private.workers.default_worker",
            "--raylet-address", self._raylet_address,
            "--gcs-address", self._gcs_address,
            "--node-id", self._node_id_hex,
        ]
        # The fork/exec itself runs OFF the event loop: on a loaded box a
        # Popen can take tens of ms, and a burst of spawns on the loop
        # starves heartbeats until the GCS declares the node dead.
        def do_popen():
            logfile = open(log_path, "ab")
            try:
                return subprocess.Popen(
                    cmd, stdout=logfile, stderr=subprocess.STDOUT, env=env,
                    start_new_session=True,
                )
            finally:
                logfile.close()  # the child holds its own copy

        async def finish():
            try:
                proc = await asyncio.to_thread(do_popen)
            except Exception:  # noqa: BLE001 — spawn failure, drop the slot
                logger.exception("worker spawn failed")
                self._workers.pop(placeholder_key, None)
                self._wake_waiters()
                return
            handle.proc = proc
            handle.pid = proc.pid
            if self._workers.pop(placeholder_key, None) is not None:
                self._workers[proc.pid] = handle
            if self._closed:
                try:
                    proc.terminate()
                except Exception:  # noqa: BLE001 — already exited
                    logger.debug("terminate of late-spawned worker failed",
                                 exc_info=True)

        self._loop.create_task(finish())

    # -- registration (RPC from the worker once its server is up) --
    def register_worker(self, worker_id: WorkerID, pid: int, address: Address,
                        spawn_token: str = "") -> bool:
        handle = self._workers.get(pid)
        if (handle is None or (spawn_token and handle.spawn_token
                               and handle.spawn_token != spawn_token)):
            # The spawn token is the authoritative match: a fork may
            # register before its pid is in our table.
            handle = None
            if spawn_token:
                for h in self._workers.values():
                    if h.spawn_token == spawn_token:
                        handle = h
                        break
        if handle is None:
            # Worker not spawned by us (e.g. driver); track it anyway.
            handle = WorkerHandle(pid=pid)
            self._workers[pid] = handle
        handle.worker_id = worker_id
        handle.address = address
        handle.state = "idle"
        self._emit_state(handle)
        handle.idle_since = time.monotonic()
        # raylint: disable=cross-domain-mutation — loop-confined:
        # register_worker/register_driver run inside raylet RPC handlers
        # on the raylet loop, as does the monitor coroutine's cleanup;
        # no user-thread caller exists
        self._registered[worker_id] = handle
        self._wake_waiters(n=1, cards=handle.cards)
        # Demand-driven replenish: under a lease burst, keep the zygote
        # spawn pipeline at depth without routing the decision through
        # another waiter wakeup. Counts PLAIN waiters only — card waiters
        # cannot use a plain worker, so spawning for them here would fill
        # the pool with workers nobody claims and starve their own direct
        # spawns.
        if self._zygote_eligible(()):
            z_starting, _, dp_starting = self._starting_by_mechanism()
            if (self._plain_waiters > z_starting
                    and z_starting < self._startup_cap(False)
                    and dp_starting < self._startup_cap(True)
                    and self.num_poolable < self._max_workers):
                self._spawn()
        return True

    def register_driver(self, worker_id: WorkerID, pid: int, address: Address):
        handle = WorkerHandle(
            worker_id=worker_id, pid=pid, address=address, state="leased",
            is_driver=True,
        )
        self._workers[pid] = handle
        self._registered[worker_id] = handle

    def _wake_waiters(self, n: Optional[int] = None,
                      cards: Optional[Tuple[int, ...]] = None):
        """Wake up to `n` LIVE pop_worker() waiters (all when n is None).

        Events that free ONE worker wake ONE waiter: waking everyone made
        a 1k-actor burst quadratic (every registration re-ran every
        waiter's O(workers) idle scan). Futures already done (timed-out
        waiters that will re-loop on their own) are skipped so a wakeup
        is never wasted on them. With the freed worker's `cards` given,
        the wakeup targets a waiter that can actually CLAIM it (one that
        wants the same cards); mismatched waiters are left queued rather
        than burning the wakeup, with the pop_worker poll as the fairness
        backstop."""
        if n is None:
            # fresh empty swap of the lease-bounded waiter set (above)
            entries, self._waiters = self._waiters, deque()  # raylint: disable=unbounded-queue
            for entry in entries:
                if not entry[0].done():
                    entry[0].set_result(None)
            return

        skipped = []
        while n > 0 and self._waiters:
            entry = self._waiters.popleft()
            fut, want = entry
            if fut.done():
                continue
            if cards is not None and want != cards:
                skipped.append(entry)
                continue
            fut.set_result(None)
            n -= 1
        for entry in reversed(skipped):
            self._waiters.appendleft(entry)

    def _startup_cap(self, direct: bool) -> int:
        """Per-mechanism startup concurrency: zygote forks are ~ms-cheap
        and keep a deep pipeline; direct spawns (card workers, zygote
        down) pay a full interpreter boot each and keep the small cap so a
        burst cannot thrash the host."""
        if CONFIG.worker_maximum_startup_concurrency:
            return CONFIG.worker_maximum_startup_concurrency
        base = max(4, os.cpu_count() or 4)
        return base if direct else max(base, 16)

    def _zygote_eligible(self, cards: Tuple[int, ...]) -> bool:
        return (not cards and CONFIG.enable_worker_zygote
                and self._zygote_failures < 3)

    def _starting_by_mechanism(self):
        """-> (zygote_starting, direct_starting, direct_plain_starting).
        The last term counts full-interpreter boots of PLAIN workers —
        i.e. zygote-fallback spawns — which plain waiters must brake on
        even while the zygote looks eligible."""
        z = d = dp = 0
        for w in self._workers.values():
            if w.state == "starting":
                if w.direct_spawn:
                    d += 1
                    if not w.cards:
                        dp += 1
                else:
                    z += 1
        return z, d, dp

    def _num_starting(self, cards: Tuple[int, ...]) -> int:
        return sum(1 for w in self._workers.values()
                   if w.state == "starting" and w.cards == cards)

    async def pop_worker(
        self, timeout: float, cards: Tuple[int, ...] = (),
    ) -> Optional[WorkerHandle]:
        """Get an idle worker bound to exactly `cards` (() for a plain
        one), spawning if below the cap. None on timeout. A worker bound to
        other cards is never handed out: its CUDA_VISIBLE_DEVICES was fixed
        at spawn."""
        cards = tuple(cards)
        deadline = time.monotonic() + timeout
        self._pop_waiters = getattr(self, "_pop_waiters", 0) + 1
        plain = not cards
        if plain:
            self._plain_waiters += 1
        try:
            while not self._closed:
                claimed = next(
                    (w for w in self._workers.values()
                     if w.state == "idle" and w.cards == cards), None)
                if claimed is not None:
                    claimed.state = "leased"
                    self._emit_state(claimed)
                    return claimed
                direct = not self._zygote_eligible(cards)
                z_starting, d_starting, dp_starting = (
                    self._starting_by_mechanism())
                starting = d_starting if direct else z_starting
                if (
                    self.num_poolable < self._max_workers
                    and self._num_starting(cards) < self._pop_waiters
                    and starting < self._startup_cap(direct)
                    # brake on zygote-FALLBACK boots: a wobbling zygote
                    # makes _spawn fall back to full interpreter boots,
                    # which must never exceed the direct pipeline depth
                    # (card boots gate themselves above)
                    and (direct
                         or dp_starting < self._startup_cap(True))
                ):
                    self._spawn(cards)
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return None
                fut = self._loop.create_future()
                self._waiters.append((fut, cards))
                try:
                    # 2s fairness backstop: waiters are woken individually
                    # as workers free up; a short poll here made 1k
                    # concurrent lease waiters re-scan the pool twice a
                    # second each (quadratic at burst scale). A timed-out
                    # waiter leaves a done future behind; _wake_waiters
                    # skips those, so wakeups are never lost to them.
                    await asyncio.wait_for(fut, min(remaining, 2.0))
                except asyncio.TimeoutError:
                    pass
            return None
        finally:
            self._pop_waiters -= 1
            if plain:
                self._plain_waiters -= 1

    def return_worker(self, worker_id: WorkerID, disconnect: bool = False):
        handle = self._registered.get(worker_id)
        if handle is None:
            return
        if disconnect:
            self._kill(handle)
            return
        handle.state = "idle"
        self._emit_state(handle)
        handle.idle_since = time.monotonic()
        self._wake_waiters(n=1, cards=handle.cards)

    def mark_actor_worker(self, worker_id: WorkerID, actor_id):
        handle = self._registered.get(worker_id)
        if handle is not None:
            handle.state = "actor"
            handle.actor_id = actor_id
            self._emit_state(handle)

    def get_by_worker_id(self, worker_id: WorkerID) -> Optional[WorkerHandle]:
        return self._registered.get(worker_id)

    def kill_worker(self, handle: WorkerHandle):
        """Terminate a worker while LEAVING its state intact, so the monitor
        loop reaper observes the exit and fires on_worker_death — releasing
        the lease/resources and reporting actor death. (_kill pre-marks the
        handle dead, which suppresses the callback; that is only correct for
        workers whose lease was already released.)"""
        handle.evicted = True
        if handle.proc is not None and handle.proc.poll() is None:
            try:
                handle.proc.terminate()
            except Exception:  # noqa: BLE001 — already exited
                logger.debug("terminate of evicted worker %s failed",
                             handle.worker_id, exc_info=True)

    def _kill(self, handle: WorkerHandle):
        handle.state = "dead"
        self._emit_state(handle, reason="killed by pool")
        if handle.proc is not None and handle.proc.poll() is None:
            try:
                handle.proc.terminate()
            except Exception:  # noqa: BLE001 — already exited
                logger.debug("terminate of worker %s failed",
                             handle.worker_id, exc_info=True)

    async def _monitor_loop(self):
        """Reap dead children + idle-timeout spares (worker_pool.cc analog).

        Zygote-fork workers report exits through the zygote pipe (which
        sets handle.proc.returncode), so their os.kill(pid, 0) liveness
        probe is only a fallback for a zygote that died silently — probing
        every one of them every tick made the loop O(workers) in SYSCALLS
        (20k/s at 1k actors). Probe pid-based handles on a ~1s cadence;
        returncode-set handles and real Popen handles stay on the fast
        tick."""
        idle_timeout = CONFIG.worker_pool_idle_timeout_s
        tick = 0
        while not self._closed:
            await asyncio.sleep(0.05)
            tick += 1
            probe_pids = (tick % 20 == 0)
            now = time.monotonic()
            for pid, handle in list(self._workers.items()):
                proc = handle.proc
                skip_probe = (isinstance(proc, _ForkedProc)
                              and proc.returncode is None and not probe_pids)
                if (proc is not None and not skip_probe
                        and proc.poll() is not None):
                    if handle.state != "dead":
                        prev_state = handle.state
                        handle.state = "dead"
                        self._emit_state(
                            handle, reason=f"process exit (was {prev_state})")
                        handle.dead_since = now
                        try:
                            self._on_worker_death(handle, prev_state)
                        except Exception:
                            logger.exception("worker-death callback failed")
                    if handle.worker_id is not None:
                        self._registered.pop(handle.worker_id, None)
                    # Keep the dead handle visible for a grace period: the
                    # log monitor (scan period ~500ms) must get at least one
                    # scan over the corpse to ship its final output — for a
                    # never-leased worker that's the only chance its startup
                    # crash traceback reaches any driver.
                    if now - handle.dead_since > 1.5:
                        del self._workers[pid]
                elif (
                    handle.state == "idle"
                    and now - handle.idle_since > idle_timeout
                    and not handle.is_driver
                ):
                    self._kill(handle)
            if tick % 1200 == 0:  # ~once a minute
                await asyncio.to_thread(self.prune_worker_logs)

    def prune_worker_logs(self) -> int:
        """Cap the worker-log directory at CONFIG.worker_log_max_files
        (reference: per-file log rotation in ray_constants — bounded log
        disk either way). A day of actor churn leaves tens of thousands
        of dead workers' logs behind; oldest files go first, live
        workers' logs are never touched. Returns files removed."""
        cap = CONFIG.worker_log_max_files
        if not cap or cap <= 0:
            return 0
        start = time.time()
        # list() of a dict's values is a single GIL-held C operation, so
        # this snapshot cannot interleave with the event loop registering
        # new workers (this method runs on a to_thread worker); a plain
        # set comprehension over the live dict could raise mid-iteration.
        live = {h.log_path for h in list(self._workers.values())
                if h.log_path}

        def is_live(path: str) -> bool:
            if path in live:
                return True
            # Rotation backups (<log>.N) of a live worker are part of its
            # log, not dead-worker residue.
            stem, dot, suffix = path.rpartition(".")
            return bool(dot) and suffix.isdigit() and stem in live
        try:
            with os.scandir(self._log_dir) as it:
                entries = [(e.stat().st_mtime, e.path) for e in it
                           if e.is_file() and e.name.startswith("worker-")]
        except OSError:
            return 0
        excess = len(entries) - cap
        if excess <= 0:
            return 0
        entries.sort()
        removed = 0
        for mtime, path in entries:
            if removed >= excess:
                break
            # Fresh files may belong to workers spawned after the live
            # snapshot — never delete anything newer than the prune start.
            if is_live(path) or mtime >= start - 1.0:
                continue
            try:
                os.unlink(path)
                removed += 1
            except OSError:
                pass
        return removed

    def shutdown(self):
        self._closed = True
        if self._monitor_task is not None:
            self._monitor_task.cancel()
        # Terminate workers BEFORE the zygote: forked workers are the
        # zygote's children, and only a live zygote reaps them and reports
        # their exits (setting _ForkedProc.returncode). Killing the zygote
        # first left every worker a zombie under init, whose slow reap made
        # each wait() burn its poll deadline — cluster shutdown cost ~2s of
        # pure waiting before this ordering.
        # Snapshots, not live views: the zygote reader is still running on
        # the loop thread (by design — it reaps and reports the exits the
        # wait loop below consumes) and re-keys _workers when a pending
        # fork lands mid-shutdown.
        handles = list(self._workers.values())
        for handle in handles:
            if handle.proc is not None and handle.proc.poll() is None:
                try:
                    handle.proc.terminate()
                except Exception:  # noqa: BLE001 — already exited
                    logger.debug("terminate on shutdown failed",
                                 exc_info=True)
        deadline = time.monotonic() + 2.0
        for handle in handles:
            if handle.proc is not None:
                try:
                    handle.proc.wait(timeout=max(0.05, deadline - time.monotonic()))
                except Exception:
                    try:
                        handle.proc.kill()
                    except Exception:  # noqa: BLE001 — exited post-timeout
                        logger.debug("kill on shutdown failed",
                                     exc_info=True)
        if self._zygote is not None:
            try:
                self._zygote.stdin.close()  # EOF = clean zygote exit
            except Exception:  # noqa: BLE001 — pipe already broken
                logger.debug("zygote stdin close failed", exc_info=True)
            try:
                self._zygote.terminate()
            except Exception:  # noqa: BLE001 — zygote already exited
                logger.debug("zygote terminate failed", exc_info=True)
            self._zygote = None
