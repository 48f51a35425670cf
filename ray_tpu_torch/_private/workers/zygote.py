"""Worker fork-server ("zygote"): fast worker spawn via preimported fork.

A fresh `python -m ...default_worker` pays ~0.25s of interpreter + package
import per worker; a 1k-actor burst on a small host serializes into
minutes of pure import CPU (and that is the measured bottleneck — see
tools/stress_report.py). The zygote imports the worker stack ONCE, then
`os.fork()`s per spawn request, so a worker costs a fork + CoreWorker
connect (~10-30ms).

The reference hides the same cost with worker prestart
(worker_pool.h:155); the fork-server removes it instead of hiding it —
prestart still helps for the card workers that must keep using fresh
spawns (CUDA_VISIBLE_DEVICES binds only before a process's first CUDA
call, and a CUDA context does not survive a fork). The zygote never
imports torch, let alone initialises CUDA: the worker stack is free of it.

Protocol (line-JSON on stdio, single-threaded and fork-safe):
  stdin  <- {"spawn": {"token": ..., "log_path": ..., "env": {...}}}
  stdout -> {"spawned": <pid>, "token": ...}
  stdout -> {"exited": <pid>, "status": <waitpid exit code>}
Children are reaped HERE (they are the zygote's children); the worker
pool converts exit reports into its normal death handling. EOF on stdin
shuts the zygote down AND takes any still-running children with it: a
clean pool shutdown terminates its workers BEFORE closing our stdin, so
surviving children at EOF mean the host process was killed without
teardown (e.g. a `timeout -k`ed tier-1 run). Leaving those workers
alive leaked serve proxy shards that kept holding SO_REUSEPORT test
ports — the next run's sockets shared the port with a corpse and its
share of connections hung on the first byte.
"""

from __future__ import annotations

import argparse
import json
import os
import select
import signal
import sys


def _child(req: dict, args) -> None:
    """Runs in the forked child: detach, redirect output, become a worker."""
    os.setsid()
    fd = os.open(req["log_path"], os.O_WRONLY | os.O_CREAT | os.O_APPEND,
                 0o644)
    os.dup2(fd, 1)
    os.dup2(fd, 2)
    os.close(fd)
    devnull = os.open(os.devnull, os.O_RDONLY)
    os.dup2(devnull, 0)
    os.close(devnull)
    for k, v in (req.get("env") or {}).items():
        os.environ[k] = v
    os.environ["RT_WORKER_LOG_PATH"] = req["log_path"]  # for self-rotation
    # default SIGTERM disposition; run_worker installs its own handler
    signal.signal(signal.SIGTERM, signal.SIG_DFL)
    from ray_tpu_torch._private.workers.default_worker import run_worker

    try:
        run_worker(args.raylet_address, args.gcs_address, args.node_id)
    finally:
        os._exit(0)


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--raylet-address", required=True)
    parser.add_argument("--gcs-address", required=True)
    parser.add_argument("--node-id", required=True)
    args = parser.parse_args()

    # `ray-tpu stack` signals every worker-shaped process (fork children
    # keep this cmdline); without a handler SIGUSR1's default action
    # would kill the fork-server.
    import faulthandler
    faulthandler.register(signal.SIGUSR1, all_threads=True)

    children: set = set()

    def _terminated(signum, frame):
        # A SIGTERM that kills only this fork-server (e.g. `timeout`
        # TERMing the whole test-run tree while the raylet is already
        # gone) must not strand its children: they are OUR children, and
        # orphaned they sit on their sockets — including SO_REUSEPORT
        # serve-proxy ports that then starve the NEXT run's listeners.
        for pid in list(children):
            try:
                os.kill(pid, signal.SIGTERM)
            except OSError:
                pass
        os._exit(0)

    signal.signal(signal.SIGTERM, _terminated)

    # Preimport the worker stack so forked children inherit a warm module
    # cache. NOTHING here may start threads or event loops — fork() only
    # duplicates the calling thread, and a lock held elsewhere at fork
    # time would deadlock the child.
    #
    # The set below covers everything a worker touches through its first
    # actor task (measured with RT_WORKER_PROFILE_DIR at 1k-actor scale:
    # post-fork imports — plasma_provider, the ctypes store binding, the
    # public ray_tpu_torch surface that unpickled user classes reference — were
    # ~40ms of compile per child because CI inherits
    # PYTHONDONTWRITEBYTECODE=1).
    import ray_tpu_torch  # noqa: F401  (public surface: user code references it)
    import ray_tpu_torch.worker.core_worker  # noqa: F401
    import ray_tpu_torch.worker.executor  # noqa: F401
    import ray_tpu_torch.worker.memory_store  # noqa: F401
    import ray_tpu_torch.worker.plasma_provider  # noqa: F401
    import ray_tpu_torch._private.serialization  # noqa: F401
    from ray_tpu_torch._private import shm_store

    # dlopen the store binding once; children inherit the mapping (~7ms
    # per worker otherwise)
    shm_store.native_store_available()

    out = sys.stdout
    stdin_fd = sys.stdin.fileno()
    buf = b""
    boot_ppid = os.getppid()
    while True:
        # Orphan defense: a clean pool shutdown closes our stdin (EOF
        # below), but a SIGKILLed host process leaves us reparented to
        # init with nobody to close anything — round-4 leftovers showed
        # zygotes + their idle workers surviving for hours. On reparent,
        # take the (now-useless) workers down with us.
        if os.getppid() != boot_ppid:
            for pid in children:
                try:
                    os.kill(pid, signal.SIGTERM)
                except OSError:
                    pass
            os._exit(0)
        readable, _, _ = select.select([stdin_fd], [], [], 0.2)
        # reap exited children and report them
        while True:
            try:
                pid, status = os.waitpid(-1, os.WNOHANG)
            except ChildProcessError:
                break
            if pid == 0:
                break
            children.discard(pid)
            code = (os.waitstatus_to_exitcode(status)
                    if hasattr(os, "waitstatus_to_exitcode") else status)
            out.write(json.dumps({"exited": pid, "status": code}) + "\n")
            out.flush()
        if not readable:
            continue
        chunk = os.read(stdin_fd, 65536)
        if not chunk:
            # Pool closed our stdin: shut down. A clean shutdown already
            # terminated the workers (pool kills children, THEN closes
            # stdin); anything still alive here is an orphan from a
            # killed host process — reap it, or it holds its ports
            # (SO_REUSEPORT proxy shards!) until someone pkills it.
            for pid in children:
                try:
                    os.kill(pid, signal.SIGTERM)
                except OSError:
                    pass
            return
        buf += chunk
        while b"\n" in buf:
            line, buf = buf.split(b"\n", 1)
            if not line.strip():
                continue
            req = json.loads(line)["spawn"]
            pid = os.fork()
            if pid == 0:
                try:
                    _child(req, args)
                except BaseException:  # noqa: BLE001 — never return to loop
                    os._exit(1)
            children.add(pid)
            out.write(json.dumps({"spawned": pid, "token": req["token"]})
                      + "\n")
            out.flush()


if __name__ == "__main__":
    main()
