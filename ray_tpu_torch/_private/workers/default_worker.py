"""Worker process entry point.

Role of the reference's default_worker.py (ray: python/ray/_private/workers/
default_worker.py): spawned by the raylet's WorkerPool, connects a CoreWorker
back to its raylet + GCS, then serves push_task until told to exit. Imports
stay light (no torch) so spawn latency is low; a task that needs torch, or
a tensor it receives, imports it on first use.
"""

from __future__ import annotations

import argparse
import logging
import os
import signal
import sys
import time


def _start_log_rotator(config) -> None:
    """Size-rotate this worker's own log file (reference: ray_constants
    LOGGING_ROTATE_BYTES/BACKUP_COUNT — bounded per-worker log disk).
    fds 1/2 point at the log; rotation renames the file and dup2s a
    fresh one under them, so writers never notice. The raylet's log
    monitor detects the size drop and restarts its tail offset."""
    import threading
    import time as _time

    log_path = os.environ.get("RT_WORKER_LOG_PATH")
    max_bytes = config.worker_log_rotate_bytes
    backups = max(1, config.worker_log_rotate_backups)
    if not log_path or not max_bytes or max_bytes <= 0:
        return

    period = float(os.environ.get("RT_WORKER_LOG_ROTATE_CHECK_S", "30"))

    def rotate_loop():
        while True:
            _time.sleep(period)
            try:
                if os.path.getsize(log_path) < max_bytes:
                    continue
                for i in range(backups - 1, 0, -1):
                    src = f"{log_path}.{i}"
                    if os.path.exists(src):
                        os.replace(src, f"{log_path}.{i + 1}")
                os.replace(log_path, f"{log_path}.1")
                fd = os.open(log_path,
                             os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
                os.dup2(fd, 1)
                os.dup2(fd, 2)
                os.close(fd)
            except OSError:
                pass

    threading.Thread(target=rotate_loop, daemon=True,
                     name="rt-log-rotator").start()


def run_worker(raylet_address: str, gcs_address: str, node_id: str,
               log_level: str = "INFO"):
    """Connect a CoreWorker and serve until terminated. Shared by the
    direct-spawn path (main below) and zygote fork-server children."""
    logging.basicConfig(
        level=getattr(logging, log_level.upper(), logging.INFO),
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
    )
    from ray_tpu_torch._private.config import CONFIG
    CONFIG.load_from_env()

    from ray_tpu_torch._private.ids import NodeID
    from ray_tpu_torch._private.spawn_diag import spawn_timing_write
    from ray_tpu_torch.worker.core_worker import CoreWorker

    _start_log_rotator(CONFIG)

    # RT_WORKER_PROFILE_DIR=<dir>: profile this worker and dump cProfile
    # stats at (graceful) exit — how the zygote preimport set and the
    # spawn hot path were measured (see workers/zygote.py). atexit runs
    # on this same thread, so disable()/dump see a quiesced profiler
    # (cProfile hooks are per-thread).
    prof_dir = os.environ.get("RT_WORKER_PROFILE_DIR")
    if prof_dir:
        import atexit
        import cProfile

        _pr = cProfile.Profile()
        _pr.enable()

        def _dump():
            try:
                _pr.disable()
                _pr.dump_stats(
                    os.path.join(prof_dir, f"worker-{os.getpid()}.prof"))
            except Exception:  # noqa: BLE001 — diagnostics only
                pass

        atexit.register(_dump)

    # RT_SPAWN_TIMING=<file>: append one line of bring-up phase timings
    # per worker — how spawn-path regressions at burst scale get located
    # (cProfile dumps don't survive the zygote children's os._exit)
    t0 = time.perf_counter()
    core_worker = CoreWorker(
        mode="worker",
        gcs_address=gcs_address,
        raylet_address=raylet_address,
        node_id=NodeID.from_hex(node_id),
    )
    spawn_timing_write(f"ctor={time.perf_counter() - t0:.4f}")

    def _term(_sig, _frm):
        sys.exit(0)

    signal.signal(signal.SIGTERM, _term)
    # `ray-tpu stack` support: SIGUSR1 dumps all thread stacks to stderr
    # (captured in the worker's log file) — dependency-free py-spy analog.
    import faulthandler

    faulthandler.register(signal.SIGUSR1, all_threads=True)
    # Crash flight recorder: the CoreWorker ctor armed atexit/excepthook
    # (install_flight_recorder(on_exit=True)); the _term handler above
    # routes SIGTERM through sys.exit(0) -> atexit, so even a pool
    # `terminate()` leaves this worker's black box in the session dir.

    # The RPC loop threads do the work; park the main thread.
    try:
        while True:
            time.sleep(3600)
    except (KeyboardInterrupt, SystemExit):
        pass


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--raylet-address", required=True)
    parser.add_argument("--gcs-address", required=True)
    parser.add_argument("--node-id", required=True)
    parser.add_argument("--log-level", default="INFO")
    args = parser.parse_args()
    run_worker(args.raylet_address, args.gcs_address, args.node_id,
               args.log_level)


if __name__ == "__main__":
    main()
