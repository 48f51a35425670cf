"""RT_SPAWN_TIMING diagnostics: one appended line per event, joined by pid.

Written from CoreWorker.__init__ (ctor phase timings) and the executor
(actor-creation completion) — burst-scale spawn regressions are located by
diffing these lines, so both writers must share one format/error policy.
"""

from __future__ import annotations

import os


def spawn_timing_write(text: str) -> None:
    """Append `<pid> <text>` with total process CPU to the RT_SPAWN_TIMING
    file; no-op (and never raises) when the env var is unset."""
    path = os.environ.get("RT_SPAWN_TIMING")
    if not path:
        return
    try:
        import resource
        import time

        ru = resource.getrusage(resource.RUSAGE_SELF)
        with open(path, "a") as fh:
            fh.write(f"{os.getpid()} {text} "
                     f"cpu={ru.ru_utime + ru.ru_stime:.4f} "
                     f"t={time.time():.4f}\n")
    except OSError:
        pass
