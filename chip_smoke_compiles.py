"""Run a checkout's chip_smoke.py with torch.compile's seconds counted by
phase: each top-level `phase_*` function of that chip_smoke.py is wrapped
so that the compile listener's seconds during the call are added to its
name, and the sums are printed, after the script's own output, as
`[compiles] seconds by phase function {...}`. Calls of one phase function
from another count once, at the outer one. The listener's seconds are
dynamo's compile start to end in this process (a spawned rank's compiles
are its own), as chip_smoke.py's own `[phases]` line reads them.

    python3 chip_smoke_compiles.py DIR [chip_smoke.py's arguments]

DIR holds the chip_smoke.py and the ray_tpu_torch package to measure (a
checkout of any commit whose package has
`_private.device_profiler.install_compile_listener`). The exit code is
that of the script's `main`.
"""

import functools
import os
import sys


def main(argv) -> int:
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    here = os.path.abspath(argv[0])
    sys.path.insert(0, here)
    os.environ["PYTHONPATH"] = os.pathsep.join(
        p for p in (here, os.environ.get("PYTHONPATH")) if p)
    import chip_smoke
    from ray_tpu_torch._private.device_profiler import (
        compile_stats, install_compile_listener)

    seconds, depth = {}, [0]

    def counted(name, fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            depth[0] += 1
            install_compile_listener()
            before = compile_stats()["compile_s"]
            try:
                return fn(*args, **kwargs)
            finally:
                depth[0] -= 1
                install_compile_listener()  # a torch._dynamo.reset() drops it
                if depth[0] == 0:
                    seconds[name] = round(seconds.get(name, 0.0)
                                          + compile_stats()["compile_s"]
                                          - before, 1)
        return run

    for name, fn in list(vars(chip_smoke).items()):
        if name.startswith("phase_") and callable(fn):
            setattr(chip_smoke, name, counted(name, fn))
    try:
        return chip_smoke.main(argv[1:])
    finally:
        print(f"[compiles] seconds by phase function {seconds}; "
              f"{compile_stats()['compile_s']:.1f} s in all", flush=True)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
