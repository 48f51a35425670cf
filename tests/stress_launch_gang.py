"""Stress `train.backend.launch_gang` on the CPU: gangs of 3 gloo ranks,
each running `dist.get_rank` and leaving at once, while CPU-bound
processes load the host. Counts the gangs that failed.

    python tests/stress_launch_gang.py [busy processes] [gangs]

Not a test (it takes minutes): it reproduces a race, a rank leaving the
gang while a slower peer is still connecting to it ("Connection closed by
peer" in gloo's connectFullMesh), that a gloo join now closes with a
barrier (`_private/gang.init_process_group`).
"""

import multiprocessing
import sys
import time


def _busy(until: float) -> None:
    while time.time() < until:
        pass


def main(busy: int = 24, gangs: int = 30) -> int:
    import torch.distributed as dist

    from ray_tpu_torch.train import backend

    load = [multiprocessing.Process(target=_busy, args=(time.time() + 3600,),
                                    daemon=True) for _ in range(busy)]
    for p in load:
        p.start()
    failed = 0
    t0 = time.time()
    try:
        for i in range(gangs):
            try:
                assert backend.launch_gang(dist.get_rank, 3, "cpu",
                                           120) == [0, 1, 2]
            except (RuntimeError, AssertionError) as e:
                failed += 1
                print(f"gang {i} failed: {str(e)[-300:]}", flush=True)
    finally:
        for p in load:
            p.kill()
    print(f"{failed} of {gangs} gangs failed under {busy} busy processes "
          f"in {time.time() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main(*map(int, sys.argv[1:])))
