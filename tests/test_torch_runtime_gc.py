"""A ref of the port's runtime that the garbage collector finalises while
its thread holds the memory store's lock.

The collector runs inside whatever allocation sets it off, so a ref held
in a cycle can be finalised under any lock of the runtime. Released in
place, it would take the memory store's lock again and deadlock the
thread; the runtime releases it on the core worker's loop instead.
"""

import gc
import threading
import time

import ray_tpu_torch as rt
from ray_tpu_torch._raylet import global_state


def test_a_ref_collected_under_the_store_lock_is_released_later():
    rt.init(num_cpus=1)
    try:
        cw = global_state.core_worker
        gc.disable()  # the cycle is collected under the lock, not before
        try:
            ref = rt.put(b"x" * 1024)
            oid = ref.object_id()
            cycle = [ref]
            cycle.append(cycle)
            del ref, cycle
            done = threading.Event()

            def collect_under_the_lock():
                with cw.memory_store._lock:
                    gc.collect()
                done.set()

            thread = threading.Thread(target=collect_under_the_lock,
                                      daemon=True)
            thread.start()
            assert done.wait(10), "the collection deadlocked on the lock"
            thread.join()
        finally:
            gc.enable()
        deadline = time.monotonic() + 10
        while cw.memory_store.get_entry(oid) is not None:
            assert time.monotonic() < deadline, "the ref was never released"
            time.sleep(0.01)
    finally:
        rt.shutdown()
