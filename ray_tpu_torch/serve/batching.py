"""Dynamic request batching (reference: ray python/ray/serve/batching.py —
@serve.batch :468, queue :80: requests accumulate until max_batch_size or
batch_wait_timeout_s, then the wrapped method is called once with the list).

On GPU replicas this is the path to fixed-shape batched inference: the
batch handler pads to a bucketed batch size so XLA reuses a small set of
compiled programs or CUDA graphs (batching + bucketing).
"""

from __future__ import annotations

import functools
import inspect
import queue
import threading
import time
from concurrent.futures import Future
from typing import Any, Callable, List, Optional


class _BatchQueue:
    """One batching thread per bound target (per replica instance)."""

    def __init__(self, handler: Callable, max_batch_size: int,
                 batch_wait_timeout_s: float):
        self._handler = handler
        self._max = max_batch_size
        self._timeout = batch_wait_timeout_s
        # fed only by this replica's in-flight requests: bounded upstream
        # by the deployment's max_ongoing_requests admission
        self._queue: "queue.Queue[tuple]" = queue.Queue()  # raylint: disable=unbounded-queue
        self._thread = threading.Thread(
            target=self._loop, name="serve-batch", daemon=True)
        self._thread.start()

    def submit(self, item: Any) -> Future:
        fut: Future = Future()
        self._queue.put((item, fut))
        return fut

    def _loop(self) -> None:
        while True:
            batch: List[tuple] = [self._queue.get()]
            deadline = time.monotonic() + self._timeout
            while len(batch) < self._max:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    batch.append(self._queue.get(timeout=remaining))
                except queue.Empty:
                    break
            items = [b[0] for b in batch]
            futures = [b[1] for b in batch]
            try:
                results = self._handler(items)
                if len(results) != len(items):
                    raise ValueError(
                        f"batch handler returned {len(results)} results for "
                        f"{len(items)} inputs")
                for fut, res in zip(futures, results):
                    fut.set_result(res)
            except Exception as e:  # noqa: BLE001 — propagate per-request
                for fut in futures:
                    fut.set_exception(e)


def batch(_func: Optional[Callable] = None, *, max_batch_size: int = 10,
          batch_wait_timeout_s: float = 0.01):
    """Decorator: the wrapped fn receives a LIST of requests and returns a
    list of responses of the same length."""

    def wrap(fn: Callable):
        params = list(inspect.signature(fn).parameters)
        is_method = bool(params) and params[0] == "self"
        # No locks/threads in the closure: the deployment class gets pickled
        # to replicas, so runtime state lives in a process-local registry
        # keyed by (wrapped fn, instance) and is created on first call.
        if is_method:
            @functools.wraps(fn)
            def wrapper(self, item):
                bq = _get_queue(fn, self, max_batch_size,
                                batch_wait_timeout_s)
                return bq.submit(item).result(timeout=60)
        else:
            @functools.wraps(fn)
            def wrapper(item):
                bq = _get_queue(fn, None, max_batch_size,
                                batch_wait_timeout_s)
                return bq.submit(item).result(timeout=60)

        wrapper._is_serve_batch = True  # type: ignore[attr-defined]
        return wrapper

    if _func is not None:
        return wrap(_func)
    return wrap


_queues_lock = threading.Lock()
_queues: dict = {}


def _get_queue(fn: Callable, instance, max_batch_size: int,
               batch_wait_timeout_s: float) -> _BatchQueue:
    key = (id(fn), id(instance))
    with _queues_lock:
        bq = _queues.get(key)
        if bq is None:
            handler = (lambda items: fn(instance, items)) \
                if instance is not None else fn
            bq = _BatchQueue(handler, max_batch_size, batch_wait_timeout_s)
            _queues[key] = bq
        return bq
