"""The device feed: host numpy batches -> tensors on the card, prefetched.

The port's counterpart of `ray_tpu/data/dataset.py`'s
`Dataset.iter_jax_batches` and `_prefetch_device_feed`. It takes any
iterator of `{name: np.ndarray}` batches (a `ray_tpu.data.Dataset`'s
`iter_batches(batch_format="numpy")`, a numpy generator) rather than being
a method of the runtime's Dataset, which the port does not import.

On the card, a producer thread stages each batch in pinned host memory (a
ring of depth + 1 buffers a column, a buffer reused only once the event of
its last copy has completed) and copies it to the device with a
non-blocking copy on its own CUDA stream, then records an event. The
consumer makes its current stream wait on that event and marks each
tensor as used by its stream (`record_stream`), so the caching allocator
does not hand the memory back to the feed while the consumer's kernels
still read it. Without either step the symptom would be a rare wrong
batch, not an error.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Dict, Iterable, Iterator, Optional

import numpy as np
import torch

from ray_tpu_torch._private import gang
from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch._private.device_profiler import observe_phase

_FEED_DONE = object()


def _local_tensors(batch: Dict[str, Any]):
    for v in batch.values():
        yield v.to_local() if hasattr(v, "to_local") else v


class _Stager:
    """Host batches -> tensors on `device`; one instance a feed. `open()`
    runs on the thread that stages (the current stream is per thread);
    `__call__` stages one batch and returns (batch of tensors, the event
    of its copies or None); `deliver` runs on the consumer's thread."""

    def __init__(self, device: torch.device, dtypes, sharding, mesh,
                 slots: int, local_rows: bool = False):
        self.device = device
        self.dtypes = dtypes or {}
        self.sharding = sharding
        self.mesh = mesh
        self.local_rows = local_rows
        self.slots = slots
        self.stream = None
        # column -> [[pinned buffer, event of its last copy], ...]; position
        self._ring: Dict[str, list] = {}
        self._pos: Dict[str, int] = {}

    def open(self, side_stream: bool) -> None:
        """On the card: the producer thread's own stream (side_stream), or
        the consumer's current stream."""
        if self.device.type != "cuda":
            return
        if side_stream:
            torch.cuda.set_device(self.device)
            self.stream = torch.cuda.Stream(self.device)
        else:
            self.stream = torch.cuda.current_stream(self.device)

    def _staged(self, name: str, arr: np.ndarray) -> list:
        """`arr` copied into the next pinned buffer of its column's ring;
        -> that ring slot, [buffer, event]."""
        ring = self._ring.setdefault(name, [[None, None]
                                            for _ in range(self.slots)])
        i = self._pos.get(name, 0)
        self._pos[name] = (i + 1) % self.slots
        slot = ring[i]
        if slot[1] is not None:
            slot[1].synchronize()  # its previous copy has left the buffer
        if (slot[0] is None or tuple(slot[0].shape) != arr.shape
                or slot[0].numpy().dtype != arr.dtype):
            slot[0] = torch.empty(arr.shape, pin_memory=True, dtype=(
                torch.from_numpy(np.empty(0, arr.dtype)).dtype))
        np.copyto(slot[0].numpy(), arr)
        return slot

    def __call__(self, batch: Dict[str, np.ndarray]):
        batch = {k: (np.asarray(v).astype(self.dtypes[k])
                     if k in self.dtypes else np.asarray(v))
                 for k, v in batch.items()}
        if self.device.type != "cuda":
            if self.sharding is not None:
                return self._sharded(batch), None
            # copies, as device_put copies: the consumer owns its batch
            return {k: torch.from_numpy(np.array(v)) for k, v in
                    batch.items()}, None
        used = []
        with torch.cuda.stream(self.stream):
            if self.sharding is not None:
                out = self._sharded(batch)
            else:
                used = [self._staged(k, v) for k, v in batch.items()]
                out = {k: slot[0].to(self.device, non_blocking=True)
                       for k, slot in zip(batch, used)}
            event = torch.cuda.Event()
            event.record(self.stream)
        for slot in used:
            slot[1] = event
        return out, event

    def _sharded(self, batch):
        from ray_tpu_torch.train import spmd

        place = (spmd.shard_position_batch if self.local_rows
                 else spmd.shard_local_batch)
        return place(batch, self.sharding, self.mesh, self.device)

    def deliver(self, item):
        out, event = item
        if event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(event)
            for t in _local_tensors(out):
                t.record_stream(stream)
        return out


def _record_wait(scope, seconds: float) -> None:
    """One consumer wait: into the phase histogram as input_wait of the
    "data" profiler, as the reference's feed records it, and to `scope`'s
    step when there is one."""
    observe_phase("input_wait", seconds)
    if scope is not None:
        (scope() if callable(scope) else scope).external("input_wait",
                                                          seconds)


def _finish_stats(stats: Optional[Dict], acc: Dict, overlap: bool) -> None:
    if stats is None:
        return
    stats.update(acc)
    busy = acc["produce_s"]
    stats["overlap_frac"] = (max(0.0, min(1.0, 1.0 - acc["wait_s"] / busy))
                             if overlap and busy > 0 else 0.0)


def _prefetch_device_feed(src: Iterable, stager: _Stager, depth: int,
                          stats: Optional[Dict] = None,
                          scope=None) -> Iterator:
    """Double-buffered device feed. A daemon producer thread
    (`rt-data-device-feed`) pulls host batches from `src` and stages them
    (`stager`) up to `depth` batches ahead of the consumer: the queue bound
    is the prefetch depth. A producer exception is re-raised at the
    consumer's next pull; closing the generator (or breaking out of it)
    stops the producer and joins it.

    `stats` gets produce_s (the producer's busy seconds: the upstream pull
    and the staging), wait_s (the consumer's seconds blocked on an empty
    queue), batches, and overlap_frac = 1 - wait_s/produce_s clipped to
    [0, 1]: the share of the input pipeline hidden behind the consumer.
    Each pull's wait also goes to `scope` (see iter_device_batches)."""
    q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
    stop = threading.Event()
    acc = {"produce_s": 0.0, "wait_s": 0.0, "batches": 0}

    def produce():
        try:
            stager.open(side_stream=True)
            it = iter(src)
            while True:
                t0 = time.perf_counter()
                batch = next(it, _FEED_DONE)
                if batch is _FEED_DONE:
                    break
                out = stager(batch)
                acc["produce_s"] += time.perf_counter() - t0
                while not stop.is_set():
                    try:
                        q.put(out, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if stop.is_set():
                    return
            q.put(_FEED_DONE)
        except BaseException as e:  # noqa: BLE001 — re-raised at consumer
            if not stop.is_set():
                q.put(e)

    t = threading.Thread(target=produce, name="rt-data-device-feed",
                         daemon=True)
    t.start()
    try:
        while True:
            t0 = time.perf_counter()
            item = q.get()
            wait = time.perf_counter() - t0
            acc["wait_s"] += wait
            _record_wait(scope, wait)
            if item is _FEED_DONE:
                break
            if isinstance(item, BaseException):
                raise item
            acc["batches"] += 1
            yield stager.deliver(item)
    finally:
        stop.set()
        while True:  # unblock a producer parked on q.put
            try:
                q.get_nowait()
            except queue.Empty:
                break
        t.join(timeout=10)
        _finish_stats(stats, acc, overlap=True)


def _sync_device_feed(src: Iterable, stager: _Stager,
                      stats: Optional[Dict] = None,
                      scope=None) -> Iterator:
    """prefetch=0: each batch is staged on the consumer's thread and stream
    when it is pulled, so every second of the input pipeline is a second
    the consumer waits (overlap_frac 0)."""
    acc = {"produce_s": 0.0, "wait_s": 0.0, "batches": 0}
    try:
        stager.open(side_stream=False)
        it = iter(src)
        while True:
            t0 = time.perf_counter()
            batch = next(it, _FEED_DONE)
            if batch is _FEED_DONE:
                break
            out = stager.deliver(stager(batch))
            dt = time.perf_counter() - t0
            acc["produce_s"] += dt
            acc["wait_s"] += dt
            _record_wait(scope, dt)
            acc["batches"] += 1
            yield out
    finally:
        _finish_stats(stats, acc, overlap=False)


def _feed_device(device, sharding) -> torch.device:
    """The feed's device: `device`; with none, under a `sharding` the
    rank's (`_private.gang.rank_device`: the card its process is bound to,
    whichever thread feeds, or the CPU under gloo), else the card; a card
    without an index is the one the process is bound to, else the calling
    thread's current card."""
    if device is None and sharding is not None:
        return gang.rank_device()
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        card = gang.bind_thread()
        dev = (card if card is not None
               else torch.device("cuda", torch.cuda.current_device()))
    return dev


def iter_device_batches(batches: Iterable[Dict[str, np.ndarray]], *,
                        device=None, dtypes: Optional[Dict] = None,
                        sharding=None, mesh=None, local_rows: bool = False,
                        prefetch: int = 1, stats: Optional[Dict] = None,
                        scope: Any = None) -> Iterator[Dict[str, Any]]:
    """Numpy batches -> {name: tensor on `device`}, the counterpart of
    `Dataset.iter_jax_batches`.

    `device`: None is the card (raises without CUDA), or with a `sharding`
    the rank's device: the card its process is bound to in a gang
    (`_private.gang.bind_card`), whichever thread feeds; "cpu" yields CPU
    tensors (copies of the batch). `dtypes` ({name: numpy dtype}) casts on
    the host before the copy, as the JAX feed does. With `sharding` (the
    placements of `ray_tpu_torch.train.spmd.batch_sharding`) and `mesh`,
    each column is a DTensor made by `shard_local_batch`: each batch of
    `batches` is the global batch, and this rank copies only its block.
    With `local_rows` as well, each batch holds only the rows of this
    rank's data position (`split_by_data_position` gives a dataset of
    them), the global batch being every position's rows in position order
    (`train.spmd.shard_position_batch`), as each JAX process of a
    multi-host gang feeds only its own rows.

    `prefetch` (default 1) is the number of batches staged ahead on a
    producer thread and its own CUDA stream while the caller's step runs;
    0 stages each batch when it is pulled (the same stream of batches,
    overlap_frac 0). `stats`, a dict, gets produce_s, wait_s, batches and
    overlap_frac when the feed ends. `scope`, a `DeviceStepProfiler.step()`
    scope or a callable returning the scope of the step now running, gets
    each pull's wait as its `input_wait` phase (`_StepScope.external`).
    Every wait also goes to ray_tpu_step_phase_seconds{phase="input_wait",
    profiler="data"} (`device_profiler.observe_phase`)."""
    dev = _feed_device(device, sharding)
    if local_rows and sharding is None:
        raise ValueError("local_rows needs the batch's sharding and mesh")
    stager = _Stager(dev, dtypes, sharding, mesh, max(0, prefetch) + 1,
                     local_rows)
    if prefetch <= 0:
        return _sync_device_feed(batches, stager, stats, scope)
    return _prefetch_device_feed(batches, stager, prefetch, stats, scope)


def split_by_data_position(dataset, mesh=None, sharding=None):
    """This rank's share of `dataset` (anything with `split_shard(rank,
    world_size)`, as the runtime's Dataset has): the split of its data
    position over the data dims that the batch's `sharding` (default
    `train.spmd.batch_sharding(mesh)`) cuts the batch over, dp x fsdp under
    the default rules. The ranks of one position (its tp and sp peers) get
    the same rows, which a split by rank in the gang (the runtime's
    `get_dataset_shard`) would not give them."""
    from ray_tpu_torch.train.spmd import (batch_sharding, data_position,
                                          get_mesh)

    mesh = mesh if mesh is not None else get_mesh()
    if sharding is None:
        sharding = batch_sharding(mesh)
    pos, n = data_position(sharding, mesh)
    return dataset.split_shard(pos, n)
