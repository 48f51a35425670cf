"""Data-plane benchmark of the port: the typed tensor wire and the device
feed.

    python -m ray_tpu_torch._private.dataplane_bench [--device cpu]

The port's counterpart of `ray_tpu/_private/dataplane_bench.py`, without
the object store (the port does not import the runtime): the wire is
measured through the port's own `serialize` into a preallocated host arena.
Prints ONE JSON line:
  {"metric": "tensor_put_gbps", "value": <the device tensor's put GB/s>,
   "unit": "GB/s", "detail": {"object_put_gbps": {"numpy", "cpu_tensor",
   "cuda_tensor"}, "object_get_gbps": {...}, "cpu_tensor_put_slowdown_vs_
   numpy", "pinned_d2h_gbps", "pinned_h2d_gbps", "cuda_put_slowdown_vs_
   pinned_d2h", "cuda_get_slowdown_vs_pinned_h2d", "feed": {...}, ...}}

Methodology:
* put: `serialize` then `write_into` a preallocated 64 MiB host arena
  (the one host copy an object-store put makes), the minimum of PUT_ITERS
  rounds, for a numpy int64 array, a CPU tensor and (on the card) a CUDA
  tensor, whose put adds its device-to-host copy; the kinds take turns
  within each round. The CPU tensor should be
  within 1.2x of numpy (the JAX bench's criterion for its typed wire).
* get: `SerializedObject.from_bytes` over the arena, read-only as an
  object-store page is, then `deserialize`. numpy and the CPU tensor are
  views (the number is the speed of making them); the CUDA tensor pays its
  host-to-device copy.
* yardsticks, on the card only and timed in the same run: a pinned
  device-to-host and host-to-device copy of the same 64 MiB.
* feed: the eager Llama train step (the bench's config on the card,
  `LlamaConfig.tiny()` on the CPU) fed by `iter_device_batches` from
  seeded numpy token batches at prefetch 0 and 1: ms a step, produce_s,
  wait_s and overlap_frac = 1 - wait_s/produce_s.

Without CUDA it raises, unless --device cpu is given; a CPU run reports no
CUDA numbers and names its device "cpu".
"""

from __future__ import annotations

import argparse
import functools
import json
import time
from typing import Any, Dict

import numpy as np
import torch

from ray_tpu_torch._private import serialization as ser
from ray_tpu_torch._private.device import resolve_device

PAYLOAD_BYTES = 64 * 1024 * 1024
PUT_ITERS = 5
GET_ITERS = 5
FEED_STEPS = 8
# The feed's batches: the bench's B, S on the card; the CPU smoke's.
FEED_SHAPE = {"cuda": (4, 2048), "cpu": (2, 64)}


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _best_s(fns: Dict[str, Any], iters: int) -> Dict[str, float]:
    """The least seconds of each fn over `iters` rounds, the fns taken in
    turns within each round (so host noise falls on every kind alike)."""
    best = {k: float("inf") for k in fns}
    for _ in range(iters):
        for k, fn in fns.items():
            t0 = time.perf_counter()
            fn()
            best[k] = min(best[k], time.perf_counter() - t0)
    return best


def _wire(values: Dict[str, Any], nbytes: int, dev) -> Dict[str, Any]:
    """put and get GB/s of each value through its own arena, and the values
    got back."""
    arenas = {k: memoryview(bytearray(ser.serialize(v).wire_size()))
              for k, v in values.items()}
    got: Dict[str, Any] = {}

    def put(k):
        return lambda: ser.serialize(values[k]).write_into(arenas[k])

    def get(k):
        def fn():
            got[k] = ser.deserialize(ser.SerializedObject.from_bytes(
                arenas[k].toreadonly()))
            _sync(dev)
        return fn

    put_s = _best_s({k: put(k) for k in values}, PUT_ITERS)
    get_s = _best_s({k: get(k) for k in values}, GET_ITERS)
    return {"put": {k: nbytes / v / 1e9 for k, v in put_s.items()},
            "get": {k: nbytes / v / 1e9 for k, v in get_s.items()},
            "values": got}


def _pinned_copies(dev, nbytes: int) -> Dict[str, float]:
    src = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)

    def d2h():
        host.copy_(src, non_blocking=True)
        torch.cuda.synchronize(dev)

    def h2d():
        src.copy_(host, non_blocking=True)
        torch.cuda.synchronize(dev)

    best = _best_s({"d2h": d2h, "h2d": h2d}, PUT_ITERS)
    return {k: nbytes / v / 1e9 for k, v in best.items()}


def token_batches(vocab: int, batch: int, seq: int, n: int, seed: int):
    """n seeded numpy batches of the train step's layout."""
    rng = np.random.default_rng(seed)
    for _ in range(n):
        toks = rng.integers(0, vocab, (batch, seq + 1))
        yield {"inputs": np.ascontiguousarray(toks[:, :-1]),
               "targets": np.ascontiguousarray(toks[:, 1:])}


def feed_bench(dev) -> Dict[str, Any]:
    """The eager Llama step fed at prefetch 0 and 1 from the same seeded
    batches and the same initial state."""
    from ray_tpu_torch.bench import bench_config
    from ray_tpu_torch.data import iter_device_batches
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.train import adamw, init_train_state, make_train_step

    cfg = bench_config() if dev.type == "cuda" else llama.LlamaConfig.tiny()
    batch, seq = FEED_SHAPE[dev.type]
    out = {"config": "bench" if dev.type == "cuda" else "tiny",
           "batch": batch, "seq": seq, "steps": FEED_STEPS}
    for prefetch in (0, 1):
        opt = adamw(3e-4, weight_decay=0.0)
        gen = torch.Generator(device=dev).manual_seed(0)
        state = init_train_state(functools.partial(llama.init, cfg, gen), opt,
                                 device=dev)
        step = make_train_step(functools.partial(llama.loss_fn, config=cfg),
                               opt, compiled=False)
        stats: Dict[str, Any] = {}
        feed = iter_device_batches(
            token_batches(cfg.vocab_size, batch, seq, FEED_STEPS + 1, 1),
            device=dev, prefetch=prefetch, stats=stats)
        state, m = step(state, next(feed))  # warm-up, untimed
        _sync(dev)
        t0 = time.perf_counter()
        for b in feed:
            state, m = step(state, b)
        _sync(dev)
        out[f"prefetch{prefetch}"] = {
            "ms_per_step": (time.perf_counter() - t0) / FEED_STEPS * 1e3,
            "loss": float(m["loss"]), **stats}
        del state, step
    return out


def run(device=None) -> Dict[str, Any]:
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    if on_card and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    n = PAYLOAD_BYTES
    np_arr = np.arange(n // 8, dtype=np.int64)
    values = {"numpy": np_arr, "cpu_tensor": torch.from_numpy(np_arr.copy())}
    if on_card:
        values["cuda_tensor"] = torch.arange(n // 8, dtype=torch.int64,
                                             device=dev)
    puts0 = ser.COPY_STATS["typed_tensor_put"]
    flatten0 = ser.COPY_STATS["payload_flatten"]
    r = _wire(values, n, dev)
    put, get = r["put"], r["get"]
    for kind, got in r["values"].items():
        same = (np.array_equal(got, np_arr) if kind == "numpy"
                else torch.equal(got.cpu(), values["cpu_tensor"]))
        if not same or (kind == "cuda_tensor" and got.device != dev):
            raise RuntimeError(f"the {kind} round trip changed the value")
    detail: Dict[str, Any] = {
        "device": torch.cuda.get_device_name(dev) if on_card else "cpu",
        "payload_bytes": n,
        "object_put_gbps": put, "object_get_gbps": get,
        "cpu_tensor_put_slowdown_vs_numpy": put["numpy"] / put["cpu_tensor"],
        "typed_tensor_puts": ser.COPY_STATS["typed_tensor_put"] - puts0,
        "payload_flattens": ser.COPY_STATS["payload_flatten"] - flatten0,
    }
    if on_card:
        from ray_tpu_torch.bench import nvidia_smi_line

        pinned = _pinned_copies(dev, n)
        detail.update({
            "nvidia_smi": nvidia_smi_line(),
            "pinned_d2h_gbps": pinned["d2h"], "pinned_h2d_gbps": pinned["h2d"],
            "cuda_put_slowdown_vs_pinned_d2h":
                pinned["d2h"] / put["cuda_tensor"],
            "cuda_get_slowdown_vs_pinned_h2d":
                pinned["h2d"] / get["cuda_tensor"]})
    detail["feed"] = feed_bench(dev)
    value = put["cuda_tensor" if on_card else "cpu_tensor"]
    return {"metric": "tensor_put_gbps", "value": value, "unit": "GB/s",
            "detail": detail}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default=None,
                        help="cuda (the default; raises without it) or cpu")
    args = parser.parse_args(argv)
    print(json.dumps(run(args.device)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
