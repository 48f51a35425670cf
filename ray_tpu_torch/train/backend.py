"""The rank side of a torch.distributed gang, and a local launcher.

Counterpart of `ray_tpu/train/backend.py`'s `TorchConfig` and
`_init_torch_pg`, for ranks that compute on the card: one process per GPU,
NCCL between them, each bound to its card before its first CUDA call; or
gloo between CPU ranks when the caller asks for the CPU (the tests, a dry
run on a host with too few cards). Nothing falls back from one to the
other. The half that runs in the trainer's own process
(`TorchBackend.on_start` over a `WorkerGroup` of actors) needs the port of
the actor runtime and waits for it.

`launch_gang` runs a function on N local ranks (spawned, never forked: a
parent with threads, as a test process with JAX's, cannot fork safely),
returns what each rank returned, and kills every rank and raises as soon as
one fails or the timeout passes, so that a hung collective fails one call
instead of hanging its caller.
"""

from __future__ import annotations

import dataclasses
import datetime
import multiprocessing
import os
import queue as queue_mod
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

from ray_tpu_torch._private import backend_probe
from ray_tpu_torch._private.accelerators.nvidia import visible_devices_env


@dataclasses.dataclass
class TorchConfig:
    """How a rank joins its gang: `backend` None picks NCCL for cuda and
    gloo for cpu; the rendezvous gives up after init_timeout_s, and so
    does every collective after it."""
    backend: Optional[str] = None
    init_timeout_s: int = 300

    def backend_for(self, device_type: str) -> str:
        if self.backend is not None:
            return self.backend
        if device_type == "cuda":
            return "nccl"
        if device_type == "cpu":
            return "gloo"
        raise ValueError(f"no process-group backend for {device_type}")


def init_process_group(rank: int, world_size: int, init_method: str,
                       device=None, config: TorchConfig = TorchConfig()
                       ) -> torch.device:
    """Join the gang as `rank` of `world_size` through `init_method`
    (`tcp://localhost:<port>` or `file://<path>`). device None or "cuda":
    NCCL, this rank on `torch.cuda.current_device()` (the launcher binds
    each rank to one card, which it then sees as cuda:0); "cpu": gloo.
    Returns the rank's device. A process already in a gang raises."""
    dev_type = "cuda" if device is None else torch.device(device).type
    if dist.is_initialized():
        raise RuntimeError("this process is already in a torch.distributed "
                           "gang; destroy_process_group() first")
    kw = {}
    if dev_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("an NCCL rank needs a CUDA card and none is "
                               "visible; ask for device='cpu' to run gloo")
        dev = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(dev)
        kw["device_id"] = dev
    elif dev_type == "cpu":
        dev = torch.device("cpu")
    else:
        raise ValueError(f"unsupported device {device} (use 'cuda' or 'cpu')")
    dist.init_process_group(
        backend=config.backend_for(dev_type), init_method=init_method,
        world_size=world_size, rank=rank,
        timeout=datetime.timedelta(seconds=config.init_timeout_s), **kw)
    return dev


def rank_device() -> torch.device:
    """This rank's device in its gang: its card under NCCL, the CPU under
    gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def destroy_process_group() -> None:
    """Leave the gang, if this process is in one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def _rank_main(fn, rank, world, dev_type, init_method, env, config, args,
               results) -> None:
    """A spawned rank: bind, join, run fn(*args), report, leave."""
    os.environ.update(env)  # before this process's first CUDA call
    if dev_type == "cpu":
        torch.set_num_threads(1)
    try:
        init_process_group(rank, world, init_method, dev_type, config)
        out = fn(*args)
        destroy_process_group()
        results.put((rank, True, out))
    except BaseException:  # reported to the parent, which raises it
        results.put((rank, False, traceback.format_exc()))
        raise


def _rank_env(rank: int, dev_type: str) -> dict:
    """What a spawned rank adds to the environment it inherits: under NCCL
    the binding to the rank-th card of this process's allotment, under
    gloo no card at all."""
    if dev_type == "cpu":
        return backend_probe.force_cpu_env({})
    return {"CUDA_VISIBLE_DEVICES":
            visible_devices_env([rank])["CUDA_VISIBLE_DEVICES"]}


def _stop(procs) -> None:
    for p in procs:
        if p.is_alive():
            p.kill()
    for p in procs:
        p.join(timeout=30)


def launch_gang(fn: Callable, world: int, device=None,
                timeout_s: float = 600.0, args: Sequence[Any] = (),
                init_method: Optional[str] = None) -> List[Any]:
    """Run fn(*args) on `world` spawned ranks that have joined one gang;
    -> the ranks' return values in rank order.

    device None or "cuda": one rank per card, rank r bound by
    CUDA_VISIBLE_DEVICES to the r-th card this process may use (the r-th
    entry of its own CUDA_VISIBLE_DEVICES when that is set) before its
    first CUDA call, NCCL between them;
    raises if this host has fewer than `world` cards (two ranks on one card
    is not a gang NCCL runs). "cpu": gloo ranks that see no card. fn and
    args go to the ranks by pickle: fn must be importable by name, from a
    module that does not import what the ranks must not load. The
    rendezvous is a file store in a fresh temporary directory unless
    `init_method` names one. If a rank raises, dies or the gang has not
    finished after timeout_s, every rank is killed and this raises."""
    dev_type = "cuda" if device is None else torch.device(device).type
    if dev_type == "cuda":
        have = backend_probe.cuda_device_count()
        if have < world:
            raise RuntimeError(f"a {world}-rank NCCL gang needs {world} "
                               f"CUDA cards; this host has {have}")
    elif dev_type != "cpu":
        raise ValueError(f"unsupported device {device} (use 'cuda' or 'cpu')")
    config = TorchConfig(init_timeout_s=max(60, int(timeout_s)))
    tmpdir = None
    if init_method is None:
        tmpdir = tempfile.mkdtemp(prefix="ray_tpu_torch_gang_")
        init_method = "file://" + os.path.join(tmpdir, "store")
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    procs = []
    try:
        for rank in range(world):
            p = ctx.Process(target=_rank_main, daemon=True, args=(
                fn, rank, world, dev_type, init_method,
                _rank_env(rank, dev_type), config,
                tuple(args), results))
            p.start()
            procs.append(p)
        out: List[Any] = [None] * world
        pending = set(range(world))
        deadline = time.monotonic() + timeout_s
        while pending:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"the {world}-rank gang of {fn.__name__} "
                                   f"did not finish in {timeout_s} s; ranks "
                                   f"{sorted(pending)} still running")
            try:
                rank, ok, payload = results.get(timeout=min(left, 1.0))
            except queue_mod.Empty:
                dead = [r for r in pending if procs[r].exitcode is not None]
                if dead:
                    # A message may still be in flight from a rank that
                    # exited; give it a moment before calling it dead.
                    try:
                        rank, ok, payload = results.get(timeout=5.0)
                    except queue_mod.Empty:
                        raise RuntimeError(
                            f"rank {dead[0]} of {fn.__name__} died (exit "
                            f"code {procs[dead[0]].exitcode}) without a "
                            "result") from None
                else:
                    continue
            if not ok:
                raise RuntimeError(f"rank {rank} of the {world}-rank gang of "
                                   f"{fn.__name__} failed:\n{payload}")
            out[rank] = payload
            pending.discard(rank)
        for p in procs:
            p.join(timeout=60)
        return out
    finally:
        _stop(procs)
        results.close()
        results.join_thread()
        if tmpdir is not None:
            shutil.rmtree(tmpdir, ignore_errors=True)
