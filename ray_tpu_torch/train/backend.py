"""A torch.distributed gang: the trainer's side over the runtime's actors,
and a local launcher.

Counterpart of `ray_tpu/train/backend.py`: one process per GPU, NCCL
between them, each bound to its card before its first CUDA call; or gloo
between CPU ranks when the caller asks for the CPU (the tests, a dry run on
a host with too few cards). Nothing falls back from one to the other.

- `TorchConfig` and `TorchBackend`, the counterparts of `JaxConfig` and
  `JaxBackend`: the runtime's `DataParallelTrainer` takes the config as
  its `backend_config` and calls the backend's hooks with its
  `WorkerGroup`. `on_start` binds each worker to the card at its local
  rank, gathers the workers at rank 0's host and a port rank 0's worker
  holds (`gang.gang_address`), and in mesh
  mode builds the mesh through a collective group (`train.spmd`). What
  each worker runs for it (`bind_card`, `join_gang`, ...) lives in
  `_private.gang`, which the collective groups declared over actors share.
- `launch_gang` runs a function on N local ranks that have joined one gang,
  `spawn_ranks` on N local ranks that join by themselves (spawned, never
  forked: a parent with threads, as a test process with JAX's, cannot fork
  safely). Each returns what each rank returned, and kills every rank and
  raises as soon as one fails or the timeout passes, so that a hung
  collective fails one call instead of hanging its caller.

The port reaches the runtime only through what the runtime hands it: the
`WorkerGroup`, its actor handles, and the `ObjectRef`s their `.remote()`
calls return, each resolved through its own `future()` (`gang.resolve`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import multiprocessing
import os
import queue as queue_mod
import shutil
import tempfile
import time
import traceback
import uuid
from typing import Any, Callable, List, Optional, Sequence

import torch

from ray_tpu_torch._private import backend_probe, gang
from ray_tpu_torch._private.accelerators.nvidia import visible_devices_env
from ray_tpu_torch._private.gang import (bind_card, destroy_process_group,  # noqa: F401
                                         gang_address, join_gang,
                                         rank_device, resolve)

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class TorchConfig:
    """How a gang of workers joins, the counterpart of `JaxConfig` (the
    runtime's `DataParallelTrainer` takes it as `backend_config`).

    `device` takes the place of JaxConfig's `platform`: None is the card
    (NCCL; each worker bound to the card at its local rank, raising without
    CUDA), "cpu" gloo. `backend` None picks NCCL for the card and gloo for
    the CPU; the rendezvous gives up after init_timeout_s, and so does every
    collective after it. `distributed=True` gathers the workers into one
    gang at rank 0's host and a port its worker serves the rendezvous on
    (`gang.gang_address`; `coordinator_port` when set, served by rank 0);
    False leaves each worker alone on its card, as JaxConfig's default does.
    `env_vars` are set in each worker before its first CUDA call.
    `mesh_config` (a `parallel.mesh.MeshConfig`) switches to mesh-native
    mode: every worker builds the named mesh through a collective group,
    and train functions reach it with `train.spmd.get_mesh()`; with more
    than one worker it needs distributed=True, as JaxConfig's does.
    `num_slices` > 1 puts a leading `dcn` dim on that mesh."""
    backend: Optional[str] = None
    init_timeout_s: int = 300
    distributed: bool = False
    coordinator_port: int = 0
    env_vars: Optional[dict] = None
    mesh_config: Optional[Any] = None
    num_slices: int = 1
    device: Optional[str] = None

    @property
    def backend_cls(self):
        return TorchBackend

    def backend_for(self, device_type: str) -> str:
        return gang.process_group_backend(self.backend, device_type)


def init_process_group(rank: int, world_size: int, init_method: str,
                       device=None, config: TorchConfig = TorchConfig()
                       ) -> torch.device:
    """Join the gang as `rank` of `world_size` through `init_method`
    (`tcp://<host>:<port>` or `file://<path>`) with `config`'s backend and
    timeout (`_private.gang.init_process_group`). device None or "cuda":
    NCCL, this rank on the card `bind_card` bound it to, else on
    `torch.cuda.current_device()` (`launch_gang` binds each rank to one
    card, which it then sees as cuda:0); "cpu": gloo. Returns the rank's
    device. A process already in a gang raises."""
    return gang.init_process_group(rank, world_size, init_method, device,
                                   config.backend, config.init_timeout_s)


def leave_gang() -> None:
    """Tear down this worker's mesh (`train.spmd.teardown_worker_mesh`,
    which destroys its collective group), then leave the gang."""
    from ray_tpu_torch.train.spmd import teardown_worker_mesh

    teardown_worker_mesh()
    destroy_process_group()


_MESH_NEEDS_DISTRIBUTED = (
    "mesh_config with num_workers>1 requires "
    "TorchConfig(distributed=True): a multi-worker gang must "
    "rendezvous into ONE global mesh; distributed=False would "
    "give {world} workers {world} independent local meshes "
    "with no gradient sync")


class TorchBackend:
    """The hooks the runtime's `BackendExecutor` calls around its gang of
    workers, the counterpart of `JaxBackend` (ray_tpu/train/backend.py). It
    has the runtime's `Backend` interface and does not subclass it: the
    port imports nothing of `ray_tpu`."""

    def on_start(self, worker_group, config: TorchConfig) -> None:
        world = worker_group.num_workers
        mesh_mode = config.mesh_config is not None
        if mesh_mode and world > 1 and not config.distributed:
            # As JaxBackend: each worker would build its own local mesh and
            # train a copy of the model with no gradient sync.
            raise ValueError(_MESH_NEEDS_DISTRIBUTED.format(world=world))
        workers = worker_group.workers
        meta = worker_group.group_metadata()
        timeout = config.init_timeout_s
        join = None
        if config.distributed or mesh_mode:
            # rank 0's worker serves the rendezvous on a port it holds
            port = config.coordinator_port or worker_group.execute_single(
                0, gang_address)["port"]
            init_method = f"tcp://{meta[0]['hostname']}:{port}"
            logger.info("torch.distributed gang of %d at %s", world,
                        init_method)

            def join(r):
                return workers[r].execute.remote(
                    join_gang, init_method, world, r, config.device, timeout,
                    config.backend)

        try:
            gang.gather_gang([m["node_id"] for m in meta],
                             lambda r, local, n: workers[r].execute.remote(
                                 bind_card, local, config.device,
                                 config.env_vars, n),
                             join, timeout)
        except BaseException:
            if join is not None:  # rank 0's worker may not have joined
                with contextlib.suppress(Exception):
                    workers[0].execute.remote(gang.release_address,
                                              init_method)
            raise
        if mesh_mode:
            from ray_tpu_torch.train.spmd import setup_worker_mesh

            group = f"rt_train_mesh:{uuid.uuid4().hex[:8]}"
            shapes = resolve([w.execute.remote(
                setup_worker_mesh, config.mesh_config, group_name=group,
                world_size=world, rank=r, distributed=config.distributed,
                num_slices=config.num_slices)
                for r, w in enumerate(workers)], list(range(world)),
                "build the mesh", timeout)
            if len(set(map(str, shapes))) != 1:
                raise RuntimeError(
                    f"gang workers disagree on mesh shape: {shapes}")
            logger.info("gang mesh established: %s", shapes[0])

    def on_training_start(self, worker_group, config: TorchConfig) -> None:
        pass

    def on_shutdown(self, worker_group, config: TorchConfig) -> None:
        """Every worker leaves its mesh's group and the gang; best-effort,
        as JaxBackend's teardown (a worker that is gone or stuck is left
        to the runtime, which kills the gang's actors next)."""
        workers = worker_group.workers
        try:
            resolve([w.execute.remote(leave_gang) for w in workers],
                    list(range(len(workers))), "leave the gang", 30.0)
        except Exception:  # noqa: BLE001 - teardown is best-effort
            logger.debug("gang teardown failed", exc_info=True)


# -- local launchers ---------------------------------------------------------------

def _rank_main(fn, rank, world, dev_type, init_method, env, config, args,
               results) -> None:
    """A spawned rank: bind, join, run fn(*args), report, leave; with no
    `init_method`, run fn(rank, *args), which joins by itself."""
    os.environ.update(env)  # before this process's first CUDA call
    if dev_type == "cpu":
        torch.set_num_threads(1)
    try:
        if init_method is None:
            out = fn(rank, *args)
        else:
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


def _need_cards(world: int, dev_type: str) -> None:
    if dev_type == "cuda":
        have = backend_probe.cuda_device_count()
        if have < world:
            raise RuntimeError(f"a {world}-rank NCCL gang needs {world} "
                               f"CUDA cards; this host has {have}")


def _run_ranks(fn, world, dev_type, init_method, envs, config, args,
               timeout_s) -> List[Any]:
    """Spawn `world` ranks of `_rank_main`, wait for their results; kill
    them all and raise on the first failure, death or the timeout."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    procs = []
    try:
        for rank in range(world):
            p = ctx.Process(target=_rank_main, daemon=True, args=(
                fn, rank, world, dev_type, init_method, envs[rank], config,
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
    dev_type = gang.device_type(device)
    _need_cards(world, dev_type)
    config = TorchConfig(init_timeout_s=max(60, int(timeout_s)))
    tmpdir = None
    if init_method is None:
        tmpdir = tempfile.mkdtemp(prefix="ray_tpu_torch_gang_")
        init_method = "file://" + os.path.join(tmpdir, "store")
    try:
        return _run_ranks(fn, world, dev_type, init_method,
                          [_rank_env(r, dev_type) for r in range(world)],
                          config, args, timeout_s)
    finally:
        if tmpdir is not None:
            shutil.rmtree(tmpdir, ignore_errors=True)


def spawn_ranks(fn: Callable, world: int, device=None,
                timeout_s: float = 600.0, args: Sequence[Any] = ()
                ) -> List[Any]:
    """Run fn(rank, *args) on `world` spawned processes that join their gang
    by themselves, as the runtime's workers do under `TorchBackend`: on the
    card each sees every card of this host (and binds itself, `bind_card`),
    on the CPU none. -> their return values in rank order; a rank that is
    still in a gang when fn returns leaves it. Failures and the timeout as
    `launch_gang`."""
    dev_type = gang.device_type(device)
    _need_cards(world, dev_type)
    env = backend_probe.force_cpu_env({}) if dev_type == "cpu" else {}
    return _run_ranks(fn, world, dev_type, None, [env] * world, None, args,
                      timeout_s)
