"""What a rank of a gang that joins by itself runs, as a runtime worker does
under `train.backend.TorchBackend`.

`join` is the worker side of `TorchBackend.on_start` in one process: bind
to the card at the local rank (the process sees every card of its host),
join the gang at rank 0's host and a free port, and build the mesh through
a "mesh" collective group (`train.spmd.setup_worker_mesh`), each call on a
fresh thread, as the runtime's worker runs each call it is sent. `train_run`
then trains Llama on that mesh on another fresh thread, as the runtime runs
a train function, naming no device: the thread reaches the rank's card
through `get_mesh()` and the per-position feed (each rank copies only its
data position's rows of a seeded global batch). It saves the state after
some steps (every rank fetches it whole, rank 0 writes it), or restores it
onto the mesh from such a checkpoint and goes on, and leaves the gang.
`chip_smoke.py` runs it at world 1 in its own process (phase (p)) and on
four spawned ranks (`cards_train_gang`); its CPU rehearsals run it on gloo
ranks. It imports nothing but the port.
"""

from __future__ import annotations

import functools
import hashlib
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch


def on_thread(fn, *args, **kwargs):
    """fn(*args, **kwargs) on a fresh thread, as the runtime's worker runs a
    call or a train function: -> its result, or raises its error."""
    box: Dict[str, Any] = {}

    def run():
        try:
            box["out"] = fn(*args, **kwargs)
        except BaseException as e:  # raised again on the caller's thread
            box["err"] = e

    t = threading.Thread(target=run, name=f"gang-{fn.__name__}")
    t.start()
    t.join()
    if "err" in box:
        raise box["err"]
    return box["out"]


def join(rank: int, world: int, init_method: str, local_rank: int,
         node_ranks: int, mesh_kw: Dict[str, int], group: str, device=None,
         timeout_s: int = 300) -> Dict[str, Any]:
    """Bind, join the gang, build the mesh, each on a fresh thread. ->
    {"card" (PCI bus id, None on the CPU), "device", "bind_s" (the binding:
    this process's first CUDA call), "join_s" (the rendezvous, with the
    wait for the other ranks), "mesh_s" (the mesh's bootstrap through the
    group), "mesh" (its dim sizes)}."""
    from ray_tpu_torch._private import gang
    from ray_tpu_torch.parallel.mesh import MeshConfig
    from ray_tpu_torch.train import spmd

    t0 = time.perf_counter()
    card = on_thread(gang.bind_card, local_rank, device,
                     node_ranks=node_ranks)
    t1 = time.perf_counter()
    dev = on_thread(gang.join_gang, init_method, world, rank, device,
                    timeout_s)
    t2 = time.perf_counter()
    sizes = on_thread(spmd.setup_worker_mesh, MeshConfig(**mesh_kw),
                      group_name=group, world_size=world, rank=rank,
                      distributed=True)
    return {"card": card, "device": dev, "bind_s": t1 - t0,
            "join_s": t2 - t1, "mesh_s": time.perf_counter() - t2,
            "mesh": sizes}


def local_digests(tree) -> List[str]:
    """One digest a leaf on this rank, in tree order: the sha256 of a
    tensor's bytes (a DTensor's local block) or of a numpy array's, the
    type and repr of a scalar (an optimizer's step count). Equal lists are
    the same state, bit for bit, on this rank."""
    from torch.distributed.tensor import DTensor

    from ray_tpu_torch.train.checkpoint import _map_tree

    out: List[str] = []

    def one(x, _):
        if isinstance(x, torch.Tensor):
            t = x.to_local() if isinstance(x, DTensor) else x
            t = t.detach().contiguous().cpu().reshape(-1)
            out.append(hashlib.sha256(t.view(torch.uint8).numpy()
                                      ).hexdigest())
        elif isinstance(x, (np.ndarray, np.generic)):
            a = np.ascontiguousarray(x)
            out.append(f"{a.dtype}{a.shape}:" + hashlib.sha256(
                a.reshape(-1).view(np.uint8)).hexdigest())
        elif x is None or isinstance(x, (bool, int, float, str)):
            out.append(f"{type(x).__name__}:{x!r}")
        return x

    _map_tree(one, tree, tree)
    return out


def _card_of(t: torch.Tensor) -> Optional[str]:
    """The PCI bus id of the card a tensor (a DTensor's block) lies on;
    None on the CPU."""
    from ray_tpu_torch._private import gang

    t = t.to_local() if hasattr(t, "to_local") else t
    return gang.card_id(t.device.index) if t.device.type == "cuda" else None


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def train_run(rank: int, world: int, init_method: str, local_rank: int,
              node_ranks: int, group: str, cfg, mesh_kw: Dict[str, int],
              tokens: np.ndarray, steps: int, save_after: int,
              ckpt_dir: str, restore: bool, seed: int = 0,
              lr: float = 3e-4, device=None, compiled: bool = True,
              timeout_s: int = 300) -> Dict[str, Any]:
    """One gang's run on this rank: `join` (device None: the card, "cpu":
    gloo), then `train` on a fresh thread; then leave the gang. -> `join`'s
    result and `train`'s."""
    from ray_tpu_torch.train import backend

    out = join(rank, world, init_method, local_rank, node_ranks, mesh_kw,
               group, device, timeout_s)
    try:
        out.update(on_thread(train, rank, cfg, tokens, steps, save_after,
                             ckpt_dir, restore, seed, lr, compiled))
        return out
    finally:
        if compiled:
            torch._dynamo.reset()
        backend.leave_gang()


def train(rank: int, cfg, tokens: np.ndarray, steps: int, save_after: int,
          ckpt_dir: str, restore: bool, seed: int = 0, lr: float = 3e-4,
          compiled: bool = True) -> Dict[str, Any]:
    """A train function on the gang's mesh, written as a user writes one: it
    names no device, taking the mesh's device type, so its tensors land on
    the card this thread was bound to when it reached the mesh
    (`get_mesh()`). The seeded Llama state on the mesh (`cfg`, AdamW at lr,
    no weight decay) or, with `restore`, the state of the checkpoint in
    `ckpt_dir` placed onto the mesh (`place_like`); then the steps from the
    checkpoint's (0 without one) to `steps`, step i fed this rank's data
    position's rows of the global batch tokens[i] ([steps, batch, seq + 1],
    the same on every rank) through `iter_device_batches(local_rows=True)`;
    after `save_after` steps (when not restoring) the state saved to
    `ckpt_dir`. -> {"position", "first_step", "losses", "global_equal" (per
    step: the global batch the feed assembled equals tokens[i] exactly),
    "launches" (per step, this process's flash kernel launches), "step_s"
    (per step, the first with its compile), "step_cards" (the cards the
    state and the first batch lie on), "saved" / "restored"
    (`local_digests` of the state saved or restored), "save_s" /
    "restore_s"}."""
    from ray_tpu_torch.data import iter_device_batches
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.train import (Checkpoint, adamw, host_tree,
                                     init_train_state, make_train_step,
                                     place_like, spmd)
    from ray_tpu_torch.train.spmd_bench import compile_backend, launch_counts

    mesh = spmd.get_mesh()
    dev = torch.device(mesh.device_type)
    opt = adamw(lr, weight_decay=0.0)
    state = init_train_state(
        functools.partial(llama.init, cfg, torch.Generator(
            device=dev).manual_seed(seed)), opt, device=dev,
        param_logical_axes=llama.param_logical_axes(cfg), mesh=mesh)
    first = 0
    out: Dict[str, Any] = {}
    if restore:
        t0 = time.perf_counter()
        host = Checkpoint.from_directory(ckpt_dir).to_arrays()
        state = place_like(host["state"], state)
        first = int(host["step"])
        del host
        _sync(dev)
        out["restore_s"] = time.perf_counter() - t0
        out["restored"] = local_digests(state)
    if compiled:
        torch._dynamo.reset()
    step = make_train_step(functools.partial(llama.loss_fn, config=cfg,
                                             mesh=mesh), opt,
                           compiled=compiled, backend=compile_backend(dev))
    sharding = spmd.batch_sharding(mesh)
    pos, n = spmd.data_position(sharding, mesh)
    rows = tokens.shape[1] // n
    mine = tokens[first:steps, pos * rows:(pos + 1) * rows]
    feed = iter_device_batches(
        ({"inputs": t[:, :-1], "targets": t[:, 1:]} for t in mine),
        sharding=sharding, mesh=mesh, local_rows=True)
    out.update(position=[pos, n], first_step=first, losses=[],
               global_equal=[], launches=[], step_s=[], step_cards=[])
    for i, batch in zip(range(first, steps), feed):
        if i == first:
            out["step_cards"] = sorted({str(_card_of(x)) for x in (
                batch["inputs"], state.params["embed"])})
        whole = batch["inputs"].full_tensor().cpu().numpy()
        out["global_equal"].append(bool(np.array_equal(
            whole, tokens[i][:, :-1])))
        before = launch_counts()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        out["losses"].append(float(m["loss"]))  # waits for the step
        out["step_s"].append(time.perf_counter() - t0)
        after = launch_counts()
        out["launches"].append({k: after[k] - before[k] for k in after})
        if not restore and i + 1 == save_after:
            t0 = time.perf_counter()
            saved = host_tree({"state": state, "step": i + 1})
            if rank == 0:
                Checkpoint.from_arrays(saved, ckpt_dir)
            out["save_s"] = time.perf_counter() - t0
            out["saved"] = local_digests(state)
            del saved
    return out


def gang_ranks(rank: int, world: int, init_method: str, local_ranks_: List[int],
               node_ranks: List[int], group: str, args: tuple,
               kwargs: Optional[dict] = None) -> Dict[str, Any]:
    """`train.backend.spawn_ranks`' entry: `train_run` as rank `rank`, with
    the local rank and the count of its node's ranks the caller derived
    from the ranks' nodes (`train.backend.local_ranks`)."""
    return train_run(rank, world, init_method, local_ranks_[rank],
                     node_ranks[rank], group, *args, **(kwargs or {}))
