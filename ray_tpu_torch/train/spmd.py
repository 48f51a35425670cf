"""Rank-side SPMD mesh state and batch placement.

Counterpart of `ray_tpu/train/spmd.py`. When `TorchConfig.mesh_config` is
set, every worker of the gang builds the named mesh through a "mesh"
collective group (`setup_worker_mesh`, `util.collective.bootstrap_mesh`)
during `TorchBackend.on_start`, and the train function reaches it with
`get_mesh()`. A world-1 gang builds a 1 x ... x 1 mesh and runs the same
code.

- `batch_sharding`: the placements of a [batch, seq] token batch under the
  logical-axis rules (batch over the data dims, seq over sp).
- `shard_local_batch`: a global numpy batch (made from a seed, the same on
  every rank) -> each rank's DTensor block of it, the block that JAX's
  NamedSharding gives the same mesh position, so both compute the same
  global loss.
- `shard_position_batch`: this process's rows only, as each JAX process of
  a multi-host gang holds only its own: the rows of this rank's data
  position (`data_position`), the global batch being every position's rows
  concatenated in position order. The ranks of one position (its tp, sp,
  ... peers) pass the same rows.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Tuple

import numpy as np
import torch

from ray_tpu_torch._private import gang

_state_lock = threading.Lock()
_state: Dict[str, Any] = {"mesh": None, "group": None}


def get_mesh():
    """The gang mesh `setup_worker_mesh` built for this worker (None
    outside mesh mode). Where the worker is bound to a card, the calling
    thread is made to use it: the runtime runs a train function on a thread
    of its own, whose current card would otherwise be card 0."""
    gang.bind_thread()
    with _state_lock:
        return _state["mesh"]


def setup_worker_mesh(mesh_config, *, group_name: str, world_size: int,
                      rank: int, distributed: bool, num_slices: int = 1,
                      mesh_axes=None) -> Dict[str, int]:
    """Bootstrap this worker's gang mesh through a "mesh" collective group.

    Runs inside each gang worker (dispatched by `TorchBackend.on_start`),
    after it has joined the gang. distributed=False gangs build per-process
    local meshes (world-1 groups over a world-1 gang); distributed=True
    gangs build one mesh over the whole gang. -> the mesh's dim sizes, for
    the trainer to compare."""
    from ray_tpu_torch.parallel.mesh import mesh_sizes
    from ray_tpu_torch.util import collective as col

    gang.bind_thread()  # the mesh's first collectives run on this thread
    ws, rk = ((world_size, rank) if (distributed and world_size > 1)
              else (1, 0))
    if not col.is_group_initialized(group_name):
        col.init_collective_group(ws, rk, backend="mesh",
                                  group_name=group_name, mesh_axes=mesh_axes)
    mesh = col.bootstrap_mesh(mesh_config, group_name=group_name,
                              num_slices=num_slices)
    with _state_lock:
        _state["mesh"] = mesh
        _state["group"] = group_name
    return mesh_sizes(mesh)


def teardown_worker_mesh() -> None:
    """Forget the mesh and destroy its collective group."""
    from ray_tpu_torch.util import collective as col

    with _state_lock:
        group = _state["group"]
        _state["mesh"] = None
        _state["group"] = None
    if group is not None and col.is_group_initialized(group):
        col.destroy_collective_group(group)


def batch_sharding(mesh=None, rules=None, logical=("batch", "seq")):
    """Placements of a global token batch on the (gang) mesh."""
    from ray_tpu_torch.parallel.sharding import (LogicalAxisRules,
                                                 logical_sharding)

    mesh = mesh if mesh is not None else get_mesh()
    if mesh is None:
        raise RuntimeError(
            "batch_sharding needs a mesh: pass one, or call "
            "setup_worker_mesh first")
    return logical_sharding(mesh, logical, rules or LogicalAxisRules())


def shard_local_batch(batch: Dict[str, Any], sharding, mesh=None,
                      device=None) -> Dict[str, Any]:
    """{name: global numpy array} -> {name: DTensor}: each rank copies only
    its block of each array to its device (`device`, default the rank's:
    its card under NCCL, the CPU under gloo), never the whole batch."""
    from torch.distributed.tensor import DTensor

    from ray_tpu_torch.parallel.sharding import local_slices

    mesh = mesh if mesh is not None else get_mesh()
    device = gang.rank_device() if device is None else device
    out = {}
    for name, full in batch.items():
        full = np.asarray(full)
        block = full[local_slices(full.shape, sharding, mesh)]
        local = torch.as_tensor(np.ascontiguousarray(block), device=device)
        out[name] = DTensor.from_local(
            local, mesh, sharding, run_check=False, shape=full.shape,
            stride=torch.empty(full.shape, device="meta").stride())
    return out


def data_position(sharding, mesh=None) -> Tuple[int, int]:
    """(this rank's data position, the number of positions): the block of
    the batch dim (dim 0) that `sharding` gives this rank, of those it cuts
    the dim into (one per position over the mesh dims it shards the dim
    on: dp x fsdp under the default rules; 1 when none)."""
    from torch.distributed.tensor import Shard

    from ray_tpu_torch.parallel.sharding import local_slices

    mesh = mesh if mesh is not None else get_mesh()
    n = 1
    for i, p in enumerate(sharding):
        if isinstance(p, Shard) and p.dim == 0:
            n *= mesh.size(i)
    rows = local_slices((n,), sharding, mesh)[0]
    return rows.start, n


def shard_position_batch(batch: Dict[str, Any], sharding, mesh=None,
                         device=None) -> Dict[str, Any]:
    """{name: this position's rows as numpy} -> {name: DTensor} of the
    global batch, every data position's rows concatenated in position
    order (`data_position`): each rank copies only its block of its rows
    to its device (`device`, default the rank's), the block
    `shard_local_batch` cuts from that global batch."""
    from torch.distributed.tensor import DTensor

    from ray_tpu_torch.parallel.sharding import local_slices

    mesh = mesh if mesh is not None else get_mesh()
    device = gang.rank_device() if device is None else device
    pos, n = data_position(sharding, mesh)
    out = {}
    for name, rows in batch.items():
        rows = np.asarray(rows)
        shape = (rows.shape[0] * n,) + rows.shape[1:]
        cut = local_slices(shape, sharding, mesh)
        if (cut[0].start, cut[0].stop) != (pos * rows.shape[0],
                                           (pos + 1) * rows.shape[0]):
            raise ValueError(f"{name}: the batch dim is cut finer than the "
                             f"data positions ({cut[0]} of {shape[0]} rows)")
        block = rows[(slice(None),) + cut[1:]]
        local = torch.as_tensor(np.ascontiguousarray(block), device=device)
        out[name] = DTensor.from_local(
            local, mesh, sharding, run_check=False, shape=shape,
            stride=torch.empty(shape, device="meta").stride())
    return out
