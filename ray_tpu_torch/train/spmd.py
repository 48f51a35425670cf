"""Rank-side SPMD mesh state and batch placement.

Counterpart of `ray_tpu/train/spmd.py`. Each rank of a gang builds the same
named mesh once it has joined the process group (`setup_worker_mesh`), and
the train function reaches it with `get_mesh()`. A world-1 gang builds a
1 x ... x 1 mesh and runs the same code.

- `batch_sharding`: the placements of a [batch, seq] token batch under the
  logical-axis rules (batch over the data dims, seq over sp).
- `shard_local_batch`: a global numpy batch (made from a seed, the same on
  every rank) -> each rank's DTensor block of it, the block that JAX's
  NamedSharding gives the same mesh position, so both compute the same
  global loss.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Optional

import numpy as np
import torch

_state_lock = threading.Lock()
_state: Dict[str, Any] = {"mesh": None}


def get_mesh():
    """The mesh `setup_worker_mesh` built for this rank (None before)."""
    with _state_lock:
        return _state["mesh"]


def setup_worker_mesh(mesh_config, *, num_slices: int = 1,
                      device_type: Optional[str] = None) -> Dict[str, int]:
    """Build this rank's gang mesh over the process group it has joined
    (`train.backend`), keep it for `get_mesh`, and return its dim sizes."""
    from ray_tpu_torch.parallel.mesh import build_multislice_mesh, mesh_sizes

    mesh = build_multislice_mesh(mesh_config, num_slices=num_slices,
                                 device_type=device_type)
    with _state_lock:
        _state["mesh"] = mesh
    return mesh_sizes(mesh)


def teardown_worker_mesh() -> None:
    with _state_lock:
        _state["mesh"] = None


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

    from ray_tpu_torch.train.backend import rank_device

    mesh = mesh if mesh is not None else get_mesh()
    device = rank_device() if device is None else device
    out = {}
    for name, full in batch.items():
        full = np.asarray(full)
        block = full[local_slices(full.shape, sharding, mesh)]
        local = torch.as_tensor(np.ascontiguousarray(block), device=device)
        out[name] = DTensor.from_local(
            local, mesh, sharding, run_check=False, shape=full.shape,
            stride=torch.empty(full.shape, device="meta").stride())
    return out
