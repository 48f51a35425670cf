"""The named device mesh of a torch.distributed gang.

Counterpart of `ray_tpu/parallel/mesh.py`: the same `MeshConfig` arithmetic
and errors, and a `torch.distributed.DeviceMesh` over the gang's ranks whose
dims are named in `AXIS_ORDER` (outer to inner: pp, dp, fsdp, ep, sp, tp;
tp innermost, so that its collectives stay between neighbouring ranks, the
cards of one NVLink island). A multi-slice mesh has a leading `dcn` dim:
only data parallelism crosses it. Where the JAX package exchanges nothing
but a coordinator address (`jax.distributed`), the ranks here join a
process group first (`initialize_distributed`, NCCL on the card, gloo on
the CPU); the mesh then cuts its sub-groups out of it, one per dim.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import torch
import torch.distributed as dist

AXIS_ORDER = ("pp", "dp", "fsdp", "ep", "sp", "tp")


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Degrees for each parallelism axis; -1 on dp means 'fill remaining'."""

    dp: int = -1      # data parallel (pure replication of params)
    fsdp: int = 1     # fully-sharded data parallel (params sharded on batch axis)
    tp: int = 1       # tensor (Megatron) parallel
    sp: int = 1       # sequence/context parallel (ring attention)
    pp: int = 1       # pipeline parallel
    ep: int = 1       # expert parallel (MoE)

    def resolved(self, n_devices: int) -> "MeshConfig":
        known = self.fsdp * self.tp * self.sp * self.pp * self.ep
        dp = self.dp
        if dp == -1:
            if n_devices % known != 0:
                raise ValueError(
                    f"device count {n_devices} not divisible by "
                    f"fsdp*tp*sp*pp*ep={known}"
                )
            dp = n_devices // known
        if dp * known != n_devices:
            raise ValueError(
                f"mesh {self} needs {dp * known} devices, have {n_devices}"
            )
        return dataclasses.replace(self, dp=dp)

    def axis_sizes(self) -> Dict[str, int]:
        return {
            "pp": self.pp, "dp": self.dp, "fsdp": self.fsdp,
            "ep": self.ep, "sp": self.sp, "tp": self.tp,
        }


def _world() -> int:
    if not dist.is_initialized():
        raise RuntimeError("a mesh needs a torch.distributed gang: call "
                           "initialize_distributed (or launch_gang) first")
    return dist.get_world_size()


def _device_type(device_type: Optional[str]) -> str:
    """The mesh's device type: the caller's, else the gang's (cuda under
    NCCL, cpu under gloo)."""
    if device_type is not None:
        return device_type
    _world()
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def _device_mesh(device_type, shape, names):
    from torch.distributed.device_mesh import DeviceMesh

    world = _world()
    if math.prod(shape) != world:
        raise ValueError(f"mesh {dict(zip(names, shape))} needs "
                         f"{math.prod(shape)} ranks, the gang has {world}")
    return DeviceMesh(device_type, torch.arange(world).reshape(shape),
                      mesh_dim_names=names)


def build_mesh(config: MeshConfig = MeshConfig(),
               device_type: Optional[str] = None):
    """A DeviceMesh over every rank of the gang, dims AXIS_ORDER with the
    config's degrees (dp=-1 takes the rest); rank r sits at the position
    that a row-major reshape of range(world) gives it, as the JAX mesh
    reshapes its device list."""
    config = config.resolved(_world())
    sizes = config.axis_sizes()
    return _device_mesh(_device_type(device_type),
                        tuple(sizes[a] for a in AXIS_ORDER), AXIS_ORDER)


def build_multislice_mesh(config: MeshConfig = MeshConfig(),
                          num_slices: int = 1,
                          device_type: Optional[str] = None):
    """A mesh over `num_slices` groups of ranks with a leading `dcn` dim:
    the config resolves per slice, each slice is a contiguous block of
    ranks (dcn outermost), and the sharding rules put only the batch on
    `dcn`, so model-axis collectives stay inside a slice. One slice is
    `build_mesh`."""
    if num_slices <= 1:
        return build_mesh(config, device_type)
    world = _world()
    if world % num_slices != 0:
        raise ValueError(
            f"{world} devices not divisible by {num_slices} slices")
    config = config.resolved(world // num_slices)
    sizes = config.axis_sizes()
    return _device_mesh(_device_type(device_type),
                        (num_slices,) + tuple(sizes[a] for a in AXIS_ORDER),
                        ("dcn",) + AXIS_ORDER)


def mesh_sizes(mesh) -> Dict[str, int]:
    """{dim name: size} of a DeviceMesh, or of a mapping given as one."""
    if isinstance(mesh, dict):
        return dict(mesh)
    return {n: mesh.size(i) for i, n in enumerate(mesh.mesh_dim_names)}


def initialize_distributed(init_method: str, num_processes: int,
                           process_id: int, device=None) -> torch.device:
    """Join the gang: the counterpart of `jax.distributed.initialize`.
    A process already in a gang of the same world size and rank stays in
    it (a gang restarted inside a surviving worker must not fail on a
    second init); one bound otherwise leaves it first. -> this rank's
    device (see `_private.gang.init_process_group`)."""
    from ray_tpu_torch._private import gang

    if dist.is_initialized():
        if (dist.get_world_size(), dist.get_rank()) == (num_processes,
                                                        process_id):
            return gang.rank_device()
        gang.destroy_process_group()
    return gang.init_process_group(process_id, num_processes, init_method,
                                   device)


def best_mesh_for(n_devices: int, model_axis_max: int = 8) -> MeshConfig:
    """Heuristic default: TP within a chip-group bound, rest data parallel."""
    tp = math.gcd(n_devices, model_axis_max)
    return MeshConfig(dp=n_devices // tp, tp=tp)
