"""Logical-axis sharding rules over a named DeviceMesh.

Counterpart of `ray_tpu/parallel/sharding.py`. Model code names each
tensor dim by a LOGICAL axis ("batch", "seq", "embed", "heads", "mlp",
"vocab", "kv", "expert", "layers"); the same rule table as the JAX
package's maps logical axes to mesh dims, size-1 and absent mesh dims drop
out, and `to_physical` gives the DTensor placements of that layout: a
`Shard(d)` on every mesh dim that tensor dim d maps to and `Replicate()`
on the others. A tensor dim over several mesh dims ("batch" over dcn, dp
and fsdp) is split in the mesh's major-to-minor order, as JAX's
PartitionSpec of a tuple splits it.

Where GSPMD inserts the collectives that a sharding implies, the port
says them: `with_logical_constraint` is `DTensor.redistribute`, and
`ShardingContext` holds the few the Llama model needs (a layer's weights
gathered right before use, whose backward is the gradients'
reduce-scatter; the tensor-parallel sum of a row-parallel product; the sum
of the loss over the data dims).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import torch

from ray_tpu_torch.parallel.mesh import mesh_sizes

PhysicalAxes = Union[None, str, Tuple[str, ...]]

# Default rule table: logical axis -> mesh axis (or tuple). dp x fsdp x tp.
# Parameter axes ("embed", "heads", ...) and activation axes ("act_*") are
# distinct namespaces: under FSDP the parameter embed dim shards over `fsdp`
# while the activation batch dim also uses `fsdp` — a single tensor may not
# map one mesh axis twice, so activations never reuse parameter rules.
DEFAULT_RULES: List[Tuple[str, PhysicalAxes]] = [
    # activations
    # batch over ALL data-parallel axes, incl. the inter-slice `dcn` axis
    # of multi-slice meshes (absent/size-1 axes drop out).
    ("batch", ("dcn", "dp", "fsdp")),
    ("seq", "sp"),               # sequence/context parallel
    ("act_embed", None),         # activations: embed replicated
    ("act_heads", "tp"),         # attention activations: heads over TP
    ("act_kv", None),
    ("act_mlp", "tp"),           # MLP activations: hidden over TP
    ("act_vocab", "tp"),         # logits: vocab over TP
    # parameters
    ("embed", "fsdp"),           # params: embed dim sharded for FSDP
    ("heads", "tp"),             # attention heads: tensor parallel
    ("kv", None),                # per-head dim: replicated
    ("mlp", "tp"),               # MLP hidden: tensor parallel
    ("vocab", "tp"),             # vocab dim: tensor parallel
    ("expert", "ep"),            # MoE experts
    ("layers", None),            # stacked layer dim: replicated (pp handles)
    ("stage", "pp"),             # pipeline stage dim
]


class LogicalAxisRules:
    def __init__(self, rules: Optional[Sequence[Tuple[str, PhysicalAxes]]] = None):
        self._rules: Dict[str, PhysicalAxes] = dict(rules if rules is not None else DEFAULT_RULES)

    def spec(self, logical_axes: Sequence[Optional[str]], mesh=None
             ) -> Tuple[PhysicalAxes, ...]:
        """The JAX PartitionSpec's entries: per tensor dim None, a mesh dim
        name or a tuple of them, mesh dims of size 1 (or absent from
        `mesh`, a DeviceMesh or {name: size}) dropped."""
        sizes = mesh_sizes(mesh) if mesh is not None else None

        def resolve(name: Optional[str]):
            if name is None:
                return None
            phys = self._rules.get(name)
            if phys is None:
                return None
            axes = (phys,) if isinstance(phys, str) else tuple(phys)
            if sizes is not None:
                axes = tuple(a for a in axes if sizes.get(a, 1) > 1)
            if not axes:
                return None
            return axes if len(axes) > 1 else axes[0]

        return tuple(resolve(n) for n in logical_axes)

    def to_physical(self, logical_axes: Sequence[Optional[str]], mesh
                    ) -> Tuple[Any, ...]:
        """DTensor placements, one per mesh dim, of a tensor whose dims are
        `logical_axes`: Shard(d) where tensor dim d maps to the mesh dim,
        Replicate() elsewhere."""
        from torch.distributed.tensor import Replicate, Shard

        names = _dim_names(mesh)
        placements: List[Any] = [Replicate()] * len(names)
        for d, phys in enumerate(self.spec(logical_axes, mesh)):
            axes = () if phys is None else (
                (phys,) if isinstance(phys, str) else phys)
            order = [names.index(a) for a in axes]
            if order != sorted(order):
                raise ValueError(
                    f"tensor dim {d} splits over {axes}, not in the mesh's "
                    f"order {names}: DTensor splits major to minor")
            for i in order:
                if placements[i] != Replicate():
                    raise ValueError(f"mesh dim {names[i]} is used twice in "
                                     f"{tuple(logical_axes)}")
                placements[i] = Shard(d)
        return tuple(placements)

    def replace(self, **kwargs: PhysicalAxes) -> "LogicalAxisRules":
        new = LogicalAxisRules(list(self._rules.items()))
        new._rules.update(kwargs)
        return new


def _dim_names(mesh) -> Tuple[str, ...]:
    if isinstance(mesh, dict):
        return tuple(mesh)
    return tuple(mesh.mesh_dim_names)


def logical_sharding(mesh, logical_axes: Sequence[Optional[str]],
                     rules: Optional[LogicalAxisRules] = None):
    """The placements of `logical_axes` on `mesh` (the NamedSharding's
    counterpart; the DTensor takes the mesh beside them)."""
    return (rules or LogicalAxisRules()).to_physical(logical_axes, mesh)


def with_logical_constraint(x, logical_axes: Sequence[Optional[str]],
                            mesh=None, rules: Optional[LogicalAxisRules] = None):
    """A DTensor in the layout `logical_axes` names: `redistribute`, which
    moves nothing when x already has it. A plain tensor (no mesh) is
    returned as it is, as the JAX constraint is a no-op without a mesh."""
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh if mesh is None else mesh
    return x.redistribute(mesh, logical_sharding(mesh, logical_axes, rules))


def local_slices(shape: Sequence[int], placements, mesh) -> Tuple[slice, ...]:
    """This rank's block of a tensor of `shape` under `placements`: per
    tensor dim, the slice that the Shard placements on it give this rank's
    mesh coordinate, major to minor. Raises where a dim does not divide."""
    from torch.distributed.tensor import Shard

    coord = mesh.get_coordinate()
    out = []
    for d, n in enumerate(shape):
        start, size = 0, n
        for i, p in enumerate(placements):
            if isinstance(p, Shard) and p.dim == d:
                k = mesh.size(i)
                if size % k:
                    raise ValueError(
                        f"dim {d} of {tuple(shape)} ({size} at this split) "
                        f"does not divide over mesh dim "
                        f"{mesh.mesh_dim_names[i]} of size {k}")
                size //= k
                start += coord[i] * size
        out.append(slice(start, start + size))
    return tuple(out)


def distribute_full(full: torch.Tensor, mesh, placements):
    """A DTensor from a tensor that every rank holds in full (the same
    values, as from one seed): each rank keeps its block, with no
    communication (JAX's device_put of a host array)."""
    from torch.distributed.tensor import DTensor

    local = full[local_slices(full.shape, placements, mesh)].contiguous()
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=full.shape, stride=full.stride())


def _map_axes(fn, params, axes):
    if isinstance(params, dict):
        return {k: _map_axes(fn, params[k], axes[k]) for k in params}
    return fn(params, axes)


def shard_params(params, param_logical_axes, mesh,
                 rules: Optional[LogicalAxisRules] = None):
    """Full parameters (nested dictionaries, the same on every rank) ->
    DTensors in their logical shardings. `param_logical_axes` is a matching
    tree of tuples of logical axis names (None: replicated)."""
    rules = rules or LogicalAxisRules()
    return _map_axes(lambda w, axes: distribute_full(
        w, mesh, rules.to_physical(axes if axes is not None
                                   else (None,) * w.dim(), mesh)),
        params, param_logical_axes)


def param_shardings(param_logical_axes, mesh, rules=None):
    """Tree of placements from a tree of logical-axes tuples."""
    rules = rules or LogicalAxisRules()
    if isinstance(param_logical_axes, dict):
        return {k: param_shardings(v, mesh, rules)
                for k, v in param_logical_axes.items()}
    return rules.to_physical(param_logical_axes or (), mesh)


def full_tensor(x) -> torch.Tensor:
    """The whole tensor on every rank (a plain tensor is returned as is)."""
    from torch.distributed.tensor import DTensor

    return x.full_tensor() if isinstance(x, DTensor) else x


class ShardingContext:
    """The mesh layout a sharded Llama step runs under, and the collectives
    it implies, for code that computes on each rank's local blocks.

    `data_dims`: the mesh dims (of size > 1) the rules put "batch" or "seq"
    on; each rank holds only its tokens, so a parameter's gradient is a
    partial sum over them. `gather` makes a parameter whole over those dims
    right before its use (FSDP's all-gather) and declares the local
    gradient partial there, so that the backward of the gather reduces it:
    a reduce-scatter over dims the parameter is sharded on, an all-reduce
    over dims it is replicated on. `tp_sum` is the constraint after a
    row-parallel product (a Partial over tp made Replicate: an all-reduce,
    its backward the identity; `tp_sum_f32` the same sum of fp32 partials,
    the engines'); `tp_copy` its conjugate before a column-parallel one
    (the identity forward, an all-reduce of the gradient). `data_sum` sums
    a per-rank partial over the data dims the same way. `data_axes`: the
    logical activation axes whose split makes a rank's gradient partial (a
    model that does not split its sequence gives ("batch",), and its sp
    ranks are replicas). `whole` gathers a block on every rank for code
    that computes the same thing on each (the MoE block on JAX's token
    partition)."""

    def __init__(self, mesh, rules: Optional[LogicalAxisRules] = None,
                 data_axes: Sequence[str] = ("batch", "seq")):
        from torch.distributed.tensor import Partial, Replicate

        self.mesh = mesh
        self.rules = rules or LogicalAxisRules()
        self.sizes = mesh_sizes(mesh)
        self.names = _dim_names(mesh)
        coord = mesh.get_coordinate()
        self.coord = dict(zip(self.names, coord))
        data = set()
        for logical in data_axes:
            phys = self.rules.spec((logical,), mesh)[0]
            data.update((phys,) if isinstance(phys, str) else phys or ())
        self.data_dims = tuple(n for n in self.names if n in data)
        self.tp = self.sizes.get("tp", 1)
        self._replicate = tuple(Replicate() for _ in self.names)
        self._partial_data = tuple(
            Partial() if n in self.data_dims else Replicate()
            for n in self.names)
        self._partial_tp = tuple(Partial() if n == "tp" else Replicate()
                                 for n in self.names)

    def placements(self, logical_axes) -> Tuple[Any, ...]:
        return self.rules.to_physical(logical_axes, self.mesh)

    def local(self, x):
        """A DTensor's local block; a plain tensor as it is."""
        from torch.distributed.tensor import DTensor

        return x.to_local() if isinstance(x, DTensor) else x

    def gather(self, local: torch.Tensor, placements) -> torch.Tensor:
        """A parameter's local block under `placements` -> its block under
        the same placements with every data dim gathered (the tp split
        stays), as a local tensor whose gradient is reduced over the data
        dims by the backward."""
        from torch.distributed.tensor import DTensor, Partial, Replicate

        use = tuple(Replicate() if n in self.data_dims else p
                    for n, p in zip(self.names, placements))
        grad = tuple(Partial() if n in self.data_dims else p
                     for n, p in zip(self.names, use))
        if use == tuple(placements) and grad == use:
            return local
        w = DTensor.from_local(local, self.mesh, placements, run_check=False)
        return w.redistribute(self.mesh, use).to_local(grad_placements=grad)

    def whole(self, local: torch.Tensor, placements) -> torch.Tensor:
        """A block under `placements` -> the whole tensor, on every rank,
        whose gradient (the same on every rank, as that of code every rank
        runs alike) goes back as this rank's block of it."""
        from torch.distributed.tensor import DTensor

        if all(p == self._replicate[0] for p in placements):
            return local
        return DTensor.from_local(local, self.mesh, placements,
                                  run_check=False).redistribute(
            self.mesh, self._replicate).to_local()

    def tp_sum(self, partial: torch.Tensor) -> torch.Tensor:
        """The sum over the tp ranks of their partial results, on each."""
        from torch.distributed.tensor import DTensor

        if self.tp == 1:
            return partial
        x = DTensor.from_local(partial, self.mesh, self._partial_tp,
                               run_check=False)
        return x.redistribute(self.mesh, self._replicate).to_local()

    def tp_sum_f32(self, partial: torch.Tensor) -> torch.Tensor:
        """`tp_sum` of partial products kept in fp32: `llama._row_out`,
        given this method, computes the product with an fp32 result, sums it
        here and rounds the sum once. The engines sum this way: their
        prefill and decode are latency-bound, so the doubled bytes cost
        little, and a sum of bf16 partials rounds each partial and each
        hop."""
        return self.tp_sum(partial.float())

    def tp_copy(self, x: torch.Tensor) -> torch.Tensor:
        """x as it is, its gradient summed over the tp ranks."""
        from torch.distributed.tensor import DTensor

        if self.tp == 1:
            return x
        return DTensor.from_local(x, self.mesh, self._replicate,
                                  run_check=False).to_local(
            grad_placements=self._partial_tp)

    def data_sum(self, partial: torch.Tensor) -> torch.Tensor:
        """The sum over the data dims of each rank's partial, on each; its
        backward hands every rank the same gradient."""
        from torch.distributed.tensor import DTensor

        if not self.data_dims:
            return partial
        x = DTensor.from_local(partial, self.mesh, self._partial_data,
                               run_check=False)
        return x.redistribute(self.mesh, self._replicate).to_local()

    def block_start(self, logical: str, local_n: int) -> int:
        """Where this rank's block of local_n elements of a dim named
        `logical` starts in the global dim, as `local_slices` cuts it."""
        phys = self.rules.spec((logical,), self.mesh)[0]
        axes = () if phys is None else (
            (phys,) if isinstance(phys, str) else phys)
        start, size = 0, local_n
        for a in reversed(axes):
            start += self.coord[a] * size
            size *= self.sizes[a]
        return start

    def on_tp(self, placements, dim: int) -> bool:
        """Whether tensor dim `dim` is split over a tp dim of size > 1."""
        from torch.distributed.tensor import Shard

        return self.tp > 1 and placements[self.names.index("tp")] == Shard(dim)

    def tp_pair(self, placements, dim: int = 1):
        """(tp_copy, tp_sum) for a product whose weight splits dim `dim`
        over tp (its column-parallel entry and row-parallel exit), (None,
        None) where it does not."""
        if self.on_tp(placements, dim):
            return self.tp_copy, self.tp_sum
        return None, None
