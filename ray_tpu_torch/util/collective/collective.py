"""Collective groups on the ranks of a torch.distributed gang.

Counterpart of `ray_tpu/util/collective/collective.py`, the rank side of
`ray.util.collective`: the same public names, backends ("host", "gloo",
"mesh", "xla") and defaults. Where the JAX package rendezvouses through a
detached coordinator actor, a group here joins the torch.distributed gang
its process is in (`train.backend.launch_gang`, `init_process_group` or
`parallel.mesh.initialize_distributed`): the gang's store is the
rendezvous. A group of world 1 needs no gang. A group of world > 1 has the
gang's world and this process's rank in it, and cuts process groups of its
own out of the gang (`dist.new_group`): one over gloo for host values and,
for a mesh group, one over the gang's backend (NCCL on the card). So named
groups coexist, and `destroy_collective_group` releases a group's.

- The host path (backends "host" and "gloo", and numpy values on a mesh
  group): pytrees of numpy in, numpy out. Each rank's contribution travels
  pickled over gloo and every rank reduces the contributions in rank order
  with the JAX package's reducers, so a result is the coordinator's to the
  bit. send/recv match by tag; send returns once the message is posted, as
  a post to the coordinator's mailbox does.
- The mesh path (backends "mesh" and "xla"), on torch tensors. Inside a
  compiled region (`torch.compiler.is_compiling()`) a collective lowers to
  functional collectives (`_c10d_functional`, which stay in the graph under
  fullgraph) over the group's mesh axes: `mesh_axes=`, else the non-trivial
  axes of the mesh `bootstrap_mesh` built. It is the counterpart of psum /
  all_gather / psum_scatter inside shard_map; broadcast's src_rank is the
  linear position along those axes. On a concrete tensor the same
  collective runs eagerly on the tensor's device over the same ranks (NCCL
  on the card) and returns a tensor there. A group with mesh axes but no
  mesh spans its whole gang; over axes of total size 1 every collective is
  the identity. send/recv ride the host path.
- Misuse raises `MeshCollectiveError` with the JAX package's key words. A
  raise while dynamo traces would end the trace with dynamo's own error, so
  inside a compiled region the collective puts an operator in the program
  that raises the error when the program runs, before any collective of
  the call.

The declaring side: `create_collective_group(actors, ...)` declares a group
over the runtime's actors (each mixes in `CollectiveActorMixin`). It makes
them one torch.distributed gang, each bound to its card (NCCL), or gloo
when the caller asks for the CPU, meeting at the host of the actor of rank
0 and a port that actor serves the rendezvous on (`gang.gang_address`),
and then has each actor join the group. It
reaches the runtime only through the handles it is given and the
ObjectRefs their calls return (`_private.gang.resolve`).
"""

from __future__ import annotations

import contextlib
import math
import pickle
import socket
import threading
from typing import Any, Dict, List

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed import _functional_collectives as funcol
from torch.distributed.tensor import DTensor
from torch.fx.node import has_side_effect

from ray_tpu_torch._private import gang
from ray_tpu_torch._private.gang import CollectiveGroupError  # noqa: F401
from ray_tpu_torch._private.gang import check_gang as _check_gang


class ReduceOp:
    SUM = "sum"
    PRODUCT = "product"
    MIN = "min"
    MAX = "max"


class MeshCollectiveError(RuntimeError):
    """A mesh-backend collective was used where it has no meaning (no mesh
    axes to run over, a chunk list of the wrong length, a broadcast source
    outside the axes, point-to-point inside a compiled region, a DTensor
    spanning ranks). The message says what is missing and what to do
    instead."""


_REDUCERS = {
    ReduceOp.SUM: lambda xs: _tree_reduce(xs, np.add),
    ReduceOp.PRODUCT: lambda xs: _tree_reduce(xs, np.multiply),
    ReduceOp.MIN: lambda xs: _tree_reduce(xs, np.minimum),
    ReduceOp.MAX: lambda xs: _tree_reduce(xs, np.maximum),
}

_DIST_OPS = {ReduceOp.SUM: dist.ReduceOp.SUM, ReduceOp.MIN: dist.ReduceOp.MIN,
             ReduceOp.MAX: dist.ReduceOp.MAX}


def _tree_reduce(xs: List[Any], op):
    out = xs[0]
    for x in xs[1:]:
        out = _tree_map2(op, out, x)
    return out


def _tree_map2(op, a, b):
    if isinstance(a, dict):
        return {k: _tree_map2(op, a[k], b[k]) for k in a}
    if isinstance(a, (list, tuple)):
        return type(a)(_tree_map2(op, x, y) for x, y in zip(a, b))
    return op(np.asarray(a), np.asarray(b))


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in _leaves(v)]
    return [tree]


class _GroupHandle:
    def __init__(self, name: str, world_size: int, rank: int,
                 backend: str = "host", mesh_axes=None):
        self.name = name
        self.world_size = world_size
        self.rank = rank
        self.backend = backend
        self.mesh_axes = tuple(mesh_axes) if mesh_axes else None
        self.mesh = None          # set by bootstrap_mesh
        self.mesh_sizes = None    # {dim name: size} of that mesh
        self.host_pg = None       # gloo, world > 1
        self.device_pg = None     # the gang's backend, mesh groups, world > 1
        # The ranks the mesh collectives run over: a process group (None
        # over a size-1 span), its name, its size and this rank's position
        # in it. Without a mesh: the whole group.
        self.span_pg = self.span_name = None
        self.span_size, self.span_pos = world_size, rank
        self._sends: list = []    # posted sends and the buffers they read
        self._lock = threading.Lock()

    @property
    def is_mesh(self) -> bool:
        return self.backend in ("mesh", "xla")

    def axes_for_lowering(self):
        if self.mesh_axes:
            return self.mesh_axes
        if self.mesh_sizes is not None:
            live = tuple(a for a, n in self.mesh_sizes.items() if n > 1)
            # All-size-1 mesh (1 device): collectives over size-1 axes are
            # the identity, so the one-card code path runs unchanged.
            return live or tuple(self.mesh_sizes)
        raise MeshCollectiveError(self.no_axes())

    def no_axes(self) -> str:
        return (f"mesh collective group {self.name!r} has no mesh axes: pass "
                "mesh_axes=(...) to init_collective_group, or bootstrap_mesh()"
                " first so the group can default to the mesh's non-trivial "
                "axes")


_groups: Dict[str, _GroupHandle] = {}
_groups_lock = threading.Lock()
_declared: set = set()  # groups this process declared over actors

def init_collective_group(
    world_size: int,
    rank: int,
    backend: str = "host",
    group_name: str = "default",
    mesh_axes=None,
) -> None:
    """Join this process into a named collective group (collective.py:120).

    A group of world 1 needs no gang and no cluster. A group of world > 1
    joins the torch.distributed gang this process is in, whose world and
    this process's rank in it must be `world_size` and `rank`
    (`CollectiveGroupError` otherwise). backend="mesh": collectives on
    torch tensors run over `mesh_axes` (see the module docstring); host
    values ride the host path. Every rank of the gang calls this, in the
    same order of groups, as the process groups it cuts are collective."""
    if backend not in ("host", "gloo", "mesh", "xla"):
        raise ValueError(f"unsupported backend {backend!r}")
    if mesh_axes is not None and backend not in ("mesh", "xla"):
        raise ValueError("mesh_axes only applies to backend='mesh'")
    if not (0 <= rank < world_size):
        raise ValueError(f"rank {rank} out of range for world size {world_size}")
    with _groups_lock:
        if group_name in _groups:
            raise RuntimeError(f"group {group_name!r} already initialized")
    g = _GroupHandle(group_name, world_size, rank, backend, mesh_axes)
    if world_size > 1:
        _check_gang(world_size, rank)
        g.host_pg = dist.new_group(backend="gloo")
        if g.is_mesh:
            g.device_pg = dist.new_group(backend=dist.get_backend())
            g.span_pg, g.span_name = g.device_pg, g.device_pg.group_name
    with _groups_lock:
        _groups[group_name] = g


def create_collective_group(actors, world_size: int, ranks: List[int],
                            backend: str = "host",
                            group_name: str = "default", *, device=None,
                            init_timeout_s: int = 300) -> None:
    """Declaration over actors (collective.py:52): make the runtime's
    `actors` (each a `CollectiveActorMixin`) one torch.distributed gang,
    then have each join the group as its rank in `ranks`.

    The actor of rank 0 (the one whose entry in `ranks` is 0) gives its
    host's name and a port it holds and serves the rendezvous's store on
    from then on (`gang.gang_address`); every actor then joins the gang
    there at once (an actor in a gang of this world and rank keeps it, one
    in a gang of another raises `CollectiveGroupError`) and calls
    `init_collective_group`. `device` has no counterpart in the JAX
    package, whose processes have one kind of device: None is the card
    (NCCL, each actor bound to the card at its position among the group's
    actors on its node, by rank, before its first CUDA call; two actors on
    one card, or fewer visible cards than actors on a node, raise), "cpu"
    gloo. Nothing falls back from the card to gloo. A call that fails on
    one actor fails the declaration at once, naming the actor's rank; the
    gang's rendezvous gives up after `init_timeout_s`, and so does this."""
    actors = list(actors)
    if not (len(actors) == len(ranks) == world_size
            and sorted(ranks) == list(range(world_size))):
        raise ValueError(f"{len(actors)} actors and ranks {list(ranks)} do "
                         f"not make a group of world size {world_size}")
    with _groups_lock:
        if group_name in _declared:
            raise RuntimeError(f"group {group_name!r} already declared; "
                               "destroy_collective_group() first")
        _declared.add(group_name)
    init_method = None
    try:
        by_rank = [actors[ranks.index(r)] for r in range(world_size)]
        addresses = gang.resolve(
            [a._rt_collective_address.remote(r == 0)
             for r, a in enumerate(by_rank)],
            list(range(world_size)), "give its address", init_timeout_s)
        init_method = (f"tcp://{addresses[0]['hostname']}:"
                       f"{addresses[0]['port']}")
        gang.gather_gang(
            [a["hostname"] for a in addresses],
            lambda r, local, n: by_rank[r]._rt_collective_bind.remote(
                local, device, n),
            lambda r: by_rank[r]._rt_collective_join.remote(
                world_size, r, backend, group_name, init_method=init_method,
                device=device, init_timeout_s=init_timeout_s),
            init_timeout_s)
    except BaseException:
        with _groups_lock:
            _declared.discard(group_name)
        if init_method is not None:  # rank 0 may not have joined
            with contextlib.suppress(Exception):
                by_rank[0]._rt_collective_release.remote(init_method)
        raise


class CollectiveActorMixin:
    """Mix into an actor class to make it joinable via
    ``create_collective_group`` (groups declared over actors,
    collective.py:52): the calls the declaration makes on each actor."""

    def _rt_collective_address(self, serve: bool = False) -> dict:
        """This actor's host; with `serve` (rank 0), also the port it serves
        the gang's rendezvous on from now on (`gang.gang_address`)."""
        if serve:
            return gang.gang_address()
        return {"hostname": socket.gethostname()}

    def _rt_collective_release(self, init_method: str) -> bool:
        """Stop serving the rendezvous of a declaration that failed."""
        return gang.release_address(init_method)

    def _rt_collective_bind(self, local_rank: int, device=None,
                            node_ranks=None):
        return gang.bind_card(local_rank, device, node_ranks=node_ranks)

    def _rt_collective_join(self, world_size: int, rank: int, backend: str,
                            group_name: str, init_method=None, device=None,
                            init_timeout_s: int = 300) -> bool:
        if init_method is not None:
            gang.join_gang(init_method, world_size, rank, device,
                           init_timeout_s)
        init_collective_group(world_size, rank, backend, group_name)
        return True


def is_group_initialized(group_name: str = "default") -> bool:
    with _groups_lock:
        return group_name in _groups


def get_group_info(group_name: str = "default") -> dict:
    g = _require(group_name)
    return {"world_size": g.world_size, "rank": g.rank, "name": g.name}


def destroy_collective_group(group_name: str = "default") -> None:
    """Leave the group and release the process groups it cut from the gang
    (those of its mesh belong to the mesh). In the process that declared
    it over actors, forget the declaration: the actors leave through their
    own destroy_collective_group."""
    with _groups_lock:
        g = _groups.pop(group_name, None)
        _declared.discard(group_name)
    if g is None:
        return
    for work, _ in g._sends:
        work.wait()
    for pg in (g.host_pg, g.device_pg):
        if pg is not None:
            dist.destroy_process_group(pg)


def _require(group_name: str) -> _GroupHandle:
    # A plain read (no lock): a compiled region traces this lookup.
    g = _groups.get(group_name)
    if g is None:
        raise RuntimeError(
            f"collective group {group_name!r} is not initialized in this "
            "process; call init_collective_group() first"
        )
    return g


def _to_host(tensor):
    """A torch tensor or array-like to host numpy."""
    if isinstance(tensor, torch.Tensor):
        return tensor.detach().cpu().numpy()
    return np.asarray(tensor)


def _tree_to_host(x):
    if isinstance(x, dict):
        return {k: _tree_to_host(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_tree_to_host(v) for v in x)
    return _to_host(x)


# ---- the host path ----------------------------------------------------------


def _gathered(g: _GroupHandle, value) -> list:
    """Every rank's `value`, in rank order."""
    out = [None] * g.world_size
    dist.all_gather_object(out, value, group=g.host_pg)
    return out


def _host_allreduce(g, tensor, op):
    value = _tree_to_host(tensor)
    if g.host_pg is None:  # world-1: reduction of one contribution
        return _REDUCERS[op]([value])
    return _REDUCERS[op](_gathered(g, value))


def _host_allgather(g, tensor):
    value = _tree_to_host(tensor)
    return [value] if g.host_pg is None else _gathered(g, value)


def _host_broadcast(g, tensor, src_rank):
    if not 0 <= src_rank < g.world_size:
        raise ValueError(f"broadcast src_rank={src_rank} is out of range for "
                         f"world size {g.world_size}")
    if g.host_pg is None:
        return _tree_to_host(tensor)
    box = [_tree_to_host(tensor) if g.rank == src_rank else None]
    dist.broadcast_object_list(box, src=src_rank, group=g.host_pg)
    return box[0]


def _host_reducescatter(g, tensor_list, op):
    if len(tensor_list) != g.world_size:
        raise ValueError(
            f"reducescatter needs world_size={g.world_size} chunks, got "
            f"{len(tensor_list)}")
    chunks = [_tree_to_host(t) for t in tensor_list]
    if g.host_pg is None:
        return _REDUCERS[op]([chunks])[0]
    return _REDUCERS[op]([c[g.rank] for c in _gathered(g, chunks)])


# ---- the mesh path: misuse, compiled and eager --------------------------------


@torch.library.custom_op("ray_tpu_torch::mesh_collective_error",
                         mutates_args=())
def _error_when_run(x: torch.Tensor, msg: str) -> torch.Tensor:
    """Raises MeshCollectiveError(msg) where a compiled program runs it."""
    raise MeshCollectiveError(msg)


@_error_when_run.register_fake
def _(x, msg):
    return torch.empty_like(x)


# The compilers keep it where nothing reads its output.
has_side_effect(torch.ops.ray_tpu_torch.mesh_collective_error.default)


def _fail(msg: str, result=None):
    """Raise the misuse `msg`: here, or, inside a compiled region, where the
    program runs (see the module docstring); -> `result` there."""
    if not torch.compiler.is_compiling():
        raise MeshCollectiveError(msg)
    _error_when_run(torch.zeros(()), msg)
    return result


def _has_tensor(tree) -> bool:
    return any(isinstance(x, torch.Tensor) for x in _leaves(tree))


def _dtensor_misuse(g: _GroupHandle, tree, op_name: str):
    """The message refusing a DTensor that spans ranks (neither this rank's
    value nor pullable here: the counterpart of `_check_host_pullable`), or
    None."""
    for leaf in _leaves(tree):
        if isinstance(leaf, DTensor) and leaf.device_mesh.size() > 1:
            return (f"collective.{op_name} on mesh group {g.name!r} was "
                    f"called on a DTensor that spans "
                    f"{leaf.device_mesh.size()} ranks: a mesh collective "
                    "takes each rank's own value. Pass its local block "
                    "(to_local()), or its whole value (full_tensor()).")
    return None


def _locals(tree):
    return _tree_map(lambda x: x.to_local() if isinstance(x, DTensor) else x,
                     tree)


def _span_misuse(g: _GroupHandle, op_name: str):
    """Why `op_name` cannot run on g's mesh path here, or None."""
    if (torch.compiler.is_compiling() and g.mesh_sizes is None
            and not g.mesh_axes):
        return (f"collective.{op_name} on group {g.name!r} (backend='mesh') "
                "runs inside a compiled region over the group's mesh axes, "
                "and it has none. " + g.no_axes() + ". For host-side "
                "metadata, pass a concrete numpy value instead: it rides "
                "the host path.")
    return None


def _stack(chunks):
    """One chunk per position, stacked leaf-wise on a new leading axis."""
    if isinstance(chunks[0], dict):
        return {k: _stack([c[k] for c in chunks]) for k in chunks[0]}
    if isinstance(chunks[0], (list, tuple)):
        return type(chunks[0])(_stack([c[i] for c in chunks])
                               for i in range(len(chunks[0])))
    return torch.stack(chunks)


def _graph_gather(x, name):
    return funcol.all_gather_tensor(x.unsqueeze(0), 0, name)


def _eager_gather(x, pg, n):
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=pg)
    return torch.stack(parts)


def _mesh_allreduce(g: _GroupHandle, tensor, op):
    if op not in _REDUCERS:
        raise ValueError(f"unknown reduce op {op!r}")
    n, name, pg = g.span_size, g.span_name, g.span_pg
    if n == 1:
        return tensor
    if torch.compiler.is_compiling():
        def one(x):
            if op == ReduceOp.PRODUCT:
                # as the JAX package lowers it: gather the factors and
                # multiply, in position order
                return torch.prod(_graph_gather(x, name), 0)
            return funcol.all_reduce(x, op, name)
    else:
        def one(x):
            if op == ReduceOp.PRODUCT:
                return torch.prod(_eager_gather(x, pg, n), 0)
            out = x.clone(memory_format=torch.contiguous_format)
            dist.all_reduce(out, op=_DIST_OPS[op], group=pg)
            return out
    return _tree_map(one, tensor)


def _mesh_allgather(g: _GroupHandle, tensor):
    # Stacked along a new leading axis, ordered by mesh position: the
    # counterpart of the host path's rank-ordered list.
    n, name, pg = g.span_size, g.span_name, g.span_pg
    if n == 1:
        return _tree_map(lambda x: x.unsqueeze(0), tensor)
    if torch.compiler.is_compiling():
        return _tree_map(lambda x: _graph_gather(x, name), tensor)
    return _tree_map(lambda x: _eager_gather(x, pg, n), tensor)


def _mesh_broadcast(g: _GroupHandle, tensor, src_rank: int):
    n, pos, name, pg = g.span_size, g.span_pos, g.span_name, g.span_pg
    # An out-of-range source matches no position: a masked sum would
    # silently return zeros. Typed error instead.
    if not 0 <= src_rank < n:
        return _fail(
            f"mesh broadcast src_rank={src_rank} is out of range for the {n} "
            f"positions of group {g.name!r} along its mesh axes (src_rank "
            "addresses the linear position along the axes, not a process "
            "rank)", tensor)
    if n == 1:
        return tensor
    if torch.compiler.is_compiling():
        # A masked sum, as the JAX package lowers it: only the source
        # position contributes.
        return _tree_map(lambda x: funcol.all_reduce(
            x if pos == src_rank else torch.zeros_like(x), "sum", name),
            tensor)

    def one(x):
        out = x.clone(memory_format=torch.contiguous_format)
        dist.broadcast(out, src=dist.get_global_rank(pg, src_rank), group=pg)
        return out

    return _tree_map(one, tensor)


def _mesh_reducescatter(g: _GroupHandle, tensor_list, op):
    n, name, pg = g.span_size, g.span_name, g.span_pg
    if op != ReduceOp.SUM:
        return _fail("a mesh reducescatter lowers to reduce_scatter_tensor, "
                     f"which the port runs for ReduceOp.SUM only (got "
                     f"{op!r})", tensor_list)
    if isinstance(tensor_list, (list, tuple)):
        # One chunk per position along the axes: the counterpart of the
        # host path's world_size check.
        if len(tensor_list) != n:
            return _fail(
                f"mesh reducescatter of group {g.name!r} needs one chunk per "
                f"position along its mesh axes ({n}), got {len(tensor_list)}",
                tensor_list)
        stacked = _stack(list(tensor_list))
    else:
        stacked = tensor_list
        lead = {x.shape[0] if x.dim() else None for x in _leaves(stacked)}
        if lead != {n}:
            return _fail(
                f"mesh reducescatter of group {g.name!r} needs one chunk per "
                f"position along its mesh axes ({n}) on the leading dim, got "
                f"{sorted(lead, key=str)}", tensor_list)
    if n == 1:
        return _tree_map(lambda x: x[0], stacked)
    if torch.compiler.is_compiling():
        return _tree_map(lambda x: funcol.reduce_scatter_tensor(
            x, "sum", 0, name)[0], stacked)

    def one(x):
        out = torch.empty((1,) + x.shape[1:], dtype=x.dtype, device=x.device)
        dist.reduce_scatter_tensor(out, x.contiguous(), group=pg)
        return out[0]

    return _tree_map(one, stacked)


def _on_mesh(g: _GroupHandle, tree) -> bool:
    """Whether a call takes the mesh path: a mesh group and a torch tensor
    among the leaves."""
    return g.is_mesh and _has_tensor(tree)


def _mesh_call(g: _GroupHandle, tree, op_name: str, run):
    msg = _dtensor_misuse(g, tree, op_name) or _span_misuse(g, op_name)
    if msg:
        return _fail(msg, tree)
    return run(_locals(tree))


# ---- collective ops ------------------------------------------------------------


def allreduce(tensor, group_name: str = "default", op=ReduceOp.SUM):
    """Allreduce (collective.py:258). Pytrees supported.

    Host groups, and numpy values on mesh groups: numpy, reduced in rank
    order. Mesh groups on torch tensors: the sum (min, max, product) over
    the group's mesh axes, in the graph of a compiled region or eagerly on
    the tensor's device."""
    g = _require(group_name)
    if _on_mesh(g, tensor):
        return _mesh_call(g, tensor, "allreduce",
                          lambda t: _mesh_allreduce(g, t, op))
    return _host_allreduce(g, tensor, op)


def allgather(tensor, group_name: str = "default") -> List[Any]:
    """Gather every rank's tensor, ordered by rank (collective.py:423).

    Mesh groups on torch tensors: stacked along a new leading axis,
    ordered by position along the mesh axes."""
    g = _require(group_name)
    if _on_mesh(g, tensor):
        return _mesh_call(g, tensor, "allgather",
                          lambda t: _mesh_allgather(g, t))
    return _host_allgather(g, tensor)


def broadcast(tensor, src_rank: int = 0, group_name: str = "default"):
    """Broadcast from src_rank to all (collective.py:373).

    Mesh groups on torch tensors: src_rank addresses the linear position
    along the group's mesh axes (each rank holds its own block, as each
    device does inside shard_map); on host values it is the process rank,
    as for host groups."""
    g = _require(group_name)
    if _on_mesh(g, tensor):
        return _mesh_call(g, tensor, "broadcast",
                          lambda t: _mesh_broadcast(g, t, src_rank))
    return _host_broadcast(g, tensor, src_rank)


def reducescatter(tensor_list: List[Any], group_name: str = "default",
                  op=ReduceOp.SUM):
    """Reduce chunk r over all ranks -> rank r (collective.py:472).

    Mesh groups on torch tensors: one chunk per position along the mesh
    axes (or one tensor whose leading dim has a row per position), summed
    by reduce_scatter_tensor."""
    g = _require(group_name)
    if _on_mesh(g, tensor_list):
        return _mesh_call(g, tensor_list, "reducescatter",
                          lambda t: _mesh_reducescatter(g, t, op))
    return _host_reducescatter(g, tensor_list, op)


def barrier(group_name: str = "default") -> None:
    g = _require(group_name)
    if g.host_pg is not None:
        dist.barrier(group=g.host_pg)


def _p2p_misuse(g: _GroupHandle, op_name: str):
    if g.is_mesh and torch.compiler.is_compiling():
        return _fail(
            f"{op_name}() has no lowering inside a compiled region: a "
            "point-to-point transfer there belongs in a custom operator that "
            "posts both its sends and its receives (as "
            "ray_tpu_torch::ring_fwd does with batch_isend_irecv), or call "
            f"{op_name}() outside the compiled region")
    return None


def send(tensor, dst_rank: int, group_name: str = "default",
         tag: int = 0) -> None:
    """P2P send (collective.py:531): posts the value (as numpy) for rank
    dst_rank's recv of the same tag and returns."""
    g = _require(group_name)
    if g.is_mesh and torch.compiler.is_compiling():
        return _p2p_misuse(g, "send")
    if g.host_pg is None:
        raise RuntimeError("send() on a world-1 group has no peer")
    payload = torch.frombuffer(bytearray(pickle.dumps(_tree_to_host(tensor))),
                               dtype=torch.uint8)
    size = torch.tensor([payload.numel()], dtype=torch.int64)
    with g._lock:
        g._sends = [s for s in g._sends if not s[0].is_completed()]
        for t in (size, payload):
            g._sends.append((dist.isend(t, dst_rank, group=g.host_pg,
                                        tag=tag), t))


def recv(src_rank: int, group_name: str = "default", tag: int = 0):
    """P2P recv (collective.py:594): the value rank src_rank sent with this
    tag, as numpy."""
    g = _require(group_name)
    if g.is_mesh and torch.compiler.is_compiling():
        return _p2p_misuse(g, "recv")
    if g.host_pg is None:
        raise RuntimeError("recv() on a world-1 group has no peer")
    size = torch.empty(1, dtype=torch.int64)
    dist.recv(size, src_rank, group=g.host_pg, tag=tag)
    payload = torch.empty(int(size), dtype=torch.uint8)
    dist.recv(payload, src_rank, group=g.host_pg, tag=tag)
    return pickle.loads(payload.numpy().tobytes())


# ---- mesh bootstrap --------------------------------------------------------


def bootstrap_mesh(mesh_config=None, *, group_name: str = "default",
                   num_slices: int = 1):
    """Build the group's named DeviceMesh over the gang
    (`parallel.mesh.build_multislice_mesh`) and remember it, so that mesh
    collectives default their axes to its non-trivial ones.

    The JAX package bootstraps `jax.distributed` through the group's
    rendezvous first; here the gang the group joined is that bootstrap, so
    no process group is started (the mesh cuts its per-dim groups, and one
    over the lowering axes when they are several, out of the gang). A
    world-1 group builds its 1 x ... x 1 mesh over a world-1 gang.
    -> the DeviceMesh."""
    from ray_tpu_torch.parallel import mesh as mesh_mod

    g = _require(group_name)
    _check_gang(g.world_size, g.rank)
    mesh = mesh_mod.build_multislice_mesh(
        mesh_config or mesh_mod.MeshConfig(), num_slices)
    g.mesh, g.mesh_sizes = mesh, mesh_mod.mesh_sizes(mesh)
    axes = g.axes_for_lowering()
    n = math.prod(g.mesh_sizes[a] for a in axes)
    if n == 1:
        pg = None
    elif len(axes) == 1:
        pg = mesh.get_group(axes[0])
    else:
        pg = mesh[axes]._flatten().get_group()
    g.span_pg, g.span_size = pg, n
    g.span_name = None if pg is None else pg.group_name
    g.span_pos = 0 if pg is None else dist.get_rank(pg)
    return mesh


def get_group_mesh(group_name: str = "default"):
    """The mesh built by bootstrap_mesh for this group (None before)."""
    return _require(group_name).mesh
