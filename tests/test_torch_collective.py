"""The port's collective groups (`ray_tpu_torch.util.collective`) against
the JAX package's `ray_tpu.util.collective`, on the CPU.

One 4-rank gloo gang (spawned once for the file) runs
`gang_cases.collective_cases`: three "mesh" groups, bootstrapped on dp=4,
on dp=2 x tp=2 over tp alone and on dp=2 x tp=2 over both dims, each
collective (the four reductions, allgather, broadcast, reducescatter of a
chunk list and of a pytree chunk list, a bf16 sum) eagerly and inside an
aot_eager fullgraph function on each rank's integer-valued fp32 tensors;
the typed errors; and the host path on numpy values over a "host" group
and over a mesh group's numpy path (the four reductions of a pytree,
allgather, broadcast, reducescatter, a send/recv ring on one tag, two tags
received in the other order). The same per-rank inputs go through JAX's
mesh groups inside `shard_map` on the same mesh shape of 4 of the 8
virtual CPU devices (results equal, every one exact), and the host values
through JAX's host path on a runtime actor gang of 4 (results equal). A
world-1 group needs no gang, in both packages.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import ray_tpu as rt
from jax.sharding import PartitionSpec as P
from ray_tpu._private.jax_compat import shard_map
from ray_tpu.parallel.mesh import MeshConfig as JMeshConfig
from ray_tpu.util import collective as jcol
from ray_tpu.util.collective import CollectiveActorMixin
from ray_tpu_torch.parallel import gang_cases
from ray_tpu_torch.parallel.mesh import MeshConfig
from ray_tpu_torch.train import backend
from ray_tpu_torch.util import collective as col

WORLD = 4
GANG_TIMEOUT_S = 240
SRC = 1
OPS = ("sum", "product", "min", "max")
# name: (mesh config kwargs, mesh_axes)
GROUPS = {"dp4": (dict(dp=4), None),
          "tp_of_2x2": (dict(dp=2, tp=2), ("tp",)),
          "2x2": (dict(dp=2, tp=2), None)}


def _positions(mesh_kw, axes):
    """The number of positions along a group's axes (its live axes when
    none are given)."""
    sizes = JMeshConfig(**mesh_kw).resolved(WORLD).axis_sizes()
    axes = axes or tuple(a for a, n in sizes.items() if n > 1)
    return int(np.prod([sizes[a] for a in axes]))


def _inputs(seed, n):
    rng = np.random.default_rng(seed)
    xs = [rng.integers(-3, 4, (3, 8)).astype(np.float32)
          for _ in range(WORLD)]
    chunks = [[rng.integers(-3, 4, (2, 8)).astype(np.float32)
               for _ in range(n)] for _ in range(WORLD)]
    return xs, chunks


def _groups():
    out = {}
    for i, (name, (mesh_kw, axes)) in enumerate(GROUPS.items()):
        xs, chunks = _inputs(10 + i, _positions(mesh_kw, axes))
        out[name] = (mesh_kw, axes, xs, chunks, SRC)
    return out


def _host_values():
    rng = np.random.default_rng(7)
    return [{"tree": {"a": rng.normal(size=5),
                      "b": [rng.normal(size=(2, 3)), rng.integers(1, 5, 4)]},
             "gather": {"r": np.array([r])}, "payload": np.arange(4.0),
             "chunks": [rng.normal(size=3) for _ in range(WORLD)]}
            for r in range(WORLD)]


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    store = tmp_path_factory.mktemp("gang") / "store"
    return [r[0] for r in backend.launch_gang(
        gang_cases.run_cases, WORLD, "cpu", GANG_TIMEOUT_S,
        args=([("collective_cases", (_groups(), _host_values(), "dp4"))],),
        init_method=f"file://{store}")]


def _jax_collectives(name, mesh_kw, axes, xs, chunks):
    """JAX's mesh group `name` inside shard_map on the same mesh shape of
    4 CPU devices, rank r's block on the device at rank r's position:
    -> per rank, the results `gang_cases.mesh_collectives` names."""
    jcol.init_collective_group(1, 0, backend="mesh", group_name=name,
                               mesh_axes=axes)
    try:
        mesh = jcol.bootstrap_mesh(JMeshConfig(**mesh_kw), group_name=name,
                                   devices=jax.devices()[:WORLD])
        live = P(tuple(a for a in mesh.axis_names if mesh.shape[a] > 1))

        def body(v, ch):
            v, ch = v[0], [c[0] for c in ch]
            out = {op: jcol.allreduce(v, name, op) for op in OPS}
            out["allgather"] = jcol.allgather(v, name)
            out["broadcast"] = jcol.broadcast(v, SRC, name)
            out["reducescatter"] = jcol.reducescatter(ch, name)
            tree = jcol.reducescatter([{"g": c, "h": [c * 2]} for c in ch],
                                      name)
            out["reducescatter_tree_g"] = tree["g"]
            out["reducescatter_tree_h"] = tree["h"][0]
            out["bf16_sum"] = jcol.allreduce(
                v.astype(jnp.bfloat16), name).astype(jnp.float32)
            return {k: x[None] for k, x in out.items()}

        n = len(chunks[0])
        f = jax.jit(shard_map(body, mesh=mesh, in_specs=(live, [live] * n),
                              out_specs=live, check_vma=False))
        got = f(np.stack(xs), [np.stack([c[i] for c in chunks])
                               for i in range(n)])
        got = {k: np.asarray(v) for k, v in got.items()}
        return [{k: v[r] for k, v in got.items()} for r in range(WORLD)]
    finally:
        jcol.destroy_collective_group(name)


@pytest.fixture(scope="module")
def jax_mesh():
    return {name: _jax_collectives(name, *g[:4])
            for name, g in _groups().items()}


@pytest.mark.parametrize("form", ["eager", "compiled"])
@pytest.mark.parametrize("name", list(GROUPS))
def test_mesh_collectives_match_jax_shard_map(gang, jax_mesh, name, form):
    for rank in range(WORLD):
        got, want = gang[rank]["mesh"][name][form], jax_mesh[name][rank]
        assert got.keys() == want.keys()
        for k, w in want.items():
            np.testing.assert_array_equal(got[k], w, err_msg=f"{rank} {k}")


def test_mesh_collectives_are_numpy_exactly(gang):
    """dp4's results against numpy on the integer-valued inputs."""
    _, _, xs, chunks, _ = _groups()["dp4"]
    x = np.stack(xs)
    for rank in range(WORLD):
        ch = np.stack([c[rank] for c in chunks])
        for form in ("eager", "compiled"):
            got = gang[rank]["mesh"]["dp4"][form]
            for k, w in {"sum": x.sum(0), "product": x.prod(0),
                         "min": x.min(0), "max": x.max(0), "allgather": x,
                         "broadcast": x[SRC], "reducescatter": ch.sum(0),
                         "bf16_sum": x.sum(0)}.items():
                np.testing.assert_array_equal(got[k], w, err_msg=k)


def test_mesh_collective_misuse_is_typed(gang):
    """JAX's key words, eagerly and where a compiled program runs: a chunk
    list one short, a broadcast source past the positions; point-to-point
    in a compiled region names the operator that holds it; no axes while
    compiling; a DTensor that spans the gang."""
    errors = gang[0]["errors"]
    keys = {"chunks_eager": "one chunk per",
            "chunks_compiled": "one chunk per",
            "src_eager": "out of range", "src_compiled": "out of range",
            "send_compiled": "ray_tpu_torch::ring_fwd",
            "recv_compiled": "ray_tpu_torch::ring_fwd",
            "noaxes_compiled": "mesh_axes=(...)",
            "dtensor_eager": "to_local()"}
    for case, word in keys.items():
        assert errors[case].startswith("MeshCollectiveError: "), errors[case]
        assert word in errors[case], errors[case]
    assert "bootstrap_mesh" in errors["noaxes_compiled"]


def test_jax_raises_the_same_key_words_in_jit():
    jcol.init_collective_group(1, 0, backend="mesh", group_name="j_err")
    try:
        mesh = jcol.bootstrap_mesh(JMeshConfig(dp=4), group_name="j_err",
                                   devices=jax.devices()[:WORLD])
        for fn, word in (
                (lambda v: jcol.reducescatter([v] * 3, "j_err"),
                 "one chunk per"),
                (lambda v: jcol.broadcast(v, 4, "j_err"), "out of range")):
            with pytest.raises(jcol.MeshCollectiveError, match=word):
                jax.jit(shard_map(fn, mesh=mesh, in_specs=P("dp"),
                                  out_specs=P("dp"), check_vma=False))(
                                      jnp.ones(4))
    finally:
        jcol.destroy_collective_group("j_err")


def test_a_group_spans_its_gang_and_leaves_with_destroy(gang):
    assert gang[0]["mismatch"].startswith("CollectiveGroupError: ")
    assert "rank 0 of a gang of 4" in gang[0]["mismatch"]
    for rank in range(WORLD):
        assert gang[rank]["info"] == {"world_size": WORLD, "rank": rank,
                                      "name": "host"}
        assert gang[rank]["left"] == [False] * len(GROUPS)


@rt.remote
class _Rank(CollectiveActorMixin):
    """A rank of JAX's host path on a runtime actor gang."""

    def run(self, values, rank, world):
        out = {op: jcol.allreduce(values["tree"], op=op) for op in OPS}
        out["allgather"] = jcol.allgather(values["gather"])
        out["broadcast"] = jcol.broadcast(
            values["payload"] if rank == 2 else None, 2)
        out["reducescatter"] = jcol.reducescatter(values["chunks"])
        jcol.send(np.array([rank]), (rank + 1) % world, tag=7)
        out["ring"] = int(jcol.recv((rank - 1) % world, tag=7)[0])
        peer, prev = (rank + 1) % world, (rank - 1) % world
        jcol.send({"tag": 8, "from": rank}, peer, tag=8)
        jcol.send({"tag": 9, "from": rank}, peer, tag=9)
        out["tags"] = [jcol.recv(prev, tag=9), jcol.recv(prev, tag=8)]
        jcol.barrier()
        return out


def _same(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(map(_same, a, b)))
    return (np.asarray(a).dtype == np.asarray(b).dtype
            and np.array_equal(a, b))


def test_host_path_matches_jax_on_an_actor_gang(gang, ray_start_regular):
    values = _host_values()
    actors = [_Rank.remote() for _ in range(WORLD)]
    jcol.create_collective_group(actors, WORLD, list(range(WORLD)))
    try:
        want = rt.get([a.run.remote(values[r], r, WORLD)
                       for r, a in enumerate(actors)])
    finally:
        jcol.destroy_collective_group()
    for rank in range(WORLD):
        for path in ("host", "host_on_mesh"):
            got = gang[rank][path]
            assert got.keys() == want[rank].keys()
            for k in want[rank]:
                assert _same(got[k], want[rank][k]), (rank, path, k)


def test_world1_group_needs_no_gang():
    """As the JAX package's world-1 group (tests/test_spmd_trainer.py's
    host-values and degenerate-mesh cases): no gang, the host path on
    numpy, and mesh collectives on tensors the identity, eagerly and
    compiled; a mesh or a larger group asks for the gang."""
    assert not torch.distributed.is_initialized()
    for pkg in (col, jcol):
        pkg.init_collective_group(1, 0, backend="mesh", group_name="w1",
                                  mesh_axes=("dp",))
    try:
        tree = {"r": np.array([1]), "v": np.array([3.0, 4.0])}
        for fn in (lambda c: c.allreduce(tree, "w1"),
                   lambda c: c.allgather(tree, "w1"),
                   lambda c: c.broadcast(tree, 0, "w1"),
                   lambda c: c.reducescatter([tree], "w1"),
                   lambda c: c.get_group_info("w1")):
            assert _same(fn(col), fn(jcol))
        x = torch.arange(6.0).reshape(2, 3)

        def ident(v):
            return (col.allreduce(v, "w1"), col.allgather(v, "w1"),
                    col.broadcast(v, 0, "w1"), col.reducescatter([v], "w1"))

        torch._dynamo.reset()
        for got in (ident(x), torch.compile(ident, backend="aot_eager",
                                            fullgraph=True)(x)):
            torch.testing.assert_close(got[0], x, rtol=0, atol=0)
            torch.testing.assert_close(got[1], x[None], rtol=0, atol=0)
            torch.testing.assert_close(got[2], x, rtol=0, atol=0)
            torch.testing.assert_close(got[3], x, rtol=0, atol=0)
        with pytest.raises(RuntimeError, match="no peer"):
            col.send(np.ones(1), 0, "w1")
        with pytest.raises(col.CollectiveGroupError, match="in none"):
            col.bootstrap_mesh(MeshConfig(), group_name="w1")
    finally:
        col.destroy_collective_group("w1")
        jcol.destroy_collective_group("w1")
    with pytest.raises(col.CollectiveGroupError,
                       match="launch_gang runs a function"):
        col.init_collective_group(2, 0, "host", "w2")
    assert not col.is_group_initialized("w2")


def test_world1_gang_mesh_collective_is_identity(tmp_path):
    """bootstrap_mesh over a world-1 gang: every dim of size 1, and an
    allreduce inside a fullgraph function the identity, as the JAX
    package's on a 1-device mesh."""
    backend.init_process_group(0, 1, f"file://{tmp_path}/store", "cpu")
    try:
        col.init_collective_group(1, 0, backend="mesh", group_name="m_one")
        mesh = col.bootstrap_mesh(MeshConfig(), group_name="m_one")
        assert col.get_group_mesh("m_one") is mesh
        assert all(n == 1 for n in mesh.shape)
        torch._dynamo.reset()
        f = torch.compile(lambda v: col.allreduce(v, "m_one"),
                          backend="aot_eager", fullgraph=True)
        got = f(torch.arange(4.0)).numpy()
        col.destroy_collective_group("m_one")
    finally:
        backend.destroy_process_group()
    jcol.init_collective_group(1, 0, backend="mesh", group_name="m_one")
    try:
        jmesh = jcol.bootstrap_mesh(JMeshConfig(), group_name="m_one",
                                    devices=jax.devices()[:1])
        want = jax.jit(shard_map(lambda v: jcol.allreduce(v, "m_one"),
                                 mesh=jmesh, in_specs=P(),
                                 out_specs=P()))(jnp.arange(4.0))
    finally:
        jcol.destroy_collective_group("m_one")
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("kw, err", [
    (dict(backend="nccl"), "unsupported backend"),
    (dict(backend="host", mesh_axes=("dp",)), "only applies"),
    (dict(rank=2), "out of range"),
])
def test_init_arguments_are_checked_as_jax_does(kw, err):
    args = dict(world_size=2, rank=0, backend="host", group_name="bad")
    args.update(kw)
    for pkg in (col, jcol):
        with pytest.raises(ValueError, match=err):
            pkg.init_collective_group(**args)
