"""The port's named mesh and logical-axis sharding against the JAX
package's, on the CPU.

`MeshConfig` arithmetic and errors, the axis order, every rule's
PartitionSpec (size-1 and absent mesh dims dropped) and the placements the
port derives from it, and `best_mesh_for` are held against
`ray_tpu.parallel` directly. One 4-rank gloo gang (spawned once for the
file, rendezvous through a file store) builds meshes over its ranks, cuts
tensors by the rules (`shard_params` and back) and places a global batch;
each rank's block is held against the block that JAX's NamedSharding gives
the device at the same mesh position of the 8 virtual CPU devices.
"""

import dataclasses
import types

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding

from ray_tpu.models import llama as jl
from ray_tpu.models import mixtral as jmx
from ray_tpu.models import t5 as jt5
from ray_tpu.models import vit as jvit
from ray_tpu.parallel import mesh as jmesh
from ray_tpu.parallel import sharding as jsharding
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.parallel import gang_cases
from ray_tpu_torch.parallel import mesh as tmesh
from ray_tpu_torch.parallel import sharding as tsharding
from ray_tpu_torch.train.backend import launch_gang

WORLD = 4
GANG_TIMEOUT_S = 240

# Meshes as {dim: size}: the rules' output depends on the sizes only.
SIZES = [
    None,
    dict(pp=1, dp=1, fsdp=1, ep=1, sp=1, tp=1),
    dict(pp=1, dp=2, fsdp=2, ep=1, sp=1, tp=2),
    dict(pp=2, dp=1, fsdp=4, ep=2, sp=2, tp=1),
    dict(dcn=2, pp=1, dp=2, fsdp=2, ep=1, sp=1, tp=1),
    dict(dcn=2, pp=1, dp=1, fsdp=1, ep=1, sp=2, tp=2),
]

# (mesh config, slices, tensor shape, logical axes) for the gang.
GANG_MESHES = [
    (dict(fsdp=2, tp=2), 1, (8, 12, 4), ("embed", "heads", "kv")),
    (dict(fsdp=2, tp=2), 1, (16, 8), ("vocab", "embed")),
    (dict(sp=2, tp=2), 1, (4, 8), ("batch", "seq")),
    (dict(dp=2, fsdp=2), 1, (8, 6), ("batch", "seq")),
    (dict(tp=2), 2, (8, 6), ("batch", "seq")),
    (dict(dp=4), 1, (6, 10), ("mlp", "embed")),
    (dict(ep=2, dp=2), 1, (4, 6, 6), ("expert", "embed", "mlp")),
]
BATCH_MESHES = [(dict(dp=2, fsdp=2), 1), (dict(sp=2, fsdp=2), 1),
                (dict(tp=2), 2), (dict(sp=4), 1)]
# (mesh config, slices, prefetch) of the sharded device feed.
FEED_MESHES = [(dict(dp=2, fsdp=2), 1, 1), (dict(sp=2, fsdp=2), 1, 0)]
# The gradient reduction of a gathered bf16 parameter, the tp sums, and a
# DTensor checkpointed whole.
REDUCE_CASE = (dict(dp=2, fsdp=2), (8, 6), ("embed", "mlp"), 41)
TP_SUM_CASE = (4, 64, 6, 43)
CHECKPOINT_CASE = (dict(fsdp=2, tp=2), (8, 12), ("embed", "mlp"))


def _feed_batches():
    rng = np.random.default_rng(7)
    return [{"inputs": rng.integers(0, 100, (8, 16)),
             "mask": rng.random((8, 16)).astype(np.float32)}
            for _ in range(3)]


def _cases():
    batch = np.arange(8 * 16).reshape(8, 16)
    cases = [("mesh_cases", ([dict(mesh=m, slices=n, shape=s, logical=ax)
                              for m, n, s, ax in GANG_MESHES],))]
    cases += [("batch_blocks", (m, n, batch)) for m, n in BATCH_MESHES]
    cases += [("feed_blocks", (m, n, _feed_batches(), p))
              for m, n, p in FEED_MESHES]
    cases += [("grad_reduce_case", REDUCE_CASE), ("tp_sum_case", TP_SUM_CASE),
              ("checkpoint_case", CHECKPOINT_CASE)]
    return cases


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    store = tmp_path_factory.mktemp("gang") / "store"
    return launch_gang(gang_cases.run_cases, WORLD, "cpu", GANG_TIMEOUT_S,
                       args=(_cases(),), init_method=f"file://{store}")


@pytest.mark.parametrize("cfg,n", [
    (dict(), 4), (dict(fsdp=2, tp=2), 4), (dict(tp=2), 8), (dict(dp=2), 2),
    (dict(sp=2, ep=2, pp=2), 8), (dict(fsdp=3), 4), (dict(dp=3), 4),
    (dict(tp=8), 4)])
def test_mesh_config_resolution_and_errors_match_jax(cfg, n):
    try:
        want = dataclasses.asdict(jmesh.MeshConfig(**cfg).resolved(n))
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tmesh.MeshConfig(**cfg).resolved(n)
        assert str(got.value) == str(e)
        return
    assert dataclasses.asdict(tmesh.MeshConfig(**cfg).resolved(n)) == want
    assert (tmesh.MeshConfig(**cfg).resolved(n).axis_sizes()
            == jmesh.MeshConfig(**cfg).resolved(n).axis_sizes())


def test_axis_order_and_best_mesh_match_jax():
    assert tmesh.AXIS_ORDER == jmesh.AXIS_ORDER
    for n in (1, 2, 4, 6, 8, 12, 16):
        assert tmesh.best_mesh_for(n) == dataclasses.replace(
            tmesh.MeshConfig(), **dataclasses.asdict(jmesh.best_mesh_for(n)))


def _jax_mesh(sizes):
    return None if sizes is None else types.SimpleNamespace(shape=sizes)


@pytest.mark.parametrize("sizes", SIZES, ids=lambda s: str(s))
def test_every_rule_gives_jax_partition_spec(sizes):
    assert tsharding.DEFAULT_RULES == jsharding.DEFAULT_RULES
    jr, tr = jsharding.LogicalAxisRules(), tsharding.LogicalAxisRules()
    names = [n for n, _ in jsharding.DEFAULT_RULES] + [None, "unknown"]
    for name in names:
        want = tuple(jr.to_physical((name,), _jax_mesh(sizes)))
        assert tr.spec((name,), sizes) == want, name
    # whole parameter trees and activation layouts, several dims at once;
    # the zoo's trees name "patch", "enc_layers" and "dec_layers", which no
    # rule maps, so those dims stay whole, as JAX keeps them
    axes = [a for tree in (jl.param_logical_axes(jl.LlamaConfig.tiny()),
                           jmx.param_logical_axes(jmx.MixtralConfig.tiny()),
                           jvit.param_logical_axes(jvit.ViTConfig.tiny()),
                           jt5.param_logical_axes(jt5.T5Config.tiny()))
            for a in jax.tree.leaves(
                tree, is_leaf=lambda x: isinstance(x, tuple))]
    for name in ("patch", "enc_layers", "dec_layers"):
        assert any(name in a for a in axes)
        assert tr.spec((name,), sizes) == (None,)
    axes += [("batch", "seq", "act_heads", "act_kv"),
             ("batch", "seq", "act_vocab"), ("batch", "seq", "act_embed")]
    for a in axes:
        assert tr.spec(a, sizes) == tuple(jr.to_physical(a, _jax_mesh(sizes)))
    replaced = dict(embed=None, vocab=None)
    assert (tr.replace(**replaced).spec(("vocab", "embed"), sizes)
            == tuple(jr.replace(**replaced).to_physical(
                ("vocab", "embed"), _jax_mesh(sizes))))


@pytest.mark.parametrize("sizes", SIZES[1:], ids=lambda s: str(s))
def test_placements_follow_the_spec(sizes):
    from torch.distributed.tensor import Replicate, Shard

    tr = tsharding.LogicalAxisRules()
    for a in [("batch", "seq", "act_heads", "act_kv"), ("vocab", "embed"),
              ("layers", "embed", "heads", "kv"), ("expert", "embed", "mlp"),
              ("stage", None), (None,)]:
        spec = tr.spec(a, sizes)
        placements = tr.to_physical(a, sizes)
        assert len(placements) == len(sizes)
        for name, p in zip(sizes, placements):
            dims = [d for d, s in enumerate(spec)
                    if s == name or (isinstance(s, tuple) and name in s)]
            assert p == (Shard(dims[0]) if dims else Replicate()), (a, name)


def test_param_shardings_follow_the_rules():
    sizes = dict(pp=1, dp=1, fsdp=2, ep=1, sp=1, tp=2)
    axes = tl.param_logical_axes(tl.LlamaConfig.tiny())
    got = tsharding.param_shardings(axes, sizes)
    rules = tsharding.LogicalAxisRules()
    assert got["embed"] == rules.to_physical(("vocab", "embed"), sizes)
    assert got["layers"]["wo"] == rules.to_physical(
        ("layers", "heads", "kv", "embed"), sizes)
    assert set(got["layers"]) == set(axes["layers"])


def test_param_logical_axes_match_jax():
    cfg = tl.LlamaConfig.tiny()
    assert tl.param_logical_axes(cfg) == jl.param_logical_axes(
        jl.LlamaConfig.tiny())


def test_rules_refuse_a_split_against_the_mesh_order():
    tr = tsharding.LogicalAxisRules().replace(batch=("fsdp", "dp"))
    with pytest.raises(ValueError, match="major to minor"):
        tr.to_physical(("batch",), dict(dp=2, fsdp=2))


def test_gang_meshes_cut_tensors_as_the_rules_say(gang):
    sizes_of = lambda cfg, n: ({"dcn": n} if n > 1 else {}) | \
        tmesh.MeshConfig(**cfg).resolved(WORLD // n).axis_sizes()  # noqa: E731
    for rank, res in enumerate(gang):
        for (cfg, n, shape, logical), got in zip(GANG_MESHES, res[0]):
            sizes = sizes_of(cfg, n)
            names = list(sizes)
            assert got["rank"] == rank
            assert got["sizes"] == sizes
            # rank r at the row-major position of range(world)
            want_coord = list(np.unravel_index(rank, tuple(sizes.values())))
            assert got["coord"] == want_coord
            assert got["local_equal"] and got["round_trip"]
            assert got["constrained"]  # with_logical_constraint gathers
            # the block JAX's NamedSharding gives the same position
            devs = np.asarray(jax.devices()[:WORLD]).reshape(
                tuple(sizes.values()))
            jm = Mesh(devs, tuple(names))
            spec = jsharding.LogicalAxisRules().to_physical(logical, jm)
            idx = NamedSharding(jm, spec).devices_indices_map(shape)[
                devs[tuple(want_coord)]]
            assert got["block"] == [
                (s.start or 0, shape[d] if s.stop is None else s.stop)
                for d, s in enumerate(idx)], (cfg, logical)


def test_gang_batch_blocks_match_jax_named_sharding(gang):
    batch = np.arange(8 * 16).reshape(8, 16)
    for rank, res in enumerate(gang):
        for (cfg, n), got in zip(BATCH_MESHES, res[1:1 + len(BATCH_MESHES)]):
            sizes = ({"dcn": n} if n > 1 else {}) | tmesh.MeshConfig(
                **cfg).resolved(WORLD // n).axis_sizes()
            devs = np.asarray(jax.devices()[:WORLD]).reshape(
                tuple(sizes.values()))
            jm = Mesh(devs, tuple(sizes))
            sharding = jsharding.logical_sharding(jm, ("batch", "seq"))
            placed = jax.device_put(batch, sharding)
            dev = devs[tuple(got["coord"])]
            want = next(s.data for s in placed.addressable_shards
                        if s.device == dev)
            np.testing.assert_array_equal(got["local"], np.asarray(want))
            np.testing.assert_array_equal(got["full"], batch)


def test_gang_sharded_feed_yields_shard_local_batch_blocks(gang):
    """iter_device_batches with the batch sharding, at prefetch 1 and 0:
    each rank's DTensor blocks equal shard_local_batch's of the same global
    batch, and the block JAX's NamedSharding gives its mesh position."""
    batches = _feed_batches()
    for i, (cfg, n, _) in enumerate(FEED_MESHES):
        sizes = ({"dcn": n} if n > 1 else {}) | tmesh.MeshConfig(
            **cfg).resolved(WORLD // n).axis_sizes()
        devs = np.asarray(jax.devices()[:WORLD]).reshape(
            tuple(sizes.values()))
        sharding = jsharding.logical_sharding(Mesh(devs, tuple(sizes)),
                                              ("batch", "seq"))
        for res in gang:
            got = res[1 + len(BATCH_MESHES) + i]
            assert got["fed"] == len(batches) and got["exhausted"]
            dev = devs[tuple(got["coord"])]
            for b, src in zip(got["batches"], batches):
                for k, v in src.items():
                    assert b[k]["shape"] == v.shape and b[k]["placements"]
                    np.testing.assert_array_equal(b[k]["local"],
                                                  b[k]["want"])
                    placed = jax.device_put(v, sharding)
                    want = next(s.data for s in placed.addressable_shards
                                if s.device == dev)
                    np.testing.assert_array_equal(b[k]["local"],
                                                  np.asarray(want))


def test_mesh_needs_a_gang():
    for build in (lambda: tmesh.build_mesh(tmesh.MeshConfig()),
                  lambda: tmesh.build_multislice_mesh(
                      tmesh.MeshConfig(), num_slices=2, device_type="cpu")):
        with pytest.raises(RuntimeError, match="gang"):
            build()


def test_with_logical_constraint_passes_plain_tensors():
    import torch

    x = torch.ones(2, 3)
    assert tsharding.with_logical_constraint(x, ("batch", "seq")) is x


def test_gang_gathers_reduce_gradients_over_the_data_dims(gang):
    """ShardingContext.gather's backward on dp=2 x fsdp=2 (an all-reduce
    over dp, a reduce-scatter over fsdp): a bf16 parameter comes out of the
    gather in bf16, and each rank's gradient block is its block of the sum
    of the four ranks' gathered gradients."""
    res = [r[len(_cases()) - 3] for r in gang]
    shape = REDUCE_CASE[1]
    total = sum(r["c"] for r in res)
    for r in res:
        block = tuple(slice(a, b) for a, b in r["block"])
        assert r["grad_dtype"] == r["gathered"] == "torch.bfloat16"
        assert r["grad"].shape == total[block].shape != shape
        np.testing.assert_array_equal(r["grad"], total[block])


def test_gang_engines_sum_fp32_partial_products_over_tp(gang):
    """The engines' tp sum (`tp_sum_f32` through `_row_out`) gives the bf16
    rounding of the whole fp32 product, where the bf16 sum of bf16 partial
    products (the training step's `tp_sum`) does not; both engines on a
    tp=4 mesh sum that way."""
    for r in (res[len(_cases()) - 2] for res in gang):
        want = torch.from_numpy(r["h"] @ r["w"]).to(torch.bfloat16).float()
        assert r["f32_dtype"] == "torch.bfloat16"
        np.testing.assert_array_equal(r["f32"], want.numpy())
        assert not np.array_equal(r["bf16"], want.numpy())
        assert r["engines_f32"] == [True, True]


def test_gang_checkpoint_saves_a_dtensor_whole(gang):
    """`Checkpoint.from_arrays` of a bf16 DTensor split over fsdp x tp
    stores the whole tensor (as JAX's device_get fetches a sharded array
    whole), and `to_arrays` gives it back bit for bit, in bf16."""
    for res in gang:
        got = res[len(_cases()) - 1]
        assert got["whole"] and got["dtype"] == "torch.bfloat16"
        assert got["step"] == 3 and got["local_shape"] == (4, 6)
