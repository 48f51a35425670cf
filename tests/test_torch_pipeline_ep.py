"""The port's pipeline, expert-parallel MoE and tensor-parallel dense and
paged decode against the JAX package's, on the CPU.

One 4-rank gloo gang (spawned once for the file) runs
`ray_tpu_torch.parallel.pipeline.pipeline_sharded` over pp=2 (x dp=2),
`ray_tpu_torch.parallel.moe.moe_shard_map` over ep=2 (x dp=2) with
all_to_all_single, and the dense and paged engines over tp=2 (x dp=2) from
the JAX init's weights. Each is held against its JAX counterpart on the
same mesh shape of the 8 virtual CPU devices: the pipeline's outputs and
its gradients with respect to the stage parameters and the microbatches
(against `jax.grad` through the shard_map'd scan; fp32, 1e-5), the MoE
outputs, aux loss and gradients with respect to x, the gate and the
experts (and the one-device `moe_layer` on each ep shard's tokens, with the
aux loss's gradient), the dense engine's streams against
`ray_tpu.inference.engine.InferenceEngine`'s with `mesh=`, and the paged
engine's streams and final host state (block table, lengths, free blocks,
prefix cache) equal to `ray_tpu.inference.paged_engine.
PagedInferenceEngine`'s with `mesh=`.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from ray_tpu.inference import GenerationConfig as JGen
from ray_tpu.inference.engine import InferenceEngine as JDense
from ray_tpu.inference.engine import (
    shard_params_for_inference as jax_shard_for_inference)
from ray_tpu.inference.paged_engine import PagedInferenceEngine as JPaged
from ray_tpu.models import llama as jl
from ray_tpu.parallel import mesh as jmesh
from ray_tpu.parallel.moe import moe_shard_map as jax_moe_shard_map
from ray_tpu.parallel.pipeline import pipeline_sharded as jax_pipeline
from ray_tpu_torch.parallel import gang_cases
from ray_tpu_torch.parallel.moe import moe_layer
from ray_tpu_torch.train.backend import launch_gang

WORLD = 4
GANG_TIMEOUT_S = 240
ATOL = 1e-5   # fp32, the same arithmetic in another order
VOCAB = 128
D = 16

PIPE_MESH = dict(dp=2, pp=2)
MOE_MESH = dict(dp=2, ep=2)
TP_MESH = dict(dp=2, tp=2)
MOE_CASES = [(1, 4.0), (2, 1.25)]   # (k, capacity factor): roomy, dropping
ENGINE = dict(max_batch=2, max_len=64, block_size=8, decode_chunk=4)
DENSE = dict(max_batch=2, max_len=64, decode_chunk=4)
PROMPTS = [[1, 2, 3], [4, 5, 6, 7, 8, 9, 10, 11, 12, 13]]
NEW_TOKENS = 6


def _jmesh(mesh_kw):
    sizes = jmesh.MeshConfig(**mesh_kw).resolved(WORLD).axis_sizes()
    return Mesh(np.asarray(jax.devices()[:WORLD]).reshape(
        tuple(sizes[a] for a in jmesh.AXIS_ORDER)), jmesh.AXIS_ORDER)


def _pipe_inputs():
    rng = np.random.default_rng(0)
    return (rng.normal(size=(2, D, D)).astype(np.float32) * 0.3,
            rng.normal(size=(4, 4, D)).astype(np.float32),
            rng.normal(size=(4, 4, D)).astype(np.float32))


def _moe_inputs(seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(32, D)).astype(np.float32),
            rng.normal(size=(D, 4)).astype(np.float32),
            rng.normal(size=(4, D, D)).astype(np.float32) * 0.3)


def _jcfg():
    return dataclasses.replace(jl.LlamaConfig.tiny(vocab_size=VOCAB),
                               dtype=jnp.float32)


@pytest.fixture(scope="module")
def params_np():
    return jax.device_get(jl.init(_jcfg(), jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def gang(tmp_path_factory, params_np):
    cases = [("pipeline_case", (*_pipe_inputs(), PIPE_MESH))]
    cases += [("moe_case", (*_moe_inputs(i), MOE_MESH, k, cf))
              for i, (k, cf) in enumerate(MOE_CASES)]
    cases.append(("dense_tp_case", (params_np, dict(vocab_size=VOCAB),
                                    TP_MESH, DENSE, PROMPTS, NEW_TOKENS)))
    cases.append(("paged_tp_case", (params_np, dict(vocab_size=VOCAB),
                                    TP_MESH, ENGINE, PROMPTS, NEW_TOKENS)))
    store = tmp_path_factory.mktemp("gang") / "store"
    return launch_gang(gang_cases.run_cases, WORLD, "cpu", GANG_TIMEOUT_S,
                       args=(cases,), init_method=f"file://{store}")


def _jax_pipe(ws, xs):
    return jax_pipeline(lambda w, x: jnp.tanh(x @ w[0]),
                        _jmesh(PIPE_MESH))(ws, xs)


def test_pipeline_matches_jax(gang):
    ws, xs, _ = _pipe_inputs()
    want = _jax_pipe(ws, xs)
    for rank in range(WORLD):
        np.testing.assert_allclose(gang[rank][0]["out"], np.asarray(want),
                                   atol=ATOL, rtol=0)


@pytest.mark.parametrize("grad_of", ["params", "microbatches"])
def test_pipeline_gradients_match_jax(gang, grad_of):
    """The backward against jax.grad through the shard_map'd scan: JAX's
    transposes (ppermute's inverse permutation, and psum under
    check_vma=False for the replicated result) give the gradient of the
    sequential composition with no factor of the group size, and so must
    the port's."""
    ws, xs, ct = _pipe_inputs()
    argnum = 0 if grad_of == "params" else 1
    want = jax.jit(jax.grad(lambda w, x: jnp.sum(_jax_pipe(w, x) * ct),
                            argnums=argnum))(ws, xs)
    seq = jax.grad(lambda w, x: jnp.sum(
        jnp.tanh(jnp.tanh(x @ w[0]) @ w[1]) * ct), argnums=argnum)(ws, xs)
    np.testing.assert_allclose(np.asarray(want), np.asarray(seq), rtol=1e-5,
                               atol=ATOL)
    key = "dw" if grad_of == "params" else "dx"
    for rank in range(WORLD):
        np.testing.assert_allclose(gang[rank][0][key], np.asarray(want),
                                   atol=ATOL, rtol=0)


@pytest.mark.parametrize("i", range(len(MOE_CASES)),
                         ids=[f"k{k}-cf{cf}" for k, cf in MOE_CASES])
def test_moe_shard_map_matches_jax_and_the_one_device_layer(gang, i):
    k, cf = MOE_CASES[i]
    x, gate_w, ew = _moe_inputs(i)
    mesh = _jmesh(MOE_MESH)

    def f(x):
        return jax_moe_shard_map(x, gate_w, lambda w_e, t: t @ w_e, ew, mesh,
                                 k=k, capacity_factor=cf)

    out, aux = jax.jit(f)(x)
    dx = jax.jit(jax.grad(lambda x: jnp.sum(f(x)[0])))(x)
    got = gang[0][1 + i]
    np.testing.assert_allclose(got["out"], np.asarray(out), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got["aux"], float(aux), rtol=1e-6)
    np.testing.assert_allclose(got["dx"], np.asarray(dx), atol=ATOL, rtol=0)
    # the gate's gradient is summed over the ep ranks, the experts' come
    # home from every rank's tokens
    dgate, dexperts = jax.jit(jax.grad(lambda g, e: jnp.sum(jax_moe_shard_map(
        x, g, lambda w_e, t: t @ w_e, e, mesh, k=k, capacity_factor=cf)[0]),
        argnums=(0, 1)))(gate_w, ew)
    np.testing.assert_allclose(got["dgate"], np.asarray(dgate), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(got["dexperts"], np.asarray(dexperts),
                               atol=ATOL, rtol=0)
    # each ep shard routes its own tokens: the one-device layer on them,
    # its gradients summed over the shards (aux's averaged)
    half = x.shape[0] // 2
    g = torch.from_numpy(gate_w).requires_grad_(True)
    e = torch.from_numpy(ew).requires_grad_(True)
    want_dgate, want_dexperts, want_daux = 0, 0, 0
    for s in range(2):
        want, aux_s = moe_layer(torch.from_numpy(x[s * half:(s + 1) * half]),
                                g, lambda w, t: torch.bmm(t, w), e, k=k,
                                capacity_factor=cf)
        np.testing.assert_allclose(got["out"][s * half:(s + 1) * half],
                                   want.detach().numpy(), atol=ATOL, rtol=0)
        dg, de = torch.autograd.grad(want.sum(), (g, e), retain_graph=True)
        (da,) = torch.autograd.grad(aux_s, g)
        want_dgate = want_dgate + dg.numpy()
        want_dexperts = want_dexperts + de.numpy()
        want_daux = want_daux + da.numpy() / 2
    np.testing.assert_allclose(got["dgate"], want_dgate, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got["dexperts"], want_dexperts, atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(got["daux_dgate"], want_daux, atol=ATOL,
                               rtol=0)


def test_tp_paged_decode_matches_the_jax_engine(gang, params_np):
    jcfg = _jcfg()
    mesh = _jmesh(TP_MESH)
    eng = JPaged(jax_shard_for_inference(params_np, jcfg, mesh), jcfg,
                 mesh=mesh, **ENGINE)
    streams = eng.generate(PROMPTS, JGen(max_new_tokens=NEW_TOKENS))
    for rank in range(WORLD):
        got = gang[rank][-1]
        assert got["streams"] == streams
        np.testing.assert_array_equal(got["block_table"], eng.block_table)
        np.testing.assert_array_equal(got["lengths"], eng.lengths)
        assert got["free_blocks"] == sorted(eng.free_blocks)
        assert got["cached"] == list(eng.cached_lru)
        assert got["prefix_stats"] == dict(eng.prefix_stats)
    # the pool's KV-head dim is split over tp: one rank holds half the heads
    got = gang[0][-1]
    assert got["pool_local_shape"][3] == jcfg.n_kv_heads // 2
    assert got["pool_placements"][-1] == "Shard(dim=3)"


def test_tp_dense_decode_matches_the_jax_engine(gang, params_np):
    jcfg = _jcfg()
    mesh = _jmesh(TP_MESH)
    eng = JDense(jax_shard_for_inference(params_np, jcfg, mesh), jcfg,
                 mesh=mesh, **DENSE)
    streams = eng.generate(PROMPTS, JGen(max_new_tokens=NEW_TOKENS))
    for rank in range(WORLD):
        assert gang[rank][-2]["streams"] == streams
    # the cache's KV-head dim is split over tp: one rank holds half the heads
    got = gang[0][-2]
    assert got["cache_local_shape"][3] == jcfg.n_kv_heads // 2
    assert got["cache_placements"][-1] == "Shard(dim=3)"
