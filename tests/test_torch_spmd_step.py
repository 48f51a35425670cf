"""The port's sharded Llama step against the JAX package's, on the CPU.

One 4-rank gloo gang (spawned once for the file) runs the tiny fp32 Llama
through `ray_tpu_torch.models.llama.loss_fn(mesh=...)` on DTensor
parameters and batches: its loss and whole gradients on fsdp=2 x tp=2,
sp=2 x tp=2 with the ring, fsdp=4 with a chunked loss and the dcn=2 x
tp=2 multi-slice mesh are held against `jax.value_and_grad(
ray_tpu.models.llama.loss_fn)` on the same mesh shape of the 8 virtual CPU
devices, and three eager AdamW steps on fsdp=2 x tp=2 against
`ray_tpu.train.step`'s sharded `init_train_state` / `make_train_step`
(loss and grad norm 1e-5, parameters within lr). Each rank's flash calls
follow the remat policy and the ring. In this process, a world-1 gloo gang:
the sharded code on a 1 x ... x 1 mesh equals the unsharded step, eagerly
and compiled (aot_eager).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh

from ray_tpu.models import llama as jl
from ray_tpu.parallel import mesh as jmesh
from ray_tpu.parallel.sharding import LogicalAxisRules, logical_sharding
from ray_tpu.train.step import init_train_state as jax_init_train_state
from ray_tpu.train.step import make_train_step as jax_make_train_step
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.parallel import gang_cases
from ray_tpu_torch.train.backend import launch_gang

WORLD = 4
GANG_TIMEOUT_S = 240
VOCAB = 128
LR = 1e-3
# As tests/test_torch_train.py: fp32 on both sides, sums in another order
# (logits as tests/test_torch_llama.py holds them: rtol = atol = 2e-4).
LOSS_RTOL = 1e-5
GRAD_ATOL, GRAD_RTOL = 2e-5, 2e-4
PARAM_ATOL = LR

# (config kwargs, mesh kwargs, slices)
LOSS_CASES = [
    (dict(), dict(fsdp=2, tp=2), 1),
    (dict(use_ring_attention=True), dict(sp=2, tp=2), 1),
    (dict(loss_chunk_size=32), dict(fsdp=4), 1),
    (dict(), dict(tp=2), 2),
]
STEP_MESH = dict(fsdp=2, tp=2)


def _cfg_kw(kw):
    return dict(vocab_size=VOCAB, **kw)


def _jcfg(kw):
    return dataclasses.replace(jl.LlamaConfig.tiny(vocab_size=VOCAB),
                               dtype=jnp.float32, **kw)


def _jmesh(mesh_kw, slices):
    per = jmesh.MeshConfig(**mesh_kw).resolved(WORLD // slices).axis_sizes()
    names = (("dcn",) if slices > 1 else ()) + jmesh.AXIS_ORDER
    shape = ((slices,) if slices > 1 else ()) + tuple(
        per[a] for a in jmesh.AXIS_ORDER)
    return Mesh(np.asarray(jax.devices()[:WORLD]).reshape(shape), names)


def _batch(seed, b=4, s=64):
    toks = np.random.default_rng(seed).integers(0, VOCAB, (b, s + 1))
    return {"inputs": toks[:, :-1], "targets": toks[:, 1:]}


@pytest.fixture(scope="module")
def params_np():
    return jax.device_get(jl.init(_jcfg({}), jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def jax_steps():
    """Three steps of optax.adamw(LR) on the STEP_MESH JAX mesh from the
    sharded init: initial weights, batches, metrics, final weights."""
    jcfg = _jcfg({})
    mesh = _jmesh(STEP_MESH, 1)
    rules = LogicalAxisRules()
    opt = optax.adamw(LR)
    state, shardings = jax_init_train_state(
        functools.partial(jl.init, jcfg), opt, jl.param_logical_axes(jcfg),
        mesh, jax.random.PRNGKey(0), rules)
    bs = logical_sharding(mesh, ("batch", "seq"), rules)
    step = jax_make_train_step(
        functools.partial(jl.loss_fn, config=jcfg, mesh=mesh, rules=rules),
        opt, shardings, batch_sharding={"inputs": bs, "targets": bs})
    batches = [_batch(10 + i) for i in range(3)]
    out = {"init": jax.device_get(state.params), "batches": batches,
           "metrics": []}
    for b in batches:
        state, m = step(state, {k: jax.device_put(v, bs)
                                for k, v in b.items()})
        out["metrics"].append((float(m["loss"]), float(m["grad_norm"])))
    out["final"] = jax.device_get(state.params)
    return out


@pytest.fixture(scope="module")
def gang(tmp_path_factory, params_np, jax_steps):
    cases = [("loss_and_grads", (params_np, _batch(i), _cfg_kw(kw), mesh_kw,
                                 slices))
             for i, (kw, mesh_kw, slices) in enumerate(LOSS_CASES)]
    cases.append(("train_steps", (jax_steps["init"], jax_steps["batches"],
                                  _cfg_kw({}), STEP_MESH, LR, 1e-4)))
    store = tmp_path_factory.mktemp("gang") / "store"
    return launch_gang(gang_cases.run_cases, WORLD, "cpu", GANG_TIMEOUT_S,
                       args=(cases,), init_method=f"file://{store}")


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: np.asarray(tree, dtype=np.float32)}


@pytest.mark.parametrize("i", range(len(LOSS_CASES)),
                         ids=[f"{m}x{s}-{k}" for k, m, s in LOSS_CASES])
def test_sharded_loss_and_grads_match_jax_on_the_same_mesh(gang, params_np,
                                                           i):
    kw, mesh_kw, slices = LOSS_CASES[i]
    jcfg = _jcfg(kw)
    mesh = _jmesh(mesh_kw, slices)
    rules = LogicalAxisRules()
    loss, grads = jax.jit(jax.value_and_grad(functools.partial(
        jl.loss_fn, config=jcfg, mesh=mesh, rules=rules)))(
        params_np, {k: jnp.asarray(v) for k, v in _batch(i).items()})
    got = gang[0][i]
    np.testing.assert_allclose(got["loss"], float(loss), rtol=LOSS_RTOL)
    want = _flat(jax.device_get(grads))
    assert set(got["grads"]) == set(want)
    for name, g in want.items():
        np.testing.assert_allclose(
            got["grads"][name], g, rtol=GRAD_RTOL,
            atol=GRAD_ATOL * float(np.abs(g).max()), err_msg=name)
    np.testing.assert_allclose(got["grad_norm"],
                               float(optax.global_norm(grads)),
                               rtol=LOSS_RTOL)
    for rank in range(WORLD):  # one loss on every rank
        assert gang[rank][i]["loss"] == got["loss"]
    logits = jax.jit(functools.partial(jl.forward, config=jcfg, mesh=mesh,
                                       rules=rules))(
        params_np, jnp.asarray(_batch(i)["inputs"]))
    np.testing.assert_allclose(got["logits"], np.asarray(logits),
                               rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("i", range(len(LOSS_CASES)))
def test_flash_calls_per_rank_follow_remat_and_ring(gang, i):
    kw, mesh_kw, slices = LOSS_CASES[i]
    layers = tl.LlamaConfig.tiny().n_layers
    for rank in range(WORLD):
        calls = gang[rank][i]["calls"]
        # "dots" reruns the forward in the backward; the ring visits its
        # own block and every earlier one (on sp=2 x tp=2 rank r sits at
        # sp coordinate r // 2).
        blocks = rank // 2 + 1 if kw.get("use_ring_attention") else 1
        assert calls == {"flash_fwd": 2 * layers * blocks,
                         "flash_bwd": layers * blocks}, (rank, calls)


def test_three_sharded_adamw_steps_match_jax(gang, jax_steps):
    got = gang[0][len(LOSS_CASES)]
    for (loss, norm), (jloss, jnorm) in zip(got["metrics"],
                                            jax_steps["metrics"]):
        np.testing.assert_allclose(loss, jloss, rtol=LOSS_RTOL)
        np.testing.assert_allclose(norm, jnorm, rtol=LOSS_RTOL)
    assert got["moment_placements_match"]
    want = _flat(jax_steps["final"])
    for name, w in want.items():
        np.testing.assert_allclose(_flat(got["params"])[name], w,
                                   atol=PARAM_ATOL, rtol=0, err_msg=name)
    for rank in range(1, WORLD):
        assert gang[rank][len(LOSS_CASES)]["metrics"] == got["metrics"]


def test_world1_mesh_equals_the_unsharded_step(tmp_path):
    from ray_tpu_torch.parallel.mesh import MeshConfig, build_mesh
    from ray_tpu_torch.train import adamw, init_train_state, make_train_step
    from ray_tpu_torch.train import backend, spmd
    from ray_tpu_torch.train.optim import tree_leaves
    from ray_tpu_torch.train.spmd import batch_sharding, shard_local_batch

    cfg = dataclasses.replace(tl.LlamaConfig.tiny(vocab_size=VOCAB),
                              dtype=torch.float32, loss_chunk_size=32)
    backend.init_process_group(0, 1, f"file://{tmp_path}/store", "cpu")
    try:
        assert spmd.get_mesh() is None
        assert spmd.setup_worker_mesh(
            MeshConfig(), group_name="world1", world_size=1, rank=0,
            distributed=False) == {
            a: 1 for a in ("pp", "dp", "fsdp", "ep", "sp", "tp")}
        mesh = spmd.get_mesh()
        assert mesh.mesh_dim_names == build_mesh(MeshConfig()).mesh_dim_names
        runs = {}
        for compiled in (False, True):
            for m in (mesh, None):
                torch._dynamo.reset()
                opt = adamw(LR)
                init = functools.partial(tl.init, cfg,
                                         torch.Generator().manual_seed(0))
                state = init_train_state(
                    init, opt, device="cpu",
                    param_logical_axes=(tl.param_logical_axes(cfg) if m
                                        else None), mesh=m)
                step = make_train_step(functools.partial(
                    tl.loss_fn, config=cfg, mesh=m), opt, compiled=compiled,
                    backend="aot_eager")
                out = []
                for i in range(3):
                    b = _batch(20 + i, b=2)
                    batch = (shard_local_batch(b, batch_sharding(m), m)
                             if m is not None else
                             {k: torch.from_numpy(v) for k, v in b.items()})
                    state, metrics = step(state, batch)
                    out.append((float(metrics["loss"]),
                                float(metrics["grad_norm"])))
                runs[compiled, m is not None] = (
                    out, [gang_cases._full(p)
                          for p in tree_leaves(state.params)])
        torch._dynamo.reset()
        # The sharded step, eager and compiled (as one compiled program
        # over DTensor parameters since the sharded step compiles), equals
        # the unsharded step of the same form.
        for compiled in (False, True):
            (sharded, p_sharded), (plain, p_plain) = (
                runs[compiled, True], runs[compiled, False])
            np.testing.assert_allclose(sharded, plain, rtol=LOSS_RTOL)
            for a, b in zip(p_sharded, p_plain):
                np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)
    finally:
        spmd.teardown_worker_mesh()
        backend.destroy_process_group()
    assert spmd.get_mesh() is None
