"""The port's compiled sharded Llama step against the JAX package's jitted
one and against its own eager sharded step, on the CPU.

One 4-rank gloo gang (spawned once for the file) runs three AdamW steps of
the tiny fp32 Llama through `make_train_step(..., compiled=True)` (fullgraph
with aot_eager: the sharded loss and its backward over DTensor parameters
as one program, the norm with its all-reduce and the update of the local
blocks as another) and eagerly from the same state, on fsdp=2 x tp=2 and
on sp=2 x fsdp=2 with the ring (its forward and backward are operators
that hold their sends and receives). Both are held against
`ray_tpu.train.step`'s sharded steps on the same mesh shape of the 8
virtual CPU devices at tests/test_torch_spmd_step.py's tolerances (loss and
grad norm 1e-5 relative, parameters within the learning rate), and the
compiled step against the eager one; each rank's flash calls a step follow
the remat policy and the ring, compiled as eagerly.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
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
LOSS_RTOL = 1e-5
PARAM_ATOL = LR

# (config kwargs, mesh kwargs)
MESHES = {
    "fsdp2xtp2": (dict(), dict(fsdp=2, tp=2)),
    "ring-sp2xfsdp2": (dict(use_ring_attention=True), dict(sp=2, fsdp=2)),
}


def _jmesh(mesh_kw):
    sizes = jmesh.MeshConfig(**mesh_kw).resolved(WORLD).axis_sizes()
    return Mesh(np.asarray(jax.devices()[:WORLD]).reshape(
        tuple(sizes[a] for a in jmesh.AXIS_ORDER)), jmesh.AXIS_ORDER)


def _batch(seed, b=4, s=64):
    toks = np.random.default_rng(seed).integers(0, VOCAB, (b, s + 1))
    return {"inputs": toks[:, :-1], "targets": toks[:, 1:]}


@pytest.fixture(scope="module")
def jax_steps():
    """Per mesh, three steps of optax.adamw(LR) from the sharded init:
    initial weights, batches, metrics, final weights."""
    out = {}
    for name, (kw, mesh_kw) in MESHES.items():
        jcfg = dataclasses.replace(jl.LlamaConfig.tiny(vocab_size=VOCAB),
                                   dtype=jnp.float32, **kw)
        mesh = _jmesh(mesh_kw)
        rules = LogicalAxisRules()
        opt = optax.adamw(LR)
        state, shardings = jax_init_train_state(
            functools.partial(jl.init, jcfg), opt,
            jl.param_logical_axes(jcfg), mesh, jax.random.PRNGKey(0), rules)
        bs = logical_sharding(mesh, ("batch", "seq"), rules)
        step = jax_make_train_step(
            functools.partial(jl.loss_fn, config=jcfg, mesh=mesh,
                              rules=rules),
            opt, shardings, batch_sharding={"inputs": bs, "targets": bs})
        batches = [_batch(30 + i) for i in range(3)]
        run = {"init": jax.device_get(state.params), "batches": batches,
               "metrics": []}
        for b in batches:
            state, m = step(state, {k: jax.device_put(v, bs)
                                    for k, v in b.items()})
            run["metrics"].append((float(m["loss"]), float(m["grad_norm"])))
        run["final"] = jax.device_get(state.params)
        out[name] = run
    return out


@pytest.fixture(scope="module")
def gang(tmp_path_factory, jax_steps):
    cases = []
    for name, (kw, mesh_kw) in MESHES.items():
        run = jax_steps[name]
        for compiled in (True, False):
            cases.append(("train_steps", (
                run["init"], run["batches"], dict(vocab_size=VOCAB, **kw),
                mesh_kw, LR, 1e-4, 1, compiled)))
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


def _result(gang, rank, name, compiled):
    return gang[rank][2 * list(MESHES).index(name) + (0 if compiled else 1)]


@pytest.mark.parametrize("compiled", [True, False],
                         ids=["compiled", "eager"])
@pytest.mark.parametrize("name", list(MESHES))
def test_three_sharded_steps_match_jax(gang, jax_steps, name, compiled):
    got, run = _result(gang, 0, name, compiled), jax_steps[name]
    for (loss, norm), (jloss, jnorm) in zip(got["metrics"], run["metrics"]):
        np.testing.assert_allclose(loss, jloss, rtol=LOSS_RTOL)
        np.testing.assert_allclose(norm, jnorm, rtol=LOSS_RTOL)
    assert got["moment_placements_match"]
    want, params = _flat(run["final"]), _flat(got["params"])
    assert params.keys() == want.keys()
    for key, w in want.items():
        np.testing.assert_allclose(params[key], w, atol=PARAM_ATOL, rtol=0,
                                   err_msg=key)
    for rank in range(1, WORLD):  # one loss on every rank
        assert (_result(gang, rank, name, compiled)["metrics"]
                == got["metrics"])


@pytest.mark.parametrize("name", list(MESHES))
def test_compiled_sharded_step_matches_the_eager_one(gang, name):
    compiled, eager = (_result(gang, 0, name, c) for c in (True, False))
    np.testing.assert_allclose(compiled["metrics"], eager["metrics"],
                               rtol=LOSS_RTOL)
    want = _flat(eager["params"])
    for key, w in _flat(compiled["params"]).items():
        np.testing.assert_allclose(w, want[key], atol=1e-6, rtol=0,
                                   err_msg=key)


@pytest.mark.parametrize("compiled", [True, False],
                         ids=["compiled", "eager"])
@pytest.mark.parametrize("name", list(MESHES))
def test_flash_calls_a_step_follow_remat_and_ring(gang, name, compiled):
    """Under "dots" the backward reruns the forward; the ring visits its
    own block and every earlier one (on sp=2 x fsdp=2 rank r sits at sp
    coordinate r % 2): 2L(c+1) / L(c+1) with c the sp coordinate."""
    kw, _ = MESHES[name]
    layers = tl.LlamaConfig.tiny().n_layers
    for rank in range(WORLD):
        blocks = rank % 2 + 1 if kw.get("use_ring_attention") else 1
        want = {"flash_fwd": 2 * layers * blocks,
                "flash_bwd": layers * blocks}
        calls = _result(gang, rank, name, compiled)["calls"]
        assert all(c == want for c in calls), (rank, calls)
