"""The port's Mixtral, ViT and T5 on a mesh against the JAX package's, on
the CPU.

One 4-rank gloo gang (spawned once for the file) runs each tiny fp32 model
through its `loss_fn(mesh=...)` on DTensor parameters in the shardings of
its `param_logical_axes` and a DTensor batch: Mixtral on dp=2 x ep=2 (the
MoE through `moe_shard_map`, the tokens split over ep as JAX splits them),
ViT-B's tiny form on dp=4 and T5 on dp=2 x tp=2 (vocab-parallel embedding
and cross-entropy, heads and hidden units over tp). Each model's loss and
whole gradients are held against `jax.value_and_grad` of the JAX `loss_fn`
on the same mesh shape of the 8 virtual CPU devices, its parameters and
batch placed there by their NamedShardings (and its `forward(mesh=...)`
logits against the JAX forward's), and three AdamW steps against
`ray_tpu.train.step`'s sharded `init_train_state` / `make_train_step`
(Mixtral's step compiled with aot_eager, fullgraph, as Llama's is; ViT's and
T5's eagerly, as their one-device steps run). `param_logical_axes` of all
three equal JAX's.
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

from ray_tpu.models import mixtral as jmx
from ray_tpu.models import t5 as jt5
from ray_tpu.models import vit as jvit
from ray_tpu.parallel import mesh as jmesh
from ray_tpu.parallel.sharding import (LogicalAxisRules, logical_sharding,
                                       param_shardings)
from ray_tpu.train.step import init_train_state as jax_init_train_state
from ray_tpu.train.step import make_train_step as jax_make_train_step
from ray_tpu_torch.models import mixtral as tmx
from ray_tpu_torch.models import t5 as tt5
from ray_tpu_torch.models import vit as tvit
from ray_tpu_torch.parallel import gang_cases
from ray_tpu_torch.train.backend import launch_gang

WORLD = 4
GANG_TIMEOUT_S = 240
VOCAB = 128
LR = 1e-3
# tests/test_torch_spmd_step.py's bounds: fp32 on both sides, sums in
# another order.
LOSS_RTOL = 1e-5
GRAD_ATOL, GRAD_RTOL = 2e-5, 2e-4
PARAM_ATOL = LR


def _tokens_batch(seed, b=4, s=32):
    toks = np.random.default_rng(seed).integers(0, VOCAB, (b, s + 1))
    return {"inputs": toks[:, :-1], "targets": toks[:, 1:]}


def _vit_batch(seed, b=8):
    rng = np.random.default_rng(seed)
    return {"images": rng.normal(size=(b, 32, 32, 3)).astype(np.float32),
            "labels": rng.integers(0, 10, (b,))}


def _t5_batch(seed, b=4, s=12, t=9):
    rng = np.random.default_rng(seed)
    src = rng.integers(1, VOCAB, (b, s))
    tgt = rng.integers(1, VOCAB, (b, t))
    src[:, -2:] = 0   # padding: masked keys and masked labels
    tgt[0, -3:] = 0
    return {"src": src, "tgt": tgt}


# family: (JAX module, JAX config, port config kwargs, mesh, batch maker,
#          logical axes of the batch, port step compiled)
FAMILIES = {
    "mixtral": (jmx, dataclasses.replace(
        jmx.MixtralConfig.tiny(vocab_size=VOCAB), dtype=jnp.float32),
        dict(vocab_size=VOCAB), dict(dp=2, ep=2), _tokens_batch,
        {"inputs": ("batch", "seq"), "targets": ("batch", "seq")}, True),
    "vit": (jvit, jvit.ViTConfig.tiny(), {}, dict(dp=4), _vit_batch,
            {"images": ("batch", None, None, None), "labels": ("batch",)},
            False),
    "t5": (jt5, jt5.T5Config.tiny(vocab_size=VOCAB), dict(vocab_size=VOCAB),
           dict(dp=2, tp=2), _t5_batch,
           {"src": ("batch", None), "tgt": ("batch", None)}, False),
}
PORT = {"mixtral": tmx, "vit": tvit, "t5": tt5}
# chip_smoke.py's ViT-over-dp=4 checks on CPU ranks, the tiny ViT in bf16:
# `spmd_bench.versus_one(family, cfg, plan, batch, logical, steps, seed, lr,
# compiled, first_step_and_fp32)`.
VIT_VERSUS_ONE = ("vit", dataclasses.replace(tvit.ViTConfig.tiny(),
                                             dtype=torch.bfloat16),
                  {"dp": 4}, _vit_batch(5), FAMILIES["vit"][5], 2, 0, LR,
                  False, True)


def _jmesh(mesh_kw):
    sizes = jmesh.MeshConfig(**mesh_kw).resolved(WORLD).axis_sizes()
    return Mesh(np.asarray(jax.devices()[:WORLD]).reshape(
        tuple(sizes[a] for a in jmesh.AXIS_ORDER)), jmesh.AXIS_ORDER)


def _jax_loss(family):
    jmod, jcfg, _, mesh_kw, _, _, _ = FAMILIES[family]
    mesh = _jmesh(mesh_kw)
    kw = {"mesh": mesh, "rules": LogicalAxisRules()}
    return functools.partial(jmod.loss_fn, config=jcfg, **kw), mesh


def _place_batch(batch, logical, mesh):
    rules = LogicalAxisRules()
    return {k: jax.device_put(jnp.asarray(v), logical_sharding(
        mesh, logical[k], rules)) for k, v in batch.items()}


@pytest.fixture(scope="module")
def jax_runs():
    """Per family, three JAX steps of optax.adamw(LR) on its mesh from the
    sharded init: initial weights, batches, metrics, final weights."""
    out = {}
    for family, (jmod, jcfg, _, mesh_kw, make, logical, _) in \
            FAMILIES.items():
        loss, mesh = _jax_loss(family)
        rules = LogicalAxisRules()
        opt = optax.adamw(LR)
        state, shardings = jax_init_train_state(
            functools.partial(jmod.init, jcfg), opt,
            jmod.param_logical_axes(jcfg), mesh, jax.random.PRNGKey(0),
            rules)
        step = jax_make_train_step(loss, opt, shardings, batch_sharding={
            k: logical_sharding(mesh, v, rules) for k, v in logical.items()})
        batches = [make(10 + i) for i in range(3)]
        run = {"init": jax.device_get(state.params), "batches": batches,
               "metrics": []}
        for b in batches:
            state, m = step(state, _place_batch(b, logical, mesh))
            run["metrics"].append((float(m["loss"]), float(m["grad_norm"])))
        run["final"] = jax.device_get(state.params)
        out[family] = run
    return out


@pytest.fixture(scope="module")
def gang(tmp_path_factory, jax_runs):
    cases = []
    for family, (_, _, cfg_kw, mesh_kw, make, logical, compiled) in \
            FAMILIES.items():
        run = jax_runs[family]
        cases.append(("zoo_loss_and_grads", (family, run["init"], make(0),
                                             logical, cfg_kw, mesh_kw)))
        cases.append(("zoo_train_steps", (family, run["init"],
                                          run["batches"], logical, cfg_kw,
                                          mesh_kw, LR, 1e-4, compiled)))
    cases.append(("spmd_versus_one", VIT_VERSUS_ONE))
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


@pytest.mark.parametrize("family", list(FAMILIES))
def test_param_logical_axes_equal_jax(family):
    jmod, jcfg = FAMILIES[family][:2]
    port = PORT[family]
    tcfg = gang_cases._family(family, FAMILIES[family][2])[1]
    assert port.param_logical_axes(tcfg) == jmod.param_logical_axes(jcfg)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_sharded_loss_and_grads_match_jax_on_the_same_mesh(gang, jax_runs,
                                                           family):
    jmod, jcfg, _, _, make, logical, _ = FAMILIES[family]
    loss_fn, mesh = _jax_loss(family)
    rules = LogicalAxisRules()
    params = jax.device_put(jax_runs[family]["init"], param_shardings(
        jmod.param_logical_axes(jcfg), mesh, rules))
    want_loss, grads = jax.jit(jax.value_and_grad(loss_fn))(
        params, _place_batch(make(0), logical, mesh))
    i = 2 * list(FAMILIES).index(family)
    got = gang[0][i]
    np.testing.assert_allclose(got["loss"], float(want_loss), rtol=LOSS_RTOL)
    want = _flat(jax.device_get(grads))
    assert set(got["grads"]) == set(want)
    for name, g in want.items():
        np.testing.assert_allclose(
            got["grads"][name], g, rtol=GRAD_RTOL,
            atol=GRAD_ATOL * float(np.abs(g).max()), err_msg=name)
    for rank in range(WORLD):  # one loss on every rank
        assert gang[rank][i]["loss"] == got["loss"]
    # forward(mesh=...) against the JAX forward of the same batch
    batch = {k: jnp.asarray(v) for k, v in make(0).items()}
    jparams = jax_runs[family]["init"]
    if family == "mixtral":
        want = jmod.forward(jparams, batch["inputs"], jcfg, mesh=mesh,
                            rules=rules)[0]
    elif family == "vit":
        want = jmod.forward(jparams, batch["images"], jcfg)
    else:
        want = jmod.forward(jparams, batch["src"], batch["tgt"][:, :-1], jcfg)
    np.testing.assert_allclose(got["logits"], np.asarray(want), rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_three_sharded_adamw_steps_match_jax(gang, jax_runs, family):
    i = 2 * list(FAMILIES).index(family) + 1
    got, run = gang[0][i], jax_runs[family]
    for (loss, norm), (jloss, jnorm) in zip(got["metrics"], run["metrics"]):
        np.testing.assert_allclose(loss, jloss, rtol=LOSS_RTOL)
        np.testing.assert_allclose(norm, jnorm, rtol=LOSS_RTOL)
    want, params = _flat(run["final"]), _flat(got["params"])
    assert params.keys() == want.keys()
    for name, w in want.items():
        np.testing.assert_allclose(params[name], w, atol=PARAM_ATOL, rtol=0,
                                   err_msg=name)
    for rank in range(1, WORLD):
        assert gang[rank][i]["metrics"] == got["metrics"]


def test_mixtral_attention_runs_the_flash_kernels_on_every_rank(gang):
    """Mixtral's attention sublayer is Llama's sharded one: under "dots"
    each rank runs the forward twice a layer (the backward reruns it) and
    the backward once, three steps."""
    layers = tmx.MixtralConfig.tiny().n_layers
    for rank in range(WORLD):
        assert gang[rank][1]["calls"] == {"flash_fwd": 3 * 2 * layers,
                                          "flash_bwd": 3 * layers}


def test_vit_over_dp4_first_step_and_fp32_steps_match_one_rank(gang):
    """chip_smoke.py's ViT-over-dp=4 checks, rehearsed on CPU ranks: (a)
    the first bf16 step's loss (1e-3) and global gradient norm (1e-2),
    after the dp reduction, against rank 0 alone on the same batch, and
    (b) three fp32 steps' losses within 1e-3 of rank 0's alone."""
    got = gang[0][2 * len(FAMILIES)]
    first = got["first"]
    assert first["loss_rel"] <= 1e-3, first
    assert first["grad_norm_rel"] <= 1e-2, first
    assert np.isfinite(first["leaf_rel_max"]) and first["leaf"]
    f32 = got["fp32"]
    assert len(f32["one"]["losses"]) == len(f32["mesh"]["losses"]) == 3
    np.testing.assert_allclose(f32["mesh"]["losses"], f32["one"]["losses"],
                               rtol=1e-3)
    for rank in range(1, WORLD):
        assert gang[rank][2 * len(FAMILIES)]["first"] == {}
