"""The port's Mixtral against the JAX package's, on the CPU.

`ray_tpu_torch.models.mixtral` against `ray_tpu.models.mixtral` at the
tiny fp32 config on the same numpy inputs: `forward` logits and aux loss,
`loss_fn` and its gradients under each remat policy, the flash launches a
step under each policy, and three AdamW steps against `ray_tpu.train.step`
on a one-device CPU mesh, eager and compiled (`aot_eager`, fullgraph at
static shapes: the index-form dispatch traces as one graph). Weights come
from the JAX side and cross with `convert.params_from_jax_numpy`; attention
takes the flash kernels' plain versions, and JAX's `flash_attention` its
reference path. Routing is batch-coupled (the capacity counts every token
of the batch), so both sides always see the same B.

Each test that compares a routing asserts its margin: the least gap
between a token's k-th and (k+1)-th gate probability stays above MARGIN,
so that a choice flipped by fp32 noise shows as that and not as a wrong
output.
"""

import dataclasses
import time
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu.models import mixtral as jm
from ray_tpu.parallel.mesh import MeshConfig, build_mesh
from ray_tpu.parallel.sharding import LogicalAxisRules
from ray_tpu.train.step import init_train_state as jax_init_train_state
from ray_tpu.train.step import make_train_step as jax_make_train_step
from ray_tpu_torch.models import mixtral as tm
from ray_tpu_torch.models.convert import params_from_jax_numpy
from ray_tpu_torch.parallel import moe as tmoe
from ray_tpu_torch.train import adamw, init_train_state, make_train_step
from test_torch_custom_ops import FWD_PER_LAYER, count_kernel_calls
from test_torch_models import _assert_trees_close, _flat, _port_loss_and_grads

VOCAB = 128
LR = 1e-3
# fp32 logits and aux (the llama parity bound of tests/test_torch_llama.py).
FWD_TOL = 2e-4
# tests/test_torch_train.py's training bounds: loss relative 1e-5 (grads
# through test_torch_models._assert_trees_close); parameters after AdamW
# steps within the learning rate.
LOSS_RTOL = 1e-5
PARAM_ATOL = LR
MARGIN = 1e-5


def _configs(**kw):
    jcfg = dataclasses.replace(jm.MixtralConfig.tiny(vocab_size=VOCAB),
                               dtype=jnp.float32, **kw)
    tcfg = dataclasses.replace(tm.MixtralConfig.tiny(vocab_size=VOCAB),
                               dtype=torch.float32, **kw)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def tiny_params():
    jcfg, _ = _configs()
    return jax.device_get(jm.init(jcfg, jax.random.PRNGKey(0)))


@pytest.fixture
def fresh_dynamo():
    torch._dynamo.reset()
    yield
    torch._dynamo.reset()


def record_margins(monkeypatch):
    """-> the list that gets the least k-th / (k+1)-th probability gap of
    every routing the port runs."""
    gaps, route = [], tmoe.route

    def recording(logits, k, capacity):
        r = route(logits, k, capacity)
        top = torch.sort(r.probs.detach(), dim=-1, descending=True).values
        gaps.append(float((top[:, k - 1] - top[:, k]).min()))
        return r

    monkeypatch.setattr(tmoe, "route", recording)
    return gaps


def _batch(form="tokens", seed=1, b=2, s=48):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, VOCAB, (b, s + 1))
    if form == "tokens":
        return {"tokens": tokens}
    return {"inputs": tokens[:, :-1], "targets": tokens[:, 1:],
            "mask": (rng.random((b, s)) > 0.3).astype(np.float32)}


def test_forward_matches_jax(tiny_params, monkeypatch):
    jcfg, tcfg = _configs()
    tokens = np.random.default_rng(0).integers(0, VOCAB, (2, 64))
    jlogits, jaux = jax.jit(partial(jm.forward, config=jcfg))(
        tiny_params, jnp.asarray(tokens))
    gaps = record_margins(monkeypatch)
    params = params_from_jax_numpy(tiny_params, tcfg, device="cpu")
    with torch.no_grad():
        logits, aux = tm.forward(params, torch.from_numpy(tokens), tcfg)
    assert len(gaps) == tcfg.n_layers and min(gaps) > MARGIN, gaps
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               rtol=FWD_TOL, atol=FWD_TOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=FWD_TOL,
                               atol=FWD_TOL)


@pytest.mark.parametrize("policy,form", [
    ("full", "tokens"), ("dots", "tokens"), ("dots_attn", "masked")])
def test_loss_and_grads_match_jax(tiny_params, policy, form, monkeypatch):
    jcfg, tcfg = _configs(remat_policy=policy)
    batch = _batch(form)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        partial(jm.loss_fn, config=jcfg)))(
        tiny_params, {k: jnp.asarray(v) for k, v in batch.items()})
    gaps = record_margins(monkeypatch)
    params = params_from_jax_numpy(tiny_params, tcfg, device="cpu")
    loss, grads = _port_loss_and_grads(partial(tm.loss_fn, config=tcfg),
                                       params, batch)
    assert min(gaps) > MARGIN, gaps
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL)
    _assert_trees_close(grads, jax.device_get(jgrads))


@pytest.mark.parametrize("policy", list(FWD_PER_LAYER))
def test_flash_launches_a_step_by_policy(tiny_params, policy, monkeypatch):
    kw = ({"remat": False} if policy == "off"
          else {"remat_policy": policy})
    _, tcfg = _configs(**kw)
    calls = count_kernel_calls(monkeypatch)
    params = params_from_jax_numpy(tiny_params, tcfg, device="cpu")
    _port_loss_and_grads(partial(tm.loss_fn, config=tcfg), params, _batch())
    n = tcfg.n_layers
    assert calls == {"fwd": FWD_PER_LAYER[policy] * n, "bwd": n}


@pytest.fixture(scope="module")
def jax_run():
    """Three JAX steps of optax.adamw(LR) on a one-device CPU mesh: the
    initial weights, the metrics and the final weights."""
    jcfg, _ = _configs()
    mesh = build_mesh(MeshConfig(dp=1), devices=jax.devices()[:1])
    rules = LogicalAxisRules()
    opt = optax.adamw(LR)
    state, shardings = jax_init_train_state(
        partial(jm.init, jcfg), opt, jm.param_logical_axes(jcfg), mesh,
        jax.random.PRNGKey(0), rules)
    step = jax_make_train_step(
        partial(jm.loss_fn, config=jcfg, mesh=mesh, rules=rules), opt,
        shardings)
    rng = np.random.default_rng(3)
    batches = [rng.integers(0, VOCAB, (2, 49)) for _ in range(3)]
    out = {"init": jax.device_get(state.params), "batches": batches,
           "metrics": []}
    for b in batches:
        state, m = step(state, {"tokens": jnp.asarray(b)})
        out["metrics"].append((float(m["loss"]), float(m["grad_norm"])))
    out["final"] = jax.device_get(state.params)
    return out


@pytest.mark.parametrize("compiled", [False, True],
                         ids=["eager", "compiled"])
def test_three_adamw_steps_match_jax(jax_run, compiled, monkeypatch,
                                     fresh_dynamo):
    """make_train_step over mixtral.loss_fn, unchanged: eagerly, and
    compiled (fullgraph, static shapes) with aot_eager."""
    _, tcfg = _configs()
    gaps = [] if compiled else record_margins(monkeypatch)
    opt = adamw(LR, weight_decay=1e-4)
    state = init_train_state(
        lambda dev: params_from_jax_numpy(jax_run["init"], tcfg, dev), opt,
        device="cpu")
    step = make_train_step(partial(tm.loss_fn, config=tcfg), opt,
                           compiled=compiled, backend="aot_eager")
    for i, (b, (jloss, jnorm)) in enumerate(zip(jax_run["batches"],
                                                jax_run["metrics"])):
        state, m = step(state, {"tokens": torch.from_numpy(b)})
        assert int(m["step"]) == i + 1
        np.testing.assert_allclose(float(m["loss"]), jloss, rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(m["grad_norm"]), jnorm,
                                   rtol=LOSS_RTOL)
    assert compiled or min(gaps) > MARGIN, gaps
    assert state.opt_state.count == 3
    got, want = _flat(state.params), _flat(jax_run["final"])
    assert got.keys() == want.keys()
    for name in want:
        np.testing.assert_allclose(got[name], want[name], atol=PARAM_ATOL,
                                   rtol=0, err_msg=name)


def test_config_counts_and_shapes_match_jax():
    """num_params, flops_per_token and the parameter shapes, at the tiny
    config and at Mixtral-8x7B's widths."""
    wide = dict(vocab_size=32_000, d_model=4096, n_layers=2, n_heads=32,
                n_kv_heads=8, d_head=128, d_ff=14_336, rope_theta=1e6)
    for kw in ({}, wide):
        jcfg, tcfg = _configs(**kw)
        assert tcfg.num_params() == jcfg.num_params()
        assert tm.flops_per_token(tcfg, 2048) == jm.flops_per_token(jcfg,
                                                                    2048)
    shapes = jax.eval_shape(partial(jm.init, jcfg), jax.random.PRNGKey(0))
    want = jax.tree_util.tree_map(lambda a: tuple(a.shape), shapes)
    assert tm.param_shapes(tcfg) == want


def test_chip_smoke_phase_k_rehearsed_on_the_cpu(monkeypatch, capsys,
                                                 tmp_path, request,
                                                 fresh_dynamo):
    """chip_smoke.py's phase (k), the model zoo, at tiny sizes on the CPU
    with the card stubbed and the kernels counted (as
    tests/test_torch_flash_sm90.py rehearses main()): every check of the
    phase runs; the launches it returns are the Mixtral path's, 2L / L / L
    a training step and L a forward through the kernel."""
    from test_torch_flash_sm90 import rehearse_on_the_cpu

    from ray_tpu_torch._private.accelerators.nvidia import peaks

    smoke = rehearse_on_the_cpu(monkeypatch, tmp_path, request)
    monkeypatch.setattr(smoke, "PEAKS", peaks("NVIDIA H100 80GB HBM3"))
    tiny = dict(vocab_size=96, d_model=64, n_layers=2, n_heads=4,
                n_kv_heads=2, d_head=16, d_ff=96, max_seq_len=64,
                n_experts=4, experts_per_token=2)
    monkeypatch.setattr(smoke, "MIXTRAL_8X7B", tiny)
    monkeypatch.setattr(smoke, "MIXTRAL_BATCH", (2, 32))
    monkeypatch.setattr(smoke, "MIXTRAL_STEPS", 2)
    monkeypatch.setattr(smoke, "VIT_CUT", dict(
        image_size=32, patch_size=8, d_model=32, n_layers=2, n_heads=2,
        d_ff=64, num_classes=10))
    monkeypatch.setattr(smoke, "VIT_BATCH", 4)
    monkeypatch.setattr(smoke, "T5_CUT", dict(
        vocab_size=96, d_model=32, n_enc_layers=2, n_dec_layers=2,
        n_heads=2, d_ff=64))
    monkeypatch.setattr(smoke, "T5_SHAPE", (2, 16, 8))
    monkeypatch.setattr(smoke, "T5_DECODE", 6)
    monkeypatch.setattr(smoke, "MLP_BATCH", 16)
    counts = smoke.phase_zoo(time.perf_counter())
    lines = capsys.readouterr().out.strip().splitlines()
    for tag in ("[k] Mixtral", "[k-1] mixtral.forward", "[k-2] eager:",
                "[k-2] compiled dots (aot_eager)", "[k-2] compiled dots:",
                "[k-2] compiled dots, torch.profiler", "[k-3] tiny fp32",
                "[k] launches on the Mixtral path", "[k-4] ViT-B/16",
                "[k-4] T5-base greedy_decode", "[k-4] MLP accuracy",
                "[k-4] tiny fp32 ViT", "[k-4] tiny fp32 T5",
                "[k-4] tiny fp32 MLP"):
        assert any(line.startswith(tag) for line in lines), tag
    assert sum("the loss did" not in line and "eager AdamW steps" in line
               for line in lines) == 3
    assert any("two runs identical True" in line for line in lines)
    # (k-1): L through the kernel, none through the plain attention; (k-2):
    # two eager trajectories of 3 steps, 3 eager losses and gradients of
    # the compiled states, and 3 + 2 timed + 2 profiled compiled steps.
    n = tiny["n_layers"]
    steps = 2 * 3 + 3 + 3 + 2 + 2
    assert counts == {"flash_fwd": n + steps * 2 * n,
                      "flash_bwd_dq": steps * n, "flash_bwd_dkv": steps * n}
