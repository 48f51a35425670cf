"""The port's compiled training step and its compile entry against the JAX
package, on the CPU.

`make_train_step` compiles by default (the loss with its backward, and the
norm with the AdamW update, as torch.compile programs); here it compiles
with `backend="aot_eager"` (AOTAutograd's graphs run eagerly: no inductor
on the CPU) and three steps and a resume are held against
`ray_tpu.train.step` on a one-device CPU mesh at the eager step's
tolerances (`tests/test_torch_train.py`). `graft_entry.entry` compiled with
aot_eager is held against `__graft_entry__.entry()` with its weights
carried across by `models/convert.py`.
"""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import __graft_entry__
from ray_tpu.models import llama as jl
from ray_tpu.parallel.mesh import MeshConfig, build_mesh
from ray_tpu.parallel.sharding import LogicalAxisRules
from ray_tpu.train.step import init_train_state as jax_init_train_state
from ray_tpu.train.step import make_train_step as jax_make_train_step
from ray_tpu_torch import graft_entry
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.models.convert import (adamw_state_from_jax_numpy,
                                          params_from_jax_numpy)
from ray_tpu_torch.parallel import hlo_report
from ray_tpu_torch.train import adamw, init_train_state, make_train_step
from ray_tpu_torch.train.optim import tree_leaves

VOCAB = 128
LR = 1e-3
# tests/test_torch_train.py's bounds for the eager step: loss and grad norm
# relative 1e-5; parameters within the learning rate (an element whose
# gradient is at fp32 rounding level takes a step of up to one lr).
LOSS_RTOL = 1e-5
PARAM_ATOL = LR
# The llama parity bound of bf16 logits (tests/test_torch_llama.py).
BF16_REL_L2 = 3e-2


@pytest.fixture(autouse=True)
def fresh_dynamo():
    """Compiled code of one test does not count against the next's
    recompile limit."""
    torch._dynamo.reset()
    yield
    torch._dynamo.reset()


def _configs():
    jcfg = dataclasses.replace(jl.LlamaConfig.tiny(vocab_size=VOCAB),
                               dtype=jnp.float32)
    tcfg = dataclasses.replace(tl.LlamaConfig.tiny(vocab_size=VOCAB),
                               dtype=torch.float32)
    return jcfg, tcfg


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}" if prefix else k))
        return out
    if isinstance(tree, torch.Tensor):
        return {prefix: tree.detach().float().numpy()}
    return {prefix: np.asarray(tree, dtype=np.float32)}


@pytest.fixture(scope="module")
def jax_run():
    """Three JAX steps of optax.adamw(LR) (default decay) on a one-device
    CPU mesh: the initial weights, the state after two steps, the metrics
    and the final weights (as tests/test_torch_train.py's)."""
    jcfg, _ = _configs()
    mesh = build_mesh(MeshConfig(dp=1), devices=jax.devices()[:1])
    rules = LogicalAxisRules()
    opt = optax.adamw(LR)
    state, shardings = jax_init_train_state(
        partial(jl.init, jcfg), opt, jl.param_logical_axes(jcfg), mesh,
        jax.random.PRNGKey(0), rules)
    step = jax_make_train_step(
        partial(jl.loss_fn, config=jcfg, mesh=mesh, rules=rules), opt,
        shardings)
    rng = np.random.default_rng(3)
    batches = [rng.integers(0, VOCAB, (2, 65)) for _ in range(3)]
    out = {"init": jax.device_get(state.params), "batches": batches,
           "metrics": []}
    for i, b in enumerate(batches):
        state, m = step(state, {"tokens": jnp.asarray(b)})
        out["metrics"].append((float(m["loss"]), float(m["grad_norm"])))
        if i == 1:
            out["after2"] = (jax.device_get(state.params),
                             jax.device_get(state.opt_state))
    out["final"] = jax.device_get(state.params)
    return out


def _compiled_step(tcfg, opt):
    return make_train_step(partial(tl.loss_fn, config=tcfg), opt,
                           backend="aot_eager")


def _assert_params_close(params, want):
    got, want = _flat(params), _flat(want)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], atol=PARAM_ATOL,
                                   rtol=0, err_msg=name)


def test_three_compiled_adamw_steps_match_jax(jax_run):
    _, tcfg = _configs()
    opt = adamw(LR, weight_decay=1e-4)
    state = init_train_state(
        lambda dev: params_from_jax_numpy(jax_run["init"], tcfg, dev), opt,
        device="cpu")
    step = _compiled_step(tcfg, opt)
    for i, (b, (jloss, jnorm)) in enumerate(zip(jax_run["batches"],
                                                jax_run["metrics"])):
        state, m = step(state, {"tokens": torch.from_numpy(b)})
        assert int(m["step"]) == int(state.step) == i + 1
        np.testing.assert_allclose(float(m["loss"]), jloss, rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(m["grad_norm"]), jnorm,
                                   rtol=LOSS_RTOL)
    assert state.opt_state.count == 3
    assert not any(p.requires_grad for p in tree_leaves(state.params))
    _assert_params_close(state.params, jax_run["final"])


def test_compiled_resume_from_jax_state(jax_run):
    """Two JAX steps, then params and AdamW state carried into the port:
    the port's compiled third step is JAX's third step."""
    _, tcfg = _configs()
    params, opt_state = jax_run["after2"]
    opt = adamw(LR)
    state = init_train_state(
        lambda dev: params_from_jax_numpy(params, tcfg, dev), opt,
        device="cpu")
    state.opt_state = adamw_state_from_jax_numpy(opt_state, tcfg, "cpu")
    step = _compiled_step(tcfg, opt)
    state, m = step(state, {"tokens": torch.from_numpy(jax_run["batches"][2])})
    jloss, jnorm = jax_run["metrics"][2]
    np.testing.assert_allclose(float(m["loss"]), jloss, rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(m["grad_norm"]), jnorm, rtol=LOSS_RTOL)
    assert state.opt_state.count == 3
    _assert_params_close(state.params, jax_run["final"])


def test_train_step_compiles_by_default_and_eager_is_a_choice(monkeypatch):
    """make_train_step builds both halves with torch.compile unless asked
    for the eager step; each compile asks for one full graph at static
    shapes, so a graph break raises instead of splitting the step."""
    seen, backends = [], []

    def record(fn, **kw):
        seen.append(kw)
        return fn

    def recording(backend, programs, options=None):
        backends.append((backend, options))
        return real(backend, programs, options)

    real = hlo_report.recording
    monkeypatch.setattr(torch, "compile", record)
    monkeypatch.setattr(hlo_report, "recording", recording)
    _, tcfg = _configs()
    make_train_step(partial(tl.loss_fn, config=tcfg), adamw(LR))
    # inductor, through the backend that notes each program's collectives
    # for parallel.hlo_report
    assert [{k: v for k, v in kw.items() if k != "backend"} for kw in seen] \
        == [dict(fullgraph=True, dynamic=False)] * 2
    assert all(callable(kw["backend"]) for kw in seen)
    assert backends == [("inductor", None),
                        ("inductor", {"loop_ordering_after_fusion": False})]
    seen.clear()
    make_train_step(partial(tl.loss_fn, config=tcfg), adamw(LR),
                    compiled=False)
    assert seen == []


def test_graft_entry_matches_the_jax_entry():
    """The port's entry, compiled (aot_eager, fullgraph), on the JAX
    entry's weights and tokens: bf16 logits within the llama parity
    bound."""
    jfn, (jparams, jtokens) = __graft_entry__.entry()
    want = np.asarray(jax.jit(jfn)(jparams, jtokens), np.float32)
    fn, (params, tokens) = graft_entry.entry(device="cpu")
    cfg = graft_entry.flagship_config()
    jcfg = __graft_entry__._flagship_config()
    for field in ("vocab_size", "d_model", "n_layers", "n_heads",
                  "n_kv_heads", "d_head", "d_ff", "max_seq_len", "remat",
                  "remat_policy", "loss_chunk_size"):
        assert getattr(cfg, field) == getattr(jcfg, field), field
    assert cfg.dtype == torch.bfloat16 and jcfg.dtype == jnp.bfloat16
    assert tokens.shape == jtokens.shape and not tokens.any()
    assert params["embed"].device.type == "cpu"
    converted = params_from_jax_numpy(jax.device_get(jparams), cfg, "cpu")
    with torch.no_grad():
        got = torch.compile(fn, backend="aot_eager", fullgraph=True)(
            converted, tokens)
    assert got.dtype == torch.float32 and got.shape == want.shape
    rel = np.linalg.norm(got.numpy() - want) / np.linalg.norm(want)
    assert rel < BF16_REL_L2


def test_graft_entry_needs_cuda_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft_entry.entry()
