"""ray_tpu_torch training path against the JAX package's, on the CPU.

`loss_fn` and its gradients, the remat policies, `chunked_ce`, AdamW and the
train step of the port are held against `ray_tpu.models.llama`, optax and
`ray_tpu.train.step` on the same numpy inputs. Weights come from the JAX
side (`jax.device_get`) and cross with `convert.params_from_jax_numpy`;
a JAX optimizer state crosses with `convert.adamw_state_from_jax_numpy`.
The port runs with device="cpu", where attention takes the flash kernels'
plain versions (forward and backward).
"""

import dataclasses
import inspect
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu.models import llama as jl
from ray_tpu.parallel.mesh import MeshConfig, build_mesh
from ray_tpu.parallel.sharding import LogicalAxisRules
from ray_tpu.train.step import init_train_state as jax_init_train_state
from ray_tpu.train.step import make_train_step as jax_make_train_step
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.models.convert import (adamw_state_from_jax_numpy,
                                          params_from_jax_numpy)
from ray_tpu_torch.ops import flash_attention as tfa
from ray_tpu_torch.train import (adamw, global_norm, init_train_state,
                                 make_train_step)
from ray_tpu_torch.train.optim import tree_leaves, tree_map

VOCAB = 128
LR = 1e-3

# fp32 on both sides, the same arithmetic in another order (another matmul
# library, blocked attention): measured ~5e-7 on the loss and ~3e-6 of the
# largest gradient. Gradients: |a - b| <= GRAD_ATOL * max|b| + GRAD_RTOL |b|.
LOSS_RTOL = 1e-5
GRAD_ATOL, GRAD_RTOL = 2e-5, 2e-4
# After AdamW steps: an element whose gradient is at fp32 rounding level
# takes a step of up to one learning rate in a direction set by that
# rounding (Adam's first step is lr * sign(g)), so parameters agree to LR.
PARAM_ATOL = LR
# bf16 on both sides: activations round to bf16 at every layer, at the same
# points but after fp32 sums in another order; one step of bf16 weights.
BF16_LOSS_RTOL, BF16_NORM_RTOL = 1e-2, 3e-2


def _flat(tree, prefix=""):
    """Nested dict of arrays or tensors -> {"a/b": numpy array}."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}" if prefix else k))
        return out
    if isinstance(tree, torch.Tensor):
        return {prefix: tree.detach().float().numpy()}
    return {prefix: np.asarray(tree, dtype=np.float32)}


def _assert_trees_close(got, want, atol_frac=GRAD_ATOL, rtol=GRAD_RTOL):
    got, want = _flat(got), _flat(want)
    assert got.keys() == want.keys()
    for name in want:
        scale = float(np.abs(want[name]).max())
        np.testing.assert_allclose(got[name], want[name], rtol=rtol,
                                   atol=atol_frac * scale, err_msg=name)


def _configs(dtype=np.float32, **kw):
    jcfg = dataclasses.replace(jl.LlamaConfig.tiny(vocab_size=VOCAB),
                               dtype=jnp.dtype(dtype), **kw)
    tcfg = dataclasses.replace(
        tl.LlamaConfig.tiny(vocab_size=VOCAB),
        dtype=torch.float32 if dtype == np.float32 else torch.bfloat16, **kw)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def tiny_params():
    jcfg, _ = _configs()
    return jax.device_get(jl.init(jcfg, jax.random.PRNGKey(0)))


def _batch(form, seed=1, b=2, s=100):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, VOCAB, (b, s + 1))
    if form == "tokens":
        return {"tokens": tokens}
    batch = {"inputs": tokens[:, :-1], "targets": tokens[:, 1:]}
    if form == "masked":
        batch["mask"] = (rng.random((b, s)) > 0.3).astype(np.float32)
    return batch


def _port_loss_and_grads(params, batch, cfg):
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    loss = tl.loss_fn(params, tb, cfg)
    grads = iter(torch.autograd.grad(loss, leaves))
    return loss.detach(), tree_map(lambda _: next(grads), params)


# S = 100 with chunk 64: one full chunk and a remainder of 36.
@pytest.mark.parametrize("chunk,form", [
    (0, "tokens"), (0, "masked"), (64, "tokens"), (64, "masked"),
    (64, "unmasked")])
def test_loss_and_grads_match_jax(tiny_params, chunk, form):
    jcfg, tcfg = _configs(loss_chunk_size=chunk)
    batch = _batch(form)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        partial(jl.loss_fn, config=jcfg)))(
        tiny_params, {k: jnp.asarray(v) for k, v in batch.items()})
    params = params_from_jax_numpy(tiny_params, tcfg, device="cpu")
    loss, grads = _port_loss_and_grads(params, batch, tcfg)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL)
    _assert_trees_close(grads, jax.device_get(jgrads))


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_policies_agree_and_rerun_attention(tiny_params, policy,
                                                  monkeypatch):
    """Remat changes what is kept, not what is computed: loss and grads
    equal those without remat. Under either policy the attention forward
    reruns in the backward (two forward launches a layer), as the JAX
    policies rerun the pallas_call; without remat it runs once."""
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = tfa._flash_fwd, tfa._flash_bwd

    def count(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(tfa, "_flash_fwd", count("fwd", fwd))
    monkeypatch.setattr(tfa, "_flash_bwd", count("bwd", bwd))
    batch = _batch("masked", seed=2)
    results = {}
    for name, kw in (("off", dict(remat=False)),
                     (policy, dict(remat=True, remat_policy=policy))):
        _, tcfg = _configs(loss_chunk_size=64, **kw)
        calls.update(fwd=0, bwd=0)
        params = params_from_jax_numpy(tiny_params, tcfg, device="cpu")
        results[name] = _port_loss_and_grads(params, batch, tcfg)
        n = tcfg.n_layers
        assert calls == {"fwd": 2 * n if kw["remat"] else n, "bwd": n}
    (l0, g0), (l1, g1) = results["off"], results[policy]
    assert float(l1) == pytest.approx(float(l0), rel=1e-6)
    _assert_trees_close(g1, g0, atol_frac=1e-6, rtol=1e-5)


def test_dots_policy_saves_only_unbatched_products():
    save, recompute = (torch.utils.checkpoint.CheckpointPolicy.MUST_SAVE,
                       torch.utils.checkpoint.CheckpointPolicy.PREFER_RECOMPUTE)
    aten = torch.ops.aten
    assert tl._save_dots(None, aten.mm.default) == save
    for op in (aten.bmm.default, aten.mul.Tensor, aten.exp.default):
        assert tl._save_dots(None, op) == recompute
    with pytest.raises(ValueError, match="dots_attn"):
        tl._remat_context(dataclasses.replace(tl.LlamaConfig.tiny(),
                                              remat_policy="dots_attn"))


def test_dots_recomputes_no_matrix_product(tiny_params):
    """The backward under "dots" runs the matrix products of the backward
    only, as without remat; under "full" it reruns the forward's too."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class CountMM(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += func == torch.ops.aten.mm.default
            return func(*args, **(kwargs or {}))

    counts = {}
    for name, kw in (("off", dict(remat=False)),
                     ("full", dict(remat_policy="full")),
                     ("dots", dict(remat_policy="dots"))):
        _, tcfg = _configs(**kw)
        params = params_from_jax_numpy(tiny_params, tcfg, device="cpu")
        for p in tree_leaves(params):
            p.requires_grad_(True)
        loss = tl.loss_fn(params, {"tokens": torch.from_numpy(
            _batch("tokens")["tokens"])}, tcfg)
        with CountMM() as mode:
            loss.backward()
        counts[name] = mode.n
    assert counts["dots"] == counts["off"] < counts["full"]


def test_serving_takes_no_checkpoint(tiny_params, monkeypatch):
    """Without gradients forward_hidden checkpoints nothing, whatever
    config.remat says: the serving path is unchanged."""
    _, tcfg = _configs()
    params = params_from_jax_numpy(tiny_params, tcfg, device="cpu")

    def refuse(*a, **k):
        raise AssertionError("checkpoint under no_grad")

    monkeypatch.setattr(tl, "checkpoint", refuse)
    with torch.no_grad():
        logits = tl.forward(params, torch.zeros((1, 8), dtype=torch.int64),
                            tcfg)
    assert logits.shape == (1, 8, VOCAB)


@pytest.mark.parametrize("chunk", [32, 50, 100])  # remainder, exact, n = 0
@pytest.mark.parametrize("mask", ["none", "random", "zeros"])
def test_chunked_ce_matches_jax(chunk, mask):
    rng = np.random.default_rng(chunk)
    b, s, d = 2, 50, 16
    hidden = rng.standard_normal((b, s, d)).astype(np.float32)
    head = rng.standard_normal((d, VOCAB)).astype(np.float32)
    targets = rng.integers(0, VOCAB, (b, s))
    m = {"none": None, "zeros": np.zeros((b, s), np.float32),
         "random": (rng.random((b, s)) > 0.5).astype(np.float32)}[mask]
    want = jl.chunked_ce(jnp.asarray(hidden), jnp.asarray(head),
                         jnp.asarray(targets),
                         None if m is None else jnp.asarray(m), chunk=chunk)
    got = tl.chunked_ce(*(torch.from_numpy(x) for x in (hidden, head,
                                                        targets)),
                        None if m is None else torch.from_numpy(m),
                        chunk=chunk)
    np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL,
                               atol=1e-6)


def test_adamw_defaults_and_update_match_optax():
    """optax.adamw's defaults (weight_decay 1e-4, not torch's 0.01) and its
    update: three steps with a large decay, so that the decoupled decay on
    the pre-update parameter, the bias correction and eps all show."""
    ours = inspect.signature(adamw).parameters
    theirs = inspect.signature(optax.adamw).parameters
    for name in ("b1", "b2", "eps", "weight_decay"):
        assert ours[name].default == theirs[name].default, name
    rng = np.random.default_rng(0)
    params = {"w": rng.standard_normal((5, 7)).astype(np.float32),
              "layers": {"b": rng.standard_normal(9).astype(np.float32)}}
    grads = [{"w": rng.standard_normal((5, 7)).astype(np.float32),
              "layers": {"b": rng.standard_normal(9).astype(np.float32)}}
             for _ in range(3)]
    jopt = optax.adamw(0.1, weight_decay=0.5)
    jparams, jstate = params, jopt.init(params)
    topt = adamw(0.1, weight_decay=0.5)
    tparams = {"w": torch.from_numpy(params["w"].copy()),
               "layers": {"b": torch.from_numpy(params["layers"]["b"].copy())}}
    tstate = topt.init(tparams)
    for g in grads:
        updates, jstate = jopt.update(g, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        tg = [torch.from_numpy(g["w"]), torch.from_numpy(g["layers"]["b"])]
        topt.update_(tg, tstate, tparams)
        np.testing.assert_allclose(float(global_norm(tg)),
                                   float(optax.global_norm(g)), rtol=1e-6)
    assert tstate.count == 3
    _assert_trees_close(tparams, jax.device_get(jparams), atol_frac=1e-6,
                        rtol=1e-5)


@pytest.fixture(scope="module")
def jax_run():
    """Three JAX steps of optax.adamw(LR) (default decay) on a one-device
    CPU mesh: the initial weights, the state after two steps, the metrics
    and the final weights."""
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


def test_three_adamw_steps_match_jax(jax_run):
    _, tcfg = _configs()
    opt = adamw(LR, weight_decay=1e-4)
    state = init_train_state(
        lambda dev: params_from_jax_numpy(jax_run["init"], tcfg, dev), opt,
        device="cpu")
    step = make_train_step(partial(tl.loss_fn, config=tcfg), opt)
    for i, (b, (jloss, jnorm)) in enumerate(zip(jax_run["batches"],
                                                jax_run["metrics"])):
        state, m = step(state, {"tokens": torch.from_numpy(b)})
        assert isinstance(m["loss"], torch.Tensor)
        assert int(m["step"]) == int(state.step) == i + 1
        np.testing.assert_allclose(float(m["loss"]), jloss, rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(m["grad_norm"]), jnorm,
                                   rtol=LOSS_RTOL)
    assert state.opt_state.count == 3
    assert not any(p.requires_grad for p in tree_leaves(state.params))
    got, want = _flat(state.params), _flat(jax_run["final"])
    for name in want:
        np.testing.assert_allclose(got[name], want[name], atol=PARAM_ATOL,
                                   rtol=0, err_msg=name)


def test_resume_from_jax_state(jax_run):
    """Two JAX steps, then params and AdamW state (count, mu, nu) carried
    into the port: the port's third step is JAX's third step."""
    _, tcfg = _configs()
    params, opt_state = jax_run["after2"]
    opt = adamw(LR)
    state = init_train_state(
        lambda dev: params_from_jax_numpy(params, tcfg, dev), opt,
        device="cpu")
    state.opt_state = adamw_state_from_jax_numpy(opt_state, tcfg, "cpu")
    assert state.opt_state.count == 2
    step = make_train_step(partial(tl.loss_fn, config=tcfg), opt)
    state, m = step(state, {"tokens": torch.from_numpy(jax_run["batches"][2])})
    jloss, jnorm = jax_run["metrics"][2]
    np.testing.assert_allclose(float(m["loss"]), jloss, rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(m["grad_norm"]), jnorm, rtol=LOSS_RTOL)
    got, want = _flat(state.params), _flat(jax_run["final"])
    for name in want:
        np.testing.assert_allclose(got[name], want[name], atol=PARAM_ATOL,
                                   rtol=0, err_msg=name)


def test_bf16_step_matches_jax():
    jcfg, tcfg = _configs(np.dtype(jnp.bfloat16), loss_chunk_size=32)
    mesh = build_mesh(MeshConfig(dp=1), devices=jax.devices()[:1])
    rules = LogicalAxisRules()
    opt = optax.adamw(LR)
    jstate, shardings = jax_init_train_state(
        partial(jl.init, jcfg), opt, jl.param_logical_axes(jcfg), mesh,
        jax.random.PRNGKey(0), rules)
    init = jax.device_get(jstate.params)
    jstep = jax_make_train_step(
        partial(jl.loss_fn, config=jcfg, mesh=mesh, rules=rules), opt,
        shardings)
    tokens = np.random.default_rng(4).integers(0, VOCAB, (2, 65))
    _, jm = jstep(jstate, {"tokens": jnp.asarray(tokens)})
    topt = adamw(LR, weight_decay=1e-4)
    state = init_train_state(
        lambda dev: params_from_jax_numpy(init, tcfg, dev), topt,
        device="cpu")
    assert state.params["layers"]["wq"].dtype == torch.bfloat16
    step = make_train_step(partial(tl.loss_fn, config=tcfg), topt)
    state, m = step(state, {"tokens": torch.from_numpy(tokens)})
    assert state.opt_state.mu["lm_head"].dtype == torch.bfloat16
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=BF16_LOSS_RTOL)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                               rtol=BF16_NORM_RTOL)


def test_init_train_state_checks_the_device():
    _, tcfg = _configs()
    with pytest.raises(ValueError, match="meta"):
        init_train_state(
            lambda dev: tl.init(tcfg, torch.Generator().manual_seed(0),
                                device="cpu") | {"lm_head": torch.zeros(
                                    1, device="meta")},
            adamw(LR), device="cpu")
