"""The flash kernels as `torch.library` custom operators, and the
`dots_attn` remat policy they make possible, on the CPU.

`ray_tpu_torch::flash_fwd` / `flash_bwd` are checked by
`torch.library.opcheck` (schema, fake implementation, autograd
registration) on CPU tensors, where their bodies take the plain versions.
`remat_policy="dots_attn"` is held against the JAX package's `loss_fn`
under the same policy on the same numpy inputs, and the forward launches a
step are counted per policy. The JAX program's own count under each
policy is pinned from its jaxpr, with the Pallas kernels in interpret
mode, as `tests/test_ops.py` runs them.
"""

import dataclasses
import importlib
from functools import partial

import jax
import jax.numpy as jnp
from jax.extend import core as jcore
import numpy as np
import pytest
import torch

from ray_tpu.models import llama as jl
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.models.convert import params_from_jax_numpy
from ray_tpu_torch.ops import flash_attention as tfa
from ray_tpu_torch.train.optim import tree_leaves, tree_map

jfa = importlib.import_module("ray_tpu.ops.flash_attention")
VOCAB = 128
# As tests/test_torch_train.py: fp32 on both sides, the same arithmetic in
# another order. Gradients: |a - b| <= GRAD_ATOL * max|b| + GRAD_RTOL |b|.
LOSS_RTOL = 1e-5
GRAD_ATOL, GRAD_RTOL = 2e-5, 2e-4


def _attention_inputs(b, s_q, s_k, h, h_kv, d, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            for shape in ((b, s_q, h, d), (b, s_k, h_kv, d),
                          (b, s_k, h_kv, d), (b, s_q, h, d))]


# (b, s_q, s_k, h, h_kv, d, causal): GQA, cross lengths, rows that see no
# key (s_q > s_k under causal).
OP_CASES = [(1, 16, 16, 4, 2, 32, True), (2, 9, 20, 2, 2, 64, False),
            (1, 24, 8, 4, 1, 32, True)]


@pytest.mark.parametrize("case", OP_CASES)
def test_opcheck_flash_fwd(case):
    *shape, causal = case
    q, k, v, _ = _attention_inputs(*shape, seed=0)
    scale = shape[-1] ** -0.5
    # Inputs that require grad: the autograd registration and the traced
    # backward are checked with the schema and the fake implementation.
    grad_args = tuple(t.requires_grad_(True) for t in (q, k, v))
    torch.library.opcheck(tfa.flash_fwd, (*grad_args, causal, scale))


@pytest.mark.parametrize("case", OP_CASES)
def test_opcheck_flash_bwd(case):
    *shape, causal = case
    q, k, v, do = _attention_inputs(*shape, seed=1)
    scale = shape[-1] ** -0.5
    o, lse = tfa._flash_fwd(q, k, v, causal, scale)
    torch.library.opcheck(tfa.flash_bwd, (q, k, v, o.contiguous(), lse, do,
                                          causal, scale))


def test_ops_write_what_their_fake_implementations_say():
    """Shapes, dtypes and strides of the real outputs are the fake
    implementations': contiguous [B,S,H,D] like q, lse fp32 [B,H,S_q], and
    dq/dk/dv like q/k/v."""
    q, k, v, do = _attention_inputs(1, 12, 20, 4, 2, 32, seed=2)
    o, lse = tfa.flash_fwd(q, k, v, True, 0.2)
    grads = tfa.flash_bwd(q, k, v, o, lse, do, True, 0.2)
    with torch._subclasses.FakeTensorMode() as mode:
        fake = [mode.from_tensor(t) for t in (q, k, v, o, lse, do)]
        f_o, f_lse = tfa.flash_fwd(*fake[:3], True, 0.2)
        f_grads = tfa.flash_bwd(*fake, True, 0.2)
    for real, want in zip((o, lse, *grads), (f_o, f_lse, *f_grads)):
        assert (real.shape, real.dtype, real.stride()) == \
            (want.shape, want.dtype, want.stride())
    assert lse.shape == (1, 4, 12) and lse.dtype == torch.float32


def test_flash_attention_goes_through_the_ops(monkeypatch):
    """flash_attention's forward and backward reach the kernels only through
    the two custom operators."""
    seen = []
    for name in ("flash_fwd", "flash_bwd"):
        op = getattr(tfa, name)
        monkeypatch.setattr(tfa, name, lambda *a, _op=op, _n=name:
                            (seen.append(_n), _op(*a))[1])
    q, k, v, do = _attention_inputs(1, 8, 8, 2, 1, 32, seed=3)
    leaves = [t.requires_grad_(True) for t in (q, k, v)]
    tfa.flash_attention(*leaves).backward(do)
    assert seen == ["flash_fwd", "flash_bwd"]


def _configs(**kw):
    jcfg = dataclasses.replace(jl.LlamaConfig.tiny(vocab_size=VOCAB),
                               dtype=jnp.float32, **kw)
    tcfg = dataclasses.replace(tl.LlamaConfig.tiny(vocab_size=VOCAB),
                               dtype=torch.float32, **kw)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def tiny_params():
    jcfg, _ = _configs()
    return jax.device_get(jl.init(jcfg, jax.random.PRNGKey(0)))


def _batch(seed=1, b=2, s=100):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, VOCAB, (b, s + 1))
    return {"inputs": tokens[:, :-1], "targets": tokens[:, 1:],
            "mask": (rng.random((b, s)) > 0.3).astype(np.float32)}


def _port_loss_and_grads(params, batch, cfg, loss_fn=None):
    """loss_fn(params, batch) (default: the eager `loss_fn` under cfg) and
    its gradients, a tree like params."""
    loss_fn = loss_fn or partial(tl.loss_fn, config=cfg)
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss = loss_fn(params, {k: torch.from_numpy(np.asarray(v))
                            for k, v in batch.items()})
    grads = iter(torch.autograd.grad(loss, leaves))
    return loss.detach(), tree_map(lambda _: next(grads), params)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}" if prefix else k))
        return out
    if isinstance(tree, torch.Tensor):
        return {prefix: tree.detach().float().numpy()}
    return {prefix: np.asarray(tree, dtype=np.float32)}


@pytest.mark.parametrize("chunk", [0, 64])
def test_dots_attn_matches_jax(tiny_params, chunk):
    jcfg, tcfg = _configs(remat_policy="dots_attn", loss_chunk_size=chunk)
    batch = _batch()
    jloss, jgrads = jax.jit(jax.value_and_grad(
        partial(jl.loss_fn, config=jcfg)))(
        tiny_params, {k: jnp.asarray(v) for k, v in batch.items()})
    params = params_from_jax_numpy(tiny_params, tcfg, device="cpu")
    loss, grads = _port_loss_and_grads(params, batch, tcfg)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL)
    got, want = _flat(grads), _flat(jax.device_get(jgrads))
    assert got.keys() == want.keys()
    for name in want:
        scale = float(np.abs(want[name]).max())
        np.testing.assert_allclose(got[name], want[name], rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL * scale, err_msg=name)


def count_kernel_calls(monkeypatch):
    """Route `_flash_fwd` / `_flash_bwd` through counters; -> the counts."""
    calls = {"fwd": 0, "bwd": 0}
    for key, name in (("fwd", "_flash_fwd"), ("bwd", "_flash_bwd")):
        fn = getattr(tfa, name)

        def wrapped(*a, _fn=fn, _key=key):
            calls[_key] += 1
            return _fn(*a)

        monkeypatch.setattr(tfa, name, wrapped)
    return calls


# Forward launches a step by policy, n layers: without remat n; "full" and
# "dots" rerun the forward in the backward, 2n; "dots_attn" saves its O and
# lse, n. The backward runs once a layer under every policy.
FWD_PER_LAYER = {"off": 1, "full": 2, "dots": 2, "dots_attn": 1}


def policy_config(policy, **kw):
    if policy == "off":
        return _configs(remat=False, **kw)[1]
    return _configs(remat_policy=policy, **kw)[1]


@pytest.mark.parametrize("policy", list(FWD_PER_LAYER))
def test_forward_launches_by_policy(tiny_params, policy, monkeypatch):
    calls = count_kernel_calls(monkeypatch)
    cfg = policy_config(policy, loss_chunk_size=64)
    params = params_from_jax_numpy(tiny_params, cfg, device="cpu")
    _port_loss_and_grads(params, _batch(seed=2), cfg)
    n = cfg.n_layers
    assert calls == {"fwd": FWD_PER_LAYER[policy] * n, "bwd": n}


def _jax_pallas_calls(jaxpr) -> int:
    """pallas_call equations in the bodies of the layer scans (the forward
    scan and the backward's): the calls a layer makes in a step."""
    scans = [eqn for eqn in jaxpr.eqns if eqn.primitive.name == "scan"]
    assert scans, "no layer scan in the jaxpr"
    return sum(_count(eqn.params["jaxpr"].jaxpr, "pallas_call")
               for eqn in scans)


def _count(jaxpr, name) -> int:
    n = 0
    for eqn in jaxpr.eqns:
        n += eqn.primitive.name == name
        for value in eqn.params.values():
            for sub in (value if isinstance(value, (list, tuple))
                        else (value,)):
                if isinstance(sub, jcore.ClosedJaxpr):
                    sub = sub.jaxpr
                if isinstance(sub, jcore.Jaxpr):
                    n += _count(sub, name)
    return n


@pytest.mark.parametrize("policy,per_layer", [
    ("off", 3), ("full", 4), ("dots", 4), ("dots_attn", 4)])
def test_jax_reference_reruns_the_forward_kernel_under_dots_attn(
        tiny_params, policy, per_layer, monkeypatch):
    """The reference, for the record: its gradient program holds the
    forward kernel, dQ and dK/dV (3 pallas_calls a layer) without remat
    and 4 under every policy, "dots_attn" included: the policy saves the
    kernel's O ("attn_out") but not the custom_vjp's lse residual, so the
    backward reruns the forward kernel. The port saves both (above)."""
    monkeypatch.setattr(jl, "flash_attention",
                        partial(jfa.flash_attention, interpret=True))
    kw = ({"remat": False} if policy == "off"
          else {"remat": True, "remat_policy": policy})
    jcfg = _configs(**kw)[0]
    batch = {k: jnp.asarray(v) for k, v in _batch(s=64).items()}
    jaxpr = jax.make_jaxpr(jax.grad(partial(jl.loss_fn, config=jcfg)))(
        tiny_params, batch)
    assert _jax_pallas_calls(jaxpr.jaxpr) == per_layer


@pytest.fixture
def fresh_dynamo():
    """Compiled code of one test does not count against the next's
    recompile limit."""
    torch._dynamo.reset()
    yield
    torch._dynamo.reset()


@pytest.mark.parametrize("policy", ["full", "dots", "dots_attn"])
def test_compiled_loss_matches_eager_and_keeps_the_launches(
        tiny_params, policy, monkeypatch, fresh_dynamo):
    """torch.compile(loss_fn, fullgraph=True) traces the model, the flash
    operators and the checkpointed layers without a graph break (aot_eager:
    AOTAutograd's forward and backward graphs, run eagerly), gives eager's
    loss and gradients, and launches what eager launches under the policy:
    the partitioner follows the policy's saves and recomputes."""
    cfg = policy_config(policy, loss_chunk_size=64)
    batch = _batch(seed=2)
    params = params_from_jax_numpy(tiny_params, cfg, device="cpu")
    loss0, grads0 = _port_loss_and_grads(params, batch, cfg)
    compiled = torch.compile(partial(tl.loss_fn, config=cfg),
                             backend="aot_eager", fullgraph=True,
                             dynamic=False)
    _port_loss_and_grads(params, batch, cfg, compiled)  # compiles
    calls = count_kernel_calls(monkeypatch)
    loss1, grads1 = _port_loss_and_grads(params, batch, cfg, compiled)
    n = cfg.n_layers
    assert calls == {"fwd": FWD_PER_LAYER[policy] * n, "bwd": n}
    np.testing.assert_allclose(float(loss1), float(loss0), rtol=1e-6)
    got, want = _flat(grads1), _flat(grads0)
    for name in want:
        scale = float(np.abs(want[name]).max())
        np.testing.assert_allclose(got[name], want[name], rtol=1e-5,
                                   atol=1e-6 * scale, err_msg=name)
