"""ray_tpu_torch flash-attention gradients against the JAX package's Pallas
backward, on the CPU.

The port's gradients on CPU tensors (autograd through `_FlashAttention`
into `_flash_bwd_reference_torch`, the plain version of the dQ and dK/dV
kernels) are held against `jax.grad` through `ray_tpu.ops.flash_attention`
run as `tests/test_ops.py` runs it: the Pallas kernels in interpret mode.
Inputs come from numpy with a seed. The CUDA kernels are held against the
same plain version on the card (`tests/test_torch_cuda.py`,
`chip_smoke.py`).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu_torch.ops import _build
from ray_tpu_torch.ops import flash_attention as tfa

jfa = importlib.import_module("ray_tpu.ops.flash_attention")

# fp32 on both sides, blocked against one pass: the bound tests/test_ops.py
# holds the Pallas backward to against the JAX oracle (measured <= 1.2e-5).
ATOL = 5e-5


def _qkv(b=1, s=128, h=2, d=64, kv_heads=None, s_k=None, seed=0):
    rng = np.random.default_rng(seed)
    kvh = kv_heads or h
    s_k = s_k or s
    return (rng.standard_normal((b, s, h, d)).astype(np.float32),
            rng.standard_normal((b, s_k, kvh, d)).astype(np.float32),
            rng.standard_normal((b, s_k, kvh, d)).astype(np.float32))


def _jax_grads(q, k, v, causal, block, dtype=jnp.float32):
    def loss(q, k, v):
        o = jfa.flash_attention(q, k, v, causal=causal, interpret=True,
                                block_q=block, block_k=block)
        return jnp.sum(o.astype(jnp.float32) ** 2)

    grads = jax.grad(loss, argnums=(0, 1, 2))(
        *(jnp.asarray(x, dtype=dtype) for x in (q, k, v)))
    return [np.asarray(g.astype(jnp.float32)) for g in grads]


def _port_grads(q, k, v, causal, dtype=torch.float32):
    leaves = [torch.from_numpy(x).to(dtype).requires_grad_(True)
              for x in (q, k, v)]
    o = tfa.flash_attention(*leaves, causal=causal)
    (o.float() ** 2).sum().backward()
    return [t.grad for t in leaves]


# Every grad case of tests/test_ops.py, plus s_q > s_k.
@pytest.mark.parametrize("case,causal,block", [
    (dict(), True, 64),                                # test_flash_attention_grads
    (dict(h=4, kv_heads=2), True, 64),                 # GQA
    (dict(s=192), True, 128),                          # partial blocks
    (dict(s=192), False, 128),
    (dict(s=64, s_k=128, seed=3), True, 64),           # cross-length s_q < s_k
    (dict(s=128, s_k=64, h=4, kv_heads=2, seed=7), True, 64),  # s_q > s_k
], ids=["causal", "gqa", "partial-causal", "partial", "s_q<s_k", "s_q>s_k"])
def test_grads_match_pallas(case, causal, block):
    q, k, v = _qkv(**case)
    want = _jax_grads(q, k, v, causal, block)
    got = _port_grads(q, k, v, causal)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a.numpy(), b, atol=ATOL, err_msg=name)
    if q.shape[1] > k.shape[1]:  # rows that see no key have dq = 0
        unseen = q.shape[1] - k.shape[1]
        assert (got[0][:, :unseen] == 0).all()
        assert (want[0][:, :unseen] == 0).all()


def test_bf16_grads_match_pallas():
    """bf16 in, bf16 grads out. Both compute in fp32 from the same bf16
    inputs and round each gradient to bf16, but the JAX package rounds dk
    and dv per repeated head and then sums the GQA group in bf16 (the
    transpose of jnp.repeat), and dO = 2o is bf16 on both sides after
    forwards that may differ by an ulp: up to ~2 bf16 ulps (2^-7 relative
    each), so rtol=2e-2, with atol=2e-2 for gradients near 0 (they reach
    ~30 here; measured max error 0.0625 at |dk| ~ 14)."""
    import ml_dtypes

    q, k, v = (x.astype(ml_dtypes.bfloat16).astype(np.float32)
               for x in _qkv(s=192, h=4, kv_heads=2, seed=11))
    want = _jax_grads(q, k, v, True, 64, dtype=jnp.bfloat16)
    got = _port_grads(q, k, v, True, dtype=torch.bfloat16)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == torch.bfloat16, name
        np.testing.assert_allclose(a.float().numpy(), b, atol=2e-2,
                                   rtol=2e-2, err_msg=name)


@pytest.mark.parametrize("case,causal", [
    (dict(), True), (dict(), False), (dict(h=4, kv_heads=1, s=100), True),
    (dict(s=30, s_k=90, d=32), True), (dict(s=90, s_k=30, d=32), True),
    (dict(s=90, s_k=30, d=32), False)])
def test_plain_backward_is_the_gradient_of_the_plain_forward(case, causal):
    """The plain backward writes out the kernels' formulas; autograd
    through the plain forward (including its masks and its zeros on rows
    that see no key) gives the same gradients. fp32, summation order only."""
    q, k, v = (torch.from_numpy(x).requires_grad_(True)
               for x in _qkv(seed=13, **case))
    scale = q.shape[-1] ** -0.5
    o, lse = tfa._reference_attention_torch(q, k, v, causal, scale)
    do = torch.from_numpy(np.random.default_rng(14).standard_normal(
        o.shape).astype(np.float32))
    want = torch.autograd.grad(o, (q, k, v), do)
    got = tfa._flash_bwd_reference_torch(q.detach(), k.detach(), v.detach(),
                                         o.detach(), lse.detach(), do,
                                         causal, scale)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        torch.testing.assert_close(a, b, atol=2e-5, rtol=1e-5,
                                   msg=lambda m: f"{name}: {m}")


def test_expanded_grad_output_reaches_the_backward_dense(monkeypatch):
    """o.sum() hands the backward an expanded dO with zero strides; the
    Function makes it dense, as the kernels need."""
    seen = []
    bwd = tfa._flash_bwd

    def spy(q, k, v, o, lse, do, causal, scale):
        seen.append(do.is_contiguous())
        return bwd(q, k, v, o, lse, do, causal, scale)

    monkeypatch.setattr(tfa, "_flash_bwd", spy)
    q, k, v = (torch.from_numpy(x).requires_grad_(True) for x in _qkv())
    tfa.flash_attention(q, k, v).sum().backward()
    assert seen == [True]
    assert all(bool(torch.isfinite(t.grad).all()) for t in (q, k, v))


def test_cpu_backward_launches_no_kernel_and_wrappers_refuse_cpu():
    before = (tfa.flash_bwd_dq_cuda.launches, tfa.flash_bwd_dkv_cuda.launches)
    q, k, v = _port_grads(*_qkv(s=16), causal=True)
    assert (tfa.flash_bwd_dq_cuda.launches,
            tfa.flash_bwd_dkv_cuda.launches) == before
    x = torch.zeros((1, 8, 2, 64))
    lse = torch.zeros((1, 2, 8))
    for wrapper in (tfa.flash_bwd_dq_cuda, tfa.flash_bwd_dkv_cuda):
        with pytest.raises(ValueError, match="CUDA"):
            wrapper(x, x, x, x, lse, lse, True, 0.125)
    mq = x.to("meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        tfa._flash_bwd(mq, mq, mq, mq, lse.to("meta"), mq, True, 0.125)


def test_build_takes_the_backward_source_and_the_shared_header(
        tmp_path, monkeypatch):
    cmd = _build.nvcc_command("nvcc", "flash_bwd", tmp_path / "x.so")
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert cmd[-1].endswith("csrc/flash_bwd.cu")
    src = tmp_path / "csrc"
    src.mkdir()
    for name in ("flash_fwd.cu", "flash_bwd.cu", "flash_common.cuh"):
        (src / name).write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC", src)
    first = _build.library_path("flash_bwd")
    (src / "flash_common.cuh").write_text("// two\n")
    assert _build.library_path("flash_bwd") != first
