"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: each test skips without an NVIDIA card. This file imports no
JAX, so it runs where the card is, without tests/conftest.py:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import pytest
import torch

from ray_tpu_torch.ops import flash_attention as fa

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# (b, s_q, s_k, h, h_kv, d, causal)
SHAPES = [
    (1, 64, 64, 2, 2, 32, True),
    (2, 130, 130, 4, 2, 64, True),
    (1, 513, 513, 8, 2, 128, False),
    (1, 17, 300, 4, 4, 128, True),     # s_q < s_k
    (1, 200, 50, 4, 1, 64, True),      # s_q > s_k: 150 rows see no key
    (3, 1, 129, 8, 8, 32, True),       # one query row, decode-shaped
    # What the sm90 tilings (128 query rows over two warpgroups with 128-
    # or, in dQ, 64-key tiles; dK/dV's 128 keys over 64-row Q tiles;
    # 64-column TMA boxes) make risky:
    (1, 1000, 1000, 8, 2, 128, True),  # S not a multiple of 128
    (1, 2047, 2047, 4, 1, 128, True),  # H_kv = 1, S = 2047
    (2, 192, 192, 4, 2, 64, True),     # 1.5 Q tiles: a warpgroup past S
    (1, 100, 700, 8, 2, 128, True),    # s_q < s_k under causal
    # s_q > s_k: 570 rows see no key, and the dQ blocks of rows 128 .. 511
    # see none at all (they load nothing and store zeros)
    (1, 700, 130, 8, 2, 128, True),
    (4, 2048, 2048, 32, 8, 128, True),  # the training path's attention
    (2, 1, 129, 8, 8, 128, True),      # one query row in a dQ block of 128
]

# |kernel - plain| <= atol + rtol * |plain|: fp32 differs in summation order
# only; bf16 rounds P before P.V and O at the end (one bf16 ulp).
TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (1e-2, 1e-2)}

# Backward, |kernel - plain| <= atol * max|plain| + rtol * |plain| for each
# of dq, dk, dv: fp32 differs in summation order and __expf only; bf16
# rounds P and dS to bf16 before their products (2^-9 relative each, summed
# over up to S terms of either sign) and the result once (one bf16 ulp), so
# the absolute part scales with the gradient's size.
BWD_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (1e-2, 1e-2)}


def _inputs(cuda, shape, dtype, seed):
    b, s_q, s_k, h, h_kv, d, _ = shape
    g = torch.Generator(device=cuda).manual_seed(seed)
    q = torch.randn((b, s_q, h, d), generator=g, device=cuda).to(dtype)
    k = torch.randn((b, s_k, h_kv, d), generator=g, device=cuda).to(dtype)
    v = torch.randn((b, s_k, h_kv, d), generator=g, device=cuda).to(dtype)
    do = torch.randn((b, s_q, h, d), generator=g, device=cuda).to(dtype)
    return q, k, v, do


def _assert_grads_close(got, want, dtype):
    atol, rtol = BWD_TOL[dtype]
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        scale = float(b.float().abs().max())
        torch.testing.assert_close(a.float(), b.float(), atol=atol * scale,
                                   rtol=rtol, msg=lambda m: f"{name}: {m}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES)
def test_flash_fwd_matches_plain(cuda, shape, dtype):
    b, s_q, s_k, h, h_kv, d, causal = shape
    g = torch.Generator(device=cuda).manual_seed(s_q * 131 + s_k)
    q = torch.randn((b, s_q, h, d), generator=g, device=cuda).to(dtype)
    k = torch.randn((b, s_k, h_kv, d), generator=g, device=cuda).to(dtype)
    v = torch.randn((b, s_k, h_kv, d), generator=g, device=cuda).to(dtype)
    before = fa.flash_fwd_cuda.launches
    o, lse = fa._flash_fwd(q, k, v, causal, d ** -0.5)
    torch.cuda.synchronize()
    assert fa.flash_fwd_cuda.launches == before + 1
    o_ref, lse_ref = fa._reference_attention_torch(q, k, v, causal, d ** -0.5)
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(o.float(), o_ref.float(), atol=atol, rtol=rtol)
    seen = lse_ref > -1e29
    torch.testing.assert_close(lse[seen], lse_ref[seen], atol=1e-3, rtol=1e-5)
    assert (lse[~seen] < -1e29).all()
    assert (o.transpose(1, 2)[~seen] == 0).all()


def test_bf16_main_path_takes_the_wgmma_kernels(cuda):
    """The built libraries launch the design `kernel_variant` names for every
    (kernel, dtype, head size), and bf16 at D = 128 (the main path) runs the
    sm90 forward, dQ and dK/dV kernels, each launch counted."""
    for kernel in fa.KERNELS:
        for dtype in fa.KERNEL_DTYPES:
            for d in fa.KERNEL_HEAD_DIMS:
                assert (fa.built_variant(kernel, dtype, d)
                        == fa.kernel_variant(kernel, dtype, d)), (kernel,
                                                                  dtype, d)
    for kernel in fa.KERNELS:
        assert fa.kernel_variant(kernel, torch.bfloat16, 128) == "wgmma"
    shape = (1, 256, 256, 4, 2, 128, True)
    q, k, v, do = _inputs(cuda, shape, torch.bfloat16, 11)
    counters = (fa.flash_fwd_cuda, fa.flash_bwd_dq_cuda, fa.flash_bwd_dkv_cuda)
    before = [fn.launches for fn in counters]
    o, lse = fa.flash_fwd_cuda(q, k, v, True, 128 ** -0.5)
    delta = (do.float() * o.float()).sum(dim=-1).transpose(1, 2).contiguous()
    fa.flash_bwd_dq_cuda(q, k, v, do, lse, delta, True, 128 ** -0.5)
    fa.flash_bwd_dkv_cuda(q, k, v, do, lse, delta, True, 128 ** -0.5)
    torch.cuda.synchronize()
    assert [fn.launches for fn in counters] == [n + 1 for n in before]


def test_flash_fwd_refuses_what_it_was_not_built_for(cuda):
    q = torch.zeros((1, 8, 2, 48), device=cuda)
    with pytest.raises(ValueError, match="head size"):
        fa.flash_fwd_cuda(q, q, q, True, 1.0)
    q = torch.zeros((1, 8, 2, 64), device=cuda, dtype=torch.float16)
    with pytest.raises(ValueError, match="float16"):
        fa.flash_fwd_cuda(q, q, q, True, 1.0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES)
def test_flash_bwd_matches_plain(cuda, shape, dtype):
    """dq and dk/dv kernels against the plain backward, on the kernel
    forward's own o and lse; rows that see no key get dq = 0."""
    causal, d = shape[6], shape[5]
    q, k, v, do = _inputs(cuda, shape, dtype, shape[1] * 7 + shape[2])
    o, lse = fa.flash_fwd_cuda(q, k, v, causal, d ** -0.5)
    before = (fa.flash_bwd_dq_cuda.launches, fa.flash_bwd_dkv_cuda.launches)
    got = fa._flash_bwd(q, k, v, o, lse, do, causal, d ** -0.5)
    torch.cuda.synchronize()
    assert (fa.flash_bwd_dq_cuda.launches,
            fa.flash_bwd_dkv_cuda.launches) == (before[0] + 1, before[1] + 1)
    want = fa._flash_bwd_reference_torch(q, k, v, o, lse, do, causal,
                                         d ** -0.5)
    _assert_grads_close(got, want, dtype)
    unseen = lse < -1e29  # [B, H, S_q]
    assert (got[0].transpose(1, 2)[unseen] == 0).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_bwd_reads_transposed_views(cuda, dtype):
    """q and dO as [B,H,S,D] storage read through [B,S,H,D] strides: the
    tensor maps and loads take the caller's strides."""
    shape = (2, 320, 320, 4, 2, 128, True)
    q, k, v, do = _inputs(cuda, shape, dtype, 5)
    q, do = (t.transpose(1, 2).contiguous().transpose(1, 2) for t in (q, do))
    o, lse = fa.flash_fwd_cuda(q, k, v, True, 128 ** -0.5)
    got = fa._flash_bwd(q, k, v, o, lse, do, True, 128 ** -0.5)
    want = fa._flash_bwd_reference_torch(q, k, v, o, lse, do, True,
                                         128 ** -0.5)
    _assert_grads_close(got, want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_autograd_round_trip(cuda, dtype):
    """flash_attention(...).backward(dO) on CUDA equals the plain backward
    on the same tensors; an expanded dO (from .sum()) is taken too."""
    shape = (2, 130, 130, 8, 2, 128, True)
    q, k, v, do = _inputs(cuda, shape, dtype, 3)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    o = fa.flash_attention(*leaves, causal=True)
    o.backward(do)
    scale = 128 ** -0.5
    _, lse = fa._flash_fwd(q, k, v, True, scale)
    want = fa._flash_bwd_reference_torch(q, k, v, o.detach(), lse, do, True,
                                         scale)
    _assert_grads_close([t.grad for t in leaves], want, dtype)
    for t in leaves:
        t.grad = None
    fa.flash_attention(*leaves, causal=True).sum().backward()
    assert all(bool(torch.isfinite(t.grad).all()) for t in leaves)


def test_flash_bwd_refuses_what_it_was_not_built_for(cuda):
    q = torch.zeros((1, 8, 2, 64), device=cuda)
    lse = torch.zeros((1, 2, 8), device=cuda)
    with pytest.raises(ValueError, match="not shaped like q"):
        fa.flash_bwd_dq_cuda(q, q, q, q[:, :4], lse, lse, True, 1.0)
    with pytest.raises(ValueError, match="lse"):
        fa.flash_bwd_dkv_cuda(q, q, q, q, lse.double(), lse, True, 1.0)
