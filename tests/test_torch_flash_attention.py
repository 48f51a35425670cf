"""ray_tpu_torch flash attention against the JAX package's Pallas kernel.

The port's plain path (what a CPU tensor takes) is held against
`ray_tpu.ops.flash_attention` run as `tests/test_ops.py` runs it on the CPU:
the Pallas kernel in interpret mode. Inputs come from numpy with a seed and
go to both. The CUDA kernel itself is held against the same plain path on
the card (`tests/test_torch_cuda.py`, `chip_smoke.py`).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu_torch.ops import _build
from ray_tpu_torch.ops import flash_attention as tfa

jfa = importlib.import_module("ray_tpu.ops.flash_attention")

# Both sides compute in fp32; they differ only in summation order (blocked
# online softmax against one pass), the tolerance tests/test_ops.py allows
# between the Pallas kernel and the JAX oracle.
ATOL = 2e-5


def _qkv(b=1, s=128, h=2, d=64, kv_heads=None, s_k=None, seed=0,
         dtype=np.float32):
    rng = np.random.default_rng(seed)
    kvh = kv_heads or h
    s_k = s_k or s
    q = rng.standard_normal((b, s, h, d)).astype(dtype)
    k = rng.standard_normal((b, s_k, kvh, d)).astype(dtype)
    v = rng.standard_normal((b, s_k, kvh, d)).astype(dtype)
    return q, k, v


def _t(*xs):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]


def _pallas_fwd(q, k, v, causal, block=64):
    """The interpreted TPU kernel on [B,S,H,D] numpy inputs, GQA repeated as
    the JAX wrapper does -> (o [B,S,H,D], lse [B,H,S_q])."""
    rep = q.shape[2] // k.shape[2]
    k, v = np.repeat(k, rep, axis=2), np.repeat(v, rep, axis=2)

    def bhsd(x):
        return jnp.asarray(x).transpose(0, 2, 1, 3)

    o, lse = jfa._flash_fwd_pallas(bhsd(q), bhsd(k), bhsd(v), causal,
                                   q.shape[-1] ** -0.5, block, block, True)
    return np.asarray(o).transpose(0, 2, 1, 3), np.asarray(lse)[..., 0]


@pytest.mark.parametrize("causal", [True, False])
def test_forward_matches_pallas(causal):
    q, k, v = _qkv()
    ref = jfa.flash_attention(*map(jnp.asarray, (q, k, v)), causal=causal,
                              interpret=True, block_q=64, block_k=64)
    out = tfa.flash_attention(*_t(q, k, v), causal=causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


def test_gqa_matches_pallas():
    q, k, v = _qkv(h=4, kv_heads=2)
    ref = jfa.flash_attention(*map(jnp.asarray, (q, k, v)), causal=True,
                              interpret=True, block_q=64, block_k=64)
    out = tfa.flash_attention(*_t(q, k, v), causal=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


def test_rejects_bad_heads():
    q, k, v = _qkv(h=4, kv_heads=3)
    with pytest.raises(ValueError):
        jfa.flash_attention(*map(jnp.asarray, (q, k, v)), use_pallas=False)
    with pytest.raises(ValueError, match="not a multiple"):
        tfa.flash_attention(*_t(q, k, v))


@pytest.mark.parametrize("causal", [True, False])
def test_partial_blocks_match_pallas(causal):
    """seq not a multiple of the TPU block: its padding keys are masked."""
    q, k, v = _qkv(s=192)
    ref = jfa.flash_attention(*map(jnp.asarray, (q, k, v)), causal=causal,
                              interpret=True, block_q=128, block_k=128)
    out = tfa.flash_attention(*_t(q, k, v), causal=causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


def test_cross_length_causal_matches_pallas():
    """s_q < s_k: query i sees keys up to i + (s_k - s_q)."""
    q, k, v = _qkv(s=64, s_k=128, seed=3)
    ref = jfa.flash_attention(*map(jnp.asarray, (q, k, v)), causal=True,
                              interpret=True, block_q=64, block_k=64)
    out = tfa.flash_attention(*_t(q, k, v), causal=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("case", [
    dict(causal=True), dict(causal=False), dict(causal=True, h=4, kv_heads=2),
    dict(causal=True, s=192), dict(causal=True, s=64, s_k=128),
    dict(causal=False, s=100, s_k=37, d=32),
])
def test_lse_matches_pallas(case):
    """The private _flash_fwd returns the kernel's lse, which the backward
    and the ring path need."""
    case = dict(case)
    causal = case.pop("causal")
    q, k, v = _qkv(seed=5, **case)
    o_ref, lse_ref = _pallas_fwd(q, k, v, causal, block=32)
    o, lse = tfa._flash_fwd(*_t(q, k, v), causal, q.shape[-1] ** -0.5)
    assert lse.shape == lse_ref.shape and lse.dtype == torch.float32
    np.testing.assert_allclose(o.numpy(), o_ref, atol=ATOL)
    np.testing.assert_allclose(lse.numpy(), lse_ref, atol=ATOL)


def test_rows_that_see_no_key_follow_the_kernel():
    """Causal with s_q > s_k: the first s_q - s_k query rows see no key.
    The TPU kernel writes 0 there (and lse ~ -1e30); the JAX package's
    `_reference_attention` writes the mean of V. The port follows the
    kernel, whose lse the backward relies on."""
    q, k, v = _qkv(s=128, s_k=64, seed=7)
    o_ref, lse_ref = _pallas_fwd(q, k, v, True)
    o, lse = tfa._flash_fwd(*_t(q, k, v), True, q.shape[-1] ** -0.5)
    np.testing.assert_allclose(o.numpy(), o_ref, atol=ATOL)
    unseen = slice(0, 64)
    assert (o[:, unseen] == 0).all()
    assert (lse[:, :, unseen] < -1e29).all()
    assert (lse_ref[:, :, unseen] < -1e29).all()
    np.testing.assert_allclose(lse[:, :, 64:].numpy(), lse_ref[:, :, 64:],
                               atol=ATOL)
    oracle = jfa._reference_attention(
        *(jnp.asarray(x).transpose(0, 2, 1, 3) for x in (q, k, v)),
        True, q.shape[-1] ** -0.5)
    oracle = np.asarray(oracle).transpose(0, 2, 1, 3)
    assert not np.allclose(oracle[:, unseen], 0.0, atol=1e-3)


def test_bf16_matches_pallas():
    """bf16 in and out: both compute in fp32 and round O once to bf16, so
    they may differ by one bf16 ulp of |O| (< 2^-7 for |O| < 2)."""
    import ml_dtypes

    q, k, v = _qkv(s=192, h=4, kv_heads=2, seed=11, dtype=ml_dtypes.bfloat16)
    ref = jfa.flash_attention(*map(jnp.asarray, (q, k, v)), causal=True,
                              interpret=True, block_q=64, block_k=64)
    tq, tk, tv = (torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
                  for x in (q, k, v))
    out = tfa.flash_attention(tq, tk, tv, causal=True)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref).astype(np.float32),
                               atol=1e-2, rtol=1e-2)


def test_default_scale_is_rsqrt_head_dim():
    q, k, v = _t(*_qkv(d=32, seed=2))
    np.testing.assert_array_equal(
        tfa.flash_attention(q, k, v).numpy(),
        tfa.flash_attention(q, k, v, scale=32 ** -0.5).numpy())


def test_cpu_path_launches_no_kernel():
    before = tfa.flash_fwd_cuda.launches
    tfa.flash_attention(*_t(*_qkv()))
    assert tfa.flash_fwd_cuda.launches == before


def test_no_fallback_off_the_cpu():
    """The kernel wrapper refuses CPU tensors, and a device that is neither
    CPU nor CUDA takes no path at all."""
    q, k, v = _t(*_qkv())
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_fwd_cuda(q, k, v, True, 0.125)
    mq, mk, mv = (x.to("meta") for x in (q, k, v))
    with pytest.raises(ValueError, match="cuda or cpu"):
        tfa.flash_attention(mq, mk, mv)


def test_build_names_sm90a_and_fails_without_nvcc(tmp_path, monkeypatch):
    cmd = _build.nvcc_command("nvcc", "flash_fwd", tmp_path / "x.so")
    assert "arch=compute_90a,code=sm_90a" in cmd and "-shared" in cmd
    assert cmd[-1].endswith("csrc/flash_fwd.cu")

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "find_nvcc", no_nvcc)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build("flash_fwd")
    assert not (tmp_path / "build").exists()


def test_build_key_follows_the_sources(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "flash_fwd.cu").write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC", src)
    first = _build.library_path("flash_fwd")
    (src / "flash_fwd.cu").write_text("// two\n")
    assert _build.library_path("flash_fwd") != first
