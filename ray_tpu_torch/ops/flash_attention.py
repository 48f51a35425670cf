"""Flash attention forward: a hand-written CUDA kernel with its plain version.

Counterpart of `ray_tpu/ops/flash_attention.py`. The TPU kernel
`_fwd_kernel` becomes `csrc/flash_fwd.cu` (see its header for the design);
`_reference_attention_torch` is the plain PyTorch version of the same
function. The public call takes `[B, S, H, D]` as the JAX package does.

Dispatch is by the device of the tensors: CPU tensors take the plain version;
CUDA tensors launch the kernel or raise. There is no fallback from one to the
other. The backward kernels, the autograd wrapper and the sharded entry point
belong to later slices of the port.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from ray_tpu_torch.ops import _build

NEG_INF = -1e30

# What the CUDA kernel is instantiated for.
KERNEL_HEAD_DIMS = (32, 64, 128)
KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def _kv_repeat(q, k, v) -> int:
    """Validates [B,S,H,D] q against [B,S_k,H_kv,D] k/v; returns H // H_kv."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention takes [B, S, H, D] tensors")
    if k.shape != v.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} differ")
    b, _, h, d = q.shape
    if k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} differ "
                         "in batch or head size")
    h_kv = k.shape[2]
    if h_kv == 0 or h % h_kv != 0:
        raise ValueError(f"q heads {h} not a multiple of kv heads {h_kv}")
    return h // h_kv


def _reference_attention_torch(q, k, v, causal: bool, scale: float
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the kernel's function, in fp32.

    q [B,S_q,H,D], k/v [B,S_k,H_kv,D] -> (o [B,S_q,H,D] in q's dtype,
    lse [B,H,S_q] fp32). It follows the TPU kernel, not the JAX package's
    `_reference_attention`, where they part: a query row that sees no key
    (causal with s_q > s_k) gets o = 0 and lse = -1e30 + log(1e-20), as the
    kernel's clamp of l gives it, where the JAX reference would give the
    mean of V. The backward's use of lse relies on the kernel's values."""
    rep = _kv_repeat(q, k, v)
    s_q, s_k = q.shape[1], k.shape[1]
    qf = q.float().transpose(1, 2)
    kf = k.float().repeat_interleave(rep, dim=2).transpose(1, 2)
    vf = v.float().repeat_interleave(rep, dim=2).transpose(1, 2)
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale  # [B,H,S_q,S_k]
    valid = torch.ones((s_q, s_k), dtype=torch.bool, device=q.device)
    if causal:
        valid = torch.tril(valid, diagonal=s_k - s_q)
    s = s.masked_fill(~valid, NEG_INF)
    m = (s.amax(dim=-1, keepdim=True) if s_k
         else s.new_full(s.shape[:-1] + (1,), NEG_INF))
    p = torch.where(valid, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-20)
    o = torch.matmul(p, vf) / l
    lse = (m + torch.log(l)).squeeze(-1)
    return o.transpose(1, 2).to(q.dtype), lse


@functools.lru_cache(maxsize=None)
def _kernel():
    lib = _build.load("flash_fwd")
    fn = lib.flash_fwd
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                   + [ctypes.POINTER(ctypes.c_int64), ctypes.c_float,
                      ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.flash_fwd_error_string.argtypes = [ctypes.c_int]
    lib.flash_fwd_error_string.restype = ctypes.c_char_p
    return fn, lib.flash_fwd_error_string


def flash_fwd_cuda(q, k, v, causal: bool, scale: float
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch `csrc/flash_fwd.cu` on PyTorch's current stream.

    Takes what `_reference_attention_torch` takes, on CUDA, and returns the
    same (o, lse). Raises on what the kernel does not take: another device or
    dtype, a head size it was not built for, a head dimension that is not
    contiguous, or strides and addresses off 16 bytes. `launches` counts the
    launches."""
    _kv_repeat(q, k, v)
    b, s_q, h, d = q.shape
    s_k, h_kv = k.shape[1], k.shape[2]
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"{name} is on {t.device}; the kernel takes "
                             f"CUDA tensors on one device ({q.device})")
        if t.dtype != q.dtype or t.dtype not in KERNEL_DTYPES:
            raise ValueError(f"{name} is {t.dtype}; the kernel takes one of "
                             f"{KERNEL_DTYPES}, the same for q, k and v")
        vec = 16 // t.element_size()
        if (t.stride(3) != 1 or any(s % vec for s in t.stride()[:3])
                or t.data_ptr() % 16):
            raise ValueError(f"{name} needs a contiguous head dimension and "
                             "16-byte aligned strides and address")
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"head size {d} not in {KERNEL_HEAD_DIMS}")
    if max(b, h) > 65535:
        raise ValueError(f"batch {b} or heads {h} above the grid's 65535")
    o = torch.empty((b, s_q, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, s_q), dtype=torch.float32, device=q.device)
    if o.numel() == 0:
        return o, lse
    fn, error_string = _kernel()
    strides = (ctypes.c_int64 * 12)(*q.stride()[:3], *k.stride()[:3],
                                    *v.stride()[:3], *o.stride()[:3])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 lse.data_ptr(), int(q.dtype == torch.bfloat16), b, h, h_kv,
                 s_q, s_k, d, strides, float(scale), int(causal), stream)
    if err:
        raise RuntimeError("flash_fwd launch failed: "
                           f"{error_string(err).decode()} (cudaError {err})")
    flash_fwd_cuda.launches += 1
    return o, lse


flash_fwd_cuda.launches = 0


def _flash_fwd(q, k, v, causal: bool, scale: float
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (o [B,S_q,H,D], lse [B,H,S_q] fp32): the plain version for CPU
    tensors, the CUDA kernel for CUDA tensors, and an error for any other."""
    if q.device.type == "cpu":
        return _reference_attention_torch(q, k, v, causal, scale)
    if q.device.type == "cuda":
        return flash_fwd_cuda(q, k, v, causal, scale)
    raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")


def flash_attention(q, k, v, causal: bool = True,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Exact attention over [B, S, H, D] inputs (GQA: fewer KV heads OK).

    Under causal, query i sees key j iff i + (s_k - s_q) >= j. The default
    scale is d ** -0.5."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    o, _ = _flash_fwd(q, k, v, causal, scale)
    return o
