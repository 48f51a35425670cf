"""Flash attention: hand-written CUDA kernels with their plain versions.

Counterpart of `ray_tpu/ops/flash_attention.py`. Its three TPU kernels
become CUDA C++ for Hopper: `_fwd_kernel` is `csrc/flash_fwd.cu`;
`_bwd_dq_kernel` and `_bwd_dkv_kernel` are the two kernels of
`csrc/flash_bwd.cu` (see the sources' headers for the design).
`kernel_variant` names the design each (kernel, dtype, head size) takes:
bf16 at D = 64 and 128, the main path, runs all three on Hopper's wgmma
with register accumulators and a TMA-fed tile ring (`csrc/flash_sm90.cuh`);
fp32, and bf16 at D = 32, keep the first WMMA / FMA design.
`_reference_attention_torch` and `_flash_bwd_reference_torch` are the plain
PyTorch versions of the same functions. The forward and the backward are
`torch.library` custom operators, `ray_tpu_torch::flash_fwd` (-> o, lse)
and `ray_tpu_torch::flash_bwd` (-> dq, dk, dv), with fake implementations
for torch.compile and the forward's autograd formula registered as the
counterpart of the `_flash_bhsd` custom_vjp; a remat policy can name
`flash_fwd` to save its outputs. The public call takes `[B, S, H, D]` as
the JAX package does.

Dispatch is by the device of the tensors: CPU tensors take the plain
versions; CUDA tensors launch the kernels or raise. There is no fallback
from one to the other. `flash_attention_sharded` runs the same kernels on
each rank's block of DTensors on a named mesh (`torch.distributed`'s
`local_map`, the counterpart of the JAX wrapper's `shard_map`).
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

# The C entry points that launch the kernels, by the library they live in.
KERNELS = {"flash_fwd": "flash_fwd", "flash_bwd_dq": "flash_bwd",
           "flash_bwd_dkv": "flash_bwd"}
# Head sizes whose bf16 launches take the sm90 design, in every kernel.
_WGMMA_HEAD_DIMS = (64, 128)


def kernel_variant(kernel: str, dtype: torch.dtype, d: int) -> str:
    """The design that `kernel` (a key of KERNELS) launches for dtype and
    head size d: "wgmma" (Hopper: wgmma, register accumulators, TMA ring),
    "wmma" (bf16 on WMMA tiles staged in shared memory) or "fma" (fp32, no
    TF32). The C sources choose by the same table; `built_variant` asks the
    built library."""
    if kernel not in KERNELS:
        raise ValueError(f"no kernel {kernel!r}; one of {sorted(KERNELS)}")
    if dtype not in KERNEL_DTYPES or d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"no kernel for {dtype} at head size {d}")
    if dtype == torch.float32:
        return "fma"
    return "wgmma" if d in _WGMMA_HEAD_DIMS else "wmma"


def _query(kernel: str, what: str, restype, dtype: torch.dtype, d: int):
    kernel_variant(kernel, dtype, d)  # validates the arguments
    fn = getattr(_build.load(KERNELS[kernel]), f"{kernel}_{what}")
    fn.argtypes = [ctypes.c_int, ctypes.c_int]
    fn.restype = restype
    return fn(int(dtype == torch.bfloat16), d)


def built_variant(kernel: str, dtype: torch.dtype, d: int) -> str:
    """What the built library of `kernel` says it launches for (dtype, d);
    builds it if needed (so it needs nvcc)."""
    return _query(kernel, "variant", ctypes.c_char_p, dtype, d).decode()


def sm90_smem_bytes(kernel: str, dtype: torch.dtype, d: int) -> int:
    """Dynamic shared memory a block of the "wgmma" design of `kernel` takes
    at (dtype, d), from the built library; 0 for the other designs."""
    if kernel_variant(kernel, dtype, d) != "wgmma":
        return 0
    return _query(kernel, "smem_bytes", ctypes.c_int, dtype, d)


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


def _check_operands(q, k, v, **more) -> None:
    """Raise on what the kernels do not take: q, k, v (and `more`, tensors
    shaped like q) must be CUDA tensors on one device, of one dtype in
    KERNEL_DTYPES, with a head size in KERNEL_HEAD_DIMS, a contiguous head
    dimension and 16-byte aligned strides and address."""
    _kv_repeat(q, k, v)
    for name, t in more.items():
        if t.shape != q.shape:
            raise ValueError(f"{name} {tuple(t.shape)} is not shaped like q "
                             f"{tuple(q.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v), *more.items()):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"{name} is on {t.device}; the kernel takes "
                             f"CUDA tensors on one device ({q.device})")
        if t.dtype != q.dtype or t.dtype not in KERNEL_DTYPES:
            raise ValueError(f"{name} is {t.dtype}; the kernel takes one of "
                             f"{KERNEL_DTYPES}, the same for all operands")
        vec = 16 // t.element_size()
        if (t.stride(3) != 1 or any(s % vec for s in t.stride()[:3])
                or t.data_ptr() % 16):
            raise ValueError(f"{name} needs a contiguous head dimension and "
                             "16-byte aligned strides and address")
    b, _, h, d = q.shape
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"head size {d} not in {KERNEL_HEAD_DIMS}")
    if max(b, h) > 65535:
        raise ValueError(f"batch {b} or heads {h} above the grid's 65535")


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
    _check_operands(q, k, v)
    b, s_q, h, d = q.shape
    s_k, h_kv = k.shape[1], k.shape[2]
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


def _flash_bwd_reference_torch(q, k, v, o, lse, do, causal: bool,
                               scale: float):
    """Plain version of the two backward kernels together, in fp32.

    Takes the forward's inputs, its o and lse [B,H,S_q], and do like o;
    returns (dq, dk, dv) in q's, k's and v's dtypes, dk/dv summed over the
    H // H_kv query heads of each KV head. It writes out the kernels'
    formulas (it is not autograd through the forward): delta = rowsum(dO*O),
    P = exp(S*scale - lse) under the forward's masks, dS = P*(dP - delta)*
    scale. A row that sees no key has lse ~ -1e30 and P = 0, so its dq is 0,
    as the kernels give it."""
    rep = _kv_repeat(q, k, v)
    b, s_q, h, d = q.shape
    s_k, h_kv = k.shape[1], k.shape[2]
    qf, dof, of = (t.float().transpose(1, 2) for t in (q, do, o))
    kf, vf = (t.float().repeat_interleave(rep, dim=2).transpose(1, 2)
              for t in (k, v))
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale  # [B,H,S_q,S_k]
    valid = torch.ones((s_q, s_k), dtype=torch.bool, device=q.device)
    if causal:
        valid = torch.tril(valid, diagonal=s_k - s_q)
    p = torch.where(valid, torch.exp(s - lse[..., None]), 0.0)
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    delta = (dof * of).sum(dim=-1, keepdim=True)
    ds = p * (dp - delta) * scale
    dq = torch.matmul(ds, kf)
    dk = torch.matmul(ds.transpose(-1, -2), qf)
    dv = torch.matmul(p.transpose(-1, -2), dof)
    dk, dv = (t.reshape(b, h_kv, rep, s_k, d).sum(dim=2) for t in (dk, dv))
    return (dq.transpose(1, 2).to(q.dtype), dk.transpose(1, 2).to(k.dtype),
            dv.transpose(1, 2).to(v.dtype))


@functools.lru_cache(maxsize=None)
def _bwd_kernels():
    lib = _build.load("flash_bwd")
    pointers = 7  # q, k, v, dO, lse, delta, dq
    for fn, n_ptr in ((lib.flash_bwd_dq, pointers),
                      (lib.flash_bwd_dkv, pointers + 1)):  # dk and dv
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 7
                       + [ctypes.POINTER(ctypes.c_int64), ctypes.c_float,
                          ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    lib.flash_bwd_error_string.argtypes = [ctypes.c_int]
    lib.flash_bwd_error_string.restype = ctypes.c_char_p
    return lib


def _bwd_launch(name, q, k, v, do, lse, delta, outs, causal, scale):
    """Check what both backward kernels take and launch `name` with `outs`
    (dq; or dk, dv) on PyTorch's current stream."""
    _check_operands(q, k, v, do=do)
    b, s_q, h, d = q.shape
    s_k, h_kv = k.shape[1], k.shape[2]
    for tname, t in (("lse", lse), ("delta", delta)):
        if (t.dtype != torch.float32 or t.device != q.device
                or t.shape != (b, h, s_q) or not t.is_contiguous()):
            raise ValueError(f"{tname} must be contiguous fp32 [B, H, S_q] "
                             f"= {(b, h, s_q)} on {q.device}")
    if outs[0].numel() == 0:
        return
    lib = _bwd_kernels()
    strides = (ctypes.c_int64 * 15)(*q.stride()[:3], *k.stride()[:3],
                                    *v.stride()[:3], *do.stride()[:3],
                                    *outs[0].stride()[:3])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = getattr(lib, name)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), *(t.data_ptr() for t in outs),
            int(q.dtype == torch.bfloat16), b, h, h_kv, s_q, s_k, d, strides,
            float(scale), int(causal), stream)
    if err:
        raise RuntimeError(f"{name} launch failed: "
                           f"{lib.flash_bwd_error_string(err).decode()} "
                           f"(cudaError {err})")


def flash_bwd_dq_cuda(q, k, v, do, lse, delta, causal: bool, scale: float
                      ) -> torch.Tensor:
    """Launch the dQ kernel of `csrc/flash_bwd.cu`: q/do [B,S_q,H,D], k/v
    [B,S_k,H_kv,D] on CUDA, lse and delta = rowsum(dO*O) contiguous fp32
    [B,H,S_q] -> dq like q. Raises on what the kernel does not take (as
    `flash_fwd_cuda`). `launches` counts the launches."""
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _bwd_launch("flash_bwd_dq", q, k, v, do, lse, delta, (dq,), causal,
                scale)
    flash_bwd_dq_cuda.launches += 1
    return dq


flash_bwd_dq_cuda.launches = 0


def flash_bwd_dkv_cuda(q, k, v, do, lse, delta, causal: bool, scale: float
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the dK/dV kernel of `csrc/flash_bwd.cu` on what
    `flash_bwd_dq_cuda` takes -> (dk, dv) like k and v, each summed over
    the query heads of its KV head. `launches` counts the launches."""
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    _bwd_launch("flash_bwd_dkv", q, k, v, do, lse, delta, (dk, dv), causal,
                scale)
    flash_bwd_dkv_cuda.launches += 1
    return dk, dv


flash_bwd_dkv_cuda.launches = 0


def _flash_bwd(q, k, v, o, lse, do, causal: bool, scale: float):
    """-> (dq, dk, dv): the plain version for CPU tensors, the two CUDA
    kernels for CUDA tensors, and an error for any other. delta =
    rowsum(dO*O) in fp32 is a plain reduction here, as it is jnp in the
    JAX wrapper."""
    if q.device.type == "cpu":
        return _flash_bwd_reference_torch(q, k, v, o, lse, do, causal, scale)
    if q.device.type == "cuda":
        delta = (do.float() * o.float()).sum(dim=-1).transpose(1, 2)
        delta = delta.contiguous()
        dq = flash_bwd_dq_cuda(q, k, v, do, lse, delta, causal, scale)
        dk, dv = flash_bwd_dkv_cuda(q, k, v, do, lse, delta, causal, scale)
        return dq, dk, dv
    raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")


# The kernels as custom operators: an opaque node to torch.compile (whose
# graphs cannot hold the ctypes launch) that checkpoint policies can name.
# The bodies look `_flash_fwd` / `_flash_bwd` up by name when they run.

@torch.library.custom_op("ray_tpu_torch::flash_fwd", mutates_args=())
def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool, scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o [B,S_q,H,D], lse [B,H,S_q] fp32), both contiguous: the forward
    kernel on CUDA tensors, its plain version on CPU tensors."""
    o, lse = _flash_fwd(q, k, v, causal, scale)
    return o.contiguous(), lse.contiguous()


@flash_fwd.register_fake
def _(q, k, v, causal, scale):
    b, s_q, h, _ = q.shape
    return (q.new_empty(q.shape),
            q.new_empty((b, h, s_q), dtype=torch.float32))


@torch.library.custom_op("ray_tpu_torch::flash_bwd", mutates_args=())
def flash_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
              causal: bool, scale: float
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) like q, k and v, contiguous: the two backward kernels on
    CUDA tensors, the plain backward on CPU tensors."""
    dq, dk, dv = _flash_bwd(q, k, v, o, lse, do, causal, scale)
    return dq.contiguous(), dk.contiguous(), dv.contiguous()


@flash_bwd.register_fake
def _(q, k, v, o, lse, do, causal, scale):
    return q.new_empty(q.shape), k.new_empty(k.shape), v.new_empty(v.shape)


def _flash_fwd_setup_context(ctx, inputs, output):
    q, k, v, causal, scale = inputs
    o, lse = output
    ctx.save_for_backward(q, k, v, o, lse)
    ctx.causal, ctx.scale = causal, scale
    ctx.mark_non_differentiable(lse)


def _flash_fwd_backward(ctx, do, _dlse):
    """The counterpart of the JAX package's `_flash_bhsd` custom_vjp: the
    forward saved q, k, v, o and lse; lse carries no gradient."""
    q, k, v, o, lse = ctx.saved_tensors
    # An incoming gradient may be strided or expanded (zero strides, as
    # from .sum()); the kernels take a dense head dimension.
    dq, dk, dv = flash_bwd(q, k, v, o, lse, do.contiguous(), ctx.causal,
                           ctx.scale)
    return dq, dk, dv, None, None


flash_fwd.register_autograd(_flash_fwd_backward,
                            setup_context=_flash_fwd_setup_context)


def flash_attention(q, k, v, causal: bool = True,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Exact attention over [B, S, H, D] inputs (GQA: fewer KV heads OK),
    differentiable in q, k and v.

    Under causal, query i sees key j iff i + (s_k - s_q) >= j. The default
    scale is d ** -0.5."""
    if q.device.type not in ("cpu", "cuda"):
        # The operator's fake implementation would answer for a meta tensor.
        raise ValueError(
            f"flash_attention runs on cuda or cpu, not {q.device}")
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return flash_fwd(q, k, v, causal, scale)[0]


def _attention_placements(mesh, b: int, h: int, seq_axis: Optional[str]):
    """Placements of [B, S, H, D] attention operands on `mesh`: B over the
    data-parallel dims (dcn, dp, fsdp; size > 1) when it divides their
    product, else unsplit; S over `seq_axis`; H over tp when it divides.
    -> (placements, whether H is split over tp)."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names)
    sizes = {n: mesh.size(i) for i, n in enumerate(names)}
    batch_axes = [a for a in ("dcn", "dp", "fsdp") if sizes.get(a, 1) > 1]
    div = 1
    for a in batch_axes:
        div *= sizes[a]
    if b % div != 0:
        batch_axes = []
    heads = sizes.get("tp", 1) > 1 and h % sizes["tp"] == 0
    out = []
    for n in names:
        if n in batch_axes:
            out.append(Shard(0))
        elif n == seq_axis and sizes[n] > 1:
            out.append(Shard(1))
        elif n == "tp" and heads:
            out.append(Shard(2))
        else:
            out.append(Replicate())
    return tuple(out), heads


def _repeat_kv_heads(x, rep: int, mesh):
    """A DTensor [B,S,H_kv,D] -> [B,S,H_kv*rep,D], each KV head repeated
    for its query heads (the JAX wrapper's jnp.repeat), heads unsplit."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    pl = tuple(Replicate() if p == Shard(2) else p for p in x.placements)
    local = x.redistribute(mesh, pl).to_local()
    return DTensor.from_local(local.repeat_interleave(rep, dim=2), mesh, pl,
                              run_check=False)


def _local_map_attention(fn, q, k, v, mesh, seq_axis=None):
    """Run fn(q, k, v) -> o on each rank's blocks of DTensors q [B,S,H,D]
    and k/v [B,S,H_kv,D] (the `shard_map` of the JAX wrappers). The
    operands are first redistributed to `_attention_placements` (a no-op
    where they are already so; an all-gather of S where `seq_axis` is None
    and S was split); where H splits over tp and H_kv does not, the KV
    heads are repeated first. -> o as a DTensor in q's placements."""
    from torch.distributed.tensor.experimental import local_map

    b, _, h, _ = q.shape
    h_kv = k.shape[2]
    spec, heads = _attention_placements(mesh, b, h, seq_axis)
    if heads and h_kv % mesh.size(mesh.mesh_dim_names.index("tp")):
        k, v = (_repeat_kv_heads(t, h // h_kv, mesh) for t in (k, v))
    back = q.placements
    q, k, v = (t.redistribute(mesh, spec) for t in (q, k, v))
    out = local_map(fn, out_placements=(spec,),
                    in_placements=(spec, spec, spec), device_mesh=mesh)(q, k, v)
    return out.redistribute(mesh, back)


def flash_attention_sharded(q, k, v, mesh, causal: bool = True,
                            scale: Optional[float] = None):
    """`local_map`-wrapped flash attention over DTensors [B, S, H, D] on
    `mesh` (k/v may have fewer heads). The custom operators have no DTensor
    sharding rule, so, as GSPMD needs a shard_map around the Pallas call,
    each rank runs the kernel on its block: B over (dcn, dp, fsdp) where it
    divides, H over tp where it divides, S whole (split S is gathered
    first; the output goes back to q's placements). KV heads split over tp
    too where H_kv divides, and the kernels sum each GQA group; else they
    are repeated to H first, as the JAX wrapper always repeats them."""
    fn = functools.partial(flash_attention, causal=causal, scale=scale)
    return _local_map_attention(fn, q, k, v, mesh)
