// Hopper building blocks of the bf16 flash-attention kernels (the forward in
// flash_fwd.cu, dQ and dK/dV in flash_bwd.cu): TMA tile loads completed on
// mbarriers, wgmma on operands in 128-byte-swizzled shared memory or in
// registers, and the register layout that ties them together.
//
// Tiles. A tile of R rows of one head is loaded by TMA as D / 64 boxes of
// R x 64 bf16 (128 bytes a row, the most a box may hold under
// SWIZZLE_128B), box n holding columns 64n .. 64n+63, one after the other:
// [box][row][64]. Every tile starts on a 1024-byte boundary, so the
// hardware's swizzle (16-byte chunk c of row r stored at chunk c ^ (r % 8))
// is the one the wgmma descriptors below name. The tensor maps are 4-D over
// (D, H, S, B) with the caller's strides, so a [B, S, H, D] tensor, or a
// strided view of one, is read as it lies; rows past S are zero-filled by
// the hardware.
//
// Products. Only m64n64k16 (bf16 in, fp32 accumulate) is issued, as
//   * SS: A and B both K-major in shared memory (Q.K^T, dO.V^T, K.Q^T,
//     V.dO^T); a k-step of 16 moves the start address 32 bytes along the
//     swizzled row;
//   * RS: A from registers (P or dS in bf16), B MN-major in shared memory
//     (V, K, dO, Q, whose rows run along the product's k), transposed by the
//     instruction; a k-step of 16 moves the start 16 rows (2048 bytes).
// A warpgroup (4 warps) owns 64 rows of the product. Its accumulator
// layout: warp w, lane l, register i of 32 holds row 16w + l/4 + 8*((i/2)%2)
// and column 8*(i/4) + 2*(l%4) + i%2 -- the m16n8 layout of mma.sync, one
// n8 block after another. The A fragment of k-block t (columns 16t ..
// 16t+15) packs the accumulator's registers 8t .. 8t+7 pairwise into bf16x2,
// so P and dS go from the fp32 accumulator to the next product's A operand
// without touching shared memory.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sm90 {

constexpr int BOX = 64;             // columns of a TMA box (128 bytes)
constexpr int ROW_BYTES = 128;      // bytes of one swizzled tile row
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// -- mbarriers ---------------------------------------------------------------

__device__ __forceinline__ void bar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void bar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// Arrive and add `bytes` to what the current phase waits for.
__device__ __forceinline__ void bar_arrive_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// -- TMA ---------------------------------------------------------------------

// One box at coordinates (d0, h, s0, b) of a 4-D (D, H, S, B) map into
// shared memory at dst; completion is counted on `bar` in bytes.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int d0, int h, int s0,
                                         int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(d0), "r"(h),
      "r"(s0), "r"(b)
      : "memory");
}

// All D / 64 boxes of a tile of `rows` rows starting at row s0.
template <int NB>
__device__ __forceinline__ void tma_tile(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int rows, int h,
                                         int s0, int b) {
#pragma unroll
  for (int n = 0; n < NB; ++n)
    tma_load(static_cast<char*>(dst) + n * rows * ROW_BYTES, map, bar, n * BOX,
             h, s0, b);
}

// -- warpgroup register budget -----------------------------------------------

template <int N> __device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N> __device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// -- wgmma -------------------------------------------------------------------

// Shared-memory matrix descriptor, 128-byte swizzle: start address,
// leading byte offset (the stride between 64-column atoms along M/N of an
// MN-major operand; unused for K-major), stride byte offset (1024: eight
// 128-byte rows), layout type 1 (SWIZZLE_128B).
__device__ __forceinline__ uint64_t desc(const void* p, uint32_t lbo_bytes) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | (uint64_t((lbo_bytes >> 4) & 0x3FFF) << 16) |
         (uint64_t(1024 >> 4) << 32) | (uint64_t(1) << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of registers that an
// in-flight wgmma owns across the fence/commit/wait instructions.
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&a)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

#define SM90_D32(d)                                                          \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),    \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),           \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),       \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),       \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),       \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),       \
      "+f"(d[31])

#define SM90_REGS32                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "   \
  "%30, %31}"

// d (+)= A . B, A [64 x 16] and B [16 x 64] both K-major in shared memory.
__device__ __forceinline__ void mma_ss(float (&d)[32], uint64_t da,
                                       uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SM90_REGS32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : SM90_D32(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d += A . B, A [64 x 16] in registers (a fragment), B [16 x 64] MN-major
// in shared memory.
__device__ __forceinline__ void mma_rs(float (&d)[32], const uint32_t* a,
                                       uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SM90_REGS32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : SM90_D32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef SM90_REGS32
#undef SM90_D32

// Accumulator register i -> (row, column) inside the warpgroup's 64 x 64.
__device__ __forceinline__ int acc_row(int i) {
  return ((threadIdx.x >> 5) & 3) * 16 + ((threadIdx.x & 31) >> 2) +
         8 * ((i >> 1) & 1);
}
__device__ __forceinline__ int acc_col(int i) {
  return 8 * (i >> 2) + 2 * (threadIdx.x & 3) + (i & 1);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A fragments of a 64 x 64 fp32 accumulator in bf16: 4 k-blocks of 4.
__device__ __forceinline__ void to_a_frags(const float (&d)[32],
                                           uint32_t (&a)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) a[i] = pack_bf16(d[2 * i], d[2 * i + 1]);
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// -- host: tensor maps -------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of the CUDA driver API, looked up through the
// runtime (so the library needs no -lcuda).
inline EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess && p)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A bf16 [B, S, H, D] tensor (element strides b, s, h; D contiguous) as a
// 4-D (D, H, S, B) map whose box is `rows` rows of 64 columns of one head,
// 128-byte swizzled, zero past S. Returns cudaErrorInvalidValue if the
// encoder refuses it.
inline cudaError_t make_map(CUtensorMap* map, const void* base, int B, int S,
                            int H, int D, int64_t sb, int64_t ss, int64_t sh,
                            int rows) {
  EncodeTiled fn = encode_fn();
  if (fn == nullptr) return cudaErrorInvalidValue;
  const cuuint64_t dims[4] = {cuuint64_t(D), cuuint64_t(H),
                              cuuint64_t(S > 0 ? S : 1), cuuint64_t(B)};
  const cuuint64_t strides[3] = {cuuint64_t(sh) * 2, cuuint64_t(ss) * 2,
                                 cuuint64_t(sb) * 2};
  const cuuint32_t box[4] = {BOX, 1, cuuint32_t(rows), 1};
  const cuuint32_t estride[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(base), dims, strides, box, estride,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace sm90
