// Pieces shared by the first design of the flash-attention kernels
// (flash_fwd.cu, flash_bwd.cu: fp32, and bf16 at D = 32); the sm90 kernels
// take theirs from flash_sm90.cuh.
//
// Every such kernel runs blocks of NT = 128 threads (4 warps) over tiles of 64
// rows of one head. Tiles sit in shared memory with rows padded by PAD
// elements, so that each row is a multiple of 16 bytes (vector loads and the
// 32-byte alignment WMMA needs at every 16-row step) and banks are
// staggered. Warp w owns rows 16w .. 16w+15 of every 64-row product it
// computes (in bf16 on the tensor cores, in fp32 by FMA), so a warp's
// element-wise pass over its own rows needs only __syncwarp.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace flash {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

constexpr int TILE = 64;  // rows of a Q, K, V or dO tile
constexpr int NT = 128;   // threads per block
constexpr float NEG_INF = -1e30f;

// VEC is the number of elements in one 16-byte global load or store.
template <typename T> struct Elem;
template <> struct Elem<float> { static constexpr int PAD = 4, VEC = 4; };
template <> struct Elem<bf16> { static constexpr int PAD = 8, VEC = 8; };

__host__ __device__ constexpr size_t align128(size_t x) {
  return (x + 127) / 128 * 128;
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16(x);
}

// Rows row0 .. row0+63 of one head into a [64][ld] tile; rows past `seq`
// are zero, so a ragged last tile adds nothing to any product.
template <typename T, int D>
__device__ __forceinline__ void load_tile(T* dst, int ld, const T* src,
                                          int64_t row_stride, int row0,
                                          int seq) {
  constexpr int VEC = Elem<T>::VEC, CPR = D / VEC;
  for (int i = threadIdx.x; i < TILE * CPR; i += NT) {
    const int r = i / CPR, c = (i % CPR) * VEC;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < seq)
      val = *reinterpret_cast<const uint4*>(src + (row0 + r) * row_stride + c);
    *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
  }
}

// S[64][64] = A . B^T for A, B [64][D] tiles (leading dimension ld), S fp32
// with leading dimension lds.
template <typename T, int D>
__device__ __forceinline__ void tile_abt(const T* A, const T* B, int ld,
                                         float* S, int lds) {
  if constexpr (std::is_same<T, bf16>::value) {
    const int w = threadIdx.x >> 5;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[TILE / 16];
#pragma unroll
    for (int n = 0; n < TILE / 16; ++n) wmma::fill_fragment(acc[n], 0.0f);
#pragma unroll
    for (int kk = 0; kk < D; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::load_matrix_sync(a, A + w * 16 * ld + kk, ld);
#pragma unroll
      for (int n = 0; n < TILE / 16; ++n) {
        // B^T as a column-major operand: element (kk, n) sits at B[n][kk].
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bt;
        wmma::load_matrix_sync(bt, B + n * 16 * ld + kk, ld);
        wmma::mma_sync(acc[n], a, bt, acc[n]);
      }
    }
#pragma unroll
    for (int n = 0; n < TILE / 16; ++n)
      wmma::store_matrix_sync(S + w * 16 * lds + n * 16, acc[n], lds,
                              wmma::mem_row_major);
  } else {
    // 16 x 8 threads, each 4 rows x 8 columns (columns strided by 8).
    const int tx = threadIdx.x & 7, ty = threadIdx.x >> 3;
    float acc[4][8] = {};
    for (int kk = 0; kk < D; ++kk) {
      float a[4], b[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = A[(ty * 4 + i) * ld + kk];
#pragma unroll
      for (int j = 0; j < 8; ++j) b[j] = B[(tx + 8 * j) * ld + kk];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) S[(ty * 4 + i) * lds + tx + 8 * j] = acc[i][j];
  }
}

}  // namespace flash
