// Flash-attention forward for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces ray_tpu/ops/flash_attention.py:_fwd_kernel, the Pallas TPU kernel
// that _flash_fwd_pallas launches. It computes the same function: exact
// attention by online softmax over streamed K/V tiles, with a running max m,
// a normaliser l and an fp32 accumulator; `scale` multiplies QK^T; keys past
// s_k are masked; under causal, query i sees key j iff i + (s_k - s_q) >= j,
// and K tiles past the diagonal are skipped. O is written in the input type
// and lse = m + log(max(l, 1e-20)) in fp32 [B, H, S_q]. A query row that sees
// no key (causal with s_q > s_k) gets O = 0 and lse ~ -1e30, as the TPU
// kernel gives it.
//
// Layout: q [B, S_q, H, D], k/v [B, S_k, H_kv, D], read through their strides
// (D contiguous), so the caller's tensors need no transpose copy. GQA reads
// KV head h / (H / H_kv) instead of materialising the repeat.
//
// What bounds it on this card: at the Llama-3-8B shape (S = 2048, D = 128,
// causal) one head does 4*D flops for each visible (query, key) pair, about
// 34 GFLOP for 32 heads, against 42 MB of q/k/v/o/lse: some 800 flops a byte,
// well above the H100's ~295 flops a byte in bf16. So the bound is the tensor
// cores (989 TFLOP/s, ~35 us), not device memory.
//
// What the design does about it: one thread block of 4 warps per (b, h, tile
// of 64 query rows). The Q tile stays in shared memory for the block's life;
// K/V tiles of 64 rows are streamed through shared memory once per Q tile.
// Both products run on the tensor cores (WMMA bf16 16x16x16, fp32
// accumulation); the softmax statistics stay in fp32 registers, two threads a
// row. The scores S and the O accumulator are staged in shared memory, so
// that the per-row rescale of O is a plain loop; that staging and the
// barriers between the phases are the main gap to the bound. Register-
// resident accumulators, wgmma, TMA and a pipelined K/V ring are later work.
// fp32 inputs take plain FMA loops (no TF32), so they agree with the fp32
// plain version to fp32 rounding. The heaviest causal tiles launch first.

#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr int BQ = TILE;  // query rows per block
constexpr int BK = TILE;  // key rows per streamed tile

template <typename T, int D>
struct Smem {
  static constexpr int LDI = D + Elem<T>::PAD;   // q, k, v tiles
  static constexpr int LDP = BK + Elem<T>::PAD;  // probabilities
  static constexpr int LDS = BK + 4;             // fp32 scores
  static constexpr int LDO = D + 4;              // fp32 output accumulator
  static constexpr size_t q_off = 0;
  static constexpr size_t k_off = q_off + align128(BQ * LDI * sizeof(T));
  static constexpr size_t v_off = k_off + align128(BK * LDI * sizeof(T));
  static constexpr size_t s_off = v_off + align128(BK * LDI * sizeof(T));
  static constexpr size_t p_off = s_off + align128(BQ * LDS * sizeof(float));
  static constexpr size_t o_off = p_off + align128(BQ * LDP * sizeof(T));
  static constexpr size_t l_off = o_off + align128(BQ * LDO * sizeof(float));
  static constexpr size_t bytes = l_off + align128(BQ * sizeof(float));
};

// sO[64][D] += sP . sV.
template <typename T, int D>
__device__ __forceinline__ void accumulate_pv(const T* sP, const T* sV,
                                              float* sO) {
  using L = Smem<T, D>;
  if constexpr (std::is_same<T, bf16>::value) {
    const int w = threadIdx.x >> 5;  // warp w owns output rows 16w .. 16w+15
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[BK / 16];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wmma::load_matrix_sync(a[kk], sP + w * 16 * L::LDP + kk * 16, L::LDP);
#pragma unroll
    for (int n = 0; n < D / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      float* tile = sO + w * 16 * L::LDO + n * 16;
      wmma::load_matrix_sync(acc, tile, L::LDO, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
        wmma::load_matrix_sync(b, sV + kk * 16 * L::LDI + n * 16, L::LDI);
        wmma::mma_sync(acc, a[kk], b, acc);
      }
      wmma::store_matrix_sync(tile, acc, L::LDO, wmma::mem_row_major);
    }
  } else {
    constexpr int NJ = D / 8;
    const int tx = threadIdx.x & 7, ty = threadIdx.x >> 3;
    float acc[4][NJ] = {};
    for (int kk = 0; kk < BK; ++kk) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = sP[(ty * 4 + i) * L::LDP + kk];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float vv = sV[kk * L::LDI + tx + 8 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(p[i], vv, acc[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        sO[(ty * 4 + i) * L::LDO + tx + 8 * j] += acc[i][j];
  }
}

struct Strides {
  int64_t q_b, q_s, q_h, k_b, k_s, k_h, v_b, v_s, v_h, o_b, o_s, o_h;
};

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int H, int rep, int S_q, int S_k,
                 Strides st, float scale, int causal) {
  using L = Smem<T, D>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem + L::q_off);
  T* sK = reinterpret_cast<T*>(smem + L::k_off);
  T* sV = reinterpret_cast<T*>(smem + L::v_off);
  float* sS = reinterpret_cast<float*>(smem + L::s_off);
  T* sP = reinterpret_cast<T*>(smem + L::p_off);
  float* sO = reinterpret_cast<float*>(smem + L::o_off);
  float* sInvL = reinterpret_cast<float*>(smem + L::l_off);

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int h = blockIdx.y, b = blockIdx.z, hk = h / rep;
  const int q0 = qt * BQ, tid = threadIdx.x;
  const T* qb = q + b * st.q_b + h * st.q_h;
  const T* kb = k + b * st.k_b + hk * st.k_h;
  const T* vb = v + b * st.v_b + hk * st.v_h;

  load_tile<T, D>(sQ, L::LDI, qb, st.q_s, q0, S_q);
  for (int i = tid; i < BQ * L::LDO; i += NT) sO[i] = 0.0f;

  const int offset = S_k - S_q;
  int n_kv = (S_k + BK - 1) / BK;
  if (causal) {
    const int lim = q0 + BQ + offset;  // one past the last key this tile sees
    n_kv = min(n_kv, lim <= 0 ? 0 : (lim + BK - 1) / BK);
  }

  // Two threads per query row; each takes every other column.
  const int row = tid >> 1, half = tid & 1;
  const int qpos = q0 + row + offset;
  float m_i = NEG_INF, l_i = 0.0f;

  for (int j = 0; j < n_kv; ++j) {
    const int k0 = j * BK;
    __syncthreads();  // the previous tile's P.V is done with sK, sV and sP
    load_tile<T, D>(sK, L::LDI, kb, st.k_s, k0, S_k);
    load_tile<T, D>(sV, L::LDI, vb, st.v_s, k0, S_k);
    __syncthreads();
    tile_abt<T, D>(sQ, sK, L::LDI, sS, L::LDS);
    __syncthreads();

    float* srow = sS + row * L::LDS;
    float mx = NEG_INF;
#pragma unroll 8
    for (int c = half; c < BK; c += 2) {
      const int kpos = k0 + c;
      const bool valid = kpos < S_k && (!causal || qpos >= kpos);
      const float s = valid ? srow[c] * scale : NEG_INF;
      srow[c] = s;
      mx = fmaxf(mx, s);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m_i, mx);
    T* prow = sP + row * L::LDP;
    float sum = 0.0f;
#pragma unroll 8
    for (int c = half; c < BK; c += 2) {
      const float s = srow[c];
      const float p = s <= NEG_INF * 0.5f ? 0.0f : __expf(s - m_new);
      prow[c] = from_f<T>(p);
      sum += p;
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    const float corr = __expf(m_i - m_new);
    l_i = l_i * corr + sum;
    m_i = m_new;
    float* orow = sO + row * L::LDO;
    for (int c = half; c < D; c += 2) orow[c] *= corr;
    __syncthreads();
    accumulate_pv<T, D>(sP, sV, sO);
  }

  const float l = fmaxf(l_i, 1e-20f);
  if (half == 0) {
    sInvL[row] = 1.0f / l;
    if (q0 + row < S_q)
      lse[(static_cast<int64_t>(b) * H + h) * S_q + q0 + row] = m_i + logf(l);
  }
  __syncthreads();

  constexpr int VEC = Elem<T>::VEC, CPR = D / VEC;
  T* ob = o + b * st.o_b + h * st.o_h;
  for (int i = tid; i < BQ * CPR; i += NT) {
    const int r = i / CPR, c = (i % CPR) * VEC;
    if (q0 + r >= S_q) continue;
    const float inv = sInvL[r];
    const float* src = sO + r * L::LDO + c;
    alignas(16) T out[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) out[e] = from_f<T>(src[e] * inv);
    *reinterpret_cast<uint4*>(ob + (q0 + r) * st.o_s + c) =
        *reinterpret_cast<const uint4*>(out);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int B, int H, int H_kv, int S_q, int S_k,
                   const Strides& st, float scale, int causal,
                   cudaStream_t stream) {
  auto kern = flash_fwd_kernel<T, D>;
  const int bytes = static_cast<int>(Smem<T, D>::bytes);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((S_q + BQ - 1) / BQ, H, B);
  kern<<<grid, NT, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      H, H / H_kv, S_q, S_k, st, scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, const void* q, const void* k, const void* v,
                       void* o, void* lse, int B, int H, int H_kv, int S_q,
                       int S_k, const Strides& st, float scale, int causal,
                       cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch<T, 32>(q, k, v, o, lse, B, H, H_kv, S_q, S_k, st, scale,
                           causal, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, lse, B, H, H_kv, S_q, S_k, st, scale,
                           causal, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, lse, B, H, H_kv, S_q, S_k, st, scale,
                            causal, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C interface for ctypes. `strides` holds 12 element strides: (batch,
// seq, head) for q, k, v and o, in that order; the head dimension must be
// contiguous and every stride a multiple of 16 bytes. Launches on `stream`,
// does not synchronise, and returns cudaGetLastError() after the launch.
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o,
                         void* lse, int is_bf16, int B, int H, int H_kv,
                         int S_q, int S_k, int D, const int64_t* strides,
                         float scale, int causal, void* stream) {
  const Strides st{strides[0], strides[1], strides[2],  strides[3],
                   strides[4], strides[5], strides[6],  strides[7],
                   strides[8], strides[9], strides[10], strides[11]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dispatch_d<bf16>(D, q, k, v, o, lse, B, H, H_kv, S_q, S_k, st,
                            scale, causal, s);
  return dispatch_d<float>(D, q, k, v, o, lse, B, H, H_kv, S_q, S_k, st, scale,
                           causal, s);
}

extern "C" const char* flash_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
