// Flash-attention forward for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces ray_tpu/ops/flash_attention.py:_fwd_kernel, the Pallas TPU kernel
// that _flash_fwd_pallas launches. It computes the same function: exact
// attention by online softmax over streamed K/V tiles, with a running max m,
// a normaliser l and an fp32 accumulator; `scale` multiplies QK^T; keys past
// s_k are masked; under causal, query i sees key j iff i + (s_k - s_q) >= j,
// and K tiles past the diagonal are skipped. O is written in the input type
// and lse = m + log(max(l, 1e-20)) in fp32 [B, H, S_q]. A query row that sees
// no key (causal with s_q > s_k) gets O = 0 and lse = -1e30 + log(1e-20), as
// the TPU kernel gives it.
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
// Two designs, chosen by (dtype, D) in flash_fwd() below:
//
// bf16 at D = 64 and 128 (the main path; flash_fwd_sm90_kernel) is built
// for Hopper's tensor cores and copy engine (flash_sm90.cuh):
//   * One block of 3 warpgroups per (b, h, tile of 128 query rows). Two
//     consumer warpgroups own 64 rows each; a producer warpgroup, of which
//     one thread works, issues TMA loads: the Q tile once, then K and V
//     tiles of 128 keys into a ring of 2 stages, each completed on its own
//     mbarrier (V has its own, so Q.K^T starts before V lands) and released
//     by the consumers' 8 warps on an "empty" mbarrier. setmaxnreg gives
//     the producer 24 registers a thread and the consumers 240: 24 x 128 +
//     240 x 256 is the 168 x 384 the block starts with, and no more.
//   * S = Q.K^T by wgmma (m64n64k16, both operands K-major from 128-byte
//     swizzled shared memory) into registers. The online softmax runs on
//     the accumulator: a thread holds rows r and r+8 of its warp's 16, so a
//     row's max takes two __shfl_xor (1, 2) over its 4 threads; l is kept
//     per thread and summed once at the end. exp2 with scale * log2(e)
//     folded in.
//   * P is rounded to bf16 in registers and is the register A operand of
//     O += P.V (wgmma RS, V MN-major through the transpose bit); O is
//     rescaled in registers. Nothing of S, P or O touches shared memory; O
//     and lse are stored from registers at the end.
//   * Masks (keys past s_k, the causal diagonal) are applied only on tiles
//     that need them; tiles past a block's diagonal are not loaded; rows
//     and keys past the ends are zero-filled by TMA. The heaviest causal
//     tiles launch first.
//   Shared memory at D = 128: Q 32 KB + 2 stages of K and V (128 KB) =
//   160 KB and the barriers, so one block (384 threads) an SM. ptxas
//   (CUDA 12.9): 168 registers at entry, no spill, at D = 64 and 128.
//
// fp32 (all head sizes) and bf16 at D = 32 (flash_fwd_kernel) keep the
// first design: one block of 4 warps per (b, h, tile of 64 query rows), K/V
// tiles loaded through registers, S and O staged in shared memory, bf16
// products by WMMA 16x16x16 and fp32 ones by FMA (no TF32), so fp32 agrees
// with the fp32 plain version to fp32 rounding.

#include "flash_common.cuh"
#include "flash_sm90.cuh"

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

// -- bf16, D = 64 and 128: wgmma, register accumulators, a TMA-fed ring --

namespace fwd90 {

constexpr int QROWS = 128;     // query rows a block (two warpgroups of 64)
constexpr int KROWS = 128;     // keys a streamed tile
constexpr int STAGES = 2;   // K/V ring
constexpr int THREADS = 384;

template <int D>
struct Smem90 {
  static constexpr int NB = D / sm90::BOX;
  static constexpr size_t q_bytes = QROWS * D * sizeof(bf16);
  static constexpr size_t kv_bytes = KROWS * D * sizeof(bf16);
  static constexpr size_t k_off = q_bytes;
  static constexpr size_t v_off = k_off + STAGES * kv_bytes;
  static constexpr size_t bar_off = v_off + STAGES * kv_bytes;
  // + the barriers, + 1024 to align the base.
  static constexpr size_t bytes = bar_off + (1 + 3 * STAGES) * 8 + 1024;
};

}  // namespace fwd90

template <int D>
__global__ void __launch_bounds__(fwd90::THREADS, 1)
flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      bf16* __restrict__ o, float* __restrict__ lse, int H,
                      int rep, int S_q, int S_k, int64_t o_b, int64_t o_s,
                      int64_t o_h, float scale_log2, int causal) {
  using namespace fwd90;
  using L = Smem90<D>;
  constexpr int NB = L::NB, KS = D / 16;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (sm90::smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* sQ = smem;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::bar_off);
  uint64_t* bar_q = bars;
  uint64_t* full_k = bars + 1;
  uint64_t* full_v = bars + 1 + STAGES;
  uint64_t* empty = bars + 1 + 2 * STAGES;

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int h = blockIdx.y, b = blockIdx.z, hk = h / rep;
  const int q0 = qt * QROWS, offset = S_k - S_q;
  int n_kv = (S_k + KROWS - 1) / KROWS;
  if (causal) {
    const int lim = q0 + QROWS + offset;  // one past the last key this tile sees
    n_kv = min(n_kv, lim <= 0 ? 0 : (lim + KROWS - 1) / KROWS);
  }

  if (threadIdx.x == 0) {
    sm90::bar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      sm90::bar_init(&full_k[s], 1);
      sm90::bar_init(&full_v[s], 1);
      sm90::bar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    sm90::bar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // Producer: one thread issues every copy of the block.
    sm90::regs_dec<24>();
    if (threadIdx.x == 256) {
      sm90::bar_arrive_tx(bar_q, L::q_bytes);
      sm90::tma_tile<NB>(sQ, &tq, bar_q, QROWS, h, q0, b);
      for (int j = 0; j < n_kv; ++j) {
        const int s = j % STAGES, u = j / STAGES;
        if (u > 0) sm90::bar_wait(&empty[s], (u - 1) & 1);
        sm90::bar_arrive_tx(&full_k[s], L::kv_bytes);
        sm90::tma_tile<NB>(smem + L::k_off + s * L::kv_bytes, &tk, &full_k[s],
                           KROWS, hk, j * KROWS, b);
        sm90::bar_arrive_tx(&full_v[s], L::kv_bytes);
        sm90::tma_tile<NB>(smem + L::v_off + s * L::kv_bytes, &tv, &full_v[s],
                           KROWS, hk, j * KROWS, b);
      }
    }
  } else {
    // Consumers: warpgroup wg owns query rows q0 + 64 wg .. + 63.
    sm90::regs_inc<240>();
    const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
    const int qw0 = q0 + wg * 64;
    const int row0 = qw0 + warp * 16 + (lane >> 2);  // and row0 + 8
    float O[NB][32];
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int i = 0; i < 32; ++i) O[n][i] = 0.0f;
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.0f, 0.0f};
    const unsigned char* qa = sQ + wg * 64 * sm90::ROW_BYTES;

    sm90::bar_wait(bar_q, 0);
    for (int j = 0; j < n_kv; ++j) {
      const int s = j % STAGES, u = j / STAGES, k0 = j * KROWS;
      const unsigned char* sK = smem + L::k_off + s * L::kv_bytes;
      const unsigned char* sV = smem + L::v_off + s * L::kv_bytes;
      sm90::bar_wait(&full_k[s], u & 1);

      // S = Q . K^T: two 64-key halves, KS k-steps of 16 each.
      float S[2][32];
      sm90::wg_fence();
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
#pragma unroll
        for (int ks = 0; ks < KS; ++ks)
          sm90::mma_ss(
              S[hf],
              sm90::desc(qa + (ks / 4) * QROWS * sm90::ROW_BYTES + (ks % 4) * 32,
                         0),
              sm90::desc(sK + (ks / 4) * KROWS * sm90::ROW_BYTES +
                             hf * 64 * sm90::ROW_BYTES + (ks % 4) * 32,
                         0),
              ks > 0);
      sm90::wg_commit();
      sm90::wg_wait<0>();
      sm90::reg_fence(S[0]);
      sm90::reg_fence(S[1]);

      // Online softmax on the accumulator, in log2 units.
      const bool masked =
          k0 + KROWS > S_k || (causal && qw0 + offset < k0 + KROWS - 1);
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int r = (i >> 1) & 1;
          float x = S[hf][i] * scale_log2;
          if (masked) {
            const int kpos = k0 + hf * 64 + sm90::acc_col(i);
            const bool valid = kpos < S_k &&
                               (!causal || row0 + 8 * r + offset >= kpos);
            x = valid ? x : NEG_INF;
          }
          S[hf][i] = x;
          mx[r] = fmaxf(mx[r], x);
        }
      float corr[2], sum[2] = {0.0f, 0.0f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        corr[r] = sm90::fast_exp2(m[r] - mx[r]);
        m[r] = mx[r];
      }
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int r = (i >> 1) & 1;
          const float x = S[hf][i];
          const float p = masked && x <= NEG_INF * 0.5f
                              ? 0.0f
                              : sm90::fast_exp2(x - m[r]);
          S[hf][i] = p;
          sum[r] += p;
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + sum[r];
#pragma unroll
      for (int n = 0; n < NB; ++n)
#pragma unroll
        for (int i = 0; i < 32; ++i) O[n][i] *= corr[(i >> 1) & 1];
      uint32_t P[2][16];
      sm90::to_a_frags(S[0], P[0]);
      sm90::to_a_frags(S[1], P[1]);

      // O += P . V: 8 k-blocks of 16 keys, one m64n64k16 per 64 columns.
      sm90::bar_wait(&full_v[s], u & 1);
#pragma unroll
      for (int n = 0; n < NB; ++n) sm90::reg_fence(O[n]);
      sm90::reg_fence(P[0]);
      sm90::reg_fence(P[1]);
      sm90::wg_fence();
#pragma unroll
      for (int kb = 0; kb < KROWS / 16; ++kb)
#pragma unroll
        for (int n = 0; n < NB; ++n)
          sm90::mma_rs(O[n], &P[kb / 4][4 * (kb % 4)],
                       sm90::desc(sV + n * KROWS * sm90::ROW_BYTES +
                                      kb * 16 * sm90::ROW_BYTES,
                                  KROWS * sm90::ROW_BYTES));
      sm90::wg_commit();
      sm90::wg_wait<0>();
#pragma unroll
      for (int n = 0; n < NB; ++n) sm90::reg_fence(O[n]);
      if (lane == 0) sm90::bar_arrive(&empty[s]);
    }

    // Epilogue: l summed over the row's 4 threads; O and lse from registers.
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float lt = l[r];
      lt += __shfl_xor_sync(0xffffffffu, lt, 1);
      lt += __shfl_xor_sync(0xffffffffu, lt, 2);
      lt = fmaxf(lt, 1e-20f);
      inv[r] = 1.0f / lt;
      const int row = row0 + 8 * r;
      if ((lane & 3) == 0 && row < S_q) {
        const float mn = m[r] <= NEG_INF * 0.5f ? NEG_INF : m[r] / sm90::LOG2E;
        lse[(static_cast<int64_t>(b) * H + h) * S_q + row] = mn + logf(lt);
      }
    }
    bf16* ob = o + b * o_b + h * o_h;
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int r = (i >> 1) & 1, row = row0 + 8 * r;
        if (row < S_q)
          *reinterpret_cast<__nv_bfloat162*>(
              ob + row * o_s + n * sm90::BOX + sm90::acc_col(i)) =
              __floats2bfloat162_rn(O[n][i] * inv[r], O[n][i + 1] * inv[r]);
      }
  }
}

template <int D>
cudaError_t launch_sm90(const void* q, const void* k, const void* v, void* o,
                        void* lse, int B, int H, int H_kv, int S_q, int S_k,
                        const Strides& st, float scale, int causal,
                        cudaStream_t stream) {
  using namespace fwd90;
  CUtensorMap tq, tk, tv;
  cudaError_t err;
  if ((err = sm90::make_map(&tq, q, B, S_q, H, D, st.q_b, st.q_s, st.q_h,
                            QROWS)) != cudaSuccess ||
      (err = sm90::make_map(&tk, k, B, S_k, H_kv, D, st.k_b, st.k_s, st.k_h,
                            KROWS)) != cudaSuccess ||
      (err = sm90::make_map(&tv, v, B, S_k, H_kv, D, st.v_b, st.v_s, st.v_h,
                            KROWS)) != cudaSuccess)
    return err;
  auto kern = flash_fwd_sm90_kernel<D>;
  const int bytes = static_cast<int>(Smem90<D>::bytes);
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((S_q + QROWS - 1) / QROWS, H, B);
  kern<<<grid, THREADS, bytes, stream>>>(
      tq, tk, tv, static_cast<bf16*>(o), static_cast<float*>(lse), H,
      H / H_kv, S_q, S_k, st.o_b, st.o_s, st.o_h, scale * sm90::LOG2E,
      causal);
  return cudaGetLastError();
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
  if (is_bf16) {
    switch (D) {
      case 32:
        return launch<bf16, 32>(q, k, v, o, lse, B, H, H_kv, S_q, S_k, st,
                                scale, causal, s);
      case 64:
        return launch_sm90<64>(q, k, v, o, lse, B, H, H_kv, S_q, S_k, st,
                               scale, causal, s);
      case 128:
        return launch_sm90<128>(q, k, v, o, lse, B, H, H_kv, S_q, S_k, st,
                                scale, causal, s);
      default:
        return cudaErrorInvalidValue;
    }
  }
  switch (D) {
    case 32:
      return launch<float, 32>(q, k, v, o, lse, B, H, H_kv, S_q, S_k, st,
                               scale, causal, s);
    case 64:
      return launch<float, 64>(q, k, v, o, lse, B, H, H_kv, S_q, S_k, st,
                               scale, causal, s);
    case 128:
      return launch<float, 128>(q, k, v, o, lse, B, H, H_kv, S_q, S_k, st,
                                scale, causal, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// Which design flash_fwd launches for (dtype, D): "wgmma" (the sm90
// kernel), "wmma" or "fma" (the first design's bf16 and fp32 paths).
extern "C" const char* flash_fwd_variant(int is_bf16, int D) {
  if (!is_bf16) return "fma";
  return D == 64 || D == 128 ? "wgmma" : "wmma";
}

// Dynamic shared memory a block of the sm90 kernel takes at head size D
// (0 where flash_fwd launches another design).
extern "C" int flash_fwd_smem_bytes(int is_bf16, int D) {
  if (!is_bf16) return 0;
  if (D == 64) return static_cast<int>(fwd90::Smem90<64>::bytes);
  if (D == 128) return static_cast<int>(fwd90::Smem90<128>::bytes);
  return 0;
}

extern "C" const char* flash_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
