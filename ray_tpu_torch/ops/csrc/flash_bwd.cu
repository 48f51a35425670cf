// Flash-attention backward for Hopper (sm_90a), hand-written CUDA C++: two
// kernels, one for dQ and one for dK/dV.
//
// Replaces ray_tpu/ops/flash_attention.py:_bwd_dq_kernel and _bwd_dkv_kernel,
// the Pallas TPU kernels that _flash_bwd_pallas launches. They compute the
// same function from the forward's saved lse and the wrapper's
// delta = rowsum(dO * O) (fp32): P = exp(S * scale - lse) with the forward's
// masks (keys past s_k; under causal, query i sees key j iff
// i + (s_k - s_q) >= j), dP = dO . V^T, dS = P * (dP - delta) * scale, then
// dQ = dS . K, dK = dS^T . Q and dV = P^T . dO. A query row that sees no key
// (lse ~ -1e30) gets P = 0 by the mask, never exp of a huge number, so its
// dQ is 0 and it adds nothing to dK or dV.
//
// Layout: q/dO/dQ [B, S_q, H, D], k/v/dK/dV [B, S_k, H_kv, D], read and
// written through their strides (D contiguous); lse and delta [B, H, S_q].
//
// What bounds them on this card: at the Llama-3-8B training shape (B = 4,
// S = 2048, D = 128, causal) the dQ kernel does three products of 2*D flops
// for each visible (query, key) pair (~206 GFLOP) and the dK/dV kernel four
// (~275 GFLOP), against ~0.2 GB of tensors: well above the H100's ~295 flops
// a byte in bf16, so the tensor cores bound both (~0.21 and ~0.28 ms at
// 989 TFLOP/s), not device memory.
//
// Ownership. The TPU kernels run their grids in order and let the repeat of
// the KV heads (jnp.repeat in the wrapper) sum dK and dV over a GQA group in
// its transpose. Here blocks run in no order, so each output has exactly one
// owner and nothing is accumulated across blocks:
//   * dQ: one block per (b, h, tile of query rows) streams the K/V tiles up
//     to the causal diagonal, heaviest tiles launched first.
//   * dK/dV: one block per (b, KV head, tile of keys) loops over the
//     H / H_kv query heads of its group and, for each, over the Q tiles from
//     the first that sees the key tile causally. It needs no atomics and no
//     fp32 scratch of the repeated heads.
//
// bf16 at D = 64 and 128 (the main path) runs two kernels built for Hopper
// (flash_sm90.cuh). Both have 3 warpgroups, 384 threads, one block an SM:
// two consumer warpgroups of 64 rows of the output each, and a producer
// warp that loads by TMA. setmaxnreg: producer 24 registers a thread,
// consumers 240 (the block's 168 x 384 in all). Both run their products by
// wgmma m64n64k16 and keep P and dS in registers: the fp32 accumulator is
// rounded to bf16 and packed into the next product's A operand.
//
// dQ (flash_bwd_dq_sm90_kernel) has the forward's shape:
//   * A block owns 128 query rows. The producer loads their Q and dO tiles
//     once, then streams (K, V) tiles of 64 keys of KV head h / rep into a
//     ring of 3 stages, each completed on one mbarrier and released by the
//     consumers' 8 warps on an "empty" mbarrier. Where no row of the block
//     sees a key it issues nothing, and the consumers store zeros.
//   * Per K/V tile, each consumer warpgroup issues S = Q.K^T and
//     dP = dO.V^T (both operands K-major) in one group; computes
//     P = exp2(S * scale * log2(e) - lse * log2(e)) under the masks and
//     dS = P * (dP - delta) * scale on the accumulators, with each thread's
//     two rows of lse and delta read once into registers; then
//     dQ += dS . K with dS as the register A operand and K as the MN-major
//     B operand.
//   * Tiles of 64 keys, not the forward's 128, for the registers: a
//     consumer thread holds dQ (64 fp32 at D = 128, for the block's life),
//     S (32), dP (32) and dS's fragments (16); 128-key tiles would double
//     the last three, to 224 in all before addressing. dQ is rounded to
//     bf16 once and stored from registers.
//   * Under causal, warpgroup 0 sees one key tile fewer than warpgroup 1:
//     it skips that tile's products but still waits for it and releases
//     it, so the ring's phases stay in step.
//   Shared memory at D = 128: Q and dO 64 KB, 3 stages of K and V 96 KB
//   (164,920 bytes with the barriers and the alignment). ptxas: 168
//   registers at entry, no spill, at D = 64 and 128.
//
// dK/dV (flash_bwd_dkv_sm90_kernel):
//   * A block owns 128 keys. The producer warp loads their K and V tiles
//     once, then streams (Q, dO) tiles of 64 rows, with their lse and delta,
//     through a ring of 2 stages on mbarriers.
//   * Everything is computed transposed, so nothing is staged: S^T = K.Q^T
//     and dP^T = V.dO^T (both operands K-major); P^T and dS^T on the
//     accumulators under the masks; then dV += P^T . dO and dK += dS^T . Q
//     with dO and Q as MN-major B operands. dV's product is issued with
//     dP's, so they overlap. lse and delta index the accumulator's columns
//     here, so the producer's lanes bring them into the stage.
//   * The dK and dV accumulators (2 x 64 fp32 a thread at D = 128) stay in
//     registers for the block's life and are stored from there.
//   Shared memory at D = 128: K and V 64 KB, 2 stages of Q and dO 64 KB,
//   lse and delta 1 KB. ptxas (CUDA 12.9): 168 registers at entry, no
//   spill, at D = 64 and 128; a consumer thread holds at most dK, dV (128),
//   S^T (32), its bf16 fragment (16) and dP^T (32) at once.
//
// In both, masks are applied only on tiles that need them (ragged ends, the
// causal diagonal) and by a select; rows and keys past the ends are
// zero-filled by TMA.
//
// fp32 (every head size) and bf16 at D = 32 keep the first design for both
// dQ and dK/dV: one block of 4 warps over tiles of 64 rows, input tiles
// loaded through registers, S and dP staged in shared memory in fp32 for
// the element-wise pass, the accumulators in registers; bf16 products by
// WMMA 16x16x16 and fp32 ones by FMA (no TF32), so fp32 agrees with the
// plain version to fp32 rounding.

#include "flash_common.cuh"
#include "flash_sm90.cuh"

namespace {

using namespace flash;

template <typename T, int D>
struct Ld {
  static constexpr int I = D + Elem<T>::PAD;     // input tiles
  static constexpr int S = TILE + 4;             // fp32 64x64 products
  static constexpr int P = TILE + Elem<T>::PAD;  // P, dS as operands
};

// Shared memory: four input tiles (dq: Q, dO, K, V; dkv: K, V, Q, dO), S and
// dP in fp32, dS (and in dkv P) in T, then lse and delta of 64 query rows.
template <typename T, int D, bool WITH_P>
struct Smem {
  using L = Ld<T, D>;
  static constexpr size_t tile = align128(TILE * L::I * sizeof(T));
  static constexpr size_t t0 = 0, t1 = tile, t2 = 2 * tile, t3 = 3 * tile;
  static constexpr size_t s_off = 4 * tile;
  static constexpr size_t dp_off = s_off + align128(TILE * L::S * sizeof(float));
  static constexpr size_t ds_off = dp_off + align128(TILE * L::S * sizeof(float));
  static constexpr size_t p_off = ds_off + align128(TILE * L::P * sizeof(T));
  static constexpr size_t row_off =
      p_off + (WITH_P ? align128(TILE * L::P * sizeof(T)) : 0);
  static constexpr size_t bytes = row_off + 2 * align128(TILE * sizeof(float));
};

// An fp32 accumulator of 64 x D held in registers for a block's life; warp
// w holds rows 16w .. 16w+15.
template <typename T, int D> struct Accum;

template <int D> struct Accum<bf16, D> {
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> f[D / 16];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int n = 0; n < D / 16; ++n) wmma::fill_fragment(f[n], 0.0f);
  }

  // += A . B for A [64][64] (row-major, lda) and B [64][D] (row-major, ldb).
  __device__ __forceinline__ void add(const bf16* A, int lda, const bf16* B,
                                      int ldb) {
    const int w = threadIdx.x >> 5;
    // One A fragment live at a time: the dK/dV kernel holds two of these
    // accumulators (128 registers at D = 128).
#pragma unroll
    for (int kk = 0; kk < TILE / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::load_matrix_sync(a, A + w * 16 * lda + kk * 16, lda);
#pragma unroll
      for (int n = 0; n < D / 16; ++n) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
        wmma::load_matrix_sync(b, B + kk * 16 * ldb + n * 16, ldb);
        wmma::mma_sync(f[n], a, b, f[n]);
      }
    }
  }

  // Rows row0 + r (r < 64, row0 + r < nrows) to dst[row][0 .. D) in bf16,
  // through the warp's own rows 16w .. of `stage` (fp32, leading dim lds).
  __device__ __forceinline__ void store(bf16* dst, int64_t row_stride,
                                        int row0, int nrows, float* stage,
                                        int lds) {
    const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
    float* st = stage + w * 16 * lds;
    const int r = lane >> 1, c = (lane & 1) * 8, row = row0 + w * 16 + r;
#pragma unroll
    for (int n = 0; n < D / 16; ++n) {
      wmma::store_matrix_sync(st, f[n], lds, wmma::mem_row_major);
      __syncwarp();
      if (row < nrows) {
        alignas(16) bf16 out[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) out[e] = __float2bfloat16(st[r * lds + c + e]);
        *reinterpret_cast<uint4*>(dst + row * row_stride + n * 16 + c) =
            *reinterpret_cast<const uint4*>(out);
      }
      __syncwarp();
    }
  }
};

template <int D> struct Accum<float, D> {
  // Thread (ty, tx) = (tid / 8, tid % 8) holds rows 4ty .. 4ty+3 and
  // columns tx, tx + 8, ...
  static constexpr int NJ = D / 8;
  float a[4][NJ];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) a[i][j] = 0.0f;
  }

  __device__ __forceinline__ void add(const float* A, int lda, const float* B,
                                      int ldb) {
    const int tx = threadIdx.x & 7, ty = threadIdx.x >> 3;
    for (int kk = 0; kk < TILE; ++kk) {
      float x[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) x[i] = A[(ty * 4 + i) * lda + kk];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float y = B[kk * ldb + tx + 8 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i][j] = fmaf(x[i], y, a[i][j]);
      }
    }
  }

  __device__ __forceinline__ void store(float* dst, int64_t row_stride,
                                        int row0, int nrows, float*, int) {
    const int tx = threadIdx.x & 7, ty = threadIdx.x >> 3;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = row0 + ty * 4 + i;
      if (row >= nrows) continue;
#pragma unroll
      for (int j = 0; j < NJ; ++j) dst[row * row_stride + tx + 8 * j] = a[i][j];
    }
  }
};

struct Strides {
  // (batch, seq, head) element strides of q, k, v, dO and the output(s).
  int64_t q_b, q_s, q_h, k_b, k_s, k_h, v_b, v_s, v_h, do_b, do_s, do_h, o_b,
      o_s, o_h;
};

// lse and delta of query rows q0 .. q0+63 of one (b, h); 0 past s_q.
__device__ __forceinline__ void load_rows(float* sLse, float* sDelta,
                                          const float* lse,
                                          const float* delta, int64_t base,
                                          int q0, int S_q) {
  const int i = threadIdx.x;
  if (i < TILE) {
    const bool in = q0 + i < S_q;
    sLse[i] = in ? lse[base + q0 + i] : 0.0f;
    sDelta[i] = in ? delta[base + q0 + i] : 0.0f;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int H, int rep, int S_q, int S_k, Strides st, float scale,
                    int causal) {
  using L = Ld<T, D>;
  using M = Smem<T, D, false>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem + M::t0);
  T* sDO = reinterpret_cast<T*>(smem + M::t1);
  T* sK = reinterpret_cast<T*>(smem + M::t2);
  T* sV = reinterpret_cast<T*>(smem + M::t3);
  float* sS = reinterpret_cast<float*>(smem + M::s_off);
  float* sDP = reinterpret_cast<float*>(smem + M::dp_off);
  T* sDS = reinterpret_cast<T*>(smem + M::ds_off);
  float* sLse = reinterpret_cast<float*>(smem + M::row_off);
  float* sDelta = sLse + align128(TILE * sizeof(float)) / sizeof(float);

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int h = blockIdx.y, b = blockIdx.z, hk = h / rep;
  const int q0 = qt * TILE, tid = threadIdx.x;
  const T* kb = k + b * st.k_b + hk * st.k_h;
  const T* vb = v + b * st.v_b + hk * st.v_h;

  load_tile<T, D>(sQ, L::I, q + b * st.q_b + h * st.q_h, st.q_s, q0, S_q);
  load_tile<T, D>(sDO, L::I, dout + b * st.do_b + h * st.do_h, st.do_s, q0,
                  S_q);
  load_rows(sLse, sDelta, lse, delta, (static_cast<int64_t>(b) * H + h) * S_q,
            q0, S_q);

  const int offset = S_k - S_q;
  int n_kv = (S_k + TILE - 1) / TILE;
  if (causal) {
    const int lim = q0 + TILE + offset;  // one past the last key this tile sees
    n_kv = min(n_kv, lim <= 0 ? 0 : (lim + TILE - 1) / TILE);
  }

  Accum<T, D> acc;
  acc.zero();
  // Element-wise pass: two threads per query row (warp w: rows 16w ..).
  const int row = tid >> 1, half = tid & 1;
  const int qpos = q0 + row + offset;

  for (int j = 0; j < n_kv; ++j) {
    const int k0 = j * TILE;
    __syncthreads();  // the previous tile's dS . K is done with sK
    load_tile<T, D>(sK, L::I, kb, st.k_s, k0, S_k);
    load_tile<T, D>(sV, L::I, vb, st.v_s, k0, S_k);
    __syncthreads();
    tile_abt<T, D>(sQ, sK, L::I, sS, L::S);
    tile_abt<T, D>(sDO, sV, L::I, sDP, L::S);
    __syncwarp();
    const float lse_r = sLse[row], delta_r = sDelta[row];
    const float* srow = sS + row * L::S;
    const float* dprow = sDP + row * L::S;
    T* dsrow = sDS + row * L::P;
#pragma unroll 8
    for (int c = half; c < TILE; c += 2) {
      const int kpos = k0 + c;
      const bool valid = kpos < S_k && (!causal || qpos >= kpos);
      const float p = valid ? __expf(srow[c] * scale - lse_r) : 0.0f;
      dsrow[c] = from_f<T>(p * (dprow[c] - delta_r) * scale);
    }
    __syncwarp();
    acc.add(sDS, L::P, sK, L::I);
  }
  acc.store(dq + b * st.o_b + h * st.o_h, st.o_s, q0, S_q, sS, L::S);
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int H, int rep, int S_q, int S_k,
                     Strides st, float scale, int causal) {
  using L = Ld<T, D>;
  using M = Smem<T, D, true>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sK = reinterpret_cast<T*>(smem + M::t0);
  T* sV = reinterpret_cast<T*>(smem + M::t1);
  T* sQ = reinterpret_cast<T*>(smem + M::t2);
  T* sDO = reinterpret_cast<T*>(smem + M::t3);
  float* sS = reinterpret_cast<float*>(smem + M::s_off);    // S^T [key][q]
  float* sDP = reinterpret_cast<float*>(smem + M::dp_off);  // dP^T
  T* sDS = reinterpret_cast<T*>(smem + M::ds_off);          // dS^T
  T* sP = reinterpret_cast<T*>(smem + M::p_off);            // P^T
  float* sLse = reinterpret_cast<float*>(smem + M::row_off);
  float* sDelta = sLse + align128(TILE * sizeof(float)) / sizeof(float);

  const int kt = blockIdx.x;  // under causal the first key tiles are heaviest
  const int hk = blockIdx.y, b = blockIdx.z;
  const int k0 = kt * TILE, tid = threadIdx.x;
  load_tile<T, D>(sK, L::I, k + b * st.k_b + hk * st.k_h, st.k_s, k0, S_k);
  load_tile<T, D>(sV, L::I, v + b * st.v_b + hk * st.v_h, st.v_s, k0, S_k);

  const int offset = S_k - S_q;
  const int n_q = (S_q + TILE - 1) / TILE;
  // The first Q tile holding a query that sees key k0.
  const int start = causal ? max(k0 - offset, 0) / TILE : 0;

  Accum<T, D> dk_acc, dv_acc;
  dk_acc.zero();
  dv_acc.zero();
  // Element-wise pass: two threads per key row (warp w: keys 16w ..).
  const int krow = tid >> 1, half = tid & 1;
  const int kpos = k0 + krow;

  for (int r = 0; r < rep; ++r) {
    const int h = hk * rep + r;
    const T* qb = q + b * st.q_b + h * st.q_h;
    const T* dob = dout + b * st.do_b + h * st.do_h;
    const int64_t base = (static_cast<int64_t>(b) * H + h) * S_q;
    for (int qi = start; qi < n_q; ++qi) {
      const int q0 = qi * TILE;
      __syncthreads();  // the previous products are done with sQ and sDO
      load_tile<T, D>(sQ, L::I, qb, st.q_s, q0, S_q);
      load_tile<T, D>(sDO, L::I, dob, st.do_s, q0, S_q);
      load_rows(sLse, sDelta, lse, delta, base, q0, S_q);
      __syncthreads();
      tile_abt<T, D>(sK, sQ, L::I, sS, L::S);
      tile_abt<T, D>(sV, sDO, L::I, sDP, L::S);
      __syncwarp();
      const float* srow = sS + krow * L::S;
      const float* dprow = sDP + krow * L::S;
      T* prow = sP + krow * L::P;
      T* dsrow = sDS + krow * L::P;
#pragma unroll 8
      for (int c = half; c < TILE; c += 2) {
        const int qrow = q0 + c;
        const bool valid = qrow < S_q && kpos < S_k &&
                           (!causal || qrow + offset >= kpos);
        const float p = valid ? __expf(srow[c] * scale - sLse[c]) : 0.0f;
        prow[c] = from_f<T>(p);
        dsrow[c] = from_f<T>(p * (dprow[c] - sDelta[c]) * scale);
      }
      __syncwarp();
      dv_acc.add(sP, L::P, sDO, L::I);
      dk_acc.add(sDS, L::P, sQ, L::I);
    }
  }
  const int64_t out = b * st.o_b + hk * st.o_h;
  dk_acc.store(dk + out, st.o_s, k0, S_k, sS, L::S);
  dv_acc.store(dv + out, st.o_s, k0, S_k, sS, L::S);
}

struct Args {
  const void *q, *k, *v, *dout, *lse, *delta;
  void *o0, *o1;  // dq; or dk, dv
  int B, H, H_kv, S_q, S_k;
  Strides st;
  float scale;
  int causal;
  cudaStream_t stream;
};

template <typename T, int D>
cudaError_t launch_dq(const Args& a) {
  auto kern = flash_bwd_dq_kernel<T, D>;
  const int bytes = static_cast<int>(Smem<T, D, false>::bytes);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.S_q + TILE - 1) / TILE, a.H, a.B);
  kern<<<grid, NT, bytes, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<T*>(a.o0), a.H, a.H / a.H_kv, a.S_q, a.S_k, a.st, a.scale,
      a.causal);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const Args& a) {
  auto kern = flash_bwd_dkv_kernel<T, D>;
  const int bytes = static_cast<int>(Smem<T, D, true>::bytes);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.S_k + TILE - 1) / TILE, a.H_kv, a.B);
  kern<<<grid, NT, bytes, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<T*>(a.o0), static_cast<T*>(a.o1), a.H, a.H / a.H_kv, a.S_q,
      a.S_k, a.st, a.scale, a.causal);
  return cudaGetLastError();
}

// -- dK/dV in bf16, D = 64 and 128: wgmma, register accumulators, a ring --

namespace dkv90 {

constexpr int KEYS = 128;   // keys a block (two warpgroups of 64)
constexpr int QROWS = 64;   // query rows a streamed tile
constexpr int STAGES = 2;   // (Q, dO, lse, delta) ring
constexpr int THREADS = 384;

template <int D>
struct SmemKV {
  static constexpr int NB = D / sm90::BOX;
  static constexpr size_t kv_bytes = KEYS * D * sizeof(bf16);
  static constexpr size_t q_bytes = QROWS * D * sizeof(bf16);
  static constexpr size_t v_off = kv_bytes;
  static constexpr size_t q_off = 2 * kv_bytes;
  static constexpr size_t do_off = q_off + STAGES * q_bytes;
  static constexpr size_t row_off = do_off + STAGES * q_bytes;  // lse, delta
  static constexpr size_t bar_off = row_off + STAGES * 2 * QROWS * 4;
  static constexpr size_t bytes = bar_off + (1 + 2 * STAGES) * 8 + 1024;
};

}  // namespace dkv90

template <int D>
__global__ void __launch_bounds__(dkv90::THREADS, 1)
flash_bwd_dkv_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tdo,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta, bf16* __restrict__ dk,
                          bf16* __restrict__ dv, int H, int rep, int S_q,
                          int S_k, int64_t o_b, int64_t o_s, int64_t o_h,
                          float scale, int causal) {
  using namespace dkv90;
  using L = SmemKV<D>;
  constexpr int NB = L::NB, KS = D / 16;
  constexpr int RB = sm90::ROW_BYTES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (sm90::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::bar_off);
  uint64_t* bar_kv = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + STAGES;
  float* rows = reinterpret_cast<float*>(smem + L::row_off);  // [stage][2][64]

  const int hk = blockIdx.y, b = blockIdx.z;
  const int k0 = blockIdx.x * KEYS;  // under causal the first tiles are heaviest
  const int offset = S_k - S_q;
  const int n_q = (S_q + QROWS - 1) / QROWS;
  // The first Q tile holding a query that sees key k0.
  const int start = min(causal ? max(k0 - offset, 0) / QROWS : 0, n_q);
  const int per_head = n_q - start, total = rep * per_head;

  if (threadIdx.x == 0) {
    sm90::bar_init(bar_kv, 1);
    for (int s = 0; s < STAGES; ++s) {
      sm90::bar_init(&full[s], 32);  // the producer warp's lanes
      sm90::bar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    sm90::bar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // Producer: warp 8. Lane 0 issues the copies; every lane brings two
    // rows of lse (times log2(e)) and delta into the stage.
    sm90::regs_dec<24>();
    if (threadIdx.x < 288) {
      const int lane = threadIdx.x & 31;
      if (lane == 0) {
        sm90::bar_arrive_tx(bar_kv, 2 * L::kv_bytes);
        sm90::tma_tile<NB>(smem, &tk, bar_kv, KEYS, hk, k0, b);
        sm90::tma_tile<NB>(smem + L::v_off, &tv, bar_kv, KEYS, hk, k0, b);
      }
      for (int t = 0; t < total; ++t) {
        const int s = t % STAGES, u = t / STAGES;
        const int h = hk * rep + t / per_head;
        const int q0 = (start + t % per_head) * QROWS;
        if (u > 0) sm90::bar_wait(&empty[s], (u - 1) & 1);
        const int64_t base = (static_cast<int64_t>(b) * H + h) * S_q;
        float* sl = rows + s * 2 * QROWS;
        for (int i = lane; i < QROWS; i += 32) {
          const bool in = q0 + i < S_q;
          sl[i] = in ? lse[base + q0 + i] * sm90::LOG2E : 0.0f;
          sl[QROWS + i] = in ? delta[base + q0 + i] : 0.0f;
        }
        if (lane == 0) {
          sm90::bar_arrive_tx(&full[s], 2 * L::q_bytes);
          sm90::tma_tile<NB>(smem + L::q_off + s * L::q_bytes, &tq, &full[s],
                             QROWS, h, q0, b);
          sm90::tma_tile<NB>(smem + L::do_off + s * L::q_bytes, &tdo,
                             &full[s], QROWS, h, q0, b);
        } else {
          sm90::bar_arrive(&full[s]);
        }
      }
    }
  } else {
    // Consumers: warpgroup wg owns keys k0 + 64 wg .. + 63.
    sm90::regs_inc<240>();
    const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
    const int kw0 = k0 + wg * 64;
    const int krow0 = kw0 + warp * 16 + (lane >> 2);  // and krow0 + 8
    const float scale_log2 = scale * sm90::LOG2E;
    float dK[NB][32], dV[NB][32];
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int i = 0; i < 32; ++i) dK[n][i] = dV[n][i] = 0.0f;
    const unsigned char* ka = smem + wg * 64 * RB;
    const unsigned char* va = smem + L::v_off + wg * 64 * RB;

    sm90::bar_wait(bar_kv, 0);
    for (int t = 0; t < total; ++t) {
      const int s = t % STAGES, u = t / STAGES;
      const int q0 = (start + t % per_head) * QROWS;
      const unsigned char* sq = smem + L::q_off + s * L::q_bytes;
      const unsigned char* sdo = smem + L::do_off + s * L::q_bytes;
      const float* sl = rows + s * 2 * QROWS;
      sm90::bar_wait(&full[s], u & 1);

      // S^T = K . Q^T (64 keys x 64 queries).
      float St[32];
      sm90::wg_fence();
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
        sm90::mma_ss(St,
                     sm90::desc(ka + (ks / 4) * KEYS * RB + (ks % 4) * 32, 0),
                     sm90::desc(sq + (ks / 4) * QROWS * RB + (ks % 4) * 32, 0),
                     ks > 0);
      sm90::wg_commit();
      sm90::wg_wait<0>();
      sm90::reg_fence(St);

      // P^T under the masks, then its bf16 fragments.
      const bool masked = kw0 + 64 > S_k || q0 + QROWS > S_q ||
                          (causal && q0 + offset < kw0 + 63);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int qc = sm90::acc_col(i);
        float p = sm90::fast_exp2(St[i] * scale_log2 - sl[qc]);
        if (masked) {
          const int key = krow0 + 8 * ((i >> 1) & 1), qpos = q0 + qc;
          const bool valid = key < S_k && qpos < S_q &&
                             (!causal || qpos + offset >= key);
          p = valid ? p : 0.0f;
        }
        St[i] = p;
      }
      uint32_t Pa[16];
      sm90::to_a_frags(St, Pa);

      // dP^T = V . dO^T, and dV += P^T . dO, in one group.
      float dPt[32];
#pragma unroll
      for (int n = 0; n < NB; ++n) sm90::reg_fence(dV[n]);
      sm90::reg_fence(Pa);
      sm90::wg_fence();
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
        sm90::mma_ss(dPt,
                     sm90::desc(va + (ks / 4) * KEYS * RB + (ks % 4) * 32, 0),
                     sm90::desc(sdo + (ks / 4) * QROWS * RB + (ks % 4) * 32, 0),
                     ks > 0);
#pragma unroll
      for (int kb = 0; kb < QROWS / 16; ++kb)
#pragma unroll
        for (int n = 0; n < NB; ++n)
          sm90::mma_rs(dV[n], &Pa[4 * kb],
                       sm90::desc(sdo + n * QROWS * RB + kb * 16 * RB,
                                  QROWS * RB));
      sm90::wg_commit();
      sm90::wg_wait<0>();
      sm90::reg_fence(dPt);
#pragma unroll
      for (int n = 0; n < NB; ++n) sm90::reg_fence(dV[n]);

      // dS^T = P^T * (dP^T - delta) * scale; dK += dS^T . Q.
#pragma unroll
      for (int i = 0; i < 32; ++i)
        dPt[i] = St[i] * (dPt[i] - sl[QROWS + sm90::acc_col(i)]) * scale;
      uint32_t Da[16];
      sm90::to_a_frags(dPt, Da);
#pragma unroll
      for (int n = 0; n < NB; ++n) sm90::reg_fence(dK[n]);
      sm90::reg_fence(Da);
      sm90::wg_fence();
#pragma unroll
      for (int kb = 0; kb < QROWS / 16; ++kb)
#pragma unroll
        for (int n = 0; n < NB; ++n)
          sm90::mma_rs(dK[n], &Da[4 * kb],
                       sm90::desc(sq + n * QROWS * RB + kb * 16 * RB,
                                  QROWS * RB));
      sm90::wg_commit();
      sm90::wg_wait<0>();
#pragma unroll
      for (int n = 0; n < NB; ++n) sm90::reg_fence(dK[n]);
      if (lane == 0) sm90::bar_arrive(&empty[s]);
    }

    bf16* dkb = dk + b * o_b + hk * o_h;
    bf16* dvb = dv + b * o_b + hk * o_h;
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int key = krow0 + 8 * ((i >> 1) & 1);
        if (key >= S_k) continue;
        const int64_t at = key * o_s + n * sm90::BOX + sm90::acc_col(i);
        *reinterpret_cast<__nv_bfloat162*>(dkb + at) =
            __floats2bfloat162_rn(dK[n][i], dK[n][i + 1]);
        *reinterpret_cast<__nv_bfloat162*>(dvb + at) =
            __floats2bfloat162_rn(dV[n][i], dV[n][i + 1]);
      }
  }
}

template <int D>
cudaError_t launch_dkv_sm90(const Args& a) {
  using namespace dkv90;
  const Strides& st = a.st;
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t err;
  if ((err = sm90::make_map(&tq, a.q, a.B, a.S_q, a.H, D, st.q_b, st.q_s,
                            st.q_h, QROWS)) != cudaSuccess ||
      (err = sm90::make_map(&tk, a.k, a.B, a.S_k, a.H_kv, D, st.k_b, st.k_s,
                            st.k_h, KEYS)) != cudaSuccess ||
      (err = sm90::make_map(&tv, a.v, a.B, a.S_k, a.H_kv, D, st.v_b, st.v_s,
                            st.v_h, KEYS)) != cudaSuccess ||
      (err = sm90::make_map(&tdo, a.dout, a.B, a.S_q, a.H, D, st.do_b,
                            st.do_s, st.do_h, QROWS)) != cudaSuccess)
    return err;
  auto kern = flash_bwd_dkv_sm90_kernel<D>;
  const int bytes = static_cast<int>(SmemKV<D>::bytes);
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.S_k + KEYS - 1) / KEYS, a.H_kv, a.B);
  kern<<<grid, THREADS, bytes, a.stream>>>(
      tq, tk, tv, tdo, static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<bf16*>(a.o0),
      static_cast<bf16*>(a.o1), a.H, a.H / a.H_kv, a.S_q, a.S_k, a.st.o_b,
      a.st.o_s, a.st.o_h, a.scale, a.causal);
  return cudaGetLastError();
}

// -- dQ in bf16, D = 64 and 128: wgmma, register accumulators, a K/V ring --

namespace dq90 {

constexpr int QROWS = 128;  // query rows a block (two warpgroups of 64)
constexpr int KROWS = 64;   // keys a streamed tile
constexpr int STAGES = 3;   // (K, V) ring
constexpr int THREADS = 384;

template <int D>
struct SmemQ {
  static constexpr int NB = D / sm90::BOX;
  static constexpr size_t q_bytes = QROWS * D * sizeof(bf16);
  static constexpr size_t kv_bytes = KROWS * D * sizeof(bf16);
  static constexpr size_t do_off = q_bytes;
  static constexpr size_t k_off = 2 * q_bytes;
  static constexpr size_t v_off = k_off + STAGES * kv_bytes;
  static constexpr size_t bar_off = v_off + STAGES * kv_bytes;
  static constexpr size_t bytes = bar_off + (1 + 2 * STAGES) * 8 + 1024;
};

}  // namespace dq90

template <int D>
__global__ void __launch_bounds__(dq90::THREADS, 1)
flash_bwd_dq_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const __grid_constant__ CUtensorMap tdo,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         bf16* __restrict__ dq, int H, int rep, int S_q,
                         int S_k, int64_t o_b, int64_t o_s, int64_t o_h,
                         float scale, int causal) {
  using namespace dq90;
  using L = SmemQ<D>;
  constexpr int NB = L::NB, KS = D / 16;
  constexpr int RB = sm90::ROW_BYTES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (sm90::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::bar_off);
  uint64_t* bar_q = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + STAGES;

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
      sm90::bar_init(&full[s], 1);
      sm90::bar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    sm90::bar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // Producer: one thread issues every copy of the block, and none where
    // no row of the block sees a key (the consumers then store zeros).
    sm90::regs_dec<24>();
    if (threadIdx.x == 256 && n_kv > 0) {
      sm90::bar_arrive_tx(bar_q, 2 * L::q_bytes);
      sm90::tma_tile<NB>(smem, &tq, bar_q, QROWS, h, q0, b);
      sm90::tma_tile<NB>(smem + L::do_off, &tdo, bar_q, QROWS, h, q0, b);
      for (int j = 0; j < n_kv; ++j) {
        const int s = j % STAGES, u = j / STAGES;
        if (u > 0) sm90::bar_wait(&empty[s], (u - 1) & 1);
        sm90::bar_arrive_tx(&full[s], 2 * L::kv_bytes);
        sm90::tma_tile<NB>(smem + L::k_off + s * L::kv_bytes, &tk, &full[s],
                           KROWS, hk, j * KROWS, b);
        sm90::tma_tile<NB>(smem + L::v_off + s * L::kv_bytes, &tv, &full[s],
                           KROWS, hk, j * KROWS, b);
      }
    }
  } else {
    // Consumers: warpgroup wg owns query rows q0 + 64 wg .. + 63.
    sm90::regs_inc<240>();
    const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
    const int qw0 = q0 + wg * 64;
    const int row0 = qw0 + warp * 16 + (lane >> 2);  // and row0 + 8
    const float scale_log2 = scale * sm90::LOG2E;
    // Under causal, warpgroup 0 sees one K/V tile fewer than the block
    // loads (or none); it still waits for that tile and releases it, so
    // the ring's phases stay in step.
    int mine = n_kv;
    if (causal) {
      const int lim = qw0 + 64 + offset;
      mine = min(n_kv, lim <= 0 ? 0 : (lim + KROWS - 1) / KROWS);
    }
    // lse (times log2(e)) and delta of the thread's two rows; 0 past S_q,
    // where Q and dO are zero-filled, so dS is 0 there.
    float lse2[2], dlt[2];
    const int64_t base = (static_cast<int64_t>(b) * H + h) * S_q;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      lse2[r] = row < S_q ? lse[base + row] * sm90::LOG2E : 0.0f;
      dlt[r] = row < S_q ? delta[base + row] : 0.0f;
    }
    float dQ[NB][32];
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int i = 0; i < 32; ++i) dQ[n][i] = 0.0f;
    const unsigned char* qa = smem + wg * 64 * RB;
    const unsigned char* doa = smem + L::do_off + wg * 64 * RB;

    if (n_kv > 0) sm90::bar_wait(bar_q, 0);
    for (int j = 0; j < n_kv; ++j) {
      const int s = j % STAGES, u = j / STAGES, k0 = j * KROWS;
      const unsigned char* sK = smem + L::k_off + s * L::kv_bytes;
      const unsigned char* sV = smem + L::v_off + s * L::kv_bytes;
      sm90::bar_wait(&full[s], u & 1);
      if (j < mine) {
        // S = Q . K^T and dP = dO . V^T (64 rows x 64 keys), one group.
        float S[32], dP[32];
        sm90::wg_fence();
#pragma unroll
        for (int ks = 0; ks < KS; ++ks)
          sm90::mma_ss(S,
                       sm90::desc(qa + (ks / 4) * QROWS * RB + (ks % 4) * 32, 0),
                       sm90::desc(sK + (ks / 4) * KROWS * RB + (ks % 4) * 32, 0),
                       ks > 0);
#pragma unroll
        for (int ks = 0; ks < KS; ++ks)
          sm90::mma_ss(dP,
                       sm90::desc(doa + (ks / 4) * QROWS * RB + (ks % 4) * 32,
                                  0),
                       sm90::desc(sV + (ks / 4) * KROWS * RB + (ks % 4) * 32, 0),
                       ks > 0);
        sm90::wg_commit();
        sm90::wg_wait<0>();
        sm90::reg_fence(S);
        sm90::reg_fence(dP);

        // dS = P * (dP - delta) * scale, P under the masks (a select: a
        // row that sees no key has exp2 of ~1e30 here).
        const bool masked =
            k0 + KROWS > S_k || (causal && qw0 + offset < k0 + KROWS - 1);
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int r = (i >> 1) & 1;
          float p = sm90::fast_exp2(S[i] * scale_log2 - lse2[r]);
          if (masked) {
            const int kpos = k0 + sm90::acc_col(i);
            const bool valid =
                kpos < S_k && (!causal || row0 + 8 * r + offset >= kpos);
            p = valid ? p : 0.0f;
          }
          dP[i] = p * (dP[i] - dlt[r]) * scale;
        }
        uint32_t Da[16];
        sm90::to_a_frags(dP, Da);

        // dQ += dS . K, K as the MN-major B operand.
#pragma unroll
        for (int n = 0; n < NB; ++n) sm90::reg_fence(dQ[n]);
        sm90::reg_fence(Da);
        sm90::wg_fence();
#pragma unroll
        for (int kb = 0; kb < KROWS / 16; ++kb)
#pragma unroll
          for (int n = 0; n < NB; ++n)
            sm90::mma_rs(dQ[n], &Da[4 * kb],
                         sm90::desc(sK + n * KROWS * RB + kb * 16 * RB,
                                    KROWS * RB));
        sm90::wg_commit();
        sm90::wg_wait<0>();
#pragma unroll
        for (int n = 0; n < NB; ++n) sm90::reg_fence(dQ[n]);
      }
      if (lane == 0) sm90::bar_arrive(&empty[s]);
    }

    bf16* dqb = dq + b * o_b + h * o_h;
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int row = row0 + 8 * ((i >> 1) & 1);
        if (row < S_q)
          *reinterpret_cast<__nv_bfloat162*>(
              dqb + row * o_s + n * sm90::BOX + sm90::acc_col(i)) =
              __floats2bfloat162_rn(dQ[n][i], dQ[n][i + 1]);
      }
  }
}

template <int D>
cudaError_t launch_dq_sm90(const Args& a) {
  using namespace dq90;
  const Strides& st = a.st;
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t err;
  if ((err = sm90::make_map(&tq, a.q, a.B, a.S_q, a.H, D, st.q_b, st.q_s,
                            st.q_h, QROWS)) != cudaSuccess ||
      (err = sm90::make_map(&tk, a.k, a.B, a.S_k, a.H_kv, D, st.k_b, st.k_s,
                            st.k_h, KROWS)) != cudaSuccess ||
      (err = sm90::make_map(&tv, a.v, a.B, a.S_k, a.H_kv, D, st.v_b, st.v_s,
                            st.v_h, KROWS)) != cudaSuccess ||
      (err = sm90::make_map(&tdo, a.dout, a.B, a.S_q, a.H, D, st.do_b,
                            st.do_s, st.do_h, QROWS)) != cudaSuccess)
    return err;
  auto kern = flash_bwd_dq_sm90_kernel<D>;
  const int bytes = static_cast<int>(SmemQ<D>::bytes);
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.S_q + QROWS - 1) / QROWS, a.H, a.B);
  kern<<<grid, THREADS, bytes, a.stream>>>(
      tq, tk, tv, tdo, static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<bf16*>(a.o0), a.H,
      a.H / a.H_kv, a.S_q, a.S_k, a.st.o_b, a.st.o_s, a.st.o_h, a.scale,
      a.causal);
  return cudaGetLastError();
}

// dQ: bf16 at D = 64 and 128 takes the sm90 kernel; fp32, and bf16 at
// D = 32, the first design.
cudaError_t dispatch_dq(int is_bf16, int D, const Args& a) {
  switch (D) {
    case 32: return is_bf16 ? launch_dq<bf16, 32>(a) : launch_dq<float, 32>(a);
    case 64: return is_bf16 ? launch_dq_sm90<64>(a) : launch_dq<float, 64>(a);
    case 128:
      return is_bf16 ? launch_dq_sm90<128>(a) : launch_dq<float, 128>(a);
    default: return cudaErrorInvalidValue;
  }
}

// dK/dV: bf16 at D = 64 and 128 takes the sm90 kernel; fp32, and bf16 at
// D = 32, the first design.
cudaError_t dispatch_dkv(int is_bf16, int D, const Args& a) {
  switch (D) {
    case 32: return is_bf16 ? launch_dkv<bf16, 32>(a) : launch_dkv<float, 32>(a);
    case 64: return is_bf16 ? launch_dkv_sm90<64>(a) : launch_dkv<float, 64>(a);
    case 128:
      return is_bf16 ? launch_dkv_sm90<128>(a) : launch_dkv<float, 128>(a);
    default: return cudaErrorInvalidValue;
  }
}

Args make_args(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* o0, void* o1, int B,
               int H, int H_kv, int S_q, int S_k, const int64_t* s,
               float scale, int causal, void* stream) {
  return Args{q, k, v, dout, lse, delta, o0, o1, B, H, H_kv, S_q, S_k,
              Strides{s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8],
                      s[9], s[10], s[11], s[12], s[13], s[14]},
              scale, causal, static_cast<cudaStream_t>(stream)};
}

}  // namespace

// Plain C interface for ctypes. `strides` holds 15 element strides: (batch,
// seq, head) for q, k, v, dO and the output (dq; or dk, which dv shares), in
// that order; the head dimension must be contiguous and every stride a
// multiple of 16 bytes. lse and delta are contiguous fp32 [B, H, S_q].
// Each launches on `stream`, does not synchronise, and returns
// cudaGetLastError() after the launch.
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, void* dq, int is_bf16, int B,
                            int H, int H_kv, int S_q, int S_k, int D,
                            const int64_t* strides, float scale, int causal,
                            void* stream) {
  const Args a = make_args(q, k, v, dout, lse, delta, dq, nullptr, B, H, H_kv,
                           S_q, S_k, strides, scale, causal, stream);
  return dispatch_dq(is_bf16, D, a);
}

extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, void* dk, void* dv,
                             int is_bf16, int B, int H, int H_kv, int S_q,
                             int S_k, int D, const int64_t* strides,
                             float scale, int causal, void* stream) {
  const Args a = make_args(q, k, v, dout, lse, delta, dk, dv, B, H, H_kv, S_q,
                           S_k, strides, scale, causal, stream);
  return dispatch_dkv(is_bf16, D, a);
}

// Which design each backward entry point launches for (dtype, D):
// "wgmma" (the sm90 kernels), "wmma" or "fma" (the first design).
extern "C" const char* flash_bwd_dq_variant(int is_bf16, int D) {
  if (!is_bf16) return "fma";
  return D == 64 || D == 128 ? "wgmma" : "wmma";
}

extern "C" const char* flash_bwd_dkv_variant(int is_bf16, int D) {
  if (!is_bf16) return "fma";
  return D == 64 || D == 128 ? "wgmma" : "wmma";
}

// Dynamic shared memory a block of the sm90 dQ or dK/dV kernel takes at
// head size D (0 where the entry point launches another design).
extern "C" int flash_bwd_dq_smem_bytes(int is_bf16, int D) {
  if (!is_bf16) return 0;
  if (D == 64) return static_cast<int>(dq90::SmemQ<64>::bytes);
  if (D == 128) return static_cast<int>(dq90::SmemQ<128>::bytes);
  return 0;
}

extern "C" int flash_bwd_dkv_smem_bytes(int is_bf16, int D) {
  if (!is_bf16) return 0;
  if (D == 64) return static_cast<int>(dkv90::SmemKV<64>::bytes);
  if (D == 128) return static_cast<int>(dkv90::SmemKV<128>::bytes);
  return 0;
}

extern "C" const char* flash_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
