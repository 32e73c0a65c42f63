// flash_bwd: causal / banded flash-attention backward for Hopper (sm_90a).
//
// Two kernels, flash_bwd_dq and flash_bwd_dkv, together replace the JAX
// package's four Pallas backward kernels, which compute the same function
// and differ only in how they stage K/V (or Q/dO) through a TPU's VMEM:
//   K3  sharetrade_tpu/ops/attention.py  _flash_bwd_dq_kernel      (line 375)
//   K4  sharetrade_tpu/ops/attention.py  _flash_bwd_dkv_kernel     (line 423)
//   K5  sharetrade_tpu/ops/attention.py  _flash_banded_dq_kernel   (line 476)
//   K6  sharetrade_tpu/ops/attention.py  _flash_banded_dkv_kernel  (line 514)
// A block loops over exactly the tiles its band can see, so the full-K/V
// versus streaming split (a VMEM capacity rule) has no counterpart here, and
// nothing is padded: the 128-lane head padding and the (8, T) sublane
// broadcast of lse/delta are Mosaic's rules.
//
// Function (contiguous, bh = batch * heads; the forward's arguments):
//   q, dO (bh, tq, D), k, v (bh, tk, D) in bf16 or f32, D in {64, 128};
//   lse, delta (bh, tq) f32, delta = rowsum(dO * O) computed by the caller.
//   Key c is visible to row r when c < tk and, if causal, r - window < c <= r.
//   p  = visible ? exp(q.k * scale - lse) : 0              (f32)
//   dp = dO . v                                            (f32)
//   ds = round(p * (dp - delta) * scale)   to the input dtype
//   dq = sum_c ds . k                      written in the input dtype
//   dv = sum_r round(p)^T . dO             round to dO's dtype first
//   dk = sum_r ds^T . q
// Products and sums in f32 (never TF32); the rounding points are
// those of the Pallas kernels (attention.py:415, :464-467), and the score is
// scaled by a separate multiply (__fmul_rn: never contracted into the
// subtraction of lse). A row that sees no key contributes nothing.
//
// What bounds it on an H100: at the training replay shape (bh = 2,
// T = 1424, D = 128, window 201, bf16) q, k, v, dO, dq, dk, dv are 7 x
// 729,088 B = 5.1 MB plus lse and delta, about 1.5 us at 3.35 TB/s; the
// band holds 266,124 (row, key) pairs per head, and each pair costs 7
// products of 2 x D FLOP (S, dP, dQ in one kernel; S, dP, dV, dK in the
// other): about 0.95 GFLOP, about 1 us at the 989 TFLOP/s bf16
// tensor-core rate. So on paper it is memory-bound, and at this size
// latency and the 46 blocks (2 x 23 tiles) on 132 SMs dominate.
//
// flash_bwd_dq, bf16 (the training path), wgmma + TMA (hopper.cuh), the
// key loop split across a thread-block cluster:
//   - one warpgroup (128 threads) per (bh, 64-row query tile, rank); Q and
//     dO are loaded once by TMA; K and V go through a 2-stage ring (one
//     mbarrier per tile), thread 0 issuing the next key tile's loads
//     before the block computes on the current one; lse and delta of the
//     thread's two fragment rows sit in registers;
//   - S = Q K^T and dP = dO V^T are wgmmas (all operands K-major in shared
//     memory), in flight together; P = exp(S * scale - lse) and
//     dS = round(P (dP - delta) scale) are formed on the accumulator
//     fragments (P is never rounded; the mask is on scores only, since TMA
//     zero-fills ragged rows);
//   - dQ += dS K is a wgmma with A = dS from registers (the fragments
//     rounded to bf16 pairs) and B = the K tile read transposed (MN-major):
//     no dS goes through shared memory, and dQ (D / 2 f32 a thread) stays
//     in registers for the whole loop. 97 KB of shared memory at D = 128,
//     two blocks per SM;
//   - what bounds it at the replay shape is latency, not bytes or
//     products: 46 query tiles for 132 SMs, each walking up to 5 key tiles
//     of the 201-wide band one after another (~2.5 us each). So the
//     launcher splits each tile's key loop over a cluster of c = 2 blocks
//     where the widest band holds 2 key tiles or more and the whole grid
//     stays resident at once (dq_cluster, by
//     cudaOccupancyMaxActiveClusters), else c = 1: rank r takes key tiles
//     r, r + c, ...; rank 1 parks its f32 dQ in its own K ring, and after a
//     cluster barrier rank 0 reads it through distributed shared memory
//     (mapa + ld.shared::cluster, 16 bytes a load), adds it, rounds and
//     stores; a second barrier keeps the peer alive until it has read it.
//     One launch, no atomics and no workspace: deterministic for a given
//     shape and card.
// flash_bwd_dkv, bf16 (the training path), wgmma + TMA (hopper.cuh):
//   - one warpgroup (128 threads) per (bh, 64-row key tile); K and V are
//     loaded once by TMA; for each query tile of the band, Q and dO go
//     through a 2-stage ring (one mbarrier per tile), thread 0 issuing the
//     next tile's loads before the block computes on the current one, and
//     the next tile's lse and delta are read into registers and parked in
//     shared memory behind the current tile's products;
//   - S^T = K Q^T and dP^T = V dO^T are wgmmas (all operands K-major in
//     shared memory); P^T = exp(S^T * scale - lse[query]) and
//     dS^T = round(P^T * (dP^T - delta[query]) * scale) are formed on the
//     accumulator fragments;
//   - dV += round(P^T) dO and dK += dS^T Q are wgmmas with A from
//     registers (the fragments rounded to bf16 pairs) and B = dO or Q read
//     transposed (MN-major): no P^T or dS^T goes through shared memory;
//   - each block owns its key rows, so no atomics: deterministic. 98 KB of
//     shared memory at D = 128; dK and dV (64 + 64 f32 registers a thread
//     at D = 128) stay in registers for the whole loop.
// float32 runs SIMT FMA loops on f32 tiles in shared memory (one block of
// 256 threads per 64-row tile) in both kernels: wgmma on f32 would be
// TF32, and the f32 backward is held bit for bit to the plain one.
// Left on the table: the same cluster split of dkv's query loop (46 blocks
// at the replay shape too); warp-specialised persistent blocks.

#include "hopper.cuh"

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kBlock = 64;      // rows of every tile (query and key)
constexpr int kThreads = 256;   // 16 x 16: thread (ty, tx)
constexpr int kPad = 4;         // row padding in floats (keeps float4 aligned)

template <int D>
struct Layout {
  static constexpr int kRow = D + kPad;          // Q / dO / K / V row stride
  static constexpr int kPRow = kBlock + kPad;    // P / dS row stride
  static constexpr int kTile = kBlock * kRow;
  // dq: q, dO, k, v tiles + dS.   dkv: k, v, q, dO tiles + P/dS + lse, delta.
  static constexpr size_t kDqBytes =
      sizeof(float) * (4 * kTile + kBlock * kPRow);
  static constexpr size_t kDkvBytes =
      sizeof(float) * (4 * kTile + kBlock * kPRow + 2 * kBlock);
};

__device__ __forceinline__ void load_vec(const float* src, float* dst) {
  const float4 v = *reinterpret_cast<const float4*>(src);
  dst[0] = v.x; dst[1] = v.y; dst[2] = v.z; dst[3] = v.w;
}

// Copy rows [row0, row0 + 64) of a (rows, D) f32 matrix into shared memory,
// zero-filling rows at or past `rows`. 16-byte vector loads.
template <int D>
__device__ __forceinline__ void load_tile(const float* __restrict__ base,
                                          int row0, int rows,
                                          float* __restrict__ tile) {
  constexpr int kPerRow = D / 4;
  constexpr int kRow = Layout<D>::kRow;
  for (int v = threadIdx.x; v < kBlock * kPerRow; v += kThreads) {
    const int r = v / kPerRow;
    const int c = (v % kPerRow) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < rows)
      val = *reinterpret_cast<const float4*>(base + static_cast<int64_t>(row0 + r) * D + c);
    *reinterpret_cast<float4*>(tile + r * kRow + c) = val;
  }
}

__device__ __forceinline__ bool visible(int row, int col, int tq, int tk,
                                        int causal, int window) {
  bool ok = row < tq && col < tk;
  if (causal) ok = ok && col <= row && col > row - window;
  return ok;
}

// acc[i][c] += sum_kk a_s[(ty*4+i)][kk] * b_s[kk][tx*4 + 64*m + e]: the
// (64 x 64) x (64 x D) product both kernels accumulate, P-layout a_s.
template <int D>
__device__ __forceinline__ void accumulate(const float* __restrict__ a_s,
                                           const float* __restrict__ b_s,
                                           int ty, int tx,
                                           float (&acc)[4][D / 16]) {
  constexpr int kRow = Layout<D>::kRow;
  constexpr int kPRow = Layout<D>::kPRow;
  constexpr int kCols = D / 16;
#pragma unroll 2
  for (int kk = 0; kk < kBlock; kk += 4) {
    float av[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) load_vec(a_s + (ty * 4 + i) * kPRow + kk, av[i]);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float bv[kCols];
#pragma unroll
      for (int m = 0; m < kCols / 4; ++m)
        load_vec(b_s + (kk + e) * kRow + tx * 4 + 64 * m, bv + 4 * m);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[i][c] = fmaf(av[i][e], bv[c], acc[i][c]);
    }
  }
}

// x[i][j] = sum_d a_s[ty*4+i][d] * b_s[tx+16j][d] and
// y[i][j] = sum_d c_s[ty*4+i][d] * e_s[tx+16j][d]: two 4 x 4 score tiles.
template <int D>
__device__ __forceinline__ void two_scores(const float* __restrict__ a_s,
                                           const float* __restrict__ b_s,
                                           const float* __restrict__ c_s,
                                           const float* __restrict__ e_s,
                                           int ty, int tx, float (&x)[4][4],
                                           float (&y)[4][4]) {
  constexpr int kRow = Layout<D>::kRow;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) x[i][j] = y[i][j] = 0.f;
#pragma unroll 2
  for (int d = 0; d < D; d += 4) {
    float av[4][4], bv[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) load_vec(a_s + (ty * 4 + i) * kRow + d, av[i]);
#pragma unroll
    for (int j = 0; j < 4; ++j) load_vec(b_s + (tx + 16 * j) * kRow + d, bv[j]);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) x[i][j] = fmaf(av[i][e], bv[j][e], x[i][j]);
#pragma unroll
    for (int i = 0; i < 4; ++i) load_vec(c_s + (ty * 4 + i) * kRow + d, av[i]);
#pragma unroll
    for (int j = 0; j < 4; ++j) load_vec(e_s + (tx + 16 * j) * kRow + d, bv[j]);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) y[i][j] = fmaf(av[i][e], bv[j][e], y[i][j]);
  }
}

template <int D>
__device__ __forceinline__ void store_rows(float* __restrict__ out, int row0,
                                           int rows, int ty, int tx,
                                           const float (&acc)[4][D / 16]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty * 4 + i;
    if (row >= rows) continue;
    float* orow = out + static_cast<int64_t>(row) * D;
#pragma unroll
    for (int m = 0; m < D / 64; ++m)
      *reinterpret_cast<float4*>(orow + tx * 4 + 64 * m) = make_float4(
          acc[i][4 * m], acc[i][4 * m + 1], acc[i][4 * m + 2], acc[i][4 * m + 3]);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_simt(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, float* __restrict__ dq,
                  int tq, int tk, int causal, int window, float sm_scale) {
  extern __shared__ float4 smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw);
  constexpr int kTile = Layout<D>::kTile;
  constexpr int kPRow = Layout<D>::kPRow;
  float* q_s = smem;
  float* do_s = q_s + kTile;
  float* k_s = do_s + kTile;
  float* v_s = k_s + kTile;
  float* ds_s = v_s + kTile;

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kBlock;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int64_t qoff = static_cast<int64_t>(bh) * tq;
  const int64_t koff = static_cast<int64_t>(bh) * tk;

  const int q_last = min(q0 + kBlock, tq) - 1;
  int k_lo = 0;
  int k_hi = tk - 1;
  if (causal) {
    k_hi = min(k_hi, q_last);
    k_lo = max(0, q0 - window + 1);
  }

  float lse_i[4], delta_i[4], acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    lse_i[i] = row < tq ? lse[qoff + row] : 0.f;
    delta_i[i] = row < tq ? delta[qoff + row] : 0.f;
#pragma unroll
    for (int c = 0; c < D / 16; ++c) acc[i][c] = 0.f;
  }

  load_tile<D>(q + qoff * D, q0, tq, q_s);
  load_tile<D>(dout + qoff * D, q0, tq, do_s);

  if (k_lo <= k_hi) {
    for (int kt = k_lo / kBlock; kt <= k_hi / kBlock; ++kt) {
      const int k0 = kt * kBlock;
      __syncthreads();                 // previous tile's K, V, dS are free
      load_tile<D>(k + koff * D, k0, tk, k_s);
      load_tile<D>(v + koff * D, k0, tk, v_s);
      __syncthreads();

      float s[4][4], dp[4][4];
      two_scores<D>(q_s, k_s, do_s, v_s, ty, tx, s, dp);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = q0 + ty * 4 + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = k0 + tx + 16 * j;
          const float p = visible(row, col, tq, tk, causal, window)
                              ? expf(__fmul_rn(s[i][j], sm_scale) - lse_i[i]) : 0.f;
          ds_s[(ty * 4 + i) * kPRow + tx + 16 * j] =
              p * (dp[i][j] - delta_i[i]) * sm_scale;
        }
      }
      __syncthreads();                 // dS ready
      accumulate<D>(ds_s, k_s, ty, tx, acc);
    }
  }
  store_rows<D>(dq + qoff * D, q0, tq, ty, tx, acc);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_simt(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, float* __restrict__ dk,
                   float* __restrict__ dv, int tq, int tk, int causal,
                   int window, float sm_scale) {
  extern __shared__ float4 smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw);
  constexpr int kTile = Layout<D>::kTile;
  constexpr int kPRow = Layout<D>::kPRow;
  float* k_s = smem;
  float* v_s = k_s + kTile;
  float* q_s = v_s + kTile;
  float* do_s = q_s + kTile;
  float* p_s = do_s + kTile;                 // P^T, then dS^T (key-major)
  float* lse_s = p_s + kBlock * kPRow;
  float* delta_s = lse_s + kBlock;

  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * kBlock;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int64_t qoff = static_cast<int64_t>(bh) * tq;
  const int64_t koff = static_cast<int64_t>(bh) * tk;

  // Query rows that can see a key of this tile.
  const int k_last = min(k0 + kBlock, tk) - 1;
  int q_lo = 0;
  int q_hi = tq - 1;
  if (causal) {
    q_lo = k0;
    q_hi = min(q_hi, k_last + window - 1);
  }

  float acc_k[4][D / 16], acc_v[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < D / 16; ++c) acc_k[i][c] = acc_v[i][c] = 0.f;

  load_tile<D>(k + koff * D, k0, tk, k_s);
  load_tile<D>(v + koff * D, k0, tk, v_s);

  if (q_lo <= q_hi) {
    for (int qt = q_lo / kBlock; qt <= q_hi / kBlock; ++qt) {
      const int q0 = qt * kBlock;
      __syncthreads();                 // previous tile's Q, dO, P are free
      load_tile<D>(q + qoff * D, q0, tq, q_s);
      load_tile<D>(dout + qoff * D, q0, tq, do_s);
      if (threadIdx.x < kBlock) {
        const int row = q0 + threadIdx.x;
        lse_s[threadIdx.x] = row < tq ? lse[qoff + row] : 0.f;
        delta_s[threadIdx.x] = row < tq ? delta[qoff + row] : 0.f;
      }
      __syncthreads();

      // S^T and dP^T: keys ty*4 + i, query rows tx + 16*j.
      float s[4][4], dp[4][4], ds[4][4];
      two_scores<D>(k_s, q_s, v_s, do_s, ty, tx, s, dp);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = k0 + ty * 4 + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = tx + 16 * j;
          const float p = visible(q0 + r, col, tq, tk, causal, window)
                              ? expf(__fmul_rn(s[i][j], sm_scale) - lse_s[r]) : 0.f;
          ds[i][j] = p * (dp[i][j] - delta_s[r]) * sm_scale;
          p_s[(ty * 4 + i) * kPRow + r] = p;
        }
      }
      __syncthreads();                 // P^T ready
      accumulate<D>(p_s, do_s, ty, tx, acc_v);
      __syncthreads();                 // every thread is done reading P^T
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) p_s[(ty * 4 + i) * kPRow + tx + 16 * j] = ds[i][j];
      __syncthreads();                 // dS^T ready
      accumulate<D>(p_s, q_s, ty, tx, acc_k);
    }
  }
  store_rows<D>(dk + koff * D, k0, tk, ty, tx, acc_k);
  store_rows<D>(dv + koff * D, k0, tk, ty, tx, acc_v);
}

template <int D>
cudaError_t launch_dq_simt(const void* q, const void* k, const void* v,
                           const void* dout, const float* lse,
                           const float* delta, void* dq, int bh, int tq,
                           int tk, int causal, int window, float sm_scale,
                           cudaStream_t stream) {
  constexpr int kBytes = static_cast<int>(Layout<D>::kDqBytes);
  cudaError_t err = hopper::set_smem_once<flash_bwd_dq_simt<D>>(kBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((tq + kBlock - 1) / kBlock, bh);
  flash_bwd_dq_simt<D><<<grid, kThreads, kBytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), lse,
      delta, static_cast<float*>(dq), tq, tk, causal, window, sm_scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv_simt(const void* q, const void* k, const void* v,
                            const void* dout, const float* lse,
                            const float* delta, void* dk, void* dv, int bh,
                            int tq, int tk, int causal, int window,
                            float sm_scale, cudaStream_t stream) {
  constexpr int kBytes = static_cast<int>(Layout<D>::kDkvBytes);
  cudaError_t err = hopper::set_smem_once<flash_bwd_dkv_simt<D>>(kBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((tk + kBlock - 1) / kBlock, bh);
  flash_bwd_dkv_simt<D><<<grid, kThreads, kBytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), lse,
      delta, static_cast<float*>(dk), static_cast<float*>(dv), tq, tk, causal,
      window, sm_scale);
  return cudaGetLastError();
}

// ---- flash_bwd_dkv, bfloat16: wgmma + TMA ----------------------------------

constexpr int kWgThreads = 128;                 // one warpgroup

template <int D>
struct DkvSmem {
  static constexpr int kTile = D * 64 * 2;      // a 64 x D bf16 tile
  static constexpr int kK = 0;
  static constexpr int kV = kTile;
  static constexpr int kQ = 2 * kTile;          // Q ring, 2 stages
  static constexpr int kDo = 4 * kTile;         // dO ring, 2 stages
  static constexpr int kRows = 6 * kTile;       // lse[2][64], delta[2][64]
  static constexpr int kBytes = 6 * kTile + 4 * 64 * 4 + 1024;
};

template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_bwd_dkv_wgmma(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const __grid_constant__ CUtensorMap tm_do,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    __nv_bfloat16* __restrict__ dk,
                    __nv_bfloat16* __restrict__ dv, int tq, int tk,
                    int causal, int window, float sm_scale) {
  using namespace hopper;
  using L = DkvSmem<D>;
  constexpr int kTileBytes = L::kTile;
  constexpr int kAcc = D / 2;                   // dK / dV fragment floats
  extern __shared__ uint8_t wg_smem[];
  __shared__ __align__(8) uint64_t bars[5];     // k+v, q[2], dO[2]
  uint8_t* smem = align_1024(wg_smem);
  const uint8_t* k_s = smem + L::kK;
  const uint8_t* v_s = smem + L::kV;
  float* lse_s = reinterpret_cast<float*>(smem + L::kRows);   // [2][64]
  float* delta_s = lse_s + 2 * 64;                             // [2][64]
  uint64_t* bar_kv = &bars[0];
  uint64_t* bar_q = &bars[1];
  uint64_t* bar_do = &bars[3];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int g = (tid % 32) / 4;
  const int t = tid % 4;
  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * 64;
  const int64_t qoff = static_cast<int64_t>(bh) * tq;

  // Query rows that can see a key of this tile.
  const int k_last = min(k0 + 64, tk) - 1;
  int q_lo = 0;
  int q_hi = tq - 1;
  if (causal) {
    q_lo = k0;
    q_hi = min(q_hi, k_last + window - 1);
  }
  const int qt0 = q_lo / 64;
  const int n_tiles = q_lo <= q_hi ? q_hi / 64 - qt0 + 1 : 0;

  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < 5; ++i) mbar_init(&bars[i], 1);
    mbar_fence_init();
  }
  // lse and delta of the first query tile: threads 0-63 lse, 64-127 delta.
  const int rix = tid % 64;
  const float* rows_src = tid < 64 ? lse : delta;
  float* rows_dst = tid < 64 ? lse_s : delta_s;
  if (n_tiles > 0) {
    const int row = qt0 * 64 + rix;
    rows_dst[rix] = row < tq ? rows_src[qoff + row] : 0.f;
  }
  __syncthreads();
  if (tid == 0 && n_tiles > 0) {
    mbar_expect_tx(bar_kv, 2 * kTileBytes);
    tma_load_tile<D>(smem + L::kK, &tm_k, bar_kv, k0, bh);
    tma_load_tile<D>(smem + L::kV, &tm_v, bar_kv, k0, bh);
    mbar_expect_tx(&bar_q[0], kTileBytes);
    tma_load_tile<D>(smem + L::kQ, &tm_q, &bar_q[0], qt0 * 64, bh);
    mbar_expect_tx(&bar_do[0], kTileBytes);
    tma_load_tile<D>(smem + L::kDo, &tm_do, &bar_do[0], qt0 * 64, bh);
  }

  float acc_k[kAcc], acc_v[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc_k[i] = acc_v[i] = 0.f;
  const int c0 = k0 + warp * 16 + g;           // this thread's keys: c0, c0 + 8

  for (int i = 0; i < n_tiles; ++i) {
    const int st = i & 1;
    const uint32_t parity = (i >> 1) & 1;
    const int q0 = (qt0 + i) * 64;
    const uint8_t* q_s = smem + L::kQ + st * kTileBytes;
    const uint8_t* do_s = smem + L::kDo + st * kTileBytes;
    const float* lse_t = lse_s + st * 64;
    const float* delta_t = delta_s + st * 64;
    const bool more = i + 1 < n_tiles;
    if (tid == 0 && more) {                     // the other stage is free
      const int nx = st ^ 1;
      mbar_expect_tx(&bar_q[nx], kTileBytes);
      tma_load_tile<D>(smem + L::kQ + nx * kTileBytes, &tm_q, &bar_q[nx],
                       q0 + 64, bh);
      mbar_expect_tx(&bar_do[nx], kTileBytes);
      tma_load_tile<D>(smem + L::kDo + nx * kTileBytes, &tm_do, &bar_do[nx],
                       q0 + 64, bh);
    }
    float next_row = 0.f;                       // next tile's lse or delta
    if (more && q0 + 64 + rix < tq) next_row = rows_src[qoff + q0 + 64 + rix];

    if (i == 0) mbar_wait(bar_kv, 0);
    // S^T = K Q^T and dP^T = V dO^T, both in flight together.
    float s[32], dp[32];
    mbar_wait(&bar_q[st], parity);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(s, desc_kmajor(k_s, kk), desc_kmajor(q_s, kk), kk > 0);
    wgmma_commit();
    mbar_wait(&bar_do[st], parity);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(dp, desc_kmajor(v_s, kk), desc_kmajor(do_s, kk), kk > 0);
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(s);

    // P^T over the visible (key, query) pairs; rounded to bf16 for dV.
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = c0 + 8 * h;
          const int col = 8 * j + 2 * t + e;
          const int qr = q0 + col;
          bool ok = qr < tq && key < tk;
          if (causal) ok = ok && key <= qr && key > qr - window;
          float& x = s[4 * j + 2 * h + e];
          x = ok ? expf(__fmul_rn(x, sm_scale) - lse_t[col]) : 0.f;
        }
      }
    }
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        pa[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs_mn<D>(acc_v, pa[kk], desc_mnmajor(do_s, kk));
    wgmma_commit();

    // dS^T = round(P^T (dP^T - delta) scale), while dV runs.
    wgmma_wait<1>();                            // dP^T is done
    fence_regs(dp);
    uint32_t da[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float ds[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int idx = 8 * kk + 2 * r + e;
          const int col = 8 * (idx / 4) + 2 * t + e;
          ds[e] = s[idx] * (dp[idx] - delta_t[col]) * sm_scale;
        }
        da[kk][r] = pack_bf16(ds[0], ds[1]);
      }
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs_mn<D>(acc_k, da[kk], desc_mnmajor(q_s, kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc_v);
    fence_regs(acc_k);
    if (more) rows_dst[(st ^ 1) * 64 + rix] = next_row;
    __syncthreads();                            // stage st may be refilled
  }

  // Epilogue: dK and dV rows inside the sequence, in bf16.
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = c0 + 8 * h;
    if (key >= tk) continue;
    const int64_t off = (static_cast<int64_t>(bh) * tk + key) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int a = 4 * j + 2 * h;
      *reinterpret_cast<uint32_t*>(dk + off + 8 * j + 2 * t) =
          pack_bf16(acc_k[a], acc_k[a + 1]);
      *reinterpret_cast<uint32_t*>(dv + off + 8 * j + 2 * t) =
          pack_bf16(acc_v[a], acc_v[a + 1]);
    }
  }
}

template <int D>
cudaError_t launch_dkv_wgmma(const void* q, const void* k, const void* v,
                             const void* dout, const float* lse,
                             const float* delta, void* dk, void* dv, int bh,
                             int tq, int tk, int causal, int window,
                             float sm_scale, cudaStream_t stream) {
  constexpr int kBytes = DkvSmem<D>::kBytes;
  cudaError_t err = hopper::set_smem_once<flash_bwd_dkv_wgmma<D>>(kBytes);
  if (err != cudaSuccess) return err;
  CUtensorMap tm_q, tm_k, tm_v, tm_do;
  // With no query (tq == 0) no Q/dO tile is loaded; any valid map will do.
  const int q_rows = tq > 0 ? tq : tk;
  if ((err = hopper::make_tile_map(&tm_q, tq > 0 ? q : k, D, q_rows, bh)) != cudaSuccess ||
      (err = hopper::make_tile_map(&tm_k, k, D, tk, bh)) != cudaSuccess ||
      (err = hopper::make_tile_map(&tm_v, v, D, tk, bh)) != cudaSuccess ||
      (err = hopper::make_tile_map(&tm_do, tq > 0 ? dout : k, D, q_rows, bh)) != cudaSuccess)
    return err;
  const dim3 grid((tk + 63) / 64, bh);
  flash_bwd_dkv_wgmma<D><<<grid, kWgThreads, kBytes, stream>>>(
      tm_q, tm_k, tm_v, tm_do, lse, delta, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), tq, tk, causal, window, sm_scale);
  return cudaGetLastError();
}

// ---- flash_bwd_dq, bfloat16: wgmma + TMA, the key loop over a cluster -------

template <int D>
struct DqSmem {
  static constexpr int kTile = D * 64 * 2;      // a 64 x D bf16 tile
  static constexpr int kQ = 0;
  static constexpr int kDo = kTile;
  static constexpr int kK = 2 * kTile;          // K ring, 2 stages; then dQ
  static constexpr int kV = 4 * kTile;          // V ring, 2 stages
  static constexpr int kBytes = 6 * kTile + 1024;
};

// dQ of one 64-row query tile, computed by the C blocks of one cluster:
// rank r takes the band's key tiles r, r + C, r + 2C, ... and the ranks'
// f32 sums meet in rank 0's registers through distributed shared memory.
// C = 1 is one block per tile, with no cluster code.
template <int D, int C>
__global__ void __launch_bounds__(kWgThreads, 2)
flash_bwd_dq_wgmma(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   const __grid_constant__ CUtensorMap tm_do,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta,
                   __nv_bfloat16* __restrict__ dq, int tq, int tk, int causal,
                   int window, float sm_scale) {
  using namespace hopper;
  using L = DqSmem<D>;
  constexpr int kTileBytes = L::kTile;
  constexpr int kAcc = D / 2;                   // dQ fragment floats
  extern __shared__ uint8_t wg_smem[];
  __shared__ __align__(8) uint64_t bars[6];     // q, dO, k[2], v[2]
  uint8_t* smem = align_1024(wg_smem);
  const uint8_t* q_s = smem + L::kQ;
  const uint8_t* do_s = smem + L::kDo;
  uint64_t* bar_q = &bars[0];
  uint64_t* bar_do = &bars[1];
  uint64_t* bar_k = &bars[2];
  uint64_t* bar_v = &bars[4];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int g = (tid % 32) / 4;
  const int t = tid % 4;
  const int bh = blockIdx.y;
  const int q0 = (blockIdx.x / C) * 64;
  const int rank = C > 1 ? static_cast<int>(cluster_rank()) : 0;
  const int64_t qoff = static_cast<int64_t>(bh) * tq;

  // Key range this query tile can see, and this rank's share of its tiles.
  const int q_last = min(q0 + 64, tq) - 1;
  int k_lo = 0;
  int k_hi = tk - 1;
  if (causal) {
    k_hi = min(k_hi, q_last);
    k_lo = max(0, q0 - window + 1);
  }
  const int kt0 = k_lo / 64;
  const int n_tiles = k_lo <= k_hi ? k_hi / 64 - kt0 + 1 : 0;
  const int n_mine = n_tiles > rank ? (n_tiles - rank + C - 1) / C : 0;

  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < 6; ++i) mbar_init(&bars[i], 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0 && n_mine > 0) {
    const int k0 = (kt0 + rank) * 64;
    mbar_expect_tx(bar_q, kTileBytes);
    tma_load_tile<D>(smem + L::kQ, &tm_q, bar_q, q0, bh);
    mbar_expect_tx(&bar_k[0], kTileBytes);
    tma_load_tile<D>(smem + L::kK, &tm_k, &bar_k[0], k0, bh);
    mbar_expect_tx(bar_do, kTileBytes);
    tma_load_tile<D>(smem + L::kDo, &tm_do, bar_do, q0, bh);
    mbar_expect_tx(&bar_v[0], kTileBytes);
    tma_load_tile<D>(smem + L::kV, &tm_v, &bar_v[0], k0, bh);
  }

  // This thread's rows r0 and r0 + 8: their lse and delta, in registers.
  const int r0 = q0 + warp * 16 + g;
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + 8 * h;
    lse_r[h] = row < tq ? lse[qoff + row] : 0.f;
    delta_r[h] = row < tq ? delta[qoff + row] : 0.f;
  }

  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;

  for (int i = 0; i < n_mine; ++i) {
    const int st = i & 1;
    const uint32_t parity = (i >> 1) & 1;
    const int k0 = (kt0 + rank + i * C) * 64;
    const uint8_t* k_s = smem + L::kK + st * kTileBytes;
    const uint8_t* v_s = smem + L::kV + st * kTileBytes;
    if (tid == 0 && i + 1 < n_mine) {           // the other stage is free
      const int nx = st ^ 1;
      mbar_expect_tx(&bar_k[nx], kTileBytes);
      tma_load_tile<D>(smem + L::kK + nx * kTileBytes, &tm_k, &bar_k[nx],
                       k0 + 64 * C, bh);
      mbar_expect_tx(&bar_v[nx], kTileBytes);
      tma_load_tile<D>(smem + L::kV + nx * kTileBytes, &tm_v, &bar_v[nx],
                       k0 + 64 * C, bh);
    }

    // S = Q K^T and dP = dO V^T, both in flight together.
    float s[32], dp[32];
    if (i == 0) mbar_wait(bar_q, 0);
    mbar_wait(&bar_k[st], parity);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(s, desc_kmajor(q_s, kk), desc_kmajor(k_s, kk), kk > 0);
    wgmma_commit();
    if (i == 0) mbar_wait(bar_do, 0);
    mbar_wait(&bar_v[st], parity);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(dp, desc_kmajor(do_s, kk), desc_kmajor(v_s, kk), kk > 0);
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(s);

    // P over the visible (row, key) pairs, never rounded.
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int row = r0 + 8 * h;
          const int col = k0 + 8 * j + 2 * t + e;
          bool ok = col < tk;
          if (causal) ok = ok && col <= row && col > row - window;
          float& x = s[4 * j + 2 * h + e];
          x = ok ? expf(__fmul_rn(x, sm_scale) - lse_r[h]) : 0.f;
        }
      }
    }

    // dS = round(P (dP - delta) scale): S's k16 slices are the register A
    // fragments of dQ += dS K.
    wgmma_wait<0>();
    fence_regs(dp);
    uint32_t da[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int idx = 8 * kk + 2 * r;
        const float d = delta_r[r & 1];
        da[kk][r] = pack_bf16(s[idx] * (dp[idx] - d) * sm_scale,
                              s[idx + 1] * (dp[idx + 1] - d) * sm_scale);
      }
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs_mn<D>(acc, da[kk], desc_mnmajor(k_s, kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    __syncthreads();                            // stage st may be refilled
  }

  if constexpr (C > 1) {
    // Ranks 1 .. C-1 that took a key tile park their f32 fragment in their
    // own K ring (its last product has been waited on), float4 v of thread
    // tid at [v * 128 + tid]; rank 0 adds them to its own in rank order,
    // reading each at its own fragment positions.
    float4* park = reinterpret_cast<float4*>(smem + L::kK);
    const int n_ranks = min(C, n_tiles);
    if (rank > 0 && rank < n_ranks) {
#pragma unroll
      for (int v = 0; v < kAcc / 4; ++v)
        park[v * kWgThreads + tid] =
            make_float4(acc[4 * v], acc[4 * v + 1], acc[4 * v + 2], acc[4 * v + 3]);
    }
    cluster_arrive();
    cluster_wait();
    if (rank == 0) {
      for (int peer = 1; peer < n_ranks; ++peer) {
        const uint32_t base = map_peer(smem_u32(park + tid), peer);
#pragma unroll
        for (int v = 0; v < kAcc / 4; ++v) {
          const float4 x = load_peer_f4(base + v * kWgThreads * 16);
          acc[4 * v] += x.x;
          acc[4 * v + 1] += x.y;
          acc[4 * v + 2] += x.z;
          acc[4 * v + 3] += x.w;
        }
      }
    }
    cluster_arrive();                           // rank 0 is done reading
  }

  // Epilogue (rank 0): dQ rows inside the sequence, in bf16.
  if (rank == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + 8 * h;
      if (row >= tq) continue;
      __nv_bfloat16* orow = dq + (qoff + row) * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(orow + 8 * j + 2 * t) =
            pack_bf16(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  }
  if constexpr (C > 1) cluster_wait();          // peers outlive the reads
}

// Key tiles of the widest query tile's band (the most ranks that find work).
inline int dq_band_tiles(int tq, int tk, int causal, int window) {
  if (!causal) return (tk + 63) / 64;
  int most = 0;
  for (int q0 = 0; q0 < tq; q0 += 64) {
    const int k_hi = std::min(tk - 1, std::min(q0 + 64, tq) - 1);
    const int k_lo = std::max(0, q0 - window + 1);
    if (k_lo <= k_hi) most = std::max(most, k_hi / 64 - k_lo / 64 + 1);
  }
  return most;
}

// The cluster size of a launch: 2 once the widest band holds 2 key tiles
// and a cluster of 2 keeps the whole grid resident at once, else 1. On an
// H100 a key tile costs a rank about 2.5 us and a cluster of 2 about 0.9 us
// (launch, barriers and the DSMEM reads), so at the replay's 5-tile band
// c = 2 beats c = 1; at T = 8192 the grid of pairs no longer fits.
template <int D>
cudaError_t dq_cluster(int bh, int tq, int tk, int causal, int window,
                       int* cluster) {
  *cluster = 1;
  if (dq_band_tiles(tq, tk, causal, window) < 2) return cudaSuccess;
  constexpr int kBytes = DqSmem<D>::kBytes;
  cudaError_t err = hopper::set_smem_once<flash_bwd_dq_wgmma<D, 2>>(kBytes);
  if (err != cudaSuccess) return err;
  int most = 0;
  err = hopper::max_active_clusters_once<flash_bwd_dq_wgmma<D, 2>>(
      kWgThreads, kBytes, 2, &most);
  if ((tq + 63) / 64 * bh <= most) *cluster = 2;
  return err;
}

template <int D>
cudaError_t launch_dq_wgmma(const void* q, const void* k, const void* v,
                            const void* dout, const float* lse,
                            const float* delta, void* dq, int bh, int tq,
                            int tk, int causal, int window, float sm_scale,
                            cudaStream_t stream) {
  constexpr int kBytes = DqSmem<D>::kBytes;
  int c = 1;
  cudaError_t err = dq_cluster<D>(bh, tq, tk, causal, window, &c);
  if (err != cudaSuccess) return err;
  CUtensorMap tm_q, tm_k, tm_v, tm_do;
  // With no key (tk == 0) no K/V tile is loaded; any valid map will do.
  const int k_rows = tk > 0 ? tk : tq;
  if ((err = hopper::make_tile_map(&tm_q, q, D, tq, bh)) != cudaSuccess ||
      (err = hopper::make_tile_map(&tm_k, tk > 0 ? k : q, D, k_rows, bh)) != cudaSuccess ||
      (err = hopper::make_tile_map(&tm_v, tk > 0 ? v : q, D, k_rows, bh)) != cudaSuccess ||
      (err = hopper::make_tile_map(&tm_do, dout, D, tq, bh)) != cudaSuccess)
    return err;
  const int q_tiles = (tq + 63) / 64;
  auto* out = static_cast<__nv_bfloat16*>(dq);
  if (c == 1) {
    if ((err = hopper::set_smem_once<flash_bwd_dq_wgmma<D, 1>>(kBytes)) != cudaSuccess)
      return err;
    flash_bwd_dq_wgmma<D, 1><<<dim3(q_tiles, bh), kWgThreads, kBytes, stream>>>(
        tm_q, tm_k, tm_v, tm_do, lse, delta, out, tq, tk, causal, window, sm_scale);
    return cudaGetLastError();
  }
  // dq_cluster has raised the shared-memory limit of the pair kernel.
  err = hopper::launch_cluster(flash_bwd_dq_wgmma<D, 2>, dim3(q_tiles * 2, bh),
                               kWgThreads, kBytes, stream, 2, tm_q, tm_k, tm_v,
                               tm_do, lse, delta, out, tq, tk, causal, window,
                               sm_scale);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

// Plain C entry points (loaded with ctypes). dtype: 0 = float32 (SIMT),
// 1 = bfloat16 (wgmma + TMA; dq's key loop split over a cluster). Each
// returns a cudaError_t; cudaErrorInvalidValue for a dtype/head_dim the
// kernels are not built for (the Python wrappers refuse those first).
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* dout, const float* lse,
                            const float* delta, void* dq, int bh, int tq,
                            int tk, int head_dim, int dtype, int causal,
                            int window, float sm_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bh == 0 || tq == 0) return static_cast<int>(cudaSuccess);
  if (dtype == 0 && head_dim == 64)
    return launch_dq_simt<64>(q, k, v, dout, lse, delta, dq, bh, tq, tk, causal, window, sm_scale, s);
  if (dtype == 0 && head_dim == 128)
    return launch_dq_simt<128>(q, k, v, dout, lse, delta, dq, bh, tq, tk, causal, window, sm_scale, s);
  if (dtype == 1 && head_dim == 64)
    return launch_dq_wgmma<64>(q, k, v, dout, lse, delta, dq, bh, tq, tk, causal, window, sm_scale, s);
  if (dtype == 1 && head_dim == 128)
    return launch_dq_wgmma<128>(q, k, v, dout, lse, delta, dq, bh, tq, tk, causal, window, sm_scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The cluster size flash_bwd_dq launches with for these arguments (1 for
// float32, whose SIMT kernel has none), written to *cluster; returns a
// cudaError_t like the entry points.
extern "C" int flash_bwd_dq_cluster(int bh, int tq, int tk, int head_dim,
                                    int dtype, int causal, int window,
                                    int* cluster) {
  *cluster = 1;
  if (bh == 0 || tq == 0 || dtype == 0) return static_cast<int>(cudaSuccess);
  if (head_dim == 64)
    return dq_cluster<64>(bh, tq, tk, causal, window, cluster);
  if (head_dim == 128)
    return dq_cluster<128>(bh, tq, tk, causal, window, cluster);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const float* lse,
                             const float* delta, void* dk, void* dv, int bh,
                             int tq, int tk, int head_dim, int dtype,
                             int causal, int window, float sm_scale,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bh == 0 || tk == 0) return static_cast<int>(cudaSuccess);
  if (dtype == 0 && head_dim == 64)
    return launch_dkv_simt<64>(q, k, v, dout, lse, delta, dk, dv, bh, tq, tk, causal, window, sm_scale, s);
  if (dtype == 0 && head_dim == 128)
    return launch_dkv_simt<128>(q, k, v, dout, lse, delta, dk, dv, bh, tq, tk, causal, window, sm_scale, s);
  if (dtype == 1 && head_dim == 64)
    return launch_dkv_wgmma<64>(q, k, v, dout, lse, delta, dk, dv, bh, tq, tk, causal, window, sm_scale, s);
  if (dtype == 1 && head_dim == 128)
    return launch_dkv_wgmma<128>(q, k, v, dout, lse, delta, dk, dv, bh, tq, tk, causal, window, sm_scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
