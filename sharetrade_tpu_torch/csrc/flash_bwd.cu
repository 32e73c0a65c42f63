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
// flash_bwd_dq (both dtypes) and flash_bwd_dkv in float32 run SIMT FMA
// loops on f32 tiles in shared memory (one block of 256 threads per 64-row
// tile); for f32, wgmma would be TF32, and the f32 backward is held bit for
// bit to the plain one. Left on the table: wgmma for flash_bwd_dq's bf16
// path (the design above carries over).
// Also: at bh = 2 the replay gives only 2 x 23 blocks for 132
// SMs (splitting the query loop of dkv or the key loop of dq across blocks,
// with a reduction, would fill the card); warp-specialised persistent
// blocks.

#include "hopper.cuh"

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

__device__ __forceinline__ void load_vec(const __nv_bfloat16* src, float* dst) {
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
}

// Copy rows [row0, row0 + 64) of a (rows, D) matrix into shared memory as
// f32, zero-filling rows at or past `rows`. 16-byte vector loads.
template <typename T, int D>
__device__ __forceinline__ void load_tile(const T* __restrict__ base, int row0,
                                          int rows, float* __restrict__ tile) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = D / kVec;
  constexpr int kRow = Layout<D>::kRow;
  for (int v = threadIdx.x; v < kBlock * kPerRow; v += kThreads) {
    const int r = v / kPerRow;
    const int c = (v % kPerRow) * kVec;
    float vals[kVec];
    if (row0 + r < rows) {
      load_vec(base + static_cast<int64_t>(row0 + r) * D + c, vals);
    } else {
#pragma unroll
      for (int i = 0; i < kVec; ++i) vals[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < kVec; i += 4) {
      *reinterpret_cast<float4*>(tile + r * kRow + c + i) =
          make_float4(vals[i], vals[i + 1], vals[i + 2], vals[i + 3]);
    }
  }
}

__device__ __forceinline__ float round_like(float x, const float*) { return x; }
__device__ __forceinline__ float round_like(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ void store4(float* dst, const float* v) {
  *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* dst, const float* v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 packed;
  packed.x = *reinterpret_cast<uint32_t*>(&lo);
  packed.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(dst) = packed;
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

template <typename T, int D>
__device__ __forceinline__ void store_rows(T* __restrict__ out, int row0,
                                           int rows, int ty, int tx,
                                           const float (&acc)[4][D / 16]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty * 4 + i;
    if (row >= rows) continue;
    T* orow = out + static_cast<int64_t>(row) * D;
#pragma unroll
    for (int m = 0; m < D / 64; ++m) store4(orow + tx * 4 + 64 * m, &acc[i][4 * m]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
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

  load_tile<T, D>(q + qoff * D, q0, tq, q_s);
  load_tile<T, D>(dout + qoff * D, q0, tq, do_s);

  if (k_lo <= k_hi) {
    for (int kt = k_lo / kBlock; kt <= k_hi / kBlock; ++kt) {
      const int k0 = kt * kBlock;
      __syncthreads();                 // previous tile's K, V, dS are free
      load_tile<T, D>(k + koff * D, k0, tk, k_s);
      load_tile<T, D>(v + koff * D, k0, tk, v_s);
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
              round_like(p * (dp[i][j] - delta_i[i]) * sm_scale, q);
        }
      }
      __syncthreads();                 // dS ready
      accumulate<D>(ds_s, k_s, ty, tx, acc);
    }
  }
  store_rows<T, D>(dq + qoff * D, q0, tq, ty, tx, acc);
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

  load_tile<float, D>(k + koff * D, k0, tk, k_s);
  load_tile<float, D>(v + koff * D, k0, tk, v_s);

  if (q_lo <= q_hi) {
    for (int qt = q_lo / kBlock; qt <= q_hi / kBlock; ++qt) {
      const int q0 = qt * kBlock;
      __syncthreads();                 // previous tile's Q, dO, P are free
      load_tile<float, D>(q + qoff * D, q0, tq, q_s);
      load_tile<float, D>(dout + qoff * D, q0, tq, do_s);
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
  store_rows<float, D>(dk + koff * D, k0, tk, ty, tx, acc_k);
  store_rows<float, D>(dv + koff * D, k0, tk, ty, tx, acc_v);
}

template <typename T, int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* delta,
                      void* dq, int bh, int tq, int tk, int causal,
                      int window, float sm_scale, cudaStream_t stream) {
  constexpr int kBytes = static_cast<int>(Layout<D>::kDqBytes);
  cudaError_t err = hopper::set_smem_once<flash_bwd_dq_kernel<T, D>>(kBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((tq + kBlock - 1) / kBlock, bh);
  flash_bwd_dq_kernel<T, D><<<grid, kThreads, kBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dq), tq, tk, causal, window, sm_scale);
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

}  // namespace

// Plain C entry points (loaded with ctypes). dtype: 0 = float32,
// 1 = bfloat16 (dkv: wgmma + TMA). Each returns a cudaError_t; cudaErrorInvalidValue for a
// dtype/head_dim the kernels are not built for (the Python wrappers refuse
// those first).
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* dout, const float* lse,
                            const float* delta, void* dq, int bh, int tq,
                            int tk, int head_dim, int dtype, int causal,
                            int window, float sm_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bh == 0 || tq == 0) return static_cast<int>(cudaSuccess);
  if (dtype == 0 && head_dim == 64)
    return launch_dq<float, 64>(q, k, v, dout, lse, delta, dq, bh, tq, tk, causal, window, sm_scale, s);
  if (dtype == 0 && head_dim == 128)
    return launch_dq<float, 128>(q, k, v, dout, lse, delta, dq, bh, tq, tk, causal, window, sm_scale, s);
  if (dtype == 1 && head_dim == 64)
    return launch_dq<__nv_bfloat16, 64>(q, k, v, dout, lse, delta, dq, bh, tq, tk, causal, window, sm_scale, s);
  if (dtype == 1 && head_dim == 128)
    return launch_dq<__nv_bfloat16, 128>(q, k, v, dout, lse, delta, dq, bh, tq, tk, causal, window, sm_scale, s);
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
