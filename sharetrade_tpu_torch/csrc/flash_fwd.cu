// flash_fwd: causal / banded flash-attention forward for Hopper (sm_90a).
//
// Replaces the JAX package's two Pallas forward kernels, which compute the
// same function and differ only in how they stage K/V through a TPU's VMEM:
//   K1  sharetrade_tpu/ops/attention.py  _flash_kernel             (line 88)
//   K2  sharetrade_tpu/ops/attention.py  _flash_banded_fwd_kernel  (line 284)
// Here one kernel serves both: a block loops over exactly the key tiles its
// query rows can see, so the sequence length is bounded by device memory and
// no full-K/V versus streaming split is needed. Nothing is padded: the
// ragged edge (rows or keys past the sequence end) is masked in the kernel.
//
// Function (all shapes contiguous, bh = batch * heads):
//   q (bh, tq, D), k/v (bh, tk, D) in bf16 or f32, D in {64, 128}
//   o (bh, tq, D) in the input dtype, lse (bh, tq) f32
//   s = (q . k) * sm_scale in f32 (a separate multiply); key c is visible
//   to row r when c < tk and, if causal, r - window < c <= r. Online
//   softmax in f32; for bf16 inputs P is rounded to bf16 before the P.V
//   product (the row sum l uses the unrounded P), as the Pallas kernel
//   does. A row that sees no key gives o = 0 and lse = 0.
//
// What bounds it on an H100: at the serving shape (bh = 128, T = 401,
// D = 128, window 201, bf16) q, k, v and o are about 52.6 MB per launch,
// about 15.7 us at 3.35 TB/s, against about 3.97 GFLOP over the band, about
// 4 us at the 989 TFLOP/s bf16 tensor-core rate: memory-bound on paper, but
// only if the products run on the tensor cores and the loads overlap them.
//
// bf16 (the main paths), wgmma + TMA (hopper.cuh):
//   - one warpgroup (128 threads) per (bh, 64-row query tile); the Q tile
//     is loaded once by TMA; K and V tiles go through a 2-stage ring with
//     one mbarrier per tile, K and V in separate buffers, so thread 0
//     issues tile i+1's loads before the block computes on tile i and V
//     lands while S is computed; the block visits exactly its band's key
//     tiles;
//   - S = Q K^T is a wgmma (both operands K-major in shared memory, f32
//     accumulators in registers); scale, mask and online softmax run on the
//     accumulator fragments (row max and sum over the quad of lanes that
//     owns a row);
//   - O += P V is a wgmma with A = P from registers (S's fragments rounded
//     to bf16 pairs in place: the layouts match) and B = V read transposed
//     (MN-major) from shared memory;
//   - bf16 tiles stay bf16 in shared memory: 81 KB a block at D = 128, two
//     blocks per SM.
// float32 runs SIMT FMA loops on f32 tiles (256 threads per 64-row tile),
// since wgmma on f32 would be TF32 and the f32 path is held to f32
// products; it is off the main paths.

#include "hopper.cuh"

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {


// ---- float32: SIMT (full f32 products, never TF32) ----------------------

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 256;   // 16 x 16: thread (ty, tx)
constexpr int kPad = 4;         // row padding in floats (keeps float4 aligned)

template <int D>
struct Smem {
  static constexpr int kRow = D + kPad;            // Q / KV row stride
  static constexpr int kPRow = kBlockK + kPad;     // P row stride
  static constexpr int kFloats = kBlockQ * kRow + kBlockK * kRow
                                 + kBlockQ * kPRow;
  static constexpr size_t kBytes = sizeof(float) * kFloats;
};

__device__ __forceinline__ void load_vec(const float* src, float* dst) {
  const float4 v = *reinterpret_cast<const float4*>(src);
  dst[0] = v.x; dst[1] = v.y; dst[2] = v.z; dst[3] = v.w;
}

// Copy rows [row0, row0 + 64) of a (rows, D) matrix into shared memory,
// zero-filling rows at or past `rows`. 16-byte vector loads.
template <int D>
__device__ __forceinline__ void load_tile(const float* __restrict__ base, int row0,
                                          int rows, float* __restrict__ tile) {
  constexpr int kVec = 4;                    // floats per 16-byte load
  constexpr int kPerRow = D / kVec;
  constexpr int kRow = Smem<D>::kRow;
  for (int v = threadIdx.x; v < kBlockQ * kPerRow; v += kThreads) {
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

__device__ __forceinline__ void store4(float* dst, const float* v) {
  *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
}

// Reduce over the 16 threads (tx) that share a row: they are the 16
// consecutive lanes of one half-warp.
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int D>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_simt(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, int tq, int tk, int causal,
                 int window, float sm_scale) {
  extern __shared__ float4 smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw);
  constexpr int kRow = Smem<D>::kRow;
  constexpr int kPRow = Smem<D>::kPRow;
  constexpr int kOCols = D / 16;             // O columns per thread
  float* q_s = smem;                         // (64, D + pad)
  float* kv_s = q_s + kBlockQ * kRow;        // (64, D + pad): K, then V
  float* p_s = kv_s + kBlockK * kRow;        // (64, 64 + pad)

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kBlockQ;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const float* qb = q + static_cast<int64_t>(bh) * tq * D;
  const float* kb = k + static_cast<int64_t>(bh) * tk * D;
  const float* vb = v + static_cast<int64_t>(bh) * tk * D;

  // Key range this query tile can see.
  const int q_last = min(q0 + kBlockQ, tq) - 1;
  int k_lo = 0;
  int k_hi = tk - 1;
  if (causal) {
    k_hi = min(k_hi, q_last);
    k_lo = max(0, q0 - window + 1);
  }

  float m_i[4], l_i[4], acc[4][kOCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_i[i] = -INFINITY;
    l_i[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kOCols; ++c) acc[i][c] = 0.f;
  }

  load_tile<D>(qb, q0, tq, q_s);

  if (k_lo <= k_hi) {
    for (int kt = k_lo / kBlockK; kt <= k_hi / kBlockK; ++kt) {
      const int k0 = kt * kBlockK;
      __syncthreads();                 // q_s ready; kv_s/p_s free for reuse
      load_tile<D>(kb, k0, tk, kv_s);
      __syncthreads();

      // S tile: rows ty*4 + i, keys tx + 16*j.
      float s[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; d += 4) {
        float qv[4][4], kv[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i) load_vec(q_s + (ty * 4 + i) * kRow + d, qv[i]);
#pragma unroll
        for (int j = 0; j < 4; ++j) load_vec(kv_s + (tx + 16 * j) * kRow + d, kv[j]);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[i][j] = fmaf(qv[i][e], kv[j][e], s[i][j]);
      }
      __syncthreads();                 // every thread is done reading K
      load_tile<D>(vb, k0, tk, kv_s);

      // Mask, online softmax, P to shared memory.
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = q0 + ty * 4 + i;
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = k0 + tx + 16 * j;
          bool ok = col < tk;
          if (causal) ok = ok && col <= row && col > row - window;
          s[i][j] = ok ? s[i][j] * sm_scale : -INFINITY;
          mx = fmaxf(mx, s[i][j]);
        }
        const float m_new = fmaxf(m_i[i], row_max(mx));
        float alpha = 1.f;
        float psum = 0.f;
        if (m_new == -INFINITY) {      // nothing visible yet in this row
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
        } else {
          alpha = expf(m_i[i] - m_new);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = expf(s[i][j] - m_new);
            psum += s[i][j];
          }
        }
        l_i[i] = l_i[i] * alpha + row_sum(psum);
        m_i[i] = m_new;
#pragma unroll
        for (int c = 0; c < kOCols; ++c) acc[i][c] *= alpha;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          p_s[(ty * 4 + i) * kPRow + tx + 16 * j] = s[i][j];
      }
      __syncthreads();                 // V and P ready

      // O += P V: rows ty*4 + i, columns tx*4 + 64*m + e.
#pragma unroll 2
      for (int kk = 0; kk < kBlockK; kk += 4) {
        float pv[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i) load_vec(p_s + (ty * 4 + i) * kPRow + kk, pv[i]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float vv[kOCols];
#pragma unroll
          for (int m = 0; m < kOCols / 4; ++m)
            load_vec(kv_s + (kk + e) * kRow + tx * 4 + 64 * m, vv + 4 * m);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int c = 0; c < kOCols; ++c) acc[i][c] = fmaf(pv[i][e], vv[c], acc[i][c]);
        }
      }
    }
  }

  // Epilogue: normalise, write O and lse for the rows inside the sequence.
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= tq) continue;
    const bool seen = l_i[i] > 0.f;
    const float l = seen ? l_i[i] : 1.f;
    float* orow = o + (static_cast<int64_t>(bh) * tq + row) * D;
#pragma unroll
    for (int m = 0; m < kOCols / 4; ++m) {
      float out[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) out[e] = acc[i][4 * m + e] / l;
      store4(orow + tx * 4 + 64 * m, out);
    }
    if (tx == 0)
      lse[static_cast<int64_t>(bh) * tq + row] = seen ? m_i[i] + logf(l_i[i]) : 0.f;
  }
}

// ---- bfloat16: wgmma + TMA ------------------------------------------------

constexpr int kWgThreads = 128;                 // one warpgroup

template <int D>
struct WgSmem {
  static constexpr int kTile = D * 64 * 2;      // a 64 x D bf16 tile
  static constexpr int kQ = 0;
  static constexpr int kK = kTile;              // K ring, 2 stages
  static constexpr int kV = 3 * kTile;          // V ring, 2 stages
  static constexpr int kBytes = 5 * kTile + 1024;   // + alignment slack
};

template <int D>
__global__ void __launch_bounds__(kWgThreads, 2)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap tm_q,
                const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v,
                __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int tq,
                int tk, int causal, int window, float sm_scale) {
  using namespace hopper;
  using L = WgSmem<D>;
  constexpr int kTileBytes = L::kTile;
  constexpr int kAcc = D / 2;                   // O fragment floats a thread
  extern __shared__ uint8_t wg_smem[];
  __shared__ __align__(8) uint64_t bars[5];     // q, k[2], v[2]
  uint8_t* smem = align_1024(wg_smem);
  uint8_t* q_s = smem + L::kQ;
  uint64_t* bar_q = &bars[0];
  uint64_t* bar_k = &bars[1];
  uint64_t* bar_v = &bars[3];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int g = (tid % 32) / 4;
  const int t = tid % 4;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * 64;

  // Key range this query tile can see.
  const int q_last = min(q0 + 64, tq) - 1;
  int k_lo = 0;
  int k_hi = tk - 1;
  if (causal) {
    k_hi = min(k_hi, q_last);
    k_lo = max(0, q0 - window + 1);
  }
  const int kt0 = k_lo / 64;
  const int n_tiles = k_lo <= k_hi ? k_hi / 64 - kt0 + 1 : 0;

  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < 5; ++i) mbar_init(&bars[i], 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0 && n_tiles > 0) {
    mbar_expect_tx(bar_q, kTileBytes);
    tma_load_tile<D>(q_s, &tm_q, bar_q, q0, bh);
    mbar_expect_tx(&bar_k[0], kTileBytes);
    tma_load_tile<D>(smem + L::kK, &tm_k, &bar_k[0], kt0 * 64, bh);
    mbar_expect_tx(&bar_v[0], kTileBytes);
    tma_load_tile<D>(smem + L::kV, &tm_v, &bar_v[0], kt0 * 64, bh);
  }

  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
  float m_i[2] = {-INFINITY, -INFINITY};
  float l_i[2] = {0.f, 0.f};
  const int r0 = q0 + warp * 16 + g;           // this thread's rows: r0, r0 + 8

  for (int i = 0; i < n_tiles; ++i) {
    const int st = i & 1;
    const uint32_t parity = (i >> 1) & 1;
    const int k0 = (kt0 + i) * 64;
    uint8_t* k_s = smem + L::kK + st * kTileBytes;
    uint8_t* v_s = smem + L::kV + st * kTileBytes;
    if (tid == 0 && i + 1 < n_tiles) {          // the other stage is free
      const int nx = st ^ 1;
      mbar_expect_tx(&bar_k[nx], kTileBytes);
      tma_load_tile<D>(smem + L::kK + nx * kTileBytes, &tm_k, &bar_k[nx],
                       k0 + 64, bh);
      mbar_expect_tx(&bar_v[nx], kTileBytes);
      tma_load_tile<D>(smem + L::kV + nx * kTileBytes, &tm_v, &bar_v[nx],
                       k0 + 64, bh);
    }
    if (i == 0) mbar_wait(bar_q, 0);
    mbar_wait(&bar_k[st], parity);

    // S = Q K^T.
    float s[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(s, desc_kmajor(q_s, kk), desc_kmajor(k_s, kk), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);

    // Scale, mask, online softmax; P = exp(s - m) in s.
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + 8 * h;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = k0 + 8 * j + 2 * t + e;
          bool ok = col < tk;
          if (causal) ok = ok && col <= row && col > row - window;
          float& x = s[4 * j + 2 * h + e];
          x = ok ? __fmul_rn(x, sm_scale) : -INFINITY;
          mx = fmaxf(mx, x);
        }
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_i[h], mx);
      float alpha = 1.f;
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[4 * j + 2 * h + e];
          x = m_new == -INFINITY ? 0.f : expf(x - m_new);
          psum += x;
        }
      }
      if (m_new != -INFINITY) alpha = expf(m_i[h] - m_new);
      psum += __shfl_xor_sync(0xffffffffu, psum, 1);
      psum += __shfl_xor_sync(0xffffffffu, psum, 2);
      l_i[h] = l_i[h] * alpha + psum;
      m_i[h] = m_new;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        acc[4 * j + 2 * h] *= alpha;
        acc[4 * j + 2 * h + 1] *= alpha;
      }
    }

    // P rounded to bf16: S's k16 slices are P.V's register A fragments.
    uint32_t p[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        p[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);

    // O += P V.
    mbar_wait(&bar_v[st], parity);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs_mn<D>(acc, p[kk], desc_mnmajor(v_s, kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    __syncthreads();                            // stage st may be refilled
  }

  // Epilogue: normalise, write O and lse for the rows inside the sequence.
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + 8 * h;
    if (row >= tq) continue;
    const bool seen = l_i[h] > 0.f;
    const float l = seen ? l_i[h] : 1.f;
    __nv_bfloat16* orow = o + (static_cast<int64_t>(bh) * tq + row) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(orow + 8 * j + 2 * t) =
          pack_bf16(acc[4 * j + 2 * h] / l, acc[4 * j + 2 * h + 1] / l);
    if (t == 0)
      lse[static_cast<int64_t>(bh) * tq + row] = seen ? m_i[h] + logf(l_i[h]) : 0.f;
  }
}

template <int D>
cudaError_t launch_simt(const void* q, const void* k, const void* v, void* o,
                        float* lse, int bh, int tq, int tk, int causal,
                        int window, float sm_scale, cudaStream_t stream) {
  constexpr int kBytes = static_cast<int>(Smem<D>::kBytes);
  cudaError_t err = hopper::set_smem_once<flash_fwd_simt<D>>(kBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((tq + kBlockQ - 1) / kBlockQ, bh);
  flash_fwd_simt<D><<<grid, kThreads, kBytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, tq, tk,
      causal, window, sm_scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, void* o,
                         float* lse, int bh, int tq, int tk, int causal,
                         int window, float sm_scale, cudaStream_t stream) {
  constexpr int kBytes = WgSmem<D>::kBytes;
  cudaError_t err = hopper::set_smem_once<flash_fwd_wgmma<D>>(kBytes);
  if (err != cudaSuccess) return err;
  CUtensorMap tm_q, tm_k, tm_v;
  // With no key (tk == 0) no K/V tile is loaded; any valid map will do.
  const int k_rows = tk > 0 ? tk : tq;
  if ((err = hopper::make_tile_map(&tm_q, q, D, tq, bh)) != cudaSuccess ||
      (err = hopper::make_tile_map(&tm_k, tk > 0 ? k : q, D, k_rows, bh)) != cudaSuccess ||
      (err = hopper::make_tile_map(&tm_v, tk > 0 ? v : q, D, k_rows, bh)) != cudaSuccess)
    return err;
  const dim3 grid((tq + 63) / 64, bh);
  flash_fwd_wgmma<D><<<grid, kWgThreads, kBytes, stream>>>(
      tm_q, tm_k, tm_v, static_cast<__nv_bfloat16*>(o), lse, tq, tk, causal,
      window, sm_scale);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes). dtype: 0 = float32 (SIMT),
// 1 = bfloat16 (wgmma + TMA). Returns a cudaError_t; cudaErrorInvalidValue
// for a dtype/head_dim the kernel is not built for (the Python wrapper
// refuses those first) or a tensor map cuTensorMapEncodeTiled refuses.
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o,
                         float* lse, int bh, int tq, int tk, int head_dim,
                         int dtype, int causal, int window, float sm_scale,
                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bh == 0 || tq == 0) return static_cast<int>(cudaSuccess);
  if (dtype == 0 && head_dim == 64)
    return launch_simt<64>(q, k, v, o, lse, bh, tq, tk, causal, window, sm_scale, s);
  if (dtype == 0 && head_dim == 128)
    return launch_simt<128>(q, k, v, o, lse, bh, tq, tk, causal, window, sm_scale, s);
  if (dtype == 1 && head_dim == 64)
    return launch_wgmma<64>(q, k, v, o, lse, bh, tq, tk, causal, window, sm_scale, s);
  if (dtype == 1 && head_dim == 128)
    return launch_wgmma<128>(q, k, v, o, lse, bh, tq, tk, causal, window, sm_scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
