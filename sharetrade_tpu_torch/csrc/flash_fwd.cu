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
//   s = (q . k) * sm_scale in f32; key c is visible to row r when c < tk and,
//   if causal, r - window < c <= r. Online softmax in f32; for bf16 inputs
//   P is rounded to bf16 before the P.V product (the row sum l uses the
//   unrounded P), as the Pallas kernel does. A row that sees no key gives
//   o = 0 and lse = 0.
//
// What bounds it on an H100: at the serving shape (bh = 128, T = 401,
// D = 128, window 201, bf16) q, k, v and o are about 52.6 MB per launch,
// about 15.7 us at 3.35 TB/s, against about 3.97 GFLOP over the band, about
// 4 us at the 989 TFLOP/s bf16 tensor-core rate: memory-bound on paper.
//
// This first design is plain and correct rather than fast:
//   - one block of 256 threads per (bh, 64-row query tile); 64-row K and V
//     tiles staged through shared memory, converted to f32;
//   - S = Q K^T and O += P V as register-tiled SIMT FMA loops (each thread
//     owns a 4x4 tile of S and a 4 x D/16 tile of O), so f32 inputs get full
//     f32 products, never TF32;
//   - K and V share one shared-memory buffer (85 KB at D = 128), which
//     keeps two blocks resident per SM.
// Left on the table for later work: wgmma tensor-core products (the SIMT
// loops cap the bf16 path near the 67 TFLOP/s f32 FMA rate instead of 989),
// TMA / cp.async double-buffered K/V loads that overlap the math, warp
// specialisation, and bf16 tiles kept in bf16 in shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

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
  constexpr int kVec = 16 / sizeof(T);       // elements per 16-byte load
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

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
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
  const T* qb = q + static_cast<int64_t>(bh) * tq * D;
  const T* kb = k + static_cast<int64_t>(bh) * tk * D;
  const T* vb = v + static_cast<int64_t>(bh) * tk * D;

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

  load_tile<T, D>(qb, q0, tq, q_s);

  if (k_lo <= k_hi) {
    for (int kt = k_lo / kBlockK; kt <= k_hi / kBlockK; ++kt) {
      const int k0 = kt * kBlockK;
      __syncthreads();                 // q_s ready; kv_s/p_s free for reuse
      load_tile<T, D>(kb, k0, tk, kv_s);
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
      load_tile<T, D>(vb, k0, tk, kv_s);

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
          p_s[(ty * 4 + i) * kPRow + tx + 16 * j] = round_like(s[i][j], q);
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
    T* orow = o + (static_cast<int64_t>(bh) * tq + row) * D;
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

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int bh, int tq, int tk, int causal, int window,
                   float sm_scale, cudaStream_t stream) {
  constexpr size_t kBytes = Smem<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kBytes));
  if (err != cudaSuccess) return err;
  const dim3 grid((tq + kBlockQ - 1) / kBlockQ, bh);
  flash_fwd_kernel<T, D><<<grid, kThreads, kBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, tq, tk, causal,
      window, sm_scale);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes). dtype: 0 = float32, 1 = bfloat16.
// Returns a cudaError_t; cudaErrorInvalidValue for a dtype/head_dim the
// kernel is not built for (the Python wrapper refuses those first).
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o,
                         float* lse, int bh, int tq, int tk, int head_dim,
                         int dtype, int causal, int window, float sm_scale,
                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bh == 0 || tq == 0) return static_cast<int>(cudaSuccess);
  if (dtype == 0 && head_dim == 64)
    return launch<float, 64>(q, k, v, o, lse, bh, tq, tk, causal, window, sm_scale, s);
  if (dtype == 0 && head_dim == 128)
    return launch<float, 128>(q, k, v, o, lse, bh, tq, tk, causal, window, sm_scale, s);
  if (dtype == 1 && head_dim == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, o, lse, bh, tq, tk, causal, window, sm_scale, s);
  if (dtype == 1 && head_dim == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, o, lse, bh, tq, tk, causal, window, sm_scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
