// fused_update: one-pass optimizer step over every parameter leaf, for
// Hopper (sm_90a).
//
// Replaces the JAX package's Pallas kernel
//   K7  sharetrade_tpu/ops/fused_update.py  _kernel (line 102), launched per
//       leaf by _pallas_leaf (line 126) from fused_apply (line 193)
// which, per (256, 128) block of one leaf, upcasts the gradient, runs
// adagrad / adam / sgd in optax's op order and writes the f32 master and
// moments (and optionally the compute-dtype recast of the new master).
// Here ONE launch covers every leaf: the leaves' pointers and sizes travel
// in a table passed by value as a kernel argument (it lands in the kernel's
// constant parameter space), each block finds its leaf from the table's
// block offsets, and each thread updates 4 elements, 256 apart (coalesced).
// The TPU kernel kept leaves under 128 elements out of Pallas (a TPU tiling
// rule); here every leaf, scalars included, goes through the kernel.
//
// Arithmetic, per element, in f32 with every operation rounded on its own
// (__fmul_rn / __fadd_rn / __fdiv_rn / __fsqrt_rn: never contracted into an
// FMA, never an approximate reciprocal), in optax's order:
//   g  = float(grad)
//   adagrad: s' = g*g + s;  inv = s' > 0 ? 1/sqrt(s' + 1e-7) : 0;
//            p' = p + (inv*g)*(-lr)
//   adam:    mu' = (1-b1)*g + b1*mu;  nu' = (1-b2)*(g*g) + b2*nu;
//            u = (mu'/bias1) / (sqrt(nu'/bias2 + 0) + 1e-8);  p' = p + u*(-lr)
//            with bias1 = 1 - b1^count, bias2 = 1 - b2^count read from a
//            2-element device tensor (the counterpart of the SMEM operand
//            at fused_update.py:153-155): no host synchronisation.
//   sgd:     p' = p + g*(-lr)
// Masters and moments are updated in place.
//
// What bounds it on an H100: it is a pure stream. At the flagship (adagrad,
// bf16 grads, 1,583,108 parameters in 34 leaves) it reads p (4 B), g (2 B)
// and s (4 B) and writes p and s (4 B each) and the bf16 compute copy the
// next minibatch differentiates against (2 B): 20 B x 1,583,108 = 31.7 MB,
// about 9.5 us at 3.35 TB/s; 7 FLOP per element is nothing. The whole set
// fits in the 50 MB L2, so it is timed with the L2 flushed between launches.
//
// Left on the table in this first design: 16-byte vector loads (leaf sizes
// and offsets are not multiples of 4 elements in general, so the kernel
// uses scalar loads), and a persistent grid sized to the SM count.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLeaves = 64;      // leaves per launch (Python: _MAX_LEAVES)
constexpr int kThreads = 256;
constexpr int kPerThread = 4;
constexpr int kPerBlock = kThreads * kPerThread;

enum Optimizer { kAdagrad = 0, kAdam = 1, kSgd = 2 };
enum Emit { kEmitNone = 0, kEmitBf16 = 1 };

constexpr float kAdagradEps = 1e-7f;
constexpr float kB1 = 0.9f;
constexpr float kB2 = 0.999f;
constexpr float kOneMinusB1 = static_cast<float>(1.0 - 0.9);    // as optax
constexpr float kOneMinusB2 = static_cast<float>(1.0 - 0.999);
constexpr float kAdamEps = 1e-8f;

struct LeafTable {
  float* p[kMaxLeaves];
  const void* g[kMaxLeaves];
  float* s1[kMaxLeaves];
  float* s2[kMaxLeaves];
  void* pc[kMaxLeaves];
  long long size[kMaxLeaves];
  int block_start[kMaxLeaves + 1];
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <int OPT, typename G, int EMIT>
__global__ void __launch_bounds__(kThreads)
fused_update_kernel(const LeafTable table, int n_leaves, float lr,
                    const float* __restrict__ bias) {
  int leaf = 0;
  while (leaf + 1 < n_leaves &&
         table.block_start[leaf + 1] <= static_cast<int>(blockIdx.x))
    ++leaf;
  const long long n = table.size[leaf];
  const long long base =
      static_cast<long long>(blockIdx.x - table.block_start[leaf]) * kPerBlock;
  float* __restrict__ p = table.p[leaf];
  const G* __restrict__ g = static_cast<const G*>(table.g[leaf]);
  float* __restrict__ s1 = table.s1[leaf];
  float* __restrict__ s2 = table.s2[leaf];
  const float neg_lr = -lr;
  float bias1 = 1.f, bias2 = 1.f;
  if (OPT == kAdam) {
    bias1 = bias[0];
    bias2 = bias[1];
  }
#pragma unroll
  for (int e = 0; e < kPerThread; ++e) {
    const long long i = base + e * kThreads + threadIdx.x;
    if (i >= n) break;
    const float gi = to_float(g[i]);
    const float pi = p[i];
    float p_new;
    if (OPT == kAdagrad) {
      const float s_new = __fadd_rn(__fmul_rn(gi, gi), s1[i]);
      const float inv = s_new > 0.f
          ? __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(s_new, kAdagradEps))) : 0.f;
      p_new = __fadd_rn(pi, __fmul_rn(__fmul_rn(inv, gi), neg_lr));
      s1[i] = s_new;
    } else if (OPT == kAdam) {
      const float mu = __fadd_rn(__fmul_rn(kOneMinusB1, gi),
                                 __fmul_rn(kB1, s1[i]));
      const float nu = __fadd_rn(__fmul_rn(kOneMinusB2, __fmul_rn(gi, gi)),
                                 __fmul_rn(kB2, s2[i]));
      const float mu_hat = __fdiv_rn(mu, bias1);
      const float nu_hat = __fdiv_rn(nu, bias2);
      const float u = __fdiv_rn(
          mu_hat, __fadd_rn(__fsqrt_rn(__fadd_rn(nu_hat, 0.f)), kAdamEps));
      p_new = __fadd_rn(pi, __fmul_rn(u, neg_lr));
      s1[i] = mu;
      s2[i] = nu;
    } else {
      p_new = __fadd_rn(pi, __fmul_rn(gi, neg_lr));
    }
    p[i] = p_new;
    if (EMIT == kEmitBf16)
      static_cast<__nv_bfloat16*>(table.pc[leaf])[i] = __float2bfloat16(p_new);
  }
}

template <int OPT, typename G>
cudaError_t launch_emit(int emit, const LeafTable& table, int n_leaves,
                        int blocks, float lr, const float* bias,
                        cudaStream_t stream) {
  if (emit == kEmitNone)
    fused_update_kernel<OPT, G, kEmitNone><<<blocks, kThreads, 0, stream>>>(
        table, n_leaves, lr, bias);
  else if (emit == kEmitBf16)
    fused_update_kernel<OPT, G, kEmitBf16><<<blocks, kThreads, 0, stream>>>(
        table, n_leaves, lr, bias);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

template <typename G>
cudaError_t launch_opt(int optimizer, int emit, const LeafTable& table,
                       int n_leaves, int blocks, float lr, const float* bias,
                       cudaStream_t stream) {
  if (optimizer == kAdagrad)
    return launch_emit<kAdagrad, G>(emit, table, n_leaves, blocks, lr, bias, stream);
  if (optimizer == kAdam)
    return launch_emit<kAdam, G>(emit, table, n_leaves, blocks, lr, bias, stream);
  if (optimizer == kSgd)
    return launch_emit<kSgd, G>(emit, table, n_leaves, blocks, lr, bias, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry point (loaded with ctypes). optimizer: 0 adagrad, 1 adam,
// 2 sgd; grad_dtype: 0 float32, 1 bfloat16; emit: 0 none, 1 bfloat16.
// The per-leaf arrays hold device addresses (s1/s2/pc entries
// unused by the optimizer or the emit mode may be 0) and element counts.
// Leaves go kMaxLeaves per launch; *launches receives the number launched.
// Returns a cudaError_t.
extern "C" int fused_update(int optimizer, int grad_dtype, int emit,
                            int n_leaves, const long long* p,
                            const long long* g, const long long* s1,
                            const long long* s2, const long long* pc,
                            const long long* sizes, float lr,
                            const float* bias, void* stream, int* launches) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  *launches = 0;
  for (int first = 0; first < n_leaves; first += kMaxLeaves) {
    const int count = n_leaves - first < kMaxLeaves ? n_leaves - first
                                                    : kMaxLeaves;
    LeafTable table = {};
    int blocks = 0;
    for (int j = 0; j < count; ++j) {
      const int i = first + j;
      table.p[j] = reinterpret_cast<float*>(p[i]);
      table.g[j] = reinterpret_cast<const void*>(g[i]);
      table.s1[j] = reinterpret_cast<float*>(s1[i]);
      table.s2[j] = reinterpret_cast<float*>(s2[i]);
      table.pc[j] = reinterpret_cast<void*>(pc[i]);
      table.size[j] = sizes[i];
      table.block_start[j] = blocks;
      blocks += static_cast<int>((sizes[i] + kPerBlock - 1) / kPerBlock);
    }
    table.block_start[count] = blocks;
    if (blocks == 0) continue;
    cudaError_t err;
    if (grad_dtype == 0)
      err = launch_opt<float>(optimizer, emit, table, count, blocks, lr, bias, st);
    else if (grad_dtype == 1)
      err = launch_opt<__nv_bfloat16>(optimizer, emit, table, count, blocks, lr, bias, st);
    else
      err = cudaErrorInvalidValue;
    if (err != cudaSuccess) return static_cast<int>(err);
    ++*launches;
  }
  return static_cast<int>(cudaSuccess);
}
