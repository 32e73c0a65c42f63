// fused_update: one-pass optimizer step over every parameter leaf, for
// Hopper (sm_90a).
//
// Replaces the JAX package's Pallas kernel
//   K7  sharetrade_tpu/ops/fused_update.py  _kernel (line 102), launched per
//       leaf by _pallas_leaf (line 126) from fused_apply (line 193)
// which, per (256, 128) block of one leaf, upcasts the gradient, runs
// adagrad / adam / sgd in optax's op order and writes the f32 master and
// moments (and optionally the compute-dtype recast of the new master).
// Here ONE launch covers up to 64 leaves: their pointers, sizes and tile
// offsets travel in a table passed by value (__grid_constant__, so it stays
// in the constant parameter bank and is never copied to local memory). The
// TPU kernel kept leaves under 128 elements out of Pallas (a TPU tiling
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
// An optional gate, a one-element bool or integer device tensor read in its
// own width (1, 2, 4 or 8 bytes), turns the whole update off when it holds
// 0: masters, moments and adam's count stay as they were (the compute copy,
// when asked for, is then the recast of the unchanged master). It is the
// JAX package's ``where(any_active, new, old)`` over params and optimizer
// state (sharetrade_tpu/agents/qlearn.py, dqn.py), read on the device, so a
// step where no agent is active (or a DQN replay not yet ready) costs no
// host synchronisation and no cast kernel.
//
// What bounds it on an H100: it is a pure stream. At the flagship (adagrad,
// bf16 grads, 1,583,108 parameters in 34 leaves) it reads p (4 B), g (2 B)
// and s (4 B) and writes p and s (4 B each) and the bf16 compute copy the
// next minibatch differentiates against (2 B): 20 B x 1,583,108 = 31.7 MB,
// about 9.5 us at 3.35 TB/s; 7 FLOP per element is nothing. At the
// reference Q-network (4 leaves, 41,403 parameters, f32 grads) the stream
// is 0.83 MB, about 0.25 us: there one HBM round trip and the launch set the
// time, and the cure for the launch is a graph of the whole step.
//
// This design (vec16+persistent):
// - A tile is 8 elements per thread of a block (4 for adam), of one leaf:
//   thread t of T takes the 4-element vectors at tile offsets 4t and
//   4T + 4t, so every warp instruction moves one contiguous run: a float4 a
//   thread of each f32 operand (512 bytes a warp), 8 bytes (4 values) of
//   each bf16 operand (256 bytes a warp). A thread owning 8 contiguous
//   elements instead (bf16 as uint4) left each f32 instruction half of
//   every sector it touched and measured slower than the scalar design it
//   replaces (one element a thread a load, 256-thread blocks); two
//   vectors a thread for adam held 106 registers and measured slower too.
//   The wrapper's plan gives each leaf its tiles (a prefix table) and picks
//   the block size (32, 64 or 128 threads) so that a small set still
//   spreads over the SMs.
// - Persistent grid: at most SMs x resident blocks per SM (both read once
//   and cached here), balanced so every block walks the same number of
//   tiles with a grid-stride loop; a warp finds its tile's leaf with one
//   ballot over the prefix table, staged in shared memory once per block
//   (no chain of dependent reads, no serialised constant-bank reads).
// - Bytes in flight: a thread issues every load of its tile before any
//   arithmetic on them, and the next tile's loads before the current
//   tile's stores (a register double buffer); loaded values are kept raw
//   until they are used, so no conversion waits on a load early. The gate
//   and adam's bias corrections are read after the first loads are issued.
// - A vector goes as one access only when it is whole and every pointer of
//   its leaf is 16-byte aligned (decided in the kernel from the pointers).
//   A leaf's last size % 4 elements, and every element of a misaligned
//   leaf (a view at an odd element offset), take predicated scalar
//   accesses. Leaves from PyTorch's allocator start 256-byte aligned, so
//   there is no head to peel.
// What the card showed (H100 80GB HBM3 at 700 W; tools/torch_update_ab.py,
// PERF.md section 6): one call timed alone carries ~5 us of launch (an
// empty kernel timed the same way) and, with the L2 flushed by writes, the
// flush's dirty lines. Replayed back to back in a CUDA graph over leaves
// larger than the L2, the flagship's update takes 13.8 us (2.30 TB/s, 69%
// of its bound; the scalar design it replaces 14.5 us), and one leaf of
// 2^26 elements streams at 2.89 TB/s (the scalar design 3.02 TB/s). The
// gains are at the sets the port runs (one HBM round trip, no dependent
// reads) and in the host path. A cp.async.bulk (1-D TMA) ring through
// shared memory was tried for the flagship's case and was no faster;
// it is not kept. Left on the table: moving adam's count and bias
// corrections into the kernel (that needs a grid-wide ordering).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int kMaxLeaves = 64;      // leaves per launch (Python: MAX_LEAVES)
constexpr int kMaxThreads = 128;    // largest block (Python: TILE_UNITS)
constexpr int kVec = 4;             // elements a vector (Python: VEC)

enum Optimizer { kAdagrad = 0, kAdam = 1, kSgd = 2 };

// Vectors a thread takes a tile (Python: UNITS[optimizer] // VEC): two,
// except adam, whose four f32 streams at two vectors held 106 registers and
// ran slower than the scalar design; at one (52 registers) it ran faster.
template <int OPT>
constexpr int kVecsOf = OPT == kAdam ? 1 : 2;

// Elements a thread takes a tile, by optimizer code (Python: UNITS); 0 for
// an unknown code.
int unit_of(int optimizer) {
  switch (optimizer) {
    case kAdagrad: return kVecsOf<kAdagrad> * kVec;
    case kAdam: return kVecsOf<kAdam> * kVec;
    case kSgd: return kVecsOf<kSgd> * kVec;
    default: return 0;
  }
}
enum Emit { kEmitNone = 0, kEmitBf16 = 1 };

constexpr float kAdagradEps = 1e-7f;
constexpr float kB1 = 0.9f;
constexpr float kB2 = 0.999f;
constexpr float kOneMinusB1 = static_cast<float>(1.0 - 0.9);    // as optax
constexpr float kOneMinusB2 = static_cast<float>(1.0 - 0.999);
constexpr float kAdamEps = 1e-8f;

// 64 x (5 pointers + a size) + 65 tile offsets = 3,332 bytes: with the
// other arguments under the 4,096-byte kernel-parameter limit of every
// CUDA 12 toolkit.
struct LeafTable {
  float* p[kMaxLeaves];
  const void* g[kMaxLeaves];
  float* s1[kMaxLeaves];
  float* s2[kMaxLeaves];
  void* pc[kMaxLeaves];
  long long size[kMaxLeaves];
  int tile_start[kMaxLeaves + 1];
};

// A thread's share of one tile, two 4-element vectors of one leaf: its
// elements [i, i + 4) and [i + 4T, i + 4T + 4), T the block size, so each
// warp instruction reads or writes one contiguous run (512 bytes of an f32
// operand, 256 of a bf16 one). Operands as loaded; grads as raw words (8
// f32, or 8 bf16 packed two to a word).
template <typename G, int V>
struct Unit {
  static constexpr int kElems = V * kVec;
  static constexpr int kGradWords = kElems * sizeof(G) / 4;
  float* p;
  const G* g;
  float* s1;
  float* s2;
  __nv_bfloat16* pc;
  long long i[V];   // first element of each vector
  int valid[V];     // elements of each vector inside the leaf (0..4)
  bool aligned;     // every pointer of the leaf 16-byte aligned
  float pv[kElems], s1v[kElems], s2v[kElems];
  uint32_t gw[kGradWords];
  __device__ __forceinline__ bool vec(int h) const {
    return aligned && valid[h] == kVec;
  }
};

template <int V>
__device__ __forceinline__ float grad_at(const Unit<float, V>& u, int e) {
  return __uint_as_float(u.gw[e]);
}
template <int V>
__device__ __forceinline__ float grad_at(const Unit<__nv_bfloat16, V>& u,
                                         int e) {
  const uint32_t w = u.gw[e >> 1];     // element 2k in the low half
  return __uint_as_float((e & 1) ? (w & 0xffff0000u) : (w << 16));
}

// Vector h's grads: one float4 (f32) or one 8-byte load of 4 bf16.
template <int V>
__device__ __forceinline__ void load_grads(Unit<float, V>& u, int h) {
  const uint4 a = *reinterpret_cast<const uint4*>(u.g + u.i[h]);
  u.gw[4 * h] = a.x; u.gw[4 * h + 1] = a.y;
  u.gw[4 * h + 2] = a.z; u.gw[4 * h + 3] = a.w;
}
template <int V>
__device__ __forceinline__ void load_grads(Unit<__nv_bfloat16, V>& u,
                                           int h) {
  const uint2 a = *reinterpret_cast<const uint2*>(u.g + u.i[h]);
  u.gw[2 * h] = a.x; u.gw[2 * h + 1] = a.y;
}

// One grad element into the unit's raw words, as the vector load lays it.
template <int V>
__device__ __forceinline__ void set_grad(Unit<float, V>& u, int e, float x) {
  u.gw[e] = __float_as_uint(x);
}
template <int V>
__device__ __forceinline__ void set_grad(Unit<__nv_bfloat16, V>& u, int e,
                                         __nv_bfloat16 x) {
  u.gw[e >> 1] |= static_cast<uint32_t>(__bfloat16_as_ushort(x))
                  << (16 * (e & 1));
}

template <int N>
__device__ __forceinline__ void load4(const float* src, float (&x)[N],
                                      int h) {
  const float4 a = *reinterpret_cast<const float4*>(src);
  x[4 * h] = a.x; x[4 * h + 1] = a.y; x[4 * h + 2] = a.z; x[4 * h + 3] = a.w;
}

template <int N>
__device__ __forceinline__ void store4(float* dst, const float (&x)[N],
                                       int h) {
  *reinterpret_cast<float4*>(dst) =
      make_float4(x[4 * h], x[4 * h + 1], x[4 * h + 2], x[4 * h + 3]);
}

// The tile's leaf: the last leaf of the launch whose first tile is at or
// before it (empty leaves are passed over). The starts never decrease, so
// it is the count of leaves starting at or before the tile, less one; each
// lane reads two starts from the block's shared copy (``starts``, staged
// once per block: lanes reading different entries of the parameter bank
// would serialise on the constant cache) and the warp counts them with a
// ballot, with no chain of dependent reads.
__device__ __forceinline__ int leaf_of(const int* starts, int n_leaves,
                                       int tile) {
  const int lane = threadIdx.x & 31;
  const bool lo = lane < n_leaves && starts[lane] <= tile;
  const bool hi = lane + 32 < n_leaves && starts[lane + 32] <= tile;
  return __popc(__ballot_sync(0xffffffffu, lo))
      + __popc(__ballot_sync(0xffffffffu, hi)) - 1;
}

// Find tile ``tile``'s leaf and issue every load of this thread's two
// vectors: 16-byte (f32) or 8-byte (bf16) vectors where the vector is whole
// and the leaf aligned, else predicated scalar loads (the rest left 0).
// Nothing here waits on a load.
template <int OPT, typename G, int V>
__device__ __forceinline__ void load_unit(const LeafTable& t,
                                          const int* starts, int n_leaves,
                                          int tile, Unit<G, V>& u) {
  const int leaf = leaf_of(starts, n_leaves, tile);
  u.p = t.p[leaf];
  u.g = static_cast<const G*>(t.g[leaf]);
  u.s1 = t.s1[leaf];
  u.s2 = t.s2[leaf];
  u.pc = static_cast<__nv_bfloat16*>(t.pc[leaf]);
  const long long n = t.size[leaf];
  const long long first =
      static_cast<long long>(tile - t.tile_start[leaf]) * blockDim.x * V * kVec
      + threadIdx.x * kVec;
  const uintptr_t any = reinterpret_cast<uintptr_t>(u.p)
      | reinterpret_cast<uintptr_t>(u.g) | reinterpret_cast<uintptr_t>(u.s1)
      | reinterpret_cast<uintptr_t>(u.s2) | reinterpret_cast<uintptr_t>(u.pc);
  u.aligned = (any & 15u) == 0;
#pragma unroll
  for (int h = 0; h < V; ++h) {
    u.i[h] = first + static_cast<long long>(h) * blockDim.x * kVec;
    const long long left = n - u.i[h];
    u.valid[h] = left <= 0 ? 0 : (left >= kVec ? kVec : static_cast<int>(left));
  }
#pragma unroll
  for (int k = 0; k < Unit<G, V>::kGradWords; ++k) u.gw[k] = 0u;
#pragma unroll
  for (int h = 0; h < V; ++h) {
    const long long i = u.i[h];
    if (u.vec(h)) {
      load4(u.p + i, u.pv, h);
      load_grads(u, h);
      if (OPT != kSgd) load4(u.s1 + i, u.s1v, h);
      if (OPT == kAdam) load4(u.s2 + i, u.s2v, h);
    } else {
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        const int e = kVec * h + k;
        u.pv[e] = 0.f; u.s1v[e] = 0.f; u.s2v[e] = 0.f;
        if (k < u.valid[h]) {
          u.pv[e] = u.p[i + k];
          set_grad(u, e, u.g[i + k]);
          if (OPT != kSgd) u.s1v[e] = u.s1[i + k];
          if (OPT == kAdam) u.s2v[e] = u.s2[i + k];
        }
      }
    }
  }
}

// Vector h of the compute copy: 4 bf16 in one 8-byte store, or scalars.
template <int EMIT, typename G, int V>
__device__ __forceinline__ void store_compute(const Unit<G, V>& u, int h) {
  const float (&x)[Unit<G, V>::kElems] = u.pv;
  if (EMIT != kEmitBf16) return;
  const long long i = u.i[h];
  if (u.vec(h)) {
    uint32_t w[2];
#pragma unroll
    for (int k = 0; k < 2; ++k)
      w[k] = static_cast<uint32_t>(__bfloat16_as_ushort(
                 __float2bfloat16(x[4 * h + 2 * k])))
          | (static_cast<uint32_t>(__bfloat16_as_ushort(
                 __float2bfloat16(x[4 * h + 2 * k + 1]))) << 16);
    *reinterpret_cast<uint2*>(u.pc + i) = make_uint2(w[0], w[1]);
  } else {
#pragma unroll
    for (int k = 0; k < kVec; ++k)
      if (k < u.valid[h]) u.pc[i + k] = __float2bfloat16(x[4 * h + k]);
  }
}

// The update of one unit (every lane computed, only the valid ones
// stored), or with the gate off only the compute copy of the old master.
template <int OPT, typename G, int EMIT, int V>
__device__ __forceinline__ void update_unit(Unit<G, V>& u, bool on,
                                            float neg_lr, float bias1,
                                            float bias2) {
  if (!on) {
#pragma unroll
    for (int h = 0; h < V; ++h) store_compute<EMIT>(u, h);
    return;
  }
#pragma unroll
  for (int e = 0; e < Unit<G, V>::kElems; ++e) {
    const float gi = grad_at(u, e);
    const float pi = u.pv[e];
    if (OPT == kAdagrad) {
      const float s_new = __fadd_rn(__fmul_rn(gi, gi), u.s1v[e]);
      const float inv = s_new > 0.f
          ? __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(s_new, kAdagradEps))) : 0.f;
      u.pv[e] = __fadd_rn(pi, __fmul_rn(__fmul_rn(inv, gi), neg_lr));
      u.s1v[e] = s_new;
    } else if (OPT == kAdam) {
      const float mu = __fadd_rn(__fmul_rn(kOneMinusB1, gi),
                                 __fmul_rn(kB1, u.s1v[e]));
      const float nu = __fadd_rn(__fmul_rn(kOneMinusB2, __fmul_rn(gi, gi)),
                                 __fmul_rn(kB2, u.s2v[e]));
      const float mu_hat = __fdiv_rn(mu, bias1);
      const float nu_hat = __fdiv_rn(nu, bias2);
      const float upd = __fdiv_rn(
          mu_hat, __fadd_rn(__fsqrt_rn(__fadd_rn(nu_hat, 0.f)), kAdamEps));
      u.pv[e] = __fadd_rn(pi, __fmul_rn(upd, neg_lr));
      u.s1v[e] = mu;
      u.s2v[e] = nu;
    } else {
      u.pv[e] = __fadd_rn(pi, __fmul_rn(gi, neg_lr));
    }
  }
#pragma unroll
  for (int h = 0; h < V; ++h) {
    const long long i = u.i[h];
    if (u.vec(h)) {
      store4(u.p + i, u.pv, h);
      if (OPT != kSgd) store4(u.s1 + i, u.s1v, h);
      if (OPT == kAdam) store4(u.s2 + i, u.s2v, h);
    } else {
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        if (k < u.valid[h]) {
          u.p[i + k] = u.pv[4 * h + k];
          if (OPT != kSgd) u.s1[i + k] = u.s1v[4 * h + k];
          if (OPT == kAdam) u.s2[i + k] = u.s2v[4 * h + k];
        }
      }
    }
    store_compute<EMIT>(u, h);
  }
}

__device__ __forceinline__ bool gate_is_on(const void* gate, int bytes) {
  switch (bytes) {
    case 1: return *static_cast<const uint8_t*>(gate) != 0;
    case 2: return *static_cast<const uint16_t*>(gate) != 0;
    case 4: return *static_cast<const uint32_t*>(gate) != 0;
    case 8: return *static_cast<const unsigned long long*>(gate) != 0;
    default: return true;    // no gate
  }
}

template <int OPT, typename G, int EMIT>
__global__ void __launch_bounds__(kMaxThreads)
fused_update_vec(const __grid_constant__ LeafTable table, int n_leaves,
                 int n_tiles, float lr, const float* __restrict__ bias,
                 const void* __restrict__ gate, int gate_bytes) {
  int tile = blockIdx.x;
  if (tile >= n_tiles) return;    // the whole block: tiles are per block
  __shared__ int starts[kMaxLeaves];
  for (int j = threadIdx.x; j < n_leaves; j += blockDim.x)
    starts[j] = table.tile_start[j];
  __syncthreads();
  Unit<G, kVecsOf<OPT>> cur, nxt;
  load_unit<OPT>(table, starts, n_leaves, tile, cur);
  // Read after the first unit's loads are issued, so they overlap.
  const bool on = gate_is_on(gate, gate_bytes);
  float bias1 = 1.f, bias2 = 1.f;
  if (OPT == kAdam) {
    bias1 = bias[0];
    bias2 = bias[1];
  }
  const float neg_lr = -lr;
  for (;;) {
    const int next = tile + gridDim.x;
    const bool more = next < n_tiles;
    if (more) load_unit<OPT>(table, starts, n_leaves, next, nxt);
    update_unit<OPT, G, EMIT>(cur, on, neg_lr, bias1, bias2);
    if (!more) break;
    cur = nxt;
    tile = next;
  }
}

// SMs and resident blocks per SM of each (kernel, block size, device),
// read once.
struct Residency {
  const void* kernel;
  int threads;
  int device;
  int slots;    // SMs x resident blocks per SM
};
std::mutex g_residency_lock;
Residency g_residency[256];
int g_residency_count = 0;

template <typename Kernel>
cudaError_t slots_for(Kernel kernel, int threads, int* slots) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const void* key = reinterpret_cast<const void*>(kernel);
  std::lock_guard<std::mutex> guard(g_residency_lock);
  for (int k = 0; k < g_residency_count; ++k) {
    const Residency& r = g_residency[k];
    if (r.kernel == key && r.threads == threads && r.device == device) {
      *slots = r.slots;
      return cudaSuccess;
    }
  }
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, 0);
  if (err != cudaSuccess) return err;
  *slots = sms * (per_sm > 0 ? per_sm : 1);
  if (g_residency_count < 256)
    g_residency[g_residency_count++] = {key, threads, device, *slots};
  return cudaSuccess;
}

template <int OPT, typename G, int EMIT>
cudaError_t launch(const LeafTable& table, int n_leaves, int n_tiles,
                   int threads, float lr, const float* bias,
                   const void* gate, int gate_bytes, cudaStream_t stream) {
  auto kernel = fused_update_vec<OPT, G, EMIT>;
  int slots = 0;
  cudaError_t err = slots_for(kernel, threads, &slots);
  if (err != cudaSuccess) return err;
  // Balanced: every block walks ceil(n_tiles / slots) tiles.
  const int per_block = (n_tiles + slots - 1) / slots;
  const int grid = (n_tiles + per_block - 1) / per_block;
  kernel<<<grid, threads, 0, stream>>>(table, n_leaves, n_tiles, lr, bias,
                                       gate, gate_bytes);
  return cudaGetLastError();
}

template <typename G>
cudaError_t launch_opt(int optimizer, int emit, const LeafTable& table,
                       int n_leaves, int n_tiles, int threads, float lr,
                       const float* bias, const void* gate, int gate_bytes,
                       cudaStream_t stream) {
#define FU_LAUNCH(OPT, EMIT)                                              \
  return launch<OPT, G, EMIT>(table, n_leaves, n_tiles, threads, lr, bias, \
                              gate, gate_bytes, stream)
  if (optimizer == kAdagrad) {
    if (emit == kEmitNone) FU_LAUNCH(kAdagrad, kEmitNone);
    if (emit == kEmitBf16) FU_LAUNCH(kAdagrad, kEmitBf16);
  } else if (optimizer == kAdam) {
    if (emit == kEmitNone) FU_LAUNCH(kAdam, kEmitNone);
    if (emit == kEmitBf16) FU_LAUNCH(kAdam, kEmitBf16);
  } else if (optimizer == kSgd) {
    if (emit == kEmitNone) FU_LAUNCH(kSgd, kEmitNone);
    if (emit == kEmitBf16) FU_LAUNCH(kSgd, kEmitBf16);
  }
#undef FU_LAUNCH
  return cudaErrorInvalidValue;
}

}  // namespace

// One call's arguments, laid out as the wrapper's ctypes structure
// (ops/fused_update.py, _Call). The plan's fields (tile size, launch ranges,
// tile prefix, sizes) and the pointer arrays stay put between calls; the
// wrapper refills the arrays' entries and the scalars in place.
struct FusedUpdateCall {
  int optimizer;              // 0 adagrad, 1 adam, 2 sgd
  int grad_dtype;             // 0 float32, 1 bfloat16
  int emit;                   // 0 none, 1 bfloat16 compute copy
  int n_leaves;
  int tile_units;             // threads per block: 32, 64 or 128
  int unit;                   // elements a thread a tile, as the plan has it
  int n_launches;
  const int* launch_leaves;   // n_launches (first, end) leaf ranges
  const int* tile_start;      // n_leaves + 1: tiles before each leaf
  const long long* sizes;     // elements per leaf
  const long long* p;         // device addresses per leaf; 0 where unused
  const long long* g;
  const long long* s1;
  const long long* s2;
  const long long* pc;
  float lr;
  const float* bias;          // adam's [1 - b1^count, 1 - b2^count]
  const void* gate;           // null, or a one-element device tensor
  int gate_bytes;             // the gate's element size (0: no gate)
  void* stream;
  int launched;               // out: kernels launched
};

// Plain C entry point (loaded with ctypes). Launches one kernel per launch
// group of the plan (at most kMaxLeaves leaves each) on ``stream``; host
// work only, no synchronisation, nothing allocated, so the call can be
// captured in a CUDA graph. Returns a cudaError_t.
extern "C" int fused_update(FusedUpdateCall* call) {
  cudaStream_t stream = static_cast<cudaStream_t>(call->stream);
  call->launched = 0;
  // The plan's tile offsets count tiles of tile_units x unit elements; a
  // unit other than this kernel's would skip or repeat elements.
  if (call->tile_units <= 0 || call->tile_units > kMaxThreads
      || call->tile_units % 32 != 0
      || call->unit != unit_of(call->optimizer))
    return static_cast<int>(cudaErrorInvalidValue);
  for (int l = 0; l < call->n_launches; ++l) {
    const int first = call->launch_leaves[2 * l];
    const int count = call->launch_leaves[2 * l + 1] - first;
    if (count <= 0 || count > kMaxLeaves)
      return static_cast<int>(cudaErrorInvalidValue);
    LeafTable table;
    for (int j = 0; j < count; ++j) {
      const int i = first + j;
      table.p[j] = reinterpret_cast<float*>(call->p[i]);
      table.g[j] = reinterpret_cast<const void*>(call->g[i]);
      table.s1[j] = reinterpret_cast<float*>(call->s1[i]);
      table.s2[j] = reinterpret_cast<float*>(call->s2[i]);
      table.pc[j] = reinterpret_cast<void*>(call->pc[i]);
      table.size[j] = call->sizes[i];
      table.tile_start[j] = call->tile_start[i] - call->tile_start[first];
    }
    const int n_tiles = call->tile_start[first + count]
        - call->tile_start[first];
    table.tile_start[count] = n_tiles;
    if (n_tiles <= 0) continue;
    cudaError_t err;
    if (call->grad_dtype == 0)
      err = launch_opt<float>(call->optimizer, call->emit, table, count,
                              n_tiles, call->tile_units, call->lr,
                              call->bias, call->gate, call->gate_bytes,
                              stream);
    else if (call->grad_dtype == 1)
      err = launch_opt<__nv_bfloat16>(call->optimizer, call->emit, table,
                                      count, n_tiles, call->tile_units,
                                      call->lr, call->bias, call->gate,
                                      call->gate_bytes, stream);
    else
      err = cudaErrorInvalidValue;
    if (err != cudaSuccess) return static_cast<int>(err);
    ++call->launched;
  }
  return static_cast<int>(cudaSuccess);
}
