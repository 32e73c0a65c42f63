// hopper.cuh: the Hopper (sm_90a) building blocks of the port's bf16
// kernels, as inline PTX; no CUTLASS, so each source stays one plain nvcc
// call. Included by flash_fwd.cu and flash_bwd.cu.
//
//   - TMA: 3-D tensor maps (D, T, b*h) of a contiguous (b*h, T, D) bf16
//     tensor with a (64 columns, 64 rows, 1) box and the 128-byte swizzle,
//     encoded on the host per call (they hold the pointer) with
//     cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint so the
//     library need not link libcuda. A 64 x D tile is D / 64 boxes of 8 KB,
//     one after the other; rows past T are zero-filled by the hardware, and
//     the third dimension keeps a ragged tile from reading the next head.
//   - mbarrier: init, arrive with expect-tx (one arrival, the TMA bytes),
//     and a parity try-wait loop.
//   - wgmma: m64nNk16 bf16 -> f32 with A and B from shared memory or A from
//     registers, plus fence / commit / wait and the shared-memory matrix
//     descriptors of the 128-byte swizzle that TMA writes: K-major (rows of
//     the contraction dimension, advanced 32 bytes per k16 step inside a
//     128-byte row, 1024 bytes between 8-row groups) and MN-major (the tile
//     read transposed: 2048 bytes per k16 step of rows, 1024 bytes between
//     8-row groups, 8192 bytes between 64-column boxes).
//   - Thread-block clusters: a launch with a cluster dimension
//     (launch_cluster, cudaLaunchKernelEx), the most clusters the card
//     holds at once, a block's rank in its cluster, the two halves of the
//     cluster barrier (arrive with release, wait with acquire), and a
//     16-byte load from a peer block's shared memory (distributed shared
//     memory: mapa, then ld.shared::cluster).
//
// Fragment layouts (PTX ISA, wgmma): warp w of the warpgroup owns rows
// 16w .. 16w+15 of a 64-row accumulator; lane l = 4g + t holds, for every
// 8-column group j, d[4j + 2h + e] = D[16w + g + 8h][8j + 2t + e]. A k16
// slice kk of that accumulator, rounded to bf16 pairs, is exactly the
// register A fragment of the next product: a[h'] = pack(d[8kk + 2h'],
// d[8kk + 2h' + 1]).

#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <utility>

namespace hopper {

constexpr int kBox = 64;                        // rows and bf16 columns of a box
constexpr int kBoxBytes = kBox * kBox * 2;      // 8 KB

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// Raise a kernel's dynamic shared-memory limit once per device, not on
// every launch (one flag per kernel: the template is keyed on the kernel
// itself, since instantiations of one kernel share a type).
template <auto Kernel>
inline cudaError_t set_smem_once(int bytes) {
  constexpr int kDevices = 64;
  static std::atomic<bool> done[kDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kDevices) return cudaErrorInvalidDevice;
  if (done[dev].load(std::memory_order_acquire)) return cudaSuccess;
  err = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess) done[dev].store(true, std::memory_order_release);
  return err;
}

// The most clusters of `cluster` blocks of Kernel (`threads` threads and
// `smem` bytes of dynamic shared memory a block, the limit raised with
// set_smem_once first) that the device holds at once; asked once per device
// (one cluster size per kernel: the template is keyed on the kernel).
template <auto Kernel>
inline cudaError_t max_active_clusters_once(int threads, int smem, int cluster,
                                            int* clusters) {
  constexpr int kDevices = 64;
  static std::atomic<int> known[kDevices];      // clusters + 1; 0: not asked
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kDevices) return cudaErrorInvalidDevice;
  const int seen = known[dev].load(std::memory_order_acquire);
  if (seen > 0) {
    *clusters = seen - 1;
    return cudaSuccess;
  }
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaOccupancyMaxActiveClusters(clusters, Kernel, &cfg);
  if (err == cudaSuccess) known[dev].store(*clusters + 1, std::memory_order_release);
  return err;
}

// Launches `kernel` with clusters of `cluster` blocks along x (gridDim.x a
// multiple of it); one launch, checked like <<<>>> by the caller.
template <typename... Params, typename... Args>
inline cudaError_t launch_cluster(void (*kernel)(Params...), dim3 grid, int threads,
                                  int smem, cudaStream_t stream, int cluster,
                                  Args&&... args) {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, std::forward<Args>(args)...);
}

inline PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault,
                                &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      ptr = nullptr;
    return reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(ptr);
  }();
  return fn;
}

// The (D, rows, bh) map of a contiguous (bh, rows, D) bf16 tensor; box
// (64, 64, 1), 128-byte swizzle, out-of-bounds elements read as zero.
inline cudaError_t make_tile_map(CUtensorMap* map, const void* ptr, int head_dim,
                                 int rows, int bh) {
  PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(head_dim),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(bh)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(head_dim) * 2,
                                 static_cast<cuuint64_t>(rows) * head_dim * 2};
  const cuuint32_t box[3] = {kBox, kBox, 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
      strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// device side
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The dynamic shared-memory base rounded up to 1024 bytes (the 128-byte
// swizzle's period); each kernel asks for 1024 bytes of slack.
__device__ __forceinline__ uint8_t* align_1024(uint8_t* p) {
  const uint32_t s = smem_u32(p);
  return p + (((s + 1023u) & ~1023u) - s);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

// Makes the barriers' initialisation visible to the async (TMA) proxy.
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t ns;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(ns));
  return ns;
}

// Waits for the barrier's phase `parity` to complete. A wait that lasts
// over 10 s (a load that never lands) traps, so a fault ends the kernel
// with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  uint64_t start = 0;
  for (uint32_t spin = 0;; ++spin) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
    if (done) return;
    if ((spin & 1023u) == 0) {
      const uint64_t now = global_ns();
      if (spin == 0) start = now;
      else if (now - start > 10000000000ull) __trap();
    }
  }
}

// One box: columns [c0, c0 + 64), rows [c1, c1 + 64) of head c2.
__device__ __forceinline__ void tma_load_box(void* dst, const CUtensorMap* map,
                                             uint64_t* bar, int c0, int c1,
                                             int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// Rows [row0, row0 + 64) x all D columns of head bh: D / 64 boxes, 8 KB
// apart. The caller has armed `bar` with D * 128 bytes.
template <int D>
__device__ __forceinline__ void tma_load_tile(uint8_t* dst, const CUtensorMap* map,
                                              uint64_t* bar, int row0, int bh) {
#pragma unroll
  for (int b = 0; b < D / kBox; ++b)
    tma_load_box(dst + b * kBoxBytes, map, bar, b * kBox, row0, bh);
}

__device__ __forceinline__ uint64_t desc_sw128(const void* p, uint32_t lbo,
                                               uint32_t sbo) {
  uint64_t d = (smem_u32(p) & 0x3FFFFu) >> 4;
  d |= static_cast<uint64_t>((lbo >> 4) & 0x3FFFu) << 16;
  d |= static_cast<uint64_t>((sbo >> 4) & 0x3FFFu) << 32;
  d |= static_cast<uint64_t>(1) << 62;                 // 128-byte swizzle
  return d;
}

// k16 slice kk of a 64-row tile whose rows run along the contraction
// (K-major): operand A, or B not transposed.
__device__ __forceinline__ uint64_t desc_kmajor(const uint8_t* tile, int kk) {
  return desc_sw128(tile + (kk / 4) * kBoxBytes + (kk % 4) * 32, 16, 1024);
}

// k16 slice kk (rows 16kk .. 16kk+15) of a 64-row tile read transposed
// (MN-major): operand B with the tile's columns as N.
__device__ __forceinline__ uint64_t desc_mnmajor(const uint8_t* tile, int kk) {
  return desc_sw128(tile + kk * 16 * 128, kBoxBytes, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Pins accumulator registers in place around a wait, so the compiler moves
// no read or write of them across the asynchronous product.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D (64 x 64, f32) (+)= A (64 x 16, smem) . B (64 x 16, smem), bf16, both
// K-major; scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a, uint64_t b,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

// D (64 x 64, f32) += A (64 x 16, registers) . B (16 x 64, smem, read
// transposed: MN-major), bf16.
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// D (64 x 128, f32) += A (64 x 16, registers) . B (16 x 128, smem, read
// transposed: MN-major), bf16.
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// O (64 x D) += A (64 x 16, registers) . B (D x 16 from a transposed tile).
template <int D>
__device__ __forceinline__ void wgmma_rs_mn(float (&d)[D / 2], const uint32_t (&a)[4],
                                            uint64_t b) {
  if constexpr (D == 64) wgmma_rs_n64(d, a, b);
  else wgmma_rs_n128(d, a, b);
}

// ---- clusters --------------------------------------------------------------

// This block's rank in its cluster (0 .. cluster size - 1).
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// The cluster barrier in two halves, executed by every thread of every
// block of the cluster: arrive releases this thread's shared-memory writes
// to the cluster; wait returns once every thread has arrived and acquires
// theirs. Work placed between the two overlaps the other blocks' arrival.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The address, in the cluster's shared window, of the byte that sits at
// shared address `addr` (smem_u32 of a local pointer) in block `rank`.
__device__ __forceinline__ uint32_t map_peer(uint32_t addr, uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

// 16 bytes from a peer's shared memory (an address from map_peer; 16-byte
// aligned). The peer must not exit or overwrite them before the reader is
// done: the caller fences that with a cluster barrier.
__device__ __forceinline__ float4 load_peer_f4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "r"(addr)
               : "memory");
  return v;
}

}  // namespace hopper
