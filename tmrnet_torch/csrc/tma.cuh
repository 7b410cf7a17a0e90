// Tensor Memory Accelerator (TMA) copies and mbarriers on Hopper, for
// fused_bottleneck_tiled (tensor boxes) and nl_attention (1-D bulk copies);
// int8_conv3x3 takes only its proxy fence. The f32 bottleneck kernels
// (bottleneck_f32.cuh) also take the thread-block-cluster side: a box
// multicast into every CTA of the cluster, arrivals on another CTA's
// mbarrier, cluster barriers and loads from another CTA's shared memory
// (distributed shared memory, DSMEM).
//
// Device side: one thread issues a cp.async.bulk.tensor load of a whole box
// (up to 5-D) from device memory into shared memory; the copy engine
// reports the box's bytes to an mbarrier in shared memory (complete_tx), so
// waiting threads need no block barrier and spend no instructions on
// addresses. The loads name the CTA's own shared memory through the
// shared::cluster window (a block without a cluster is a cluster of one).
// A TMA store reads a box back out of shared memory into device memory;
// elements of a box outside the tensor are zero-filled on a load and
// dropped on a store.
//
// Host side: a tensor map (CUtensorMap, 128 bytes) describes the tensor
// (base, dims innermost first, byte strides of dims 1..), the box and the
// shared-memory swizzle. It is encoded on the host by the driver's
// cuTensorMapEncodeTiled, fetched through the runtime
// (cudaGetDriverEntryPoint) so that no library links libcuda, and passed to
// the kernel by value as a __grid_constant__ parameter.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tmr {
namespace tma {

__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// Makes the initialised barriers visible to the copy engine and the other
// threads (the block barrier that follows orders the rest).
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Arrive once and expect `bytes` more of copies before the phase completes.
__device__ __forceinline__ void mbar_arrive_expect_tx(unsigned bar,
                                                      unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(unsigned bar, unsigned parity) {
  unsigned done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Whether the phase of parity `parity` has completed, without waiting.
__device__ __forceinline__ bool mbar_test_wait(unsigned bar, unsigned parity) {
  unsigned done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait until the barrier's phase of parity `parity` has completed. A wait
// that never ends (a fault in the ring's protocol) traps after 2^28 tries,
// so the launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  for (unsigned i = 0; !mbar_try_wait(bar, parity);)
    if (++i == (1u << 28)) __trap();
}

// ---- clusters ----

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// The cluster barrier in two halves; every thread of every CTA of the
// cluster takes part (`.aligned`: a warp's threads together, so each half
// first reconverges the warp). arrive
// releases this thread's earlier memory operations, wait acquires the
// others' once all have arrived.
__device__ __forceinline__ void cluster_arrive() {
  __syncwarp();
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  __syncwarp();
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The same shared-memory offset in the CTA of rank `rank`, as a
// shared::cluster address.
__device__ __forceinline__ unsigned map_rank(unsigned addr, unsigned rank) {
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(addr), "r"(rank));
  return r;
}

__device__ __forceinline__ float4 ld_cluster_f4(unsigned addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

// Arrive once on the mbarrier at offset `bar` of the CTA of rank `rank`.
__device__ __forceinline__ void mbar_arrive_remote(unsigned bar,
                                                   unsigned rank) {
  asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];\n" ::"r"(
                   map_rank(bar, rank))
               : "memory");
}

__device__ __forceinline__ uint64_t map_addr(const CUtensorMap& m) {
  return reinterpret_cast<uint64_t>(&m);
}

// A 1-D bulk copy of `bytes` contiguous bytes (a multiple of 16; src and
// dst 16-byte aligned) from device memory into shared memory, reported to
// the mbarrier like a tensor box.
__device__ __forceinline__ void load_1d(unsigned dst, const void* src,
                                        unsigned bytes, unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void load_2d(unsigned dst, const CUtensorMap& m,
                                        unsigned bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(map_addr(m)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// One box into the shared memory of every CTA of the cluster in `mask`
// (bit i: rank i), at the same offset `dst` in each, each CTA's mbarrier
// at offset `bar` told of the box's bytes.
__device__ __forceinline__ void load_2d_multicast(unsigned dst,
                                                  const CUtensorMap& m,
                                                  unsigned bar, int c0, int c1,
                                                  unsigned short mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes.multicast::cluster [%0], [%1, {%4, %5}], [%2], %3;\n" ::"r"(dst),
      "l"(map_addr(m)), "r"(bar), "h"(mask), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void load_3d(unsigned dst, const CUtensorMap& m,
                                        unsigned bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(map_addr(m)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void load_4d(unsigned dst, const CUtensorMap& m,
                                        unsigned bar, int c0, int c1, int c2,
                                        int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(map_addr(m)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void store_4d(const CUtensorMap& m, unsigned src,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, "
      "%4, %5}], [%1];\n" ::"l"(map_addr(m)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void store_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Until the committed stores have read their shared memory.
__device__ __forceinline__ void store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// Orders this thread's ordinary shared-memory writes (st.shared, cp.async)
// before later reads of the async proxy: the copy engine's stores, and
// wgmma's operands in shared memory (wgmma_s8.cuh).
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void prefetch_map(const CUtensorMap& m) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(map_addr(m)) : "memory");
}

// ---- host ----

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, or nullptr.
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A bf16 tensor map of `rank` dims (dims and box innermost first; strides
// in elements of dims 1..rank-1); zero fill out of bounds. Returns the
// driver's CUresult, or CUDA_ERROR_NOT_FOUND without the entry point.
inline int encode_bf16(CUtensorMap* m, const void* base, int rank,
                       const uint64_t* dims, const uint64_t* strides,
                       const uint32_t* box, CUtensorMapSwizzle swizzle) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)CUDA_ERROR_NOT_FOUND;
  cuuint64_t d[5], s[4];
  cuuint32_t b[5], e[5];
  for (int i = 0; i < rank; ++i) {
    d[i] = dims[i];
    b[i] = box[i];
    e[i] = 1;
    if (i > 0) s[i - 1] = strides[i - 1] * 2;  // bytes
  }
  return (int)fn(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
                 const_cast<void*>(base), d, s, b, e,
                 CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                 CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                 CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// An f32 tensor map, as encode_bf16 (strides in elements); no swizzle.
inline int encode_f32(CUtensorMap* m, const void* base, int rank,
                      const uint64_t* dims, const uint64_t* strides,
                      const uint32_t* box) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)CUDA_ERROR_NOT_FOUND;
  cuuint64_t d[5], s[4];
  cuuint32_t b[5], e[5];
  for (int i = 0; i < rank; ++i) {
    d[i] = dims[i];
    b[i] = box[i];
    e[i] = 1;
    if (i > 0) s[i - 1] = strides[i - 1] * 4;  // bytes
  }
  return (int)fn(m, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, rank,
                 const_cast<void*>(base), d, s, b, e,
                 CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                 CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                 CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

}  // namespace tma
}  // namespace tmr
