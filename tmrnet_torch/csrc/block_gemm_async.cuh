// cp.async copies (global -> shared, 16 bytes a thread, completion tracked
// in commit groups), used by the chunk rings of fused_bottleneck and
// time_conv: while chunk k is multiplied, the copies of the next chunks are
// in flight.
#pragma once

#include "block_gemm.cuh"

namespace tmr {

// 16-byte global -> shared copy; valid == false copies 0 bytes and zero-fills
// (src must still be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N younger commit groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace tmr
