// Int8 matmul with a dequantizing epilogue on Hopper:
//   out[m, n] = f32(sum_k a_q[m, k] * b_q[k, n], exact in int32)
//               * (a_scale * b_scale[n])
// in f32 or bf16, the scale product taken in f32 first (the order of the
// TPU kernel), so the result equals the plain version's bit for bit.
//
// Replaces the Pallas TPU kernel tmrnet_tpu/ops/quant.py::int8_matmul
// (:66-97, pallas_call at :80), whose int32 accumulator lives in VMEM
// scratch across the K grid axis.
//
// Bound on the H100: for an (M, K) @ (K, N) product with f32 output, 2 M K N
// operations over about M (K + 4 N) bytes, 2 K N / (K + 4 N) operations per
// byte against the int8 ridge of ~590 (1979 TOPS / 3.35 TB/s): bytes at the
// int8 gate's 1x1 shapes (K, N <= 2048), where the f32 output is 48-94% of
// the bytes; operations for the square 8192^3 product.
//
// Design: the int8 wgmma block of wgmma_s8_gemm.cuh (shared with
// int8_conv3x3): a cp.async ring of 128-byte K chunks, two warpgroups of
// m64 tiles, one wgmma group in flight, the epilogue from registers.
// - A is K-major already: row m of a chunk kc is read from a + m K + 128 kc,
//   zero-filled past M and past K.
// - B must be K-major too (the integer wgmma has no transpose): the wrapper
//   hands over b_q as an (N, K) copy, made once per version of b_q.
// - The plan (ops/quant.py::plan_int8_matmul) picks the tile width BN and
//   the ring depth per shape; its cost counts the output's stores beside
//   the tensor and copy cycles, since the output dominates the bytes here.
// - a_scale stays on the device (no host sync per call).
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma_s8_gemm.cuh"

namespace tmr {
namespace i8 {

// Blocks an SM must hold by registers (the plan's blocks_per_sm): 3 at BN =
// 64, 2 at 128, 1 at 256.
template <int BN, int NSTAGE>
__global__ void __launch_bounds__(THREADS, BN == 64 ? 3 : BN == 128 ? 2 : 1)
int8_matmul_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ bk,
                   const float* __restrict__ a_scale,
                   const float* __restrict__ b_scale, void* __restrict__ out,
                   int M, int N, int K, int out_bf16) {
  const Tile tile = block_tile<BN, Order::kRowBlocks>(N);
  const int piece = threadIdx.x & 7, row0 = threadIdx.x >> 3;
  auto load_a = [&](unsigned char* sa, int k) {
#pragma unroll
    for (int i = 0; i < AROWS; ++i) {
      const int r = row0 + 32 * i, m = tile.m0 + r;
      const bool ok = m < M && k < K;
      cp_async16(sa + wgmma::kmajor_offset(r, 16 * piece),
                 ok ? a + (size_t)m * K + k : a, ok);
    }
  };
  gemm_block<BN, NSTAGE>(tile, load_a, bk, a_scale, b_scale, out, M, N, K,
                         out_bf16);
}

}  // namespace i8
}  // namespace tmr

// The (BN, NSTAGE) plans the kernel is built for: each one plan_int8_matmul
// picks at some shape. (BN = 128 with a 4-stage ring, one block an SM, was
// never the fastest at the gate's products or at 8192^3 on the H100.)
#define TMR_I8M_PLANS(X) X(64, 3) X(64, 4) X(128, 3) X(256, 4)

// Shared memory of a block under a plan, or -1 for a plan the kernel is not
// built for.
extern "C" int tmr_int8_matmul_smem(int BN, int NSTAGE) {
#define TMR_I8M_SMEM(bn, ns) \
  if (BN == bn && NSTAGE == ns) return tmr::i8::smem_bytes(bn, ns);
  TMR_I8M_PLANS(TMR_I8M_SMEM)
#undef TMR_I8M_SMEM
  return -1;
}

// a: (M, K) int8 row-major; b_kmajor: (N, K) int8, row n the column n of
// b_q; a_scale: one f32; b_scale: (N,) f32; out: (M, N) f32, or bf16 when
// out_bf16; all contiguous on the device. K % 16 == 0, N % 16 == 0, M and
// N below 2^31; (BN, NSTAGE) one of TMR_I8M_PLANS. Returns
// cudaErrorInvalidValue outside those, else cudaGetLastError().
extern "C" int tmr_int8_matmul(const void* a, const void* b_kmajor,
                               const void* a_scale, const void* b_scale,
                               void* out, int M, int N, int K, int out_bf16,
                               int BN, int NSTAGE, void* stream) {
  if (M < 1 || K < 16 || K % 16 || N < 16 || N % 16)
    return (int)cudaErrorInvalidValue;
#define TMR_I8M_LAUNCH(bn, ns)                                            \
  if (BN == bn && NSTAGE == ns)                                           \
    return tmr::i8::launch<bn, ns, tmr::i8::Order::kRowBlocks>(           \
        tmr::i8::int8_matmul_kernel<bn, ns>, M, N, (cudaStream_t)stream,  \
        (const int8_t*)a, (const int8_t*)b_kmajor, (const float*)a_scale, \
        (const float*)b_scale, out, M, N, K, out_bf16);
  TMR_I8M_PLANS(TMR_I8M_LAUNCH)
#undef TMR_I8M_LAUNCH
  return (int)cudaErrorInvalidValue;
}
