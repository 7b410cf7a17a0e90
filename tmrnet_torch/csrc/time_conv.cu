// TimeConv on Hopper: out = max(x, causal2max(x), conv3(x)+b3, conv5(x)+b5,
// conv7(x)+b7), SAME 1-D convolutions along the window axis of x (B, W, C).
//
// Replaces the Pallas TPU kernel tmrnet_tpu/ops/time_conv.py::time_conv_fused
// (:76-97, pallas_call at :82).
//
// Bound on the H100: operations. At the main path's shapes (B=32 clips,
// W=30, C=512) it is 2*960*512*(3+5+7)*512 = 7.5 GFLOP of bf16 products over
// 1 MB of activations and 7.9 MB of weights, far above the card's ~295
// FLOP/byte ridge. Design: each branch is an implicit GEMM of the
// (B*W, k*C) tap view of x with the (k*C, C) flax-layout weight, on the
// tensor cores (WMMA bf16, f32 accumulation) through block_gemm.cuh. One
// 64x64 output tile per block runs the three branches back to back and keeps
// the running max in registers, so no branch output reaches device memory.
// Taps never cross a sequence: a tap whose source position falls outside
// [0, W) of its own sequence contributes zero, as the per-item SAME padding.
// The causal branch is max(x[t], x[t-1]) with x[-1] = 0.
#include <cuda_runtime.h>

#include "block_gemm.cuh"

namespace tmr {

__global__ void __launch_bounds__(NT)
time_conv_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w3,
                 const bf16* __restrict__ w5, const bf16* __restrict__ w7,
                 const float* __restrict__ b3, const float* __restrict__ b5,
                 const float* __restrict__ b7, bf16* __restrict__ out, int M,
                 int W, int C) {
  extern __shared__ __align__(128) unsigned char smem[];
  Stage& s = *reinterpret_cast<Stage*>(smem);
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;

  // Seed the running max with the identity and the causal 2-max branches.
  float best[2][8];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int v = threadIdx.x + i * NT;
    const int r = v / (BN / 8), c8 = (v % (BN / 8)) * 8;
    const int m = m0 + r;
#pragma unroll
    for (int j = 0; j < 8; ++j) best[i][j] = 0.0f;
    if (m < M) {
      float cur[8], prev[8];
      load8(x + (size_t)m * C + n0 + c8, cur);
      if (m % W != 0) {
        load8(x + (size_t)(m - 1) * C + n0 + c8, prev);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) prev[j] = 0.0f;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) best[i][j] = fmaxf(cur[j], prev[j]);
    }
  }

  const bf16* ws[3] = {w3, w5, w7};
  const float* bs[3] = {b3, b5, b7};
#pragma unroll 1
  for (int br = 0; br < 3; ++br) {
    const int ksz = 3 + 2 * br, half = ksz / 2;
    auto a_row = [=](int m, int k) -> const bf16* {
      if (m >= M) return nullptr;
      const int tap = k / C, ci = k - tap * C;
      const int t = m % W + tap - half;
      if (t < 0 || t >= W) return nullptr;
      return x + (size_t)(m + tap - half) * C + ci;
    };
    gemm_tile(m0, n0, ksz * C, a_row, ws[br], C, s);
    const float* bias = bs[br];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int v = threadIdx.x + i * NT;
      const int r = v / (BN / 8), c8 = (v % (BN / 8)) * 8;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        best[i][j] = fmaxf(best[i][j], s.c[r * LDC + c8 + j] + bias[n0 + c8 + j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int v = threadIdx.x + i * NT;
    const int r = v / (BN / 8), c8 = (v % (BN / 8)) * 8;
    if (m0 + r < M) store8(out + (size_t)(m0 + r) * C + n0 + c8, best[i]);
  }
}

}  // namespace tmr

// x, out: (B, W, C) bf16; w3/w5/w7: (k, C, C) bf16 (flax layout, contiguous);
// b3/b5/b7: (C,) f32. C must be a multiple of 64. Returns cudaGetLastError().
extern "C" int tmr_time_conv(const void* x, const void* w3, const void* w5,
                             const void* w7, const void* b3, const void* b5,
                             const void* b7, void* out, int B, int W, int C,
                             void* stream) {
  using namespace tmr;
  const int M = B * W;
  const int smem = (int)sizeof(Stage);
  cudaFuncSetAttribute(time_conv_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  dim3 grid((M + BM - 1) / BM, C / BN);
  time_conv_kernel<<<grid, NT, smem, (cudaStream_t)stream>>>(
      (const bf16*)x, (const bf16*)w3, (const bf16*)w5, (const bf16*)w7,
      (const float*)b3, (const float*)b5, (const float*)b7, (bf16*)out, M, W,
      C);
  return (int)cudaGetLastError();
}
