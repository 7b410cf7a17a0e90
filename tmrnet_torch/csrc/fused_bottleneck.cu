// Whole BN-folded stride-1 identity bottleneck on Hopper, NHWC bf16:
//   out = relu(x + W3 . relu(conv3x3(y1) + b2) + b3),  y1 = relu(W1 . x + b1)
// with y1 and y2 rounded to bf16 (x's dtype) and f32 accumulation, as the
// TPU kernel does.
//
// Replaces the Pallas TPU kernel
// tmrnet_tpu/experimental/fused_bottleneck.py::fused_bottleneck (:58-89,
// pallas_call at :71).
//
// Bound on the H100: operations. One block of ResNet-50 at N=320 frames is
// ~140 GFLOP of bf16 products over ~1 GB of activations in and out (stage 1),
// above the ~295 FLOP/byte ridge at every stage. What the fusion saves is the
// y1/y2 round trips through device memory (4 of the 6 activation transfers
// of the unfused chain). Design: one thread block owns an (image, tile of TH
// rows). It computes y1 over the tile plus a 1-pixel halo into shared memory
// (bf16), then y2 = the 3x3 conv as an implicit GEMM over that y1 into shared
// memory, then the 1x1 expand with bias, residual and ReLU straight to the
// output. All three products run on the tensor cores through block_gemm.cuh.
// y1 halo values outside the image are ZERO (the conv's padding), not
// relu(b1): the halo rows are masked, and the left/right pad columns are
// cleared once per block. TH is chosen by the wrapper to fit shared memory
// (stage 4 at 7x7, P=512 takes 165 KB, above the 48 KB default, hence the
// MaxDynamicSharedMemorySize attribute).
#include <cuda_runtime.h>

#include "block_gemm.cuh"

namespace tmr {

__global__ void __launch_bounds__(NT)
fused_bottleneck_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
                        const float* __restrict__ b1, const bf16* __restrict__ w2,
                        const float* __restrict__ b2, const bf16* __restrict__ w3,
                        const float* __restrict__ b3, bf16* __restrict__ out,
                        int H, int W, int C, int P, int TH) {
  extern __shared__ __align__(128) unsigned char smem[];
  Stage& s = *reinterpret_cast<Stage*>(smem);
  const int W2 = W + 2;
  bf16* y1 = reinterpret_cast<bf16*>(smem + sizeof(Stage));  // (TH+2, W+2, P)
  bf16* y2 = y1 + (size_t)(TH + 2) * W2 * P;                  // (TH*W, P)
  const int h0 = blockIdx.x * TH;
  const size_t img = (size_t)blockIdx.y * H * W * C;
  const bf16* xi = x + img;
  bf16* oi = out + img;

  // Left and right pad columns of y1 are the conv's zero padding.
  const int p8 = P / 8;
  for (int v = threadIdx.x; v < (TH + 2) * 2 * p8; v += NT) {
    const int row = v / (2 * p8), rem = v % (2 * p8);
    const int col = (rem / p8) ? W + 1 : 0;
    *reinterpret_cast<uint4*>(&y1[((size_t)row * W2 + col) * P + (rem % p8) * 8]) =
        make_uint4(0u, 0u, 0u, 0u);
  }

  // Phase 1: y1 = relu(x @ w1 + b1) over rows h0-1 .. h0+TH, zero off-image.
  const int M1 = (TH + 2) * W;
  auto a1 = [=](int m, int k) -> const bf16* {
    if (m >= M1) return nullptr;
    const int hr = m / W, w = m - hr * W, h = h0 - 1 + hr;
    if (h < 0 || h >= H) return nullptr;
    return xi + ((size_t)h * W + w) * C + k;
  };
  for (int m0 = 0; m0 < M1; m0 += BM) {
    for (int n0 = 0; n0 < P; n0 += BN) {
      gemm_tile(m0, n0, C, a1, w1, P, s);
      for_each_run(s, [&](int r, int c8, const float* v) {
        const int m = m0 + r;
        if (m >= M1) return;
        const int hr = m / W, w = m - hr * W, h = h0 - 1 + hr;
        const bool inside = h >= 0 && h < H;
        float o[8];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          o[j] = inside ? fmaxf(v[j] + b1[n0 + c8 + j], 0.0f) : 0.0f;
        store8(&y1[((size_t)hr * W2 + w + 1) * P + n0 + c8], o);
      });
      __syncthreads();
    }
  }

  // Phase 2: y2 = relu(conv3x3(y1) + b2) for the TH*W output positions; the
  // K index walks (dy, dx, ci) as the flattened (3, 3, P, P) weight does.
  const int M2 = TH * W;
  auto a2 = [=](int m, int k) -> const bf16* {
    if (m >= M2) return nullptr;
    const int r = m / W, c = m - r * W;
    const int tap = k / P, ci = k - tap * P;
    const int dy = tap / 3, dx = tap - dy * 3;
    return y1 + ((size_t)(r + dy) * W2 + c + dx) * P + ci;
  };
  for (int m0 = 0; m0 < M2; m0 += BM) {
    for (int n0 = 0; n0 < P; n0 += BN) {
      gemm_tile(m0, n0, 9 * P, a2, w2, P, s);
      for_each_run(s, [&](int r, int c8, const float* v) {
        const int m = m0 + r;
        if (m >= M2) return;
        float o[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) o[j] = fmaxf(v[j] + b2[n0 + c8 + j], 0.0f);
        store8(&y2[(size_t)m * P + n0 + c8], o);
      });
      __syncthreads();
    }
  }

  // Phase 3: out = relu(y2 @ w3 + b3 + x) for the rows of the tile inside
  // the image.
  auto a3 = [=](int m, int k) -> const bf16* {
    return m < M2 ? y2 + (size_t)m * P + k : nullptr;
  };
  for (int m0 = 0; m0 < M2; m0 += BM) {
    for (int n0 = 0; n0 < C; n0 += BN) {
      gemm_tile(m0, n0, P, a3, w3, C, s);
      for_each_run(s, [&](int r, int c8, const float* v) {
        const int m = m0 + r;
        if (m >= M2) return;
        const int rr = m / W, c = m - rr * W, h = h0 + rr;
        if (h >= H) return;
        const size_t at = ((size_t)h * W + c) * C + n0 + c8;
        float res[8], o[8];
        load8(xi + at, res);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          o[j] = fmaxf(v[j] + b3[n0 + c8 + j] + res[j], 0.0f);
        store8(oi + at, o);
      });
      __syncthreads();
    }
  }
}

}  // namespace tmr

// Shared memory one block needs at tile height TH.
extern "C" int tmr_fused_bottleneck_smem(int W, int P, int TH) {
  return (int)sizeof(tmr::Stage) +
         ((TH + 2) * (W + 2) * P + TH * W * P) * (int)sizeof(tmr::bf16);
}

// x, out: (N, H, W, C) bf16 NHWC-contiguous; w1: (C, P), w2: (3, 3, P, P),
// w3: (P, C) bf16 contiguous; b1, b2: (P,), b3: (C,) f32. P and C multiples
// of 64. Returns cudaGetLastError().
extern "C" int tmr_fused_bottleneck(const void* x, const void* w1,
                                    const void* b1, const void* w2,
                                    const void* b2, const void* w3,
                                    const void* b3, void* out, int N, int H,
                                    int W, int C, int P, int TH, void* stream) {
  using namespace tmr;
  const int smem = tmr_fused_bottleneck_smem(W, P, TH);
  cudaError_t err = cudaFuncSetAttribute(
      fused_bottleneck_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((H + TH - 1) / TH, N);
  fused_bottleneck_kernel<<<grid, NT, smem, (cudaStream_t)stream>>>(
      (const bf16*)x, (const bf16*)w1, (const float*)b1, (const bf16*)w2,
      (const float*)b2, (const bf16*)w3, (const float*)b3, (bf16*)out, H, W,
      C, P, TH);
  return (int)cudaGetLastError();
}
