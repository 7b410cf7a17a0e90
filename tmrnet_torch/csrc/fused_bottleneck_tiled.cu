// Whole BN-folded stride-1 identity bottleneck on Hopper, NHWC bf16, tiled
// over H with a 1-row halo and a pipelined K loop:
//   out = relu(x + W3 . relu(conv3x3(y1) + b2) + b3),  y1 = relu(W1 . x + b1)
// with y1 and y2 rounded to bf16 (x's dtype) and f32 accumulation, as the
// TPU kernel does.
//
// Replaces the Pallas TPU kernel
// tmrnet_tpu/experimental/fused_bottleneck_tiled.py::fused_bottleneck_tiled
// (:123-162, pallas_call at :142), which overlaps the DMA of the next grid
// step's halo'd slab with the current step's compute.
//
// Bound on the H100: operations (the same work as fused_bottleneck.cu, above
// the ~295 FLOP/byte ridge at every stage). Design: one thread block owns an
// (image, tile of TH rows); TH is chosen by the wrapper to fit shared memory
// and the last tile may be partial. Two whole-C slabs do not fit a block's
// 227 KB, so the overlap is over 64-channel K chunks instead: every GEMM
// streams its weight chunks, and in phase 1 its x chunks, through a 3-stage
// cp.async ring (block_gemm_async.cuh), so the copies of the next chunks are
// in flight while the tensor cores run on this one. Off-image x rows are
// zero-filled by the copy itself (source size 0).
//
// Layout trick: y1 is kept in shared memory over the tile's TH+2 rows and
// W+2 columns ("wide" rows, row-major, stride LDY = P+16), and the 3x3 conv
// computes its output on the same wide grid (TH x (W+2), two junk columns
// per row that phase 3 drops). Then tap (dy, dx) of output row m is y1 row
// m + dy*(W+2) + dx, a constant offset, so the conv's A operand is read by
// the fragment loads straight from y1 with no im2col staging; y2 likewise
// feeds phase 3 in place. The junk work is 2/W of phases 2-3 (4-14% at
// ResNet-50's 56/28/14).
//
// The halo trap: a zero-filled x row still gives relu(b1) != 0, but y1
// outside the image must be the conv's zero padding, so phase 1's epilogue
// writes 0 for every wide position outside the image (halo rows, pad
// columns). Rows of y1/y2 past the written ones (read only by junk output
// rows) are zeroed once per block.
#include <cuda_runtime.h>

#include "block_gemm_async.cuh"

namespace tmr {

struct TiledGeometry {
  int W2, LDY, R1, R2, Y1ROWS, Y2ROWS;
  __host__ __device__ TiledGeometry(int W, int P, int TH) {
    W2 = W + 2;
    LDY = P + 16;                       // 32-byte rows for the fragment loads
    R1 = (TH + 2) * W2;                 // y1 rows computed (halo included)
    R2 = TH * W2;                       // wide output rows of phases 2 and 3
    Y2ROWS = (R2 + BM - 1) / BM * BM;
    const int reach = Y2ROWS + 2 * W2 + 2;  // rows the conv's tiles read
    Y1ROWS = R1 > reach ? R1 : reach;
  }
};

__global__ void __launch_bounds__(NT)
fused_bottleneck_tiled_kernel(const bf16* __restrict__ x,
                              const bf16* __restrict__ w1,
                              const float* __restrict__ b1,
                              const bf16* __restrict__ w2,
                              const float* __restrict__ b2,
                              const bf16* __restrict__ w3,
                              const float* __restrict__ b3,
                              bf16* __restrict__ out, int H, int W, int C,
                              int P, int TH) {
  extern __shared__ __align__(128) unsigned char smem[];
  AsyncRing& ring = *reinterpret_cast<AsyncRing*>(smem);
  const TiledGeometry g(W, P, TH);
  const int W2 = g.W2, LDY = g.LDY, R1 = g.R1, R2 = g.R2;
  bf16* y1 = reinterpret_cast<bf16*>(smem + sizeof(AsyncRing));
  bf16* y2 = y1 + (size_t)g.Y1ROWS * LDY;
  const int h0 = blockIdx.x * TH;
  const size_t img = (size_t)blockIdx.y * H * W * C;
  const bf16* xi = x + img;
  bf16* oi = out + img;

  // Rows never written by an epilogue, read only by junk output rows.
  const int ldy8 = LDY / 8;
  const uint4 z = make_uint4(0u, 0u, 0u, 0u);
  for (int v = threadIdx.x; v < (g.Y1ROWS - R1) * ldy8; v += NT)
    reinterpret_cast<uint4*>(y1 + (size_t)R1 * LDY)[v] = z;
  for (int v = threadIdx.x; v < (g.Y2ROWS - R2) * ldy8; v += NT)
    reinterpret_cast<uint4*>(y2 + (size_t)R2 * LDY)[v] = z;

  // Phase 1: y1 = relu(x @ w1 + b1) on the wide grid of rows h0-1 .. h0+TH,
  // zero outside the image.
  auto a1 = [=](int m, int k) -> const bf16* {
    if (m >= R1) return nullptr;
    const int hr = m / W2, w = m - hr * W2 - 1, h = h0 - 1 + hr;
    if (h < 0 || h >= H || w < 0 || w >= W) return nullptr;
    return xi + ((size_t)h * W + w) * C + k;
  };
  for (int m0 = 0; m0 < R1; m0 += BM) {
    for (int n0 = 0; n0 < P; n0 += BN) {
      gemm_tile_global_a(m0, n0, C, a1, w1, P, ring);
      for_each_result_run(ring, [&](int r, int c8, const float* v) {
        const int m = m0 + r;
        if (m >= R1) return;
        const int hr = m / W2, w = m - hr * W2 - 1, h = h0 - 1 + hr;
        const bool inside = h >= 0 && h < H && w >= 0 && w < W;
        float o[8];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          o[j] = inside ? fmaxf(v[j] + b1[n0 + c8 + j], 0.0f) : 0.0f;
        store8(&y1[(size_t)m * LDY + n0 + c8], o);
      });
      __syncthreads();
    }
  }

  // Phase 2: y2 = relu(conv3x3(y1) + b2) on the wide grid; the K index walks
  // (dy, dx, ci) as the flattened (3, 3, P, P) weight does, and a 64-wide K
  // chunk never straddles two taps (P % 64 == 0).
  for (int m0 = 0; m0 < R2; m0 += BM) {
    for (int n0 = 0; n0 < P; n0 += BN) {
      auto a2 = [=](int k0) -> const bf16* {
        const int tap = k0 / P, ci = k0 - tap * P;
        const int dy = tap / 3, dx = tap - dy * 3;
        return y1 + (size_t)(m0 + dy * W2 + dx) * LDY + ci;
      };
      gemm_tile_shared_a(n0, 9 * P, a2, LDY, w2, P, ring);
      for_each_result_run(ring, [&](int r, int c8, const float* v) {
        const int m = m0 + r;
        if (m >= R2) return;
        float o[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) o[j] = fmaxf(v[j] + b2[n0 + c8 + j], 0.0f);
        store8(&y2[(size_t)m * LDY + n0 + c8], o);
      });
      __syncthreads();
    }
  }

  // Phase 3: out = relu(y2 @ w3 + b3 + x) for the real columns of the rows
  // of the tile inside the image.
  for (int m0 = 0; m0 < R2; m0 += BM) {
    for (int n0 = 0; n0 < C; n0 += BN) {
      auto a3 = [=](int k0) -> const bf16* {
        return y2 + (size_t)m0 * LDY + k0;
      };
      gemm_tile_shared_a(n0, P, a3, LDY, w3, C, ring);
      for_each_result_run(ring, [&](int r, int c8, const float* v) {
        const int m = m0 + r;
        if (m >= R2) return;
        const int rr = m / W2, c = m - rr * W2, h = h0 + rr;
        if (c >= W || h >= H) return;
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
extern "C" int tmr_fused_bottleneck_tiled_smem(int W, int P, int TH) {
  const tmr::TiledGeometry g(W, P, TH);
  return (int)sizeof(tmr::AsyncRing) +
         (g.Y1ROWS + g.Y2ROWS) * g.LDY * (int)sizeof(tmr::bf16);
}

// x, out: (N, H, W, C) bf16 NHWC-contiguous; w1: (C, P), w2: (3, 3, P, P),
// w3: (P, C) bf16 contiguous; b1, b2: (P,), b3: (C,) f32. P and C multiples
// of 64; TH rows per block (the last tile may be partial). Returns
// cudaGetLastError().
extern "C" int tmr_fused_bottleneck_tiled(const void* x, const void* w1,
                                          const void* b1, const void* w2,
                                          const void* b2, const void* w3,
                                          const void* b3, void* out, int N,
                                          int H, int W, int C, int P, int TH,
                                          void* stream) {
  using namespace tmr;
  const int smem = tmr_fused_bottleneck_tiled_smem(W, P, TH);
  cudaError_t err = cudaFuncSetAttribute(
      fused_bottleneck_tiled_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((H + TH - 1) / TH, N);
  fused_bottleneck_tiled_kernel<<<grid, NT, smem, (cudaStream_t)stream>>>(
      (const bf16*)x, (const bf16*)w1, (const float*)b1, (const bf16*)w2,
      (const float*)b2, (const bf16*)w3, (const float*)b3, (bf16*)out, H, W,
      C, P, TH);
  return (int)cudaGetLastError();
}
