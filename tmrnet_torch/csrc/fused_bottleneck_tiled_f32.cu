// Whole BN-folded stride-1 identity bottleneck on Hopper, NHWC f32, tiled
// over H with a 1-row halo:
//   out = relu(x + W3 . relu(conv3x3(y1) + b2) + b3),  y1 = relu(W1 . x + b1)
// with y1 and y2 in f32 and every product and sum in f32 on the FFMA units
// (no TF32), as the TPU kernel computes it for f32 x.
// csrc/fused_bottleneck_tiled.cu is its bf16 counterpart on the tensor
// cores; the wrapper (experimental/fused_bottleneck_tiled.py::
// fused_bottleneck_tiled_cuda) picks by dtype.
//
// Replaces the Pallas TPU kernel
// tmrnet_tpu/experimental/fused_bottleneck_tiled.py::fused_bottleneck_tiled
// (:123-162, pallas_call at :142) for f32 operands. That kernel DMAs one
// halo'd slab of x per grid step, starts the next step's slab during this
// step's compute, and reads phase 3's residual from the slab.
//
// Bound on the H100: operations, as for csrc/fused_bottleneck_f32.cu (the
// same products: ~139.9 GFLOP a launch at N = 320, ~2.09 ms at 67 TFLOP/s
// of f32 FFMA, against ~0.61 ms for stage 1's bytes at 3.35 TB/s). In f32 a
// halo'd slab of x does not fit shared memory beside y1 and y2 (stage 1's 6
// rows of 56 x 256 are 344 KB), so the slab streams through the ring in K
// chunks. The design, on bottleneck_f32.cuh's register-tiled product:
// - A block owns an (image, tile of TH rows) with TH W <= BM, so phases 2
//   and 3 are one row tile each, as the TPU kernel's steps are one slab.
// - The slab's rows (the tile's and its halo's image rows) and the weights
//   stream through a ring of NSTAGE (3, else 2) slots by cp.async: the next
//   chunks of the slab are in flight while this one is multiplied.
// - Phase 3's residual comes from a staged copy: each column pass copies its
//   tile of x (TH W rows x BN) into shared memory over y1 (dead by then)
//   with the pass's chunk NSTAGE - 1, overlapping the pass's products, and
//   the epilogue adds it there.
// - The halo trap: y1 is zeroed at the image border (halo rows off the
//   image), never computed from x.
// The plan (experimental/fused_bottleneck_tiled.py::plan_bottleneck_tiled_f32)
// picks TH, TX and NSTAGE; `Layout` (bottleneck_f32.cuh) and the plan's
// `f32_layout_bytes` must agree, which the wrapper checks at every launch.
// W > 256 is refused (TH W <= BM <= 256). One block per SM.
#include "bottleneck_f32.cuh"

namespace tmr {
namespace fbf {

template <int TX, int NSTAGE>
__global__ void __launch_bounds__(THREADS, 1)
    fused_bottleneck_tiled_f32_kernel(const Args a) {
  bottleneck_block<TX, NSTAGE, true>(a);
}

template <int TX, int NSTAGE>
int launch_tiled(const Args& a, int N, void* stream) {
  const int smem = Layout(a.W, a.P, a.TH, TX, NSTAGE).total;
  cudaError_t err = cudaFuncSetAttribute(
      fused_bottleneck_tiled_f32_kernel<TX, NSTAGE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.H + a.TH - 1) / a.TH, N);
  fused_bottleneck_tiled_f32_kernel<TX, NSTAGE>
      <<<grid, THREADS, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

template <int NSTAGE>
int launch_tiled_tx(const Args& a, int N, int TX, void* stream) {
  switch (TX) {
    case 8: return launch_tiled<8, NSTAGE>(a, N, stream);
    case 16: return launch_tiled<16, NSTAGE>(a, N, stream);
    case 32: return launch_tiled<32, NSTAGE>(a, N, stream);
    default: return launch_tiled<64, NSTAGE>(a, N, stream);
  }
}

}  // namespace fbf
}  // namespace tmr

// Shared memory of one block under a plan (TH rows, TX threads across N,
// NSTAGE ring slots).
extern "C" int tmr_fused_bottleneck_tiled_f32_smem(int W, int P, int TH,
                                                   int TX, int NSTAGE) {
  return tmr::fbf::Layout(W, P, TH, TX, NSTAGE).total;
}

// x: (N, H, W, C) f32 NHWC; w1 (C, P), w2 (3, 3, P, P) HWIO, w3 (P, C) f32
// row-major; b1 (P,), b2 (P,), b3 (C,) f32; out like x; all 16-byte
// aligned. TX in {8, 16, 32, 64} with 8 TX dividing P and C (multiples of
// 64); 1 <= TH <= H with TH W <= BM = 8 (256 / TX); NSTAGE 2 or 3; N <= 65535.
// Returns cudaErrorInvalidValue for a call outside those, else
// cudaGetLastError() after the launch.
extern "C" int tmr_fused_bottleneck_tiled_f32(
    const void* x, const void* w1, const void* b1, const void* w2,
    const void* b2, const void* w3, const void* b3, void* out, int N, int H,
    int W, int C, int P, int TH, int TX, int NSTAGE, void* stream) {
  using namespace tmr::fbf;
  if ((NSTAGE != 2 && NSTAGE != 3) ||
      check_call(N, H, W, C, P, TH, TX, NSTAGE, true))
    return (int)cudaErrorInvalidValue;
  const Args a{(const float*)x,  (const float*)w1, (const float*)b1,
               (const float*)w2, (const float*)b2, (const float*)w3,
               (const float*)b3, (float*)out,      H,
               W,                C,                P,
               TH};
  return NSTAGE == 3 ? launch_tiled_tx<3>(a, N, TX, stream)
                     : launch_tiled_tx<2>(a, N, TX, stream);
}
