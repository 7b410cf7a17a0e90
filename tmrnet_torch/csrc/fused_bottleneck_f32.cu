// Whole BN-folded stride-1 identity bottleneck on Hopper, NHWC f32:
//   out = relu(x + W3 . relu(conv3x3(y1) + b2) + b3),  y1 = relu(W1 . x + b1)
// with y1 and y2 in f32 and every product and sum in f32 on the FFMA units
// (no TF32), as the TPU kernel computes it for f32 x. csrc/fused_bottleneck.cu
// is its bf16 counterpart on the tensor cores; the wrapper
// (experimental/fused_bottleneck.py::fused_bottleneck_cuda) picks by dtype.
//
// Replaces the Pallas TPU kernel
// tmrnet_tpu/experimental/fused_bottleneck.py::fused_bottleneck (:58-89,
// pallas_call at :71) for f32 operands.
//
// Bound on the H100: operations. ResNet-50's 12 identity blocks at N = 320
// frames are ~1.68 TFLOP of products a forward, ~139.9 GFLOP a launch: ~25.0
// ms a forward, ~2.09 ms a launch, at 67 TFLOP/s of f32 FFMA. Stage 1, the
// largest activation, moves ~2.06 GB in and out at 320 frames, ~0.61 ms at
// 3.35 TB/s: operations bound every stage, ~68 FLOP a byte at stage 1
// against the ~20 where the FFMA rate meets the memory's. The design is the
// plain register-tiled product of bottleneck_f32.cuh, simple first:
// - A block owns an (image, tile of TH rows) and walks each phase in block
//   tiles of BM x BN, as many row tiles as its rows need (the plan may pick
//   TH W > BM); f32 doubles bf16's bytes, so y1 and y2 at TH = 4 already
//   take ~150 KB and stage 4's whole 7 x 7 image does not fit with both.
// - Two ring slots (cp.async double buffer): a chunk's copy runs while the
//   one before it is multiplied.
// - Phase 3 reads its residual from device memory in the epilogue (the
//   tiled kernel stages it instead).
// The plan (experimental/fused_bottleneck.py::plan_bottleneck_f32) picks TH
// and TX; `Layout` (bottleneck_f32.cuh) and the plan's `f32_layout_bytes`
// must agree, which the wrapper checks at every launch. One block per SM.
#include "bottleneck_f32.cuh"

namespace tmr {
namespace fbf {

constexpr int BLOCK_NSTAGE = 2;

template <int TX>
__global__ void __launch_bounds__(THREADS, 1)
    fused_bottleneck_f32_kernel(const Args a) {
  bottleneck_block<TX, BLOCK_NSTAGE, false>(a);
}

template <int TX>
int launch_block(const Args& a, int N, void* stream) {
  const int smem = Layout(a.W, a.P, a.TH, TX, BLOCK_NSTAGE).total;
  cudaError_t err = cudaFuncSetAttribute(
      fused_bottleneck_f32_kernel<TX>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.H + a.TH - 1) / a.TH, N);
  fused_bottleneck_f32_kernel<TX>
      <<<grid, THREADS, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace fbf
}  // namespace tmr

// Shared memory of one block under a plan (TH rows, TX threads across N).
extern "C" int tmr_fused_bottleneck_f32_smem(int W, int P, int TH, int TX) {
  return tmr::fbf::Layout(W, P, TH, TX, tmr::fbf::BLOCK_NSTAGE).total;
}

// x: (N, H, W, C) f32 NHWC; w1 (C, P), w2 (3, 3, P, P) HWIO, w3 (P, C) f32
// row-major; b1 (P,), b2 (P,), b3 (C,) f32; out like x; all 16-byte
// aligned. TX in {8, 16, 32, 64} with 8 TX dividing P and C (multiples of
// 64); 1 <= TH <= H; N <= 65535. Returns cudaErrorInvalidValue for a call
// outside those, else cudaGetLastError() after the launch.
extern "C" int tmr_fused_bottleneck_f32(const void* x, const void* w1,
                                        const void* b1, const void* w2,
                                        const void* b2, const void* w3,
                                        const void* b3, void* out, int N,
                                        int H, int W, int C, int P, int TH,
                                        int TX, void* stream) {
  using namespace tmr::fbf;
  if (check_call(N, H, W, C, P, TH, TX, BLOCK_NSTAGE, false))
    return (int)cudaErrorInvalidValue;
  const Args a{(const float*)x,  (const float*)w1, (const float*)b1,
               (const float*)w2, (const float*)b2, (const float*)w3,
               (const float*)b3, (float*)out,      H,
               W,                C,                P,
               TH};
  switch (TX) {
    case 8: return launch_block<8>(a, N, stream);
    case 16: return launch_block<16>(a, N, stream);
    case 32: return launch_block<32>(a, N, stream);
    default: return launch_block<64>(a, N, stream);
  }
}
