// Whole BN-folded stride-1 identity bottleneck on Hopper, NHWC f32:
//   out = relu(x + W3 . relu(conv3x3(y1) + b2) + b3),  y1 = relu(W1 . x + b1)
// with y1 and y2 in f32 and every product and sum in f32 on the FFMA units
// (no TF32), as the TPU kernels compute it for f32 x. csrc/fused_bottleneck.cu
// and csrc/fused_bottleneck_tiled.cu are its bf16 counterparts on the tensor
// cores; both wrappers (experimental/fused_bottleneck.py::
// fused_bottleneck_cuda, experimental/fused_bottleneck_tiled.py::
// fused_bottleneck_tiled_cuda) pick by dtype, and in f32 both launch this
// one kernel under one plan, counted apart.
//
// Replaces the Pallas TPU kernels for f32 operands:
// - tmrnet_tpu/experimental/fused_bottleneck.py::fused_bottleneck (:58-89,
//   pallas_call at :71);
// - tmrnet_tpu/experimental/fused_bottleneck_tiled.py::
//   fused_bottleneck_tiled (:123-162, pallas_call at :142), with its limit
//   W <= 256 (the tiled wrapper's plan refuses wider rows). That kernel DMAs
//   one halo'd slab of x per grid step; in f32 such a slab does not fit
//   shared memory beside y1 and y2 (stage 1's 6 rows of 56 x 256 are 344
//   KB), so here x streams through the ring in K chunks, each a TMA box,
//   and the halo is taken from the neighbouring CTAs of the cluster instead
//   of read twice.
//
// Bound on the H100: operations. ResNet-50's 12 identity blocks at N = 320
// frames are ~1.68 TFLOP of products a forward, ~139.9 GFLOP a launch: ~25.0
// ms a forward, ~2.09 ms a launch, at 67 TFLOP/s of f32 FFMA. Stage 1, the
// largest activation, moves ~2.06 GB in and out at 320 frames, ~0.61 ms at
// 3.35 TB/s: operations bound every stage. What keeps the FFMA units from
// that rate is work on padding and the weights' path, so the design
// (bottleneck_f32.cuh) is about both:
// - clusters of CTAs own consecutive pixels, one tile of output rows a CTA,
//   and share y1's halo through DSMEM, so the products on rows that are not
//   the block's own are the tile's padding and y1 at a cluster's edges;
// - each weight chunk leaves L2 once a cluster (TMA multicast), against
//   once a block before, and a ring of 3-4 slots with full and empty
//   mbarriers runs on across passes and phases, with no block barrier in
//   the K loop;
// - phase 3's residual is staged in shared memory over y1 (dead by then)
//   by cp.async while the pass's products run, where the plan finds room;
//   else (y2 over y1, stage 4) read from device memory in the epilogue.
// The plan (experimental/fused_bottleneck.py::plan_f32) picks TX, the
// cluster size, the span, the ring, y2's place and whether the residual is
// staged, counting waves over the card's active clusters
// (tmr_fused_bottleneck_f32_clusters); `Layout` (bottleneck_f32.cuh) and
// the plan's `f32_layout` must agree, which the wrapper checks at every
// launch. One CTA per SM.
#include "bottleneck_f32.cuh"

namespace tmr {
namespace fbf {

template <int TX>
__global__ void __launch_bounds__(CTA_THREADS, 1)
    fused_bottleneck_f32_kernel(const __grid_constant__ CUtensorMap mx,
                                const __grid_constant__ CUtensorMap mw1,
                                const __grid_constant__ CUtensorMap mw2,
                                const __grid_constant__ CUtensorMap mw3,
                                const Args a) {
  bottleneck_block<TX>(mx, mw1, mw2, mw3, a);
}

inline Kernel block_kernel(int TX) {
  switch (TX) {
    case 8: return fused_bottleneck_f32_kernel<8>;
    case 16: return fused_bottleneck_f32_kernel<16>;
    case 32: return fused_bottleneck_f32_kernel<32>;
    default: return fused_bottleneck_f32_kernel<64>;
  }
}

}  // namespace fbf
}  // namespace tmr

// Shared memory of one CTA under a plan (TX threads across N, `span`
// pixels a cluster of cs, nstage ring slots, y2 over y1 or not).
extern "C" int tmr_fused_bottleneck_f32_smem(int W, int P, int TX, int span,
                                             int cs, int nstage,
                                             int overlay) {
  using namespace tmr::fbf;
  return Layout(W, P, TX, rows_of(span, cs), nstage, overlay != 0).total;
}

// cudaOccupancyMaxActiveClusters of clusters of cs CTAs at one CTA an SM
// (the most shared memory a CTA may take), or minus the CUDA error.
extern "C" int tmr_fused_bottleneck_f32_clusters(int cs) {
  using namespace tmr::fbf;
  return active_clusters(block_kernel(64), cs, 232448);
}

// x: (N, H, W, C) f32 NHWC; w1 (C, P), w2 (3, 3, P, P) HWIO, w3 (P, C) f32
// row-major; b1 (P,), b2 (P,), b3 (C,) f32; out like x; all 16-byte
// aligned. TX in {8, 16, 32, 64} with 8 TX dividing P and C (multiples of
// 64); cs in {2, 4, 8}; nstage 3 or 4; ceil(span / cs) <= BM = 2048 / TX
// and a span with its halo (span + 2 W + 2, or span where it is whole
// images) at most cs BM; overlay only where P = 8 TX; staged only where the
// residual fits over y1; N H W + span < 2^31.
// Returns cudaErrorInvalidValue for a call outside those, 100000 + the
// driver's CUresult where a tensor map does not encode, else the launch's
// CUDA error.
extern "C" int tmr_fused_bottleneck_f32(const void* x, const void* w1,
                                        const void* b1, const void* w2,
                                        const void* b2, const void* w3,
                                        const void* b3, void* out, int N,
                                        int H, int W, int C, int P, int TX,
                                        int span, int cs, int nstage,
                                        int overlay, int staged,
                                        void* stream) {
  using namespace tmr::fbf;
  if (check_call(N, H, W, C, P, TX, span, cs, nstage, overlay, staged))
    return (int)cudaErrorInvalidValue;
  const Args a{(const float*)x, (const float*)b1, (const float*)b2,
               (const float*)b3, (float*)out, H, W, C, P, N * H * W, span,
               cs, nstage, overlay, staged != 0};
  return launch_cluster(block_kernel(TX), TX, x, w1, w2, w3, a,
                        (cudaStream_t)stream);
}

#ifdef TMR_PROBE_F32_STATS
extern "C" int tmr_f32_stats(unsigned long long* host, int reset) {
  cudaError_t e = cudaMemcpyFromSymbol(host, tmr::fbf::f32_stats,
                                       sizeof(tmr::fbf::f32_stats));
  if (reset) {
    unsigned long long z[8] = {};
    cudaMemcpyToSymbol(tmr::fbf::f32_stats, z, sizeof(z));
  }
  return (int)e;
}
#endif
