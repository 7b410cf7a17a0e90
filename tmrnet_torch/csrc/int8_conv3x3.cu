// Int8 3x3 SAME stride-1 convolution with a dequantizing epilogue on Hopper,
// NHWC:
//   out[n, h, w, o] = f32(sum over (dy, dx, ci) of xpad[n, h+dy, w+dx, ci]
//                     * w_q[dy, dx, ci, o], in int32) * (x_scale * w_scale[o])
// in f32 or bf16, the scale product taken in f32 first (the order of the
// TPU kernel), so the result equals the plain version's bit for bit.
// Quantization is symmetric with no zero point, so the padding is int8 0.
//
// Replaces the Pallas TPU kernel
// tmrnet_tpu/experimental/quant_conv.py::int8_conv3x3 (:47-73, pallas_call
// at :57), which builds a (Nb, H, W, 9C) im2col in VMEM for one K = 9C
// contraction.
//
// Bound on the H100: 2 M 9C Co operations (M = N H W) over about
// M (C + 4 Co) bytes with f32 output, ~3.6 C operations per byte at C = Co
// against the int8 ridge of ~590: bytes at the gate's C = 64 and 128 (the
// f32 output), operations at 256 and 512.
//
// Design: an implicit GEMM on the int8 wgmma block of wgmma_s8_gemm.cuh
// (shared with int8_matmul: ring, k32 steps, epilogue) with M = N H W,
// K = 9C in the (dy, dx, ci) order of the HWIO weight and N = Co.
// - Both operands K-major, as the integer wgmma requires: A's rows are
//   pixels, B's rows output channels; the wrapper hands over the weight as
//   (Co, 9C) (w_kmajor, made once per weight version).
// - This file's part is A's loader: each 16-byte piece of an A row is one
//   tap's 16 channels (C % 16 == 0, so a piece never straddles two taps),
//   copied from x, or zero where the tap leaves the image or k >= K: no
//   im2col in device memory. A 9-bit mask of in-image taps per row, made
//   once per block, so any H and W work.
// - The plan (experimental/quant_conv.py::plan_int8_conv3x3) picks BN and
//   NSTAGE. (Tiles of BM = 256, two m64 tiles a warpgroup, were slower at
//   every gate stage on the H100.)
//
// wgmma_s8_tile_kernel below is the header's own check: one 64 x 128 @
// 128 x N chunk, s32 out, through the same copies and descriptors.
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma_s8_gemm.cuh"

namespace tmr {
namespace i8 {

// Blocks an SM must hold by registers (the plan's blocks_per_sm): 3 at BN =
// 64 (at most 85 registers a thread), 2 at 128, 1 at 256.
template <int BN, int NSTAGE>
__global__ void __launch_bounds__(THREADS, BN == 64 ? 3 : BN == 128 ? 2 : 1)
int8_conv3x3_kernel(const int8_t* __restrict__ x,
                    const int8_t* __restrict__ wk,
                    const float* __restrict__ x_scale,
                    const float* __restrict__ w_scale, void* __restrict__ out,
                    int H, int W, int C, int CO, int M, int out_bf16) {
  const int K = 9 * C;
  const Tile tile = block_tile<BN, Order::kColumns>(CO);
  const int m0 = tile.m0, piece = threadIdx.x & 7, row0 = threadIdx.x >> 3;

  // Bit t of taps[i]: tap t (dy = t / 3 - 1, dx = t % 3 - 1) of this
  // thread's A row i lies in the image; no bit for a row past M.
  int taps[AROWS];
#pragma unroll
  for (int i = 0; i < AROWS; ++i) {
    const int m = m0 + row0 + 32 * i;
    taps[i] = 0;
    if (m < M) {
      const int rem = m % (H * W), h = rem / W, w = rem - h * W;
#pragma unroll
      for (int t = 0; t < 9; ++t)
        taps[i] |= ((unsigned)(h + t / 3 - 1) < (unsigned)H &&
                    (unsigned)(w + t % 3 - 1) < (unsigned)W) << t;
    }
  }

  auto load_a = [&](unsigned char* sa, int k) {
    const int tap = k / C, ci = k - tap * C;  // tap >= 9 where k >= K
    const int dy = tap / 3 - 1, dx = tap % 3 - 1;
    const bool kin = k < K;
#pragma unroll
    for (int i = 0; i < AROWS; ++i) {
      const int r = row0 + 32 * i;
      const bool ok = kin && (taps[i] >> tap & 1);
      const int8_t* src =
          ok ? x + (size_t)(m0 + r + dy * W + dx) * C + ci : x;
      cp_async16(sa + wgmma::kmajor_offset(r, 16 * piece), src, ok);
    }
  };
  gemm_block<BN, NSTAGE>(tile, load_a, wk, x_scale, w_scale, out, M, CO, K,
                         out_bf16);
}

// One warpgroup: out (64 x N, s32) = a (64 x 128) @ b (N x 128)^T, both
// int8 K-major, copied by cp.async into the swizzled layout; the first k32
// step with scale_d = 0 over accumulators that start nonzero.
template <int N>
__global__ void __launch_bounds__(128)
wgmma_s8_tile_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ b,
                     int* __restrict__ out) {
  using namespace wgmma;
  __shared__ __align__(1024) unsigned char s[(64 + N) * BK];
  const int tid = threadIdx.x, piece = tid & 7;
  for (int r = tid >> 3; r < 64 + N; r += 16) {
    const int8_t* src = r < 64 ? a + r * BK : b + (r - 64) * BK;
    cp_async16(s + kmajor_offset(r, 16 * piece), src + 16 * piece, true);
  }
  cp_async_commit();
  cp_async_wait<0>();
  tma::fence_async_shared();
  __syncthreads();
  int acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 12345;
  const unsigned a0 = smem_addr(s), b0 = a0 + 64 * BK;
  fence_operand(acc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 32; ++kk)
    wgmma_ss_s8<N>(acc, kmajor_desc(a0 + 32 * kk), kmajor_desc(b0 + 32 * kk),
                   kk > 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_operand(acc);
  const int warp = tid >> 5, lane = tid & 31;
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      out[(16 * warp + (lane >> 2) + 8 * (e >> 1)) * N + 8 * j + 2 * (lane & 3) +
          (e & 1)] = acc[4 * j + e];
}

}  // namespace i8
}  // namespace tmr

// The (BN, NSTAGE) plans the kernel is built for.
// (At BN = 256 a block holds the SM alone whatever the ring's depth, so
// the plan would never pick a shallower ring there.)
#define TMR_I8C_PLANS(X) X(64, 3) X(64, 4) X(128, 3) X(128, 4) X(256, 4)

// Shared memory of a block under a plan, or -1 for a plan the kernel is not
// built for.
extern "C" int tmr_int8_conv3x3_smem(int BN, int NSTAGE) {
#define TMR_I8C_SMEM(bn, ns) \
  if (BN == bn && NSTAGE == ns) return tmr::i8::smem_bytes(bn, ns);
  TMR_I8C_PLANS(TMR_I8C_SMEM)
#undef TMR_I8C_SMEM
  return -1;
}

// x: (N, H, W, C) int8 NHWC-contiguous; w_kmajor: (Co, 9C) int8, row o the
// HWIO weight's column o in (dy, dx, ci) order; x_scale: one f32; w_scale:
// (Co,) f32; out: (N, H, W, Co) f32, or bf16 when out_bf16; all on the
// device. C % 16 == 0, Co % 16 == 0, N H W below 2^31; (BN, NSTAGE) one
// of TMR_I8C_PLANS. Returns
// cudaErrorInvalidValue outside those, else cudaGetLastError().
extern "C" int tmr_int8_conv3x3(const void* x, const void* w_kmajor,
                                const void* x_scale, const void* w_scale,
                                void* out, int N, int H, int W, int C, int CO,
                                int out_bf16, int BN, int NSTAGE,
                                void* stream) {
  const long long M = (long long)N * H * W;
  if (C < 16 || C % 16 || CO < 16 || CO % 16 || M < 1 || M > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
#define TMR_I8C_LAUNCH(bn, ns)                                          \
  if (BN == bn && NSTAGE == ns)                                         \
    return tmr::i8::launch<bn, ns, tmr::i8::Order::kColumns>(           \
        tmr::i8::int8_conv3x3_kernel<bn, ns>, (int)M, CO,               \
        (cudaStream_t)stream, (const int8_t*)x, (const int8_t*)w_kmajor, \
        (const float*)x_scale, (const float*)w_scale, out, H, W, C, CO, \
        (int)M, out_bf16);
  TMR_I8C_PLANS(TMR_I8C_LAUNCH)
#undef TMR_I8C_LAUNCH
  return (int)cudaErrorInvalidValue;
}

// a: (64, 128) int8; b: (N, 128) int8; out: (64, N) int32, all contiguous
// on the device; N in {64, 128, 256}. Returns cudaErrorInvalidValue for
// another N, else cudaGetLastError().
extern "C" int tmr_wgmma_s8_tile(const void* a, const void* b, void* out,
                                 int N, void* stream) {
  using namespace tmr::i8;
  const int8_t* pa = (const int8_t*)a;
  const int8_t* pb = (const int8_t*)b;
  cudaStream_t s = (cudaStream_t)stream;
  if (N == 64)
    wgmma_s8_tile_kernel<64><<<1, 128, 0, s>>>(pa, pb, (int*)out);
  else if (N == 128)
    wgmma_s8_tile_kernel<128><<<1, 128, 0, s>>>(pa, pb, (int*)out);
  else if (N == 256)
    wgmma_s8_tile_kernel<256><<<1, 128, 0, s>>>(pa, pb, (int*)out);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
