// Int8 3x3 SAME stride-1 convolution with a dequantizing epilogue on Hopper,
// NHWC:
//   out[n, h, w, o] = f32(sum over (dy, dx, ci) of xpad[n, h+dy, w+dx, ci]
//                     * w_q[dy, dx, ci, o], in int32) * (x_scale * w_scale[o])
// in f32 or bf16. Quantization is symmetric with no zero point, so the
// padding is int8 0.
//
// Replaces the Pallas TPU kernel
// tmrnet_tpu/experimental/quant_conv.py::int8_conv3x3 (:47-73, pallas_call
// at :57), which builds a (Nb, H, W, 9C) im2col in VMEM for one K = 9C
// contraction.
//
// Bound on the H100: 2 M 9C Co operations (M = N H W) over about
// M (C + 4 Co) bytes with f32 output, ~3.6 C operations per byte at C = Co
// against the int8 ridge of ~590: bytes at the gate's C = 64 and 128,
// operations at 256 and 512. Design: an implicit GEMM on the int8 tile of
// int8_gemm.cuh with M = N H W, K = 9C in the (dy, dx, ci) order of the
// HWIO weight and N = Co.
// Each 16-byte piece of an A row is one tap's 16 channels (C % 16 == 0, so a
// piece never straddles two taps), copied from the input by cp.async, or
// zero-filled where the tap falls off the image: no im2col in device memory.
#include "int8_gemm.cuh"

namespace tmr8 {

__global__ void __launch_bounds__(NT)
int8_conv3x3_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                    const float* __restrict__ x_scale,
                    const float* __restrict__ w_scale, void* __restrict__ out,
                    int NB, int H, int W, int C, int CO, int out_bf16) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int HW = H * W, M = NB * HW, K = 9 * C;
  auto a_row = [=](int m, int k) -> const int8_t* {
    if (m >= M || k >= K) return nullptr;
    const int tap = k / C, ci = k - tap * C;
    const int dy = tap / 3, dx = tap - dy * 3;
    const int n = m / HW, rem = m - n * HW;
    const int h = rem / W + dy - 1, ww = rem % W + dx - 1;
    if (h < 0 || h >= H || ww < 0 || ww >= W) return nullptr;
    return x + (((size_t)n * H + h) * W + ww) * C + ci;
  };
  int8_gemm_tile(M, CO, K, a_row, w, x_scale, w_scale, out, out_bf16 != 0,
                 *reinterpret_cast<Smem*>(smem));
}

}  // namespace tmr8

// x: (N, H, W, C) int8 NHWC-contiguous; w: (3, 3, C, Co) int8 contiguous;
// x_scale: one f32; w_scale: (Co,) f32; out: (N, H, W, Co) f32, or bf16 when
// out_bf16; all on the device. C % 16 == 0, Co % 16 == 0, N H W < 2^31.
// Returns cudaGetLastError().
extern "C" int tmr_int8_conv3x3(const void* x, const void* w,
                                const void* x_scale, const void* w_scale,
                                void* out, int N, int H, int W, int C, int CO,
                                int out_bf16, void* stream) {
  using namespace tmr8;
  return launch(int8_conv3x3_kernel, N * H * W, CO, stream, (const int8_t*)x,
                (const int8_t*)w, (const float*)x_scale,
                (const float*)w_scale, out, N, H, W, C, CO, out_bf16);
}
