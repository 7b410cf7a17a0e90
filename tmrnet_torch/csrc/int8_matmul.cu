// Int8 matmul with a dequantizing epilogue on Hopper:
//   out = f32(a_q @ b_q accumulated in int32) * (a_scale * b_scale[n])
// in f32 or bf16.
//
// Replaces the Pallas TPU kernel tmrnet_tpu/ops/quant.py::int8_matmul
// (:66-97, pallas_call at :80), whose int32 accumulator lives in VMEM
// scratch across the K grid axis.
//
// Bound on the H100: for an (M, K) @ (K, N) product with f32 output, 2 M K N
// operations over about M (K + 4 N) bytes, 2 K N / (K + 4 N) operations
// per byte against the int8 ridge of ~590 (1979 TOPS / 3.35 TB/s): bytes at
// the gate's 1x1 shapes (K, N <= 2048, at most ~512 per byte, at K = 2048,
// N = 512), operations for the square 8192^3 product. Design: the
// int8 tile of int8_gemm.cuh (WMMA 16x16x16 signed char, int32 accumulators
// in registers across K, 3-stage cp.async ring), A read as a plain
// row-major matrix. a_scale stays on the device (no host sync per call).
#include "int8_gemm.cuh"

namespace tmr8 {

__global__ void __launch_bounds__(NT)
int8_matmul_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ b,
                   const float* __restrict__ a_scale,
                   const float* __restrict__ b_scale, void* __restrict__ out,
                   int M, int N, int K, int out_bf16) {
  extern __shared__ __align__(128) unsigned char smem[];
  auto a_row = [=](int m, int k) -> const int8_t* {
    return (m < M && k < K) ? a + (size_t)m * K + k : nullptr;
  };
  int8_gemm_tile(M, N, K, a_row, b, a_scale, b_scale, out, out_bf16 != 0,
                 *reinterpret_cast<Smem*>(smem));
}

}  // namespace tmr8

// a: (M, K) int8, b: (K, N) int8, row-major contiguous; a_scale: one f32;
// b_scale: (N,) f32; out: (M, N) f32, or bf16 when out_bf16; all on the
// device. K % 16 == 0, N % 16 == 0. Returns cudaGetLastError().
extern "C" int tmr_int8_matmul(const void* a, const void* b,
                               const void* a_scale, const void* b_scale,
                               void* out, int M, int N, int K, int out_bf16,
                               void* stream) {
  using namespace tmr8;
  return launch(int8_matmul_kernel, M, N, stream, (const int8_t*)a,
                (const int8_t*)b, (const float*)a_scale,
                (const float*)b_scale, out, M, N, K, out_bf16);
}
