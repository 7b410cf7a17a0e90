// Block-wide int8 GEMM tile on the tensor cores with a dequantizing
// epilogue. Its only user is int8_matmul (int8_conv3x3 runs on int8 wgmma,
// wgmma_s8.cuh):
//   out[m, n] = float(sum_k A[m, k] * B[k, n]) * (a_scale * b_scale[n])
// with the int32 sum exact (|A|, |B| <= 127 and K below 2^31 / 127^2) and
// the scale product taken in f32 first, in the order of the TPU kernels
// (tmrnet_tpu/ops/quant.py:58-60), so the result equals the plain version's
// bit for bit.
//
// One thread block of NT = 256 threads (8 warps, 4 rows x 2 columns of
// 32x64 warp tiles) computes one BM x BN = 128x128 output tile with WMMA
// signed-char 16x16x16 fragments and int32 accumulators held in registers
// across K. K is walked in chunks of BK = 64 bytes through a 3-stage cp.async
// ring in shared memory: the copies of the next two chunks are in flight
// while the tensor cores run on this one. A rows come through a row
// functor (for int8_matmul a plain matrix), with 16-byte pieces that fall
// outside the data (rows past M, k past K) zero-filled by the copy itself;
// B (K x N) is row-major int8. The epilogue goes through a 16x16 int32
// scratch per warp, so nothing but the int8 operands and the result touch
// device memory.
//
// Needs K % 16 == 0, N % 16 == 0 and 16-byte-aligned rows; the wrappers
// check that.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace tmr8 {

constexpr int BM = 128, BN = 128, BK = 64, NT = 256, NSTAGE = 3;
// Each stage keeps A as BK/16 slices of (BM rows x 16 bytes) and B as BN/16
// slices of (BK rows x 16 bytes): a 16x16 fragment is then 256 contiguous
// bytes (leading dimension 16), 32-byte aligned as the fragment loads need
// and free of bank conflicts.
struct __align__(128) Ring {
  int8_t a[NSTAGE][BK / 16][BM][16];  // 3 x 8192 bytes
  int8_t b[NSTAGE][BN / 16][BK][16];  // 3 x 8192 bytes
};

struct __align__(128) Smem {
  Ring ring;
  int scratch[NT / 32][16 * 16];  // one 16x16 int32 tile per warp
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// a_row(m, k) returns a 16-byte-aligned pointer to A[m, k..k+15], or
// nullptr for 16 zeros (it must return nullptr for m >= M and k >= K).
// a_scale: one f32 on the device; b_scale: N f32; out: (M, N) f32, or bf16
// when out_bf16.
template <class ARow>
__device__ __forceinline__ void int8_gemm_tile(
    int M, int N, int K, ARow a_row, const int8_t* __restrict__ B,
    const float* __restrict__ a_scale, const float* __restrict__ b_scale,
    void* __restrict__ out, bool out_bf16, Smem& s) {
  using namespace nvcuda;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 1;  // 4 warp rows of 32
  const int wn = warp & 1;   // 2 warp columns of 64
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int nk = (K + BK - 1) / BK;
  Ring& r = s.ring;

  auto load = [&](int kc) {
    const int st = kc % NSTAGE, k0 = kc * BK;
#pragma unroll
    for (int i = 0; i < (BM * BK / 16) / NT; ++i) {
      const int v = tid + i * NT;
      const int row = v / (BK / 16), c16 = (v % (BK / 16)) * 16;
      const int8_t* p = a_row(m0 + row, k0 + c16);
      cp_async16(r.a[st][c16 / 16][row], p != nullptr ? p : B, p != nullptr);
    }
#pragma unroll
    for (int i = 0; i < (BK * BN / 16) / NT; ++i) {
      const int v = tid + i * NT;
      const int row = v / (BN / 16), c16 = (v % (BN / 16)) * 16;
      const int k = k0 + row, n = n0 + c16;
      const bool valid = k < K && n < N;
      cp_async16(r.b[st][c16 / 16][row], valid ? B + (size_t)k * N + n : B,
                 valid);
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0);

#pragma unroll
  for (int st = 0; st < NSTAGE - 1; ++st) {
    if (st < nk) load(st);
    cp_async_commit();
  }
  for (int kc = 0; kc < nk; ++kc) {
    cp_async_wait<NSTAGE - 2>();
    __syncthreads();
    if (kc + NSTAGE - 1 < nk) load(kc + NSTAGE - 1);
    cp_async_commit();
    const int st = kc % NSTAGE;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major>
          fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::row_major>
          fb[4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(
            fa[i],
            reinterpret_cast<const signed char*>(
                r.a[st][kk / 16][wm * 32 + i * 16]),
            16);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::load_matrix_sync(
            fb[j],
            reinterpret_cast<const signed char*>(
                r.b[st][wn * 4 + j][kk]),
            16);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();

  // Epilogue, one 16x16 fragment at a time through the warp's scratch: each
  // lane owns 8 consecutive columns of one row.
  int* sc = s.scratch[warp];
  const float as = a_scale[0];
  const int er = lane >> 1, ec = (lane & 1) * 8;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::store_matrix_sync(sc, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int m = m0 + wm * 32 + i * 16 + er;
      const int n = n0 + wn * 64 + j * 16 + ec;  // N % 16 == 0: all 8 or none
      if (m < M && n < N) {
        float o[8];
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const float scale = __fmul_rn(as, b_scale[n + q]);
          o[q] = __fmul_rn(__int2float_rn(sc[er * 16 + ec + q]), scale);
        }
        const size_t at = (size_t)m * N + n;
        if (out_bf16) {
          uint4 raw;
          __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
          for (int q = 0; q < 4; ++q)
            h[q] = __floats2bfloat162_rn(o[2 * q], o[2 * q + 1]);
          *reinterpret_cast<uint4*>(
              reinterpret_cast<__nv_bfloat16*>(out) + at) = raw;
        } else {
          float4* p = reinterpret_cast<float4*>(
              reinterpret_cast<float*>(out) + at);
          p[0] = make_float4(o[0], o[1], o[2], o[3]);
          p[1] = make_float4(o[4], o[5], o[6], o[7]);
        }
      }
      __syncwarp();
    }
  }
}

// Launch helper: grid over (M / BM, N / BN) output tiles, dynamic shared
// memory above the 48 KB default. Returns cudaGetLastError().
template <class Kernel, class... Args>
int launch(Kernel kernel, int M, int N, void* stream, Args... args) {
  const int smem = (int)sizeof(Smem);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  kernel<<<grid, NT, smem, (cudaStream_t)stream>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace tmr8
