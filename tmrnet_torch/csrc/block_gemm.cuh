// Block-wide bf16 GEMM tile on the tensor cores (WMMA, f32 accumulation),
// shared by the time_conv and fused_bottleneck kernels.
//
// One thread block of 256 threads (8 warps) computes one 64x64 tile of
// C = A @ B, where A (M x K) is read through a caller-supplied row functor
// (so A may be an implicit im2col view of global or shared memory, with
// zeros where a tap falls outside the data) and B (K x N) is a row-major
// bf16 weight matrix in global memory. K is walked in chunks of 64 staged in
// shared memory. The f32 result is left in shared memory (`Stage::c`) for
// the caller's epilogue.
//
// Design limits of this first version: no cp.async / TMA pipelining and no
// wgmma, so the loads of one chunk do not overlap the products of the last.
#pragma once

#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

namespace tmr {

typedef __nv_bfloat16 bf16;

constexpr int BM = 64, BN = 64, BK = 64, NT = 256;
// Padded leading dimensions: multiples of 8 (bf16) / 4 (f32) as WMMA needs,
// and off a multiple of 32 banks.
constexpr int LDA = BK + 8, LDB = BN + 8, LDC = BN + 4;

struct __align__(128) Stage {
  bf16 a[BM * LDA];   // 9216 bytes
  bf16 b[BK * LDB];   // 9216 bytes
  float c[BM * LDC];  // 17408 bytes
};

// a_row(m, k) returns a 16-byte-aligned pointer to A[m, k..k+7], or nullptr
// for eight zeros. K must be a multiple of BK; B has leading dimension ldb.
template <class ARow>
__device__ __forceinline__ void gemm_tile(int m0, int n0, int K, ARow a_row,
                                          const bf16* __restrict__ B, int ldb,
                                          Stage& s) {
  using namespace nvcuda;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wm = warp >> 1;  // 4 warp rows of 16
  const int wn = warp & 1;   // 2 warp columns of 32
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
  wmma::fill_fragment(acc[0], 0.0f);
  wmma::fill_fragment(acc[1], 0.0f);
  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int i = 0; i < (BM * BK / 8) / NT; ++i) {
      const int v = tid + i * NT;
      const int r = v / (BK / 8), c8 = (v % (BK / 8)) * 8;
      const bf16* p = a_row(m0 + r, k0 + c8);
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (p != nullptr) val = *reinterpret_cast<const uint4*>(p);
      *reinterpret_cast<uint4*>(&s.a[r * LDA + c8]) = val;
    }
#pragma unroll
    for (int i = 0; i < (BK * BN / 8) / NT; ++i) {
      const int v = tid + i * NT;
      const int r = v / (BN / 8), c8 = (v % (BN / 8)) * 8;
      *reinterpret_cast<uint4*>(&s.b[r * LDB + c8]) =
          *reinterpret_cast<const uint4*>(&B[(size_t)(k0 + r) * ldb + n0 + c8]);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::load_matrix_sync(fa, &s.a[(wm * 16) * LDA + kk], LDA);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fb, &s.b[kk * LDB + wn * 32 + j * 16], LDB);
        wmma::mma_sync(acc[j], fa, fb, acc[j]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < 2; ++j)
    wmma::store_matrix_sync(&s.c[(wm * 16) * LDC + wn * 32 + j * 16], acc[j],
                            LDC, wmma::mem_row_major);
  __syncthreads();
}

// Epilogue walk over the tile in Stage::c: each thread owns two runs of 8
// consecutive columns; fn(r, c8, v) gets the tile row, the run's first
// column and its eight f32 values. Callers __syncthreads() before anything
// reads what fn wrote to shared memory.
template <class Fn>
__device__ __forceinline__ void for_each_run(const Stage& s, Fn fn) {
#pragma unroll
  for (int i = 0; i < (BM * BN / 8) / NT; ++i) {
    const int v = threadIdx.x + i * NT;
    const int r = v / (BN / 8), c8 = (v % (BN / 8)) * 8;
    float vals[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) vals[j] = s.c[r * LDC + c8 + j];
    fn(r, c8, vals);
  }
}

__device__ __forceinline__ void load8(const bf16* p, float* out) {
  uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float2 f = __bfloat1622float2(h[j]);
    out[2 * j] = f.x;
    out[2 * j + 1] = f.y;
  }
}

__device__ __forceinline__ void store8(bf16* p, const float* v) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int j = 0; j < 4; ++j) h[j] = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
  *reinterpret_cast<uint4*>(p) = raw;
}

}  // namespace tmr
