// Block-wide bf16 GEMM tile on the tensor cores (WMMA, f32 accumulation)
// whose K loop streams its operands through a ring of NSTAGE shared-memory
// stages with cp.async: while chunk k runs on the tensor cores, the copies
// of chunks k+1 .. k+NSTAGE-1 are in flight. Used by fused_bottleneck_tiled.
//
// One thread block of NT = 256 threads (8 warps, 4 rows x 2 columns of
// 16x32 warp tiles) computes one BM x BN = 64x64 tile of C = A @ B, K walked
// in chunks of BK = 64. B (K x N) is a row-major bf16 matrix in global
// memory, always staged through the ring. A comes one of two ways:
// - gemm_tile_global_a: from global memory through a row functor, staged
//   through the ring; where the functor returns nullptr the cp.async copies
//   0 source bytes, which fills the 16 bytes with zeros (off-image taps);
// - gemm_tile_shared_a: a row-major bf16 matrix already in shared memory,
//   read by the fragment loads straight from there (no staging). Its row
//   stride and every fragment's address must be multiples of 32 bytes.
// The f32 result tile is written over the ring once the K loop is done
// (result_tile()), for the caller's epilogue; before the next call issues
// its copies into the ring the caller must __syncthreads().
#pragma once

#include "block_gemm.cuh"

namespace tmr {

constexpr int NSTAGE = 3;

struct __align__(128) AsyncRing {
  bf16 a[NSTAGE][BM * LDA];  // 3 x 9216 bytes
  bf16 b[NSTAGE][BK * LDB];  // 3 x 9216 bytes
};
static_assert(sizeof(float) * BM * LDC <= sizeof(AsyncRing),
              "the f32 result tile is kept over the ring");

__device__ __forceinline__ float* result_tile(AsyncRing& r) {
  return reinterpret_cast<float*>(&r);
}

// 16-byte global -> shared copy; valid == false copies 0 bytes and zero-fills
// (src must still be a valid address).
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

// The pipelined K loop. load_a(dst, k0) issues this thread's cp.async copies
// of the A chunk at k0 into dst (or nothing); a_frag(stage_a, row, k0, kk)
// returns the address of A[row, k0 + kk] for a fragment load of leading
// dimension lda.
template <class ALoad, class AFrag>
__device__ __forceinline__ void gemm_ring(int n0, int K, ALoad load_a,
                                          AFrag a_frag, int lda,
                                          const bf16* __restrict__ B, int ldb,
                                          AsyncRing& r) {
  using namespace nvcuda;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wm = warp >> 1;  // 4 warp rows of 16
  const int wn = warp & 1;   // 2 warp columns of 32
  const int nk = K / BK;
  auto load = [&](int kc) {
    const int st = kc % NSTAGE, k0 = kc * BK;
    load_a(r.a[st], k0);
#pragma unroll
    for (int i = 0; i < (BK * BN / 8) / NT; ++i) {
      const int v = tid + i * NT;
      const int row = v / (BN / 8), c8 = (v % (BN / 8)) * 8;
      cp_async16(&r.b[st][row * LDB + c8],
                 &B[(size_t)(k0 + row) * ldb + n0 + c8], true);
    }
  };
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
  wmma::fill_fragment(acc[0], 0.0f);
  wmma::fill_fragment(acc[1], 0.0f);
#pragma unroll
  for (int s = 0; s < NSTAGE - 1; ++s) {
    if (s < nk) load(s);
    cp_async_commit();
  }
  for (int kc = 0; kc < nk; ++kc) {
    cp_async_wait<NSTAGE - 2>();  // chunk kc has landed (this thread's part)
    __syncthreads();              // ... everyone's; and stage (kc-1) is free
    if (kc + NSTAGE - 1 < nk) load(kc + NSTAGE - 1);
    cp_async_commit();            // an empty group keeps the count uniform
    const int st = kc % NSTAGE;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::load_matrix_sync(fa, a_frag(r.a[st], wm * 16, kc * BK, kk), lda);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fb, &r.b[st][kk * LDB + wn * 32 + j * 16], LDB);
        wmma::mma_sync(acc[j], fa, fb, acc[j]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring: C goes over it
  float* c = result_tile(r);
#pragma unroll
  for (int j = 0; j < 2; ++j)
    wmma::store_matrix_sync(&c[(wm * 16) * LDC + wn * 32 + j * 16], acc[j],
                            LDC, wmma::mem_row_major);
  __syncthreads();
}

// A from global memory: a_row(m, k) returns a 16-byte-aligned pointer to
// A[m, k..k+7], or nullptr for eight zeros. K must be a multiple of BK.
template <class ARow>
__device__ __forceinline__ void gemm_tile_global_a(
    int m0, int n0, int K, ARow a_row, const bf16* __restrict__ B, int ldb,
    AsyncRing& r) {
  auto load_a = [&](bf16* dst, int k0) {
#pragma unroll
    for (int i = 0; i < (BM * BK / 8) / NT; ++i) {
      const int v = threadIdx.x + i * NT;
      const int row = v / (BK / 8), c8 = (v % (BK / 8)) * 8;
      const bf16* p = a_row(m0 + row, k0 + c8);
      cp_async16(&dst[row * LDA + c8], p != nullptr ? p : B, p != nullptr);
    }
  };
  auto a_frag = [](const bf16* stage_a, int row, int, int kk) {
    return stage_a + row * LDA + kk;
  };
  gemm_ring(n0, K, load_a, a_frag, LDA, B, ldb, r);
}

// A in shared memory: a_tile(k0) returns the address of A[m0, k0] (the
// tile's first row) in shared memory, rows lda elements apart.
template <class ATile>
__device__ __forceinline__ void gemm_tile_shared_a(
    int n0, int K, ATile a_tile, int lda, const bf16* __restrict__ B,
    int ldb, AsyncRing& r) {
  auto load_a = [](bf16*, int) {};
  auto a_frag = [&](const bf16*, int row, int k0, int kk) {
    return a_tile(k0) + (size_t)row * lda + kk;
  };
  gemm_ring(n0, K, load_a, a_frag, lda, B, ldb, r);
}

// Epilogue walk over the result tile: as for_each_run in block_gemm.cuh.
template <class Fn>
__device__ __forceinline__ void for_each_result_run(const AsyncRing& r,
                                                    Fn fn) {
  const float* c = reinterpret_cast<const float*>(&r);
#pragma unroll
  for (int i = 0; i < (BM * BN / 8) / NT; ++i) {
    const int v = threadIdx.x + i * NT;
    const int row = v / (BN / 8), c8 = (v % (BN / 8)) * 8;
    float vals[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) vals[j] = c[row * LDC + c8 + j];
    fn(row, c8, vals);
  }
}

}  // namespace tmr
