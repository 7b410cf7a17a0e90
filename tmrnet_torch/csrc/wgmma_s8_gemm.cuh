// The block of the port's two int8 kernels (int8_matmul, int8_conv3x3): one
// BM x BN output tile of
//   out[m, n] = f32(sum_k A[m, k] * B[n, k], exact in int32)
//               * (a_scale * b_scale[n])
// in f32 or bf16, the scale product taken in f32 first (the order of the
// TPU kernels, tmrnet_tpu/ops/quant.py:58-60), so the result equals the
// plain versions' bit for bit. The int32 sum is exact for |A|, |B| <= 127
// and K below 2^31 / 127^2.
//
// - Both operands K-major, as the integer wgmma requires (wgmma_s8.cuh): A
//   as M rows, B as N rows, each row K contiguous int8. B is read from
//   device memory as such; A's rows come through the kernel's loader, so
//   the conv gathers them from an image where the matmul reads a matrix.
// - K chunks of BK = 128 bytes, one swizzle atom wide, through a ring of
//   NSTAGE stages in shared memory, filled by cp.async. A thread copies
//   16-byte piece threadIdx.x % 8 of rows threadIdx.x / 8 + 32 i of A and
//   of B; pieces with no data (past M, N or K, or off the image) are
//   zero-filled by the copy, so they add zero products.
// - 256 threads, two warpgroups, each owning one m64 tile of a BM = 128 x
//   BN tile; BN in {64, 128, 256}, so a narrow N does not pay for a wide
//   tile. Each kernel's plan (Python) picks BN and NSTAGE per shape, and the
//   kernel the order of the tiles over the grid (Order).
// - Every chunk issues its four k32 steps, those past K on zeros. Issuing
//   only the steps that hold some k < K (2 at K = 64), by a test per step
//   or a switch on the count, made ptxas inject warpgroup.arrive before
//   the wgmma (C7519) and slowed the conv by 1-6% at the gate's stages on
//   the H100, and gained nothing at K = 64, where the output's stores bound
//   the time.
// - The accumulators start as the first k32 step's product (scale_d = 0),
//   not as zeros written by other instructions: ptxas serializes wgmma
//   where non-wgmma instructions define accumulator registers (C7515).
// - One wgmma group in flight: chunk kc's products are committed, the
//   copies of chunk kc + NSTAGE - 2 are issued into the stage chunk kc - 2
//   read (every warpgroup retired it before the block barrier), then the
//   group of chunk kc - 1 is retired.
// - The epilogue goes from registers to device memory: a quad of lanes
//   writes 8 consecutive columns of a row (32 bytes in f32).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "block_gemm_async.cuh"
#include "tma.cuh"
#include "wgmma_s8.cuh"

namespace tmr {
namespace i8 {

constexpr int THREADS = 256, BM = 128, BK = 128;
constexpr int AROWS = BM / 32;  // A rows a thread copies a chunk

__host__ __device__ constexpr int stage_bytes(int bn) { return (BM + bn) * BK; }

// Dynamic shared memory of a block: the ring, + 1 KB of slack to align it.
__host__ __device__ constexpr int smem_bytes(int bn, int nstage) {
  return nstage * stage_bytes(bn) + 1024;
}

// A block's output tile: rows m0 .. m0 + BM, columns n0 .. n0 + BN.
struct Tile {
  int m0, n0;
};

// The order of the tiles over the grid. kRowBlocks: a 1-D grid over the
// tiles in row-major order, so the column tiles of one row block run side
// by side and read its A rows once from device memory (the matmul, whose
// P -> C products have up to 16 column tiles: 10% less time a gate pass on
// the H100). kColumns: a 2-D grid, x over the row blocks (the conv, 2% less
// time at the gate's stage 4 that way).
enum class Order { kRowBlocks, kColumns };

template <int BN, Order ORDER>
__device__ __forceinline__ Tile block_tile(int N) {
  if (ORDER == Order::kColumns)
    return {(int)blockIdx.x * BM, (int)blockIdx.y * BN};
  const int nt = (N + BN - 1) / BN;
  return {(int)(blockIdx.x / nt) * BM, (int)(blockIdx.x % nt) * BN};
}

// One block's tile = block_tile<BN, ORDER>(N) under dynamic shared memory of
// smem_bytes(BN, NSTAGE); bk is B as (N, K). load_a(sa, k) issues this
// thread's copies of A into the ring stage at sa: the 16 bytes at k (k % 128
// = 16 (threadIdx.x % 8)) of the tile's rows r = threadIdx.x / 8 + 32 i, i <
// AROWS, each at sa + kmajor_offset(r, k % 128), zero-filled where there
// is no data.
template <int BN, int NSTAGE, class LoadA>
__device__ __forceinline__ void gemm_block(
    Tile tile, LoadA load_a, const int8_t* __restrict__ bk,
    const float* __restrict__ a_scale, const float* __restrict__ b_scale,
    void* __restrict__ out, int M, int N, int K, int out_bf16) {
  using namespace wgmma;
  constexpr int LEAD = NSTAGE - 2;  // chunks in flight ahead of the one multiplied
  constexpr int BROWS = BN / 32;
  constexpr int SB = stage_bytes(BN);
  extern __shared__ __align__(128) unsigned char smem_raw[];
  // the swizzle atoms must be 1 KB aligned in the shared window
  unsigned char* smem =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const int tid = threadIdx.x;
  const int nk = (K + BK - 1) / BK;
  const int m0 = tile.m0, n0 = tile.n0;
  const int piece = tid & 7, row0 = tid >> 3;

  // This thread's copies of chunk kc into ring stage st.
  auto load = [&](int kc, int st) {
    const int k = kc * BK + 16 * piece;
    unsigned char* sa = smem + st * SB;
    load_a(sa, k);
    unsigned char* sb = sa + BM * BK;
    const bool kin = k < K;
#pragma unroll
    for (int i = 0; i < BROWS; ++i) {
      const int r = row0 + 32 * i;
      const bool ok = kin && n0 + r < N;
      const int8_t* src = ok ? bk + (size_t)(n0 + r) * K + k : bk;
      cp_async16(sb + kmajor_offset(r, 16 * piece), src, ok);
    }
  };

  const int wg = tid >> 7;
  int acc[BN / 2];  // written first by chunk 0's first k32 step

#pragma unroll
  for (int s = 0; s < LEAD; ++s) {
    if (s < nk) load(s, s);
    cp_async_commit();
  }
  for (int kc = 0; kc < nk; ++kc) {
    cp_async_wait<LEAD - 1>();  // chunk kc landed (this thread's copies)
    tma::fence_async_shared();
    __syncthreads();  // ... everyone's; every warpgroup retired chunk kc - 2
    const int st = kc % NSTAGE;
    const unsigned a0 = smem_addr(smem + st * SB) + wg * 64 * BK;
    const unsigned b0 = smem_addr(smem + st * SB + BM * BK);
    fence_operand(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 32; ++kk)
      wgmma_ss_s8<BN>(acc, kmajor_desc(a0 + 32 * kk), kmajor_desc(b0 + 32 * kk),
                      kc > 0 || kk > 0);
    wgmma_commit();
    if (kc + LEAD < nk) load(kc + LEAD, (kc + LEAD) % NSTAGE);
    cp_async_commit();  // an empty group keeps the count uniform
    wgmma_wait<1>();    // chunk kc - 1 retired
    fence_operand(acc);
  }
  wgmma_wait<0>();
  fence_operand(acc);
  cp_async_wait<0>();

  // Epilogue: rows 16 warp + lane / 4 (+ 8), column pairs 8 j + 2 (lane % 4).
  const float as = a_scale[0];
  const int warp = (tid >> 5) & 3, lane = tid & 31;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int m = m0 + wg * 64 + 16 * warp + (lane >> 2) + 8 * hf;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int n = n0 + 8 * j + 2 * (lane & 3);
      if (n >= N) break;  // N % 16 == 0: both columns or neither
      const float2 s = __ldg(reinterpret_cast<const float2*>(b_scale + n));
      const float o0 =
          __fmul_rn(__int2float_rn(acc[4 * j + 2 * hf]), __fmul_rn(as, s.x));
      const float o1 =
          __fmul_rn(__int2float_rn(acc[4 * j + 2 * hf + 1]), __fmul_rn(as, s.y));
      const size_t at = (size_t)m * N + n;
      if (out_bf16)
        *reinterpret_cast<__nv_bfloat162*>(
            reinterpret_cast<__nv_bfloat16*>(out) + at) =
            __floats2bfloat162_rn(o0, o1);
      else
        *reinterpret_cast<float2*>(reinterpret_cast<float*>(out) + at) =
            make_float2(o0, o1);
    }
  }
}

// Launch kernel, a __global__ over gemm_block<BN, NSTAGE> on the tiles
// block_tile<BN, ORDER> gives, over an M x N output; returns a cudaError_t
// as int.
template <int BN, int NSTAGE, Order ORDER, class... P, class... A>
int launch(void (*kernel)(P...), int M, int N, cudaStream_t stream,
           A... args) {
  const int smem = smem_bytes(BN, NSTAGE);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const long long mt = (M + BM - 1) / BM, nt = (N + BN - 1) / BN;
  if (ORDER == Order::kColumns) {
    if (nt > 65535) return (int)cudaErrorInvalidValue;
    kernel<<<dim3((unsigned)mt, (unsigned)nt), THREADS, smem, stream>>>(args...);
  } else {
    if (mt * nt > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    kernel<<<(unsigned)(mt * nt), THREADS, smem, stream>>>(args...);
  }
  return (int)cudaGetLastError();
}

}  // namespace i8
}  // namespace tmr
