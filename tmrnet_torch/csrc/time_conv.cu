// TimeConv on Hopper: out = max(x, causal2max(x), conv3(x)+b3, conv5(x)+b5,
// conv7(x)+b7), SAME 1-D convolutions along the window axis of x (B, W, C),
// per sequence; the causal branch is max(x[t], x[t-1]) with x[-1] = 0.
// bf16 in and out, f32 accumulation, one rounding at the end.
//
// A column slice (tensor parallelism, tmrnet_torch/parallel/tensor.py):
// weights (k, Cin, Cout) and biases (Cout,) of the output channels
// c0 .. c0 + Cout of a layer over all Cin input channels; the identity and
// causal branches read x's channels c0 + n; the output is (B, W, Cout).
// The whole width is the slice c0 = 0, Cout = Cin, with the same
// arithmetic. A block's tile is the same; only where it reads a weight
// row (Cout apart), x's channel for the causal branch and where it writes
// (Cout apart) move.
//
// Replaces the Pallas TPU kernel tmrnet_tpu/ops/time_conv.py::time_conv_fused
// (:76-97, pallas_call at :82).
//
// Bound on the H100: operations. At the main path's shapes (B=32 clips,
// W=30, C=512) it is 2*960*512*(3+5+7)*512 = 7.5 GFLOP of bf16 products over
// 1 MB of activations and 7.9 MB of weights, above the card's ~295
// FLOP/byte ridge. In practice a block runs one serial loop over 60 K
// chunks (the 15 taps' weights for its 64 columns, ~1 MB from L2), so what
// it waits on is each chunk's fixed steps: the copy wait, a block barrier,
// ldmatrix and the wgmma chain. The design:
// - One warpgroup (128 threads) owns a tile of BM = 64 rows of M = B W by
//   BN = 64 output columns and keeps it as a wgmma f32 accumulator in
//   registers (wgmma_rs<64>, wgmma_tile.cuh), A from registers through
//   ldmatrix, B from shared memory in the 128-byte-swizzle layout.
// - A from a staged window tile. The block's x rows m0 - 3 .. m0 + BM + 2 of
//   a channel chunk (CK channels) are copied once into shared memory (rows
//   off [0, M) zero-filled) and feed all 15 taps: tap offset d of a lane's
//   row r reads staged row r + 3 + d, or a zero row where the source
//   position t + d falls outside [0, W) of the row's own sequence. ldmatrix
//   takes one row address per lane, so the per-sequence SAME padding costs
//   no copy. Rows are CK + 8 elements apart (16 bytes off a multiple of 128),
//   so ldmatrix's eight rows fall in distinct banks. Where the whole of C
//   fits (CK = C, the main path) x is staged once for all three branches;
//   else each (branch, chunk) region restages its chunk into one of two
//   buffers, alternately.
// - B through a cp.async ring of NSTAGE K chunks (KC = 128 input channels
//   of one tap where C allows, else 64; 64 columns): the chunk stream walks
//   branch -> channel chunk -> tap -> K chunk, and the x staging of a region
//   rides in the group of the region's first chunk. Only each branch's own
//   k taps are streamed; there are no zero taps.
// - One wgmma group in flight: chunk g's products are committed and the
//   loop waits only for chunk g-1's (A double-buffered in registers), so
//   the next chunk's barrier, copy issue and ldmatrix overlap chunk g on the
//   tensor cores. The copies run LEAD = NSTAGE - 2 chunks ahead: a stage is
//   refilled once every warp has retired the products that read it.
// - The branches are separate sums: the accumulator restarts at each
//   branch's first chunk, and at its last (after a full wait) the running
//   max takes max(best, acc + bias) in registers of the same fragment
//   layout. best starts as max(x[t], x[t-1]) read from the staged tile. The
//   tile is written once, as bf16.
// The wrapper's plan (ops/time_conv.py::plan_time_conv) picks KC and CK;
// `Layout` below and the plan's `time_conv_layout_bytes` must agree, which
// the wrapper checks at every launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "block_gemm_async.cuh"
#include "wgmma_tile.cuh"

namespace tmr {
namespace tc {

constexpr int THREADS = 128, BM = 64, BN = 64, HALO = 3, NSTAGE = 5;
constexpr int LEAD = NSTAGE - 2;      // chunks in flight ahead of the one multiplied
constexpr int XROWS = BM + 2 * HALO;  // staged x rows of a block

// Dynamic shared memory, byte offsets from a 1 KB aligned base: the ring
// (NSTAGE B parts of KC x BN, wgmma's canonical layout), the x tile (one
// or two buffers of XROWS rows of CK + 8), one zero row of CK.
struct Layout {
  int b_stage, x, ldx, x_elems, zero, total;
  __host__ __device__ Layout(int C, int KC, int CK) {
    b_stage = KC * BN * 2;
    x = NSTAGE * b_stage;
    ldx = CK + 8;
    x_elems = XROWS * ldx;
    zero = x + (C / CK > 1 ? 2 : 1) * x_elems * 2;
    total = zero + CK * 2 + 1024;  // + slack: the base is 1 KB aligned
  }
};

// Where the chunk stream is: branch (k = 3 + 2 br), channel chunk, tap,
// K chunk within the channel chunk.
struct Cursor {
  int br, ck, tap, kc;
};

__device__ __forceinline__ unsigned pack_bf16x2(float a, float b) {
  __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<unsigned*>(&h);
}

template <int KC>
__global__ void __launch_bounds__(THREADS)
time_conv_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w3,
                 const bf16* __restrict__ w5, const bf16* __restrict__ w7,
                 const float* __restrict__ b3, const float* __restrict__ b5,
                 const float* __restrict__ b7, bf16* __restrict__ out, int M,
                 int W, int C, int Cout, int c0, int CK) {
  using namespace wgmma;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  // the swizzle atoms of B must be 1 KB aligned in the shared window
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const Layout L(C, KC, CK);
  bf16* xs = reinterpret_cast<bf16*>(smem + L.x);
  const int tid = threadIdx.x, lane = tid & 31, wq = tid >> 5;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int nck = C / CK, nkc = CK / KC;
  const int total = 15 * nck * nkc;  // (3 + 5 + 7) taps x C / KC

  for (int i = tid; i < CK / 8; i += THREADS)
    reinterpret_cast<uint4*>(smem + L.zero)[i] = make_uint4(0u, 0u, 0u, 0u);

  auto advance = [&](Cursor& c) {
    if (++c.kc < nkc) return;
    c.kc = 0;
    if (++c.tap < 3 + 2 * c.br) return;
    c.tap = 0;
    if (++c.ck < nck) return;
    c.ck = 0;
    ++c.br;
  };
  // The x buffer of a (branch, channel chunk) region.
  auto xbuf = [&](const Cursor& c) {
    return nck > 1 ? xs + ((c.br * nck + c.ck) & 1) * L.x_elems : xs;
  };

  // Issue this thread's copies of one chunk into ring stage st: KC rows of
  // the tap's (C, Cout) weight, columns n0 .. n0 + BN; with a region's
  // first chunk, the region's x tile.
  auto issue = [&](const Cursor& c, int st) {
    bf16* sb = reinterpret_cast<bf16*>(smem + st * L.b_stage);
    const bf16* wk = c.br == 0 ? w3 : c.br == 1 ? w5 : w7;
    const bf16* src = wk + ((size_t)c.tap * C + c.ck * CK + c.kc * KC) * Cout + n0;
#pragma unroll
    for (int i = 0; i < KC * BN / 8 / THREADS; ++i) {
      // a warp copies 4 rows x 128 bytes: 4 whole rows of a swizzle atom
      const int v = tid + i * THREADS;
      const int k = ((v >> 3) & 3) + 4 * (v >> 5);
      const int n = 8 * (v & 7);
      cp_async16(&sb[b_chunk_offset(k, n, KC)], src + (size_t)k * Cout + n, true);
    }
    if (c.tap == 0 && c.kc == 0 && (nck > 1 || c.br == 0)) {
      bf16* xb = xbuf(c);
      const int p8 = CK / 8;
      for (int v = tid; v < XROWS * p8; v += THREADS) {
        const int r = v / p8, c8 = (v - r * p8) * 8;
        const int m = m0 - HALO + r;
        const bool ok = m >= 0 && m < M;
        cp_async16(xb + r * L.ldx + c8,
                   ok ? x + (size_t)m * C + c.ck * CK + c8 : x, ok);
      }
    }
  };

  // This lane's ldmatrix row of the tile, and its position in its sequence.
  const int arow = 16 * wq + (lane & 15);
  const int a_t = (m0 + arow) % W;
  const bool a_in = m0 + arow < M;
  const unsigned zero_addr = smem_addr(smem + L.zero);
  // This lane's accumulator rows erow and erow + 8, column pairs 8 j +
  // ecol (wgmma_tile.cuh).
  const int erow = 16 * wq + (lane >> 2), ecol = 2 * (lane & 3);

  float acc[BN / 2], best[BN / 2];

  // best = max(x[t], x[t-1]), x[-1] = 0, from the staged chunk holding
  // x's channels c0 + n0 .. c0 + n0 + BN.
  auto seed = [&](const bf16* xb) {
    const int cin = (c0 + n0) % CK;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = erow + 8 * hf;
      const bf16* cur = xb + (r + HALO) * L.ldx + cin;
      const bf16* prev = (m0 + r) % W > 0
                             ? cur - L.ldx
                             : reinterpret_cast<const bf16*>(smem + L.zero) + cin;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const float2 a = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(cur + 8 * j + ecol));
        const float2 b = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(prev + 8 * j + ecol));
        best[4 * j + 2 * hf] = fmaxf(a.x, b.x);
        best[4 * j + 2 * hf + 1] = fmaxf(a.y, b.y);
      }
    }
  };

  // best = max(best, acc + bias) at a branch's end.
  auto epilogue = [&](int br) {
    const float* bias = (br == 0 ? b3 : br == 1 ? b5 : b7) + n0 + ecol;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const float2 bj = __ldg(reinterpret_cast<const float2*>(bias + 8 * j));
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        best[4 * j + 2 * hf] = fmaxf(best[4 * j + 2 * hf], acc[4 * j + 2 * hf] + bj.x);
        best[4 * j + 2 * hf + 1] =
            fmaxf(best[4 * j + 2 * hf + 1], acc[4 * j + 2 * hf + 1] + bj.y);
      }
    }
  };

  Cursor prod{0, 0, 0, 0}, cons{0, 0, 0, 0};
  int st_prod = 0, st_cons = 0;
  for (int s = 0; s < LEAD; ++s) {
    if (s < total) {
      issue(prod, st_prod++);
      advance(prod);
    }
    cp_async_commit();
  }

  // Chunk g: its A into a[g & 1] while chunk g-1's products (A in the
  // other half) may still run; then retire chunk g-1's group, or at a
  // branch's end all. The loop takes chunks in pairs, so that a's halves
  // are registers, and leaves only after the last branch's full wait (an
  // exit that ptxas could reach with products in flight makes it drain the
  // tensor cores at every turn of the loop).
  unsigned a[2][KC / 16][4];
  for (int g0 = 0;; g0 += 2) {
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int g = g0 + p;
      cp_async_wait<LEAD - 1>();  // chunk g landed (this thread's part)
      __syncthreads();  // ... everyone's; every warp retired chunk g-2's products
      if (g + LEAD < total) {  // into chunk g-2's stage
        issue(prod, st_prod);
        if (++st_prod == NSTAGE) st_prod = 0;
        advance(prod);
      }
      cp_async_commit();  // an empty group keeps the count uniform
      const bf16* xb = xbuf(cons);
      if (cons.br == 0 && cons.tap == 0 && cons.kc == 0 &&
          cons.ck == (c0 + n0) / CK)
        seed(xb);
      const int d = cons.tap - (1 + cons.br);  // the tap's offset, -k/2 .. k/2
      const int ts = a_t + d;
      const bool ok = a_in && ts >= 0 && ts < W;
      const unsigned a_addr =
          (ok ? smem_addr(xb) + (arow + HALO + d) * L.ldx * 2 : zero_addr) +
          (cons.kc * KC + (lane >> 4) * 8) * 2;
#pragma unroll
      for (int kk = 0; kk < KC / 16; ++kk) ldsm_x4(a[p][kk], a_addr + 32 * kk);
      const unsigned b0 = smem_addr(smem + st_cons * L.b_stage);
      const bool first = cons.ck == 0 && cons.tap == 0 && cons.kc == 0;
      fence_operand(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KC / 16; ++kk)
        wgmma_rs<BN>(acc, a[p][kk],
                     b_desc(b0 + b_chunk_offset(16 * kk, 0, KC) * 2, KC),
                     !first || kk > 0);
      wgmma_commit();
      fence_operand(acc);
      if (cons.ck == nck - 1 && cons.tap == 2 + 2 * cons.br &&
          cons.kc == nkc - 1) {
        wgmma_wait<0>();
        fence_operand(reinterpret_cast<unsigned(&)[KC / 2]>(a));
        fence_operand(acc);
        epilogue(cons.br);
        if (cons.br == 2) goto stream_done;  // the last chunk
      } else {
        wgmma_wait<1>();
        fence_operand(reinterpret_cast<unsigned(&)[KC / 4]>(a[p ^ 1]));
      }
      if (++st_cons == NSTAGE) st_cons = 0;
      advance(cons);
    }
  }
stream_done:
  cp_async_wait<0>();

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int m = m0 + erow + 8 * hf;
    if (m >= M) continue;
    bf16* dst = out + (size_t)m * Cout + n0 + ecol;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
      *reinterpret_cast<unsigned*>(dst + 8 * j) =
          pack_bf16x2(best[4 * j + 2 * hf], best[4 * j + 2 * hf + 1]);
  }
}

template <int KC>
int launch(const void* x, const void* w3, const void* w5, const void* w7,
           const void* b3, const void* b5, const void* b7, void* out, int M,
           int W, int C, int Cout, int c0, int CK, int smem,
           cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      time_conv_kernel<KC>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((M + BM - 1) / BM, Cout / BN);
  time_conv_kernel<KC><<<grid, THREADS, smem, stream>>>(
      (const bf16*)x, (const bf16*)w3, (const bf16*)w5, (const bf16*)w7,
      (const float*)b3, (const float*)b5, (const float*)b7, (bf16*)out, M, W,
      C, Cout, c0, CK);
  return (int)cudaGetLastError();
}

}  // namespace tc
}  // namespace tmr

// Shared memory one block needs under a plan (KC-deep chunks, CK channels
// a staged x tile).
extern "C" int tmr_time_conv_smem(int C, int KC, int CK) {
  return tmr::tc::Layout(C, KC, CK).total;
}

// x: (B, W, C) bf16; w3/w5/w7: (k, C, Cout) bf16 (flax layout,
// contiguous); b3/b5/b7: (Cout,) f32; out: (B, W, Cout) bf16, the output
// channels c0 .. c0 + Cout (Cout = C, c0 = 0: the whole width). KC in
// {64, 128}; CK a multiple of KC dividing C; Cout and c0 multiples of 64,
// c0 + Cout <= C; B W C < 2^31. Returns cudaErrorInvalidValue for a plan
// outside those, else cudaGetLastError().
extern "C" int tmr_time_conv(const void* x, const void* w3, const void* w5,
                             const void* w7, const void* b3, const void* b5,
                             const void* b7, void* out, int B, int W, int C,
                             int Cout, int c0, int KC, int CK, void* stream) {
  using namespace tmr::tc;
  const long long M = (long long)B * W;
  if ((KC != 64 && KC != 128) || B < 1 || W < 1 || CK < KC || CK % KC ||
      C % CK || M * C > 0x7fffffff || Cout < BN || Cout % BN || c0 < 0 ||
      c0 % BN || c0 + Cout > C)
    return (int)cudaErrorInvalidValue;
  const int smem = tmr_time_conv_smem(C, KC, CK);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (KC == 64)
    return launch<64>(x, w3, w5, w7, b3, b5, b7, out, (int)M, W, C, Cout, c0,
                      CK, smem, s);
  return launch<128>(x, w3, w5, w7, b3, b5, b7, out, (int)M, W, C, Cout, c0,
                     CK, smem, s);
}
