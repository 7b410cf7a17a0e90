// Whole BN-folded stride-1 identity bottleneck on Hopper, NHWC bf16:
//   out = relu(x + W3 . relu(conv3x3(y1) + b2) + b3),  y1 = relu(W1 . x + b1)
// with y1 and y2 rounded to bf16 (x's dtype) and f32 accumulation, as the
// TPU kernel does.
//
// Replaces the Pallas TPU kernel
// tmrnet_tpu/experimental/fused_bottleneck.py::fused_bottleneck (:58-89,
// pallas_call at :71).
//
// Bound on the H100: operations by count. One stage of ResNet-50's identity
// blocks at N = 320 frames is ~140 GFLOP of bf16 products over at most ~1.7
// GB of activations in and out, above the ~295 FLOP/byte ridge at every
// stage. What bounds it in practice: how long the tensor cores wait on the
// serial steps of a block (K chunk copies, barriers, epilogues) and, at
// 7x7 (P = 512, one image per block), the weight stream from L2 (each block
// reads all 8.9 MB of the block's weights for 49 output rows). The design:
// - Whole-P register tiles on wgmma. A block of 8 warps (two warpgroups)
//   owns an (image, tile of TH rows). Each warpgroup keeps MT m64 tiles x
//   NWG columns of f32 accumulators in registers for a whole K loop (MT x
//   NWG = 256: 128 registers a thread) and multiplies with
//   wgmma.m64nNk16, A from registers, B from shared memory
//   (wgmma_tile.cuh). The block's output tile, BM = 64 x 8 / WN rows by
//   NB = 64 WN columns, covers all of P (WN = P / 64 up to 8), so phases 1
//   and 2 read each K chunk of A (the x rows; the y1 taps) once, not P / 64
//   times; phase 3 walks N = C in passes of NB over y2 in shared memory.
// - One cp.async stream. Every K chunk of every phase (KC = 32 deep) takes
//   one slot of a ring of NSTAGE >= 3 stages: the weight rows (B, in the
//   128-byte-swizzle layout wgmma reads) of all three phases and, in phase
//   1, the x rows (A, off-image rows copied with source size 0). The stream
//   runs across phase boundaries, so the next phase's weights are in
//   flight while an epilogue runs, and NSTAGE - 1 chunks are in flight
//   while one is multiplied. The loop keeps its slots and the conv's tap as
//   counters: no integer division on a chunk's path.
// - A in place. y1 lives in shared memory on a "wide" grid of (TH+2) x
//   (W+2) rows, zero on its pad columns and on halo rows off the image. The
//   conv's and phase 3's output rows are compact (TH x W): A reaches wgmma
//   through ldmatrix, which takes one row address per lane, so tap (dy, dx)
//   of output pixel (r, c) is y1 wide row (r + dy)(W+2) + c + dx, with no
//   im2col copy and no junk columns (a descriptor's 8-row core matrices
//   could not shift by one row). Rows past the tile's last are clamped to a
//   real row and never stored. Phase 1 computes only the in-image rows of
//   the tile and its halo, compactly (a table maps its rows to x), and its
//   epilogue scatters them into the wide grid.
// - The halo trap: y1 off the image is the conv's zero padding, not
//   relu(b1); those rows and the pad columns are zeroed, never computed.
// - y2 (TH x W rows) has its own region, or overlays y1 when phase 2 is a
//   single tile (stages 1-4 need it to fit); then every warp passes a
//   barrier before the first y2 store.
// - Phase 3 at P <= 128 (stages 1-2, where the epilogue's device-memory
//   traffic is a large share): each pass's residual tile of x is copied
//   into the ring's A parts (idle after phase 1) while the pass's K loop
//   runs; the epilogue adds it in shared memory and writes the tile out
//   with 16-byte stores.
// The wrapper's plan (experimental/fused_bottleneck.py::plan_bottleneck)
// picks TH, WN, NSTAGE and the overlay; `Layout` below and the plan's
// `layout_bytes` must agree, which the wrapper checks at every launch.
// One block per SM (up to 255 registers a thread, up to 227 KB).
//
// Probes (off in the library build; experimental/fused_bottleneck_probe.py
// builds each as a separate library and times it): TMR_PROBE_NO_B skips the
// weight copies, TMR_PROBE_NO_MMA the wgmma, TMR_PROBE_NO_EPILOGUE the
// epilogues (results are then wrong); TMR_PROBE_TRACE has thread 0 of each
// block stamp %globaltimer at its start, after its prologue, at the first
// chunk of each phase and at its end, into tmr_probe_trace.
#include <cuda_runtime.h>

#include "block_gemm_async.cuh"
#include "wgmma_tile.cuh"

#ifdef TMR_PROBE_TRACE
__device__ unsigned long long tmr_probe_trace[65536 * 6];
#define TMR_PROBE_STAMP(slot)                                               \
  do {                                                                      \
    const unsigned bid = blockIdx.y * gridDim.x + blockIdx.x;               \
    if (threadIdx.x == 0 && bid < 65536) {                                  \
      unsigned long long t;                                                 \
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));                 \
      tmr_probe_trace[bid * 6 + (slot)] = t;                                \
    }                                                                       \
  } while (0)
extern "C" int tmr_probe_trace_read(void* dst, int blocks) {
  return (int)cudaMemcpyFromSymbol(dst, tmr_probe_trace,
                                   (size_t)blocks * 6 * sizeof(long long));
}
#else
#define TMR_PROBE_STAMP(slot) \
  do {                        \
  } while (0)
#endif

namespace tmr {
namespace fb {

constexpr int THREADS = 256, WARPS = 8, KC = 32;
constexpr int LDA = KC + 8;  // A stage rows: 80 bytes, ldmatrix conflict-free

// Dynamic shared memory, byte offsets: the ring's A parts (NSTAGE of BM x
// LDA; phase 1 only), its B parts (NSTAGE of KC x NB in wgmma's canonical
// layout, wgmma_tile.cuh), y1 ((TH+2)(W+2) rows of P + 8), y2 (TH W rows of
// P + 8, or over y1), phase 1's row table (ints). `res`: phase 3's BM x
// (NB + 8) residual tile fits the A parts, which phase 3 does not use.
struct Layout {
  int a_stage, b_region, b_stage, y1, y2, rows, total;
  bool res;
  __host__ __device__ Layout(int W, int P, int TH, int WN, int nstage,
                             int overlay) {
    const int bm = 64 * (WARPS / WN), nb = 64 * WN, ldy = P + 8;
    a_stage = bm * LDA * 2;
    b_region = nstage * a_stage;
    b_stage = KC * nb * 2;
    res = b_region >= bm * (nb + 8) * 2;
    y1 = b_region + nstage * b_stage;
    const int y1_bytes = (TH + 2) * (W + 2) * ldy * 2;
    y2 = overlay ? y1 : y1 + y1_bytes;
    rows = y1 + y1_bytes + (overlay ? 0 : TH * W * ldy * 2);
    total = rows + (TH + 2) * W * 4 + 1024;  // + slack: ring 1 KB aligned
  }
};

// Wait until at most `pending` (clamped to 2) younger cp.async groups are
// in flight.
__device__ __forceinline__ void cp_async_wait_pending(int pending) {
  if (pending >= 2) {
    cp_async_wait<2>();
  } else if (pending == 1) {
    cp_async_wait<1>();
  } else {
    cp_async_wait<0>();
  }
}

__device__ __forceinline__ unsigned pack_bf16x2(float a, float b) {
  __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<unsigned*>(&h);
}

// Where the chunk stream is: phase (0, 1, 2), row tile, column pass, K chunk.
struct Cursor {
  int ph, mt, np, kc;
};

template <int WN>
__global__ void __launch_bounds__(THREADS, 1)
fused_bottleneck_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
                        const float* __restrict__ b1, const bf16* __restrict__ w2,
                        const float* __restrict__ b2, const bf16* __restrict__ w3,
                        const float* __restrict__ b3, bf16* __restrict__ out,
                        int H, int W, int C, int P, int TH, int nstage,
                        int overlay) {
  using namespace wgmma;
  TMR_PROBE_STAMP(0);
  // Block tile BM x NB; warpgroup g holds MT m64 tiles x NWG columns of it
  // (MT * NWG = 256, 128 accumulators a thread): side by side at P = 512
  // (WGN = 2), else one above the other.
  constexpr int WM = WARPS / WN, BM = 64 * WM, NB = 64 * WN;
  constexpr int WGN = WN == 8 ? 2 : 1, NWG = NB / WGN, MT = 256 / NWG;
  constexpr int NJ = NWG / 8;
  // Phase 3's residual tile through shared memory: only at MT >= 2 (P <=
  // 128), where it fits the A parts (L.res) and the epilogue's device-memory
  // traffic is a large share of the time; elsewhere its code would cost
  // registers in the main loop.
  constexpr bool RES = MT >= 2;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  // the swizzle atoms of B must be 1 KB aligned in the shared window
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const Layout L(W, P, TH, WN, nstage, overlay);
  bf16* y1 = reinterpret_cast<bf16*>(smem + L.y1);
  bf16* y2 = reinterpret_cast<bf16*>(smem + L.y2);
  int* rowoff = reinterpret_cast<int*>(smem + L.rows);
  bf16* rtile = reinterpret_cast<bf16*>(smem);  // over the A parts (L.res)
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2, wq = warp & 3;  // warpgroup, warp within it
  const int wg_row0 = WGN == 2 ? 0 : wg * 64 * MT;
  const int wg_col0 = WGN == 2 ? wg * NWG : 0;
  const int W2 = W + 2, LDY = P + 8, LDR = NB + 8;
  const int h0 = blockIdx.x * TH;
  const int th = min(TH, H - h0);                        // rows of this tile
  const int lo = max(h0 - 1, 0), hi = min(h0 + th + 1, H);  // y1's image rows
  const int M1 = (hi - lo) * W, M2 = th * W;
  const int shift = (h0 - lo) * W;  // output row m is phase 1's row m + shift
  const size_t img = (size_t)blockIdx.y * H * W * C;
  const bf16* xi = x + img;
  bf16* oi = out + img;

  // y1's pad columns and its halo rows off the image: the conv's zeros.
  const int p8 = P / 8;
  for (int v = tid; v < (th + 2) * W2 * p8; v += THREADS) {
    const int row = v / p8, hr = row / W2, col = row - hr * W2;
    const int h = h0 - 1 + hr;
    if (h < 0 || h >= H || col == 0 || col == W + 1)
      *reinterpret_cast<uint4*>(&y1[(size_t)row * LDY + (v - row * p8) * 8]) =
          make_uint4(0u, 0u, 0u, 0u);
  }
  // Phase 1's rows: x offset of compact row m (image row lo + m / W).
  for (int m = tid; m < M1; m += THREADS)
    rowoff[m] = ((lo + m / W) * W + m % W) * C;
  __syncthreads();
  TMR_PROBE_STAMP(1);

  // The chunk stream: per phase, row tiles x column passes x K chunks.
  const int nt1 = (M1 + BM - 1) / BM, nt2 = (M2 + BM - 1) / BM;
  const int nk0 = C / KC, nk1 = 9 * P / KC, nk2 = P / KC;
  const int np01 = P / NB, np2 = C / NB;
  const int total = nt1 * np01 * nk0 + nt2 * np01 * nk1 + nt2 * np2 * nk2;
  auto nk_of = [&](int ph) { return ph == 0 ? nk0 : ph == 1 ? nk1 : nk2; };
  auto advance = [&](Cursor& c) {
    if (++c.kc < nk_of(c.ph)) return;
    c.kc = 0;
    if (++c.np < (c.ph == 2 ? np2 : np01)) return;
    c.np = 0;
    if (++c.mt < (c.ph == 0 ? nt1 : nt2)) return;
    c.mt = 0;
    ++c.ph;
  };

  // Issue this thread's copies of one chunk into ring stage st.
  auto issue = [&](const Cursor& c, int st) {
    bf16* sb = reinterpret_cast<bf16*>(smem + L.b_region + st * L.b_stage);
    const int k0 = c.kc * KC, n0 = c.np * NB;
    const bf16* B = c.ph == 0 ? w1 : c.ph == 1 ? w2 : w3;
    const int ldb = c.ph == 2 ? C : P;
#pragma unroll
    for (int i = 0; i < WN; ++i) {  // KC x NB: 4 NB pieces of 16 bytes
      // a warp copies 4 rows x 128 bytes: 4 whole rows of a swizzle atom
      const int v = tid + i * THREADS;
      const int k = ((v >> 3) & 3) + 4 * ((v >> 5) % (KC / 4));
      const int n = 8 * (v & 7) + 64 * ((v >> 5) / (KC / 4));
#ifndef TMR_PROBE_NO_B
      cp_async16(&sb[b_chunk_offset(k, n, KC)],
                 &B[(size_t)(k0 + k) * ldb + n0 + n], true);
#endif
    }
    if (c.ph == 0) {
      bf16* sa = reinterpret_cast<bf16*>(smem + st * L.a_stage);
#pragma unroll
      for (int i = 0; i < WM; ++i) {  // BM x KC: 4 BM pieces
        const int v = tid + i * THREADS;
        const int r = v >> 2, c8 = (v & 3) * 8;
        const int m = c.mt * BM + r;
        const bool ok = m < M1;
        cp_async16(&sa[r * LDA + c8], ok ? xi + rowoff[m] + k0 + c8 : xi, ok);
      }
    }
  };

  // This lane's A row for m64 tile t of the current row tile (its warp's
  // 16 rows of it), as an element offset: into the A stage (phase 1), y1's
  // wide grid (phase 2), y2.
  int aoff[MT];
  auto set_rows = [&](const Cursor& c) {
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int r = wg_row0 + 64 * i + 16 * wq + (lane & 15);
      const int m = min(c.mt * BM + r, M2 - 1);  // clamp: junk rows unstored
      if (c.ph == 0) {
        aoff[i] = r * LDA;
      } else if (c.ph == 1) {
        const int rr = m / W;
        aoff[i] = (rr * W2 + m - rr * W) * LDY;
      } else {
        aoff[i] = m * LDY;
      }
    }
  };

  float acc[MT][NWG / 2];
  // One chunk: ldmatrix A, wgmma, retire the group before the ring slot,
  // A's registers or the accumulators are touched again. koff: the chunk's
  // A column as an element offset (phase 2: tap (dy, dx) and channel ci,
  // kept by the loop without a division).
  auto multiply = [&](const Cursor& c, int st, int koff) {
    const int k8 = (lane >> 4) * 8;
    const unsigned a0 =
        (c.ph == 0 ? smem_addr(smem + st * L.a_stage)
                   : smem_addr(c.ph == 1 ? y1 : y2) + koff * 2) +
        k8 * 2;
    unsigned a[KC / 16][MT][4];
#pragma unroll
    for (int kk = 0; kk < KC / 16; ++kk)
#pragma unroll
      for (int t = 0; t < MT; ++t) ldsm_x4(a[kk][t], a0 + (aoff[t] + 16 * kk) * 2);
    const unsigned b0 = smem_addr(smem + L.b_region + st * L.b_stage);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KC / 16; ++kk) {
      const uint64_t desc =
          b_desc(b0 + b_chunk_offset(16 * kk, wg_col0, KC) * 2, KC);
#pragma unroll
      for (int t = 0; t < MT; ++t) {
#ifndef TMR_PROBE_NO_MMA
        wgmma_rs<NWG>(acc[t], a[kk][t], desc, c.kc > 0 || kk > 0);
#endif
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_operand(reinterpret_cast<unsigned(&)[KC / 16 * MT * 4]>(a));
#pragma unroll
    for (int t = 0; t < MT; ++t) fence_operand(acc[t]);
  };

  // Epilogues from registers: lane holds rows 16 wq + lane / 4 (+ 8) of
  // each m64 tile and column pairs 8 j + 2 (lane % 4) of its warpgroup's
  // columns (wgmma_tile.cuh). In runs of 8 column groups: the bias pairs
  // are loaded once per run, and phase 3 (without the residual tile)
  // issues the 16 residual loads of a lane's two rows of an m64 tile before
  // any store, so that their device-memory latencies overlap.
  auto epilogue = [&](const Cursor& c) {
    const int row0 = c.mt * BM + wg_row0 + 16 * wq + (lane >> 2);
    const int col0 = c.np * NB + wg_col0 + (lane & 3) * 2;
    const float* bias = c.ph == 0 ? b1 : c.ph == 1 ? b2 : b3;
    if (c.ph == 1 && overlay) __syncthreads();  // every warp is done with y1
    if (RES && c.ph == 2 && L.res) {
      // out = relu(. + b3 + x) in place over the prefetched residual tile,
      // then 16-byte stores of its real rows
      cp_async_wait_pending(nk2 - 1);  // the tile's group is this pass's first
      __syncthreads();
      const int r0 = row0 - c.mt * BM, n0 = c.np * NB;
#pragma unroll
      for (int jb = 0; jb < NJ; jb += 8) {
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const float2 bq =
              __ldg(reinterpret_cast<const float2*>(bias + col0 + 8 * (jb + q)));
#pragma unroll
          for (int t = 0; t < MT; ++t)
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
              __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(
                  rtile + (r0 + 64 * t + 8 * hf) * LDR + col0 - n0 + 8 * (jb + q));
              const float2 r = __bfloat1622float2(*p);
              *p = __floats2bfloat162_rn(
                  fmaxf(acc[t][4 * (jb + q) + 2 * hf] + bq.x + r.x, 0.0f),
                  fmaxf(acc[t][4 * (jb + q) + 2 * hf + 1] + bq.y + r.y, 0.0f));
            }
        }
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < BM * NB / 8 / THREADS; ++i) {
        const int v = tid + i * THREADS, r = v / (NB / 8), c8 = v % (NB / 8) * 8;
        const int m = c.mt * BM + r;
        if (m < M2)
          *reinterpret_cast<uint4*>(oi + rowoff[m + shift] + n0 + c8) =
              *reinterpret_cast<const uint4*>(rtile + r * LDR + c8);
      }
      return;
    }
#pragma unroll
    for (int jb = 0; jb < NJ; jb += 8) {
      float2 bj[8];
#pragma unroll
      for (int q = 0; q < 8; ++q)
        bj[q] = __ldg(reinterpret_cast<const float2*>(bias + col0 + 8 * (jb + q)));
#pragma unroll
      for (int t = 0; t < MT; ++t) {
        size_t at[2];
        __nv_bfloat162 res[2][8];
        if (c.ph == 2) {
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int m = min(row0 + 64 * t + 8 * hf, M2 - 1), rr = m / W;
            at[hf] = ((size_t)(h0 + rr) * W + m - rr * W) * C + col0 + 8 * jb;
#pragma unroll
            for (int q = 0; q < 8; ++q)
              res[hf][q] = __ldg(
                  reinterpret_cast<const __nv_bfloat162*>(xi + at[hf] + 8 * q));
          }
        }
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int m = row0 + 64 * t + 8 * hf;
          float o[8][2];
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            o[q][0] = acc[t][4 * (jb + q) + 2 * hf] + bj[q].x;
            o[q][1] = acc[t][4 * (jb + q) + 2 * hf + 1] + bj[q].y;
          }
          bf16* dst;
          if (c.ph == 2) {  // out = relu(. + b3 + x)
            if (m >= M2) continue;
#pragma unroll
            for (int q = 0; q < 8; ++q) {
              const float2 r = __bfloat1622float2(res[hf][q]);
              o[q][0] += r.x;
              o[q][1] += r.y;
            }
            dst = oi + at[hf];
          } else if (c.ph == 0) {  // y1 = relu(. + b1), into the wide grid
            if (m >= M1) continue;
            const int hr = m / W, w = m - hr * W;
            dst = y1 + (size_t)((lo + hr - (h0 - 1)) * W2 + w + 1) * LDY +
                  col0 + 8 * jb;
          } else {  // y2 = relu(. + b2)
            if (m >= M2) continue;
            dst = y2 + (size_t)m * LDY + col0 + 8 * jb;
          }
#pragma unroll
          for (int q = 0; q < 8; ++q)
            *reinterpret_cast<unsigned*>(dst + 8 * q) =
                pack_bf16x2(fmaxf(o[q][0], 0.0f), fmaxf(o[q][1], 0.0f));
        }
      }
    }
  };

  Cursor prod{0, 0, 0, 0}, cons{0, 0, 0, 0};
  int st_prod = 0, st_cons = 0;
  for (int s = 0; s < nstage - 1; ++s) {
    if (s < total) {
      issue(prod, st_prod++);
      advance(prod);
    }
    cp_async_commit();
  }
  int ci = 0, tapoff = 0, dx = 0;  // phase 2: channel, tap offset, tap column
  for (int g = 0; g < total; ++g) {
    cp_async_wait_pending(nstage - 2);  // chunk g landed (this thread's part)
    __syncthreads();             // ... everyone's; and stage g-1 is free
    if (g + nstage - 1 < total) {
      issue(prod, st_prod);
      if (++st_prod == nstage) st_prod = 0;
      advance(prod);
    }
    if (RES && L.res && cons.ph == 2 && cons.kc == 0) {
      // this phase-3 pass's residual tile: x at its rows, columns n0 ..
      // n0 + NB (rows past M2 zero), in flight through the pass's K loop
      const int n0 = cons.np * NB;
#pragma unroll
      for (int i = 0; i < BM * NB / 8 / THREADS; ++i) {
        const int v = tid + i * THREADS, r = v / (NB / 8), c8 = v % (NB / 8) * 8;
        const int m = cons.mt * BM + r;
        const bool ok = m < M2;
        cp_async16(rtile + r * LDR + c8, ok ? xi + rowoff[m + shift] + n0 + c8 : xi,
                   ok);
      }
    }
    cp_async_commit();  // an empty group keeps the count uniform
    if (cons.kc == 0) {  // the first chunk's wgmma sets acc
      set_rows(cons);
      ci = tapoff = dx = 0;
      if (cons.mt == 0 && cons.np == 0) TMR_PROBE_STAMP(2 + cons.ph);
    }
    multiply(cons, st_cons, cons.ph == 1 ? tapoff + ci : cons.kc * KC);
    if (++st_cons == nstage) st_cons = 0;
#ifndef TMR_PROBE_NO_EPILOGUE
    if (cons.kc == nk_of(cons.ph) - 1) epilogue(cons);
#endif
    if ((ci += KC) == P) {  // next tap: (dy, dx) -> (dy, dx + 1) or (dy + 1, 0)
      ci = 0;
      tapoff += LDY;
      if (++dx == 3) {
        dx = 0;
        tapoff += (W2 - 3) * LDY;
      }
    }
    advance(cons);
  }
  cp_async_wait<0>();
  TMR_PROBE_STAMP(5);
}

template <int WN>
int launch(const void* x, const void* w1, const void* b1, const void* w2,
           const void* b2, const void* w3, const void* b3, void* out, int N,
           int H, int W, int C, int P, int TH, int nstage, int overlay,
           int smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      fused_bottleneck_kernel<WN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((H + TH - 1) / TH, N);
  fused_bottleneck_kernel<WN><<<grid, THREADS, smem, stream>>>(
      (const bf16*)x, (const bf16*)w1, (const float*)b1, (const bf16*)w2,
      (const float*)b2, (const bf16*)w3, (const float*)b3, (bf16*)out, H, W,
      C, P, TH, nstage, overlay);
  return (int)cudaGetLastError();
}

}  // namespace fb
}  // namespace tmr

// Shared memory one block needs under a plan (TH rows, WN warps across N,
// NSTAGE ring stages, y2 over y1 or not).
extern "C" int tmr_fused_bottleneck_smem(int W, int P, int TH, int WN,
                                         int nstage, int overlay) {
  return tmr::fb::Layout(W, P, TH, WN, nstage, overlay).total;
}

// x, out: (N, H, W, C) bf16 NHWC-contiguous; w1: (C, P), w2: (3, 3, P, P),
// w3: (P, C) bf16 contiguous; b1, b2: (P,), b3: (C,) f32. P and C multiples
// of 64 WN; WN in {1, 2, 4, 8}; nstage >= 3; overlay only where phase 2 is
// one tile (TH W <= 64 * 8 / WN rows, P == 64 WN); H W C < 2^31. Returns
// cudaErrorInvalidValue for a plan outside those, else cudaGetLastError().
extern "C" int tmr_fused_bottleneck(const void* x, const void* w1,
                                    const void* b1, const void* w2,
                                    const void* b2, const void* w3,
                                    const void* b3, void* out, int N, int H,
                                    int W, int C, int P, int TH, int WN,
                                    int nstage, int overlay, void* stream) {
  using namespace tmr::fb;
  const int nb = 64 * WN, bm = 64 * (WARPS / WN);
  const int smem = tmr_fused_bottleneck_smem(W, P, TH, WN, nstage, overlay);
  if ((WN != 1 && WN != 2 && WN != 4 && WN != 8) || P % nb || C % nb ||
      nstage < 3 || TH < 1 || smem > 232448 ||
      (long long)H * W * C > 0x7fffffff ||
      (overlay && (TH * W > bm || P != nb)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (WN) {
    case 1:
      return launch<1>(x, w1, b1, w2, b2, w3, b3, out, N, H, W, C, P, TH,
                       nstage, overlay, smem, s);
    case 2:
      return launch<2>(x, w1, b1, w2, b2, w3, b3, out, N, H, W, C, P, TH,
                       nstage, overlay, smem, s);
    case 4:
      return launch<4>(x, w1, b1, w2, b2, w3, b3, out, N, H, W, C, P, TH,
                       nstage, overlay, smem, s);
    default:
      return launch<8>(x, w1, b1, w2, b2, w3, b3, out, N, H, W, C, P, TH,
                       nstage, overlay, smem, s);
  }
}
