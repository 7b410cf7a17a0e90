// Whole BN-folded stride-1 identity bottleneck on Hopper, NHWC bf16, tiled
// over H with a 1-row halo:
//   out = relu(x + W3 . relu(conv3x3(y1) + b2) + b3),  y1 = relu(W1 . x + b1)
// with y1 and y2 rounded to bf16 (x's dtype) and f32 accumulation, as the
// TPU kernel does.
//
// Replaces the Pallas TPU kernel
// tmrnet_tpu/experimental/fused_bottleneck_tiled.py::fused_bottleneck_tiled
// (:123-162, pallas_call at :142). That kernel DMAs one halo'd slab of a
// zero-padded x per grid step, starts the next step's slab during this
// step's compute, and reads phase 3's residual from the slab.
//
// Bound on the H100: operations by count (ResNet-50's identity blocks at N
// = 320 frames are ~140 GFLOP of bf16 products a stage over at most ~1.7 GB
// of activations, above the ~295 FLOP/byte ridge). What bounds it in
// practice is how long the tensor cores wait on the serial steps of a block:
// the copies of each K chunk, the barriers, the epilogues. The design:
// - Whole-P register tiles on wgmma (wgmma_tile.cuh), as in
//   fused_bottleneck.cu: a block of 8 warps (two warpgroups) owns an (image,
//   tile of TH rows); each warpgroup keeps MT m64 tiles x NWG columns of f32
//   accumulators (MT x NWG = 256) for a whole K loop. A reaches wgmma from
//   registers through ldmatrix (one row address per lane); B from shared
//   memory in the 128-byte-swizzle layout.
// - TMA for every copy, into a ring of NSTAGE slots guarded by mbarriers
//   (tma.cuh). Each slot has a full barrier (thread 0 arms it with the
//   slot's bytes and issues the boxes) and an empty barrier (each of the 8
//   warps arrives once its wgmma has retired the chunk). Thread 0 refills
//   the slot of the previous chunk after waiting on its empty barrier, and
//   does so while the tensor cores run its warpgroup's product, so its
//   serial work stays off the warpgroup's path; no block barrier per chunk.
//   One K-chunk stream (32 deep) runs through all three phases, so the next
//   phase's weights land during an epilogue.
//   * B: 3-D maps over w1 (C, P), w2 as (9P, P), w3 (P, C), each viewed as
//     (64 columns, K rows, N / 64 column groups), 128-byte swizzle: one box
//     of (64, 32, NB / 64) is a whole chunk in exactly wgmma's canonical
//     layout (b_chunk_offset); one copy a chunk instead of NB / 64 (which
//     measured slower at P = 256).
//   * Phase 1's A: a 4-D map over x (C, W, H, N), box (32 channels, W
//     columns, R rows) at (k0, 0, row, n), R whole image rows a row tile
//     (R W <= BM), from the tile's top halo row h0 - 1. TMA zero-fills the
//     rows that lie off the image, so no padded copy of x and no off-image
//     case in the copy. The box is 64-byte swizzled (rows of 64 bytes,
//     conflict-free ldmatrix with the same XOR on the row addresses). The
//     box holds no pad columns: a box of W + 2 columns would fit only 8
//     rows of the halo'd tile in BM at TH = 7 (W = 56, 28, 14), so each
//     block would stream phase 1 twice.
//   * Phase 3's residual: per column pass, boxes (64 channels, W, TH rows)
//     of x into the ring's A region (idle after phase 1), waited on by the
//     epilogue, which adds it in place; TMA stores the tile out (rows off
//     the image dropped by the store). With two buffers (NRES = 2, where
//     they fit) the next pass's residual loads during this pass; a buffer is
//     reloaded once the store of the pass before has read it.
// - A in place. y1 lives on a "wide" grid of (TH + 2) x (W + 2) rows, zero
//   on its pad columns (written once per block) and on halo rows off the
//   image; phase 1's epilogue puts image row hr, column c at wide row hr
//   (W + 2) + c + 1. The conv's and phase 3's output rows are compact (TH x
//   W); tap (dy, dx) of output pixel (r, c) is y1 wide row (r + dy)(W+2) +
//   c + dx, so the conv reads y1 shifted by a tap with no im2col and no junk
//   columns. Rows past the tile's last are clamped to a real row and never
//   stored. The loop keeps its ring slots and the conv's tap as counters: no
//   integer division on a chunk's path.
// - The halo trap: a zero-filled x row still gives relu(b1) != 0, so phase
//   1's epilogue writes 0 for the halo rows off the image.
// - Without a block barrier per chunk, the phases are ordered by explicit
//   ones: before phase 2 reads y1, before y2 overlays y1, before phase 3
//   reads y2, and before each phase-3 tile is stored.
// The wrapper's plan (experimental/fused_bottleneck_tiled.py::
// plan_bottleneck_tiled) picks TH, WN, R, NSTAGE, NRES and the overlay,
// with TH W <= BM (phases 2-3 are one row tile) and R W <= BM; `Layout`
// below and the plan's `tiled_layout_bytes` must agree, which the wrapper
// checks at every launch. One block per SM (up to 255 registers a thread,
// 227 KB).
//
// Probes (off in the library build; experimental/fused_bottleneck_probe.py
// --kernel tiled builds each as a separate library and times it):
// TMR_PROBE_NO_B skips the weight copies, TMR_PROBE_NO_MMA the wgmma,
// TMR_PROBE_NO_EPILOGUE the epilogues' arithmetic and stores (results are
// then wrong); TMR_PROBE_TRACE has thread 0 of each block stamp
// %globaltimer at its start, after its prologue, at the first chunk of each
// phase and at its end, into tmr_probe_trace.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tma.cuh"
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
namespace fbt {

typedef __nv_bfloat16 bf16;

constexpr int THREADS = 256, WARPS = 8, KC = 32;

__host__ __device__ constexpr int round_1k(int bytes) {
  return (bytes + 1023) & ~1023;
}

// Dynamic shared memory, byte offsets from a 1 KB aligned base: the ring's
// A parts (NSTAGE x a_stage: phase 1's x box, R W rows of 64 bytes;
// phase 3's residual tiles, NRES buffers of NB / 64 boxes of res_box, over
// them), its B parts (NSTAGE x KC x NB in wgmma's canonical layout), y1
// ((TH+2)(W+2) rows of P + 8), y2 (TH W rows of P + 8, or over y1), the
// barriers (full and empty per slot, the residual's), 1 KB of alignment
// slack.
struct Layout {
  int a_stage, res_box, b_region, b_stage, y1, y2, bars, total;
  __host__ __device__ Layout(int W, int P, int TH, int WN, int R, int nstage,
                             int nres, int overlay) {
    const int nb = 64 * WN, ldy = P + 8;
    a_stage = round_1k(R * W * KC * 2);
    res_box = round_1k(TH * W * 128);
    const int res = nres * nb / 64 * res_box;
    b_region = nstage * a_stage > res ? nstage * a_stage : res;
    b_stage = KC * nb * 2;
    y1 = b_region + nstage * b_stage;
    const int y1_bytes = (TH + 2) * (W + 2) * ldy * 2;
    y2 = overlay ? y1 : y1 + y1_bytes;
    bars = y1 + y1_bytes + (overlay ? 0 : TH * W * ldy * 2);
    total = bars + (2 * nstage + 2) * 8 + 1024;
  }
};

__device__ __forceinline__ unsigned pack_bf16x2(float a, float b) {
  __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<unsigned*>(&h);
}

// Where the chunk stream is: phase (0, 1, 2), phase-1 row tile, column
// pass, K chunk. Phases 2 and 3 are one row tile.
struct Cursor {
  int ph, mt, np, kc;
};

template <int WN>
__global__ void __launch_bounds__(THREADS, 1)
fused_bottleneck_tiled_kernel(const __grid_constant__ CUtensorMap mx,
                              const __grid_constant__ CUtensorMap mres,
                              const __grid_constant__ CUtensorMap mout,
                              const __grid_constant__ CUtensorMap mw1,
                              const __grid_constant__ CUtensorMap mw2,
                              const __grid_constant__ CUtensorMap mw3,
                              const float* __restrict__ b1,
                              const float* __restrict__ b2,
                              const float* __restrict__ b3, int H, int W,
                              int C, int P, int TH, int R, int nstage,
                              int nres, int overlay) {
  using namespace wgmma;
  using namespace tma;
  TMR_PROBE_STAMP(0);
  // Block tile (512 / WN) x NB; warpgroup g holds MT m64 tiles x NWG
  // columns of it (MT * NWG = 256, 128 accumulators a thread): side by side
  // at NB = 512 (WGN = 2), else one above the other.
  constexpr int NB = 64 * WN;
  constexpr int WGN = WN == 8 ? 2 : 1, NWG = NB / WGN, MT = 256 / NWG;
  constexpr int NJ = NWG / 8;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  // swizzled boxes (TMA) and B's swizzle atoms need 1 KB alignment
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const unsigned s0 = smem_addr(smem);
  const Layout L(W, P, TH, WN, R, nstage, nres, overlay);
  bf16* y1 = reinterpret_cast<bf16*>(smem + L.y1);
  bf16* y2 = reinterpret_cast<bf16*>(smem + L.y2);
  const unsigned full0 = s0 + L.bars, empty0 = full0 + 8 * nstage;
  const unsigned resbar0 = empty0 + 8 * nstage;  // one per residual buffer
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2, wq = warp & 3;  // warpgroup, warp within it
  const int wg_row0 = WGN == 2 ? 0 : wg * 64 * MT;
  const int wg_col0 = WGN == 2 ? wg * NWG : 0;
  const int W2 = W + 2, LDY = P + 8;
  const int h0 = blockIdx.x * TH, img = blockIdx.y;
  const int th = min(TH, H - h0);  // rows of this tile
  // phase 1's rows (the halo'd tile), output rows, GEMM rows of one
  // phase-1 box, box rows stored by phase 3 (those off the image are
  // dropped by the store)
  const int M1 = (th + 2) * W, M2 = th * W, RW = R * W, MR = TH * W;

  // the tensor maps, by address (kernel parameters; the lambdas below use
  // these pointers)
  const CUtensorMap *px = &mx, *pres = &mres, *pout = &mout;
  const CUtensorMap *pw1 = &mw1, *pw2 = &mw2, *pw3 = &mw3;
  if (tid == 0) {
    for (int s = 0; s < nstage; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, WARPS);
    }
    mbar_init(resbar0, 1);
    mbar_init(resbar0 + 8, 1);
    mbar_init_fence();
    prefetch_map(mx);
    prefetch_map(mw1);
    prefetch_map(mw2);
    prefetch_map(mw3);
  }

  // The chunk stream: phase 1's row tiles x column passes x K chunks, then
  // phase 2's and phase 3's column passes x K chunks.
  const int nt1 = (th + 2 + R - 1) / R;
  const int nk0 = C / KC, nk1 = 9 * P / KC, nk2 = P / KC;
  const int np01 = P / NB, np2 = C / NB;
  const int total = nt1 * np01 * nk0 + np01 * nk1 + np2 * nk2;
  auto nk_of = [&](int ph) { return ph == 0 ? nk0 : ph == 1 ? nk1 : nk2; };
  auto advance = [&](Cursor& c) {
    if (++c.kc < nk_of(c.ph)) return;
    c.kc = 0;
    if (++c.np < (c.ph == 2 ? np2 : np01)) return;
    c.np = 0;
    if (c.ph == 0 && ++c.mt < nt1) return;
    c.mt = 0;
    ++c.ph;
  };

  // Thread 0: arm slot st's full barrier with the chunk's bytes and issue
  // its boxes: B's (64 columns x KC rows x NB / 64 column groups, 4 KB a
  // group, as b_chunk_offset lays them) and, in phase 1, x's.
  auto issue = [&](const Cursor& c, int st) {
    const unsigned bar = full0 + 8 * st;
    unsigned bytes = c.ph == 0 ? RW * KC * 2 : 0;
#ifndef TMR_PROBE_NO_B
    bytes += KC * NB * 2;
#endif
    mbar_arrive_expect_tx(bar, bytes);
    const int k0 = c.kc * KC, n0 = c.np * NB;
#ifndef TMR_PROBE_NO_B
    const CUtensorMap& mw = *(c.ph == 0 ? pw1 : c.ph == 1 ? pw2 : pw3);
    load_3d(s0 + L.b_region + st * L.b_stage, mw, bar, 0, k0, n0 / 64);
#endif
    if (c.ph == 0)
      load_4d(s0 + st * L.a_stage, *px, bar, k0, 0, h0 - 1 + c.mt * R, img);
  };
  // Thread 0's side of the ring: slot st_prod's (round)th fill waits until
  // the 8 warps have released its previous chunk.
  Cursor prod{0, 0, 0, 0};
  int st_prod = 0;
  unsigned prod_round = 0;
  auto produce = [&]() {
    if (prod_round > 0) mbar_wait(empty0 + 8 * st_prod, (prod_round - 1) & 1);
    issue(prod, st_prod);
    advance(prod);
    if (++st_prod == nstage) {
      st_prod = 0;
      ++prod_round;
    }
  };

  // This lane's A row for m64 tile t (its warp's 16 rows of it): phase 1, a
  // byte offset into the slot's box (rows past the box clamped to its last);
  // phases 2-3, an element offset into y1's wide grid or y2 (rows past the
  // tile clamped to its last).
  int aoff[MT];
  auto set_rows = [&](const Cursor& c) {
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int r = wg_row0 + 64 * i + 16 * wq + (lane & 15);
      if (c.ph == 0) {
        aoff[i] = min(r, RW - 1) * (KC * 2);
      } else {
        const int m = min(r, M2 - 1);
        const int rr = m / W;
        aoff[i] = c.ph == 1 ? (rr * W2 + m - rr * W) * LDY : m * LDY;
      }
    }
  };

  float acc[MT][NWG / 2];
  // One chunk: ldmatrix A, wgmma, retire the group before A's registers or
  // the accumulators are touched again. koff: the chunk's A column in y1
  // (tap and channel, kept by the loop) or y2. `meanwhile` runs while the
  // tensor cores work on the chunk (thread 0 refills the ring there, so its
  // serial work is off the warpgroup's path).
  auto multiply = [&](const Cursor& c, int st, int koff, auto meanwhile) {
    unsigned a[KC / 16][MT][4];
    if (c.ph == 0) {
      // the box's rows are 64 bytes; 64-byte swizzle: 16-byte piece p of
      // row m sits at piece p ^ ((m / 2) % 4)
      const unsigned base = s0 + st * L.a_stage;
#pragma unroll
      for (int kk = 0; kk < KC / 16; ++kk)
#pragma unroll
        for (int t = 0; t < MT; ++t) {
          const unsigned row = aoff[t];
          const unsigned piece = (2 * kk + (lane >> 4)) ^ ((row >> 7) & 3);
          ldsm_x4(a[kk][t], base + row + (piece << 4));
        }
    } else {
      const unsigned a0 =
          smem_addr(c.ph == 1 ? y1 : y2) + (koff + (lane >> 4) * 8) * 2;
#pragma unroll
      for (int kk = 0; kk < KC / 16; ++kk)
#pragma unroll
        for (int t = 0; t < MT; ++t) ldsm_x4(a[kk][t], a0 + (aoff[t] + 16 * kk) * 2);
    }
    const unsigned b0 = s0 + L.b_region + st * L.b_stage;
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
    meanwhile();
    __syncwarp();  // thread 0's warp converges before the aligned wait
    wgmma_wait<0>();
    fence_operand(reinterpret_cast<unsigned(&)[KC / 16 * MT * 4]>(a));
#pragma unroll
    for (int t = 0; t < MT; ++t) fence_operand(acc[t]);
  };

  // Epilogues from registers: lane holds rows 16 wq + lane / 4 (+ 8) of
  // each m64 tile and column pairs 8 j + 2 (lane % 4) of its warpgroup's
  // columns (wgmma_tile.cuh); bias pairs loaded once per run of 8 columns.
  auto epilogue = [&](const Cursor& c) {
    const int rl = wg_row0 + 16 * wq + (lane >> 2);  // + 64 t + 8 hf
    const int cl = wg_col0 + (lane & 3) * 2;         // + 8 j, in the pass
    const int col0 = c.np * NB + cl;
    const float* bias = c.ph == 0 ? b1 : c.ph == 1 ? b2 : b3;
    if (c.ph == 2) {
      // out = relu(. + b3 + x) in place over the pass's residual tile (NB /
      // 64 boxes of MR rows x 128 bytes, 128-byte swizzle; buffer np %
      // nres), then TMA stores
      const int buf = nres == 2 ? c.np & 1 : 0;
      mbar_wait(resbar0 + 8 * buf, (nres == 2 ? c.np >> 1 : c.np) & 1);
      unsigned char* rt = smem + buf * WN * L.res_box;
#ifndef TMR_PROBE_NO_EPILOGUE
#pragma unroll
      for (int jb = 0; jb < NJ; jb += 8) {
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const float2 bq =
              __ldg(reinterpret_cast<const float2*>(bias + col0 + 8 * (jb + q)));
          const int cc = cl + 8 * (jb + q);
#pragma unroll
          for (int t = 0; t < MT; ++t)
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
              const int m = rl + 64 * t + 8 * hf;
              if (m >= MR) continue;
              __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(
                  rt + (cc >> 6) * L.res_box + m * 128 +
                  ((((cc >> 3) & 7) ^ (m & 7)) << 4) + (cc & 7) * 2);
              const float2 r = __bfloat1622float2(*p);
              *p = __floats2bfloat162_rn(
                  fmaxf(acc[t][4 * (jb + q) + 2 * hf] + bq.x + r.x, 0.0f),
                  fmaxf(acc[t][4 * (jb + q) + 2 * hf + 1] + bq.y + r.y, 0.0f));
            }
        }
      }
#endif
      fence_async_shared();
      __syncthreads();  // the whole tile is written
#ifndef TMR_PROBE_NO_EPILOGUE
      if (tid == 0) {
#pragma unroll
        for (int j = 0; j < WN; ++j)
          store_4d(*pout, smem_addr(rt) + j * L.res_box, c.np * NB + 64 * j, 0,
                   h0, img);
        store_commit();
      }
#endif
      return;
    }
    if (c.ph == 1 && overlay) __syncthreads();  // every warp is done with y1
#ifndef TMR_PROBE_NO_EPILOGUE
#pragma unroll
    for (int jb = 0; jb < NJ; jb += 8) {
      float2 bj[8];
#pragma unroll
      for (int q = 0; q < 8; ++q)
        bj[q] = __ldg(reinterpret_cast<const float2*>(bias + col0 + 8 * (jb + q)));
#pragma unroll
      for (int t = 0; t < MT; ++t)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int m = rl + 64 * t + 8 * hf;
          bool keep = true;  // phase 1: the wide position lies on the image
          bf16* dst;
          if (c.ph == 0) {  // y1 = relu(. + b1) on the wide grid, 0 off the image
            const int mc = c.mt * RW + m;
            if (m >= RW || mc >= M1) continue;
            const int hr = mc / W, h = h0 - 1 + hr;
            keep = h >= 0 && h < H;
            dst = y1 + (size_t)(mc + 2 * hr + 1) * LDY + col0 + 8 * jb;
          } else {  // y2 = relu(. + b2)
            if (m >= M2) continue;
            dst = y2 + (size_t)m * LDY + col0 + 8 * jb;
          }
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            const float v0 = acc[t][4 * (jb + q) + 2 * hf] + bj[q].x;
            const float v1 = acc[t][4 * (jb + q) + 2 * hf + 1] + bj[q].y;
            *reinterpret_cast<unsigned*>(dst + 8 * q) =
                keep ? pack_bf16x2(fmaxf(v0, 0.0f), fmaxf(v1, 0.0f)) : 0u;
          }
        }
    }
#endif
  };

  // the first chunks are in flight while the block zeroes y1's pad columns
  if (tid == 0)
    for (int s = 0; s < nstage - 1 && s < total; ++s) produce();
  // y1's pad columns (0 and W + 1 of each wide row): the conv's zeros. The
  // barrier below shows them and the initialised mbarriers to every thread.
  const int p8 = P / 8;
  for (int v = tid; v < (th + 2) * 2 * p8; v += THREADS) {
    const int e = v / p8, row = (e >> 1) * W2 + (e & 1) * (W + 1);
    *reinterpret_cast<uint4*>(&y1[(size_t)row * LDY + (v - e * p8) * 8]) =
        make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();
  TMR_PROBE_STAMP(1);
  Cursor cons{0, 0, 0, 0};
  int st_cons = 0;
  unsigned cons_round = 0;
  int ci = 0, tapoff = 0, dx = 0;  // phase 2: channel, tap offset, tap column
  for (int g = 0; g < total; ++g) {
    if (cons.kc == 0 && cons.np == 0 && cons.mt == 0 && cons.ph > 0)
      __syncthreads();  // y1 (phase 2) or y2 (phase 3) is complete
    mbar_wait(full0 + 8 * st_cons, cons_round & 1);  // chunk g landed
    if (cons.kc == 0) {  // the first chunk's wgmma sets acc
      set_rows(cons);
      ci = tapoff = dx = 0;
      if (cons.mt == 0 && cons.np == 0) TMR_PROBE_STAMP(2 + cons.ph);
    }
    multiply(cons, st_cons, cons.ph == 1 ? tapoff + ci : cons.kc * KC, [&]() {
      if (tid != 0) return;
      // chunk g + nstage - 1 into the slot of chunk g - 1
      if (g + nstage - 1 < total) produce();
      if (cons.ph == 2 && cons.kc == 0) {
        // residual tiles, over the ring's A parts (idle since phase 1):
        // pass np's first chunk loads pass np + nres - 1's (pass 0's, the
        // first nres) into the buffer whose stores (pass np - 1's) have
        // read it
        if (cons.np > 0) store_wait_read();
        const int q1 = min(cons.np + nres, np2);
        for (int q = cons.np > 0 ? cons.np + nres - 1 : 0; q < q1; ++q) {
          const int buf = nres == 2 ? q & 1 : 0;
          const unsigned bar = resbar0 + 8 * buf;
          mbar_arrive_expect_tx(bar, WN * MR * 128);
#pragma unroll
          for (int j = 0; j < WN; ++j)
            load_4d(s0 + (buf * WN + j) * L.res_box, *pres, bar, q * NB + 64 * j,
                    0, h0, img);
        }
      }
    });
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * st_cons);  // the slot is free
    if (++st_cons == nstage) {
      st_cons = 0;
      ++cons_round;
    }
    if (cons.kc == nk_of(cons.ph) - 1) epilogue(cons);
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
  if (tid == 0) store_wait_read();  // the stores have read shared memory
  TMR_PROBE_STAMP(5);
}

template <int WN>
int launch(const CUtensorMap (&maps)[6], const void* b1, const void* b2,
           const void* b3, int N, int H, int W, int C, int P, int TH, int R,
           int nstage, int nres, int overlay, int smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      fused_bottleneck_tiled_kernel<WN>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((H + TH - 1) / TH, N);
  fused_bottleneck_tiled_kernel<WN><<<grid, THREADS, smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], maps[5], (const float*)b1,
      (const float*)b2, (const float*)b3, H, W, C, P, TH, R, nstage, nres,
      overlay);
  return (int)cudaGetLastError();
}

}  // namespace fbt
}  // namespace tmr

// Shared memory one block needs under a plan (TH rows, WN warps across N,
// R image rows a phase-1 box, NSTAGE ring slots, NRES residual buffers, y2
// over y1 or not).
extern "C" int tmr_fused_bottleneck_tiled_smem(int W, int P, int TH, int WN,
                                               int R, int nstage, int nres,
                                               int overlay) {
  return tmr::fbt::Layout(W, P, TH, WN, R, nstage, nres, overlay).total;
}

// x, out: (N, H, W, C) bf16 NHWC-contiguous; w1: (C, P), w2: (3, 3, P, P),
// w3: (P, C) bf16 contiguous; b1, b2: (P,), b3: (C,) f32; every pointer 16
// byte aligned. P and C multiples of 64 WN; WN in {1, 2, 4, 8}; nstage >=
// 3; nres in {1, 2}; TH W <= BM = 512 / WN; R W <= BM; TH, R, W <= 256 (a
// TMA box's sides); overlay only where P == 64 WN. Returns
// cudaErrorInvalidValue for a plan outside those, 100000 + the driver's
// CUresult where a tensor map does not encode, else cudaGetLastError().
extern "C" int tmr_fused_bottleneck_tiled(const void* x, const void* w1,
                                          const void* b1, const void* w2,
                                          const void* b2, const void* w3,
                                          const void* b3, void* out, int N,
                                          int H, int W, int C, int P, int TH,
                                          int WN, int R, int nstage, int nres,
                                          int overlay, void* stream) {
  using namespace tmr::fbt;
  const int nb = 64 * WN, bm = 64 * (WARPS / (WN < 1 ? 1 : WN));
  const int smem =
      tmr_fused_bottleneck_tiled_smem(W, P, TH, WN, R, nstage, nres, overlay);
  const void* ptrs[5] = {x, w1, w2, w3, out};
  bool aligned = true;
  for (const void* p : ptrs) aligned &= reinterpret_cast<uintptr_t>(p) % 16 == 0;
  if ((WN != 1 && WN != 2 && WN != 4 && WN != 8) || P % nb || C % nb ||
      nstage < 3 || nres < 1 || nres > 2 || TH < 1 || TH > 256 || R < 1 ||
      R > 256 || W > 256 || TH * W > bm || R * W > bm || smem > 232448 ||
      (overlay && P != nb) || !aligned)
    return (int)cudaErrorInvalidValue;
  using tmr::tma::encode_bf16;
  const uint64_t xd[4] = {(uint64_t)C, (uint64_t)W, (uint64_t)H, (uint64_t)N};
  const uint64_t xs[3] = {(uint64_t)C, (uint64_t)W * C, (uint64_t)H * W * C};
  const uint32_t box_x[4] = {KC, (uint32_t)W, (uint32_t)R, 1};
  const uint32_t box_res[4] = {64, (uint32_t)W, (uint32_t)TH, 1};
  // the weights as (64 columns, K rows, N / 64 column groups): one box of
  // (64, KC, WN) is a whole chunk, its column groups 4 KB apart
  const uint32_t box_w[3] = {64, KC, (uint32_t)WN};
  const uint64_t d1[3] = {64, (uint64_t)C, (uint64_t)P / 64};
  const uint64_t d2[3] = {64, 9ull * P, (uint64_t)P / 64};
  const uint64_t d3[3] = {64, (uint64_t)P, (uint64_t)C / 64};
  const uint64_t sp[2] = {(uint64_t)P, 64}, sc[2] = {(uint64_t)C, 64};
  CUtensorMap maps[6];
  const int errs[6] = {
      encode_bf16(&maps[0], x, 4, xd, xs, box_x, CU_TENSOR_MAP_SWIZZLE_64B),
      encode_bf16(&maps[1], x, 4, xd, xs, box_res, CU_TENSOR_MAP_SWIZZLE_128B),
      encode_bf16(&maps[2], out, 4, xd, xs, box_res, CU_TENSOR_MAP_SWIZZLE_128B),
      encode_bf16(&maps[3], w1, 3, d1, sp, box_w, CU_TENSOR_MAP_SWIZZLE_128B),
      encode_bf16(&maps[4], w2, 3, d2, sp, box_w, CU_TENSOR_MAP_SWIZZLE_128B),
      encode_bf16(&maps[5], w3, 3, d3, sc, box_w, CU_TENSOR_MAP_SWIZZLE_128B)};
  for (int e : errs)
    if (e != 0) return 100000 + e;
  cudaStream_t s = (cudaStream_t)stream;
  switch (WN) {
    case 1:
      return launch<1>(maps, b1, b2, b3, N, H, W, C, P, TH, R, nstage, nres,
                       overlay, smem, s);
    case 2:
      return launch<2>(maps, b1, b2, b3, N, H, W, C, P, TH, R, nstage, nres,
                       overlay, smem, s);
    case 4:
      return launch<4>(maps, b1, b2, b3, N, H, W, C, P, TH, R, nstage, nres,
                       overlay, smem, s);
    default:
      return launch<8>(maps, b1, b2, b3, N, H, W, C, P, TH, R, nstage, nres,
                       overlay, smem, s);
  }
}
