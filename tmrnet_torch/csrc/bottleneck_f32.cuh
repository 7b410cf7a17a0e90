// The f32 BN-folded stride-1 identity bottleneck block, NHWC, the body of
// fused_bottleneck_f32.cu's kernel (both f32 bottleneck wrappers launch it):
//   out = relu(x + W3 . relu(conv3x3(y1) + b2) + b3),  y1 = relu(W1 . x + b1)
// with y1 and y2 kept in f32, as the TPU kernels keep them in x's dtype.
// Products and sums are f32 on the FFMA units (fmaf): no TF32 tensor cores,
// which would round the operands to 10 bits of mantissa (this path exists to
// match the CPU's and JAX's f32).
//
// The cut: the N H W pixels, in NHWC order, fall into spans of `span`
// consecutive pixels, one span a cluster of CS CTAs (2, 4 or 8) on
// neighbouring SMs. CTA i of a cluster over pixels [u0, u1) owns the
// output pixels [u0 + i (u1 - u0) / CS, u0 + (i + 1) (u1 - u0) / CS)
// (floors), at most M = ceil(span / CS) <= BM: one CTA tile of output rows
// in phases 2 and 3. A span may cross image boundaries; where it is whole
// images, nothing of y1 lies outside it.
// - y1 is needed on the span's pixels and their 3x3 neighbours in the same
//   image: R = [u0 - W - 1, u1 + W + 1) cut at the images of u0 and u1 - 1.
//   R is split evenly over the cluster: CTA i computes y1 on the slice
//   [r0 + i |R| / CS, r0 + (i + 1) |R| / CS) in phase 1 (one tile of at
//   most BM rows), so the only y1 computed twice is R's part outside the
//   span, at the cluster's edges inside an image.
// - CTA i keeps y1 in a window of M + 2 (W + 1) rows of P + 4 floats,
//   window row 0 holding pixel own_begin - W - 1. Its slice lies inside its
//   window (a slice boundary is within W + 1 of the own boundary of the same
//   index), and so does every neighbour of its own pixels. After phase 1 a
//   cluster barrier; then each CTA copies the rest of its window that R
//   holds from the other CTAs' windows through DSMEM (ld.shared::cluster),
//   so phase 2's loop reads its own shared memory only.
// - The halo trap: y1 off the image is the conv's zero padding, not
//   relu(b1). A tap whose pixel lies off the image (a row above or below
//   it, a column left or right of it, or another image's pixel next in
//   NHWC order) reads the zero row instead; window rows off R are never
//   written and never read, and x's rows past a slice (other pixels, or
//   the TMA box's zero fill past N H W) are computed but never stored.
// - Three GEMMs in turn, each walked in CTA tiles of BM x BN (BM = 8 TY,
//   BN = 8 TX, TX x TY = 256 threads): phase 1 the slice's rows x C times
//   C x P; phase 2 the own rows, the 3x3 conv as 9 taps of P, x 9P times
//   9P x P; phase 3 the own rows x P times P x C, plus b3 and the residual.
// - A thread owns TM x TN = 8 x 8 outputs: rows ty + TY i, columns 4 tx ..
//   4 tx + 3 and BN / 2 + 4 tx .. + 3. Warps are 4 x 8 threads, so a
//   warp's B loads are one 128-byte line, as float4, four K steps of A a
//   load.
// - K runs in chunks of KC = 16 through one ring of NSTAGE (3 or 4) slots
//   that runs on across column passes and phases: a slot is an A part (BM
//   x KC of x, phase 1) and a B part (KC x BN of a weight, as two halves of
//   KC x BN / 2, each a TMA box). Every CTA of the cluster walks the same
//   chunks in the same order. Each CTA's producer issues the copies: its
//   CTA's x box, and KC / CS rows of the weight chunk multicast into
//   every CTA's slot (cp.async.bulk.tensor .multicast::cluster), so a
//   chunk leaves L2 once a cluster. Each slot has a full mbarrier (its
//   CTA's producer arrives once, expecting the whole slot's bytes from
//   all CS issuers) and an empty one (8 warps x CS CTAs arrive, each warp
//   on every CTA's, when it has read the slot); a producer refills a slot
//   once its own empty barrier says every CTA has freed it. No block
//   barrier inside the K loop.
// - y2 has M rows of P + 4 after y1's window, or over y1 where phase 2 is
//   one column pass (`overlay`). Phase 3 reads its residual from a copy
//   of the pass's x tile in shared memory over y1, made by cp.async while
//   the pass runs (`staged`, where the plan finds room), else from device
//   memory.
// - DSMEM lifetime: a cluster barrier's arrive follows each CTA's copy,
//   its wait precedes the first write over y1 (phase 2's last epilogue),
//   and a full cluster barrier precedes exit, after the last arrival on
//   another CTA's empty barrier.
// - A CTA without own pixels (the last cluster's, where its span is short)
//   walks every chunk, takes part in every barrier and stores nothing.
// - The producer is a ninth warp whose lane 0 only issues: a consumer
//   warp that issued between its own chunks stalled every CTA of the
//   cluster whenever it was late, since each chunk waits on every CTA's
//   share. Nine warps put three on one SM scheduler, so a thread gets at
//   most 168 registers (read -Xptxas -v for spills after an edit).
// The probe build (experimental/fused_bottleneck_f32_probe.py),
// -DTMR_PROBE_F32_STATS, sums clock64() spans over the launch (the
// consumers' waits on full barriers, each phase's end) into `f32_stats`.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "block_gemm_async.cuh"
#include "tma.cuh"

namespace tmr {
namespace fbf {

#ifdef TMR_PROBE_F32_STATS
// sums over the launch: [0] cycles consumer warps waited on full barriers,
// [2] CTA cycles (thread 0), [3] CTAs, [4..6] thread 0's cycles at phase
// 1's end, the halo copy's end, phase 2's end
__device__ unsigned long long f32_stats[8];
#define TMR_STAT(i, v) atomicAdd(&f32_stats[i], (unsigned long long)(v))
#else
#define TMR_STAT(i, v)
#endif

// THREADS consumer threads (8 warps) and one producer warp a CTA
constexpr int THREADS = 256, WARPS = 8, CTA_THREADS = THREADS + 32;
constexpr int TM = 8, TN = 8, KC = 16;
constexpr int ALIGN = 128;  // bytes: TMA boxes land at 128-byte offsets

__host__ __device__ constexpr int bn_of(int tx) { return 8 * tx; }
__host__ __device__ constexpr int bm_of(int tx) { return 8 * (THREADS / tx); }

// Dynamic shared memory from its 128-byte aligned start, offsets in floats:
// NSTAGE ring slots (an A part of BM x KC, then a B part of KC x BN), y1's
// window (M + 2 (W + 1) rows of LDY = P + 4), the zero row, y2 (M rows of
// LDY, or over y1), then the 2 NSTAGE mbarriers; `res` is the staged
// residual's first float (over y1, after y2 where y2 is over y1); `total`
// in bytes, with ALIGN of slack. The plan's `f32_layout` computes the same;
// the wrappers check it.
struct Layout {
  int ldy, y1_rows, a_part, slot, y1, zero, y2, res, bars, total;
  __host__ __device__ Layout(int W, int P, int TX, int M, int nstage,
                             bool overlay) {
    ldy = P + 4;
    y1_rows = M + 2 * (W + 1);
    a_part = bm_of(TX) * KC;
    slot = a_part + KC * bn_of(TX);
    y1 = nstage * slot;
    zero = y1 + y1_rows * ldy;
    y2 = overlay ? y1 : zero + ldy;
    res = overlay ? y1 + M * ldy : y1;
    bars = overlay ? zero + ldy : y2 + M * ldy;
    total = ALIGN + bars * 4 + 16 * nstage;
  }
  // the staged residual (M rows of BN + 4) fits before the zero row
  __host__ __device__ bool stage_fits(int TX, int M) const {
    return res + M * (bn_of(TX) + 4) <= zero;
  }
};

struct Args {
  const float *x, *b1, *b2, *b3;
  float* out;
  int H, W, C, P;
  int npix;  // N H W
  int span;  // pixels a cluster
  int cs, nstage, overlay, staged;
};

__host__ __device__ inline int rows_of(int span, int cs) {
  return (span + cs - 1) / cs;
}

// acc[i][j] += sum over the chunk's KC steps k of A[row i][k] * B[k][col
// j]: A's row i at sm + aoff[i] + koff, B's chunk at sm + boff as two
// halves of KC x BN / 2.
template <int TX>
__device__ __forceinline__ void mma_chunk(float (&acc)[TM][TN],
                                          const float* sm,
                                          const int (&aoff)[TM], int koff,
                                          int boff, int tx) {
  constexpr int HALF = bn_of(TX) / 2;
  const float* b = sm + boff + 4 * tx;
#pragma unroll
  for (int kq = 0; kq < KC; kq += 4) {
    float4 av[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i)
      av[i] = *reinterpret_cast<const float4*>(sm + aoff[i] + koff + kq);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float4 b0 = *reinterpret_cast<const float4*>(b + (kq + kk) * HALF);
      const float4 b1 =
          *reinterpret_cast<const float4*>(b + (KC + kq + kk) * HALF);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float a = kk == 0   ? av[i].x
                        : kk == 1 ? av[i].y
                        : kk == 2 ? av[i].z
                                  : av[i].w;
        acc[i][0] = fmaf(a, b0.x, acc[i][0]);
        acc[i][1] = fmaf(a, b0.y, acc[i][1]);
        acc[i][2] = fmaf(a, b0.z, acc[i][2]);
        acc[i][3] = fmaf(a, b0.w, acc[i][3]);
        acc[i][4] = fmaf(a, b1.x, acc[i][4]);
        acc[i][5] = fmaf(a, b1.y, acc[i][5]);
        acc[i][6] = fmaf(a, b1.z, acc[i][6]);
        acc[i][7] = fmaf(a, b1.w, acc[i][7]);
      }
    }
  }
}

// A block barrier of the consumer warps only (named barrier 1).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(THREADS) : "memory");
}

// relu(acc[J .. J + 3] + b + r)
template <int J>
__device__ __forceinline__ float4 bias_relu(const float (&acc)[TN], float4 b,
                                            float4 r) {
  return make_float4(fmaxf(acc[J] + b.x + r.x, 0.0f),
                     fmaxf(acc[J + 1] + b.y + r.y, 0.0f),
                     fmaxf(acc[J + 2] + b.z + r.z, 0.0f),
                     fmaxf(acc[J + 3] + b.w + r.w, 0.0f));
}

// The cut of cluster `cl`: own pixels and y1 slices, boundaries of rank i
// at own(i), slice(i), i = 0 .. CS.
struct Cut {
  int u0, nu, r0, nr, cs;
  __device__ Cut(const Args& a, int cl) : cs(a.cs) {
    const int HW = a.H * a.W;
    u0 = cl * a.span;
    nu = min(a.span, a.npix - u0);
    const int last = u0 + nu - 1;
    r0 = max(u0 - a.W - 1, u0 - u0 % HW);
    nr = min(u0 + nu + a.W + 1, last - last % HW + HW) - r0;
  }
  __device__ int own(int i) const { return u0 + i * nu / cs; }
  __device__ int slice(int i) const { return r0 + i * nr / cs; }
};

// The whole block, one CTA of a cluster. Maps: x as (C, N H W) with boxes
// of KC x BM; w1 (P, C), w2 (P, 9P), w3 (C, P) with boxes of BN / 2 x KC /
// CS (innermost first).
template <int TX>
__device__ __forceinline__ void bottleneck_block(const CUtensorMap& mx,
                                                 const CUtensorMap& mw1,
                                                 const CUtensorMap& mw2,
                                                 const CUtensorMap& mw3,
                                                 const Args& a) {
  constexpr int BN = bn_of(TX), TY = THREADS / TX, BM = bm_of(TX);
  constexpr int HALF = BN / 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const unsigned raw = static_cast<unsigned>(__cvta_generic_to_shared(smem_raw));
  const unsigned base = (raw + ALIGN - 1) & ~unsigned(ALIGN - 1);
  float* sm = reinterpret_cast<float*>(smem_raw + (base - raw));
  const int W = a.W, C = a.C, P = a.P, CS = a.cs, NS = a.nstage;
  const int M = rows_of(a.span, CS);
  const Layout L(W, P, TX, M, NS, a.overlay);
  const int ldy = L.ldy;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ty = (warp / (TX / 8)) * 4 + (lane >> 3);
  const int tx = (warp % (TX / 8)) * 8 + (lane & 7);
  const unsigned rank = tma::cluster_rank();
  const Cut cut(a, blockIdx.x / CS);
  const int o0 = cut.own(rank), own = cut.own(rank + 1) - o0;
  const int s0 = cut.slice(rank), slice = cut.slice(rank + 1) - s0;
  const int win = o0 - W - 1;  // the pixel of y1's window row 0
  const unsigned bars = base + 4 * L.bars;
  // a slot's mbarriers: full (its bytes landed), empty (every CTA's
  // consumer warps read it)
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (NS + s); };
  if (tid == 0) {
    for (int s = 0; s < NS; ++s) {
      tma::mbar_init(full(s), 1);
      tma::mbar_init(empty(s), WARPS * CS);
    }
    tma::mbar_init_fence();
  }
  for (int e = tid; e < ldy / 4; e += CTA_THREADS)
    reinterpret_cast<float4*>(sm + L.zero)[e] =
        make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  // every CTA's barriers are initialised before any multicast or remote
  // arrival reaches them
  tma::cluster_arrive();
  tma::cluster_wait();

  // The chunks, in order: phase 1's P / BN passes x C / KC, phase 2's
  // P / BN passes x 9 taps x P / KC, phase 3's C / BN passes x P / KC.
  const int kc1 = C / KC, kc2 = 9 * P / KC, kc3 = P / KC;
  const int n1 = (P / BN) * kc1;
  const int total = n1 + (P / BN) * kc2 + (C / BN) * kc3;

  if (warp == WARPS) {
    // ---- the producer warp: lane 0 issues every chunk in order, each
    // into its slot once the slot's empty barrier says every CTA's
    // consumers read the slot's last chunk. Its cluster barriers: it
    // writes no y1, so it arrives at the halo barrier at once and waits
    // for it once phase 2's first chunks are out (they need only phase
    // 1's slots); the barrier after the halo copy, in between.
    tma::cluster_arrive();
    const unsigned short mask = (unsigned short)((1u << CS) - 1);
    const int share = KC / CS;  // weight rows this CTA multicasts a chunk
    const int sync_at = min(total, n1 + NS);
    int ph = 0, k = 0, col = 0, s = 0;
    unsigned parity = 0;
    for (int n = 0; n < total; ++n) {
      if (lane == 0) {
        if (n == 0) {
          tma::prefetch_map(mx);
          tma::prefetch_map(mw1);
          tma::prefetch_map(mw2);
          tma::prefetch_map(mw3);
        }
        tma::mbar_wait(empty(s), parity ^ 1);
        const CUtensorMap& m = ph == 0 ? mw1 : ph == 1 ? mw2 : mw3;
        const unsigned dst = base + 4 * s * L.slot, bar = full(s);
        tma::mbar_arrive_expect_tx(bar,
                                   4 * (KC * BN + (ph == 0 ? L.a_part : 0)));
        if (ph == 0) tma::load_2d(dst, mx, bar, k * KC, s0);
        const int row = k * KC + (int)rank * share;
        const unsigned b = dst + 4 * (L.a_part + (int)rank * share * HALF);
        tma::load_2d_multicast(b, m, bar, col, row, mask);
        tma::load_2d_multicast(b + 4 * KC * HALF, m, bar, col + HALF, row,
                               mask);
      }
      if (++s == NS) s = 0, parity ^= 1;
      if (++k == (ph == 0 ? kc1 : ph == 1 ? kc2 : kc3)) {
        k = 0;
        col += BN;
        if (col == (ph == 2 ? C : P)) col = 0, ++ph;
      }
      if (n + 1 == sync_at) {
        tma::cluster_wait();     // the halo barrier
        tma::cluster_arrive();   // the barrier after the halo copy
      }
    }
    tma::cluster_wait();
    tma::cluster_arrive();       // the exit barrier
    tma::cluster_wait();
    return;
  }

  // ---- the consumer warps: chunks consumed, the next one's slot and round
  // parity
  int cslot = 0;
  unsigned cparity = 0;
#ifdef TMR_PROBE_F32_STATS
  long long t_wait = 0;
  const long long t_start = clock64();
#endif
  auto wait_chunk = [&]() {
#ifdef TMR_PROBE_F32_STATS
    const long long t0 = clock64();
    tma::mbar_wait(full(cslot), cparity);
    t_wait += clock64() - t0;
#else
    tma::mbar_wait(full(cslot), cparity);
#endif
    return cslot;
  };
  // This warp has read slot s (every value it loaded from the slot went
  // into its products before this point): one arrival on every CTA's empty
  // barrier of the slot.
  auto release = [&](int s) {
    __syncwarp();
    if (lane < CS) tma::mbar_arrive_remote(empty(s), lane);
    if (++cslot == NS) cslot = 0, cparity ^= 1;
  };

  float acc[TM][TN];
  auto clear = [&]() {
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;
  };
  const int col0 = 4 * tx, col1 = BN / 2 + 4 * tx;
  const float4 zero4 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  int aoff[TM];

  // ---- phase 1: y1 = relu(x W1 + b1) over the slice
#pragma unroll
  for (int i = 0; i < TM; ++i) aoff[i] = (ty + TY * i) * KC;
  for (int n0 = 0; n0 < P; n0 += BN) {
    clear();
    for (int k = 0; k < kc1; ++k) {
      const int s = wait_chunk();
      mma_chunk<TX>(acc, sm, aoff, s * L.slot, s * L.slot + L.a_part, tx);
      release(s);
    }
    const float4 c0 = *reinterpret_cast<const float4*>(a.b1 + n0 + col0);
    const float4 c1 = *reinterpret_cast<const float4*>(a.b1 + n0 + col1);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int r = ty + TY * i;
      if (r < slice) {
        float* d = sm + L.y1 + (s0 + r - win) * ldy + n0;
        *reinterpret_cast<float4*>(d + col0) = bias_relu<0>(acc[i], c0, zero4);
        *reinterpret_cast<float4*>(d + col1) = bias_relu<4>(acc[i], c1, zero4);
      }
    }
  }

  // ---- the halo: the window's pixels in the other CTAs' slices, by DSMEM
  if (tid == 0) TMR_STAT(4, clock64() - t_start);
  tma::cluster_arrive();
  tma::cluster_wait();
  {
    const unsigned y1_at = base + 4 * L.y1;
    const int hi = o0 + own + W + 1, q4 = P / 4;
    for (int j = 0; j < CS; ++j) {
      if (j == (int)rank) continue;
      const int lo = max(cut.slice(j), win);
      const int n = min(cut.slice(j + 1), hi) - lo;
      if (n <= 0) continue;
      const int win_j = cut.own(j) - W - 1;
      const unsigned src =
          tma::map_rank(y1_at + 4 * (lo - win_j) * ldy, (unsigned)j);
      float* dst = sm + L.y1 + (lo - win) * ldy;
      for (int e = tid; e < n * q4; e += THREADS) {
        const int r = e / q4, q = e - r * q4;
        *reinterpret_cast<float4*>(dst + r * ldy + 4 * q) =
            tma::ld_cluster_f4(src + 4 * (r * ldy + 4 * q));
      }
    }
  }
  consumers_sync();
  if (tid == 0) TMR_STAT(5, clock64() - t_start);
  tma::cluster_arrive();  // done reading the other CTAs' y1

  // ---- phase 2: y2 = relu(conv3x3(y1) + b2), 9 taps of P channels each.
  // A row's window row and which of its neighbours lie on the image: bits
  // 0-3 above, below, left, right.
  int pk[TM];
  {
    const int HW = a.H * W;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int r = min(ty + TY * i, max(own - 1, 0));
      const int pos = (o0 + r) % HW, h = pos / W, w = pos - h * W;
      pk[i] = ((W + 1 + r) << 4) | (h > 0) | (h < a.H - 1) << 1 |
              (w > 0) << 2 | (w < W - 1) << 3;
    }
  }
  for (int n0 = 0; n0 < P; n0 += BN) {
    clear();
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap - 3 * dy;
      const int shift = (dy - 1) * W + dx - 1;
      const int need = (dy == 0) | (dy == 2) << 1 | (dx == 0) << 2 |
                       (dx == 2) << 3;
#pragma unroll
      for (int i = 0; i < TM; ++i)
        aoff[i] = (pk[i] & need) == need
                      ? L.y1 + ((pk[i] >> 4) + shift) * ldy
                      : L.zero;
      for (int kk = 0; kk < P; kk += KC) {
        const int s = wait_chunk();
        mma_chunk<TX>(acc, sm, aoff, kk, s * L.slot + L.a_part, tx);
        release(s);
      }
    }
    if (n0 + BN == P) {
      consumers_sync();      // this CTA's reads of y1 are done
      tma::cluster_wait();   // and every other CTA's reads of its y1
    }
    const float4 c0 = *reinterpret_cast<const float4*>(a.b2 + n0 + col0);
    const float4 c1 = *reinterpret_cast<const float4*>(a.b2 + n0 + col1);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int r = ty + TY * i;
      if (r < own) {
        float* d = sm + L.y2 + r * ldy + n0;
        *reinterpret_cast<float4*>(d + col0) = bias_relu<0>(acc[i], c0, zero4);
        *reinterpret_cast<float4*>(d + col1) = bias_relu<4>(acc[i], c1, zero4);
      }
    }
  }
  consumers_sync();  // y2 is whole
  if (tid == 0) TMR_STAT(6, clock64() - t_start);

  // ---- phase 3: out = relu(y2 W3 + b3 + x), C in passes of BN
  constexpr int LDR = BN + 4;  // the staged residual's row pitch
#pragma unroll
  for (int i = 0; i < TM; ++i)
    aoff[i] = L.y2 + min(ty + TY * i, max(own - 1, 0)) * ldy;
  const float* xo = a.x + (size_t)o0 * C;
  float* out = a.out + (size_t)o0 * C;
  for (int n0 = 0; n0 < C; n0 += BN) {
    if (a.staged) {
      consumers_sync();  // the last pass's epilogue has read its tile
      for (int e = tid; e < own * (BN / 4); e += THREADS) {
        const int r = e / (BN / 4), q = e % (BN / 4);
        cp_async16(sm + L.res + r * LDR + 4 * q,
                   xo + (size_t)r * C + n0 + 4 * q, true);
      }
      cp_async_commit();
    }
    clear();
    for (int k = 0; k < kc3; ++k) {
      const int s = wait_chunk();
      mma_chunk<TX>(acc, sm, aoff, k * KC, s * L.slot + L.a_part, tx);
      release(s);
    }
    if (a.staged) {
      cp_async_wait<0>();
      consumers_sync();
    }
    const float4 c0 = *reinterpret_cast<const float4*>(a.b3 + n0 + col0);
    const float4 c1 = *reinterpret_cast<const float4*>(a.b3 + n0 + col1);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int r = ty + TY * i;
      if (r < own) {
        float4 r0, r1;
        if (a.staged) {
          const float* s = sm + L.res + r * LDR;
          r0 = *reinterpret_cast<const float4*>(s + col0);
          r1 = *reinterpret_cast<const float4*>(s + col1);
        } else {
          const float* s = xo + (size_t)r * C + n0;
          r0 = __ldg(reinterpret_cast<const float4*>(s + col0));
          r1 = __ldg(reinterpret_cast<const float4*>(s + col1));
        }
        float* d = out + (size_t)r * C + n0;
        *reinterpret_cast<float4*>(d + col0) = bias_relu<0>(acc[i], c0, r0);
        *reinterpret_cast<float4*>(d + col1) = bias_relu<4>(acc[i], c1, r1);
      }
    }
  }
  // no CTA exits while another may still arrive on its barriers
  tma::cluster_arrive();
  tma::cluster_wait();
#ifdef TMR_PROBE_F32_STATS
  if (lane == 0) TMR_STAT(0, t_wait);
  if (tid == 0) {
    TMR_STAT(2, clock64() - t_start);
    TMR_STAT(3, 1);
  }
#endif
}

// The launch entry's checks of a call; 0 where the kernel takes it.
inline int check_call(int N, int H, int W, int C, int P, int TX, int span,
                      int cs, int nstage, int overlay, int staged) {
  if (TX != 8 && TX != 16 && TX != 32 && TX != 64) return 1;
  if (cs != 2 && cs != 4 && cs != 8) return 1;
  if (nstage != 3 && nstage != 4) return 1;
  if (N < 1 || H < 1 || W < 1 || span < 1) return 1;
  const long long npix = (long long)N * H * W;
  if (npix + span > 0x7fffffffLL) return 1;
  if (P % bn_of(TX) || C % bn_of(TX) || P % 64 || C % 64) return 1;
  if (overlay && P != bn_of(TX)) return 1;
  const int M = rows_of(span, cs);
  // a slice is at most one tile: R is the span, or the span and W + 1
  // pixels each side
  const long long r = span % (H * W) == 0 ? span : span + 2LL * (W + 1);
  if (M > bm_of(TX) || r > (long long)cs * bm_of(TX)) return 1;
  const Layout L(W, P, TX, M, nstage, overlay != 0);
  if (L.total > 232448 || (staged && !L.stage_fits(TX, M))) return 1;
  return 0;
}

// ---- host: the cluster launch

typedef void (*Kernel)(CUtensorMap, CUtensorMap, CUtensorMap, CUtensorMap,
                       Args);

inline cudaLaunchConfig_t cluster_config(int grid, int cs, int smem,
                                         cudaStream_t stream,
                                         cudaLaunchAttribute* attr) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cs;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(CTA_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// cudaOccupancyMaxActiveClusters of `kern` in clusters of cs CTAs of
// `smem` bytes, or minus the CUDA error.
inline int active_clusters(Kernel kern, int cs, int smem) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(cs, cs, smem, 0, &attr);
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, (const void*)kern, &cfg);
  return err != cudaSuccess ? -(int)err : n;
}

// Encode the four maps and launch ceil(N H W / span) clusters of a.cs.
// Returns 100000 + the driver's CUresult where a map does not encode, else
// the launch's CUDA error (cudaSuccess: 0).
inline int launch_cluster(Kernel kern, int TX, const void* x, const void* w1,
                          const void* w2, const void* w3, const Args& a,
                          cudaStream_t stream) {
  const uint64_t C = a.C, P = a.P;
  const uint32_t half = bn_of(TX) / 2, share = KC / a.cs;
  const uint64_t dx[2] = {C, (uint64_t)a.npix}, d1[2] = {P, C},
                 d2[2] = {P, 9 * P}, d3[2] = {C, P};
  const uint32_t box_x[2] = {KC, (uint32_t)bm_of(TX)}, box_w[2] = {half, share};
  CUtensorMap maps[4];
  const int errs[4] = {tma::encode_f32(&maps[0], x, 2, dx, &C, box_x),
                       tma::encode_f32(&maps[1], w1, 2, d1, &P, box_w),
                       tma::encode_f32(&maps[2], w2, 2, d2, &P, box_w),
                       tma::encode_f32(&maps[3], w3, 2, d3, &C, box_w)};
  for (int e : errs)
    if (e != 0) return 100000 + e;
  const int smem =
      Layout(a.W, a.P, TX, rows_of(a.span, a.cs), a.nstage, a.overlay != 0)
          .total;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int clusters = (a.npix + a.span - 1) / a.span;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      cluster_config(clusters * a.cs, a.cs, smem, stream, &attr);
  Args args = a;
  void* params[5] = {&maps[0], &maps[1], &maps[2], &maps[3], &args};
  err = cudaLaunchKernelExC(&cfg, (const void*)kern, params);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace fbf
}  // namespace tmr
