// The f32 BN-folded stride-1 identity bottleneck block, NHWC, shared by
// fused_bottleneck_f32.cu and fused_bottleneck_tiled_f32.cu:
//   out = relu(x + W3 . relu(conv3x3(y1) + b2) + b3),  y1 = relu(W1 . x + b1)
// with y1 and y2 kept in f32, as the TPU kernels keep them in x's dtype.
// Products and sums are f32 on the FFMA units (fmaf): no TF32 tensor cores,
// which would round the operands to 10 bits of mantissa (this path exists to
// match the CPU's and JAX's f32).
//
// One block of 256 threads owns an (image, tile of TH rows), as the TPU
// kernels' grid steps own an image's rows: its y1 (the tile plus a 1-row
// halo) and its y2 stay in shared memory, x comes in once per phase-1 row
// and the output goes out once.
// - Three GEMMs in turn, each walked in block tiles of BM x BN (BM = 8 TY,
//   BN = 8 TX, TX x TY = 256 threads): phase 1 over the (in-image) rows of
//   the tile and its halo, (rows) x C times C x P; phase 2 over the tile's
//   rows, the 3x3 conv as 9 taps of P, (rows) x 9P times 9P x P; phase 3,
//   (rows) x P times P x C, plus b3 and the residual.
// - A thread owns TM x TN = 8 x 8 outputs: rows ty + TY i, columns 4 tx ..
//   4 tx + 3 and BN / 2 + 4 tx .. + 3. Warps are 4 x 8 threads, so a warp's
//   A loads hit 4 rows (pitches of 4 mod 32 words keep them in distinct
//   banks) and its B loads one 128-byte line; both as float4, four K steps
//   of A a load.
// - K runs in chunks of KC = 16 through a ring of NSTAGE slots filled by
//   cp.async (16 bytes a thread): the weights' KC x BN rows and, in phase
//   1, x's BM x KC rows (off-tile rows zero-filled). The next NSTAGE - 1
//   chunks are in flight while one is multiplied; the ring drains at the
//   end of each block tile.
// - y1 is compact, (TH + 2) W rows of P + 4 floats, tile row r + 1 holding
//   image row h0 + r, plus one zero row. Tap (dy, dx) of output pixel (r, c)
//   reads y1 row (r + dy) W + c + dx - 1, or the zero row where c + dx - 1
//   falls off the image: the conv's column padding is one address choice per
//   row and tap, outside the channel loop.
// - The halo trap: y1 off the image is the conv's zero padding, not
//   relu(b1). Phase 1 computes only the image's rows; the halo rows off the
//   image are zeroed at the block's start, never computed.
// - y2 has its own TH W rows of P + 4; phase 3 reads it as A.
// Rows past a tile's last are clamped to a real row (or zero-filled) and
// never stored.
#pragma once

#include <cuda_runtime.h>

#include "block_gemm_async.cuh"

namespace tmr {
namespace fbf {

constexpr int THREADS = 256, TM = 8, TN = 8, KC = 16;
constexpr int LDA = KC + 4;  // floats between staged x rows: 4 rows, 4 banks

__host__ __device__ constexpr int bn_of(int tx) { return 8 * tx; }
__host__ __device__ constexpr int bm_of(int tx) { return 8 * (THREADS / tx); }

// Dynamic shared memory, offsets in floats: NSTAGE ring slots (an A part of
// BM x LDA, phase 1's x rows, then a B part of KC x BN), y1 ((TH + 2) W rows
// of LDY = P + 4), the zero row, y2 (TH W rows of LDY); `total` in bytes.
// The plan's `f32_layout_bytes` computes the same; the wrappers check it.
struct Layout {
  int ldy, a_stage, slot, y1, zero, y2, total;
  __host__ __device__ Layout(int W, int P, int TH, int TX, int nstage) {
    ldy = P + 4;
    a_stage = bm_of(TX) * LDA;
    slot = a_stage + KC * bn_of(TX);
    y1 = nstage * slot;
    zero = y1 + (TH + 2) * W * ldy;
    y2 = zero + ldy;
    total = (y2 + TH * W * ldy) * 4;
  }
};

struct Args {
  const float *x, *w1, *b1, *w2, *b2, *w3, *b3;
  float* out;
  int H, W, C, P, TH;
};

// acc[i][j] += sum over the chunk's KC steps k of A[row i][koff + k] *
// B[k][column j]; row i of A starts at sm + aoff[i], B's chunk at sm + boff.
template <int TX>
__device__ __forceinline__ void mma_chunk(float (&acc)[TM][TN],
                                          const float* sm,
                                          const int (&aoff)[TM], int koff,
                                          int boff, int tx) {
  constexpr int BN = bn_of(TX);
  const float* b = sm + boff + 4 * tx;
#pragma unroll
  for (int kq = 0; kq < KC; kq += 4) {
    float4 av[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i)
      av[i] = *reinterpret_cast<const float4*>(sm + aoff[i] + koff + kq);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float4 b0 = *reinterpret_cast<const float4*>(b + (kq + kk) * BN);
      const float4 b1 =
          *reinterpret_cast<const float4*>(b + (kq + kk) * BN + BN / 2);
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

// KC rows k0 .. of a row-major weight matrix (ldw columns), columns n0 ..
// n0 + BN - 1, into dst (KC x BN).
template <int BN>
__device__ __forceinline__ void copy_b(float* dst, const float* w, int ldw,
                                       int k0, int n0, int tid) {
#pragma unroll
  for (int j = 0; j < KC * BN / 4 / THREADS; ++j) {
    const int e = tid + j * THREADS, r = e / (BN / 4), q = e % (BN / 4);
    cp_async16(dst + r * BN + 4 * q, w + (size_t)(k0 + r) * ldw + n0 + 4 * q,
               true);
  }
}

// One block tile's K loop over nk chunks through the ring: issue(c, slot)
// starts chunk c's copies, compute(c, slot) multiplies it. Every thread
// commits one group an iteration (empty past the last chunk), so the wait
// counts line up; the ring is idle and every thread past its last compute
// on return.
template <int NSTAGE, class Issue, class Compute>
__device__ __forceinline__ void pipeline(int nk, Issue issue,
                                         Compute compute) {
#pragma unroll
  for (int s = 0; s < NSTAGE - 1; ++s) {
    if (s < nk) issue(s, s);
    cp_async_commit();
  }
  int slot = 0, next = NSTAGE - 1;
  for (int c = 0; c < nk; ++c) {
    cp_async_wait<NSTAGE - 2>();
    __syncthreads();  // chunk c landed for all; slot `next` is free
    if (c + NSTAGE - 1 < nk) issue(c + NSTAGE - 1, next);
    cp_async_commit();
    compute(c, slot);
    slot = slot + 1 == NSTAGE ? 0 : slot + 1;
    next = next + 1 == NSTAGE ? 0 : next + 1;
  }
  cp_async_wait<0>();
  __syncthreads();
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

// The whole block. STAGED_RES: phase 3's residual tile of x is copied into
// shared memory (over y1, dead by then) with the pass's chunk NSTAGE - 1,
// so the copy overlaps the pass's products, and the epilogue reads it there
// (this needs the tile's rows in one block tile, rows W <= BM); else the
// epilogue reads it from device memory.
template <int TX, int NSTAGE, bool STAGED_RES>
__device__ __forceinline__ void bottleneck_block(const Args& a) {
  constexpr int BN = bn_of(TX), TY = THREADS / TX, BM = bm_of(TX);
  extern __shared__ __align__(16) float sm[];
  const int W = a.W, C = a.C, P = a.P, H = a.H;
  const Layout L(W, P, a.TH, TX, NSTAGE);
  const int ldy = L.ldy;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ty = (warp / (TX / 8)) * 4 + (lane >> 3);
  const int tx = (warp % (TX / 8)) * 8 + (lane & 7);
  const int h0 = blockIdx.x * a.TH, rows = min(a.TH, H - h0);
  const int lo = max(h0 - 1, 0), hi = min(h0 + rows + 1, H);
  const int M1 = (hi - lo) * W, M2 = rows * W;
  const int row1 = (lo - (h0 - 1)) * W;  // y1 row of phase 1's first row
  const size_t img = (size_t)blockIdx.y * H * W;  // the image's first pixel
  const float* xin = a.x + (img + (size_t)lo * W) * C;   // phase 1's rows
  const size_t tile = (img + (size_t)h0 * W) * C;         // the tile's x, out

  // the conv's zero padding: halo rows off the image, the zero row
  auto zero_rows = [&](int r0, int n) {
    float4* d = reinterpret_cast<float4*>(sm + L.y1 + r0 * ldy);
    for (int e = tid; e < n * ldy / 4; e += THREADS)
      d[e] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  };
  if (h0 == 0) zero_rows(0, W);
  if (h0 + rows == H) zero_rows((rows + 1) * W, W);
  zero_rows((a.TH + 2) * W, 1);

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

  // ---- phase 1: y1 = relu(x W1 + b1) over the image's rows of the tile
  // and its halo
  for (int m0 = 0; m0 < M1; m0 += BM) {
#pragma unroll
    for (int i = 0; i < TM; ++i) aoff[i] = (ty + TY * i) * LDA;
    for (int n0 = 0; n0 < P; n0 += BN) {
      clear();
      pipeline<NSTAGE>(
          C / KC,
          [&](int c, int s) {
            float* base = sm + s * L.slot;
            constexpr int NA = 4 * BM;  // float4s of a BM x KC chunk
#pragma unroll
            for (int j = 0; j < (NA + THREADS - 1) / THREADS; ++j) {
              const int e = tid + j * THREADS;
              if (NA % THREADS == 0 || e < NA) {
                const int r = e >> 2, q = e & 3, m = m0 + r;
                const bool in = m < M1;
                cp_async16(base + r * LDA + 4 * q,
                           xin + (size_t)(in ? m : 0) * C + c * KC + 4 * q,
                           in);
              }
            }
            copy_b<BN>(base + L.a_stage, a.w1, P, c * KC, n0, tid);
          },
          [&](int, int s) {
            mma_chunk<TX>(acc, sm, aoff, s * L.slot, s * L.slot + L.a_stage,
                          tx);
          });
      const float4 c0 = *reinterpret_cast<const float4*>(a.b1 + n0 + col0);
      const float4 c1 = *reinterpret_cast<const float4*>(a.b1 + n0 + col1);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int r = m0 + ty + TY * i;
        if (r < M1) {
          float* d = sm + L.y1 + (row1 + r) * ldy + n0;
          *reinterpret_cast<float4*>(d + col0) = bias_relu<0>(acc[i], c0, zero4);
          *reinterpret_cast<float4*>(d + col1) =
              bias_relu<4>(acc[i], c1, zero4);
        }
      }
    }
  }

  // ---- phase 2: y2 = relu(conv3x3(y1) + b2), 9 taps of P channels each
  for (int m0 = 0; m0 < M2; m0 += BM) {
    int ro[TM], co[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int m = min(m0 + ty + TY * i, M2 - 1);
      ro[i] = m / W;
      co[i] = m - ro[i] * W;
    }
    for (int n0 = 0; n0 < P; n0 += BN) {
      clear();
      int tap = 0, kk = 0;
      pipeline<NSTAGE>(
          9 * (P / KC),
          [&](int c, int s) {
            copy_b<BN>(sm + s * L.slot + L.a_stage, a.w2, P, c * KC, n0, tid);
          },
          [&](int, int s) {
            if (kk == 0) {
              const int dy = tap / 3, dx = tap - 3 * dy;
#pragma unroll
              for (int i = 0; i < TM; ++i) {
                const int col = co[i] + dx - 1;
                aoff[i] = (col >= 0 && col < W)
                              ? L.y1 + ((ro[i] + dy) * W + col) * ldy
                              : L.zero;
              }
            }
            mma_chunk<TX>(acc, sm, aoff, kk, s * L.slot + L.a_stage, tx);
            kk += KC;
            if (kk == P) {
              kk = 0;
              ++tap;
            }
          });
      const float4 c0 = *reinterpret_cast<const float4*>(a.b2 + n0 + col0);
      const float4 c1 = *reinterpret_cast<const float4*>(a.b2 + n0 + col1);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int r = m0 + ty + TY * i;
        if (r < M2) {
          float* d = sm + L.y2 + r * ldy + n0;
          *reinterpret_cast<float4*>(d + col0) = bias_relu<0>(acc[i], c0, zero4);
          *reinterpret_cast<float4*>(d + col1) =
              bias_relu<4>(acc[i], c1, zero4);
        }
      }
    }
  }

  // ---- phase 3: out = relu(y2 W3 + b3 + x), C in passes of BN
  constexpr int LDR = BN + 4;  // the staged residual's row pitch
  for (int m0 = 0; m0 < M2; m0 += BM) {
#pragma unroll
    for (int i = 0; i < TM; ++i)
      aoff[i] = L.y2 + min(m0 + ty + TY * i, M2 - 1) * ldy;
    for (int n0 = 0; n0 < C; n0 += BN) {
      clear();
      pipeline<NSTAGE>(
          P / KC,
          [&](int c, int s) {
            copy_b<BN>(sm + s * L.slot + L.a_stage, a.w3, C, c * KC, n0, tid);
            if (STAGED_RES && c == NSTAGE - 1) {
              for (int e = tid; e < M2 * (BN / 4); e += THREADS) {
                const int r = e / (BN / 4), q = e % (BN / 4);
                cp_async16(sm + L.y1 + r * LDR + 4 * q,
                           a.x + tile + (size_t)r * C + n0 + 4 * q, true);
              }
            }
          },
          [&](int c, int s) {
            mma_chunk<TX>(acc, sm, aoff, c * KC, s * L.slot + L.a_stage, tx);
          });
      const float4 c0 = *reinterpret_cast<const float4*>(a.b3 + n0 + col0);
      const float4 c1 = *reinterpret_cast<const float4*>(a.b3 + n0 + col1);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int r = m0 + ty + TY * i;
        if (r < M2) {
          float4 r0, r1;
          if (STAGED_RES) {
            const float* s = sm + L.y1 + r * LDR;
            r0 = *reinterpret_cast<const float4*>(s + col0);
            r1 = *reinterpret_cast<const float4*>(s + col1);
          } else {
            const float* s = a.x + tile + (size_t)r * C + n0;
            r0 = __ldg(reinterpret_cast<const float4*>(s + col0));
            r1 = __ldg(reinterpret_cast<const float4*>(s + col1));
          }
          float* d = a.out + tile + (size_t)r * C + n0;
          *reinterpret_cast<float4*>(d + col0) = bias_relu<0>(acc[i], c0, r0);
          *reinterpret_cast<float4*>(d + col1) = bias_relu<4>(acc[i], c1, r1);
        }
      }
    }
  }
}

// The checks both entries make of a call; 0 where the kernel takes it.
inline int check_call(int N, int H, int W, int C, int P, int TH, int TX,
                      int nstage, bool one_tile) {
  if (TX != 8 && TX != 16 && TX != 32 && TX != 64) return 1;
  if (N < 1 || N > 65535 || H < 1 || W < 1 || TH < 1 || TH > H) return 1;
  if (P % bn_of(TX) || C % bn_of(TX) || P % 64 || C % 64) return 1;
  if (one_tile && TH * W > bm_of(TX)) return 1;
  if (Layout(W, P, TH, TX, nstage).total > 232448) return 1;
  return 0;
}

}  // namespace fbf
}  // namespace tmr
