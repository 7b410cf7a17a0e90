// TimeConv in f32 on Hopper: out = max(x, causal2max(x), conv3(x)+b3,
// conv5(x)+b5, conv7(x)+b7), SAME 1-D convolutions along the window axis
// of x (B, W, C), per sequence; the causal branch is max(x[t], x[t-1])
// with x[-1] = 0. f32 in and out, f32 products and sums on the FFMA units:
// no TF32 tensor cores, which would round the inputs to 10 bits of
// mantissa (this path exists to match the CPU's f32).
//
// A column slice (tensor parallelism, tmrnet_torch/parallel/tensor.py), as
// csrc/time_conv.cu takes it: weights (k, Cin, Cout) and biases (Cout,) of
// the output channels c0 .. c0 + Cout over all Cin input channels; the
// identity and causal branches read x's channels c0 + n; the output is
// (B, W, Cout). The whole width is the slice c0 = 0, Cout = Cin.
//
// Replaces the Pallas TPU kernel tmrnet_tpu/ops/time_conv.py::time_conv_fused
// (:76-97, pallas_call at :82) for f32 operands; csrc/time_conv.cu is its
// bf16 counterpart on the tensor cores.
//
// Bound on the H100: operations. At the main path's shapes (B clips, W =
// 30, C = 512) a row of B W does 2 * 512 * 512 * 15 = 7.9 MFLOP against 4
// KB of x and output, far above the ~20 FLOP/byte where the card's 67
// TFLOP/s of f32 FFMA meets its 3.35 TB/s. The design is a plain
// register-tiled product, simple first:
// - A block of 256 threads owns BM = 64 rows of M = B W by BN = 64 output
//   columns; a thread owns TM x TN = 4 x 4 outputs (rows ty + 16 i,
//   columns 4 tx .. 4 tx + 3) in three accumulators, one a branch.
// - A loop over K chunks of KC = 16 input channels. For each, the block
//   stages in shared memory the 15 taps' weights of its 64 columns (15 x
//   16 x 64 f32) and its x rows m0 - 3 .. m0 + BM + 2 (zero off [0, M)),
//   rows LDX = 20 floats apart so that two rows' loads fall in distinct
//   banks.
// - Tap offset d of a thread's row reads staged row r + 3 + d, or a zero
//   row where the source position t + d falls outside [0, W) of the row's
//   own sequence: the per-sequence SAME padding is one address choice per
//   row and tap, outside the channel loop.
// - After the last chunk the thread takes max(x, max(x[t], x[t-1]), acc_k
//   + b_k) in the flax module's nesting (any nesting gives the same value;
//   a NaN propagates as torch.maximum's does) and writes its 4 x 4 tile.
// The wrapper (ops/time_conv.py::plan_time_conv_f32) computes the grid and
// `SMEM`, which `tmr_time_conv_f32_smem` reports and the wrapper checks.
#include <cuda_runtime.h>

namespace tmr {
namespace tcf {

constexpr int THREADS = 256, BM = 64, BN = 64, TM = 4, TN = 4, KC = 16;
constexpr int HALO = 3, TAPS = 3 + 5 + 7;
constexpr int XROWS = BM + 2 * HALO;  // staged x rows of a block
constexpr int LDX = KC + 4;           // floats between staged rows
constexpr int ZROW = XROWS;           // the zero row, after the staged rows
constexpr int W_FLOATS = TAPS * KC * BN;
constexpr int X_FLOATS = (XROWS + 1) * LDX;
constexpr int SMEM = (W_FLOATS + X_FLOATS) * 4;

static_assert(THREADS == (BM / TM) * (BN / TN), "a thread a 4 x 4 tile");
static_assert(THREADS == KC * (BN / 4), "a weight chunk's row a thread");

// max that propagates a NaN in either operand, as torch.maximum does
__device__ __forceinline__ float vmax(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// One branch of K taps over the staged chunk: acc[i][j] += sum over the
// chunk's channels c and taps of x[row_i + d, c] w[tap, c, col_j].
template <int K>
__device__ __forceinline__ void branch(float (&acc)[TM][TN], const float* xs,
                                       const float* ws, const int (&t)[TM],
                                       const bool (&live)[TM], int ty, int tx,
                                       int W) {
#pragma unroll 1
  for (int j = 0; j < K; ++j) {
    const int d = j - K / 2;
    int off[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int s = t[i] + d;
      off[i] = (live[i] && s >= 0 && s < W) ? (ty + 16 * i + HALO + d) * LDX
                                            : ZROW * LDX;
    }
    const float* wj = ws + j * KC * BN + tx * TN;
#pragma unroll
    for (int c = 0; c < KC; ++c) {
      const float4 b = *reinterpret_cast<const float4*>(wj + c * BN);
      float a[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = xs[off[i] + c];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        acc[i][0] = fmaf(a[i], b.x, acc[i][0]);
        acc[i][1] = fmaf(a[i], b.y, acc[i][1]);
        acc[i][2] = fmaf(a[i], b.z, acc[i][2]);
        acc[i][3] = fmaf(a[i], b.w, acc[i][3]);
      }
    }
  }
}

__global__ void __launch_bounds__(THREADS, 2)
time_conv_f32_kernel(const float* __restrict__ x, const float* __restrict__ w3,
                     const float* __restrict__ w5,
                     const float* __restrict__ w7,
                     const float* __restrict__ b3,
                     const float* __restrict__ b5,
                     const float* __restrict__ b7, float* __restrict__ out,
                     int M, int W, int C, int Cout, int c0) {
  extern __shared__ __align__(16) float smem[];
  float* ws = smem;             // [TAPS][KC][BN]
  float* xs = smem + W_FLOATS;  // [XROWS + 1][LDX]
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;

  int t[TM];
  bool live[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty + 16 * i;
    live[i] = m < M;
    t[i] = m % W;
  }
  if (tid < LDX) xs[ZROW * LDX + tid] = 0.0f;

  float a3[TM][TN], a5[TM][TN], a7[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) a3[i][j] = a5[i][j] = a7[i][j] = 0.0f;

  // this thread's float4 of every tap's weight chunk: channel row wc of
  // the chunk, columns n0 + 4 wq .. + 3
  const int wc = tid / (BN / 4), wq = tid % (BN / 4);
  const size_t tap = (size_t)C * Cout;
  for (int cc = 0; cc < C; cc += KC) {
    __syncthreads();  // every thread is done with the previous chunk
    const size_t wrow = (size_t)(cc + wc) * Cout + n0 + 4 * wq;
#pragma unroll
    for (int j = 0; j < TAPS; ++j) {
      const float* wk = j < 3 ? w3 + j * tap
                              : (j < 8 ? w5 + (j - 3) * tap : w7 + (j - 8) * tap);
      const float4 v = __ldg(reinterpret_cast<const float4*>(wk + wrow));
      *reinterpret_cast<float4*>(ws + (j * KC + wc) * BN + 4 * wq) = v;
    }
    for (int e = tid; e < XROWS * (KC / 4); e += THREADS) {
      const int r = e / (KC / 4), q = e % (KC / 4);
      const long long gm = (long long)m0 - HALO + r;
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (gm >= 0 && gm < M)
        v = __ldg(reinterpret_cast<const float4*>(x + gm * C + cc + 4 * q));
      *reinterpret_cast<float4*>(xs + r * LDX + 4 * q) = v;
    }
    __syncthreads();
    branch<3>(a3, xs, ws, t, live, ty, tx, W);
    branch<5>(a5, xs, ws + 3 * KC * BN, t, live, ty, tx, W);
    branch<7>(a7, xs, ws + 8 * KC * BN, t, live, ty, tx, W);
  }

  const int n = n0 + 4 * tx;
  const float4 c3 = __ldg(reinterpret_cast<const float4*>(b3 + n));
  const float4 c5 = __ldg(reinterpret_cast<const float4*>(b5 + n));
  const float4 c7 = __ldg(reinterpret_cast<const float4*>(b7 + n));
  const float bias3[TN] = {c3.x, c3.y, c3.z, c3.w};
  const float bias5[TN] = {c5.x, c5.y, c5.z, c5.w};
  const float bias7[TN] = {c7.x, c7.y, c7.z, c7.w};
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    if (!live[i]) continue;
    const long long m = m0 + ty + 16 * i;
    const float4 xv4 = __ldg(reinterpret_cast<const float4*>(x + m * C + c0 + n));
    float4 xp4 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (t[i] > 0)
      xp4 = __ldg(reinterpret_cast<const float4*>(x + (m - 1) * C + c0 + n));
    const float xv[TN] = {xv4.x, xv4.y, xv4.z, xv4.w};
    const float xp[TN] = {xp4.x, xp4.y, xp4.z, xp4.w};
    float o[TN];
#pragma unroll
    for (int j = 0; j < TN; ++j)
      o[j] = vmax(vmax(vmax(xv[j], a3[i][j] + bias3[j]),
                       vmax(a5[i][j] + bias5[j], a7[i][j] + bias7[j])),
                  vmax(xv[j], xp[j]));
    *reinterpret_cast<float4*>(out + m * Cout + n) =
        make_float4(o[0], o[1], o[2], o[3]);
  }
}

}  // namespace tcf
}  // namespace tmr

// Shared memory one block needs (the plan has no other choice).
extern "C" int tmr_time_conv_f32_smem() { return tmr::tcf::SMEM; }

// x: (B, W, C) f32; w3/w5/w7: (k, C, Cout) f32 (flax layout, contiguous);
// b3/b5/b7: (Cout,) f32; out: (B, W, Cout) f32, the output channels c0 ..
// c0 + Cout (Cout = C, c0 = 0: the whole width); all 16-byte aligned. C,
// Cout and c0 multiples of 64, c0 + Cout <= C; B W C < 2^31. Returns
// cudaErrorInvalidValue for shapes outside those, else cudaGetLastError().
extern "C" int tmr_time_conv_f32(const void* x, const void* w3, const void* w5,
                                 const void* w7, const void* b3,
                                 const void* b5, const void* b7, void* out,
                                 int B, int W, int C, int Cout, int c0,
                                 void* stream) {
  using namespace tmr::tcf;
  const long long M = (long long)B * W;
  if (B < 1 || W < 1 || C < BN || C % BN || M * C > 0x7fffffff ||
      Cout < BN || Cout % BN || c0 < 0 || c0 % BN || c0 + Cout > C)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      time_conv_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)((M + BM - 1) / BM), Cout / BN);
  time_conv_f32_kernel<<<grid, THREADS, SMEM, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)w3, (const float*)w5, (const float*)w7,
      (const float*)b3, (const float*)b5, (const float*)b7, (float*)out,
      (int)M, W, C, Cout, c0);
  return (int)cudaGetLastError();
}
