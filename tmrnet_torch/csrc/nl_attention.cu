// Non-local memory read on Hopper: out[b] = softmax(q[b] . k[b]^T / sqrt(F))
// . v[b], one query per row. q (B, F); k, v (B, W, F); bf16 or f32 in and
// out (q's dtype), f32 math.
//
// Replaces the Pallas TPU kernel tmrnet_tpu/ops/nl_attention.py::nl_attention
// (:39-64, pallas_call at :50).
//
// Bound on the H100: bytes. One query per row means 2 W F multiply-adds
// for (2 W + 1) F loaded values: at B = 32, W = 30, F = 512 it is ~2 MB of
// bf16 for ~2 MFLOP, far below the card's ridge, and no tensor-core work.
// At that size what a call costs is latency: one trip to device memory and
// the steps after it. The design:
// - One block of 256 threads per row. k[b] and v[b] are each one contiguous
//   run of W F elements. At the block's start one thread issues two 1-D
//   bulk copies (cp.async.bulk, tma.cuh) of them into shared memory, each
//   completing on its own mbarrier, so v's copy is in flight while the
//   logits and the softmax run.
// - Logits: warps take window positions in turn, four rows a pass so that
//   their reductions interleave; a lane reads 16 bytes of a k row at a time
//   against q (staged in shared memory as f32), and the warp reduces with
//   shuffles.
// - Softmax in f32 over the W logits, which stay in shared memory (each
//   warp reduces max and sum with shuffles); the (B, W) attention matrix
//   never reaches device memory.
// - Output: each thread owns groups of 4 columns and sums them over W.
// The wrapper (ops/nl_attention.py) refuses what the copies cannot take:
// F times the element size not a multiple of 16 bytes, operands off a
// 16-byte boundary, or k and v beyond a block's shared memory;
// `nl_attention_smem_bytes` there mirrors `Layout` below, checked against
// tmr_nl_attention_smem at every launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "tma.cuh"

namespace tmr {
namespace nla {

constexpr int THREADS = 256, WARPS = THREADS / 32, ROWS = 4;

// Dynamic shared memory, byte offsets: k (W F elements), v (the same), q
// as f32 (F), the logits, then the weights, as f32 (W, rounded up to 4),
// two mbarriers.
struct Layout {
  int kv_bytes, v, q, p, bars, total;
  __host__ __device__ Layout(int W, int F, int elt) {
    kv_bytes = W * F * elt;
    v = kv_bytes;
    q = 2 * kv_bytes;
    p = q + 4 * F;
    bars = p + 4 * ((W + 3) & ~3);
    total = bars + 16;
  }
};

// Four consecutive elements as f32 (8 bytes of bf16, 16 of f32).
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
  uint2 raw;
  raw.x = *reinterpret_cast<unsigned*>(&a);
  raw.y = *reinterpret_cast<unsigned*>(&b);
  *reinterpret_cast<uint2*>(p) = raw;
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
nl_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, T* __restrict__ out, int W, int F,
                    float scale) {
  using namespace tma;
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L(W, F, sizeof(T));
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t row = blockIdx.x;
  const unsigned bar_k = (unsigned)__cvta_generic_to_shared(smem + L.bars);
  const unsigned bar_v = bar_k + 8;
  if (tid == 0) {
    mbar_init(bar_k, 1);
    mbar_init(bar_v, 1);
    mbar_init_fence();
    const unsigned base = (unsigned)__cvta_generic_to_shared(smem);
    mbar_arrive_expect_tx(bar_k, L.kv_bytes);
    load_1d(base, k + row * W * F, L.kv_bytes, bar_k);
    mbar_arrive_expect_tx(bar_v, L.kv_bytes);
    load_1d(base + L.v, v + row * W * F, L.kv_bytes, bar_v);
  }
  float* qs = reinterpret_cast<float*>(smem + L.q);
  float* ps = reinterpret_cast<float*>(smem + L.p);
  for (int i = tid; i < F / 4; i += THREADS)
    reinterpret_cast<float4*>(qs)[i] = load4(q + row * F + 4 * i);
  __syncthreads();  // q staged; the barriers initialised

  // Logits: warp takes rows w0 + WARPS r (r < ROWS) at a time, so that
  // their loads and shuffle reductions interleave; a lane reads VEC
  // elements (16 bytes) of a k row at a time.
  constexpr int VEC = 16 / sizeof(T);
  const T* ks = reinterpret_cast<const T*>(smem);
  mbar_wait(bar_k, 0);
  for (int w0 = warp; w0 < W; w0 += ROWS * WARPS) {
    float s[ROWS] = {};
    for (int i = lane; i < F / VEC; i += 32) {
#pragma unroll
      for (int h = 0; h < VEC / 4; ++h) {
        const int f = i * VEC + 4 * h;
        const float4 qf = reinterpret_cast<const float4*>(qs)[f / 4];
#pragma unroll
        for (int r = 0; r < ROWS; ++r)
          if (w0 + WARPS * r < W)
            s[r] += dot4(load4(ks + (w0 + WARPS * r) * F + f), qf);
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
#pragma unroll
      for (int r = 0; r < ROWS; ++r) s[r] += __shfl_xor_sync(0xffffffffu, s[r], o);
    if (lane == 0)
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
        if (w0 + WARPS * r < W) ps[w0 + WARPS * r] = s[r] * scale;
  }
  __syncthreads();

  // Softmax over the window: every warp reduces the max and the sum over
  // all W with shuffles, then the weights overwrite the logits.
  float mx = -INFINITY;
  for (int w = lane; w < W; w += 32) mx = fmaxf(mx, ps[w]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  float sum = 0.0f;
  for (int w = lane; w < W; w += 32) sum += expf(ps[w] - mx);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
  __syncthreads();  // every warp has read the logits
  for (int w = tid; w < W; w += THREADS) ps[w] = expf(ps[w] - mx) / sum;
  __syncthreads();

  // Output: groups of 4 columns summed over the window.
  const T* vs = reinterpret_cast<const T*>(smem + L.v);
  mbar_wait(bar_v, 0);
  for (int i = tid; i < F / 4; i += THREADS) {
    float4 o = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int w = 0; w < W; ++w) {
      const float pw = ps[w];
      const float4 x = load4(vs + w * F + 4 * i);
      o.x += pw * x.x;
      o.y += pw * x.y;
      o.z += pw * x.z;
      o.w += pw * x.w;
    }
    store4(out + row * F + 4 * i, o);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int W, int F, int smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      nl_attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  nl_attention_kernel<T><<<B, THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, W, F,
      (float)(1.0 / sqrt((double)F)));
  return (int)cudaGetLastError();
}

}  // namespace nla
}  // namespace tmr

// Shared memory one block needs at window W, width F, elt bytes an element.
extern "C" int tmr_nl_attention_smem(int W, int F, int elt) {
  return tmr::nla::Layout(W, F, elt).total;
}

// q, out: (B, F); k, v: (B, W, F); bf16 (f32 == 0) or f32 (f32 != 0), all
// 16-byte aligned; F times the element size a multiple of 16 bytes.
// Returns cudaErrorInvalidValue for shapes outside those or beyond a
// block's shared memory, else cudaGetLastError().
extern "C" int tmr_nl_attention(const void* q, const void* k, const void* v,
                                void* out, int B, int W, int F, int f32,
                                void* stream) {
  const int elt = f32 ? 4 : 2;
  if (B < 1 || W < 1 || F < 1 || (long long)W * F * elt > 232448)
    return (int)cudaErrorInvalidValue;
  const int smem = tmr_nl_attention_smem(W, F, elt);
  if ((F * elt) % 16 || smem > 232448) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (f32) return tmr::nla::launch<float>(q, k, v, out, B, W, F, smem, s);
  return tmr::nla::launch<__nv_bfloat16>(q, k, v, out, B, W, F, smem, s);
}
