// The bf16 element type of the port's bf16 kernels (fused_bottleneck,
// time_conv), through block_gemm_async.cuh.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace tmr {

typedef __nv_bfloat16 bf16;

}  // namespace tmr
