"""Whole BN-folded stride-1 identity bottleneck, tiled over H with a
pipelined K loop, NHWC.

Port of the Pallas TPU kernel
`tmrnet_tpu/experimental/fused_bottleneck_tiled.py::fused_bottleneck_tiled`
(:123-162, pallas_call at :142); the CUDA kernel is
`csrc/fused_bottleneck_tiled.cu`, whose header says what bounds it and how
its cp.async ring stands in for the TPU kernel's double-buffered slab DMA.

It computes the same function as `fused_bottleneck` (both are held to
`fused_bottleneck_reference` in JAX), so its plain version is
`fused_bottleneck_plain`. Unlike the TPU kernel it takes any H and N: the
last H tile may be partial. `fused_bottleneck_tiled` takes the kernel for
CUDA tensors and the plain version for CPU tensors; anything else raises.
"""

from __future__ import annotations

import ctypes

import torch

from tmrnet_torch.experimental.fused_bottleneck import (
    check_operands,
    fused_bottleneck_plain,
    tile_rows,
)
from tmrnet_torch.kernels import build
from tmrnet_torch.kernels.build import LAUNCHES


def fused_bottleneck_tiled_cuda(x, w1, b1, w2, b2, w3, b3):
    """Launch csrc/fused_bottleneck_tiled.cu. x (N, H, W, C) bf16
    NHWC-contiguous; w1/w2/w3 bf16 contiguous; biases f32; P and C
    multiples of 64."""
    n, h, w, c, p = check_operands("fused_bottleneck_tiled_cuda", x, w1, b1,
                                   w2, b2, w3, b3)
    lib = build.library("fused_bottleneck_tiled")
    lib.tmr_fused_bottleneck_tiled_smem.argtypes = [ctypes.c_int] * 3
    lib.tmr_fused_bottleneck_tiled_smem.restype = ctypes.c_int
    fn = lib.tmr_fused_bottleneck_tiled
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    # the kernel's GEMMs run over "wide" rows of W+2 columns
    th = tile_rows(lambda t: lib.tmr_fused_bottleneck_tiled_smem(w, p, t), h,
                   w + 2, c, p, "fused_bottleneck_tiled")
    out = torch.empty_like(x)
    q = build.ptr
    err = fn(q(x), q(w1), q(b1), q(w2), q(b2), q(w3), q(b3), q(out),
             n, h, w, c, p, th, build.stream_ptr(x.device))
    build.check(err, "fused_bottleneck_tiled")
    LAUNCHES["fused_bottleneck_tiled"] += 1
    return out


def fused_bottleneck_tiled(x, w1, b1, w2, b2, w3, b3):
    """relu(x + W3 . relu(conv3x3(relu(W1 . x + b1)) + b2) + b3), NHWC."""
    if x.device.type == "cpu":
        return fused_bottleneck_plain(x, w1, b1, w2, b2, w3, b3)
    if x.device.type == "cuda":
        return fused_bottleneck_tiled_cuda(x, w1, b1, w2, b2, w3, b3)
    raise ValueError(f"fused_bottleneck_tiled: unsupported device {x.device}")
