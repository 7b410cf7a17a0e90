"""Int8 3x3 SAME stride-1 convolution with a dequantizing epilogue, NHWC.

Port of the Pallas TPU kernel
`tmrnet_tpu/experimental/quant_conv.py::int8_conv3x3` (:47-73, pallas_call
at :57); the CUDA kernel is `csrc/int8_conv3x3.cu`, an implicit GEMM on the
int8 tile of `csrc/int8_gemm.cuh`, whose headers say what bounds it.

x_q (N, H, W, C) int8, w_q (3, 3, C, Co) int8 HWIO, x_scale one value,
w_scale (Co,) -> (N, H, W, Co):
    out = f32(conv(x_q, w_q), summed exactly) * (x_scale * w_scale[o])
`int8_conv3x3` takes the kernel for CUDA tensors and the plain version for
CPU tensors; anything else raises.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from tmrnet_torch.kernels import build
from tmrnet_torch.kernels.build import LAUNCHES
from tmrnet_torch.ops.quant import (
    OUT_DTYPES,
    check_operand,
    check_scales,
    dequantize,
)


def im2col3x3(x: torch.Tensor) -> torch.Tensor:
    """(N, H, W, C) -> (N*H*W, 9C), taps in the (dy, dx, ci) order of an
    HWIO weight, zero outside the image."""
    n, h, w, c = x.shape
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    cols = [xp[:, dy:dy + h, dx:dx + w, :] for dy in range(3) for dx in range(3)]
    return torch.cat(cols, dim=-1).reshape(n * h * w, 9 * c)


def int8_conv3x3_plain(x_q, w_q, x_scale, w_scale, out_dtype=torch.float32):
    """The TPU kernel's math (tmrnet_tpu/experimental/quant_conv.py:22-44):
    `int8_conv3x3_reference` (:76-81) dequantizes before a float conv; this
    sums the integer products exactly instead (an explicit im2col and an f64
    matmul, exact below 2^53; a library conv might use a transform that
    rounds) and then applies the kernel's epilogue."""
    n, h, w, _ = x_q.shape
    co = w_q.shape[-1]
    acc = im2col3x3(x_q.double()) @ w_q.double().reshape(-1, co)
    return dequantize(acc, x_scale, w_scale, out_dtype).reshape(n, h, w, co)


def int8_conv3x3_cuda(x_q, w_q, x_scale, w_scale, out_dtype=torch.float32):
    """Launch csrc/int8_conv3x3.cu. x_q (N, H, W, C) int8 NHWC-contiguous,
    w_q (3, 3, C, Co) int8 contiguous, x_scale one f32, w_scale (Co,) f32,
    all on one CUDA device; C % 16 == 0 and Co % 16 == 0."""
    if x_q.device.type != "cuda":
        raise ValueError("int8_conv3x3_cuda: x_q is not on CUDA")
    if x_q.dim() != 4 or w_q.dim() != 4:
        raise ValueError(f"int8_conv3x3_cuda: x_q {tuple(x_q.shape)}, "
                         f"w_q {tuple(w_q.shape)}")
    n, h, w, c = x_q.shape
    co = w_q.shape[-1]
    if c % 16 or co % 16 or n * h * w == 0:
        raise ValueError(f"int8_conv3x3_cuda: needs C % 16 == 0, Co % 16 == 0 "
                         f"and a nonempty x, got C={c}, Co={co}, "
                         f"x {tuple(x_q.shape)}")
    if n * h * w >= 2 ** 31:
        raise ValueError(f"int8_conv3x3_cuda: N*H*W = {n * h * w} rows")
    if out_dtype not in OUT_DTYPES:
        raise TypeError(f"int8_conv3x3_cuda: out_dtype {out_dtype}")
    check_operand("x_q", x_q, x_q.device, torch.int8)
    check_operand("w_q", w_q, x_q.device, torch.int8, (3, 3, c, co))
    check_scales(x_scale, w_scale, co, x_q.device)
    fn = build.library("int8_conv3x3").tmr_int8_conv3x3
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty((n, h, w, co), dtype=out_dtype, device=x_q.device)
    q = build.ptr
    err = fn(q(x_q), q(w_q), q(x_scale), q(w_scale), q(out), n, h, w, c, co,
             int(out_dtype == torch.bfloat16), build.stream_ptr(x_q.device))
    build.check(err, "int8_conv3x3")
    LAUNCHES["int8_conv3x3"] += 1
    return out


def int8_conv3x3(x_q, w_q, x_scale, w_scale, out_dtype=torch.float32):
    """Int8 3x3 SAME stride-1 conv with per-output-channel dequantization."""
    if x_q.device.type == "cpu":
        return int8_conv3x3_plain(x_q, w_q, x_scale, w_scale, out_dtype)
    if x_q.device.type == "cuda":
        return int8_conv3x3_cuda(x_q, w_q, x_scale, w_scale, out_dtype)
    raise ValueError(f"int8_conv3x3: unsupported device {x_q.device}")
