"""Whole BN-folded stride-1 identity bottleneck in one kernel, NHWC.

Port of the Pallas TPU kernel
`tmrnet_tpu/experimental/fused_bottleneck.py::fused_bottleneck` (:58-89,
pallas_call at :71); the CUDA kernel is `csrc/fused_bottleneck.cu`, whose
header says what bounds it and how it is built.

x (N, H, W, C); w1 (C, P), w2 (3, 3, P, P) HWIO, w3 (P, C); biases are the
BN-folded shifts. `fused_bottleneck` takes the kernel for CUDA tensors and
the plain version for CPU tensors; anything else raises.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from tmrnet_torch.kernels import build
from tmrnet_torch.kernels.build import LAUNCHES

# Shared memory a Hopper block may opt into, and an SM's total.
_SMEM_BLOCK_MAX = 232448
_SMEM_SM = 233472


def fused_bottleneck_plain(x, w1, b1, w2, b2, w3, b3):
    """The math of `fused_bottleneck_reference`
    (tmrnet_tpu/experimental/fused_bottleneck.py:92-104), in f32, result in
    x's dtype."""
    xf = x.float()
    n, h, w, c = x.shape
    p = w1.shape[1]
    y = torch.relu(xf.reshape(-1, c) @ w1.float() + b1.float())
    y = y.reshape(n, h, w, p).permute(0, 3, 1, 2)
    y = F.conv2d(y, w2.float().permute(3, 2, 0, 1), b2.float(), padding=1)
    y = torch.relu(y).permute(0, 2, 3, 1).reshape(-1, p)
    y = y @ w3.float() + b3.float()
    return torch.relu(y.reshape(n, h, w, c) + xf).to(x.dtype)


def tile_rows(lib, h: int, w: int, c: int, p: int) -> int:
    """Rows of the image one block owns. Model: tensor-core work counted in
    64-row tiles (halo rows of y1 recomputed per block), halved when two
    blocks fit on an SM; the tile must fit the block's shared memory."""
    best = None
    for th in range(1, h + 1):
        smem = lib.tmr_fused_bottleneck_smem(w, p, th)
        if smem > _SMEM_BLOCK_MAX:
            break
        rows1 = math.ceil((th + 2) * w / 64) * 64
        rows2 = math.ceil(th * w / 64) * 64
        work = math.ceil(h / th) * (rows1 * c * p + rows2 * (9 * p * p + p * c))
        per_sm = min(_SMEM_SM // (smem + 1024), 2)
        cost = work / per_sm
        if best is None or cost < best[0]:
            best = (cost, th)
    if best is None:
        raise ValueError(f"fused_bottleneck: W={w}, P={p} does not fit "
                         f"shared memory at one row per block")
    return best[1]


def _check(name, t, device, dtype, shape):
    if t.device != device:
        raise ValueError(f"fused_bottleneck_cuda: {name} on {t.device}, "
                         f"x on {device}")
    if t.dtype != dtype:
        raise TypeError(f"fused_bottleneck_cuda: {name} dtype {t.dtype}, "
                        f"want {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"fused_bottleneck_cuda: {name} shape "
                         f"{tuple(t.shape)}, want {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"fused_bottleneck_cuda: {name} is not contiguous "
                         f"(x must be NHWC-contiguous)")


def fused_bottleneck_cuda(x, w1, b1, w2, b2, w3, b3):
    """Launch csrc/fused_bottleneck.cu. x (N, H, W, C) bf16 NHWC-contiguous;
    w1/w2/w3 bf16 contiguous; biases f32; P and C multiples of 64."""
    if x.device.type != "cuda":
        raise ValueError("fused_bottleneck_cuda: x is not on CUDA")
    if x.dim() != 4 or w1.dim() != 2:
        raise ValueError(f"fused_bottleneck_cuda: x {tuple(x.shape)}, "
                         f"w1 {tuple(w1.shape)}")
    n, h, w, c = x.shape
    p = w1.shape[1]
    if c % 64 or p % 64 or n * h * w == 0:
        raise ValueError(f"fused_bottleneck_cuda: needs C, P multiples of 64 "
                         f"and a nonempty x, got C={c}, P={p}, x {tuple(x.shape)}")
    if n > 65535:   # one grid row of blocks per image
        raise ValueError(f"fused_bottleneck_cuda: at most 65535 images, got {n}")
    _check("x", x, x.device, torch.bfloat16, (n, h, w, c))
    _check("w1", w1, x.device, torch.bfloat16, (c, p))
    _check("b1", b1, x.device, torch.float32, (p,))
    _check("w2", w2, x.device, torch.bfloat16, (3, 3, p, p))
    _check("b2", b2, x.device, torch.float32, (p,))
    _check("w3", w3, x.device, torch.bfloat16, (p, c))
    _check("b3", b3, x.device, torch.float32, (c,))
    lib = build.library("fused_bottleneck")
    lib.tmr_fused_bottleneck_smem.argtypes = [ctypes.c_int] * 3
    lib.tmr_fused_bottleneck_smem.restype = ctypes.c_int
    fn = lib.tmr_fused_bottleneck
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    th = tile_rows(lib, h, w, c, p)
    out = torch.empty_like(x)
    q = build.ptr
    err = fn(q(x), q(w1), q(b1), q(w2), q(b2), q(w3), q(b3), q(out),
             n, h, w, c, p, th, build.stream_ptr(x.device))
    build.check(err, "fused_bottleneck")
    LAUNCHES["fused_bottleneck"] += 1
    return out


def fused_bottleneck(x, w1, b1, w2, b2, w3, b3):
    """relu(x + W3 . relu(conv3x3(relu(W1 . x + b1)) + b2) + b3), NHWC."""
    if x.device.type == "cpu":
        return fused_bottleneck_plain(x, w1, b1, w2, b2, w3, b3)
    if x.device.type == "cuda":
        return fused_bottleneck_cuda(x, w1, b1, w2, b2, w3, b3)
    raise ValueError(f"fused_bottleneck: unsupported device {x.device}")
