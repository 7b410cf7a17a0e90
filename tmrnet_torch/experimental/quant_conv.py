"""Int8 3x3 SAME stride-1 convolution with a dequantizing epilogue, NHWC.

Port of the Pallas TPU kernel
`tmrnet_tpu/experimental/quant_conv.py::int8_conv3x3` (:47-73, pallas_call
at :57); the CUDA kernel is `csrc/int8_conv3x3.cu`, an implicit GEMM on int8
wgmma (`csrc/wgmma_s8_gemm.cuh`, shared with `int8_matmul`), whose header
says what bounds it.

x_q (N, H, W, C) int8, w_q (3, 3, C, Co) int8 HWIO, x_scale one value,
w_scale (Co,) -> (N, H, W, Co):
    out = f32(conv(x_q, w_q), summed exactly) * (x_scale * w_scale[o])
`int8_conv3x3` takes the kernel for CUDA tensors and the plain version for
CPU tensors; anything else raises. `plan_int8_conv3x3` decides how the
kernel cuts a call into blocks; `kmajor_weight` keeps the (Co, 9C) copy of
the weight that the kernel reads.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from tmrnet_torch.kernels import build
from tmrnet_torch.kernels.build import LAUNCHES
from tmrnet_torch.kernels.prepared import copy_beside
from tmrnet_torch.ops.quant import (
    BK,
    BM,
    OUT_DTYPES,
    SMS,
    Int8Plan,
    check_operand,
    check_scales,
    dequantize,
)

# The (tile width, ring depth) pairs csrc/int8_conv3x3.cu is built for
# (TMR_I8C_PLANS). At BN = 256 a block holds the SM alone at any ring depth,
# so the deeper ring is the only one worth building.
PLANS = ((64, 3), (64, 4), (128, 3), (128, 4), (256, 4))


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


def check_conv_shape(n: int, h: int, w: int, c: int, co: int) -> None:
    """What the kernel takes: C and Co multiples of 16, a nonempty x, N H W
    below 2^31."""
    if c % 16 or co % 16 or c < 16 or co < 16 or n * h * w == 0:
        raise ValueError(f"int8_conv3x3_cuda: needs C % 16 == 0, Co % 16 == 0 "
                         f"and a nonempty x, got C={c}, Co={co}, "
                         f"x ({n}, {h}, {w}, {c})")
    if n * h * w >= 2 ** 31:
        raise ValueError(f"int8_conv3x3_cuda: x ({n}, {h}, {w}, {c}) is too "
                         f"large (N*H*W < 2^31)")


def plan_cost(plan: Int8Plan, m: int, co: int, nk: int):
    """The plan's sort key. First the modelled time of an SM: waves of
    `blocks_per_sm` blocks over 132 SMs, times the blocks it holds, times a
    block's nk chunks at BM bn / 32 cycles of int8 tensor work (4,096
    products a cycle) plus 2 (BM + bn) cycles of copies (64 bytes a cycle
    from L2). Then, on a tie, more blocks an SM (they hide each other's
    copy latency), then the deeper ring. On an H100 it picked the fastest
    plan at each of the int8 gate's stages (PERF.md, timed by
    experimental/kernel_timing.py --all-plans)."""
    tiles = -(-m // BM) * -(-co // plan.bn)
    blocks = plan.blocks_per_sm
    waves = -(-tiles // (SMS * blocks))
    chunk = BM * plan.bn / 32 + 2 * (BM + plan.bn)
    return waves * blocks * nk * chunk, -blocks, -plan.nstage


@functools.lru_cache(maxsize=256)
def plan_int8_conv3x3(n: int, h: int, w: int, c: int, co: int) -> Int8Plan:
    """The plan of one call: of the plans the kernel is built for, the one
    of least `plan_cost`."""
    check_conv_shape(n, h, w, c, co)
    m, nk = n * h * w, -(-9 * c // BK)
    plans = (Int8Plan(bn, s) for bn, s in PLANS)
    return min(plans, key=lambda p: plan_cost(p, m, co, nk))


def _kmajor(w_q: torch.Tensor) -> torch.Tensor:
    return w_q.reshape(-1, w_q.shape[-1]).t().contiguous()


def kmajor_weight(w_q: torch.Tensor) -> torch.Tensor:
    """The HWIO weight (3, 3, C, Co) as the kernel reads it: (Co, 9C)
    contiguous, row o holding column o in (dy, dx, ci) order (K-major, as
    the integer wgmma requires of B). Made once per change of w_q and kept
    beside w_q for as long as w_q lives (`kernels.prepared.copy_beside`)."""
    return copy_beside(w_q, _kmajor)


@functools.lru_cache(maxsize=None)
def _entries():
    """The library's three C entries, their argument types set once."""
    lib = build.library("int8_conv3x3")
    run, smem, tile = (lib.tmr_int8_conv3x3, lib.tmr_int8_conv3x3_smem,
                       lib.tmr_wgmma_s8_tile)
    run.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    run.restype = ctypes.c_int
    smem.argtypes = [ctypes.c_int] * 2
    smem.restype = ctypes.c_int
    tile.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p]
    tile.restype = ctypes.c_int
    return run, smem, tile


def int8_conv3x3_cuda(x_q, w_q, x_scale, w_scale, out_dtype=torch.float32,
                      plan: Int8Plan = None):
    """Launch csrc/int8_conv3x3.cu under `plan` (default
    `plan_int8_conv3x3`). x_q (N, H, W, C) int8 NHWC-contiguous, w_q (3, 3,
    C, Co) int8 contiguous, x_scale one f32, w_scale (Co,) f32, all on one
    CUDA device; C % 16 == 0 and Co % 16 == 0."""
    if x_q.device.type != "cuda":
        raise ValueError("int8_conv3x3_cuda: x_q is not on CUDA")
    if x_q.dim() != 4 or w_q.dim() != 4:
        raise ValueError(f"int8_conv3x3_cuda: x_q {tuple(x_q.shape)}, "
                         f"w_q {tuple(w_q.shape)}")
    n, h, w, c = x_q.shape
    co = w_q.shape[-1]
    check_conv_shape(n, h, w, c, co)
    if out_dtype not in OUT_DTYPES:
        raise TypeError(f"int8_conv3x3_cuda: out_dtype {out_dtype}")
    check_operand("x_q", x_q, x_q.device, torch.int8)
    check_operand("w_q", w_q, x_q.device, torch.int8, (3, 3, c, co))
    check_scales(x_scale, w_scale, co, x_q.device)
    plan = plan or plan_int8_conv3x3(n, h, w, c, co)
    run, smem_of, _ = _entries()
    smem = smem_of(plan.bn, plan.nstage)
    if smem != plan.smem:
        raise RuntimeError(f"int8_conv3x3: the kernel lays out {smem} bytes "
                           f"of shared memory for {plan}, the plan {plan.smem}")
    wk = kmajor_weight(w_q)
    out = torch.empty((n, h, w, co), dtype=out_dtype, device=x_q.device)
    q = build.ptr
    err = run(q(x_q), q(wk), q(x_scale), q(w_scale), q(out), n, h, w, c, co,
              int(out_dtype == torch.bfloat16), plan.bn, plan.nstage,
              build.stream_ptr(x_q.device))
    build.check(err, "int8_conv3x3")
    LAUNCHES["int8_conv3x3"] += 1
    return out


def wgmma_s8_tile_cuda(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The check of csrc/wgmma_s8.cuh: a (64, 128) int8 @ b (N, 128) int8
    transposed -> (64, N) int32 through one warpgroup's four k32 steps, N in
    {64, 128, 256}; both contiguous on one CUDA device."""
    if a.device.type != "cuda" or tuple(a.shape) != (64, BK) or b.dim() != 2 \
            or b.shape[0] not in (64, 128, 256) or b.shape[1] != BK:
        raise ValueError(f"wgmma_s8_tile_cuda: a {tuple(a.shape)} on "
                         f"{a.device}, b {tuple(b.shape)}")
    check_operand("a", a, a.device, torch.int8)
    check_operand("b", b, a.device, torch.int8)
    _, _, tile = _entries()
    out = torch.empty((64, b.shape[0]), dtype=torch.int32, device=a.device)
    q = build.ptr
    err = tile(q(a), q(b), q(out), b.shape[0], build.stream_ptr(a.device))
    build.check(err, "wgmma_s8_tile")
    LAUNCHES["wgmma_s8_tile"] += 1
    return out


def int8_conv3x3(x_q, w_q, x_scale, w_scale, out_dtype=torch.float32):
    """Int8 3x3 SAME stride-1 conv with per-output-channel dequantization."""
    if x_q.device.type == "cpu":
        return int8_conv3x3_plain(x_q, w_q, x_scale, w_scale, out_dtype)
    if x_q.device.type == "cuda":
        return int8_conv3x3_cuda(x_q, w_q, x_scale, w_scale, out_dtype)
    raise ValueError(f"int8_conv3x3: unsupported device {x_q.device}")
