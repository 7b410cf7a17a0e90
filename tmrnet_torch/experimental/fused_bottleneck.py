"""Whole BN-folded stride-1 identity bottleneck in one kernel, NHWC.

Port of the Pallas TPU kernel
`tmrnet_tpu/experimental/fused_bottleneck.py::fused_bottleneck` (:58-89,
pallas_call at :71); the CUDA kernel is `csrc/fused_bottleneck.cu`, whose
header says what bounds it and how it is built.

x (N, H, W, C); w1 (C, P), w2 (3, 3, P, P) HWIO, w3 (P, C); biases are the
BN-folded shifts. `fused_bottleneck` takes the kernel for CUDA tensors and
the plain version for CPU tensors; anything else raises. `plan_bottleneck`
decides how the kernel cuts a call into blocks.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch
import torch.nn.functional as F

from tmrnet_torch.kernels import build
from tmrnet_torch.kernels.build import LAUNCHES

# Shared memory a Hopper block may opt into.
_SMEM_BLOCK_MAX = 232448


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


# fused_bottleneck.cu's block: 8 warps (two warpgroups) whose register
# tiles make one bm x nb block tile of 8 x 64 x 64; K chunks of 32 through
# the cp.async ring; one block per SM.
_WARPS, _KC = 8, 32
_SMS = 132          # an H100 SXM's SMs: blocks per wave


@dataclasses.dataclass(frozen=True)
class BottleneckPlan:
    """How csrc/fused_bottleneck.cu cuts one call: `th` image rows per
    block; `wn`: the block tile is `bm` = 64 * 8 / wn rows by `nb` = 64 *
    wn columns (the kernel's template argument); `nstage` ring stages;
    `overlay`: y2 over y1; `smem` bytes of shared memory a block takes."""
    th: int
    wn: int
    nstage: int
    overlay: bool
    smem: int

    @property
    def bm(self) -> int:
        return 64 * (_WARPS // self.wn)

    @property
    def nb(self) -> int:
        return 64 * self.wn


def layout_bytes(w: int, p: int, th: int, wn: int, nstage: int,
                 overlay: bool) -> int:
    """A block's shared memory, as `Layout` in csrc/fused_bottleneck.cu
    computes it: the ring (each stage an A part of bm x 40 and a B part of
    32 x nb bf16), y1 on the wide (th+2) x (w+2) grid of rows p + 8
    wide, y2 (th * w rows, or over y1), phase 1's int row table, and 1 KB
    of slack to align the ring."""
    bm, nb, ldy = 64 * (_WARPS // wn), 64 * wn, p + 8
    stage = bm * (_KC + 8) * 2 + _KC * nb * 2
    y1 = (th + 2) * (w + 2) * ldy * 2
    y2 = 0 if overlay else th * w * ldy * 2
    return nstage * stage + y1 + y2 + (th + 2) * w * 4 + 1024   # + align


def block_rows(h: int, th: int):
    """Per block of an image: (h0, rows, lo, hi) -- output rows h0 ..
    h0+rows-1 and y1's image rows lo .. hi-1 (the tile and its halo, cut
    at the image), as the kernel computes them from blockIdx.x."""
    out = []
    for h0 in range(0, h, th):
        rows = min(th, h - h0)
        out.append((h0, rows, max(h0 - 1, 0), min(h0 + rows + 1, h)))
    return out


def block_chunks(h: int, w: int, c: int, p: int, th: int, wn: int):
    """K chunks of 32 each block of an image streams (phase 1 row tiles x
    passes x C/32, phase 2 x 9P/32, phase 3 x C/nb passes x P/32)."""
    bm, nb = 64 * (_WARPS // wn), 64 * wn
    out = []
    for _, rows, lo, hi in block_rows(h, th):
        t1 = -(-(hi - lo) * w // bm)
        t2 = -(-rows * w // bm)
        out.append(t1 * (p // nb) * (c // _KC) + t2 * (p // nb) * (9 * p // _KC)
                   + t2 * (c // nb) * (p // _KC))
    return out


@functools.lru_cache(maxsize=256)   # ~0.1-0.4 ms of Python a call, 12 a forward
def plan_bottleneck(n: int, h: int, w: int, c: int, p: int) -> BottleneckPlan:
    """The plan of one call. wn: the most warps across N (8, 4, 2, 1) whose
    64-wide column tiles divide P and C. th: the least modelled time --
    waves of one block per SM times the chunks of the longest block; ties
    go to more ring stages, then fewer chunks in all. Each th takes the
    deepest ring (4, else 3) that fits 227 KB, with y2 over y1 only where
    it must and may (phase 2 one tile, P = nb)."""
    wn = next(k for k in (8, 4, 2, 1) if p % (64 * k) == 0 and c % (64 * k) == 0)
    best = None
    for th in range(1, h + 1):
        choice = None
        for nstage in (4, 3):
            for overlay in (False, True):
                if overlay and (th * w > 64 * (_WARPS // wn) or p != 64 * wn):
                    continue
                nbytes = layout_bytes(w, p, th, wn, nstage, overlay)
                if nbytes <= _SMEM_BLOCK_MAX:
                    choice = (nstage, overlay, nbytes)
                    break
            if choice:
                break
        if choice is None:
            continue
        chunks = block_chunks(h, w, c, p, th, wn)
        waves = -(-n * len(chunks) // _SMS)
        key = (waves * max(chunks), -choice[0], n * sum(chunks))
        if best is None or key < best[0]:
            best = (key, BottleneckPlan(th, wn, *choice))
    if best is None:
        raise ValueError(f"fused_bottleneck: W={w}, P={p} does not fit shared "
                         f"memory at one row per block")
    return best[1]


def _check(name, t, device, dtype, shape, what):
    if t.device != device:
        raise ValueError(f"{what}: {name} on {t.device}, x on {device}")
    if t.dtype != dtype:
        raise TypeError(f"{what}: {name} dtype {t.dtype}, want {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: {name} shape {tuple(t.shape)}, "
                         f"want {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: {name} is not contiguous "
                         f"(x must be NHWC-contiguous)")


def check_operands(what, x, w1, b1, w2, b2, w3, b3):
    """The CUDA wrappers' checks of a bottleneck's operands: x (N, H, W, C)
    bf16 NHWC-contiguous on CUDA; w1/w2/w3 bf16 contiguous; biases f32;
    P and C multiples of 64. Returns (N, H, W, C, P)."""
    if x.device.type != "cuda":
        raise ValueError(f"{what}: x is not on CUDA")
    if x.dim() != 4 or w1.dim() != 2:
        raise ValueError(f"{what}: x {tuple(x.shape)}, w1 {tuple(w1.shape)}")
    n, h, w, c = x.shape
    p = w1.shape[1]
    if c % 64 or p % 64 or n * h * w == 0:
        raise ValueError(f"{what}: needs C, P multiples of 64 and a nonempty "
                         f"x, got C={c}, P={p}, x {tuple(x.shape)}")
    if n > 65535:   # one grid row of blocks per image
        raise ValueError(f"{what}: at most 65535 images, got {n}")
    for name, t, dtype, shape in (
            ("x", x, torch.bfloat16, (n, h, w, c)),
            ("w1", w1, torch.bfloat16, (c, p)), ("b1", b1, torch.float32, (p,)),
            ("w2", w2, torch.bfloat16, (3, 3, p, p)),
            ("b2", b2, torch.float32, (p,)),
            ("w3", w3, torch.bfloat16, (p, c)), ("b3", b3, torch.float32, (c,))):
        _check(name, t, x.device, dtype, shape, what)
    return n, h, w, c, p


def fused_bottleneck_cuda(x, w1, b1, w2, b2, w3, b3):
    """Launch csrc/fused_bottleneck.cu under `plan_bottleneck`. x (N, H, W,
    C) bf16 NHWC-contiguous; w1/w2/w3 bf16 contiguous; biases f32; P and C
    multiples of 64."""
    n, h, w, c, p = check_operands("fused_bottleneck_cuda", x, w1, b1, w2, b2,
                                   w3, b3)
    plan = plan_bottleneck(n, h, w, c, p)
    lib = build.library("fused_bottleneck")
    lib.tmr_fused_bottleneck_smem.argtypes = [ctypes.c_int] * 6
    lib.tmr_fused_bottleneck_smem.restype = ctypes.c_int
    fn = lib.tmr_fused_bottleneck
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    args = (plan.th, plan.wn, plan.nstage, int(plan.overlay))
    smem = lib.tmr_fused_bottleneck_smem(w, p, *args)
    if smem != plan.smem:
        raise RuntimeError(f"fused_bottleneck: the kernel lays out {smem} "
                           f"bytes of shared memory, the plan {plan.smem}")
    out = torch.empty_like(x)
    q = build.ptr
    err = fn(q(x), q(w1), q(b1), q(w2), q(b2), q(w3), q(b3), q(out),
             n, h, w, c, p, *args, build.stream_ptr(x.device))
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
