"""Whole BN-folded stride-1 identity bottleneck in one kernel, NHWC.

Port of the Pallas TPU kernel
`tmrnet_tpu/experimental/fused_bottleneck.py::fused_bottleneck` (:58-89,
pallas_call at :71); the CUDA kernel is `csrc/fused_bottleneck.cu`, whose
header says what bounds it and how it is built.

x (N, H, W, C); w1 (C, P), w2 (3, 3, P, P) HWIO, w3 (P, C); biases are the
BN-folded shifts. The op `torch.ops.tmrnet.fused_bottleneck`
(`kernels/library.py`), which `fused_bottleneck` calls, takes a kernel
for CUDA tensors and the plain version for CPU tensors; anything else
raises. On the card x and the weights are bf16 (`csrc/fused_bottleneck.cu`,
planned by `plan_bottleneck`) or f32 (`csrc/fused_bottleneck_f32.cu`, FFMA
and no TF32, planned by `plan_bottleneck_f32`), in one dtype
(`bottleneck_dtype`); the biases f32.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch
import torch.nn.functional as F

from tmrnet_torch.kernels import build, library

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


# csrc/bottleneck_f32.cuh's block: 256 threads as TX across N by 256 / TX
# down M, each owning 8 x 8 outputs, so the block tile is BM = 2048 / TX
# rows by BN = 8 TX columns (every TX: 16,384 outputs); K chunks of 16
# through a ring of f32 slots; x's staged rows 20 floats apart.
_F32_THREADS, _F32_KC, _F32_LDA = 256, 16, 20
F32_TX = (64, 32, 16, 8)
BLOCK_F32_NSTAGE = 2    # fused_bottleneck_f32.cu's ring: a double buffer


@dataclasses.dataclass(frozen=True)
class BottleneckF32Plan:
    """How an f32 bottleneck kernel cuts one call: `th` image rows per
    block; `tx` threads across N (the kernels' template argument): the
    block tile is `bm` = 2048 / tx rows by `bn` = 8 tx columns; `nstage`
    ring slots; `smem` bytes of shared memory a block takes."""
    th: int
    tx: int
    nstage: int
    smem: int

    @property
    def bm(self) -> int:
        return 8 * (_F32_THREADS // self.tx)

    @property
    def bn(self) -> int:
        return 8 * self.tx


def f32_layout_bytes(w: int, p: int, th: int, tx: int, nstage: int) -> int:
    """A block's shared memory, as `Layout` in csrc/bottleneck_f32.cuh
    computes it: `nstage` ring slots (an A part of bm x 20 floats, phase 1's
    x rows, and a B part of 16 x bn), y1's (th + 2) w rows and one zero row,
    and y2's th w rows, each row p + 4 floats."""
    bm, bn, ldy = 8 * (_F32_THREADS // tx), 8 * tx, p + 4
    slot = bm * _F32_LDA + _F32_KC * bn
    return 4 * (nstage * slot + ((th + 2) * w + 1) * ldy + th * w * ldy)


def f32_chunks(h: int, w: int, c: int, p: int, th: int, tx: int):
    """K chunks of 16 each block of an image multiplies, each a bm x bn x
    16 product (the same 262,144 FMAs at every tx): phase 1's row tiles x
    column passes x C/16, phase 2's x 9P/16, phase 3's C/bn passes x
    P/16."""
    bm, bn = 8 * (_F32_THREADS // tx), 8 * tx
    out = []
    for _, rows, lo, hi in block_rows(h, th):
        t1, t2 = -(-(hi - lo) * w // bm), -(-rows * w // bm)
        out.append(t1 * (p // bn) * (c // _F32_KC)
                   + t2 * (p // bn) * (9 * p // _F32_KC)
                   + t2 * (c // bn) * (p // _F32_KC))
    return out


def plan_f32(n: int, h: int, w: int, c: int, p: int, what: str,
             one_tile: bool, stages) -> BottleneckF32Plan:
    """The least modelled time over tx (8 tx dividing P and C; where
    `one_tile`, bm >= w) and th (where `one_tile`, th w <= bm): waves of
    one block per SM times the chunks of the longest block; ties go to more
    ring slots, then fewer chunks in all. Each (tx, th) takes the first of
    `stages` whose layout fits 227 KB."""
    best = None
    for tx in F32_TX:
        bm = 8 * (_F32_THREADS // tx)
        if p % (8 * tx) or c % (8 * tx) or (one_tile and bm < w):
            continue
        for th in range(1, (min(h, bm // w) if one_tile else h) + 1):
            nstage = next((s for s in stages if f32_layout_bytes(
                w, p, th, tx, s) <= _SMEM_BLOCK_MAX), None)
            if nstage is None:
                continue
            chunks = f32_chunks(h, w, c, p, th, tx)
            waves = -(-n * len(chunks) // _SMS)
            key = (waves * max(chunks), -nstage, n * sum(chunks))
            if best is None or key < best[0]:
                best = (key, BottleneckF32Plan(
                    th, tx, nstage, f32_layout_bytes(w, p, th, tx, nstage)))
    if best is None:
        raise ValueError(f"{what}: W={w}, P={p}, C={c} does not fit shared "
                         f"memory at one row per block in f32")
    return best[1]


@functools.lru_cache(maxsize=256)   # called once per launch, 12 a forward
def plan_bottleneck_f32(n: int, h: int, w: int, c: int,
                        p: int) -> BottleneckF32Plan:
    """The plan of one f32 call of csrc/fused_bottleneck_f32.cu: a block
    walks as many row tiles as its th rows need; a two-slot ring."""
    return plan_f32(n, h, w, c, p, "fused_bottleneck_f32", False,
                    (BLOCK_F32_NSTAGE,))


def bottleneck_dtype(x_dtype, w_dtypes) -> torch.dtype:
    """Which kernel takes the operands on the card: x's dtype where it and
    the three weights' are one, bf16 or f32; else TypeError (mixed dtypes,
    f16, f64)."""
    if len({x_dtype, *w_dtypes}) != 1 or x_dtype not in (torch.bfloat16,
                                                         torch.float32):
        raise TypeError(
            f"fused bottleneck: x dtype {x_dtype} and weights "
            f"{', '.join(str(d) for d in w_dtypes)}: the card's kernels take "
            f"bf16 or f32, x and the weights in one dtype")
    return x_dtype


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
    NHWC-contiguous on CUDA; w1/w2/w3 contiguous, in x's dtype, bf16 or f32
    (`bottleneck_dtype`); biases f32; P and C multiples of 64. Returns (N,
    H, W, C, P)."""
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
    dt = bottleneck_dtype(x.dtype, (w1.dtype, w2.dtype, w3.dtype))
    for name, t, dtype, shape in (
            ("x", x, dt, (n, h, w, c)),
            ("w1", w1, dt, (c, p)), ("b1", b1, torch.float32, (p,)),
            ("w2", w2, dt, (3, 3, p, p)),
            ("b2", b2, torch.float32, (p,)),
            ("w3", w3, dt, (p, c)), ("b3", b3, torch.float32, (c,))):
        _check(name, t, x.device, dtype, shape, what)
    return n, h, w, c, p


def check_aligned(what, *tensors):
    """The f32 kernels' float4 and cp.async copies want every operand
    16-byte aligned."""
    names = ("x", "w1", "b1", "w2", "b2", "w3", "b3")
    for name, t in zip(names, tensors):
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} is not 16-byte aligned")


@functools.lru_cache(maxsize=None)
def _f32_entries():
    """fused_bottleneck_f32's two C entries, their argument types set
    once."""
    lib = build.library("fused_bottleneck_f32")
    run, smem = lib.tmr_fused_bottleneck_f32, lib.tmr_fused_bottleneck_f32_smem
    run.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    run.restype = ctypes.c_int
    smem.argtypes = [ctypes.c_int] * 4
    smem.restype = ctypes.c_int
    return run, smem


def _fused_bottleneck_f32_cuda(x, w1, b1, w2, b2, w3, b3, shape):
    """csrc/fused_bottleneck_f32.cu under `plan_bottleneck_f32`."""
    n, h, w, c, p = shape
    check_aligned("fused_bottleneck_cuda", x, w1, b1, w2, b2, w3, b3)
    plan = plan_bottleneck_f32(n, h, w, c, p)
    run, smem_of = _f32_entries()
    smem = smem_of(w, p, plan.th, plan.tx)
    if smem != plan.smem:
        raise RuntimeError(f"fused_bottleneck_f32: the kernel lays out "
                           f"{smem} bytes of shared memory, the plan "
                           f"{plan.smem}")
    out = torch.empty_like(x)
    q = build.ptr
    err = run(q(x), q(w1), q(b1), q(w2), q(b2), q(w3), q(b3), q(out),
              n, h, w, c, p, plan.th, plan.tx, build.stream_ptr(x.device))
    build.check(err, "fused_bottleneck_f32")
    build.count("fused_bottleneck_f32", x.device)
    return out


def fused_bottleneck_cuda(x, w1, b1, w2, b2, w3, b3):
    """Launch csrc/fused_bottleneck.cu under `plan_bottleneck` (bf16
    operands) or csrc/fused_bottleneck_f32.cu under `plan_bottleneck_f32`
    (f32). x (N, H, W, C) NHWC-contiguous; w1/w2/w3 contiguous in x's
    dtype; biases f32; P and C multiples of 64; in f32 every operand
    16-byte aligned."""
    shape = check_operands("fused_bottleneck_cuda", x, w1, b1, w2, b2, w3, b3)
    if x.dtype == torch.float32:
        return _fused_bottleneck_f32_cuda(x, w1, b1, w2, b2, w3, b3, shape)
    n, h, w, c, p = shape
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
    build.count("fused_bottleneck", x.device)
    return out


def _fused_bottleneck_fake(x, w1, b1, w2, b2, w3, b3):
    if x.device.type == "cuda":
        shape = check_operands("fused_bottleneck_cuda", x, w1, b1, w2, b2,
                               w3, b3)
        (plan_bottleneck_f32 if x.dtype == torch.float32
         else plan_bottleneck)(*shape)
    return torch.empty_like(x)


BOTTLENECK_SCHEMA = ("(Tensor x, Tensor w1, Tensor b1, Tensor w2, Tensor b2, "
                     "Tensor w3, Tensor b3) -> Tensor")
fused_bottleneck = library.define(
    "fused_bottleneck", BOTTLENECK_SCHEMA, fused_bottleneck_cuda,
    fused_bottleneck_plain, _fused_bottleneck_fake)
"""fused_bottleneck(x, w1, b1, w2, b2, w3, b3): relu(x + W3 . relu(conv3x3(
relu(W1 . x + b1)) + b2) + b3), NHWC; the op
`torch.ops.tmrnet.fused_bottleneck`."""
