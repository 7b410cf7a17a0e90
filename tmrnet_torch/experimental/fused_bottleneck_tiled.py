"""Whole BN-folded stride-1 identity bottleneck, tiled over H with a 1-row
halo, NHWC.

Port of the Pallas TPU kernel
`tmrnet_tpu/experimental/fused_bottleneck_tiled.py::fused_bottleneck_tiled`
(:123-162, pallas_call at :142); the CUDA kernel is
`csrc/fused_bottleneck_tiled.cu`, whose header says what bounds it and how
its TMA boxes and mbarrier ring stand in for the TPU kernel's halo'd slab
DMA.

It computes the same function as `fused_bottleneck` (both are held to
`fused_bottleneck_reference` in JAX), so its plain version is
`fused_bottleneck_plain`. Unlike the TPU kernel it takes any H and N: the
last H tile may be partial. The op `torch.ops.tmrnet.fused_bottleneck_tiled`
(`kernels/library.py`), which `fused_bottleneck_tiled` calls, takes a
kernel for CUDA tensors and the plain version for CPU tensors; anything
else raises. On the card x and the weights are bf16 or f32, in one dtype
(`fused_bottleneck.bottleneck_dtype`); the biases f32.
In bf16 `plan_bottleneck_tiled` decides how the kernel cuts a call into
blocks; `tiled_blocks`, `chunk_boxes` and `tiled_layout_bytes` say what a
block copies and where it keeps it, as the kernel computes them. In f32
the kernel is `fused_bottleneck`'s, `csrc/fused_bottleneck_f32.cu` (FFMA,
no TF32, x through a TMA ring in K chunks, y1's halo shared by DSMEM
within a cluster of CTAs, phase 3's residual staged in shared memory where
it fits), with no tiled structure of its own: it runs under
`plan_bottleneck_tiled_f32` (the block plan, W <= 256) and counts its
launches as `fused_bottleneck_tiled_f32`.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch

from tmrnet_torch.experimental.fused_bottleneck import (
    _SMEM_BLOCK_MAX,
    _SMS,
    BOTTLENECK_SCHEMA,
    F32_ACTIVE_CLUSTERS,
    BottleneckF32Plan,
    card_clusters,
    check_operands,
    fused_bottleneck_plain,
    launch_f32,
    plan_f32,
)
from tmrnet_torch.kernels import build, library

# The kernel's block: 8 warps (two warpgroups) whose register tiles make one
# bm x nb = 512 x 64, 256 x 128, 128 x 256 or 64 x 512 block tile; K chunks
# of 32; a TMA box's sides are at most 256 elements.
_WARPS, _KC, _BOX_MAX = 8, 32, 256


@dataclasses.dataclass(frozen=True)
class TiledPlan:
    """How csrc/fused_bottleneck_tiled.cu cuts one call: `th` image rows per
    block (th * w <= bm: phases 2-3 are one row tile); `wn`: the block tile
    is `bm` = 64 * 8 / wn rows by `nb` = 64 * wn columns (the kernel's
    template argument); `r` image rows a phase-1 box of x (r * w <= bm);
    `nstage` ring slots; `nres` buffers of phase 3's residual tile (2: the
    next column pass's loads while this one runs); `overlay`: y2 over y1;
    `smem` bytes of shared memory a block takes."""
    th: int
    wn: int
    r: int
    nstage: int
    nres: int
    overlay: bool
    smem: int

    @property
    def bm(self) -> int:
        return 64 * (_WARPS // self.wn)

    @property
    def nb(self) -> int:
        return 64 * self.wn


def _round_1k(nbytes: int) -> int:
    return -(-nbytes // 1024) * 1024


def tiled_layout_bytes(w: int, p: int, th: int, wn: int, r: int, nstage: int,
                       nres: int, overlay: bool) -> int:
    """A block's shared memory, as `Layout` in the kernel computes it: the
    ring's A parts (nstage slots, each one x box of r * w rows x 64 bytes;
    phase 3's nres residual tiles, each nb / 64 boxes of th * w rows x 128
    bytes, over them), its B parts (nstage x 32 x nb bf16), y1 on the wide
    (th + 2) x (w + 2) grid of rows p + 8 wide, y2 (th * w rows, or over
    y1), 2 nstage + 2 mbarriers, 1 KB of slack to align the ring."""
    nb, ldy = 64 * wn, p + 8
    a_stage = _round_1k(r * w * _KC * 2)
    res = nres * nb // 64 * _round_1k(th * w * 128)
    y1 = (th + 2) * (w + 2) * ldy * 2
    y2 = 0 if overlay else th * w * ldy * 2
    return (max(nstage * a_stage, res) + nstage * _KC * nb * 2 + y1 + y2
            + (2 * nstage + 2) * 8 + 1024)


def tiled_blocks(h: int, th: int, r: int):
    """Per block of an image: (h0, rows, box_rows) -- output rows h0 ..
    h0+rows-1 and the first image row of each phase-1 box of x (r rows
    each, from h0 - 1: the tile's halo rows included; rows off the image
    come zero-filled), as the kernel computes them from blockIdx.x."""
    out = []
    for h0 in range(0, h, th):
        rows = min(th, h - h0)
        boxes = -(-(rows + 2) // r)
        out.append((h0, rows, [h0 - 1 + k * r for k in range(boxes)]))
    return out


def chunk_boxes(phase, w: int, th: int, wn: int, r: int):
    """The boxes the kernel issues into one ring slot for a K chunk of
    `phase` (0, 1, 2), as (elements innermost first, bytes): the weights'
    box of 64 columns x 32 rows x nb / 64 column groups and, in phase 0,
    x's box of 32 channels x w columns x r rows x 1 image; and, at the
    start of each phase-2 column pass ("residual"), nb / 64 boxes of 64
    channels x w x th."""
    if phase == "residual":
        shapes = [(64, w, th, 1)] * wn
    else:
        shapes = [(64, _KC, wn)] + ([(_KC, w, r, 1)] if phase == 0 else [])
    return [(s, 2 * math.prod(s)) for s in shapes]


def chunk_tx_bytes(phase, w: int, th: int, wn: int, r: int) -> int:
    """The bytes the kernel arms a slot's full barrier (or the residual's)
    with: `bytes` in its `issue`, and WN * MR * 128 for the residual."""
    if phase == "residual":
        return wn * th * w * 128
    return (r * w * _KC * 2 if phase == 0 else 0) + _KC * 64 * wn * 2


def tiled_chunks(h: int, w: int, c: int, p: int, th: int, wn: int, r: int):
    """K chunks of 32 each block of an image streams: phase 1's box tiles x
    passes x C/32, then phase 2's passes x 9P/32, phase 3's C/nb passes x
    P/32."""
    nb = 64 * wn
    return [len(boxes) * (p // nb) * (c // _KC) + (p // nb) * (9 * p // _KC)
            + (c // nb) * (p // _KC) for _, _, boxes in tiled_blocks(h, th, r)]


@functools.lru_cache(maxsize=256)   # called once per launch, 10 a forward
def plan_bottleneck_tiled(n: int, h: int, w: int, c: int,
                          p: int) -> TiledPlan:
    """The plan of one call. wn: the most warps across N (8, 4, 2, 1) whose
    64-wide column tiles divide P and C and whose bm rows hold an image row.
    th: at most bm / w (phases 2-3 one row tile) and 256 (a box side), the
    least modelled time -- waves of one block per SM times the chunks of the
    longest block; ties go to more ring slots, then fewer chunks in all; r =
    min(bm // w, th + 2). Each th takes the first layout that fits 227 KB
    in this order: the deeper ring (4, else 3 slots), two residual buffers
    (where phase 3 has more than one column pass) before one, y2 in its own
    region before over y1 (which only P = nb allows)."""
    if w > _BOX_MAX:
        raise ValueError(f"fused_bottleneck_tiled: W = {w} > {_BOX_MAX}, "
                         f"the most a TMA box holds")
    wn = next(k for k in (8, 4, 2, 1) if p % (64 * k) == 0
              and c % (64 * k) == 0 and 64 * (_WARPS // k) >= w)
    bm = 64 * (_WARPS // wn)
    best = None
    for th in range(1, min(h, bm // w, _BOX_MAX) + 1):
        r = min(bm // w, th + 2)
        layouts = [(nstage, nres, overlay) for nstage in (4, 3)
                   for nres in ((2, 1) if c > 64 * wn else (1,))
                   for overlay in ((False, True) if p == 64 * wn else (False,))]
        choice = next(((*lay, nbytes) for lay in layouts
                       if (nbytes := tiled_layout_bytes(w, p, th, wn, r, *lay))
                       <= _SMEM_BLOCK_MAX), None)
        if choice is None:
            continue
        chunks = tiled_chunks(h, w, c, p, th, wn, r)
        waves = -(-n * len(chunks) // _SMS)
        key = (waves * max(chunks), -choice[0], n * sum(chunks))
        if best is None or key < best[0]:
            best = (key, TiledPlan(th, wn, r, *choice))
    if best is None:
        raise ValueError(f"fused_bottleneck_tiled: W={w}, P={p} does not fit "
                         f"shared memory at one row per block")
    return best[1]


@functools.lru_cache(maxsize=256)   # called once per launch, 10 a forward
def plan_bottleneck_tiled_f32(n: int, h: int, w: int, c: int, p: int,
                              active=F32_ACTIVE_CLUSTERS) -> BottleneckF32Plan:
    """The plan of one f32 call from `fused_bottleneck_tiled_cuda`: the
    block kernel's (`plan_f32`), which it launches too, with the TPU tiled
    kernel's limit W <= 256, as the bf16 kernel's TMA boxes take."""
    if w > _BOX_MAX:
        raise ValueError(f"fused_bottleneck_tiled_f32: W = {w} > {_BOX_MAX}, "
                         f"the widest image the tiled kernels take")
    return plan_f32(n, h, w, c, p, "fused_bottleneck_tiled_f32", active)


def _fused_bottleneck_tiled_f32_cuda(x, w1, b1, w2, b2, w3, b3, shape):
    """csrc/fused_bottleneck_f32.cu's kernel under
    `plan_bottleneck_tiled_f32` over the card's active clusters, counted as
    fused_bottleneck_tiled_f32."""
    plan = plan_bottleneck_tiled_f32(*shape, card_clusters(x.device.index))
    return launch_f32("fused_bottleneck_tiled_f32",
                      "fused_bottleneck_tiled_cuda", x, w1, b1, w2, b2, w3,
                      b3, shape, plan)


def fused_bottleneck_tiled_cuda(x, w1, b1, w2, b2, w3, b3):
    """Launch csrc/fused_bottleneck_tiled.cu under `plan_bottleneck_tiled`
    (bf16 operands) or csrc/fused_bottleneck_f32.cu's kernel under
    `plan_bottleneck_tiled_f32` (f32). x (N, H, W, C) NHWC-contiguous;
    w1/w2/w3 contiguous in x's dtype; biases f32; P and C multiples of 64;
    W <= 256; every tensor 16-byte aligned (TMA; the f32 kernel's
    cp.async)."""
    shape = check_operands("fused_bottleneck_tiled_cuda", x, w1, b1, w2, b2,
                           w3, b3)
    if x.dtype == torch.float32:
        return _fused_bottleneck_tiled_f32_cuda(x, w1, b1, w2, b2, w3, b3,
                                                shape)
    n, h, w, c, p = shape
    plan = plan_bottleneck_tiled(n, h, w, c, p)
    if any(t.data_ptr() % 16 for t in (x, w1, w2, w3)):
        raise ValueError("fused_bottleneck_tiled_cuda: x and the weights must "
                         "be 16-byte aligned (TMA)")
    lib = build.library("fused_bottleneck_tiled")
    lib.tmr_fused_bottleneck_tiled_smem.argtypes = [ctypes.c_int] * 8
    lib.tmr_fused_bottleneck_tiled_smem.restype = ctypes.c_int
    fn = lib.tmr_fused_bottleneck_tiled
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 11 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    args = (plan.th, plan.wn, plan.r, plan.nstage, plan.nres,
            int(plan.overlay))
    smem = lib.tmr_fused_bottleneck_tiled_smem(w, p, *args)
    if smem != plan.smem:
        raise RuntimeError(f"fused_bottleneck_tiled: the kernel lays out "
                           f"{smem} bytes of shared memory, the plan "
                           f"{plan.smem}")
    out = torch.empty_like(x)
    q = build.ptr
    err = fn(q(x), q(w1), q(b1), q(w2), q(b2), q(w3), q(b3), q(out),
             n, h, w, c, p, *args, build.stream_ptr(x.device))
    build.check(err, "fused_bottleneck_tiled")
    build.count("fused_bottleneck_tiled", x.device)
    return out


def _fused_bottleneck_tiled_fake(x, w1, b1, w2, b2, w3, b3):
    if x.device.type == "cuda":
        shape = check_operands("fused_bottleneck_tiled_cuda", x, w1, b1, w2,
                               b2, w3, b3)
        (plan_bottleneck_tiled_f32 if x.dtype == torch.float32
         else plan_bottleneck_tiled)(*shape)
    return torch.empty_like(x)


fused_bottleneck_tiled = library.define(
    "fused_bottleneck_tiled", BOTTLENECK_SCHEMA, fused_bottleneck_tiled_cuda,
    fused_bottleneck_plain, _fused_bottleneck_tiled_fake)
"""fused_bottleneck_tiled(x, w1, b1, w2, b2, w3, b3): the same function as
`fused_bottleneck`, NHWC; the op `torch.ops.tmrnet.fused_bottleneck_tiled`."""
