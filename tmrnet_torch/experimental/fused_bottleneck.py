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


# csrc/bottleneck_f32.cuh's CTA: 256 threads as TX across N by 256 / TX
# down M, each owning 8 x 8 outputs, so the CTA tile is BM = 2048 / TX
# pixels by BN = 8 TX columns (every TX: 16,384 outputs); K chunks of 16
# through a ring of f32 slots (BM x 16 of x and 16 x BN of a weight). CTAs
# run in clusters that own consecutive pixels, share each weight chunk (TMA
# multicast) and y1's halo (DSMEM).
_F32_THREADS, _F32_KC, _F32_ALIGN = 256, 16, 128
F32_TX = (64, 32, 16, 8)
F32_CLUSTERS = (8, 4, 2)
F32_NSTAGES = (4, 3)
# cudaOccupancyMaxActiveClusters on an H100 SXM (132 SMs) at one CTA an
# SM, (cluster size, clusters): what a plan counts waves over where no card
# is asked (the fake implementations, CPU tests); the wrappers plan with
# the card's own (`card_clusters`).
F32_ACTIVE_CLUSTERS = ((8, 15), (4, 30), (2, 66))


@dataclasses.dataclass(frozen=True)
class BottleneckF32Plan:
    """How an f32 bottleneck kernel cuts one call. The N H W pixels, in
    NHWC order, fall into spans of `span` consecutive pixels, one a
    cluster of `cs` CTAs; each CTA owns at most `rows` = ceil(span / cs)
    <= bm of them (`f32_cut`). `tx` threads across N (the kernels' template
    argument): the CTA tile is `bm` = 2048 / tx pixels by `bn` = 8 tx
    columns; `nstage` ring slots; `overlay`: y2 over y1 (phase 2 one column
    pass); `staged`: phase 3's residual staged in shared memory (where it
    fits, else read from device memory); `smem` bytes a CTA. The model:
    `clusters` launched, `waves` of them over the card's active clusters,
    `real_share` of the products on the call's own pixels (the rest fall
    on tile padding and on y1 at clusters' edges), `weight_bytes` of
    W1, W2 and W3 read from L2 a launch (once a cluster)."""
    tx: int
    cs: int
    span: int
    rows: int
    nstage: int
    overlay: bool
    staged: bool
    smem: int
    clusters: int
    waves: int
    real_share: float
    weight_bytes: int

    @property
    def bm(self) -> int:
        return 8 * (_F32_THREADS // self.tx)

    @property
    def bn(self) -> int:
        return 8 * self.tx


def f32_layout(w: int, p: int, tx: int, rows: int, nstage: int,
               overlay: bool) -> dict:
    """A CTA's shared memory, as `Layout` in csrc/bottleneck_f32.cuh lays it
    out from its 128-byte aligned start, offsets in floats: `nstage` ring
    slots (an A part of bm x 16 floats, then 16 x bn), y1's window of rows
    + 2 (w + 1) rows, the zero row, y2's rows (or over y1), the 2 nstage
    mbarriers; `res` the staged residual's start; `total` bytes with 128 of
    slack for the alignment."""
    bm, bn, ldy = 8 * (_F32_THREADS // tx), 8 * tx, p + 4
    a_part = bm * _F32_KC
    slot = a_part + _F32_KC * bn
    y1 = nstage * slot
    zero = y1 + (rows + 2 * (w + 1)) * ldy
    y2 = y1 if overlay else zero + ldy
    res = y1 + rows * ldy if overlay else y1
    bars = zero + ldy if overlay else y2 + rows * ldy
    return dict(bm=bm, bn=bn, ldy=ldy, a_part=a_part, slot=slot, y1=y1,
                zero=zero, y2=y2, res=res, bars=bars,
                total=_F32_ALIGN + 4 * bars + 16 * nstage)


def f32_layout_bytes(w: int, p: int, tx: int, rows: int, nstage: int,
                     overlay: bool) -> int:
    return f32_layout(w, p, tx, rows, nstage, overlay)["total"]


def f32_stage_fits(w: int, p: int, tx: int, rows: int, nstage: int,
                   overlay: bool) -> bool:
    """The staged residual (rows x bn + 4 floats) fits before the zero
    row."""
    lay = f32_layout(w, p, tx, rows, nstage, overlay)
    return lay["res"] + rows * (lay["bn"] + 4) <= lay["zero"]


def f32_cut(npix: int, h: int, w: int, span: int, cs: int, cluster: int):
    """The kernel's `Cut` of one cluster: (own, slices), each cs + 1
    boundaries. CTA i owns the output pixels own[i] .. own[i + 1] - 1 and
    computes y1 on slices[i] .. slices[i + 1] - 1: R, the cluster's pixels
    and w + 1 more each side cut at their images, split evenly. Its y1
    window's row 0 is pixel own[i] - w - 1."""
    hw = h * w
    u0 = cluster * span
    nu = min(span, npix - u0)
    last = u0 + nu - 1
    r0 = max(u0 - w - 1, u0 - u0 % hw)
    nr = min(u0 + nu + w + 1, last - last % hw + hw) - r0
    return ([u0 + i * nu // cs for i in range(cs + 1)],
            [r0 + i * nr // cs for i in range(cs + 1)])


def f32_spans(npix: int, hw: int, w: int, cs: int, bm: int, rows: int):
    """The spans a cluster of cs CTAs of `rows` own pixels may take: the
    longest whose y1 (the span and w + 1 pixels each side) splits into
    slices of at most bm, and the longest of whole images (whose y1 is the
    span); none past the call's pixels."""
    out = {min(cs * rows, cs * bm - 2 * (w + 1), npix)}
    if hw <= cs * rows:
        out.add(min(cs * rows // hw * hw, npix))
    return sorted(x for x in out if x >= 1)


def plan_f32(n: int, h: int, w: int, c: int, p: int, what: str,
             active=F32_ACTIVE_CLUSTERS) -> BottleneckF32Plan:
    """The least modelled time: waves of clusters over the card's active
    clusters (`active`: (cluster size, clusters) pairs, as `card_clusters`
    reads them; a size the card runs none of is not planned), times a CTA's
    products (bm pixels through the three phases, whatever it owns); ties
    go to fewer products in all (a higher real share), then the staged
    residual, then more ring slots, then smaller clusters. Over tx (8 tx
    dividing P and C), the cluster size, the ring (4 or 3 slots), y2 over
    y1 or not (only where P = bn) and the span (`f32_spans`, its rows the
    most that fit 227 KB)."""
    hw, npix = h * w, n * h * w
    if npix + 2 * hw >= 2 ** 31:
        raise ValueError(f"{what}: N H W = {npix} pixels, past the kernel's "
                         f"32-bit pixel index")
    wbytes = 4 * (2 * c * p + 9 * p * p)
    active = dict(active)
    if not any(active.get(cs, 0) > 0 for cs in F32_CLUSTERS):
        raise ValueError(f"{what}: the card runs no cluster of "
                         f"{', '.join(map(str, F32_CLUSTERS))} CTAs at one "
                         f"CTA an SM ({active})")
    best = None
    for tx in F32_TX:
        bm, bn = 8 * (_F32_THREADS // tx), 8 * tx
        if p % bn or c % bn:
            continue
        for cs in (k for k in F32_CLUSTERS if active.get(k, 0) > 0):
            for nstage in F32_NSTAGES:
                for overlay in ((False, True) if p == bn else (False,)):
                    fit = next((r for r in range(bm, 0, -1) if f32_layout_bytes(
                        w, p, tx, r, nstage, overlay) <= _SMEM_BLOCK_MAX), 0)
                    for span in f32_spans(npix, hw, w, cs, bm, fit):
                        rows = -(-span // cs)
                        staged = f32_stage_fits(w, p, tx, rows, nstage,
                                                overlay)
                        clusters = -(-npix // span)
                        waves = -(-clusters // active[cs])
                        key = (waves * bm, clusters * cs * bm, not staged,
                               -nstage, cs, overlay)
                        if best is None or key < best[0]:
                            best = (key, BottleneckF32Plan(
                                tx, cs, span, rows, nstage, overlay, staged,
                                f32_layout_bytes(w, p, tx, rows, nstage,
                                                 overlay),
                                clusters, waves,
                                npix / (clusters * cs * bm),
                                clusters * wbytes))
    if best is None:
        raise ValueError(f"{what}: W={w}, P={p}, C={c} does not fit shared "
                         f"memory in f32 (y1's window needs 2 W + 2 rows "
                         f"beside the CTA's own)")
    return best[1]


@functools.lru_cache(maxsize=256)   # called once per launch, 12 a forward
def plan_bottleneck_f32(n: int, h: int, w: int, c: int, p: int,
                        active=F32_ACTIVE_CLUSTERS) -> BottleneckF32Plan:
    """The plan of one f32 call of csrc/fused_bottleneck_f32.cu from
    `fused_bottleneck_cuda`, over `active` clusters (`plan_f32`)."""
    return plan_f32(n, h, w, c, p, "fused_bottleneck_f32", active)


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
    """The f32 kernels' TMA boxes, float4 and cp.async copies want every
    operand 16-byte aligned."""
    names = ("x", "w1", "b1", "w2", "b2", "w3", "b3")
    for name, t in zip(names, tensors):
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} is not 16-byte aligned")


@functools.lru_cache(maxsize=None)
def f32_entries(path=None):
    """The three C entries of csrc/fused_bottleneck_f32.cu's library (the
    launch, its shared memory, the card's active clusters), their argument
    types set once; `path`: another build of that source to load instead
    (the probe's)."""
    lib = (build.library("fused_bottleneck_f32") if path is None
           else ctypes.CDLL(str(path)))
    run, smem, clusters = (getattr(lib, f"tmr_fused_bottleneck_f32{x}")
                           for x in ("", "_smem", "_clusters"))
    run.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 11 + [
        ctypes.c_void_p]
    for fn in (run, smem, clusters):
        fn.restype = ctypes.c_int
    smem.argtypes = [ctypes.c_int] * 7
    clusters.argtypes = [ctypes.c_int]
    return run, smem, clusters


@functools.lru_cache(maxsize=None)
def card_clusters(index: int) -> tuple:
    """How many clusters of each size in F32_CLUSTERS card `index` runs at
    once at one CTA an SM (cudaOccupancyMaxActiveClusters), as (cluster
    size, clusters) pairs: what the f32 plans count waves over. Read once a
    card; a CUDA error raises."""
    clusters_of = f32_entries()[2]
    out = []
    with torch.cuda.device(index):
        for cs in F32_CLUSTERS:
            active = clusters_of(cs)
            if active < 0:
                raise RuntimeError(
                    f"fused_bottleneck_f32: cudaOccupancyMaxActiveClusters "
                    f"for clusters of {cs} on cuda:{index} failed (CUDA error "
                    f"{-active})")
            out.append((cs, active))
    return tuple(out)


def launch_f32(name, what, x, w1, b1, w2, b2, w3, b3, shape, plan,
               entries=None):
    """Launch csrc/fused_bottleneck_f32.cu's kernel (`entries`, by default
    its library's) under `plan`, counted as `name`; every failure raises
    and names the call's shape: a layout that disagrees with the plan's
    bytes, a tensor map that does not encode, a launch the card refuses."""
    n, h, w, c, p = shape
    at = f"{name} at N={n} H={h} W={w} C={c} P={p} (tx={plan.tx}, " \
         f"cluster {plan.cs}, span {plan.span})"
    check_aligned(what, x, w1, b1, w2, b2, w3, b3)
    run, smem_of, _ = entries or f32_entries()
    smem = smem_of(w, p, plan.tx, plan.span, plan.cs, plan.nstage,
                   int(plan.overlay))
    if smem != plan.smem:
        raise RuntimeError(f"{at}: the kernel lays out {smem} bytes of "
                           f"shared memory, the plan {plan.smem}")
    out = torch.empty_like(x)
    q = build.ptr
    err = run(q(x), q(w1), q(b1), q(w2), q(b2), q(w3), q(b3), q(out),
              n, h, w, c, p, plan.tx, plan.span, plan.cs, plan.nstage,
              int(plan.overlay), int(plan.staged), build.stream_ptr(x.device))
    if err >= 100000:
        raise RuntimeError(f"{at}: a tensor map does not encode (CUresult "
                           f"{err - 100000})")
    if err != 0:
        raise RuntimeError(f"{at}: the cluster launch failed (CUDA error "
                           f"{err})")
    build.count(name, x.device)
    return out


def _fused_bottleneck_f32_cuda(x, w1, b1, w2, b2, w3, b3, shape):
    """csrc/fused_bottleneck_f32.cu under `plan_bottleneck_f32` over the
    card's active clusters."""
    plan = plan_bottleneck_f32(*shape, card_clusters(x.device.index))
    return launch_f32("fused_bottleneck_f32", "fused_bottleneck_cuda", x, w1,
                      b1, w2, b2, w3, b3, shape, plan)


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
