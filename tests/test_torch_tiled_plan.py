"""The plan of csrc/fused_bottleneck_tiled.cu, on the CPU: how the wrapper
cuts a call into blocks (rows per block, warps across N, image rows per
phase-1 box of x, ring depth, y2 over y1), what each TMA box and each
mbarrier's expected bytes are, and how much shared memory a block takes, at
ResNet-50's identity stages (N = 320 frames, as on the main path) and at
the card tests' ragged shapes. The kernel's `Layout` is checked against
`tiled_layout_bytes` at every launch on the card.

Last, a numpy rehearsal of the kernel's index arithmetic -- boxes of x
zero-filled off the image, phase 1's rows put on the wide (th + 2) x (w + 2)
grid with its halo and pad zeroed, the conv's taps as row offsets into it,
rows past a tile clamped, phase 3's residual boxes and stores dropped off
the image -- computes small bottlenecks in f32 that must equal
`fused_bottleneck_plain` (1e-5: the same products, summed in other
orders)."""

import numpy as np
import pytest
import torch

from tmrnet_torch.experimental.fused_bottleneck_tiled import (
    chunk_boxes,
    chunk_tx_bytes,
    fused_bottleneck_plain,
    plan_bottleneck_tiled,
    tiled_blocks,
    tiled_layout_bytes,
)

SMEM_BLOCK_MAX = 232448     # a Hopper block's opt-in maximum
SMEM_SM = 233472            # an SM's total; 1 KB of it is reserved per block
BOX_MAX = 256               # a TMA box's longest side

STAGES = [(320, 56, 56, 256, 64), (320, 28, 28, 512, 128),
          (320, 14, 14, 1024, 256), (320, 7, 7, 2048, 512)]
RAGGED = [(2, 56, 56, 256, 64), (2, 28, 28, 512, 128), (2, 14, 14, 1024, 256),
          (2, 7, 7, 2048, 512), (1, 57, 56, 256, 64), (1, 29, 28, 512, 128),
          (1, 5, 9, 256, 64), (3, 1, 1, 128, 64), (2, 13, 7, 64, 128),
          (300, 14, 14, 1024, 256), (3, 10, 13, 1024, 256),
          (2, 5, 29, 512, 128), (1, 6, 100, 512, 128), (1, 5, 7, 1024, 1024),
          (1, 3, 256, 128, 64)]
SHAPES = STAGES + RAGGED


@pytest.mark.parametrize("n,h,w,c,p", SHAPES)
def test_plan_fits_one_block_per_sm(n, h, w, c, p):
    plan = plan_bottleneck_tiled(n, h, w, c, p)
    assert plan.smem == tiled_layout_bytes(w, p, plan.th, plan.wn, plan.r,
                                           plan.nstage, plan.nres, plan.overlay)
    # __launch_bounds__(256, 1): one block of 256 threads per SM
    assert plan.smem <= SMEM_BLOCK_MAX
    assert plan.smem + 1024 <= SMEM_SM
    assert plan.nstage >= 3 and plan.nres in (1, 2)
    if plan.nres == 2:                  # a second buffer only for a next pass
        assert c > plan.nb
    assert plan.wn in (1, 2, 4, 8)
    assert plan.bm * plan.nb == 8 * 64 * 64      # 8 warps of 64x64
    assert p % plan.nb == 0 and c % plan.nb == 0
    # phases 2-3 are one row tile; a phase-1 box fits the block tile
    assert plan.th * w <= plan.bm
    assert 1 <= plan.r and plan.r * w <= plan.bm
    # y2 over y1 only where phase 2 is one column pass
    if plan.overlay:
        assert plan.nb == p


@pytest.mark.parametrize("n,h,w,c,p", SHAPES)
def test_row_tiles_cover_every_output_row_once(n, h, w, c, p):
    plan = plan_bottleneck_tiled(n, h, w, c, p)
    covered = []
    for h0, rows, _ in tiled_blocks(h, plan.th, plan.r):
        assert 1 <= rows <= plan.th
        covered += range(h0, h0 + rows)
    assert covered == list(range(h))
    assert -(-h // plan.th) == len(tiled_blocks(h, plan.th, plan.r))  # grid.x


@pytest.mark.parametrize("n,h,w,c,p", SHAPES)
def test_phase1_boxes_cover_the_halo(n, h, w, c, p):
    plan = plan_bottleneck_tiled(n, h, w, c, p)
    for h0, rows, boxes in tiled_blocks(h, plan.th, plan.r):
        # the boxes hold image rows h0 - 1 .. h0 + rows in order, r each,
        # the last one reaching at most r - 1 rows past them
        got = [b + i for b in boxes for i in range(plan.r)]
        need = list(range(h0 - 1, h0 + rows + 1))
        assert got[:len(need)] == need
        assert len(got) - len(need) < plan.r
        # y1's wide grid holds exactly the halo'd tile
        assert (rows + 2) * (w + 2) <= (plan.th + 2) * (w + 2)
    # every box side is at most 256 elements; the swizzled boxes' inner
    # side is the swizzle's span (x: 32 channels = 64 bytes, 64-byte
    # swizzle; weights and residual: 64 = 128 bytes, 128-byte swizzle)
    for phase in (0, 1, 2, "residual"):
        for shape, _ in chunk_boxes(phase, w, plan.th, plan.wn, plan.r):
            assert all(1 <= s <= BOX_MAX for s in shape), shape
            assert shape[0] * 2 in (64, 128)


@pytest.mark.parametrize("n,h,w,c,p", SHAPES)
def test_expect_tx_equals_the_bytes_of_the_boxes(n, h, w, c, p):
    plan = plan_bottleneck_tiled(n, h, w, c, p)
    a_stage = -(-plan.r * w * 64 // 1024) * 1024
    for phase in (0, 1, 2, "residual"):
        boxes = chunk_boxes(phase, w, plan.th, plan.wn, plan.r)
        tx = chunk_tx_bytes(phase, w, plan.th, plan.wn, plan.r)
        assert tx == sum(nbytes for _, nbytes in boxes)
        assert tx < 2 ** 20            # an mbarrier's transaction count
    # the weight boxes fill a slot's B part; x's box its A part; the
    # residual boxes fit the A parts of the ring
    weights = [b for s, b in chunk_boxes(1, w, plan.th, plan.wn, plan.r)]
    assert sum(weights) == 32 * plan.nb * 2
    x_box = chunk_boxes(0, w, plan.th, plan.wn, plan.r)[-1][1]
    assert x_box <= a_stage and a_stage % 1024 == 0
    res = chunk_tx_bytes("residual", w, plan.th, plan.wn, plan.r)
    res_boxes = plan.nres * plan.wn * -(-plan.th * w * 128 // 1024) * 1024
    assert res <= res_boxes <= plan.smem - 1024


@pytest.mark.parametrize("w", [257, 300])
def test_plan_refuses_rows_wider_than_a_box(w):
    with pytest.raises(ValueError, match="256"):
        plan_bottleneck_tiled(1, 4, w, 128, 64)


def test_plan_refuses_rows_too_wide_for_shared_memory():
    with pytest.raises(ValueError, match="does not fit"):
        plan_bottleneck_tiled(1, 6, 100, 512, 512)


def _rehearse(x, w1, b1, w2, b2, w3, b3, th, wn, r):
    """The kernel's blocks in numpy, f32, following its index arithmetic.
    Shared-memory tiles start as NaN, so a read of a row no step wrote
    shows in the result."""
    n, h, w, c = x.shape
    p = w1.shape[1]
    w2_, bm, nb = w + 2, 64 * (8 // wn), 64 * wn
    relu = lambda v: np.maximum(v, 0.0)
    out = np.full_like(x, np.nan)
    xpad = np.zeros((n, h + 2 * (th + r) + 2, w, c), np.float32)
    off = th + r + 1        # image row 0 of xpad: TMA's zero fill off the image
    xpad[:, off:off + h] = x
    for img in range(n):
        for h0, rows, boxes in tiled_blocks(h, th, r):
            m1, m2, rw, mr = (rows + 2) * w, rows * w, r * w, th * w
            y1 = np.full(((th + 2) * w2_, p), np.nan, np.float32)
            pad = np.arange(th + 2) * w2_
            y1[pad] = y1[pad + w + 1] = 0.0     # the pad columns, per block
            for mt, hb in enumerate(boxes):
                # box (32-channel chunks, w columns, r rows from hb)
                box = xpad[img, off + hb:off + hb + r].reshape(rw, c)
                a = box[np.minimum(np.arange(bm), rw - 1)]   # clamped rows
                acc = a @ w1 + b1
                m = np.arange(bm)
                mc = mt * rw + m
                ok = (m < rw) & (mc < m1)
                hr = mc // w
                hh = h0 - 1 + hr
                inside = (hh >= 0) & (hh < h)
                y1[(mc + 2 * hr + 1)[ok]] = np.where(inside[ok, None],
                                                     relu(acc[ok]), 0.0)
            # phase 2: compact output rows, taps as wide-grid row offsets
            m = np.minimum(np.arange(bm), m2 - 1)
            base = (m // w) * w2_ + m % w
            acc = b2 + sum(y1[base + dy * w2_ + dx] @ w2[dy, dx]
                           for dy in range(3) for dx in range(3))
            y2 = np.full((mr, p), np.nan, np.float32)
            y2[:m2] = relu(acc[:m2])
            # phase 3: C / nb passes; the residual boxes (64 channels x w x
            # th rows from h0) zero off the image; the store drops those rows
            a = y2[np.minimum(np.arange(bm), m2 - 1)]
            res = xpad[img, off + h0:off + h0 + th].reshape(mr, c)
            for n0 in range(0, c, nb):
                tile = relu(a[:mr] @ w3[:, n0:n0 + nb] + b3[n0:n0 + nb]
                            + res[:, n0:n0 + nb])
                keep = h0 + np.arange(mr) // w < h
                rr = h0 + np.arange(mr)[keep] // w
                out[img, rr, np.arange(mr)[keep] % w, n0:n0 + nb] = tile[keep]
    return out


# The plan at small shapes; then forced plans with several phase-1 boxes,
# partial last tiles, W + 2 not dividing the block tile, several column
# passes in phases 1-2 (P > nb) and in phase 3.
@pytest.mark.parametrize("n,h,w,c,p,forced", [
    (2, 5, 9, 128, 64, None), (2, 13, 7, 64, 128, None),
    (2, 7, 9, 128, 64, (3, 1, 2)), (1, 6, 13, 256, 128, (4, 2, 3)),
    (1, 4, 6, 128, 128, (3, 1, 3)), (1, 3, 5, 512, 512, (2, 8, 1))])
def test_rehearsal_of_the_index_arithmetic_matches_plain(n, h, w, c, p, forced):
    rng = np.random.default_rng(n * 100 + h * 10 + w)
    x = np.maximum(rng.standard_normal((n, h, w, c)), 0).astype(np.float32)
    ws = (rng.standard_normal((c, p)).astype(np.float32) * (2.0 / c) ** 0.5,
          np.abs(rng.standard_normal(p)).astype(np.float32) + 1.0,  # halo trap
          rng.standard_normal((3, 3, p, p)).astype(np.float32) * (2.0 / (9 * p)) ** 0.5,
          rng.standard_normal(p).astype(np.float32) * 0.1,
          rng.standard_normal((p, c)).astype(np.float32) * (2.0 / p) ** 0.5,
          rng.standard_normal(c).astype(np.float32) * 0.1)
    if forced is None:
        plan = plan_bottleneck_tiled(n, h, w, c, p)
        th, wn, r = plan.th, plan.wn, plan.r
    else:
        th, wn, r = forced
    assert th * w <= 64 * (8 // wn) and r * w <= 64 * (8 // wn)
    got = _rehearse(x, *ws, th, wn, r)
    want = fused_bottleneck_plain(torch.from_numpy(x),
                                  *map(torch.from_numpy, ws)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
