"""The plan of csrc/fused_bottleneck.cu, on the CPU: how the wrapper cuts a
call into blocks (rows per block, warps across N, ring depth, y2 over y1)
and how much shared memory a block takes, at ResNet-50's four identity
stages (N = 320 frames, as on the main path) and at ragged test shapes.
The kernel's `Layout` is checked against `layout_bytes` at every launch on
the card; here the plan itself is held to what the kernel needs."""

import pytest

from tmrnet_torch.experimental.fused_bottleneck import (
    block_chunks,
    block_rows,
    layout_bytes,
    plan_bottleneck,
)

SMEM_BLOCK_MAX = 232448     # a Hopper block's opt-in maximum
SMEM_SM = 233472            # an SM's total; 1 KB of it is reserved per block

STAGES = [(320, 56, 56, 256, 64), (320, 28, 28, 512, 128),
          (320, 14, 14, 1024, 256), (320, 7, 7, 2048, 512)]
RAGGED = [(2, 56, 56, 256, 64), (1, 5, 9, 256, 64), (3, 1, 1, 128, 64),
          (1, 7, 7, 2048, 512), (4, 17, 14, 1024, 256),
          (64, 17, 14, 1024, 256), (3, 10, 13, 1024, 256),
          (2, 5, 30, 512, 128), (2, 13, 7, 64, 128), (1, 57, 56, 256, 64)]
SHAPES = STAGES + RAGGED


@pytest.mark.parametrize("n,h,w,c,p", SHAPES)
def test_plan_fits_one_block_per_sm(n, h, w, c, p):
    plan = plan_bottleneck(n, h, w, c, p)
    assert plan.smem == layout_bytes(w, p, plan.th, plan.wn, plan.nstage,
                                     plan.overlay)
    # __launch_bounds__(256, 1): one block of 256 threads per SM
    assert plan.smem <= SMEM_BLOCK_MAX
    assert plan.smem + 1024 <= SMEM_SM
    assert plan.nstage >= 3
    assert plan.wn in (1, 2, 4, 8)
    assert plan.bm * plan.nb == 8 * 64 * 64      # 8 warps of 64x64
    assert p % plan.nb == 0 and c % plan.nb == 0


@pytest.mark.parametrize("n,h,w,c,p", SHAPES)
def test_row_tiles_cover_every_output_row_once(n, h, w, c, p):
    plan = plan_bottleneck(n, h, w, c, p)
    covered = []
    for h0, rows, _, _ in block_rows(h, plan.th):
        assert 1 <= rows <= plan.th
        covered += range(h0, h0 + rows)
        # the block's GEMM row tiles hold all of its rows * w output pixels
        tiles = -(-rows * w // plan.bm)
        assert (tiles - 1) * plan.bm < rows * w <= tiles * plan.bm
    assert covered == list(range(h))
    assert -(-h // plan.th) == len(block_rows(h, plan.th))   # grid.x


@pytest.mark.parametrize("n,h,w,c,p", SHAPES)
def test_y1_tile_covers_its_halo(n, h, w, c, p):
    plan = plan_bottleneck(n, h, w, c, p)
    w2 = w + 2
    for h0, rows, lo, hi in block_rows(h, plan.th):
        # y1 holds image rows h0-1 .. h0+rows, cut at the image; the rows
        # outside the image are the conv's zero padding
        assert lo == max(h0 - 1, 0) and hi == min(h0 + rows + 1, h)
        need = {r for r in range(h0 - 1, h0 + rows + 1) if 0 <= r < h}
        assert set(range(lo, hi)) == need
        # every tap of every output pixel lands inside y1's wide grid of
        # (th + 2) x (w + 2) rows: tap (dy, dx) of (r, c) is row
        # (r + dy) * (w + 2) + c + dx
        last = (rows - 1 + 2) * w2 + (w - 1) + 2
        assert last < (plan.th + 2) * w2
        # y2 over y1 only where phase 2 is one tile and one pass
        if plan.overlay:
            assert rows * w <= plan.bm and plan.nb == p


@pytest.mark.parametrize("n,h,w,c,p", STAGES)
def test_stage_plans_read_each_a_chunk_once(n, h, w, c, p):
    """At ResNet-50's stages the block's tile spans all of P and each phase
    is one row tile, so every block streams each K chunk of A once: C/32
    chunks of x, 9P/32 of y1's taps, and C/P passes of P/32 over y2."""
    plan = plan_bottleneck(n, h, w, c, p)
    assert plan.nb == p
    for chunks in block_chunks(h, w, c, p, plan.th, plan.wn):
        assert chunks == (c + 9 * p + c) // 32


def test_plan_refuses_rows_too_wide_for_shared_memory():
    with pytest.raises(ValueError, match="does not fit"):
        plan_bottleneck(1, 4, 400, 256, 64)
