"""The f32 bottleneck kernel (csrc/fused_bottleneck_f32.cu on
csrc/bottleneck_f32.cuh, which both wrappers launch in f32), on the CPU:

- their plans (`plan_bottleneck_f32`, `plan_bottleneck_tiled_f32`): every
  ResNet-50 identity stage at N in {1, 7, 320, 2048} and ragged shapes fit
  one CTA per SM, in clusters of 2, 4 or 8 that divide the grid; the
  clusters' own pixels cover every output pixel once, their y1 slices
  cover R (the span and its halo) once, each inside its CTA's window; every
  3x3 neighbour a CTA's pixels read lies in its window and in R, so in its
  own slice or in another CTA's of the cluster (the DSMEM halo); at N =
  320 and 2048 at least 90% of the products fall on the call's own pixels
  and, at stages 3 and 4, the weights leave L2 at most a third as often as
  under the previous cut; rows too wide are refused; waves are counted
  over the card's own active clusters, skipping a size it runs none of;
- a numpy rehearsal of a cluster's index arithmetic on one flat array of
  shared memory a CTA, as `Layout` lays it out (NaN where nothing was
  written, so a read of a slot, row or halo the kernel never fills shows):
  each chunk's weight rows multicast by the CS CTAs into every CTA's slot
  (two halves of BN / 2), x's TMA box of BM rows from the slice's first
  (zero past N H W), y1 on the slice only, the other CTAs' slices copied
  into the window, the conv's taps as row choices with the zero row off
  the image, rows past a CTA's own clamped, y2 over y1 or not, phase 3's
  residual from x or staged; it must equal `fused_bottleneck_plain` within
  1e-5 (the same f32 products, summed in other orders), with relu(b1) >= 1
  so that y1 computed off the image would show, at spans that cross image
  boundaries, recompute y1 at a cluster's edges and leave CTAs idle;
- the dtype rule and both ops' fake implementations on fake CUDA tensors:
  f32 operands of ResNet-50's shapes pass, mixed bf16 / f32 and f64 raise
  TypeError;
- the folded f32 ResNet trunk through `torch.ops.tmrnet.*` against JAX's
  `apply_fused_resnet` with both Pallas kernels in interpret mode, for
  kernel "block" and "tiled", within 1e-4 (rtol and atol: f32 on both
  sides, summed in other orders by XLA and by PyTorch's CPU kernels).
"""

import functools

import jax
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

import tmrnet_torch.ops  # noqa: F401  (registers the ops)
import tmrnet_tpu.experimental.fused_resnet as jax_fr
from tests.test_fold_bn import _nontrivial_stats
from tmrnet_torch.experimental.fused_bottleneck import (
    F32_ACTIVE_CLUSTERS,
    F32_CLUSTERS,
    F32_TX,
    bottleneck_dtype,
    f32_cut,
    f32_layout,
    f32_layout_bytes,
    f32_stage_fits,
    fused_bottleneck_plain,
    plan_bottleneck_f32,
)
from tmrnet_torch.experimental.fused_bottleneck_tiled import (
    plan_bottleneck_tiled_f32,
)
from tmrnet_torch.models.convert import from_jax_variables
from tmrnet_torch.models.fold_bn import fold_resnet
from tmrnet_torch.models.resnet import ResNet
from tmrnet_tpu.experimental.fused_bottleneck import (
    fused_bottleneck as jax_fused_bottleneck,
)
from tmrnet_tpu.experimental.fused_bottleneck_tiled import (
    fused_bottleneck_tiled as jax_fused_bottleneck_tiled,
)
from tmrnet_tpu.models.fold_bn import fold_resnet as jax_fold_resnet
from tmrnet_tpu.models.resnet import ResNet as JaxResNet

torch.set_num_threads(2)

SMEM_BLOCK_MAX = 232448     # a Hopper block's opt-in maximum
SMEM_SM = 233472            # an SM's total; 1 KB of it is reserved per block
KC = 16                     # bottleneck_f32.cuh's K chunk

STAGES = [(56, 56, 256, 64), (28, 28, 512, 128), (14, 14, 1024, 256),
          (7, 7, 2048, 512)]
FRAMES = (1, 7, 320, 2048)
RAGGED = [(1, 5, 9, 256, 64), (3, 1, 1, 128, 64), (2, 13, 7, 64, 128),
          (1, 57, 56, 256, 64), (4, 17, 14, 1024, 256), (3, 10, 13, 1024, 256),
          (2, 5, 30, 512, 128), (1, 3, 100, 64, 64), (5, 7, 7, 2048, 512)]
SHAPES = [(n, *s) for s in STAGES for n in FRAMES] + RAGGED
PLANS = {"block": plan_bottleneck_f32, "tiled": plan_bottleneck_tiled_f32}
# The previous cut's weight bytes from L2 a launch at N = 320, stages 3
# and 4 (every 256-thread block streamed W1, W2 and W3 from L2 through its
# own ring, per its 4-row tile): the redesign's goal is at most a third.
PREVIOUS_WEIGHT_BYTES = {14: 6.71e9, 7: 12.75e9}


@pytest.mark.parametrize("kernel", sorted(PLANS))
@pytest.mark.parametrize("n,h,w,c,p", SHAPES)
def test_f32_plan_fits_one_block_per_sm(kernel, n, h, w, c, p):
    plan = PLANS[kernel](n, h, w, c, p)
    assert plan.smem == f32_layout_bytes(w, p, plan.tx, plan.rows,
                                         plan.nstage, plan.overlay)
    # __launch_bounds__(288, 1): one CTA per SM
    assert plan.smem <= SMEM_BLOCK_MAX
    assert plan.smem + 1024 <= SMEM_SM
    assert plan.tx in F32_TX and plan.bm * plan.bn == 256 * 64
    assert p % plan.bn == 0 and c % plan.bn == 0
    assert plan.nstage in (3, 4)
    # the grid is whole clusters; a CTA's own pixels are one tile
    assert plan.cs in F32_CLUSTERS and KC % plan.cs == 0
    assert plan.clusters == -(-n * h * w // plan.span)
    assert plan.waves == -(-plan.clusters // dict(F32_ACTIVE_CLUSTERS)[plan.cs])
    assert plan.rows == -(-plan.span // plan.cs) <= plan.bm
    assert not plan.overlay or p == plan.bn
    assert plan.staged == f32_stage_fits(w, p, plan.tx, plan.rows,
                                         plan.nstage, plan.overlay)
    assert 0 < plan.real_share <= 1
    assert plan.weight_bytes == plan.clusters * 4 * (2 * c * p + 9 * p * p)


def _clusters(plan, n, h, w):
    """Every cluster's (own, slices) under the plan, as the kernel cuts."""
    return [f32_cut(n * h * w, h, w, plan.span, plan.cs, k)
            for k in range(plan.clusters)]


@pytest.mark.parametrize("kernel", sorted(PLANS))
@pytest.mark.parametrize("n,h,w,c,p", SHAPES)
def test_f32_row_tiles_cover_every_output_row_once(kernel, n, h, w, c, p):
    plan = PLANS[kernel](n, h, w, c, p)
    npix, hw = n * h * w, h * w
    covered = 0
    for k, (own, slices) in enumerate(_clusters(plan, n, h, w)):
        # own pixels: consecutive, the cluster's span, at most a tile a CTA
        assert own[0] == covered == k * plan.span
        assert own[-1] == min(npix, (k + 1) * plan.span)
        sizes = np.diff(own)
        assert (sizes >= 0).all() and (sizes <= plan.rows).all()
        covered = own[-1]
        # slices: R (the span, w + 1 more each side in their images) split
        # into at most a tile each, each inside its CTA's window
        first, last = own[0], own[-1] - 1
        assert slices[0] == max(first - w - 1, first - first % hw)
        assert slices[-1] == min(last + w + 2, last - last % hw + hw)
        assert (np.diff(slices) >= 0).all()
        assert (np.diff(slices) <= plan.bm).all()
        for i in range(plan.cs):
            assert own[i] - w - 1 <= slices[i]
            assert slices[i + 1] <= own[i + 1] + w + 1
    assert covered == npix


@pytest.mark.parametrize("kernel", sorted(PLANS))
@pytest.mark.parametrize("n,h,w,c,p", SHAPES)
def test_f32_y1_tile_covers_its_halo(kernel, n, h, w, c, p):
    # Every 3x3 neighbour on the image of a CTA's own pixels lies in its
    # window (own pixels + w + 1 each side) and in R: its y1 is computed in
    # the CTA's slice or copied from another CTA's by DSMEM. Off the image
    # the tap reads the zero row (the halo trap). y1 computed twice is R's
    # part outside the span, and only inside an image.
    plan = PLANS[kernel](n, h, w, c, p)
    npix, hw = n * h * w, h * w
    cuts = _clusters(plan, n, h, w)
    picks = sorted({*range(min(3, len(cuts))), *range(len(cuts))[-3:],
                    *range(0, len(cuts), max(1, len(cuts) // 16))})
    for k in picks:
        own, slices = cuts[k]
        r0, r1 = slices[0], slices[-1]
        assert 0 <= r0 <= own[0] and own[-1] <= r1 <= npix
        if plan.span % hw == 0:
            assert (r0, r1) == (own[0], own[-1])
        for i in range(plan.cs):
            q = np.arange(own[i], own[i + 1])
            y, x = q % hw // w, q % w
            for dy in (-1, 0, 1):
                for dx in (-1, 0, 1):
                    on = (y + dy >= 0) & (y + dy < h) & (x + dx >= 0) & (
                        x + dx < w)
                    nb = (q + dy * w + dx)[on]
                    assert ((nb // hw) == (q[on] // hw)).all()
                    assert (nb >= own[i] - w - 1).all()
                    assert (nb < own[i + 1] + w + 1).all()
                    assert ((nb >= r0) & (nb < r1)).all()
        # the recomputed halo: R outside the span, in the span's images
        extra = (own[0] - r0) + (r1 - own[-1])
        assert extra <= 2 * (w + 1)
        assert r0 // hw == own[0] // hw
        assert (r1 - 1) // hw == (own[-1] - 1) // hw


# (the tiled path sends stage 4 to the block kernel)
@pytest.mark.parametrize("n", [320, 2048])
@pytest.mark.parametrize("kernel,h,w,c,p", [
    (k, *s) for k in sorted(PLANS) for s in STAGES
    if k == "block" or s[2] < 2048])
def test_f32_plan_real_share_and_weight_bytes(kernel, n, h, w, c, p):
    plan = PLANS[kernel](n, h, w, c, p)
    # products on the call's own pixels over all products the CTAs run
    assert plan.real_share == pytest.approx(
        n * h * w / (plan.clusters * plan.cs * plan.bm))
    assert plan.real_share >= 0.90
    if n == 320 and h in PREVIOUS_WEIGHT_BYTES:
        assert plan.weight_bytes <= PREVIOUS_WEIGHT_BYTES[h] / 3


def test_f32_plans_refuse_rows_too_wide():
    with pytest.raises(ValueError, match="does not fit"):
        plan_bottleneck_f32(1, 4, 400, 256, 64)
    with pytest.raises(ValueError, match="W = 257"):
        plan_bottleneck_tiled_f32(1, 2, 257, 64, 64)
    with pytest.raises(ValueError, match="does not fit"):
        plan_bottleneck_tiled_f32(1, 4, 200, 1024, 1024)


# Cards other than the H100 SXM of F32_ACTIVE_CLUSTERS, as `card_clusters`
# reads them: fewer SMs (114), a slice that runs no cluster of 8, one that
# runs a single cluster of 2 at a time.
@pytest.mark.parametrize("kernel", sorted(PLANS))
@pytest.mark.parametrize("active", [((8, 14), (4, 28), (2, 57)),
                                    ((8, 0), (4, 7), (2, 14)),
                                    ((8, 0), (4, 0), (2, 1))])
@pytest.mark.parametrize("n,h,w,c,p", [(320, *s) for s in STAGES]
                         + RAGGED[:3])
def test_f32_plan_counts_waves_over_the_cards_clusters(kernel, active, n, h,
                                                       w, c, p):
    plan = PLANS[kernel](n, h, w, c, p, active)
    counts = dict(active)
    assert counts[plan.cs] > 0
    assert plan.waves == -(-plan.clusters // counts[plan.cs])
    assert plan.clusters == -(-n * h * w // plan.span)
    assert plan.rows == -(-plan.span // plan.cs) <= plan.bm
    assert plan.smem == f32_layout_bytes(w, p, plan.tx, plan.rows,
                                         plan.nstage, plan.overlay)


def test_f32_plans_refuse_a_card_that_runs_no_cluster():
    for plan in PLANS.values():
        with pytest.raises(ValueError, match="runs no cluster"):
            plan(2, 14, 14, 1024, 256, ((8, 0), (4, 0), (2, 0)))


def _rehearse(x, w1, b1, w2, b2, w3, b3, tx, cs, span, nstage, overlay,
              staged):
    """bottleneck_f32.cuh's `bottleneck_block` on numpy, a cluster at a
    time: each CTA's shared memory one flat f32 array, NaN until written;
    each chunk multicast into every CTA's ring slot, y1's halo copied
    between the CTAs' arrays, everything read back through the kernel's
    offsets."""
    n_img, h, w, c = x.shape
    p = w1.shape[1]
    npix, hw = n_img * h * w, h * w
    rows = -(-span // cs)
    lay = f32_layout(w, p, tx, rows, nstage, overlay)
    bm, bn, ldy = lay["bm"], lay["bn"], lay["ldy"]
    half, share = bn // 2, KC // cs
    assert lay["total"] <= SMEM_BLOCK_MAX and rows <= bm
    assert not staged or f32_stage_fits(w, p, tx, rows, nstage, overlay)
    relu = lambda t: np.maximum(t, 0.0)
    xf = x.reshape(npix, c)
    out = np.full((npix, c), np.nan, np.float32)
    w2m = w2.reshape(9 * p, p)
    k = np.arange(KC)
    kc1, kc2, kc3 = c // KC, 9 * p // KC, p // KC
    n1 = (p // bn) * kc1
    n12 = n1 + (p // bn) * kc2

    def chunk(g):
        """Chunk g's weight, rows and first column, as the producer's."""
        if g < n1:
            return w1, g % kc1, g // kc1 * bn
        if g < n12:
            return w2m, (g - n1) % kc2, (g - n1) // kc2 * bn
        return w3, (g - n12) % kc3, (g - n12) // kc3 * bn

    for cl in range(-(-npix // span)):
        own, slices = f32_cut(npix, h, w, span, cs, cl)
        sms = [np.full(lay["total"] // 4, np.nan, np.float32)
               for _ in range(cs)]
        for sm in sms:
            sm[lay["zero"]:lay["zero"] + ldy] = 0.0
        g = 0       # chunks consumed, the same in every CTA

        def land(g):
            """Chunk g into slot g % nstage of every CTA: rank j's KC / cs
            weight rows multicast into all, as two halves; each CTA's own
            x box (phase 1), rows from its slice's first."""
            wm, kk, col = chunk(g)
            slot = g % nstage * lay["slot"]
            for j in range(cs):
                rws = slice(kk * KC + j * share, kk * KC + (j + 1) * share)
                for hh in range(2):
                    box = wm[rws, col + hh * half:col + (hh + 1) * half]
                    at = slot + lay["a_part"] + (hh * KC + j * share) * half
                    for sm in sms:
                        sm[at:at + box.size] = box.reshape(-1)
            if g < n1:
                for i, sm in enumerate(sms):
                    box = np.zeros((bm, KC), np.float32)
                    r = np.arange(slices[i], slices[i] + bm)
                    ok = r < npix
                    box[ok] = xf[r[ok], kk * KC:(kk + 1) * KC]
                    sm[slot:slot + bm * KC] = box.reshape(-1)

        def product(sm, g, a_rows, koff):
            """acc += A (rows at flat offsets a_rows + koff + k) times
            chunk g's slot, read as the kernel's mma_chunk reads it."""
            slot = g % nstage * lay["slot"] + lay["a_part"]
            a = sm[(a_rows + koff)[:, None] + k]
            b = np.concatenate([
                sm[slot + hh * KC * half + k[:, None] * half
                   + np.arange(half)] for hh in range(2)], axis=1)
            return a @ b

        ty = np.arange(bm)
        accs = [None] * cs
        # phase 1: y1 on each CTA's slice
        for n0 in range(0, p, bn):
            accs = [np.zeros((bm, bn), np.float32) for _ in range(cs)]
            for kk in range(kc1):
                land(g)
                for i, sm in enumerate(sms):
                    accs[i] += product(sm, g, g % nstage * lay["slot"]
                                       + ty * KC, 0)
                g += 1
            for i, sm in enumerate(sms):
                r = ty[ty < slices[i + 1] - slices[i]]
                win = own[i] - w - 1
                dst = lay["y1"] + (slices[i] + r - win) * ldy
                sm[dst[:, None] + n0 + np.arange(bn)] = relu(
                    accs[i][r] + b1[n0:n0 + bn])
        # the halo, by DSMEM: the window's pixels in the other slices
        for i, sm in enumerate(sms):
            win, hi = own[i] - w - 1, own[i + 1] + w + 1
            for j in range(cs):
                if j == i:
                    continue
                lo = max(slices[j], win)
                cnt = min(slices[j + 1], hi) - lo
                if cnt <= 0:
                    continue
                win_j = own[j] - w - 1
                src = lay["y1"] + (lo - win_j + np.arange(cnt)) * ldy
                dst = lay["y1"] + (lo - win + np.arange(cnt)) * ldy
                sm[dst[:, None] + np.arange(p)] = sms[j][src[:, None]
                                                         + np.arange(p)]
        # phase 2: 9 taps of P; rows past a CTA's own clamped; taps off
        # the image on the zero row
        pk = []
        for i in range(cs):
            cnt = own[i + 1] - own[i]
            r = np.minimum(ty, max(cnt - 1, 0))
            pos = (own[i] + r) % hw
            pk.append((w + 1 + r, pos // w, pos % w))
        for n0 in range(0, p, bn):
            accs = [np.zeros((bm, bn), np.float32) for _ in range(cs)]
            for tap in range(9):
                dy, dx = divmod(tap, 3)
                for kk in range(0, p, KC):
                    land(g)
                    for i, sm in enumerate(sms):
                        wrow, yy, xx = pk[i]
                        on = ((yy + dy - 1 >= 0) & (yy + dy - 1 < h)
                              & (xx + dx - 1 >= 0) & (xx + dx - 1 < w))
                        a_rows = np.where(on, lay["y1"] + (
                            wrow + (dy - 1) * w + dx - 1) * ldy, lay["zero"])
                        accs[i] += product(sm, g, a_rows, kk)
                    g += 1
            for i, sm in enumerate(sms):
                r = ty[ty < own[i + 1] - own[i]]
                dst = (lay["y2"] + r * ldy)[:, None] + n0 + np.arange(bn)
                sm[dst] = relu(accs[i][r] + b2[n0:n0 + bn])
        # phase 3: C in passes of bn; the residual from x, or staged
        for n0 in range(0, c, bn):
            accs = [np.zeros((bm, bn), np.float32) for _ in range(cs)]
            ldr = bn + 4
            for i, sm in enumerate(sms):
                cnt = own[i + 1] - own[i]
                if staged and cnt:
                    dst = lay["res"] + np.arange(cnt)[:, None] * ldr
                    sm[dst + np.arange(bn)] = xf[own[i]:own[i + 1],
                                                 n0:n0 + bn]
            for kk in range(kc3):
                land(g)
                for i, sm in enumerate(sms):
                    cnt = own[i + 1] - own[i]
                    a_rows = lay["y2"] + np.minimum(ty, max(cnt - 1, 0)) * ldy
                    accs[i] += product(sm, g, a_rows, kk * KC)
                g += 1
            for i, sm in enumerate(sms):
                r = ty[ty < own[i + 1] - own[i]]
                if staged:
                    res = sm[(lay["res"] + r * ldr)[:, None] + np.arange(bn)]
                else:
                    res = xf[own[i] + r, n0:n0 + bn]
                out[own[i] + r, n0:n0 + bn] = relu(accs[i][r]
                                                   + b3[n0:n0 + bn] + res)
        assert g == n12 + (c // bn) * kc3
    return out.reshape(x.shape)


def _bottleneck_inputs(n, h, w, c, p, seed):
    rng = np.random.default_rng(seed)
    x = np.maximum(rng.standard_normal((n, h, w, c)), 0).astype(np.float32)
    ws = (rng.standard_normal((c, p)).astype(np.float32) * (2.0 / c) ** 0.5,
          np.abs(rng.standard_normal(p)).astype(np.float32) + 1.0,  # halo trap
          rng.standard_normal((3, 3, p, p)).astype(np.float32)
          * (2.0 / (9 * p)) ** 0.5,
          rng.standard_normal(p).astype(np.float32) * 0.1,
          rng.standard_normal((p, c)).astype(np.float32) * (2.0 / p) ** 0.5,
          rng.standard_normal(c).astype(np.float32) * 0.1)
    return x, ws


# The plans at small shapes, then forced (tx, cs, span, nstage, overlay):
# spans that cross image boundaries and recompute y1 at clusters' edges,
# clusters of 2, 4 and 8, CTAs without pixels (one-pixel images, a short
# last span), several column passes (P > bn) and C / bn phase-3 passes,
# y2 over y1, both ring depths, W + 1 beyond a CTA's own pixels, phase 3's
# residual staged and (y2 over y1 with no room left) from x.
@pytest.mark.parametrize("kernel,n,h,w,c,p,forced", [
    ("block", 2, 5, 9, 128, 64, None), ("tiled", 2, 5, 9, 128, 64, None),
    ("block", 2, 13, 7, 64, 128, None), ("tiled", 2, 13, 7, 64, 128, None),
    ("block", 1, 3, 100, 64, 64, (8, 2, 300, 4, True)),
    ("block", 3, 1, 1, 128, 64, None),
    ("block", 1, 6, 5, 256, 128, (8, 4, 23, 3, False)),
    ("tiled", 1, 6, 5, 256, 128, (16, 4, 17, 3, False)),
    ("tiled", 2, 7, 6, 256, 128, (8, 8, 40, 4, False)),
    ("tiled", 1, 4, 3, 512, 256, (16, 2, 5, 3, False)),
    ("block", 3, 4, 4, 128, 64, (8, 8, 20, 3, True)),
    ("tiled", 3, 1, 1, 128, 64, (8, 8, 2, 3, False)),
    ("block", 2, 5, 2, 128, 64, (8, 2, 20, 3, True)),
    ("tiled", 3, 5, 3, 128, 64, (8, 4, 40, 4, True))])
def test_f32_rehearsal_of_the_index_arithmetic_matches_plain(
        kernel, n, h, w, c, p, forced):
    x, ws = _bottleneck_inputs(n, h, w, c, p, n * 100 + h * 10 + w)
    if forced is None:
        plan = PLANS[kernel](n, h, w, c, p)
        forced = (plan.tx, plan.cs, plan.span, plan.nstage, plan.overlay)
    tx, cs, span, nstage, overlay = forced
    rows = -(-span // cs)
    assert p % (8 * tx) == 0 and c % (8 * tx) == 0
    assert rows <= 2048 // tx
    assert (span if span % (h * w) == 0 else span + 2 * w + 2) <= cs * (
        2048 // tx)
    staged = f32_stage_fits(w, p, tx, rows, nstage, overlay)
    got = _rehearse(x, *ws, tx, cs, span, nstage, overlay, staged)
    want = fused_bottleneck_plain(torch.from_numpy(x),
                                  *map(torch.from_numpy, ws)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtypes,ok", [
    ((torch.bfloat16,) * 4, True), ((torch.float32,) * 4, True),
    ((torch.float32, torch.bfloat16, torch.float32, torch.float32), False),
    ((torch.bfloat16, torch.float32, torch.float32, torch.float32), False),
    ((torch.float64,) * 4, False), ((torch.float16,) * 4, False)])
def test_bottleneck_dtype_rule(dtypes, ok):
    if ok:
        assert bottleneck_dtype(dtypes[0], dtypes[1:]) == dtypes[0]
    else:
        with pytest.raises(TypeError, match="one dtype"):
            bottleneck_dtype(dtypes[0], dtypes[1:])


def _fake_operands(n, h, w, c, p, dtype, bias=torch.float32):
    shapes = ((n, h, w, c), (c, p), (p,), (3, 3, p, p), (p,), (p, c), (c,))
    return tuple(torch.empty(s, dtype=bias if len(s) == 1 else dtype,
                             device="cuda") for s in shapes)


@pytest.mark.parametrize("name", ["fused_bottleneck", "fused_bottleneck_tiled"])
@pytest.mark.parametrize("h,w,c,p", STAGES)
def test_f32_fake_cuda_operands_take_the_kernels_checks(name, h, w, c, p):
    op = getattr(torch.ops.tmrnet, name).default
    with FakeTensorMode():
        args = _fake_operands(320, h, w, c, p, torch.float32)
        out = op(*args)
        assert out.device.type == "cuda" and out.shape == args[0].shape
        assert out.dtype == torch.float32
        # mixed bf16 / f32: x, then a weight
        with pytest.raises(TypeError, match="dtype"):
            op(args[0].bfloat16(), *args[1:])
        with pytest.raises(TypeError, match="dtype"):
            op(args[0], args[1], args[2], args[3].bfloat16(), *args[4:])
        # f64 operands, and f32 biases refused under f64 weights alike
        with pytest.raises(TypeError, match="dtype"):
            op(*_fake_operands(2, h, w, c, p, torch.float64))
        # an f32 bias in bf16
        with pytest.raises(TypeError, match="dtype"):
            op(*args[:2], args[2].bfloat16(), *args[3:])


def _folded_trunk(kernel, monkeypatch):
    """JAX's apply_fused_resnet with both Pallas kernels in interpret mode,
    and the port's folded ResNet on the same folded weights, in f32."""
    stage_sizes, width = (2, 2), 8
    x = np.random.default_rng(11).standard_normal((3, 32, 32, 3)).astype(
        np.float32)
    model = JaxResNet(stage_sizes=stage_sizes, width=width)
    variables = _nontrivial_stats(model.init(jax.random.PRNGKey(4), x))
    folded = jax_fold_resnet(variables["params"], variables["batch_stats"])
    monkeypatch.setattr(jax_fr, "fused_bottleneck", functools.partial(
        jax_fused_bottleneck, interpret=True))
    monkeypatch.setattr(jax_fr, "fused_bottleneck_tiled", functools.partial(
        jax_fused_bottleneck_tiled, interpret=True))
    want = np.asarray(jax_fr.apply_fused_resnet(
        folded, x, stage_sizes, use_fused=True, kernel=kernel))
    state = from_jax_variables(jax.tree_util.tree_map(np.asarray, variables))
    port = ResNet(stage_sizes, width, folded=True, kernel=kernel)
    port.load_state_dict(fold_resnet(state), strict=True)
    return port.eval(), x, want


@pytest.mark.parametrize("kernel,ops", [
    ("block", {"fused_bottleneck": 2}),
    ("tiled", {"fused_bottleneck_tiled": 2})])
def test_folded_f32_trunk_matches_apply_fused_resnet(kernel, ops, monkeypatch):
    from tmrnet_torch.models import resnet as port_resnet

    port, x, want = _folded_trunk(kernel, monkeypatch)
    # the identity blocks (stage 1's second, stage 2's second) go through
    # the ops torch.ops.tmrnet.*
    calls = {}
    for name in ("fused_bottleneck", "fused_bottleneck_tiled"):
        op = getattr(port_resnet, name)
        assert op is getattr(torch.ops.tmrnet, name).default

        def counted(*a, name=name, op=op):
            calls[name] = calls.get(name, 0) + 1
            return op(*a)
        monkeypatch.setattr(port_resnet, name, counted)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert calls == ops
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
