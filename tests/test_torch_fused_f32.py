"""The f32 bottleneck kernels (csrc/fused_bottleneck_f32.cu and
csrc/fused_bottleneck_tiled_f32.cu, both on csrc/bottleneck_f32.cuh), on
the CPU:

- their plans (`plan_bottleneck_f32`, `plan_bottleneck_tiled_f32`): every
  ResNet-50 identity stage at N in {1, 7, 320, 2048} fits one block per
  SM; every output row is covered once; each tile's y1 covers its halo;
  rows too wide are refused;
- a numpy rehearsal of the block's index arithmetic on one flat array of
  its shared memory, as `Layout` lays it out (NaN where nothing was
  written, so a read of a slot, row or halo the kernel never fills shows):
  the ring's x rows zero-filled past the tile, y1's compact rows with its
  halo off the image zeroed and its zero row, the conv's taps as row
  choices, rows past a tile clamped, phase 3's residual from x or staged
  over y1; it must equal `fused_bottleneck_plain` within 1e-5 (the same
  f32 products, summed in other orders);
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
    F32_TX,
    block_rows,
    bottleneck_dtype,
    f32_layout_bytes,
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
KC, LDA = 16, 20            # bottleneck_f32.cuh's K chunk and x row pitch

STAGES = [(56, 56, 256, 64), (28, 28, 512, 128), (14, 14, 1024, 256),
          (7, 7, 2048, 512)]
FRAMES = (1, 7, 320, 2048)
RAGGED = [(1, 5, 9, 256, 64), (3, 1, 1, 128, 64), (2, 13, 7, 64, 128),
          (1, 57, 56, 256, 64), (4, 17, 14, 1024, 256), (3, 10, 13, 1024, 256),
          (2, 5, 30, 512, 128), (1, 3, 100, 64, 64), (5, 7, 7, 2048, 512)]
SHAPES = [(n, *s) for s in STAGES for n in FRAMES] + RAGGED
PLANS = {"block": plan_bottleneck_f32, "tiled": plan_bottleneck_tiled_f32}


@pytest.mark.parametrize("kernel", sorted(PLANS))
@pytest.mark.parametrize("n,h,w,c,p", SHAPES)
def test_f32_plan_fits_one_block_per_sm(kernel, n, h, w, c, p):
    plan = PLANS[kernel](n, h, w, c, p)
    assert plan.smem == f32_layout_bytes(w, p, plan.th, plan.tx, plan.nstage)
    # __launch_bounds__(256, 1): one block of 256 threads per SM
    assert plan.smem <= SMEM_BLOCK_MAX
    assert plan.smem + 1024 <= SMEM_SM
    assert plan.tx in F32_TX and plan.bm * plan.bn == 256 * 64
    assert p % plan.bn == 0 and c % plan.bn == 0
    if kernel == "block":
        assert plan.nstage == 2
    else:
        # phases 2-3 one row tile (the staged residual's), a 2- or 3-slot
        # ring, the residual over y1
        assert plan.nstage in (2, 3) and plan.th * w <= plan.bm
        assert plan.th * w * (plan.bn + 4) <= (plan.th + 2) * w * (p + 4)


@pytest.mark.parametrize("kernel", sorted(PLANS))
@pytest.mark.parametrize("n,h,w,c,p", SHAPES)
def test_f32_row_tiles_cover_every_output_row_once(kernel, n, h, w, c, p):
    plan = PLANS[kernel](n, h, w, c, p)
    covered = []
    for h0, rows, _, _ in block_rows(h, plan.th):
        assert 1 <= rows <= plan.th
        covered += range(h0, h0 + rows)
    assert covered == list(range(h))
    assert -(-h // plan.th) == len(block_rows(h, plan.th))   # grid.x


@pytest.mark.parametrize("kernel", sorted(PLANS))
@pytest.mark.parametrize("n,h,w,c,p", SHAPES)
def test_f32_y1_tile_covers_its_halo(kernel, n, h, w, c, p):
    plan = PLANS[kernel](n, h, w, c, p)
    for h0, rows, lo, hi in block_rows(h, plan.th):
        # phase 1 computes the image rows h0-1 .. h0+rows cut at the image,
        # into y1's tile rows lo - (h0 - 1) ..; the rows off the image are
        # the zeroed halo
        need = {r for r in range(h0 - 1, h0 + rows + 1) if 0 <= r < h}
        assert set(range(lo, hi)) == need
        assert 0 <= lo - (h0 - 1) and hi - (h0 - 1) <= plan.th + 2
        # the last tap of the last output pixel lies inside y1's rows
        assert (rows - 1 + 2) * w + (w - 1) < (plan.th + 2) * w


def test_f32_plans_refuse_rows_too_wide():
    with pytest.raises(ValueError, match="does not fit"):
        plan_bottleneck_f32(1, 4, 400, 256, 64)
    with pytest.raises(ValueError, match="W = 257"):
        plan_bottleneck_tiled_f32(1, 2, 257, 64, 64)
    with pytest.raises(ValueError, match="does not fit"):
        plan_bottleneck_tiled_f32(1, 4, 200, 1024, 1024)


def _layout(w, p, th, tx, nstage):
    """bottleneck_f32.cuh's `Layout`, offsets in floats."""
    bm, bn, ldy = 2048 // tx, 8 * tx, p + 4
    a_stage = bm * LDA
    slot = a_stage + KC * bn
    y1 = nstage * slot
    zero = y1 + (th + 2) * w * ldy
    y2 = zero + ldy
    return dict(bm=bm, bn=bn, ldy=ldy, a_stage=a_stage, slot=slot, y1=y1,
                zero=zero, y2=y2, total=(y2 + th * w * ldy) * 4)


def _rehearse(x, w1, b1, w2, b2, w3, b3, th, tx, nstage, staged):
    """bottleneck_f32.cuh's `bottleneck_block` on numpy: each block's shared
    memory one flat f32 array, NaN until written; each chunk copied into
    its ring slot and read back through the kernel's row offsets."""
    n_img, h, w, c = x.shape
    p = w1.shape[1]
    lay = _layout(w, p, th, tx, nstage)
    bm, bn, ldy = lay["bm"], lay["bn"], lay["ldy"]
    assert lay["total"] <= SMEM_BLOCK_MAX
    relu = lambda t: np.maximum(t, 0.0)
    out = np.full(x.shape, np.nan, np.float32)
    w2m = w2.reshape(9 * p, p)
    k = np.arange(KC)

    def ring(nk, issue, a_rows):
        """The K loop: chunk cc lands in slot cc % nstage, then A's rows
        (flat offsets a_rows(cc, slot) + k) times the slot's B part."""
        acc = np.zeros((bm, bn), np.float32)
        for cc in range(nk):
            slot = cc % nstage
            issue(cc, slot)
            a = sm[a_rows(cc, slot)[:, None] + k]
            b = sm[slot * lay["slot"] + lay["a_stage"]
                   + (k[:, None] * bn + np.arange(bn))]
            acc += a @ b
        return acc

    def copy_b(slot, wm, k0, n0):
        base = slot * lay["slot"] + lay["a_stage"]
        sm[base:base + KC * bn] = wm[k0:k0 + KC, n0:n0 + bn].reshape(-1)

    for img in range(n_img):
        for bx in range(-(-h // th)):
            sm = np.full(lay["total"] // 4, np.nan, np.float32)
            h0 = bx * th
            rows = min(th, h - h0)
            lo, hi = max(h0 - 1, 0), min(h0 + rows + 1, h)
            m1, m2 = (hi - lo) * w, rows * w
            row1 = (lo - (h0 - 1)) * w
            xin = x[img, lo:hi].reshape(-1, c)
            xt = x[img, h0:h0 + rows].reshape(-1, c)
            y1 = lambda r: lay["y1"] + r * ldy     # y1 row r's offset

            def zero_rows(r0, nr):
                sm[y1(r0):y1(r0) + nr * ldy] = 0.0

            if h0 == 0:
                zero_rows(0, w)
            if h0 + rows == h:
                zero_rows((rows + 1) * w, w)
            zero_rows((th + 2) * w, 1)
            # phase 1
            for m0 in range(0, m1, bm):
                for n0 in range(0, p, bn):
                    def issue1(cc, slot, m0=m0, n0=n0):
                        base = slot * lay["slot"]
                        for r in range(bm):
                            m = m0 + r
                            sm[base + r * LDA:base + r * LDA + KC] = (
                                xin[m, cc * KC:cc * KC + KC] if m < m1 else 0.0)
                        copy_b(slot, w1, cc * KC, n0)
                    acc = ring(c // KC, issue1, lambda cc, slot: (
                        slot * lay["slot"] + np.arange(bm) * LDA))
                    r = m0 + np.arange(bm)
                    keep = r < m1
                    dst = y1(row1 + r[keep])[:, None] + n0 + np.arange(bn)
                    sm[dst] = relu(acc[keep] + b1[n0:n0 + bn])
            # phase 2: 9 taps of P, rows clamped, off-image columns on the
            # zero row
            for m0 in range(0, m2, bm):
                m = np.minimum(m0 + np.arange(bm), m2 - 1)
                ro, co = m // w, m % w
                for n0 in range(0, p, bn):
                    def a2(cc, slot):
                        tap, kk = divmod(cc * KC, p)
                        dy, dx = divmod(tap, 3)
                        col = co + dx - 1
                        inside = (col >= 0) & (col < w)
                        return np.where(inside, y1((ro + dy) * w + col),
                                        lay["zero"]) + kk
                    acc = ring(9 * p // KC, lambda cc, slot, n0=n0: copy_b(
                        slot, w2m, cc * KC, n0), a2)
                    r = m0 + np.arange(bm)
                    keep = r < m2
                    dst = (lay["y2"] + r[keep] * ldy)[:, None] + n0 + np.arange(bn)
                    sm[dst] = relu(acc[keep] + b2[n0:n0 + bn])
            # phase 3: C in passes of bn; the residual from x, or staged
            # over y1 with chunk nstage - 1 (one row tile)
            for m0 in range(0, m2, bm):
                m = np.minimum(m0 + np.arange(bm), m2 - 1)
                for n0 in range(0, c, bn):
                    ldr = bn + 4

                    def issue3(cc, slot, n0=n0):
                        copy_b(slot, w3, cc * KC, n0)
                        if staged and cc == nstage - 1:
                            dst = lay["y1"] + np.arange(m2)[:, None] * ldr
                            sm[dst + np.arange(bn)] = xt[:, n0:n0 + bn]
                    acc = ring(p // KC, issue3, lambda cc, slot: (
                        lay["y2"] + m * ldy + cc * KC))
                    r = m0 + np.arange(bm)
                    keep = r < m2
                    if staged:
                        assert m0 == 0
                        res = sm[(lay["y1"] + r[keep] * ldr)[:, None]
                                 + np.arange(bn)]
                    else:
                        res = xt[r[keep], n0:n0 + bn]
                    tile = relu(acc[keep] + b3[n0:n0 + bn] + res)
                    rr = r[keep]
                    out[img, h0 + rr // w, rr % w, n0:n0 + bn] = tile
    return out


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


# The plans at small shapes, then forced (th, tx, nstage): several row
# tiles in phases 1-3 (block), partial last tiles, one-row images, several
# column passes (P > bn) and C / bn phase-3 passes, both ring depths.
@pytest.mark.parametrize("kernel,n,h,w,c,p,forced", [
    ("block", 2, 5, 9, 128, 64, None), ("tiled", 2, 5, 9, 128, 64, None),
    ("block", 2, 13, 7, 64, 128, None), ("tiled", 2, 13, 7, 64, 128, None),
    ("block", 1, 3, 100, 64, 64, (2, 8, 2)), ("block", 1, 5, 65, 64, 64, (4, 8, 2)),
    ("block", 1, 1, 3, 128, 64, None),
    ("block", 1, 6, 5, 256, 128, (4, 8, 2)),
    ("tiled", 1, 6, 5, 256, 128, (4, 16, 3)),
    ("tiled", 1, 7, 6, 256, 128, (3, 8, 2)),
    ("tiled", 1, 4, 3, 512, 256, (2, 16, 3))])
def test_f32_rehearsal_of_the_index_arithmetic_matches_plain(
        kernel, n, h, w, c, p, forced):
    x, ws = _bottleneck_inputs(n, h, w, c, p, n * 100 + h * 10 + w)
    if forced is None:
        plan = PLANS[kernel](n, h, w, c, p)
        forced = (plan.th, plan.tx, plan.nstage)
    th, tx, nstage = forced
    assert p % (8 * tx) == 0 and c % (8 * tx) == 0
    if kernel == "tiled":
        assert th * w <= 2048 // tx
    got = _rehearse(x, *ws, th, tx, nstage, staged=kernel == "tiled")
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
