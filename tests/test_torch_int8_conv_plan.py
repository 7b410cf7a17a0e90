"""csrc/int8_conv3x3.cu on the CPU, where it cannot run: its plan (tile,
ring depth, shared memory) at the int8 gate's and the card tests' shapes; a
numpy rehearsal of its index arithmetic, held to `int8_conv3x3_plain` and to
the Pallas kernel (interpret mode) bit for bit; and the prepared (Co, 9C)
weight after an in-place edit of w_q.

The rehearsal (tests/int8_wgmma_rehearsal.py, the block the kernel shares
with int8_matmul) walks each block as the kernel does, with the conv's A
loader: one tap's 16 channels of a pixel a piece, zero where the tap leaves
the image, the row is past M or k >= K. A broken swizzle, tap offset, ring
lead or k32 step count makes it fail."""

import gc

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tmrnet_tpu.experimental.quant_conv import int8_conv3x3 as jax_int8_conv3x3
from tests.int8_wgmma_rehearsal import (
    BK,
    BM,
    ROW0,
    dequantize,
    gather,
    rehearse_gemm,
)
from tmrnet_torch.experimental import int8_gate
from tmrnet_torch.experimental.quant_conv import (
    PLANS,
    int8_conv3x3_plain,
    kmajor_weight,
    plan_int8_conv3x3,
)
from tmrnet_torch.kernels import prepared
from tmrnet_torch.ops.quant import Int8Plan

torch.set_num_threads(2)

SMEM_BLOCK_MAX = 232448     # a Hopper block's opt-in maximum

GATE = [(128, h, h, p, p) for _, h, _, p in int8_gate.STAGES]
# The shapes of tests/test_torch_cuda.py::test_int8_conv3x3_kernel_equals_plain
# and of its forced-plan cases.
CARD = [(2, 7, 7, 64, 64), (1, 5, 9, 16, 32), (3, 14, 14, 256, 256),
        (2, 56, 56, 64, 64), (1, 1, 1, 32, 16), (2, 9, 11, 48, 256)]


@pytest.mark.parametrize("shape", GATE + CARD)
def test_plan_fits_shared_memory(shape):
    plan = plan_int8_conv3x3(*shape)
    assert plan.bm == 128 and plan.bn in (64, 128, 256)
    assert plan.nstage in (3, 4)
    assert plan.smem == plan.nstage * (plan.bm + plan.bn) * BK + 1024
    assert plan.smem <= SMEM_BLOCK_MAX
    assert plan.blocks_per_sm * (plan.smem + 1024) <= 233472


@pytest.mark.parametrize("shape", GATE)
def test_plan_wastes_no_columns_at_the_gate(shape):
    # stage 1 has Co = 64: a 128-column tile would compute half zeros
    plan = plan_int8_conv3x3(*shape)
    assert shape[-1] % plan.bn == 0


@pytest.mark.parametrize("shape", [(1, 4, 4, 24, 32), (1, 4, 4, 32, 40),
                                   (0, 4, 4, 32, 32), (2 ** 11, 2 ** 10, 2 ** 10, 16, 16)])
def test_plan_refuses_what_the_kernel_cannot_take(shape):
    with pytest.raises(ValueError):
        plan_int8_conv3x3(*shape)


@pytest.mark.parametrize("shape", [(1, 2 ** 16, 1, 16, 16), (1, 1, 2 ** 16, 16, 16),
                                   (1, 2 ** 15, 2 ** 15, 16, 16)])
def test_plan_takes_any_image_side(shape):
    assert plan_int8_conv3x3(*shape).bn in (64, 128, 256)


# A shape at which the plan picks each (tile width, ring depth) the kernel
# is built for: no instantiation is there for tests alone.
PICKED_AT = {(64, 3): (128, 56, 56, 64, 64), (64, 4): (8, 56, 56, 16, 16),
             (128, 3): (128, 28, 28, 128, 128), (128, 4): (128, 14, 14, 256, 256),
             (256, 4): (128, 7, 7, 512, 512)}


@pytest.mark.parametrize("plan", PLANS)
def test_the_plan_picks_every_built_plan(plan):
    got = plan_int8_conv3x3(*PICKED_AT[plan])
    assert (got.bn, got.nstage) == plan


# ---- the rehearsal ----

def conv_loader(x, mutation=None):
    """csrc/int8_conv3x3.cu's A loader over x (N, H, W, C) int8 numpy: per
    block a 9-bit mask of in-image taps for each of a thread's rows, then
    one tap's 16 channels a piece."""
    n, h, w, c = x.shape
    m_all, k_all = n * h * w, 9 * c
    xf = x.reshape(-1)

    def at(m0):
        taps = []   # bit t: tap t of the row lies in the image
        for i in range(BM // 32):
            m = m0 + ROW0 + 32 * i
            rem = m % (h * w)
            hh, ww = rem // w, rem % w
            bits = np.zeros_like(m)
            for t in range(9):
                y, xw = hh + t // 3 - 1, ww + t % 3 - 1
                bits |= ((y >= 0) & (y < h) & (xw >= 0) & (xw < w)) << t
            taps.append(np.where(m < m_all, bits, 0))

        def a_src(i, r, k):
            tap = k // c
            ci = k - tap * c
            dy, dx = tap // 3 - 1, tap % 3 - 1
            if mutation == "tap":
                dy, dx = dx, dy
            bit = 3 * (dy + 1) + dx + 1     # the tap, unless mutated
            ok = (k < k_all) & ((taps[i] >> bit) & 1).astype(bool)
            return gather(xf, (m0 + r + dy * w + dx) * c + ci, ok)
        return a_src
    return at


def rehearse(x, w_q, x_scale, w_scale, plan, out_dtype=torch.float32,
             mutation=None, seed=0):
    """csrc/int8_conv3x3.cu's index arithmetic in numpy. x (N, H, W, C) and
    w_q (3, 3, C, Co) int8 numpy; x_scale a float; w_scale (Co,) f32."""
    n, h, w, c = x.shape
    co = w_q.shape[-1]
    wk = kmajor_weight(torch.from_numpy(w_q)).numpy()
    assert wk.shape == (co, 9 * c)
    acc = rehearse_gemm(conv_loader(x, mutation), wk, n * h * w, 9 * c, plan,
                        mutation if mutation != "tap" else None, seed)
    return dequantize(acc, x_scale, w_scale, out_dtype).reshape(n, h, w, co)


def _operands(shape, seed):
    n, h, w, c, co = shape
    rng = np.random.RandomState(seed)
    x = rng.randint(-127, 128, (n, h, w, c)).astype(np.int8)
    wq = rng.randint(-127, 128, (3, 3, c, co)).astype(np.int8)
    ws = (rng.rand(co) * 0.01).astype(np.float32)
    return x, wq, np.float32(0.037), ws


def _plain(x, wq, xs, ws, out_dtype=torch.float32):
    return int8_conv3x3_plain(torch.from_numpy(x), torch.from_numpy(wq),
                              torch.tensor(xs), torch.from_numpy(ws), out_dtype)


# Default plans at the card tests' small shapes (K = 144 and 288 not
# multiples of 128, rows past M, one pixel), and every tile width and ring
# depth forced at a shape with two row tiles and Co = 256.
REHEARSALS = [((1, 5, 9, 16, 32), None), ((1, 1, 1, 32, 16), None),
              ((2, 7, 7, 64, 64), None)] + [
    ((2, 9, 11, 48, 256), Int8Plan(bn, ns)) for bn, ns in PLANS]


@pytest.mark.parametrize("shape,plan", REHEARSALS)
def test_index_rehearsal_equals_plain(shape, plan):
    x, wq, xs, ws = _operands(shape, sum(shape))
    plan = plan or plan_int8_conv3x3(*shape)
    for out_dtype in (torch.float32, torch.bfloat16):
        got = rehearse(x, wq, xs, ws, plan, out_dtype)
        assert torch.equal(got, _plain(x, wq, xs, ws, out_dtype))


@pytest.mark.parametrize("mutation", ["swizzle", "tap", "lead"])
def test_index_rehearsal_catches_a_broken_kernel(mutation):
    shape = (1, 5, 9, 64, 32)       # five K chunks through a ring of four
    x, wq, xs, ws = _operands(shape, 5)
    plan = Int8Plan(64, 4)
    try:
        got = rehearse(x, wq, xs, ws, plan, mutation=mutation)
    except AssertionError:
        return                      # a stage read while overwritten
    assert not torch.equal(got, _plain(x, wq, xs, ws))


def test_index_rehearsal_equals_the_pallas_kernel():
    shape = (2, 6, 5, 32, 48)
    x, wq, xs, ws = _operands(shape, 11)
    want = jax_int8_conv3x3(jnp.asarray(x), jnp.asarray(wq), jnp.float32(xs),
                            jnp.asarray(ws), block_n=2, interpret=True)
    got = rehearse(x, wq, xs, ws, plan_int8_conv3x3(*shape))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want, np.float32))


def test_kmajor_weight_follows_in_place_edits():
    rng = np.random.RandomState(2)
    w = torch.from_numpy(rng.randint(-127, 128, (3, 3, 32, 16)).astype(np.int8))
    first = kmajor_weight(w)
    torch.testing.assert_close(first, w.reshape(288, 16).t(), rtol=0, atol=0)
    assert first.is_contiguous() and kmajor_weight(w) is first   # reused
    w.add_(1)                                   # an in-place edit
    second = kmajor_weight(w)
    assert second is not first
    torch.testing.assert_close(second, w.reshape(288, 16).t(), rtol=0, atol=0)
    w[0, 0, 0, 0] = 5                           # another, through indexing
    assert kmajor_weight(w)[0, 0].item() == 5
    other = w.clone()                           # new storage, same values
    assert kmajor_weight(other) is not kmajor_weight(w)


def test_kmajor_weight_keeps_a_copy_per_live_weight():
    # as many weights as a deep int8 backbone has 3x3 convs, each copy kept
    ws = [torch.full((3, 3, 16, 16), i, dtype=torch.int8) for i in range(40)]
    firsts = [kmajor_weight(w) for w in ws]
    assert all(kmajor_weight(w) is f for w, f in zip(ws, firsts))
    before = len(prepared._BESIDE)
    del ws[0]
    gc.collect()
    assert len(prepared._BESIDE) == before - 1    # gone with its weight
