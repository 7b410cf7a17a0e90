"""csrc/int8_conv3x3.cu on the CPU, where it cannot run: its plan (tile,
ring depth, shared memory) at the int8 gate's and the card tests' shapes; a
numpy rehearsal of its index arithmetic, held to `int8_conv3x3_plain` and to
the Pallas kernel (interpret mode) bit for bit; and the prepared (Co, 9C)
weight after an in-place edit of w_q.

The rehearsal walks each block as the kernel does: its 256 threads' cp.async
pieces of each K chunk (A: one tap's 16 channels of a pixel, zero where the
tap leaves the image, the row is past M or k >= K; B: 16 bytes of a row of
the prepared weight, zero past Co or K) written at `kmajor_offset`; the
copies committed in groups and landing only at the `cp.async.wait_group`
that covers them; each k32 step read through its descriptor the way the
hardware forms addresses (rows 128 bytes apart, 8-row groups SBO = 1 KB
apart, the start advanced 32 bytes a step, address bits 4-6 XORed with bits
7-9); one wgmma group in flight, so each chunk's operands are read both when
its products are issued and when they are retired, with every copy issued by
then landed, and the two reads must agree; the epilogue through the
accumulator fragment layout. A broken swizzle, tap offset or ring lead makes
it fail."""

import gc

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tmrnet_tpu.experimental.quant_conv import int8_conv3x3 as jax_int8_conv3x3
from tmrnet_torch.experimental import int8_gate, quant_conv
from tmrnet_torch.experimental.quant_conv import (
    BK,
    BM,
    PLANS,
    Int8ConvPlan,
    int8_conv3x3_plain,
    kmajor_weight,
    plan_int8_conv3x3,
)

torch.set_num_threads(2)

SMEM_BLOCK_MAX = 232448     # a Hopper block's opt-in maximum
THREADS = 256

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

def kmajor_offset(row, kbyte):
    """csrc/wgmma_s8.cuh::kmajor_offset."""
    return row * 128 + ((((kbyte >> 4) ^ row) & 7) << 4) + (kbyte & 15)


def descriptor_read(mem, start, rows):
    """What one k32 step of wgmma reads through a K-major 128-byte-swizzle
    descriptor starting at byte `start` (from a 1 KB aligned base): rows x
    32 int8."""
    i = np.arange(rows)[:, None]
    j = np.arange(32)[None, :]
    addr = start + (i // 8) * 1024 + (i % 8) * 128 + j
    return mem[addr ^ (((addr >> 7) & 7) << 4)].astype(np.int64)


class Ring:
    """Shared memory under cp.async: copies land at the wait that covers
    their commit group; `eager()` is the memory with every issued copy
    landed."""

    def __init__(self, nbytes, rng):
        self.mem = rng.integers(-128, 128, nbytes).astype(np.int8)  # garbage
        self.groups, self.open = [], []

    def copy(self, dst, src):
        self.open.append((dst, src))

    def commit(self):
        self.groups.append(self.open)
        self.open = []

    @staticmethod
    def _land(mem, group):
        for dst, src in group:
            mem[dst[:, None] + np.arange(16)] = src

    def wait(self, n):
        while len(self.groups) > n:
            self._land(self.mem, self.groups.pop(0))

    def eager(self):
        mem = self.mem.copy()
        for group in self.groups + [self.open]:
            self._land(mem, group)
        return mem


def rehearse(x, w_q, x_scale, w_scale, plan, out_dtype=torch.float32,
             mutation=None, seed=0):
    """csrc/int8_conv3x3.cu's index arithmetic in numpy. x (N, H, W, C) and
    w_q (3, 3, C, Co) int8 numpy; x_scale a float; w_scale (Co,) f32."""
    n, h, w, c = x.shape
    co = w_q.shape[-1]
    m_all, k_all = n * h * w, 9 * c
    nk = -(-k_all // BK)
    bm, bn, ns = BM, plan.bn, plan.nstage
    lead = ns - (1 if mutation == "lead" else 2)
    sb = (bm + bn) * BK
    xf = x.reshape(-1)
    wk = kmajor_weight(torch.from_numpy(w_q)).numpy()
    assert wk.shape == (co, k_all)
    wf = wk.reshape(-1)
    zero = np.zeros(16, np.int8)
    offset = (lambda r, kb: r * 128 + kb) if mutation == "swizzle" else kmajor_offset
    tid = np.arange(THREADS)
    piece, row0 = tid & 7, tid >> 3
    rng = np.random.default_rng(seed)
    acc_out = np.full((m_all, co), np.nan, np.float32)
    for bx in range(-(-m_all // bm)):
        for by in range(-(-co // bn)):
            m0, n0 = bx * bm, by * bn
            ring = Ring(ns * sb, rng)
            taps = []   # bit t: tap t of the row lies in the image
            for i in range(bm // 32):
                m = m0 + row0 + 32 * i
                rem = m % (h * w)
                hh, ww = rem // w, rem % w
                bits = np.zeros_like(m)
                for t in range(9):
                    y, xw = hh + t // 3 - 1, ww + t % 3 - 1
                    bits |= ((y >= 0) & (y < h) & (xw >= 0) & (xw < w)) << t
                taps.append(np.where(m < m_all, bits, 0))

            def load(kc, st):
                k = kc * BK + 16 * piece
                tap = k // c
                ci = k - tap * c
                dy, dx = tap // 3 - 1, tap % 3 - 1
                if mutation == "tap":
                    dy, dx = dx, dy
                bit = 3 * (dy + 1) + dx + 1     # the tap, unless mutated
                kin = k < k_all
                for i in range(bm // 32):
                    r = row0 + 32 * i
                    ok = kin & ((taps[i] >> bit) & 1).astype(bool)
                    src = (m0 + r + dy * w + dx) * c + ci
                    ring.copy(st * sb + offset(r, 16 * piece),
                              np.stack([xf[s:s + 16] if o else zero
                                        for s, o in zip(src, ok)]))
                for i in range(bn // 32):
                    r = row0 + 32 * i
                    ok = kin & (n0 + r < co)
                    src = (n0 + r) * k_all + k
                    ring.copy(st * sb + bm * BK + offset(r, 16 * piece),
                              np.stack([wf[s:s + 16] if o else zero
                                        for s, o in zip(src, ok)]))

            def products(mem, st):
                """Chunk in stage st: per warpgroup (rows 64 wg ..), the
                (64, bn) sum of its four k32 steps."""
                b0 = st * sb + bm * BK
                return [sum(descriptor_read(mem, st * sb + 64 * wg * BK + 32 * kk, 64)
                            @ descriptor_read(mem, b0 + 32 * kk, bn).T
                            for kk in range(BK // 32)) for wg in range(2)]

            acc = [np.zeros((64, bn), np.int64) for _ in range(2)]
            for s in range(lead):
                if s < nk:
                    load(s, s)
                ring.commit()
            pending = None
            for kc in range(nk):
                ring.wait(lead - 1)
                st = kc % ns
                issued = products(ring.mem, st)
                if kc + lead < nk:
                    load(kc + lead, (kc + lead) % ns)
                ring.commit()
                if pending is not None:   # chunk kc - 1 retires
                    late = products(ring.eager(), pending[0])
                    if any((a != b).any() for a, b in zip(late, pending[1])):
                        raise AssertionError(f"chunk {kc - 1}: a stage was "
                                             f"overwritten while read")
                    acc = [a + p for a, p in zip(acc, pending[1])]
                pending = (st, issued)
            acc = [a + p for a, p in zip(acc, pending[1])]

            # the epilogue, through the fragment layout
            for wg in range(2):
                for warp in range(4):
                    for lane in range(32):
                        for hf in range(2):
                            row = 16 * warp + (lane >> 2) + 8 * hf
                            m = m0 + 64 * wg + row
                            if m >= m_all:
                                continue
                            for j in range(bn // 8):
                                col = 8 * j + 2 * (lane & 3)
                                if n0 + col >= co:
                                    break
                                acc_out[m, n0 + col:n0 + col + 2] = \
                                    acc[wg][row, col:col + 2]
    assert not np.isnan(acc_out).any()
    scale = np.float32(x_scale) * w_scale.astype(np.float32)
    out = acc_out.astype(np.float32) * scale
    return torch.from_numpy(out.reshape(n, h, w, co)).to(out_dtype)


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
    ((2, 9, 11, 48, 256), Int8ConvPlan(bn, ns)) for bn, ns in PLANS]


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
    plan = Int8ConvPlan(64, 4)
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
    before = len(quant_conv._KMAJOR)
    del ws[0]
    gc.collect()
    assert len(quant_conv._KMAJOR) == before - 1    # gone with its weight
