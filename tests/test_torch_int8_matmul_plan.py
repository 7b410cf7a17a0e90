"""csrc/int8_matmul.cu on the CPU, where it cannot run: its plan (tile
width, ring depth, shared memory) at the int8 gate's and the card tests'
shapes; a numpy rehearsal of its index arithmetic, held to
`int8_matmul_plain` and to the Pallas kernel (interpret mode) bit for bit;
and the prepared (N, K) copy of b_q after an in-place edit.

The rehearsal (tests/int8_wgmma_rehearsal.py, the block the kernel shares
with int8_conv3x3) walks each block as the kernel does, with the matmul's A
loader: 16 bytes of row m of a from m K + k, zero past M and past K. A
broken swizzle, ring lead or k32 step count makes it fail."""

import gc

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests.int8_wgmma_rehearsal import (
    BK,
    dequantize,
    gather,
    rehearse_gemm,
)
from tmrnet_tpu.ops.quant import int8_matmul as jax_int8_matmul
from tmrnet_torch.experimental import int8_gate
from tmrnet_torch.kernels import prepared
from tmrnet_torch.ops.quant import (
    MATMUL_PLANS,
    Int8Plan,
    int8_matmul_plain,
    kmajor_b,
    plan_int8_matmul,
)

torch.set_num_threads(2)

SMEM_BLOCK_MAX = 232448     # a Hopper block's opt-in maximum

# The int8 gate's products at B = 128 frames (M = B H W): per stage C -> P
# and P -> C (the chain) and P -> P (the gate's "mm" row); the square one.
GATE = [(128 * h * h, k, n) for _, h, c, p in int8_gate.STAGES
        for k, n in ((c, p), (p, c), (p, p))]
SQUARE = (8192, 8192, 8192)
# The shapes of tests/test_torch_cuda.py's int8_matmul cases.
CARD = [(100, 64, 16), (1, 32, 48), (777, 160, 144), (6272, 2048, 512),
        (300, 4608, 64), (401408, 64, 256), (300, 400, 272), (4096, 512, 512),
        (25088, 256, 1024)]


@pytest.mark.parametrize("shape", GATE + CARD + [SQUARE])
@pytest.mark.parametrize("out_bytes", [4, 2])
def test_plan_fits_shared_memory(shape, out_bytes):
    plan = plan_int8_matmul(*shape, out_bytes)
    assert plan.bm == 128 and (plan.bn, plan.nstage) in MATMUL_PLANS
    assert plan.smem == plan.nstage * (plan.bm + plan.bn) * BK + 1024
    assert plan.smem <= SMEM_BLOCK_MAX
    assert plan.blocks_per_sm * (plan.smem + 1024) <= 233472


@pytest.mark.parametrize("shape", [(64, 40, 32), (64, 32, 40), (0, 32, 32),
                                   (64, 0, 32), (64, 32, 0), (2 ** 31, 16, 16)])
def test_plan_refuses_what_the_kernel_cannot_take(shape):
    with pytest.raises(ValueError):
        plan_int8_matmul(*shape)


# A shape at which the plan picks each (tile width, ring depth) the kernel
# is built for: no instantiation is there for tests alone.
PICKED_AT = {(64, 3): (6272, 2048, 512), (64, 4): (401408, 256, 64),
             (128, 3): (401408, 64, 256), (256, 4): SQUARE}


@pytest.mark.parametrize("plan", MATMUL_PLANS)
def test_the_plan_picks_every_built_plan(plan):
    got = plan_int8_matmul(*PICKED_AT[plan])
    assert (got.bn, got.nstage) == plan


# ---- the rehearsal ----

def matmul_loader(a):
    """csrc/int8_matmul.cu's A loader over a (M, K) int8 numpy."""
    m_all, k_all = a.shape
    af = a.reshape(-1)

    def at(m0):
        def a_src(i, r, k):
            m = m0 + r
            return gather(af, m * k_all + k, (m < m_all) & (k < k_all))
        return a_src
    return at


def rehearse(a, b, a_scale, b_scale, plan, out_dtype=torch.float32,
             mutation=None, seed=0):
    """csrc/int8_matmul.cu's index arithmetic in numpy. a (M, K) and b
    (K, N) int8 numpy; a_scale a float; b_scale (N,) f32."""
    bk = kmajor_b(torch.from_numpy(b)).numpy()
    assert bk.shape == b.shape[::-1]
    acc = rehearse_gemm(matmul_loader(a), bk, a.shape[0], a.shape[1], plan,
                        mutation, seed)
    return dequantize(acc, a_scale, b_scale, out_dtype)


def _operands(m, k, n, seed):
    rng = np.random.RandomState(seed)
    a = rng.randint(-127, 128, (m, k)).astype(np.int8)
    b = rng.randint(-127, 128, (k, n)).astype(np.int8)
    bs = (rng.rand(n) * 0.01).astype(np.float32)
    return a, b, np.float32(0.037), bs


def _plain(a, b, a_s, b_s, out_dtype=torch.float32):
    return int8_matmul_plain(torch.from_numpy(a), torch.from_numpy(b),
                             torch.tensor(a_s), torch.from_numpy(b_s), out_dtype)


# Default plans at rows past M (M = 100, 1, 200, 130), K = 16, 48 and 64
# (one chunk, its last k32 steps on zeros) and 160 (a second chunk of 32
# bytes), N = 16, 48 and 144; every tile width and ring depth forced at a
# shape with three row tiles, N = 144 over one to three column tiles and K =
# 400 (four chunks, the last of 16 bytes).
REHEARSALS = [((100, 64, 16), None), ((1, 16, 48), None),
              ((200, 48, 144), None), ((130, 160, 48), None)] + [
    ((257, 400, 144), Int8Plan(bn, ns)) for bn, ns in MATMUL_PLANS]


@pytest.mark.parametrize("shape,plan", REHEARSALS)
def test_index_rehearsal_equals_plain(shape, plan):
    a, b, a_s, b_s = _operands(*shape, sum(shape))
    plan = plan or plan_int8_matmul(*shape)
    for out_dtype in (torch.float32, torch.bfloat16):
        got = rehearse(a, b, a_s, b_s, plan, out_dtype)
        assert torch.equal(got, _plain(a, b, a_s, b_s, out_dtype))


@pytest.mark.parametrize("mutation", ["swizzle", "steps", "lead"])
def test_index_rehearsal_catches_a_broken_kernel(mutation):
    # five K chunks through a ring of four, the last of 48 bytes
    shape = (40, 560, 32)
    a, b, a_s, b_s = _operands(*shape, 5)
    try:
        got = rehearse(a, b, a_s, b_s, Int8Plan(64, 4), mutation=mutation)
    except AssertionError:
        return                      # a stage read while overwritten
    assert not torch.equal(got, _plain(a, b, a_s, b_s))


def test_index_rehearsal_equals_the_pallas_kernel():
    a, b, a_s, b_s = _operands(96, 80, 48, 11)
    want = jax_int8_matmul(jnp.asarray(a), jnp.asarray(b), jnp.float32(a_s),
                           jnp.asarray(b_s), block_m=32, block_n=16,
                           block_k=16, interpret=True)
    got = rehearse(a, b, a_s, b_s, plan_int8_matmul(96, 80, 48))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want, np.float32))


def test_kmajor_b_follows_in_place_edits():
    rng = np.random.RandomState(2)
    b = torch.from_numpy(rng.randint(-127, 128, (48, 32)).astype(np.int8))
    first = kmajor_b(b)
    torch.testing.assert_close(first, b.t(), rtol=0, atol=0)
    assert first.is_contiguous() and kmajor_b(b) is first   # reused
    b.add_(1)                                   # an in-place edit
    second = kmajor_b(b)
    assert second is not first
    torch.testing.assert_close(second, b.t(), rtol=0, atol=0)
    b[0, 3] = 5                                 # another, through indexing
    assert kmajor_b(b)[3, 0].item() == 5
    other = b.clone()                           # new storage, same values
    assert kmajor_b(other) is not kmajor_b(b)


def test_kmajor_b_keeps_a_copy_per_live_tensor():
    # a deep int8 backbone's 1x1 weights, each copy kept while it lives
    bs = [torch.full((64, 32), i, dtype=torch.int8) for i in range(40)]
    firsts = [kmajor_b(b) for b in bs]
    assert all(kmajor_b(b) is f for b, f in zip(bs, firsts))
    before = len(prepared._BESIDE)
    del bs[0]
    gc.collect()
    assert len(prepared._BESIDE) == before - 1      # gone with its tensor
