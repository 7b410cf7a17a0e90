"""The head's two kernels on the CPU, where they cannot run: the plan of
csrc/time_conv.cu (K chunk depth, channel chunk, shared memory) at the
main path's and the card tests' shapes; a numpy rehearsal of its index
arithmetic; the shape checks of csrc/nl_attention.cu; and TimeConv's
prepared weights against flax after the parameters change.

The rehearsal walks each block as the kernel does: the chunk stream
(branch -> channel chunk -> tap -> K chunk) with its copies NSTAGE - 2
chunks ahead, each (branch, chunk) region's x rows m0 - 3 .. m0 + 66 staged
into its buffer when the region's first chunk is issued (rows off [0, B W)
zero, unstaged rows NaN), every tap's A row as the staged row r + 3 + d or
the zero row where t + d falls outside its sequence, each chunk's product
read from its ring stage only when the next chunk is under way (one wgmma
group in flight), the running max seeded from the staged tile. It must
equal `time_conv_plain` (1e-5: the same products in f64 against f32
sums)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tmrnet_tpu.models.blocks import TimeConv as JaxTimeConv
from tmrnet_torch.models.blocks import TimeConv
from tmrnet_torch.models.convert import from_jax_variables
from tmrnet_torch.ops.nl_attention import (
    check_nl_attention_shape,
    nl_attention_smem_bytes,
)
from tmrnet_torch.ops.time_conv import (
    BM,
    BN,
    HALO,
    NSTAGE,
    TimeConvPlan,
    plan_time_conv,
    time_conv_grid,
    time_conv_layout_bytes,
    time_conv_plain,
)

torch.set_num_threads(2)

SMEM_BLOCK_MAX = 232448     # a Hopper block's opt-in maximum

# The main path (32 clips, window 30) and bench.py's 96 clips, windows 30
# and 40 (the JAX configs' largest); the card tests' shapes.
SHAPES = [(32, 30, 512), (96, 30, 512), (96, 40, 512), (32, 40, 512),
          (3, 7, 64), (5, 13, 128), (1, 1, 64), (4, 30, 1024), (2, 17, 2048),
          (3, 37, 128)]


@pytest.mark.parametrize("b,w,c", SHAPES)
def test_time_conv_plan_fits_shared_memory(b, w, c):
    plan = plan_time_conv(b, w, c)
    assert plan.smem == time_conv_layout_bytes(plan) <= SMEM_BLOCK_MAX
    assert plan.kc == (128 if c % 128 == 0 else 64)
    assert c % plan.ck == 0 and plan.ck % plan.kc == 0
    # a region (one branch's taps over one chunk) outlasts the copies'
    # lead, so the other x buffer is free when a region restages it
    assert 3 * plan.ck // plan.kc >= NSTAGE - 2
    if c <= 1024:       # x staged once for all three branches
        assert plan.ck == c


@pytest.mark.parametrize("b,w,c", SHAPES)
def test_time_conv_grid_covers_every_output_once(b, w, c):
    plan = plan_time_conv(b, w, c)
    m = b * w
    gx, gy = time_conv_grid(b, w, plan)
    seen = np.zeros((m, c), np.int32)
    for bx in range(gx):
        for by in range(gy):
            m0, n0 = bx * BM, by * BN
            seen[m0:min(m0 + BM, m), n0:n0 + BN] += 1   # rows >= m unstored
    assert (seen == 1).all()


def test_time_conv_plan_refuses_what_the_kernel_cannot_take():
    with pytest.raises(ValueError, match="C % 64"):
        plan_time_conv(2, 3, 48)
    with pytest.raises(ValueError, match="nonempty"):
        plan_time_conv(0, 3, 64)
    with pytest.raises(ValueError, match="32-bit"):
        plan_time_conv(65536, 64, 512)


def rehearse(x, ws, bs, plan):
    """csrc/time_conv.cu's index arithmetic in numpy (f64)."""
    b, w, c = x.shape
    m_all = b * w
    xf = x.reshape(m_all, c).astype(np.float64)
    out = np.full((m_all, c), np.nan)
    kc_, ck, lead = plan.kc, plan.ck, NSTAGE - 2
    nck, nkc = c // ck, ck // kc_
    seq = [(br, j, tap, kc) for br in range(3) for j in range(nck)
           for tap in range(3 + 2 * br) for kc in range(nkc)]
    buf_of = lambda br, j: (br * nck + j) & 1 if nck > 1 else 0
    gx, gy = time_conv_grid(b, w, plan)
    rows = np.arange(BM)
    for bx in range(gx):
        for by in range(gy):
            m0, n0 = bx * BM, by * BN
            xs = np.full((2 if nck > 1 else 1, BM + 2 * HALO, ck), np.nan)
            zero = np.zeros(ck)
            ring = [None] * NSTAGE

            def issue(g):
                br, j, tap, kc = seq[g]
                k0 = j * ck + kc * kc_
                ring[g % NSTAGE] = ws[br][tap, k0:k0 + kc_, n0:n0 + BN]
                if tap == 0 and kc == 0 and (nck > 1 or br == 0):
                    for r in range(BM + 2 * HALO):
                        m = m0 - HALO + r
                        ok = 0 <= m < m_all
                        xs[buf_of(br, j), r] = xf[m, j * ck:(j + 1) * ck] if ok else 0

            def retire(g, a, acc):
                """Chunk g's product, its B read from the ring only now."""
                prod = a @ ring[g % NSTAGE]
                return prod if seq[g][1:] == (0, 0, 0) else acc + prod

            for g in range(min(lead, len(seq))):
                issue(g)
            acc = best = pending = None
            t_of = (m0 + rows) % w
            for g, (br, j, tap, kc) in enumerate(seq):
                if g + lead < len(seq):
                    issue(g + lead)    # into the stage of chunk g - 2
                xb = xs[buf_of(br, j)]
                if br == 0 and tap == 0 and kc == 0 and j == n0 // ck:
                    cin = n0 % ck
                    cur = xb[rows + HALO, cin:cin + BN]
                    prev = np.where((t_of > 0)[:, None],
                                    xb[rows + HALO - 1, cin:cin + BN], 0.0)
                    best = np.maximum(cur, prev)
                d = tap - (1 + br)
                ok = (m0 + rows < m_all) & (t_of + d >= 0) & (t_of + d < w)
                a = np.stack([xb[r + HALO + d] if ok[r] else zero
                              for r in rows])[:, kc * kc_:(kc + 1) * kc_]
                if pending is not None:             # chunk g-1 retires
                    acc = retire(*pending, acc)
                pending = (g, a)
                if (j, tap, kc) == (nck - 1, 2 + 2 * br, nkc - 1):
                    acc = retire(*pending, acc)     # a branch's end: all
                    pending = None
                    best = np.maximum(best, acc + bs[br][n0:n0 + BN])
            keep = m0 + rows < m_all
            out[m0 + rows[keep], n0:n0 + BN] = best[keep]
    return out.reshape(b, w, c)


# Default plans at small shapes (W = 1; sequences straddling a 64-row
# tile at W = 45; a sequence longer than a tile at W = 70; K chunks of 64
# and of 128), and plans with C in more than one chunk, so x is restaged
# into two buffers by turns.
REHEARSALS = [
    ((3, 7, 64), None), ((1, 1, 64), None), ((2, 45, 64), None),
    ((1, 70, 64), None), ((5, 13, 128), None), ((3, 11, 192), None),
    ((2, 30, 128), TimeConvPlan(128, 64, 64)),
    ((3, 11, 192), TimeConvPlan(192, 64, 64)),
    ((2, 40, 256), TimeConvPlan(256, 128, 128)),
    ((1, 9, 384), TimeConvPlan(384, 128, 128)),
]


@pytest.mark.parametrize("shape,plan", REHEARSALS)
def test_time_conv_index_rehearsal_matches_plain(shape, plan):
    b, w, c = shape
    plan = plan or plan_time_conv(b, w, c)
    rng = np.random.RandomState(b * w + c)
    x = rng.randn(b, w, c).astype(np.float32)
    ws = [(rng.randn(k, c, c) / np.sqrt(k * c)).astype(np.float32)
          for k in (3, 5, 7)]
    bs = [(rng.randn(c) * 0.1).astype(np.float32) for _ in range(3)]
    got = rehearse(x, ws, bs, plan)
    t = torch.from_numpy
    want = time_conv_plain(t(x), t(ws[0]), t(bs[0]), t(ws[1]), t(bs[1]),
                           t(ws[2]), t(bs[2])).numpy()
    assert not np.isnan(got).any()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


# (W, F, itemsize) the card tests run, bf16 and f32.
NL_OK = [(30, 512, 2), (7, 64, 2), (40, 200, 2), (30, 512, 4), (7, 64, 4),
         (40, 200, 4), (3, 64, 2)]


@pytest.mark.parametrize("w,f,itemsize", NL_OK)
def test_nl_attention_takes_the_card_tests_shapes(w, f, itemsize):
    smem = check_nl_attention_shape(w, f, itemsize)
    assert smem == nl_attention_smem_bytes(w, f, itemsize) <= SMEM_BLOCK_MAX
    # k and v whole, 16-byte rows; q and the logits in f32; two barriers
    assert smem >= 2 * w * f * itemsize + 4 * f + 4 * w + 16
    assert (w * f * itemsize) % 16 == 0


@pytest.mark.parametrize("w,f,itemsize,match", [
    (30, 60, 2, "16 bytes"), (5, 6, 4, "16 bytes"), (30, 3, 2, "16 bytes"),
    (120, 512, 2, "shared memory"), (60, 512, 4, "shared memory"),
    (0, 64, 2, "empty")])
def test_nl_attention_refuses_what_the_copies_cannot_take(w, f, itemsize, match):
    with pytest.raises(ValueError, match=match):
        check_nl_attention_shape(w, f, itemsize)


def _flax_timeconv(hid, seed):
    rng = np.random.RandomState(seed)
    block = JaxTimeConv(feature_dim=hid)
    x = jnp.asarray(rng.randn(2, 6, hid), jnp.float32)
    variables = block.init(jax.random.PRNGKey(seed), x)
    variables = jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.randn(*a.shape) * 0.2, jnp.float32), variables)
    return block, variables, x


def test_timeconv_prepared_weights_follow_the_parameters():
    hid = 8
    port = TimeConv(hid).eval()
    for seed in (1, 2):                 # a second load_state_dict, other weights
        block, variables, x = _flax_timeconv(hid, seed)
        port.load_state_dict(from_jax_variables(
            jax.tree_util.tree_map(np.asarray, variables)), strict=True)
        with torch.no_grad():
            got = port(torch.from_numpy(np.array(x)))
        np.testing.assert_allclose(got.numpy(), np.asarray(block.apply(variables, x)),
                                   rtol=1e-4, atol=1e-4)
    first = port.kernel_args()
    assert all(a is b for a, b in zip(first, port.kernel_args()))   # reused
    with torch.no_grad():               # an in-place edit of one parameter
        port.conv_k5.weight.mul_(-1.0)
    w5 = port.kernel_args()[2]
    torch.testing.assert_close(w5, port.conv_k5.weight.permute(2, 1, 0))
    port.to(torch.float64)              # .to(): new storage
    args = port.kernel_args()
    assert args[0].dtype == torch.float32 and args[1].dtype == torch.float32
    torch.testing.assert_close(args[0], port.conv_k3.weight.permute(2, 1, 0).float())
