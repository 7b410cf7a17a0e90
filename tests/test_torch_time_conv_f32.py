"""The f32 TimeConv on the CPU, where its kernel cannot run: the dtype
rule that picks csrc/time_conv.cu (bf16) or csrc/time_conv_f32.cu (f32);
the f32 kernel's plan (grid, shared memory, pieces past 32-bit offsets)
at the main path's shapes; a numpy rehearsal of its index arithmetic;
the ops' fake implementations on fake CUDA tensors of both dtypes; the
port's TimeConv and a whole tmr model at compute_dtype float32 against
JAX's to 1e-5; and the switch that turns TF32 off under f32 on the card.

The rehearsal walks each block as the kernel does: K chunks of F32_KC
channels, each staging the block's x rows m0 - 3 .. m0 + 66 (zero off
[0, B W)) beside a zero row; every tap's row as the staged row r + 3 + d,
or the zero row where t + d falls outside its sequence or the row is
past B W; three accumulators; the epilogue's max over the identity and
causal branches read from x at channel c0. It must equal
`time_conv_plain` to 1e-5 (products in f64 against f32 sums)."""

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

import jax
import jax.numpy as jnp

from tmrnet_tpu.config import ModelConfig as JaxModelConfig
from tmrnet_tpu.models.blocks import TimeConv as JaxTimeConv
from tmrnet_tpu.models.tmrnet import build_model as jax_build_model
from tmrnet_torch import device as port_device
from tmrnet_torch.config import ModelConfig
from tmrnet_torch.models.blocks import TimeConv
from tmrnet_torch.models.convert import from_jax_variables
from tmrnet_torch.models.tmrnet import build_model
from tmrnet_torch.ops.time_conv import (
    BM,
    BN,
    F32_KC,
    F32_LDX,
    F32_THREADS,
    HALO,
    TAPS,
    TimeConvF32Plan,
    plan_time_conv_f32,
    time_conv_dtype,
    time_conv_f32_smem,
    time_conv_max_rows,
    time_conv_plain,
)

torch.set_num_threads(2)

SMEM_BLOCK_MAX = 232448     # a Hopper block's opt-in maximum
SMEM_SM = 233472            # an SM's shared memory for blocks (228 KB)
TOL = dict(rtol=1e-5, atol=1e-5)
BF16, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("x,w,want", [
    (BF16, (BF16,) * 3, BF16),
    (F32, (F32,) * 3, F32),
])
def test_dtype_rule_takes_bf16_and_f32(x, w, want):
    assert time_conv_dtype(x, w) == want


@pytest.mark.parametrize("x,w", [
    (F32, (BF16,) * 3),                     # mixed: x f32, weights bf16
    (BF16, (F32,) * 3),
    (F32, (F32, BF16, F32)),                # mixed among the weights
    (torch.float16, (torch.float16,) * 3),  # f16: neither kernel's
    (torch.float64, (torch.float64,) * 3),
])
def test_dtype_rule_refuses_mixed_and_other_dtypes(x, w):
    with pytest.raises(TypeError, match="bf16 or f32"):
        time_conv_dtype(x, w)


def test_f32_shared_memory_is_the_kernels_layout():
    # the 15 taps' weights of a chunk and BM + 6 staged rows + a zero row
    want = (15 * 16 * 64 + (64 + 6 + 1) * 20) * 4
    assert time_conv_f32_smem() == want == 67120
    assert TAPS == 3 + 5 + 7
    # over 48 KB (dynamic, opted into), under a block's maximum, and two
    # blocks an SM (the kernel's __launch_bounds__ minimum)
    assert 48 * 1024 < want <= SMEM_BLOCK_MAX and 2 * want <= SMEM_SM


@pytest.mark.parametrize("b", [16, 2582, 44000])
@pytest.mark.parametrize("w", [30, 40])
def test_f32_plan_at_the_main_paths_shapes(b, w):
    plan = plan_time_conv_f32(b, w, 512, 512)
    assert plan == TimeConvF32Plan(b, 1, (-(-b * w // BM), 8), 67120)
    # the grid covers every row of B W once, with at most BM - 1 spare
    assert 0 <= plan.grid[0] * BM - b * w < BM


@pytest.mark.parametrize("m", [2, 4])
def test_f32_plan_of_a_column_slice(m):
    """A model group of M ranks: each launch writes C / M columns, so the
    grid has (C / M) / BN column tiles; the rows and memory are unchanged."""
    plan = plan_time_conv_f32(2582, 30, 512, 512 // m)
    assert plan.grid == (-(-2582 * 30 // BM), 512 // m // BN)
    assert plan.smem == 67120 and plan.pieces == 1


@pytest.mark.parametrize("w", [30, 40])
def test_f32_plan_splits_past_32_bit_offsets(w):
    rows = time_conv_max_rows(w, 512)
    assert rows * w * 512 <= 2**31 - 1 < (rows + 1) * w * 512
    plan = plan_time_conv_f32(rows, w, 512, 512)
    assert (plan.rows, plan.pieces) == (rows, 1)
    plan = plan_time_conv_f32(rows + 1, w, 512, 512)
    assert (plan.rows, plan.pieces) == (rows, 2)
    assert plan.grid == (-(-rows * w // BM), 8)
    # a grid row of blocks within the launch limit
    assert plan.grid[0] < 2**31


@pytest.mark.parametrize("b,w,c,cout", [(1, 0, 512, 512), (0, 30, 512, 512),
                                        (4, 30, 96, 96), (4, 30, 512, 32),
                                        (4, 30, 512, 100)])
def test_f32_plan_refuses_what_the_kernel_cannot_take(b, w, c, cout):
    with pytest.raises(ValueError, match="time_conv_cuda"):
        plan_time_conv_f32(b, w, c, cout)


def test_f32_thread_maps_cover_their_tiles_once():
    """A thread's 4 x 4 outputs (rows ty + 16 i, columns 4 tx + j), its
    float4 of a weight chunk (row tid / 16, columns 4 (tid % 16) ..) and
    the x staging loop (e = tid, tid + 256, ... < 70 rows x 4 float4s)
    each cover their tile exactly once."""
    outs, wts, xs = [], [], []
    for tid in range(F32_THREADS):
        tx, ty = tid % 16, tid // 16
        outs += [(ty + 16 * i, 4 * tx + j) for i in range(4)
                 for j in range(4)]
        wts += [(tid // (BN // 4), 4 * (tid % (BN // 4)) + j)
                for j in range(4)]
        xs += [(e // (F32_KC // 4), 4 * (e % (F32_KC // 4)) + j)
               for e in range(tid, (BM + 2 * HALO) * (F32_KC // 4),
                              F32_THREADS) for j in range(4)]
    assert sorted(outs) == [(r, n) for r in range(BM) for n in range(BN)]
    assert sorted(wts) == [(c, n) for c in range(F32_KC) for n in range(BN)]
    assert sorted(xs) == [(r, c) for r in range(BM + 2 * HALO)
                          for c in range(F32_KC)]
    # staged rows 80 bytes apart: 16-byte aligned for the float4 stores,
    # and rows r and r + 1 (the two ty of a warp) in distinct banks
    assert F32_LDX * 4 % 16 == 0 and F32_LDX % 32 != 0


def rehearse_f32(x, ws, bs, c0=0):
    """csrc/time_conv_f32.cu's arithmetic, block by block, in numpy."""
    b, w, c = x.shape
    cout = ws[0].shape[2]
    m_rows = b * w
    plan = plan_time_conv_f32(b, w, c, cout)
    xf = x.reshape(m_rows, c).astype(np.float64)
    taps = [wk[j].astype(np.float64) for wk in ws for j in range(len(wk))]
    assert len(taps) == TAPS
    out = np.full((m_rows, cout), np.nan)
    zrow = BM + 2 * HALO
    for bx in range(plan.grid[0]):
        m0 = bx * BM
        rows = m0 + np.arange(BM)
        live = rows < m_rows
        t = rows % w
        for by in range(plan.grid[1]):
            n0 = by * BN
            acc = np.zeros((3, BM, BN))
            for cc in range(0, c, F32_KC):
                xs = np.zeros((zrow + 1, F32_KC))
                for r in range(zrow):
                    gm = m0 - HALO + r
                    if 0 <= gm < m_rows:
                        xs[r] = xf[gm, cc:cc + F32_KC]
                tap = 0
                for branch, k in enumerate((3, 5, 7)):
                    for j in range(k):
                        d = j - k // 2
                        ok = live & (t + d >= 0) & (t + d < w)
                        src = np.where(ok, np.arange(BM) + HALO + d, zrow)
                        acc[branch] += xs[src] @ taps[tap][cc:cc + F32_KC,
                                                          n0:n0 + BN]
                        tap += 1
            for i in np.nonzero(live)[0]:
                m = m0 + i
                cols = slice(c0 + n0, c0 + n0 + BN)
                xv = xf[m, cols]
                xp = xf[m - 1, cols] if t[i] > 0 else np.zeros(BN)
                conv = [acc[k][i] + bs[k][n0:n0 + BN] for k in range(3)]
                out[m, n0:n0 + BN] = np.maximum(
                    np.maximum(np.maximum(xv, conv[0]),
                               np.maximum(conv[1], conv[2])),
                    np.maximum(xv, xp))
    return out.reshape(b, w, cout)


def _operands(rng, b, w, c, cout):
    x = rng.standard_normal((b, w, c)).astype(np.float32)
    ws = [(rng.standard_normal((k, c, cout)) * 0.05).astype(np.float32)
          for k in (3, 5, 7)]
    bs = [(rng.standard_normal(cout) * 0.1).astype(np.float32)
          for _ in range(3)]
    return x, ws, bs


@pytest.mark.parametrize("b,w,c,cout,c0", [
    (3, 7, 64, 64, 0),       # several sequences in one row tile
    (2, 30, 64, 64, 0),      # the window of the pairs task
    (3, 40, 128, 128, 0),    # window 40; rows past B W in the last tile
    (5, 1, 64, 64, 0),       # W = 1: every tap but d = 0 reads the zero row
    (2, 30, 128, 64, 64),    # a column slice: the second of two
])
def test_f32_index_rehearsal_matches_plain(b, w, c, cout, c0):
    rng = np.random.default_rng(b * 100 + w + c0)
    x, ws, bs = _operands(rng, b, w, c, cout)
    got = rehearse_f32(x, ws, bs, c0)
    args = [torch.from_numpy(a) for a in
            (x, ws[0], bs[0], ws[1], bs[1], ws[2], bs[2])]
    want = time_conv_plain(*args, c0=c0).numpy()
    assert not np.isnan(got).any()
    np.testing.assert_allclose(got, want, **TOL)


def _fake_cuda(dtype, b=2, w=30, c=256, cout=256, wdtype=None):
    wdtype = wdtype or dtype
    x = torch.empty((b, w, c), dtype=dtype, device="cuda")
    args = [x]
    for k in (3, 5, 7):
        args += [torch.empty((k, c, cout), dtype=wdtype, device="cuda"),
                 torch.empty((cout,), dtype=F32, device="cuda")]
    return args


@pytest.mark.parametrize("dtype", [BF16, F32])
def test_fake_cuda_ops_take_both_dtypes(dtype):
    """`export-model` of a head in either dtype: the ops' fake
    implementations run the kernels' checks, which take bf16 and f32."""
    with FakeTensorMode():
        out = torch.ops.tmrnet.time_conv.default(*_fake_cuda(dtype))
        assert out.shape == (2, 30, 256) and out.dtype == dtype
        assert out.device.type == "cuda"
        part = torch.ops.tmrnet.time_conv_slice.default(
            *_fake_cuda(dtype, cout=128), 128)
        assert part.shape == (2, 30, 128) and part.dtype == dtype


@pytest.mark.parametrize("dtype,wdtype", [(F32, BF16), (BF16, F32),
                                          (torch.float16, torch.float16)])
def test_fake_cuda_ops_refuse_mixed_and_f16(dtype, wdtype):
    with FakeTensorMode():
        with pytest.raises(TypeError, match="bf16 or f32"):
            torch.ops.tmrnet.time_conv.default(
                *_fake_cuda(dtype, wdtype=wdtype))


def test_f32_operands_keep_the_kernels_other_checks():
    with FakeTensorMode():
        args = _fake_cuda(F32)
        args[2] = torch.empty((256,), dtype=BF16, device="cuda")    # b3
        with pytest.raises(TypeError, match="b3 dtype"):
            torch.ops.tmrnet.time_conv.default(*args)
        with pytest.raises(ValueError, match="C % 64"):
            torch.ops.tmrnet.time_conv.default(*_fake_cuda(F32, c=96,
                                                            cout=96))


def _perturbed(variables, seed):
    """Nonzero biases, so that a dropped term shows."""
    rng = np.random.RandomState(seed)

    def leaf(path, x):
        name = jax.tree_util.keystr(path[-1:])
        if "var" in name or "scale" in name:
            return jnp.asarray(rng.uniform(0.5, 1.5, x.shape), x.dtype)
        if "mean" in name or "bias" in name:
            return jnp.asarray(rng.randn(*x.shape) * 0.1, x.dtype)
        return x

    return jax.tree_util.tree_map_with_path(leaf, variables)


def _load(module, variables):
    tree = jax.tree_util.tree_map(np.asarray, variables)
    module.load_state_dict(from_jax_variables(tree), strict=True)
    return module.eval()


@pytest.mark.parametrize("window", [30, 40])
def test_timeconv_f32_at_the_kernels_width_matches_flax(window):
    """TimeConv at hidden 64 (the f32 kernel's tile), f32, windows 30 and
    40, with JAX's weights carried across: to 1e-5."""
    rng = np.random.RandomState(window)
    x = jnp.asarray(rng.randn(3, window, 64), jnp.float32)
    block = JaxTimeConv(feature_dim=64)
    variables = _perturbed(block.init(jax.random.PRNGKey(3), x), 4)
    want = np.asarray(block.apply(variables, x))
    port = _load(TimeConv(64, torch.float32), variables)
    with torch.no_grad():
        got = port(torch.from_numpy(np.array(x)))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_tmr_model_f32_matches_flax():
    """A whole tmr model (tiny trunk, hidden 64, window 30) at
    compute_dtype float32 against JAX's: the head's TimeConv, NLBlock and
    classifier on JAX's weights, to 1e-5."""
    kw = dict(backbone="tiny", stage_sizes=(1, 1), width=8, hidden_dim=64,
              num_classes=7, head="tmr", compute_dtype="float32")
    rng = np.random.RandomState(6)
    clips = jnp.asarray(rng.rand(2, 3, 32, 32, 3), jnp.float32)
    memory = jnp.asarray(rng.randn(2, 30, 64), jnp.float32)
    model = jax_build_model(JaxModelConfig(**kw))
    variables = _perturbed(model.init(jax.random.PRNGKey(6), clips, memory),
                           7)
    want = np.asarray(model.apply(variables, clips, memory, train=False))
    port = _load(build_model(ModelConfig(**kw), device="cpu"), variables)
    assert port.time_conv.compute_dtype == torch.float32
    # the kernel's prepared weights are f32, in the flax layout
    prepared = port.time_conv.kernel_args()
    assert all(p.dtype == torch.float32 for p in prepared)
    assert prepared[0].shape == (3, 64, 64)
    with torch.no_grad():
        got = port(torch.from_numpy(np.array(clips)),
                   torch.from_numpy(np.array(memory))).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("dtype,where,exact", [
    ("float32", "cuda", True), ("float32", "cuda:1", True),
    (torch.float32, "cuda:0", True), ("bfloat16", "cuda", False),
    ("float32", "cpu", False), ("bfloat16", "cpu", False)])
def test_exact_f32_only_for_f32_on_the_card(dtype, where, exact):
    assert port_device.exact_f32(dtype, where) is exact


def test_set_precision_turns_tf32_off_for_f32_on_the_card():
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    try:
        for where, dtype in (("cpu", "float32"), ("cuda", "bfloat16")):
            torch.backends.cudnn.allow_tf32 = True
            torch.backends.cuda.matmul.allow_tf32 = True
            port_device.set_precision(dtype, where)     # left as they are
            assert torch.backends.cudnn.allow_tf32
            assert torch.backends.cuda.matmul.allow_tf32
        port_device.set_precision("float32", "cuda")
        assert not torch.backends.cudnn.allow_tf32
        assert not torch.backends.cuda.matmul.allow_tf32
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved
