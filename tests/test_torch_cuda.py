"""The port's Hopper kernels on the card, against their plain versions on
the same inputs; wrapper checks and launch counts; a small folded
ResNet-50 TMRNet on the card, on the block and the tiled fused path, and a
ResNeSt-50 one (folded and not; its trunk launches no fused kernel),
against the same model in f32 on the CPU; and the video and stream engines
(on both trunks) on the card against the video engine in f32 on the CPU.

Needs a CUDA card and skips without one. The card has no JAX, so this file
imports none and runs without the repository's conftest:

    python -m pytest tests/test_torch_cuda.py -q --noconftest

Tolerance: max |kernel - plain| <= 2e-2 * max |plain|. The kernels take
bf16 inputs and round their output (and the fused bottleneck its y1 and y2)
to bf16, 2^-8 relative each; the plain versions run in f32 (TF32 off).
The f32 time_conv and bottleneck kernels are held to 1e-5 of max |plain|:
the same f32 products, summed in another order (TF32 off for the plain
version). A folded f32 ResNet-50 TMRNet on the card is held to the CPU's
softmax within 1e-3.
The int8 kernels are held to their plain versions bit for bit: both sum the
integer products exactly and take the same f32 epilogue steps. The two
bf16 bottleneck kernels are held to equal bits only against themselves, on
a repeated call.
"""

import numpy as np
import pytest
import torch

from tmrnet_torch.experimental.fused_bottleneck import (
    fused_bottleneck_cuda,
    fused_bottleneck_plain,
    plan_bottleneck_f32,
)
from tmrnet_torch.experimental.fused_bottleneck_tiled import (
    fused_bottleneck_tiled_cuda,
    plan_bottleneck_tiled_f32,
)
from tmrnet_torch.experimental.quant_conv import (
    PLANS,
    int8_conv3x3_cuda,
    int8_conv3x3_plain,
    wgmma_s8_tile_cuda,
)
from tmrnet_torch.kernels.build import LAUNCHES, reset_launches
from tmrnet_torch.ops.nl_attention import nl_attention_cuda, nl_attention_plain
from tmrnet_torch.ops.quant import (
    MATMUL_PLANS,
    Int8Plan,
    int8_matmul_cuda,
    int8_matmul_plain,
)
from tmrnet_torch.ops.time_conv import (
    plan_time_conv,
    time_conv_cuda,
    time_conv_max_rows,
    time_conv_plain,
)

REL = 2e-2


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _randn(gen, shape, scale=1.0, dtype=torch.bfloat16):
    return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)


def _close(got, want, rel=REL):
    err = (got.float() - want.float()).abs().max().item()
    assert err <= rel * want.float().abs().max().item(), err


@pytest.mark.parametrize("b,w,f", [(32, 30, 512), (5, 7, 64), (3, 40, 200)])
def test_nl_attention_kernel(gen, b, w, f):
    q, k, v = (_randn(gen, s) for s in ((b, f), (b, w, f), (b, w, f)))
    _close(nl_attention_cuda(q, k, v),
           nl_attention_plain(q.float(), k.float(), v.float()))
    qf, kf, vf = q.float(), k.float(), v.float()
    torch.testing.assert_close(nl_attention_cuda(qf, kf, vf),
                               nl_attention_plain(qf, kf, vf),
                               rtol=1e-5, atol=1e-5)


def _tc_weights(gen, c):
    out = []
    for k in (3, 5, 7):
        out += [_randn(gen, (k, c, c), (1.0 / (k * c)) ** 0.5),
                _randn(gen, (c,), 0.02, torch.float32)]
    return out


@pytest.mark.parametrize("b,w,c", [(32, 30, 512), (3, 7, 64), (5, 13, 128),
                                   (1, 1, 64)])
def test_time_conv_kernel(gen, b, w, c):
    x = _randn(gen, (b, w, c))
    ws = _tc_weights(gen, c)
    _close(time_conv_cuda(x, *ws),
           time_conv_plain(x.float(), *(t.float() for t in ws)))


# Cases the kernel's plan can get wrong: window 40 (the JAX configs'
# largest); 96 clips (bench.py's batch); C = 1024 (x staged whole, 224 KB
# of shared memory); C = 2048 (x in four channel chunks through two
# buffers); C = 192 (K chunks of 64) and 1152 (of 128, x in three chunks);
# a W that does not divide the 64-row tile, and a sequence longer than one
# (W = 70).
@pytest.mark.parametrize("b,w,c", [(32, 40, 512), (96, 30, 512), (4, 30, 1024),
                                   (2, 17, 2048), (3, 11, 192), (2, 9, 1152),
                                   (3, 37, 128), (2, 70, 256)])
def test_time_conv_kernel_plans(gen, b, w, c):
    x = _randn(gen, (b, w, c))
    ws = _tc_weights(gen, c)
    _close(time_conv_cuda(x, *ws),
           time_conv_plain(x.float(), *(t.float() for t in ws)))


# The same inputs twice give the same bits: a race on the ring or on the
# staged x buffers would not.
@pytest.mark.parametrize("b,w,c", [(32, 30, 512), (2, 17, 2048), (3, 11, 192)])
def test_time_conv_kernel_repeats_bit_for_bit(gen, b, w, c):
    x = _randn(gen, (b, w, c))
    ws = _tc_weights(gen, c)
    first = time_conv_cuda(x, *ws)
    for _ in range(3):
        assert torch.equal(time_conv_cuda(x, *ws), first)


# Column slices of a layer (tensor parallelism over M ranks): each slice
# against the plain version's slice, and the M slices side by side equal
# to the whole call bit for bit (each output column's arithmetic is the
# same); plans with x staged once and in two buffers (C = 2048).
@pytest.mark.parametrize("b,w,c,m", [(8, 30, 512, 2), (8, 30, 512, 4),
                                     (2582, 30, 512, 2), (3, 11, 192, 3),
                                     (2, 17, 2048, 4), (2, 70, 256, 2)])
def test_time_conv_kernel_column_slices(gen, b, w, c, m):
    x = _randn(gen, (b, w, c))
    ws = _tc_weights(gen, c)
    cout = c // m
    parts = []
    for j in range(m):
        c0 = j * cout
        sl = [t[..., c0:c0 + cout].contiguous() if t.dim() == 3
              else t[c0:c0 + cout].contiguous() for t in ws]
        reset_launches()
        parts.append(time_conv_cuda(x, *sl, c0=c0))
        assert dict(LAUNCHES) == {"time_conv": 1}
        _close(parts[-1], time_conv_plain(x.float(), *(t.float() for t in sl),
                                          c0=c0))
    assert torch.equal(torch.cat(parts, dim=-1), time_conv_cuda(x, *ws))


def test_time_conv_kernel_refuses_a_slice_off_the_tiles(gen):
    x = _randn(gen, (2, 3, 128))
    ws = [t[..., :64].contiguous() if t.dim() == 3 else t[:64].contiguous()
          for t in _tc_weights(gen, 128)]
    for c0 in (32, 96):
        with pytest.raises(ValueError, match="column slice"):
            time_conv_cuda(x, *ws, c0=c0)


# The f32 kernel (csrc/time_conv_f32.cu: FFMA, no TF32) against the
# plain version in f32 with TF32 off: max |diff| <= 1e-5 max |plain| (the
# same f32 products, summed in another order); one launch of
# time_conv_f32 a call. Windows 30 and 40, sequences shorter and longer
# than the 64-row tile, C from 64 to 1024, B at the engines' 2,582.
F32_REL = 1e-5


def _tc_f32(gen, b, w, c):
    x = _randn(gen, (b, w, c), dtype=torch.float32)
    return x, [t.float() for t in _tc_weights(gen, c)]


@pytest.mark.parametrize("b,w,c", [(32, 30, 512), (3, 7, 64), (5, 13, 128),
                                   (1, 1, 64), (32, 40, 512), (2, 70, 256),
                                   (3, 37, 128), (4, 30, 1024),
                                   (2582, 30, 512)])
def test_time_conv_f32_kernel(gen, b, w, c):
    x, ws = _tc_f32(gen, b, w, c)
    reset_launches()
    got = time_conv_cuda(x, *ws)
    assert dict(LAUNCHES) == {"time_conv_f32": 1}
    assert got.dtype == torch.float32 and got.shape == (b, w, c)
    _close(got, time_conv_plain(x, *ws), F32_REL)


def test_time_conv_f32_kernel_repeats_bit_for_bit(gen):
    x, ws = _tc_f32(gen, 32, 30, 512)
    first = time_conv_cuda(x, *ws)
    for _ in range(3):
        assert torch.equal(time_conv_cuda(x, *ws), first)


@pytest.mark.parametrize("b,w,c,m", [(8, 30, 512, 2), (8, 30, 512, 4),
                                     (2582, 30, 512, 2), (2, 70, 256, 2)])
def test_time_conv_f32_kernel_column_slices(gen, b, w, c, m):
    x, ws = _tc_f32(gen, b, w, c)
    cout = c // m
    parts = []
    for j in range(m):
        c0 = j * cout
        sl = [t[..., c0:c0 + cout].contiguous() if t.dim() == 3
              else t[c0:c0 + cout].contiguous() for t in ws]
        reset_launches()
        parts.append(time_conv_cuda(x, *sl, c0=c0))
        assert dict(LAUNCHES) == {"time_conv_f32": 1}
        _close(parts[-1], time_conv_plain(x, *sl, c0=c0), F32_REL)
    assert torch.equal(torch.cat(parts, dim=-1), time_conv_cuda(x, *ws))


def test_time_conv_f32_past_the_limit_splits(gen):
    """B = 139,811 at W = 30, C = 512 (~8.6 GB of f32), one row past one
    launch's 32-bit limit: two launches of time_conv_f32, and the rows at
    the split and 256 seeded others match the plain version."""
    b, w, c = time_conv_max_rows(30, 512) + 1, 30, 512
    x = torch.randn((b, w, c), generator=gen, device="cuda")
    ws = [t.float() for t in _tc_weights(gen, c)]
    reset_launches()
    out = time_conv_cuda(x, *ws)
    assert dict(LAUNCHES) == {"time_conv_f32": 2}
    rows = torch.cat([torch.arange(b - 3, b, device="cuda"),
                      torch.randint(0, b, (256,), generator=gen,
                                    device="cuda")])
    _close(out[rows], time_conv_plain(x[rows], *ws), F32_REL)
    del x, out


def test_time_conv_f32_refuses_mixed_dtypes_and_odd_shapes(gen):
    x, ws = _tc_f32(gen, 2, 3, 64)
    with pytest.raises(TypeError, match="bf16 or f32"):
        time_conv_cuda(x, *[t.bfloat16() if t.dim() == 3 else t for t in ws])
    with pytest.raises(TypeError, match="bf16 or f32"):
        time_conv_cuda(x.half(), *[t.half() if t.dim() == 3 else t
                                   for t in ws])
    x48, ws48 = _tc_f32(gen, 2, 3, 48)
    with pytest.raises(ValueError, match="C % 64"):
        time_conv_cuda(x48, *ws48)
    flat = torch.empty(x.numel() + 1, device="cuda")
    x_off = flat[1:].view(x.shape).copy_(x)
    with pytest.raises(ValueError, match="16-byte aligned"):
        time_conv_cuda(x_off, *ws)


def test_timeconv_module_f32_on_the_card(gen):
    """models/blocks.py::TimeConv at compute_dtype float32 on the card:
    the forward through the f32 kernel (one launch) against the same
    module on the CPU, and its gradients (the plain f32 recompute)
    against the CPU's, both to 1e-5 of their largest value."""
    from tmrnet_torch.models.blocks import TimeConv

    torch.manual_seed(0)
    cpu = TimeConv(512, torch.float32)
    card = TimeConv(512, torch.float32).cuda()
    card.load_state_dict(cpu.state_dict())
    x = torch.randn((8, 30, 512), generator=gen, device="cuda")
    xc = x.cpu().requires_grad_(True)
    xg = x.clone().requires_grad_(True)
    reset_launches()
    got = card(xg)
    assert dict(LAUNCHES) == {"time_conv_f32": 1}
    want = cpu(xc)
    _close(got.cpu(), want, F32_REL)
    got.square().sum().backward()
    want.square().sum().backward()
    _close(xg.grad.cpu(), xc.grad, F32_REL)
    _close(card.conv_k7.weight.grad.cpu(), cpu.conv_k7.weight.grad, F32_REL)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_nl_attention_kernel_repeats_bit_for_bit(gen, dtype):
    q, k, v = (_randn(gen, s, dtype=dtype)
               for s in ((32, 512), (32, 30, 512), (32, 30, 512)))
    first = nl_attention_cuda(q, k, v)
    for _ in range(3):
        assert torch.equal(nl_attention_cuda(q, k, v), first)


def test_head_kernels_refuse_what_they_cannot_take(gen):
    # a row of 60 bf16 is 120 bytes, not a multiple of the copies' 16
    q, k = _randn(gen, (2, 60)), _randn(gen, (2, 3, 60))
    with pytest.raises(ValueError, match="16 bytes"):
        nl_attention_cuda(q, k, k)
    # k and v of 120 x 512 bf16 (240 KB) exceed a block's shared memory
    q, k = _randn(gen, (2, 512)), _randn(gen, (2, 120, 512))
    with pytest.raises(ValueError, match="shared memory"):
        nl_attention_cuda(q, k, k)
    # k 8 bytes off a 16-byte boundary
    k = _randn(gen, (2, 3, 64))
    flat = torch.empty(k.numel() + 4, dtype=torch.bfloat16, device="cuda")
    k_off = flat[4:].view(k.shape).copy_(k)
    with pytest.raises(ValueError, match="16-byte aligned"):
        nl_attention_cuda(_randn(gen, (2, 64)), k_off, k)
    # B*W*C past 32-bit offsets: one launch is refused (the wrapper splits
    # such a call, test_time_conv_past_the_limit_splits)
    with pytest.raises(ValueError, match="32-bit"):
        plan_time_conv(65536, 64, 512)
    # and a row that alone passes them
    x = _randn(gen, (1, 1, 64)).expand(1, 33554432, 64)
    with pytest.raises(ValueError, match="32-bit"):
        time_conv_cuda(x, *_tc_weights(gen, 64))


def test_time_conv_past_the_limit_splits(gen):
    """B = 139,811 at W = 30, C = 512 (~4.3 GB of bf16), one row past one
    launch's 32-bit limit: two launches, and the rows at the split and 256
    seeded others match the plain version."""
    b, w, c = time_conv_max_rows(30, 512) + 1, 30, 512
    x = torch.randn((b, w, c), generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    ws = _tc_weights(gen, c)
    reset_launches()
    out = time_conv_cuda(x, *ws)
    assert dict(LAUNCHES) == {"time_conv": 2}
    rows = torch.cat([torch.arange(b - 3, b, device="cuda"),
                      torch.randint(0, b, (256,), generator=gen,
                                    device="cuda")])
    _close(out[rows], time_conv_plain(x[rows].float(),
                                      *(t.float() for t in ws)))


def _fb_args(gen, n, h, w, c, p, b1_shift=0.0):
    return (torch.relu(_randn(gen, (n, h, w, c))),
            _randn(gen, (c, p), (2.0 / c) ** 0.5),
            _randn(gen, (p,), 0.05, torch.float32).abs() * 20 + b1_shift
            if b1_shift else _randn(gen, (p,), 0.05, torch.float32),
            _randn(gen, (3, 3, p, p), (2.0 / (9 * p)) ** 0.5),
            _randn(gen, (p,), 0.05, torch.float32),
            _randn(gen, (p, c), 0.25 * (2.0 / p) ** 0.5),
            _randn(gen, (c,), 0.05, torch.float32))


@pytest.mark.parametrize("n,h,w,c,p", [
    (2, 56, 56, 256, 64), (2, 28, 28, 512, 128), (2, 14, 14, 1024, 256),
    (2, 7, 7, 2048, 512), (1, 5, 9, 256, 64), (3, 1, 1, 128, 64)])
def test_fused_bottleneck_kernel(gen, n, h, w, c, p):
    args = _fb_args(gen, n, h, w, c, p)
    _close(fused_bottleneck_cuda(*args),
           fused_bottleneck_plain(*(t.float() for t in args)))


# Cases the kernel's plan can get wrong (plan_bottleneck decides at each):
# one image, at stage 3 (2 blocks) and stage 4 (a partial second tile);
# a partial last row tile at stage 3's width, with y2 in its own region
# and over y1; a W whose output rows cross the warps' 64-row tiles (30
# columns; 13 columns, a 65-row tile); stage 1 at its main-path plan.
@pytest.mark.parametrize("n,h,w,c,p", [
    (1, 14, 14, 1024, 256), (1, 7, 7, 2048, 512), (4, 17, 14, 1024, 256),
    (64, 17, 14, 1024, 256), (2, 5, 30, 512, 128), (3, 10, 13, 1024, 256),
    (40, 56, 56, 256, 64)])
def test_fused_bottleneck_kernel_plans(gen, n, h, w, c, p):
    from tmrnet_torch.experimental.fused_bottleneck import plan_bottleneck

    plan = plan_bottleneck(n, h, w, c, p)
    if (n, h) in ((1, 7), (4, 17), (64, 17)):
        assert h % plan.th, plan          # the last row tile is partial
    args = _fb_args(gen, n, h, w, c, p)
    _close(fused_bottleneck_cuda(*args),
           fused_bottleneck_plain(*(t.float() for t in args)))


# b1 large and positive: relu(b1) != 0 on the halo would show at every
# image border.
@pytest.mark.parametrize("n,h,w,c,p", [(2, 7, 7, 2048, 512), (1, 5, 9, 256, 64),
                                       (4, 17, 14, 1024, 256)])
def test_fused_bottleneck_kernel_zero_halo(gen, n, h, w, c, p):
    args = _fb_args(gen, n, h, w, c, p, b1_shift=2.0)
    _close(fused_bottleneck_cuda(*args),
           fused_bottleneck_plain(*(t.float() for t in args)))


# The same inputs twice give the same bits: a race on the cp.async ring or
# on y2 over y1 would not.
@pytest.mark.parametrize("n,h,w,c,p", [(64, 7, 7, 2048, 512),
                                       (32, 14, 14, 1024, 256),
                                       (16, 56, 56, 256, 64)])
def test_fused_bottleneck_kernel_repeats_bit_for_bit(gen, n, h, w, c, p):
    args = _fb_args(gen, n, h, w, c, p)
    first = fused_bottleneck_cuda(*args)
    for _ in range(3):
        assert torch.equal(fused_bottleneck_cuda(*args), first)


def test_wrappers_check_their_inputs(gen):
    q = _randn(gen, (2, 64))
    k = _randn(gen, (2, 3, 64))
    with pytest.raises(TypeError):
        nl_attention_cuda(q.float(), k, k)
    with pytest.raises(ValueError, match="contiguous"):
        nl_attention_cuda(q, k.transpose(0, 1).contiguous().transpose(0, 1), k)
    x = _randn(gen, (2, 3, 64))
    ws = _tc_weights(gen, 64)
    with pytest.raises(TypeError):
        time_conv_cuda(x.float(), *ws)
    with pytest.raises(ValueError, match="C % 64"):
        time_conv_cuda(_randn(gen, (2, 3, 48)), *_tc_weights(gen, 48))
    args = list(_fb_args(gen, 1, 4, 4, 256, 64))
    nchw = args[0].permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    with pytest.raises(ValueError, match="NHWC-contiguous"):
        fused_bottleneck_cuda(nchw, *args[1:])
    with pytest.raises(ValueError, match="65535 images"):
        fused_bottleneck_cuda(args[0].expand(65536, 4, 4, 256), *args[1:])
    args[2] = args[2].bfloat16()
    with pytest.raises(TypeError):
        fused_bottleneck_cuda(*args)


def test_launch_counts(gen):
    reset_launches()
    q = _randn(gen, (2, 64))
    k = _randn(gen, (2, 3, 64))
    nl_attention_cuda(q, k, k)
    nl_attention_cuda(q, k, k)
    time_conv_cuda(_randn(gen, (2, 3, 64)), *_tc_weights(gen, 64))
    fused_bottleneck_cuda(*_fb_args(gen, 1, 4, 4, 256, 64))
    assert dict(LAUNCHES) == {"nl_attention": 2, "time_conv": 1,
                              "fused_bottleneck": 1}


def _folded_resnet50_card_vs_cpu(fused_kernel, backbone="resnet50",
                                 folded=True, dtype="bfloat16", tol=2e-2):
    from tmrnet_torch.config import ModelConfig
    from tmrnet_torch.models.convert import from_jax_variables, random_variables
    from tmrnet_torch.models.fold_bn import fold_variables
    from tmrnet_torch.models.tmrnet import build_model

    kw = dict(backbone=backbone, hidden_dim=512, head="tmr", folded=folded)
    state = from_jax_variables(random_variables(
        ModelConfig(**dict(kw, folded=False)), seed=1))
    if folded:
        state = fold_variables(state)
    card = build_model(ModelConfig(**kw, compute_dtype=dtype),
                       fused_kernel=fused_kernel)
    card.load_state_dict(state, strict=True)
    cpu = build_model(ModelConfig(**kw, compute_dtype="float32"), device="cpu",
                      fused_kernel=fused_kernel)
    cpu.load_state_dict(state, strict=True)
    rng = np.random.default_rng(2)
    clips = torch.from_numpy(rng.standard_normal((2, 3, 64, 64, 3), np.float32))
    memory = torch.from_numpy(rng.standard_normal((2, 30, 512), np.float32))
    reset_launches()
    with torch.no_grad():
        got = torch.softmax(card(clips.cuda(), memory.cuda()).float(), -1)
        want = torch.softmax(cpu(clips, memory), -1)
    counts = dict(LAUNCHES)
    assert (got.cpu() - want).abs().max().item() <= tol
    return counts


def test_folded_resnet50_tmrnet_on_card_matches_cpu(gen):
    assert _folded_resnet50_card_vs_cpu("block") == {
        "fused_bottleneck": 12, "time_conv": 1, "nl_attention": 1}


def test_folded_resnet50_tiled_path_on_card_matches_cpu(gen):
    assert _folded_resnet50_card_vs_cpu("tiled") == {
        "fused_bottleneck_tiled": 10, "fused_bottleneck": 2, "time_conv": 1,
        "nl_attention": 1}


@pytest.mark.parametrize("fused_kernel,want", [
    ("block", {"fused_bottleneck_f32": 12}),
    ("tiled", {"fused_bottleneck_tiled_f32": 10, "fused_bottleneck_f32": 2})])
def test_folded_f32_resnet50_tmrnet_on_card_matches_cpu(gen, fused_kernel,
                                                        want):
    """model.folded=true at float32: the identity blocks on the f32
    kernels, no bf16 bottleneck launch, the softmax within 1e-3 of the
    CPU's f32."""
    assert _folded_resnet50_card_vs_cpu(
        fused_kernel, dtype="float32", tol=1e-3) == {
            **want, "time_conv_f32": 1, "nl_attention": 1}


@pytest.mark.parametrize("folded", [True, False])
@pytest.mark.parametrize("fused_kernel", ["block", "tiled"])
def test_resnest50_tmrnet_on_card_matches_cpu(gen, fused_kernel, folded):
    assert _folded_resnet50_card_vs_cpu(fused_kernel, "resnest50", folded) == {
        "time_conv": 1, "nl_attention": 1}


def test_resnest_video_and_stream_engines_on_card_match_cpu(gen):
    """The video engine (in trunk chunks of 5 frames) and a 2-stream
    StreamingInference on a folded ResNeSt at ResNeSt-50's widths, one
    block a stage, on the card against the video engine in f32 on the
    CPU; one time_conv and one nl_attention a head call or a step, and no
    fused-bottleneck launch."""
    from tmrnet_torch.config import (DataConfig, ExperimentConfig,
                                     MemoryConfig, ModelConfig)
    from tmrnet_torch.eval.infer import VideoInference
    from tmrnet_torch.eval.stream import StreamingInference
    from tmrnet_torch.models.convert import from_jax_variables, random_variables
    from tmrnet_torch.models.fold_bn import fold_variables

    kw = dict(backbone="resnest50", stage_sizes=(1, 1, 1, 1), hidden_dim=512,
              head="tmr")
    weights = [fold_variables(from_jax_variables(random_variables(
        ModelConfig(**dict(kw, head=head)), seed))) for head, seed in
        (("tmr", 1), ("lfb", 2))]
    cfg = lambda cdt: ExperimentConfig(
        data=DataConfig(device_normalize=True),
        model=ModelConfig(**kw, folded=True, compute_dtype=cdt),
        memory=MemoryConfig(window=30))
    rng = np.random.default_rng(3)
    videos = [rng.integers(0, 256, (12, 64, 64, 3), dtype=np.uint8)
              for _ in range(2)]
    want = [VideoInference(cfg("float32"), *weights, device="cpu")
            .run_video(v)[1] for v in videos]
    card = VideoInference(cfg("bfloat16"), *weights, backbone_chunk=5)
    reset_launches()
    _, got = card.run_video(videos[0])
    assert dict(LAUNCHES) == {"time_conv": 1, "nl_attention": 1}
    assert np.abs(got - want[0]).max() <= REL
    stream = StreamingInference(cfg("bfloat16"), *weights)
    state, outs = stream.init_state(2), []
    for t in range(12):
        reset_launches()
        state, _, probs, valid = stream.step(
            state, torch.from_numpy(np.stack([v[t] for v in videos])).cuda())
        assert dict(LAUNCHES) == {"time_conv": 1, "nl_attention": 1}
        outs.append(probs.cpu().numpy())
    got = np.stack(outs[9:], axis=1)                  # (streams, clips, C)
    assert np.abs(got - np.stack(want)).max() <= REL


def test_video_and_stream_engines_on_card_match_cpu(gen):
    """VideoInference (unchunked, and in trunk chunks of 5 frames) and
    StreamingInference on the card against VideoInference in f32 on the
    CPU, at ResNet-50's widths with one identity block (stage 1's second);
    launch counts: one fused_bottleneck a trunk chunk a trunk, one
    time_conv and one nl_attention a head call or a stream step."""
    from tmrnet_torch.config import (DataConfig, ExperimentConfig,
                                     MemoryConfig, ModelConfig)
    from tmrnet_torch.eval.infer import VideoInference
    from tmrnet_torch.eval.stream import StreamingInference
    from tmrnet_torch.models.convert import from_jax_variables, random_variables
    from tmrnet_torch.models.fold_bn import fold_variables

    kw = dict(backbone="resnet50", stage_sizes=(2, 1, 1, 1), hidden_dim=512,
              head="tmr")
    weights = [fold_variables(from_jax_variables(random_variables(
        ModelConfig(**dict(kw, head=head)), seed))) for head, seed in
        (("tmr", 1), ("lfb", 2))]
    cfg = lambda cdt: ExperimentConfig(
        data=DataConfig(device_normalize=True),
        model=ModelConfig(**kw, folded=True, compute_dtype=cdt),
        memory=MemoryConfig(window=30))
    rng = np.random.default_rng(3)
    videos = [rng.integers(0, 256, (14, 64, 64, 3), dtype=np.uint8)
              for _ in range(2)]
    cpu = VideoInference(cfg("float32"), *weights, device="cpu")
    want = [cpu.run_video(v)[1] for v in videos]
    for chunk, trunk_chunks in ((0, 1), (5, 3)):
        card = VideoInference(cfg("bfloat16"), *weights, backbone_chunk=chunk)
        reset_launches()
        _, got = card.run_video(videos[0])
        assert dict(LAUNCHES) == {"fused_bottleneck": 2 * trunk_chunks,
                                  "time_conv": 1, "nl_attention": 1}
        assert np.abs(got - want[0]).max() <= REL
    stream = StreamingInference(cfg("bfloat16"), *weights)
    state, outs = stream.init_state(2), []
    for t in range(14):
        reset_launches()
        state, _, probs, valid = stream.step(
            state, torch.from_numpy(np.stack([v[t] for v in videos])).cuda())
        assert dict(LAUNCHES) == {"fused_bottleneck": 2, "time_conv": 1,
                                  "nl_attention": 1}
        assert bool(valid.all()) == (t >= 9)
        outs.append(probs.cpu().numpy())
    got = np.stack(outs[9:], axis=1)                  # (streams, clips, C)
    assert np.abs(got - np.stack(want)).max() <= REL


def test_serve_loop_on_card_matches_cpu(gen):
    """serve_loop over StreamingInference on the card (bf16, folded,
    ResNet-50 widths with one identity block) against the same loop over
    the engine in f32 on the CPU: 3 streams through 2 slots with a join,
    an end and a recycle, a no-free-slot error and a dropped tick. Same
    rows but for probabilities (within 2e-2) and preds where the CPU's two
    best lie within 4e-2; one fused_bottleneck a trunk, one time_conv and
    one nl_attention a tick, the warm-up tick included."""
    import io
    import json

    from tmrnet_torch.config import (DataConfig, ExperimentConfig,
                                     MemoryConfig, ModelConfig)
    from tmrnet_torch.eval.serve import serve_loop
    from tmrnet_torch.eval.stream import StreamingInference
    from tmrnet_torch.models.convert import from_jax_variables, random_variables
    from tmrnet_torch.models.fold_bn import fold_variables

    kw = dict(backbone="resnet50", stage_sizes=(2, 1, 1, 1), hidden_dim=512,
              head="tmr")
    weights = [fold_variables(from_jax_variables(random_variables(
        ModelConfig(**dict(kw, head=head)), seed))) for head, seed in
        (("tmr", 5), ("lfb", 6))]
    cfg = lambda cdt: ExperimentConfig(
        data=DataConfig(device_normalize=True),
        model=ModelConfig(**kw, folded=True, compute_dtype=cdt),
        memory=MemoryConfig(window=30))
    rng = np.random.default_rng(7)
    frames = {f"{k}{t}": rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)
              for k in "abc" for t in range(14)}
    lines = []
    for t in range(14):
        if t != 6:                                   # a drops tick 6
            lines.append({"id": "a", "image": f"a{t}"})
        if t < 11:
            lines.append({"id": "b", "image": f"b{t}"})
        if t == 2:
            lines.append({"id": "c", "image": "c0"})  # no free slot
        if t == 11:
            lines.append({"id": "b", "end": True})
        if t >= 11:
            lines.append({"id": "c", "image": f"c{t - 11}"})
        lines.append({"step": True})
    text = "".join(json.dumps(o) + "\n" for o in lines)
    outs = []
    for device, cdt in (("cuda", "bfloat16"), ("cpu", "float32")):
        engine = StreamingInference(cfg(cdt), *weights, device=device)
        out = io.StringIO()
        reset_launches()
        serve_loop(engine, 2, io.StringIO(text), out, frames.__getitem__,
                   emit_probs=True, warmup_shape=(64, 64, 3),
                   warmup_dtype=np.uint8)
        if device == "cuda":
            ticks = 1 + 14                           # the warm-up tick too
            assert dict(LAUNCHES) == {"fused_bottleneck": 2 * ticks,
                                      "time_conv": ticks,
                                      "nl_attention": ticks}
        outs.append([json.loads(line) for line in out.getvalue().splitlines()])
    got, want = outs
    assert len(got) == len(want)
    assert sum(r.get("valid", False) for r in want) == 4 + 2   # a, b
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k, v in w.items():
            if k == "probs":
                assert np.abs(np.subtract(g[k], v)).max() <= REL
            elif k == "pred" and v is not None and g[k] != v:
                top2 = np.sort(w["probs"])[-2:]
                assert top2[1] - top2[0] <= 2 * REL
            else:
                assert g[k] == v


# Stage shapes; a partial last H tile (57 and 29 rows at the 2-row tiles of
# stages 1-2); small odd images.
@pytest.mark.parametrize("n,h,w,c,p", [
    (2, 56, 56, 256, 64), (2, 28, 28, 512, 128), (2, 14, 14, 1024, 256),
    (2, 7, 7, 2048, 512), (1, 57, 56, 256, 64), (1, 29, 28, 512, 128),
    (1, 5, 9, 256, 64), (3, 1, 1, 128, 64), (2, 13, 7, 64, 128)])
def test_fused_bottleneck_tiled_kernel(gen, n, h, w, c, p):
    args = _fb_args(gen, n, h, w, c, p)
    _close(fused_bottleneck_tiled_cuda(*args),
           fused_bottleneck_plain(*(t.float() for t in args)))


# Cases the tiled kernel's plan can get wrong (plan_bottleneck_tiled
# decides at each): more (image, row tile) blocks than SMs; W not dividing
# the block tile (13 into 128, 29 into 256); a wide row (W = 100: two
# image rows a phase-1 box); P = 1024 (two column passes in phases 1-2, y2
# in its own region); W = 256, a TMA box's widest.
@pytest.mark.parametrize("n,h,w,c,p", [
    (300, 14, 14, 1024, 256), (3, 10, 13, 1024, 256), (2, 5, 29, 512, 128),
    (1, 6, 100, 512, 128), (1, 5, 7, 1024, 1024), (1, 3, 256, 128, 64)])
def test_fused_bottleneck_tiled_kernel_plans(gen, n, h, w, c, p):
    from tmrnet_torch.experimental.fused_bottleneck_tiled import (
        plan_bottleneck_tiled)

    plan = plan_bottleneck_tiled(n, h, w, c, p)
    if n == 300:
        assert n * -(-h // plan.th) > 132
    args = _fb_args(gen, n, h, w, c, p)
    _close(fused_bottleneck_tiled_cuda(*args),
           fused_bottleneck_plain(*(t.float() for t in args)))


# b1 large and positive: relu(b1) != 0 on the zero-filled halo and pad
# columns would show at every image border.
@pytest.mark.parametrize("n,h,w,c,p", [(2, 7, 7, 2048, 512), (1, 5, 9, 256, 64),
                                       (4, 17, 14, 1024, 256),
                                       (2, 56, 56, 256, 64)])
def test_fused_bottleneck_tiled_kernel_zero_halo(gen, n, h, w, c, p):
    args = _fb_args(gen, n, h, w, c, p, b1_shift=2.0)
    _close(fused_bottleneck_tiled_cuda(*args),
           fused_bottleneck_plain(*(t.float() for t in args)))


# The same inputs twice give the same bits: a slot refilled before every
# warp released it (a wrong mbarrier parity), or a race on y2 over y1 or on
# the residual tile, would not.
@pytest.mark.parametrize("n,h,w,c,p", [(32, 14, 14, 1024, 256),
                                       (16, 56, 56, 256, 64),
                                       (32, 28, 28, 512, 128)])
def test_fused_bottleneck_tiled_kernel_repeats_bit_for_bit(gen, n, h, w, c, p):
    args = _fb_args(gen, n, h, w, c, p)
    first = fused_bottleneck_tiled_cuda(*args)
    for _ in range(3):
        assert torch.equal(fused_bottleneck_tiled_cuda(*args), first)


def test_fused_bottleneck_tiled_refuses_what_tma_cannot_copy(gen):
    # W > 256: x's boxes would be wider than a TMA box may be
    with pytest.raises(ValueError, match="256"):
        fused_bottleneck_tiled_cuda(*_fb_args(gen, 1, 2, 257, 64, 64))
    # x 8 bytes off a 16-byte boundary
    args = list(_fb_args(gen, 1, 4, 4, 256, 64))
    flat = torch.empty(args[0].numel() + 4, dtype=torch.bfloat16, device="cuda")
    args[0] = flat[4:].view(args[0].shape).copy_(args[0])
    with pytest.raises(ValueError, match="16-byte"):
        fused_bottleneck_tiled_cuda(*args)


F32_BOTTLENECKS = {"block": fused_bottleneck_cuda,
                   "tiled": fused_bottleneck_tiled_cuda}


def _fb_f32(gen, *shape, b1_shift=0.0):
    return tuple(t.float() for t in _fb_args(gen, *shape, b1_shift=b1_shift))


# ResNet-50's four identity stages at an even and an odd N, then shapes
# the plans cut otherwise: partial last tiles, several row tiles in every
# phase (block), one-row images, W not dividing the block tile.
@pytest.mark.parametrize("kernel", sorted(F32_BOTTLENECKS))
@pytest.mark.parametrize("n,h,w,c,p", [
    (2, 56, 56, 256, 64), (2, 28, 28, 512, 128), (2, 14, 14, 1024, 256),
    (2, 7, 7, 2048, 512), (3, 56, 56, 256, 64), (3, 28, 28, 512, 128),
    (3, 14, 14, 1024, 256), (3, 7, 7, 2048, 512), (1, 5, 9, 256, 64),
    (3, 1, 1, 128, 64), (2, 13, 7, 64, 128), (1, 57, 56, 256, 64),
    (1, 5, 65, 64, 64), (3, 10, 13, 1024, 256), (2, 5, 30, 512, 128)])
def test_fused_bottleneck_f32_kernels(gen, kernel, n, h, w, c, p):
    args = _fb_f32(gen, n, h, w, c, p)
    reset_launches()
    got = F32_BOTTLENECKS[kernel](*args)
    name = ("fused_bottleneck_f32" if kernel == "block"
            else "fused_bottleneck_tiled_f32")
    assert dict(LAUNCHES) == {name: 1}
    assert got.dtype == torch.float32 and got.shape == args[0].shape
    _close(got, fused_bottleneck_plain(*args), F32_REL)


@pytest.mark.parametrize("kernel", sorted(F32_BOTTLENECKS))
@pytest.mark.parametrize("n,h,w,c,p", [(1, 8, 8, 256, 64),
                                       (2, 7, 7, 2048, 512)])
def test_fused_bottleneck_f32_kernels_zero_halo(gen, kernel, n, h, w, c, p):
    # relu(b1) far from 0: a halo row computed from x instead of zeroed
    # would show
    args = _fb_f32(gen, n, h, w, c, p, b1_shift=1.0)
    _close(F32_BOTTLENECKS[kernel](*args), fused_bottleneck_plain(*args),
           F32_REL)


@pytest.mark.parametrize("kernel", sorted(F32_BOTTLENECKS))
def test_fused_bottleneck_f32_kernels_repeat_bit_for_bit(gen, kernel):
    args = _fb_f32(gen, 2, 14, 14, 1024, 256)
    first = F32_BOTTLENECKS[kernel](*args)
    for _ in range(3):
        assert torch.equal(F32_BOTTLENECKS[kernel](*args), first)


@pytest.mark.parametrize("kernel", sorted(F32_BOTTLENECKS))
def test_fused_bottleneck_f32_kernels_refuse(gen, kernel):
    args = list(_fb_f32(gen, 1, 4, 4, 256, 64))
    op = F32_BOTTLENECKS[kernel]
    # x in f32 with bf16 weights, and f64 throughout
    with pytest.raises(TypeError, match="one dtype"):
        op(args[0], args[1].bfloat16(), *args[2:])
    with pytest.raises(TypeError, match="one dtype"):
        op(*(t.double() if t.dim() > 1 else t for t in args))
    # x 8 bytes off a 16-byte boundary
    flat = torch.empty(args[0].numel() + 2, device="cuda")
    with pytest.raises(ValueError, match="16-byte"):
        op(flat[2:].view(args[0].shape).copy_(args[0]), *args[1:])
    # rows too wide for shared memory in f32, or for the tiled block tile
    with pytest.raises(ValueError, match="does not fit" if kernel == "block"
                       else "W = 257"):
        op(*_fb_f32(gen, 1, 2, 400 if kernel == "block" else 257, 64, 64))


# The cluster cut (bottleneck_f32.cuh): N = 1, N smaller than a cluster
# (CTAs with no pixels), odd N, H that no span divides, spans that cross
# image boundaries and recompute y1 at clusters' edges inside an image.
@pytest.mark.parametrize("kernel", sorted(F32_BOTTLENECKS))
@pytest.mark.parametrize("n,h,w,c,p", [
    (1, 56, 56, 256, 64), (1, 14, 14, 1024, 256), (1, 7, 7, 2048, 512),
    (3, 7, 7, 2048, 512), (1, 1, 1, 256, 64), (5, 28, 28, 512, 128),
    (7, 14, 14, 1024, 256), (2, 15, 14, 1024, 256), (3, 9, 7, 2048, 512),
    (5, 13, 13, 512, 128)])
def test_fused_bottleneck_f32_cluster_cut(gen, kernel, n, h, w, c, p):
    args = _fb_f32(gen, n, h, w, c, p)
    _close(F32_BOTTLENECKS[kernel](*args), fused_bottleneck_plain(*args),
           F32_REL)


# relu(b1) far from 0 where a cluster's edge lies inside an image (stage 1
# at N = 2: spans of 910 pixels in 3,136-pixel images; stage 3 at N = 5:
# spans of half an image) or an image boundary inside a span (stage 1;
# stage 4 at N = 64: spans of 5 images) meets the halo: y1 off the image,
# computed instead of read as the zero row, would show.
@pytest.mark.parametrize("kernel", sorted(F32_BOTTLENECKS))
@pytest.mark.parametrize("n,h,w,c,p", [(2, 56, 56, 256, 64),
                                       (5, 14, 14, 1024, 256),
                                       (64, 7, 7, 2048, 512)])
def test_fused_bottleneck_f32_cluster_halo_trap(gen, kernel, n, h, w, c, p):
    from tmrnet_torch.experimental.fused_bottleneck import f32_cut

    from tmrnet_torch.experimental.fused_bottleneck import card_clusters

    plan = (plan_bottleneck_f32 if kernel == "block"
            else plan_bottleneck_tiled_f32)(
        n, h, w, c, p, card_clusters(torch.cuda.current_device()))
    cuts = [f32_cut(n * h * w, h, w, plan.span, plan.cs, k)
            for k in range(plan.clusters)]
    # the shapes do what they are here for
    assert (any(own[0] % (h * w) for own, _ in cuts[1:])
            or any((own[0] // (h * w)) != (own[-1] - 1) // (h * w)
                   for own, _ in cuts))
    args = _fb_f32(gen, n, h, w, c, p, b1_shift=1.0)
    _close(F32_BOTTLENECKS[kernel](*args), fused_bottleneck_plain(*args),
           F32_REL)


# The same inputs twice give the same bits at every stage's cut: a slot
# refilled before every CTA of the cluster read it, or a halo read before
# its neighbour wrote it, would not.
@pytest.mark.parametrize("kernel", sorted(F32_BOTTLENECKS))
@pytest.mark.parametrize("n,h,w,c,p", [(16, 56, 56, 256, 64),
                                       (24, 28, 28, 512, 128),
                                       (32, 7, 7, 2048, 512)])
def test_fused_bottleneck_f32_cluster_repeats_bit_for_bit(gen, kernel, n, h,
                                                          w, c, p):
    args = _fb_f32(gen, n, h, w, c, p)
    first = F32_BOTTLENECKS[kernel](*args)
    for _ in range(3):
        assert torch.equal(F32_BOTTLENECKS[kernel](*args), first)


def test_fused_bottleneck_f32_cluster_failures_raise(gen, monkeypatch):
    import dataclasses

    import tmrnet_torch.experimental.fused_bottleneck as fb

    args = _fb_f32(gen, 2, 14, 14, 1024, 256)
    shape = (2, 14, 14, 1024, 256)
    index = torch.cuda.current_device()
    plan = fb.plan_bottleneck_f32(*shape, fb.card_clusters(index))
    # the card's active clusters: read once a card, each size it may run;
    # a failed query raises and names the cluster size
    assert [cs for cs, _ in fb.card_clusters(index)] == list(fb.F32_CLUSTERS)
    assert all(k >= 0 for _, k in fb.card_clusters(index))
    run, smem, _ = fb.f32_entries()
    fb.card_clusters.cache_clear()
    monkeypatch.setattr(fb, "f32_entries", lambda: (run, smem, lambda cs: -2))
    with pytest.raises(RuntimeError, match="clusters of 8 on cuda:"):
        fused_bottleneck_cuda(*args)
    monkeypatch.undo()
    fb.card_clusters.cache_clear()
    # a plan the kernel refuses (a cluster of 16, its layout's bytes)
    # fails the launch
    bad = dataclasses.replace(plan, cs=16, smem=fb.f32_layout_bytes(
        14, 256, plan.tx, -(-plan.span // 16), plan.nstage, plan.overlay))
    with pytest.raises(RuntimeError, match="N=2 H=14 .*launch failed"):
        fb.launch_f32("fused_bottleneck_f32", "t", *args, shape, bad)
    # x off TMA's 16-byte alignment past the wrapper's check: the tensor
    # map does not encode
    flat = torch.empty(args[0].numel() + 2, device="cuda")
    x = flat[2:].view(args[0].shape).copy_(args[0])
    monkeypatch.setattr(fb, "check_aligned", lambda *a: None)
    with pytest.raises(RuntimeError, match="N=2 H=14 .*tensor map"):
        fb.launch_f32("fused_bottleneck_f32", "t", x, *args[1:], shape, plan)


def _i8(gen, shape):
    return torch.randint(-127, 128, shape, generator=gen, device="cuda",
                         dtype=torch.int8)


def _scales(gen, n):
    return (torch.rand((), generator=gen, device="cuda") * 0.1,
            torch.rand((n,), generator=gen, device="cuda") * 0.01)


# M not a multiple of the 128-row tile, N not of the 128-column tile, K not
# of the 64-byte chunk; a gate shape; K = 9 * 512 (sums past 2^24).
@pytest.mark.parametrize("m,k,n", [(100, 64, 16), (1, 32, 48),
                                   (777, 160, 144), (6272, 2048, 512),
                                   (300, 4608, 64)])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_int8_matmul_kernel_equals_plain(gen, m, k, n, out_dtype):
    a, b = _i8(gen, (m, k)), _i8(gen, (k, n))
    a_scale, b_scale = _scales(gen, n)
    got = int8_matmul_cuda(a, b, a_scale, b_scale, out_dtype)
    assert got.dtype == out_dtype
    assert torch.equal(got, int8_matmul_plain(a, b, a_scale, b_scale, out_dtype))


# Every tile width and ring depth the kernel is built for, forced past the
# plan: three row tiles (the last of 44 rows), N = 272 over two to five
# column tiles (the last of 16 columns), K = 400 (four chunks, the last of
# 16 bytes).
@pytest.mark.parametrize("bn,nstage", MATMUL_PLANS)
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_int8_matmul_kernel_forced_plans(gen, bn, nstage, out_dtype):
    a, b = _i8(gen, (300, 400)), _i8(gen, (400, 272))
    a_scale, b_scale = _scales(gen, 272)
    got = int8_matmul_cuda(a, b, a_scale, b_scale, out_dtype,
                           plan=Int8Plan(bn, nstage))
    assert torch.equal(got, int8_matmul_plain(a, b, a_scale, b_scale, out_dtype))


# The gate's stage-1 P -> C product: K = 64, half of one chunk.
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_int8_matmul_kernel_gate_k64(gen, out_dtype):
    a, b = _i8(gen, (401408, 64)), _i8(gen, (64, 256))
    a_scale, b_scale = _scales(gen, 256)
    got = int8_matmul_cuda(a, b, a_scale, b_scale, out_dtype)
    assert torch.equal(got, int8_matmul_plain(a, b, a_scale, b_scale, out_dtype))


@pytest.mark.parametrize("m,k,n", [(4096, 512, 512), (25088, 256, 1024)])
def test_int8_matmul_kernel_repeats_bit_for_bit(gen, m, k, n):
    a, b = _i8(gen, (m, k)), _i8(gen, (k, n))
    a_scale, b_scale = _scales(gen, n)
    first = int8_matmul_cuda(a, b, a_scale, b_scale)
    assert torch.equal(int8_matmul_cuda(a, b, a_scale, b_scale), first)


def test_int8_matmul_b_copy_follows_in_place_edits(gen):
    a = _i8(gen, (200, 96))
    b = torch.randint(-100, 100, (96, 48), generator=gen, device="cuda",
                      dtype=torch.int8)
    a_scale, b_scale = _scales(gen, 48)
    before = int8_matmul_cuda(a, b, a_scale, b_scale)
    b.add_(1)
    after = int8_matmul_cuda(a, b, a_scale, b_scale)
    assert torch.equal(after, int8_matmul_plain(a, b, a_scale, b_scale))
    assert not torch.equal(after, before)


def test_int8_matmul_counts_its_launches(gen):
    a, b = _i8(gen, (256, 128)), _i8(gen, (128, 64))
    a_scale, b_scale = _scales(gen, 64)
    int8_matmul_cuda(a, b, a_scale, b_scale)    # the B copy made before
    reset_launches()
    for bn, nstage in MATMUL_PLANS:
        int8_matmul_cuda(a, b, a_scale, b_scale, plan=Int8Plan(bn, nstage))
    int8_matmul_cuda(a, b, a_scale, b_scale, torch.bfloat16)
    assert dict(LAUNCHES) == {"int8_matmul": len(MATMUL_PLANS) + 1}


# C = 64 at a 7x7 image; C = 16 at an odd image; a gate stage; one pixel.
@pytest.mark.parametrize("n,h,w,c,co", [(2, 7, 7, 64, 64), (1, 5, 9, 16, 32),
                                        (3, 14, 14, 256, 256),
                                        (2, 56, 56, 64, 64), (1, 1, 1, 32, 16)])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_int8_conv3x3_kernel_equals_plain(gen, n, h, w, c, co, out_dtype):
    x, wq = _i8(gen, (n, h, w, c)), _i8(gen, (3, 3, c, co))
    x_scale, w_scale = _scales(gen, co)
    got = int8_conv3x3_cuda(x, wq, x_scale, w_scale, out_dtype)
    assert torch.equal(got, int8_conv3x3_plain(x, wq, x_scale, w_scale,
                                               out_dtype))


# csrc/wgmma_s8.cuh alone: one 64 x 128 @ 128 x N chunk through its copies,
# descriptors and k32 steps, against integer products on the host.
@pytest.mark.parametrize("n", [64, 128, 256])
def test_wgmma_s8_tile_equals_integer_products(gen, n):
    a, b = _i8(gen, (64, 128)), _i8(gen, (n, 128))
    got = wgmma_s8_tile_cuda(a, b)
    want = (a.cpu().long() @ b.cpu().long().t()).int()
    assert torch.equal(got.cpu(), want)


# Every tile width and ring depth the kernel is built for, forced past the
# plan: two row tiles, Co = 256 over one to four column tiles, K = 432 (not
# a multiple of the 128-byte chunk).
@pytest.mark.parametrize("bn,nstage", PLANS)
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_int8_conv3x3_kernel_forced_plans(gen, bn, nstage, out_dtype):
    x, wq = _i8(gen, (2, 9, 11, 48)), _i8(gen, (3, 3, 48, 256))
    x_scale, w_scale = _scales(gen, 256)
    got = int8_conv3x3_cuda(x, wq, x_scale, w_scale, out_dtype,
                            plan=Int8Plan(bn, nstage))
    assert torch.equal(got, int8_conv3x3_plain(x, wq, x_scale, w_scale,
                                               out_dtype))


# An image side past 2^15 (the kernel keeps no packed coordinates).
@pytest.mark.parametrize("n,h,w", [(1, 40000, 1), (1, 1, 40000), (2, 3, 33000)])
def test_int8_conv3x3_kernel_takes_any_image_side(gen, n, h, w):
    x, wq = _i8(gen, (n, h, w, 16)), _i8(gen, (3, 3, 16, 32))
    x_scale, w_scale = _scales(gen, 32)
    got = int8_conv3x3_cuda(x, wq, x_scale, w_scale)
    assert torch.equal(got, int8_conv3x3_plain(x, wq, x_scale, w_scale))


@pytest.mark.parametrize("n,h,w,c,co", [(16, 28, 28, 128, 128),
                                        (8, 7, 7, 512, 512)])
def test_int8_conv3x3_kernel_repeats_bit_for_bit(gen, n, h, w, c, co):
    x, wq = _i8(gen, (n, h, w, c)), _i8(gen, (3, 3, c, co))
    x_scale, w_scale = _scales(gen, co)
    first = int8_conv3x3_cuda(x, wq, x_scale, w_scale)
    assert torch.equal(int8_conv3x3_cuda(x, wq, x_scale, w_scale), first)


def test_int8_conv3x3_weight_copy_follows_in_place_edits(gen):
    x = _i8(gen, (2, 6, 7, 32))
    wq = torch.randint(-100, 100, (3, 3, 32, 64), generator=gen, device="cuda",
                       dtype=torch.int8)
    x_scale, w_scale = _scales(gen, 64)
    before = int8_conv3x3_cuda(x, wq, x_scale, w_scale)
    wq.add_(1)
    after = int8_conv3x3_cuda(x, wq, x_scale, w_scale)
    assert torch.equal(after, int8_conv3x3_plain(x, wq, x_scale, w_scale))
    assert not torch.equal(after, before)


def test_new_wrappers_check_their_inputs(gen):
    args = list(_fb_args(gen, 1, 4, 4, 256, 64))
    nchw = args[0].permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    with pytest.raises(ValueError, match="NHWC-contiguous"):
        fused_bottleneck_tiled_cuda(nchw, *args[1:])
    with pytest.raises(ValueError, match="multiples of 64"):
        fused_bottleneck_tiled_cuda(*_fb_args(gen, 1, 4, 4, 96, 64))
    with pytest.raises(TypeError):
        fused_bottleneck_tiled_cuda(args[0].float(), *args[1:])
    with pytest.raises(ValueError, match="on cpu"):
        fused_bottleneck_tiled_cuda(args[0], args[1], args[2].cpu(), *args[3:])

    a, b = _i8(gen, (32, 64)), _i8(gen, (64, 32))
    a_scale, b_scale = _scales(gen, 32)
    with pytest.raises(TypeError):
        int8_matmul_cuda(a.float(), b, a_scale, b_scale)
    with pytest.raises(ValueError, match="K % 16"):
        int8_matmul_cuda(_i8(gen, (32, 40)), _i8(gen, (40, 32)), a_scale, b_scale)
    with pytest.raises(ValueError, match="contiguous"):
        int8_matmul_cuda(a, b.t().contiguous().t(), a_scale, b_scale)
    with pytest.raises(ValueError, match="on cpu"):
        int8_matmul_cuda(a, b, a_scale.cpu(), b_scale)
    with pytest.raises(TypeError):
        int8_matmul_cuda(a, b, a_scale, b_scale, torch.float16)

    x, wq = _i8(gen, (1, 4, 4, 32)), _i8(gen, (3, 3, 32, 32))
    with pytest.raises(TypeError):
        int8_conv3x3_cuda(x.float(), wq, a_scale, b_scale)
    with pytest.raises(ValueError, match="C % 16"):
        int8_conv3x3_cuda(_i8(gen, (1, 4, 4, 24)), _i8(gen, (3, 3, 24, 32)),
                          a_scale, b_scale)
    with pytest.raises(ValueError, match="contiguous"):
        int8_conv3x3_cuda(x.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1),
                          wq, a_scale, b_scale)
    with pytest.raises(ValueError, match="on cpu"):
        int8_conv3x3_cuda(x, wq, a_scale, b_scale.cpu())


def test_new_kernels_count_their_launches(gen):
    reset_launches()
    fused_bottleneck_tiled_cuda(*_fb_args(gen, 1, 4, 4, 256, 64))
    a_scale, b_scale = _scales(gen, 32)
    int8_matmul_cuda(_i8(gen, (32, 64)), _i8(gen, (64, 32)), a_scale, b_scale)
    int8_matmul_cuda(_i8(gen, (32, 64)), _i8(gen, (64, 32)), a_scale, b_scale)
    int8_conv3x3_cuda(_i8(gen, (1, 4, 4, 32)), _i8(gen, (3, 3, 32, 32)),
                      a_scale, b_scale)
    assert dict(LAUNCHES) == {"fused_bottleneck_tiled": 1, "int8_matmul": 2,
                              "int8_conv3x3": 1}


def test_device_prefetch_on_card(gen):
    """12 batches through 3 staging slots: every array arrives on the card
    equal to its host batch, non-array items pass through, the host arrays
    may be overwritten once staged, and bf16 CPU tensors keep their dtype."""
    from tmrnet_torch.data.device_feed import device_prefetch

    rng = np.random.default_rng(0)
    host = [rng.integers(0, 256, (64, 10, 56, 56, 3), dtype=np.uint8)
            for _ in range(12)]
    want = [h.copy() for h in host]

    def batches():
        for k, h in enumerate(host):
            yield h, torch.full((4,), k, dtype=torch.bfloat16), np.arange(k), k
            h[...] = 0                # the loader reuses its memory

    got = []
    for x, b, rows, k in device_prefetch(batches(), buffer_size=2):
        assert x.is_cuda and b.is_cuda and b.dtype == torch.bfloat16
        assert rows.is_cuda and len(rows) == k
        for _ in range(3):            # keep the compute stream busy
            x = (x.float() * 1.0).to(torch.uint8)
        got.append(x.cpu().numpy())
        assert torch.equal(b.cpu(), torch.full((4,), k, dtype=torch.bfloat16))
    assert len(got) == 12
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    with pytest.raises(TypeError, match="bare array"):
        next(device_prefetch([host[0]]))


def _packed_dataset(tmp_path, lengths, hw, seq, transform=None, seed=0):
    from tmrnet_torch.data.manifests import Manifest, VideoRecord
    from tmrnet_torch.data.pipeline import ClipDataset

    rng = np.random.default_rng(seed)
    videos = []
    for v, n in enumerate(lengths):
        path = tmp_path / f"v{v}.npy"
        np.save(path, rng.integers(0, 256, (n, hw, hw, 3), dtype=np.uint8))
        videos.append(VideoRecord(f"v{v}", [f"{path}#{j}" for j in range(n)],
                                  (np.arange(n) % 7).astype(np.int64)))
    return ClipDataset(Manifest(videos), seq, transform=transform)


def test_clip_loader_processes_after_cuda_init(gen, tmp_path):
    """With the card initialised and the packed files' handles open in
    this process, forked loader workers give the same batches as threads,
    and the batches reach the card through device_prefetch intact."""
    from tmrnet_torch.data.device_feed import device_prefetch
    from tmrnet_torch.data.pipeline import ClipLoader

    torch.zeros(1, device="cuda").sum().item()
    ds = _packed_dataset(tmp_path, (30, 4, 17), 48, 10)
    ds.get_clip(0)
    threads = list(ClipLoader(ds, 8, num_workers=2).epoch(0))
    procs = list(ClipLoader(ds, 8, num_workers=3, use_processes=True,
                            shuffle=True).epoch(1))
    order = np.argsort(np.concatenate([b[2] for b in procs])[:ds.num_clips])
    flat = np.concatenate([b[0] for b in procs])[:ds.num_clips][order]
    np.testing.assert_array_equal(
        flat, np.concatenate([b[0] for b in threads])[:ds.num_clips])
    assert len(threads) == 4 and threads[-1][3] == 8 * 4 - 29
    loader = ClipLoader(ds, 8, num_workers=2, use_processes=True)
    for (clips, labels, rows, pad), want in zip(
            device_prefetch(loader.epoch(0), array_indices=(0,)), threads):
        assert clips.is_cuda
        np.testing.assert_array_equal(clips.cpu().numpy(), want[0])
        np.testing.assert_array_equal(labels, want[1])


def test_dataset_engines_on_card_match_cpu(gen, tmp_path):
    """build_lfb (clip and video engines) and ClipInference.run(ds) on the
    card (bf16, folded, ResNet-50 widths with one identity block) against
    the same in f32 on the CPU, over a packed dataset with a padded last
    batch: banks within 2e-2 of max |feature|, softmax within 2e-2; one
    fused_bottleneck a clip batch, a trunk chunk of the video engine."""
    from tmrnet_torch.config import (DataConfig, EvalConfig, ExperimentConfig,
                                     MemoryConfig, ModelConfig)
    from tmrnet_torch.data.transforms import EvalTransform
    from tmrnet_torch.eval.infer import ClipInference
    from tmrnet_torch.models.convert import from_jax_variables, random_variables
    from tmrnet_torch.models.fold_bn import fold_variables
    from tmrnet_torch.train.loop import build_lfb

    kw = dict(backbone="resnet50", stage_sizes=(2, 1, 1, 1), hidden_dim=512,
              head="tmr")
    weights = [fold_variables(from_jax_variables(random_variables(
        ModelConfig(**dict(kw, head=head)), seed))) for head, seed in
        (("tmr", 8), ("lfb", 9))]
    cfg = lambda cdt: ExperimentConfig(
        data=DataConfig(device_normalize=True, resize=64, crop_size=64,
                        batch_clips=8, num_workers=2),
        model=ModelConfig(**kw, folded=True, compute_dtype=cdt),
        memory=MemoryConfig(window=30), eval=EvalConfig(batch_clips=8))
    ds = _packed_dataset(tmp_path, (24, 9, 12), 64, 10,
                         EvalTransform(64, 64, 1, normalize=False), seed=4)
    banks = {}
    for device, cdt in (("cpu", "float32"), ("cuda", "bfloat16")):
        for engine in ("clip", "video"):
            reset_launches()
            banks[device, engine] = build_lfb(
                cfg(cdt), weights[1], ds, engine=engine, device=device,
                cache_path=str(tmp_path / f"{device}_{engine}.npz"))
            if device == "cuda":
                # two videos with clip positions; 18 clips in batches of 8
                chunks = 2 if engine == "video" else 3
                assert dict(LAUNCHES) == {"fused_bottleneck": chunks}
    want = banks["cpu", "clip"].features
    for key, bank in banks.items():
        _close(bank.features.cpu(), want)
    cpu = ClipInference(cfg("float32"), weights[0], banks["cpu", "clip"],
                        device="cpu").run(ds)
    reset_launches()
    card = ClipInference(cfg("bfloat16"), weights[0], banks["cuda", "clip"]
                         ).run(ds)
    assert dict(LAUNCHES) == {"fused_bottleneck": 3, "time_conv": 3,
                              "nl_attention": 3}
    assert card.scores.shape == cpu.scores.shape == (18, 7)
    assert np.abs(card.scores - cpu.scores).max() <= REL
    np.testing.assert_array_equal(card.rows, np.arange(18))


def test_head_functions_backward_on_card_match_plain(gen):
    """time_conv and nl_attention under autograd on the card (bf16, B = 8,
    W = 30, C = 512): one kernel launch each in the forward, none in the
    backward, and every gradient within 2e-2 of max |plain| of the plain
    versions' autograd in f32 on the same inputs."""
    from tmrnet_torch.ops.nl_attention import nl_attention
    from tmrnet_torch.ops.time_conv import time_conv

    b, w, c = 8, 30, 512
    x = _randn(gen, (b, w, c))
    ws = []
    for k in (3, 5, 7):
        ws += [_randn(gen, (k, c, c), (1.0 / (k * c)) ** 0.5),
               _randn(gen, (c,), 0.02).float()]
    q, kk, v = (_randn(gen, s) for s in ((b, c), (b, w, c), (b, w, c)))
    g_tc, g_nl = _randn(gen, (b, w, c)), _randn(gen, (b, c))
    for fn, inputs, g, plain, name in (
            (time_conv, [x, *ws], g_tc, time_conv_plain, "time_conv"),
            (nl_attention, [q, kk, v], g_nl, nl_attention_plain,
             "nl_attention")):
        card = [t.detach().clone().requires_grad_() for t in inputs]
        reset_launches()
        out = fn(*card)
        torch.cuda.synchronize()
        assert dict(LAUNCHES) == {name: 1}
        (out.float() * g.float()).sum().backward()
        torch.cuda.synchronize()
        assert dict(LAUNCHES) == {name: 1}
        ref = [t.detach().float().requires_grad_() for t in inputs]
        (plain(*ref) * g.float()).sum().backward()
        for got, want in zip(card, ref):
            assert got.grad.dtype == got.dtype
            _close(got.grad, want.grad)


def test_time_conv_copies_follow_an_optimizer_step_on_card(gen):
    """TimeConv in bf16 on the card: after each SGD step the kernel's
    copies are made again from the new parameters, and the module's output
    follows them."""
    from tmrnet_torch.models.blocks import TimeConv

    block = TimeConv(512, torch.bfloat16).cuda()
    with torch.no_grad():
        for p in block.parameters():
            p.normal_(0, 0.02, generator=gen)
    opt = torch.optim.SGD(block.parameters(), lr=0.5, momentum=0.9)
    x = _randn(gen, (4, 30, 512))
    for _ in range(2):
        before = block.kernel_args()
        block(x).float().square().mean().backward()
        opt.step()
        opt.zero_grad()
        after = block.kernel_args()
        assert after is not before
        torch.testing.assert_close(
            after[0], block.conv_k3.weight.detach().permute(2, 1, 0)
            .to(torch.bfloat16).contiguous(), rtol=0, atol=0)
        with torch.no_grad():
            _close(block(x), time_conv_plain(x.float(), *(
                t.float() for t in after)))


def _step_on(device, head, weights, batch, cdt=None):
    """One train step of `head` on `device` (bf16 on the card, f32 on the
    CPU unless `cdt` says otherwise); returns (loss, the parameter deltas,
    the running statistics, the launches)."""
    from tmrnet_torch.config import DataConfig, ModelConfig, TrainConfig
    from tmrnet_torch.data.device_feed import DevicePrep
    from tmrnet_torch.models.tmrnet import build_model
    from tmrnet_torch.train.optim import make_optimizer, slow_modules_for_head
    from tmrnet_torch.train.state import TrainState
    from tmrnet_torch.train.steps import make_stage1_steps, make_stage2_steps

    cdt = cdt or ("bfloat16" if device == "cuda" else "float32")
    cfg = ModelConfig(backbone="resnet50", stage_sizes=(1, 1, 1, 1),
                      hidden_dim=64, head=head, compute_dtype=cdt,
                      dropout_stage1=0.0, dropout_head=0.0, dropout_nl=0.0)
    model = build_model(cfg, device=device)
    model.load_state_dict(weights)
    state = TrainState(model, make_optimizer(
        TrainConfig(lr=0.05, momentum=0.9, weight_decay=5e-4), model,
        slow_modules_for_head(head)))
    make = make_stage1_steps if head == "stage1" else make_stage2_steps
    train, _ = make(prep=DevicePrep(DataConfig(device_normalize=True), cdt,
                                    device))
    clips, memory, labels = (t.to(device) for t in batch)
    args = (clips,) if head == "stage1" else (clips, memory)
    before = {k: v.detach().clone() for k, v in model.named_parameters()}
    reset_launches()
    loss = train(state, *args, labels,
                 torch.Generator(device=device).manual_seed(0))["loss"]
    if device == "cuda":
        torch.cuda.synchronize()
    deltas = {k: (v.detach() - before[k]).float().cpu()
              for k, v in model.named_parameters()}
    stats = {k: v.float().cpu() for k, v in model.state_dict().items()
             if "running" in k}
    return float(loss), deltas, stats, dict(LAUNCHES)


@pytest.mark.parametrize("head", ["stage1", "tmr", "nl_only"])
def test_train_step_on_card_matches_cpu(gen, head):
    """One SGD step on the card in bf16 against the CPU in f32, beside the
    same step in bf16 on the CPU (`train/step_check.py`): loss within 2e-2
    relative, the running statistics within 2e-2 of max |cpu|, the head's
    kernels launched once each; the backbone's deltas laid end to end, and
    the head's and LSTM's, no further from the f32 step than twice the
    CPU's bf16 step (+ 1e-3); each tensor that the CPU's bf16 step resolves
    within 5e-2 or twice that step's distance."""
    from tmrnet_torch.config import ModelConfig
    from tmrnet_torch.models.convert import from_jax_variables, random_variables
    from tmrnet_torch.train.step_check import aggregate, verdicts

    weights = from_jax_variables(random_variables(ModelConfig(
        backbone="resnet50", stage_sizes=(1, 1, 1, 1), hidden_dim=64,
        head=head), 3))
    g = torch.Generator().manual_seed(1)
    batch = (torch.randint(0, 256, (4, 3, 64, 64, 3), generator=g,
                           dtype=torch.uint8),
             torch.randn(4, 30, 64, generator=g), torch.tensor([0, 3, 6, 2]))
    cpu = _step_on("cpu", head, weights, batch)
    ref = _step_on("cpu", head, weights, batch, "bfloat16")
    card = _step_on("cuda", head, weights, batch)
    assert abs(card[0] - cpu[0]) <= 2e-2 * abs(cpu[0])
    agg, agg_ref = aggregate(card[1], cpu[1]), aggregate(ref[1], cpu[1])
    for group, d in agg.items():
        assert d <= 2 * agg_ref[group] + 1e-3, (group, d, agg_ref[group])
    bad = {k: v for k, v in verdicts(card[1], ref[1], cpu[1]).items()
           if v[0] == "FAIL"}
    assert not bad
    for k, want in cpu[2].items():
        _close(card[2][k], want)
    assert card[3] == {"stage1": {}, "tmr": {"time_conv": 1,
                                             "nl_attention": 1},
                       "nl_only": {"nl_attention": 1}}[head]


@pytest.mark.parametrize("head", ["stage1", "nl_only"])
def test_train_step_on_card_in_f32_matches_cpu(gen, head):
    """The same step in f32 on the card (time_conv's kernel takes bf16
    only, so head tmr is left out): loss and the running statistics
    within 1e-3 of the CPU's, each parameter tensor's delta within 5e-2
    (cosine 0.95 for the backbone), nl_attention launched once."""
    from tmrnet_torch.config import ModelConfig
    from tmrnet_torch.models.convert import from_jax_variables, random_variables
    from tmrnet_torch.train.step_check import TENSOR_LIMIT, distance

    weights = from_jax_variables(random_variables(ModelConfig(
        backbone="resnet50", stage_sizes=(1, 1, 1, 1), hidden_dim=64,
        head=head), 3))
    g = torch.Generator().manual_seed(1)
    batch = (torch.randint(0, 256, (4, 3, 64, 64, 3), generator=g,
                           dtype=torch.uint8),
             torch.randn(4, 30, 64, generator=g), torch.tensor([0, 3, 6, 2]))
    cpu = _step_on("cpu", head, weights, batch)
    card = _step_on("cuda", head, weights, batch, "float32")
    assert abs(card[0] - cpu[0]) <= 1e-3 * abs(cpu[0])
    for k, want in cpu[1].items():
        assert distance(k, card[1][k], want) <= TENSOR_LIMIT, k
    for k, want in cpu[2].items():
        _close(card[2][k], want, 1e-3)
    assert card[3] == ({"nl_attention": 1} if head == "nl_only" else {})


def _sharded_setup(seeds=(11, 12)):
    """ResNet-50 widths with one identity block (stage 1's second), folded,
    bf16, window 30: the config and the TMR model's and the extractor's
    folded weights."""
    from tmrnet_torch.config import (DataConfig, ExperimentConfig,
                                     MemoryConfig, ModelConfig)
    from tmrnet_torch.models.convert import from_jax_variables, random_variables
    from tmrnet_torch.models.fold_bn import fold_variables

    kw = dict(backbone="resnet50", stage_sizes=(2, 1, 1, 1), hidden_dim=512,
              head="tmr")
    weights = [fold_variables(from_jax_variables(random_variables(
        ModelConfig(**dict(kw, head=head)), seed))) for head, seed in
        zip(("tmr", "lfb"), seeds)]
    cfg = ExperimentConfig(
        data=DataConfig(device_normalize=True),
        model=ModelConfig(**kw, folded=True, compute_dtype="bfloat16"),
        memory=MemoryConfig(window=30))
    return cfg, weights


def test_sharded_clip_engine_on_card_matches_one_device(gen):
    """ClipInference(devices=[cuda:0, cuda:0]) against the one-device
    engine on the card: a batch of 4 clips in two shards (per shard one
    fused_bottleneck, one time_conv, one nl_attention, all on card 0), a
    batch of 3 whole; softmax within 2e-2."""
    from tmrnet_torch.eval.infer import ClipInference
    from tmrnet_torch.kernels.build import LAUNCHES_BY_DEVICE
    from tmrnet_torch.memory.lfb import FeatureBank

    cfg, (state, _) = _sharded_setup()
    rng = np.random.default_rng(13)
    bank = FeatureBank(torch.randn(64, 512, generator=gen, device="cuda")
                       .to(torch.bfloat16),
                       torch.zeros(64, dtype=torch.int32).cuda())
    one = ClipInference(cfg, state, bank)
    sharded = ClipInference(cfg, state, bank,
                            devices=[torch.device("cuda", 0)] * 2)
    firsts = np.zeros(64, np.int64)
    for b, want_counts in ((4, 2), (3, 1)):
        batch = [(rng.integers(0, 256, (b, 10, 64, 64, 3), dtype=np.uint8),
                  np.zeros(b, int), rng.integers(0, 64, b), 0)]
        want = one.run_batches(batch, firsts)
        reset_launches()
        got = sharded.run_batches(batch, firsts)
        assert dict(LAUNCHES) == {"fused_bottleneck": want_counts,
                                  "time_conv": want_counts,
                                  "nl_attention": want_counts}
        assert dict(LAUNCHES_BY_DEVICE) == {
            (k, 0): want_counts for k in LAUNCHES}
        assert np.abs(got.scores - want.scores).max() <= REL


def test_sharded_stream_engine_on_card_matches_one_device(gen):
    """StreamingInference(devices=[cuda:0, cuda:0]), 4 slots in two groups
    over 12 steps, slot 1 inactive at steps 4-5 (frozen bit for bit), slot
    2 reset at step 7, against the one-device engine: per step 2
    fused_bottleneck (both trunks), 1 time_conv and 1 nl_attention a
    group; softmax within 2e-2, the same valid mask."""
    from tmrnet_torch.eval.stream import StreamingInference

    cfg, weights = _sharded_setup((14, 15))
    one = StreamingInference(cfg, *weights)
    sharded = StreamingInference(cfg, *weights,
                                 devices=[torch.device("cuda", 0)] * 2)
    frames = np.random.default_rng(16).integers(
        0, 256, (12, 4, 64, 64, 3), dtype=np.uint8)
    s1, s2 = one.init_state(4), sharded.init_state(4)
    for t in range(12):
        if t == 7:
            mask = np.arange(4) == 2
            s1, s2 = one.reset_streams(s1, mask), sharded.reset_streams(
                s2, mask)
        active = np.ones(4, bool)
        active[1] = t not in (4, 5)
        old = [x[1].clone() for x in (s2.ext_ring, s2.tmr_ring, s2.bank_ring,
                                      s2.count)]
        s1, _, q1, v1 = one.step(s1, frames[t], active)
        reset_launches()
        s2, _, q2, v2 = sharded.step(s2, frames[t], active)
        assert dict(LAUNCHES) == {"fused_bottleneck": 4, "time_conv": 2,
                                  "nl_attention": 2}
        assert torch.equal(v1, v2)
        assert (q2 - q1).abs().max().item() <= REL
        if not active[1]:
            assert all(torch.equal(a[1], b) for a, b in zip(
                (s2.ext_ring, s2.tmr_ring, s2.bank_ring, s2.count), old))


def test_entry_on_card(gen):
    """entry() on the card: finite logits (2, 7) from its zero-filled
    state, and from seeded weights, each call one time_conv and one
    nl_attention (the trunk is not folded: no fused kernel)."""
    from tmrnet_torch.config import ModelConfig
    from tmrnet_torch.entry import entry
    from tmrnet_torch.models.convert import from_jax_variables, random_variables

    fn, (state, clips, memory) = entry()
    assert clips.is_cuda and memory.is_cuda
    seeded = {k: v.cuda() for k, v in from_jax_variables(random_variables(
        ModelConfig(backbone="resnet50", head="tmr", num_classes=7,
                    hidden_dim=512), 17)).items()}
    for weights in (state, seeded):
        reset_launches()
        logits = fn(weights, clips, memory)
        assert dict(LAUNCHES) == {"time_conv": 1, "nl_attention": 1}
        assert logits.shape == (2, 7) and bool(torch.isfinite(logits).all())


def test_head_only_on_card_matches_cpu(gen):
    """experimental/headlevel_multiscale.py's HeadOnly at hidden 64, window
    40, bf16 on the card against f32 on the CPU (within 2e-2 of max
    |logit|), then 3 Adam steps with finite losses; one time_conv and one
    nl_attention a forward."""
    from tmrnet_torch.experimental.headlevel_multiscale import (HeadOnly,
                                                                adam_step,
                                                                init_head)

    cpu = init_head(64, True, 0)
    card = HeadOnly(64, True, compute_dtype="bfloat16").cuda()
    card.load_state_dict(cpu.state_dict())
    host = torch.Generator().manual_seed(0)
    st = torch.randn(32, 64, generator=host)
    lt = torch.randn(32, 40, 64, generator=host)
    with torch.no_grad():
        want = cpu(st, lt)
        reset_launches()
        got = card(st.cuda(), lt.cuda()).float().cpu()
    assert dict(LAUNCHES) == {"time_conv": 1, "nl_attention": 1}
    assert (got - want).abs().max() <= REL * want.abs().max()
    step = adam_step(card)
    y = torch.randint(0, 2, (32,), generator=host).cuda()
    for _ in range(3):
        assert torch.isfinite(step(st.cuda(), lt.cuda(), y))
