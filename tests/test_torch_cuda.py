"""The port's Hopper kernels on the card, against their plain versions on
the same inputs; wrapper checks and launch counts; a small folded
ResNet-50 TMRNet on the card, on the block and the tiled fused path,
against the same model in f32 on the CPU; and the video and stream engines
on the card against the video engine in f32 on the CPU.

Needs a CUDA card and skips without one. The card has no JAX, so this file
imports none and runs without the repository's conftest:

    python -m pytest tests/test_torch_cuda.py -q --noconftest

Tolerance: max |kernel - plain| <= 2e-2 * max |plain|. The kernels take
bf16 inputs and round their output (and the fused bottleneck its y1 and y2)
to bf16, 2^-8 relative each; the plain versions run in f32 (TF32 off).
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
)
from tmrnet_torch.experimental.fused_bottleneck_tiled import (
    fused_bottleneck_tiled_cuda,
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
from tmrnet_torch.ops.time_conv import time_conv_cuda, time_conv_plain

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


def _close(got, want):
    err = (got.float() - want.float()).abs().max().item()
    assert err <= REL * want.float().abs().max().item(), err


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
    # B*W*C past 32-bit offsets (refused before any operand is read)
    x = _randn(gen, (1, 64, 512)).expand(65536, 64, 512)
    with pytest.raises(ValueError, match="32-bit"):
        time_conv_cuda(x, *_tc_weights(gen, 512))


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


def _folded_resnet50_card_vs_cpu(fused_kernel):
    from tmrnet_torch.config import ModelConfig
    from tmrnet_torch.models.convert import from_jax_variables, random_variables
    from tmrnet_torch.models.fold_bn import fold_variables
    from tmrnet_torch.models.tmrnet import build_model

    kw = dict(backbone="resnet50", hidden_dim=512, head="tmr", folded=True)
    state = fold_variables(from_jax_variables(random_variables(
        ModelConfig(**dict(kw, folded=False)), seed=1)))
    card = build_model(ModelConfig(**kw, compute_dtype="bfloat16"),
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
    assert (got.cpu() - want).abs().max().item() <= 2e-2
    return counts


def test_folded_resnet50_tmrnet_on_card_matches_cpu(gen):
    assert _folded_resnet50_card_vs_cpu("block") == {
        "fused_bottleneck": 12, "time_conv": 1, "nl_attention": 1}


def test_folded_resnet50_tiled_path_on_card_matches_cpu(gen):
    assert _folded_resnet50_card_vs_cpu("tiled") == {
        "fused_bottleneck_tiled": 10, "fused_bottleneck": 2, "time_conv": 1,
        "nl_attention": 1}


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
