"""The port's Hopper kernels on the card, against their plain versions on
the same inputs; wrapper checks and launch counts; and a small folded
ResNet-50 TMRNet on the card against the same model in f32 on the CPU.

Needs a CUDA card and skips without one. The card has no JAX, so this file
imports none and runs without the repository's conftest:

    python -m pytest tests/test_torch_cuda.py -q --noconftest

Tolerance: max |kernel - plain| <= 2e-2 * max |plain|. The kernels take
bf16 inputs and round their output (and the fused bottleneck its y1 and y2)
to bf16, 2^-8 relative each; the plain versions run in f32 (TF32 off).
"""

import numpy as np
import pytest
import torch

from tmrnet_torch.experimental.fused_bottleneck import (
    fused_bottleneck_cuda,
    fused_bottleneck_plain,
)
from tmrnet_torch.kernels.build import LAUNCHES, reset_launches
from tmrnet_torch.ops.nl_attention import nl_attention_cuda, nl_attention_plain
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


def _fb_args(gen, n, h, w, c, p):
    return (torch.relu(_randn(gen, (n, h, w, c))),
            _randn(gen, (c, p), (2.0 / c) ** 0.5),
            _randn(gen, (p,), 0.05, torch.float32),
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


def test_folded_resnet50_tmrnet_on_card_matches_cpu(gen):
    from tmrnet_torch.config import ModelConfig
    from tmrnet_torch.models.convert import from_jax_variables, random_variables
    from tmrnet_torch.models.fold_bn import fold_variables
    from tmrnet_torch.models.tmrnet import build_model

    kw = dict(backbone="resnet50", hidden_dim=512, head="tmr", folded=True)
    state = fold_variables(from_jax_variables(random_variables(
        ModelConfig(**dict(kw, folded=False)), seed=1)))
    card = build_model(ModelConfig(**kw, compute_dtype="bfloat16"))
    card.load_state_dict(state, strict=True)
    cpu = build_model(ModelConfig(**kw, compute_dtype="float32"), device="cpu")
    cpu.load_state_dict(state, strict=True)
    rng = np.random.default_rng(2)
    clips = torch.from_numpy(rng.standard_normal((2, 3, 64, 64, 3), np.float32))
    memory = torch.from_numpy(rng.standard_normal((2, 30, 512), np.float32))
    reset_launches()
    with torch.no_grad():
        got = torch.softmax(card(clips.cuda(), memory.cuda()).float(), -1)
        want = torch.softmax(cpu(clips, memory), -1)
    assert dict(LAUNCHES) == {"fused_bottleneck": 12, "time_conv": 1,
                              "nl_attention": 1}
    assert (got.cpu() - want).abs().max().item() <= 2e-2
