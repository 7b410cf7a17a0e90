"""The port's plain kernel versions against the JAX package's Pallas kernels
(interpret mode on the CPU), in f32, with the same numpy inputs; and the
dispatch rule: CPU tensors take the plain version, the CUDA wrappers refuse
anything but CUDA tensors."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from tmrnet_tpu.experimental.fused_bottleneck import fused_bottleneck as jax_fused_bottleneck
from tmrnet_tpu.ops.nl_attention import nl_attention as jax_nl_attention
from tmrnet_tpu.ops.time_conv import time_conv_fused as jax_time_conv
from tmrnet_torch.experimental.fused_bottleneck import (
    fused_bottleneck,
    fused_bottleneck_cuda,
    fused_bottleneck_plain,
)
from tmrnet_torch.ops.nl_attention import nl_attention, nl_attention_cuda, nl_attention_plain
from tmrnet_torch.ops.time_conv import time_conv, time_conv_cuda, time_conv_plain

torch.set_num_threads(2)

# f32 on both sides; the sums run in another order, so 1e-4 absolute.
ATOL = 1e-4


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


@pytest.mark.parametrize("b,w,f", [(4, 30, 64), (5, 7, 32), (3, 40, 48)])
def test_nl_attention_plain_matches_pallas(b, w, f):
    rng = np.random.RandomState(b * w)
    q, k, v = (rng.randn(*s).astype(np.float32)
               for s in ((b, f), (b, w, f), (b, w, f)))
    want = np.asarray(jax_nl_attention(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), interpret=True))
    got = nl_attention_plain(_t(q), _t(k), _t(v)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    np.testing.assert_array_equal(nl_attention(_t(q), _t(k), _t(v)).numpy(), got)


def _tc_weights(rng, c):
    out = []
    for k in (3, 5, 7):
        out += [rng.randn(k, c, c).astype(np.float32) * 0.1,
                rng.randn(c).astype(np.float32) * 0.1]
    return out


@pytest.mark.parametrize("b,w,c", [(3, 30, 32), (2, 7, 16), (1, 2, 8)])
def test_time_conv_plain_matches_pallas(b, w, c):
    rng = np.random.RandomState(w)
    x = rng.randn(b, w, c).astype(np.float32)
    ws = _tc_weights(rng, c)
    want = np.asarray(jax_time_conv(jnp.asarray(x),
                                    *(jnp.asarray(a) for a in ws),
                                    interpret=True))
    got = time_conv_plain(_t(x), *(_t(a) for a in ws)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    np.testing.assert_array_equal(
        time_conv(_t(x), *(_t(a) for a in ws)).numpy(), got)


def _fb_weights(rng, c, p):
    s = 1.0 / np.sqrt(c)
    return [rng.randn(c, p) * s, rng.randn(p) * 0.1,
            rng.randn(3, 3, p, p) * s * 0.3, rng.randn(p) * 0.1,
            rng.randn(p, c) * s, rng.randn(c) * 0.1]


@pytest.mark.parametrize("n,h,w,c,p", [(2, 6, 6, 32, 8), (1, 5, 7, 16, 4)])
def test_fused_bottleneck_plain_matches_pallas(n, h, w, c, p):
    rng = np.random.RandomState(h * w)
    x = rng.randn(n, h, w, c).astype(np.float32)
    ws = [np.asarray(a, np.float32) for a in _fb_weights(rng, c, p)]
    want = np.asarray(jax_fused_bottleneck(
        jnp.asarray(x), *(jnp.asarray(a) for a in ws), block_n=1,
        interpret=True))
    got = fused_bottleneck_plain(_t(x), *(_t(a) for a in ws)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    np.testing.assert_array_equal(
        fused_bottleneck(_t(x), *(_t(a) for a in ws)).numpy(), got)


def test_plain_versions_keep_input_dtype():
    rng = np.random.RandomState(0)
    q = _t(rng.randn(2, 16)).bfloat16()
    k = _t(rng.randn(2, 5, 16)).bfloat16()
    assert nl_attention(q, k, k).dtype == torch.bfloat16
    x = _t(rng.randn(2, 5, 8)).bfloat16()
    ws = [_t(a) for a in _tc_weights(rng, 8)]
    assert time_conv(x, *ws).dtype == torch.bfloat16


def test_cuda_wrappers_refuse_cpu_tensors():
    """No fallback: a wrapper of a kernel takes CUDA tensors or raises."""
    rng = np.random.RandomState(1)
    q, k = _t(rng.randn(2, 64)), _t(rng.randn(2, 3, 64))
    with pytest.raises(ValueError, match="not on CUDA"):
        nl_attention_cuda(q, k, k)
    x = _t(rng.randn(2, 3, 64)).bfloat16()
    ws = [_t(a) for a in _tc_weights(rng, 64)]
    with pytest.raises(ValueError, match="not on CUDA"):
        time_conv_cuda(x, *ws)
    xb = _t(rng.randn(1, 4, 4, 256)).bfloat16()
    wb = [_t(a) for a in _fb_weights(rng, 256, 64)]
    with pytest.raises(ValueError, match="not on CUDA"):
        fused_bottleneck_cuda(xb, *wb)


def test_dispatch_refuses_other_devices():
    q = torch.empty(2, 8, device="meta")
    k = torch.empty(2, 3, 8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        nl_attention(q, k, k)
    with pytest.raises(ValueError, match="unsupported device"):
        time_conv(k, *([k] * 6))
    with pytest.raises(ValueError, match="unsupported device"):
        fused_bottleneck(torch.empty(1, 2, 2, 8, device="meta"), *([k] * 6))
