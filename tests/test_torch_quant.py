"""The port's int8 path against the JAX package's, on the CPU: the
quantizers, `int8_matmul` (the Pallas kernel in interpret mode),
`quantized_matmul`, `int8_conv3x3` (the Pallas kernel in interpret mode) and
the int8 gate's bottleneck chain, each EQUAL to JAX's bit for bit, at the
shapes of tests/test_quant.py and tests/test_quant_conv.py. The integer sums
are exact on both sides and the epilogues take the same f32 steps in the same
order, so a mismatch would be an epilogue order or a rounding mode. The
gate's bf16 chain is held to JAX's in f32 at 1e-5 (the same convs, summed in
other orders)."""

import importlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tmrnet_tpu.experimental.quant_conv import int8_conv3x3 as jax_int8_conv3x3
from tmrnet_tpu.ops.quant import int8_matmul as jax_int8_matmul
from tmrnet_tpu.ops.quant import quantize_per_channel as jax_quantize_per_channel
from tmrnet_tpu.ops.quant import quantize_per_tensor as jax_quantize_per_tensor
from tmrnet_tpu.ops.quant import quantized_matmul as jax_quantized_matmul
from tmrnet_torch.experimental import int8_gate
from tmrnet_torch.experimental.quant_conv import int8_conv3x3, int8_conv3x3_plain
from tmrnet_torch.ops import (
    int8_matmul,
    quantize_per_channel,
    quantize_per_tensor,
    quantized_matmul,
)
from tmrnet_torch.ops.quant import int8_matmul_plain

torch.set_num_threads(2)

jax_gate = importlib.import_module("scripts.bench_int8_gate")


def t(a):
    return torch.from_numpy(np.array(a))


def equal(got, want):
    np.testing.assert_array_equal(got.numpy() if isinstance(got, torch.Tensor)
                                  else got, np.asarray(want))


@pytest.mark.parametrize("shape,scale", [((64, 32), 1.0), ((7, 5, 3), 1e-3),
                                         ((16, 16), 40.0)])
def test_quantize_per_tensor_equals_jax(shape, scale):
    x = np.random.RandomState(0).randn(*shape).astype(np.float32) * scale
    q, s = quantize_per_tensor(t(x))
    jq, js = jax_quantize_per_tensor(jnp.asarray(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32 and s.dim() == 0
    equal(q, jq)
    equal(s, js)


def test_quantize_rounds_half_to_even_and_clips():
    # amax 127 gives scale 1.0 exactly: halves land on the grid's midpoints
    x = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -2.5, -127.0], np.float32)
    q, s = quantize_per_tensor(t(x))
    assert float(s) == 1.0
    assert q.tolist() == [127, 0, 2, 2, 0, -2, -127]
    equal(q, jax_quantize_per_tensor(jnp.asarray(x))[0])


@pytest.mark.parametrize("shape,axis", [((32, 16), 1), ((3, 3, 64, 32), 3),
                                        ((8, 12), 0)])
def test_quantize_per_channel_equals_jax(shape, axis):
    w = np.random.RandomState(1).randn(*shape).astype(np.float32)
    w[..., 0] = 0.0 if axis == w.ndim - 1 else w[..., 0]  # an all-zero column
    q, s = quantize_per_channel(t(w), axis=axis)
    jq, js = jax_quantize_per_channel(jnp.asarray(w), axis=axis)
    assert s.shape == (shape[axis],)
    equal(q, jq)
    equal(s, js)


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_int8_matmul_equals_jax(out_dtype):
    rng = np.random.RandomState(2)
    a = rng.randint(-127, 128, (32, 128)).astype(np.int8)
    b = rng.randint(-127, 128, (128, 64)).astype(np.int8)
    a_scale = np.float32(0.0371)
    b_scale = rng.rand(64).astype(np.float32) * 0.01
    want = jax_int8_matmul(jnp.asarray(a), jnp.asarray(b), jnp.float32(a_scale),
                           jnp.asarray(b_scale), block_m=16, block_n=32,
                           block_k=64, out_dtype=jnp.dtype(out_dtype),
                           interpret=True)
    got = int8_matmul(t(a), t(b), torch.tensor(a_scale), t(b_scale),
                      out_dtype=getattr(torch, out_dtype))
    assert got.dtype == getattr(torch, out_dtype)
    equal(got.float(), np.asarray(want, np.float32))


def test_int8_matmul_exact_small_ints_and_k_accumulation():
    # tests/test_quant.py:31-60: small integers come back exactly, and a K
    # that spans many of the TPU kernel's steps still sums exactly
    rng = np.random.RandomState(1)
    a = rng.randint(-50, 50, (32, 128)).astype(np.int8)
    b = np.random.RandomState(2).randint(-50, 50, (128, 64)).astype(np.int8)
    got = int8_matmul(t(a), t(b), torch.tensor(1.0), torch.ones(64))
    equal(got, (a.astype(np.int32) @ b.astype(np.int32)).astype(np.float32))
    ones = int8_matmul(torch.ones(16, 512, dtype=torch.int8),
                       torch.ones(512, 128, dtype=torch.int8),
                       torch.tensor(2.0), torch.full((128,), 0.5))
    assert torch.equal(ones, torch.full((16, 128), 512.0))


def test_int8_matmul_plain_sums_exactly_past_f32():
    # K = 4608 products of 127 * 127: 74,322,432 > 2^24, still exact
    a = torch.full((2, 4608), 127, dtype=torch.int8)
    b = torch.full((4608, 16), 127, dtype=torch.int8)
    got = int8_matmul_plain(a, b, torch.tensor(1.0), torch.ones(16),
                            out_dtype=torch.float32)
    assert got[0, 0].item() == np.float32(4608 * 127 * 127)


def test_quantized_matmul_equals_jax():
    rng = np.random.RandomState(3)
    x = rng.randn(48, 256).astype(np.float32)
    w = rng.randn(256, 64).astype(np.float32)
    want = jax_quantized_matmul(jnp.asarray(x), jnp.asarray(w), interpret=True)
    got = quantized_matmul(t(x), t(w))
    equal(got, want)
    ref = x @ w   # and it is close to the float product (tests/test_quant.py)
    assert np.corrcoef(got.numpy().ravel(), ref.ravel())[0, 1] > 0.999


@pytest.mark.parametrize("x_shape,w_shape,out_dtype", [
    ((4, 8, 8, 32), (3, 3, 32, 16), "float32"),
    ((1, 5, 7, 16), (3, 3, 16, 32), "bfloat16")])
def test_int8_conv3x3_equals_jax(x_shape, w_shape, out_dtype):
    rng = np.random.RandomState(0)
    x_q = rng.randint(-40, 40, x_shape).astype(np.int8)
    w_q = rng.randint(-20, 20, w_shape).astype(np.int8)
    ws = rng.rand(w_shape[-1]).astype(np.float32) * 0.1
    want = jax_int8_conv3x3(jnp.asarray(x_q), jnp.asarray(w_q),
                            jnp.float32(0.05), jnp.asarray(ws), block_n=2,
                            out_dtype=jnp.dtype(out_dtype), interpret=True)
    got = int8_conv3x3(t(x_q), t(w_q), torch.tensor(0.05, dtype=torch.float32),
                       t(ws), out_dtype=getattr(torch, out_dtype))
    equal(got.float(), np.asarray(want, np.float32))


def test_int8_conv3x3_of_quantized_floats_equals_jax():
    # tests/test_quant_conv.py:25-36, each package quantizing with its own
    # quantizers
    rng = np.random.RandomState(1)
    x = rng.randn(2, 8, 8, 64).astype(np.float32)
    w = rng.randn(3, 3, 64, 32).astype(np.float32) * 0.1
    jx_q, jxs = jax_quantize_per_tensor(jnp.asarray(x))
    jw_q, jws = jax_quantize_per_channel(jnp.asarray(w), axis=3)
    want = jax_int8_conv3x3(jx_q, jw_q, jxs, jws, block_n=2, interpret=True)
    x_q, xs = quantize_per_tensor(t(x))
    w_q, ws = quantize_per_channel(t(w), axis=3)
    equal(int8_conv3x3_plain(x_q, w_q, xs, ws), want)


def test_int8_ops_refuse_other_devices():
    z = torch.zeros(16, 16, dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        int8_matmul(z, z, torch.tensor(1.0), torch.ones(16))
    with pytest.raises(ValueError, match="unsupported device"):
        int8_conv3x3(z.reshape(1, 4, 4, 16), z.reshape(1, 1, 16, 16).expand(
            3, 3, 16, 16), torch.tensor(1.0), torch.ones(16))


def test_gate_tables_and_requant_equal_jax():
    assert int8_gate.STAGES == tuple(s[:4] for s in jax_gate.STAGES)
    y = (np.random.RandomState(4).randn(1000) * 5).astype(np.float32)
    y[:4] = [0.025, 0.075, -0.025, 100.0]    # halves at scale 0.05, a clip
    for scale in (0.05, 0.005):
        equal(int8_gate.requant(t(y), scale), jax_gate.requant(jnp.asarray(y),
                                                               scale))


def _jax_int8_chain(yq, w1q, s1, w2q, s2, w3q, s3):
    """scripts/bench_int8_gate.py:110-121, op by op (interpret mode)."""
    requant, a = jax_gate.requant, jnp.float32(0.05)
    bb, hh, ww, cc = yq.shape
    cmid = w1q.shape[1]
    z = jax_int8_matmul(yq.reshape(bb * hh * ww, cc), w1q, a, s1,
                        out_dtype=jnp.float32, interpret=True)
    z = requant(jnp.maximum(z, 0), 0.05).reshape(bb, hh, ww, cmid)
    z = jax_int8_conv3x3(z, w2q, a, s2, block_n=1, out_dtype=jnp.float32,
                         interpret=True)
    z = requant(jnp.maximum(z, 0), 0.05)
    z = jax_int8_matmul(z.reshape(bb * hh * ww, cmid), w3q, a, s3,
                        out_dtype=jnp.float32, interpret=True)
    z = z.reshape(bb, hh, ww, cc) + yq.astype(jnp.float32) * 0.05
    return requant(jnp.maximum(z, 0), 0.05)


def _gate_operands(b, h, c, p, seed):
    rng = np.random.RandomState(seed)
    rq = lambda a, s: np.asarray(jax_gate.requant(jnp.asarray(a), s))
    return (rq(rng.randn(b, h, h, c).astype(np.float32) * 0.1, 0.05),
            rq(rng.randn(c, p).astype(np.float32) * 0.05, 0.005),
            np.full((p,), 0.005, np.float32),
            rq(rng.randn(3, 3, p, p).astype(np.float32) * 0.05, 0.005),
            np.full((p,), 0.005, np.float32),
            rq(rng.randn(p, c).astype(np.float32) * 0.05, 0.005),
            np.full((c,), 0.005, np.float32))


@pytest.mark.parametrize("b,h,c,p", [(2, 8, 64, 16), (1, 7, 128, 32)])
def test_gate_int8_chain_equals_jax(b, h, c, p):
    ops = _gate_operands(b, h, c, p, seed=h)
    want = _jax_int8_chain(*map(jnp.asarray, ops))
    got = int8_gate.bottleneck_int8(*map(t, ops), torch.tensor(0.05))
    assert got.dtype == torch.int8
    equal(got, want)
    assert np.abs(np.asarray(want, np.int32)).max() > 0   # not all zero
    plain = int8_gate.bottleneck_int8(*map(t, ops), torch.tensor(0.05),
                                      plain=True)
    assert torch.equal(got, plain)


def test_gate_bf16_chain_matches_jax_in_f32():
    rng = np.random.RandomState(6)
    b, h, c, p = 2, 8, 64, 16
    y = rng.randn(b, h, h, c).astype(np.float32) * 0.1
    w1, w2, w3 = (rng.randn(*s).astype(np.float32) * 0.05
                  for s in ((1, 1, c, p), (3, 3, p, p), (1, 1, p, c)))
    b1, b2, b3 = (rng.randn(n).astype(np.float32) * 0.1 for n in (p, p, c))
    dn = ("NHWC", "HWIO", "NHWC")
    conv = lambda v, k, pad: jax.lax.conv_general_dilated(
        v, jnp.asarray(k), (1, 1), pad, dimension_numbers=dn)
    z = jnp.maximum(conv(jnp.asarray(y), w1, "VALID") + b1, 0)
    z = jnp.maximum(conv(z, w2, "SAME") + b2, 0)
    want = np.asarray(jnp.maximum(conv(z, w3, "VALID") + b3 + y, 0))
    oihw = lambda k: t(k).permute(3, 2, 0, 1)
    got = int8_gate.bottleneck_bf16(
        t(y).permute(0, 3, 1, 2), oihw(w1), t(b1)[:, None, None], oihw(w2),
        t(b2)[:, None, None], oihw(w3), t(b3)[:, None, None])
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=1e-5, atol=1e-5)
