"""The main path's four kernels as `torch.library` ops
(`tmrnet_torch/kernels/library.py`), on the CPU: `torch.library.opcheck`
on each (schema, fake implementation, autograd registration, AOT
dispatch), each op's CPU result equal to its plain version bit for bit (it
is the plain version), a one-op module exported by `torch.export` to a
graph that holds the op as one node, and the fake implementations on fake
CUDA tensors: the output's shape and dtype where the kernel takes the
operands, the kernel's own error where it refuses them, so that an export
for the card fails at export time. No tolerance: every comparison here is
exact."""

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

import tmrnet_torch.ops  # noqa: F401  (registers the four ops)
from tmrnet_torch.experimental.fused_bottleneck import fused_bottleneck_plain
from tmrnet_torch.ops.nl_attention import (NLAttentionFunction, nl_attention,
                                           nl_attention_plain)
from tmrnet_torch.ops.time_conv import TimeConvFunction, time_conv, time_conv_plain

torch.set_num_threads(2)


def _rand(rng, *shape, scale=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * scale)
                            .astype(np.float32))


def _operands(name, dtype=torch.float32, c=64, p=64, device="cpu"):
    """Seeded operands of op `name` at a small legal shape: activations
    and weights in `dtype`, biases in f32."""
    rng = np.random.default_rng(7)
    if name == "nl_attention":
        ts = (_rand(rng, 3, c), _rand(rng, 3, 5, c), _rand(rng, 3, 5, c))
    elif name == "time_conv":
        ts = (_rand(rng, 2, 6, c),) + tuple(
            t for k in (3, 5, 7) for t in (_rand(rng, k, c, c, scale=0.1),
                                           _rand(rng, c, scale=0.1)))
    else:
        ts = (_rand(rng, 2, 5, 4, c), _rand(rng, c, p, scale=0.2),
              _rand(rng, p), _rand(rng, 3, 3, p, p, scale=0.1),
              _rand(rng, p), _rand(rng, p, c, scale=0.2), _rand(rng, c))
    return tuple(t.to(device, t.dtype if t.dim() == 1 and name != "nl_attention"
                      else dtype) for t in ts)


def _fake_cuda(args):
    """Fake CUDA tensors like `args` (inside a FakeTensorMode)."""
    return tuple(torch.empty(t.shape, dtype=t.dtype, device="cuda")
                 for t in args)


OPS = ("nl_attention", "time_conv", "fused_bottleneck",
       "fused_bottleneck_tiled")
PLAIN = {"nl_attention": nl_attention_plain, "time_conv": time_conv_plain,
         "fused_bottleneck": fused_bottleneck_plain,
         "fused_bottleneck_tiled": fused_bottleneck_plain}


def _op(name):
    return getattr(torch.ops.tmrnet, name).default


@pytest.mark.parametrize("name", OPS)
def test_opcheck(name):
    torch.library.opcheck(_op(name), _operands(name))


@pytest.mark.parametrize("name", OPS)
def test_cpu_op_is_the_plain_version(name):
    args = _operands(name)
    got = _op(name)(*args)
    assert torch.equal(got, PLAIN[name](*args))
    assert got.shape == args[0].shape and got.dtype == args[0].dtype


class _OneOp(torch.nn.Module):
    def __init__(self, name, weights):
        super().__init__()
        self.name = name
        self.weights = weights      # plain attributes: export's constants

    def forward(self, x):
        return _op(self.name)(x, *self.weights)


@pytest.mark.parametrize("name", OPS)
def test_one_op_module_exports_to_one_node(name):
    x, *weights = _operands(name)
    program = torch.export.export(_OneOp(name, weights), (x,))
    calls = [str(n.target) for n in program.graph.nodes
             if n.op == "call_function"]
    assert calls == [f"tmrnet.{name}.default"]
    assert torch.equal(program.module()(x), PLAIN[name](x, *weights))


@pytest.mark.parametrize("name", OPS)
def test_fake_cuda_operands_take_the_kernels_checks(name):
    bf16 = torch.bfloat16
    args, odd = _operands(name, bf16, c=256), _operands(
        name, bf16, c=48 if name != "nl_attention" else 4)
    with FakeTensorMode():
        args, odd = _fake_cuda(args), _fake_cuda(odd)
        out = _op(name)(*args)
        assert out.device.type == "cuda" and out.shape == args[0].shape
        assert out.dtype == bf16
        # what each kernel refuses: f32 activations beside bf16 weights
        # (each op takes bf16 or f32, in one dtype), a channel count off
        # the kernel's tiles, an NCHW-strided input
        with pytest.raises(TypeError, match="dtype"):
            _op(name)(args[0].float(), *args[1:])
        with pytest.raises(ValueError):
            _op(name)(*odd)
        if name.startswith("fused"):
            n, h, w, c = args[0].shape
            nchw = torch.empty((n, c, h, w), dtype=bf16,
                               device="cuda").permute(0, 2, 3, 1)
            with pytest.raises(ValueError, match="contiguous"):
                _op(name)(nchw, *args[1:])


def test_other_devices_raise():
    for name in OPS:
        args = _operands(name, device="meta")
        with pytest.raises(ValueError, match="unsupported device"):
            _op(name)(*args)


def test_autograd_records_through_the_functions_else_the_op():
    q, k, v = _operands("nl_attention")
    assert nl_attention(q, k, v).grad_fn is None
    q.requires_grad_(True)
    out = nl_attention(q, k, v)
    assert type(out.grad_fn).__name__ == NLAttentionFunction.__name__ + "Backward"
    with torch.no_grad():
        assert nl_attention(q, k, v).grad_fn is None
    x, *weights = _operands("time_conv")
    assert time_conv(x, *weights).grad_fn is None
    weights[0].requires_grad_(True)
    out = time_conv(x, *weights)
    assert type(out.grad_fn).__name__ == TimeConvFunction.__name__ + "Backward"
    out.sum().backward()
    assert weights[0].grad is not None and weights[0].grad.abs().sum() > 0
