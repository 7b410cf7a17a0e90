"""TimeConv pyramid: max(x, causal2max(x), conv3+b3, conv5+b5, conv7+b7).

Port of the Pallas TPU kernel `tmrnet_tpu/ops/time_conv.py::time_conv_fused`
(:76-97, pallas_call at :82); the CUDA kernel is `csrc/time_conv.cu`, whose
header says what bounds it and how it is built.

x (B, W, C); weights in the flax layout (k, Cin, Cout); biases (C,).
`time_conv` takes the kernel for CUDA tensors and the plain version for CPU
tensors; anything else raises.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from tmrnet_torch.kernels import build
from tmrnet_torch.kernels.build import LAUNCHES


def time_conv_plain(x, w3, b3, w5, b5, w7, b7):
    """The math of `time_conv_reference` (tmrnet_tpu/ops/time_conv.py
    :100-116), in f32, result in x's dtype."""
    xf = x.float()
    xt = xf.transpose(1, 2)                                   # (B, C, W)

    def conv(wk, bk):
        k = wk.shape[0]
        wt = wk.float().permute(2, 1, 0)                      # (Cout, Cin, k)
        out = F.conv1d(xt, wt, bk.float(), padding=k // 2)
        return out.transpose(1, 2)

    shifted = F.pad(xf, (0, 0, 1, 0))[:, :-1, :]
    out = torch.maximum(xf, conv(w3, b3))
    out = torch.maximum(out, conv(w5, b5))
    out = torch.maximum(out, conv(w7, b7))
    out = torch.maximum(out, torch.maximum(xf, shifted))
    return out.to(x.dtype)


def _check(name, t, device, dtype, shape):
    if t.device != device:
        raise ValueError(f"time_conv_cuda: {name} on {t.device}, x on {device}")
    if t.dtype != dtype:
        raise TypeError(f"time_conv_cuda: {name} dtype {t.dtype}, want {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"time_conv_cuda: {name} shape {tuple(t.shape)}, "
                         f"want {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"time_conv_cuda: {name} is not contiguous")


def time_conv_cuda(x, w3, b3, w5, b5, w7, b7):
    """Launch csrc/time_conv.cu. x (B, W, C) bf16; w_k (k, C, C) bf16;
    b_k (C,) f32; C a multiple of 64; all contiguous on one CUDA device."""
    if x.device.type != "cuda":
        raise ValueError("time_conv_cuda: x is not on CUDA")
    if x.dim() != 3:
        raise ValueError(f"time_conv_cuda: x shape {tuple(x.shape)}")
    b, w, c = x.shape
    if c % 64 or b * w == 0:
        raise ValueError(f"time_conv_cuda: needs C % 64 == 0 and a nonempty "
                         f"batch, got x {tuple(x.shape)}")
    _check("x", x, x.device, torch.bfloat16, x.shape)
    for k, wk, bk in ((3, w3, b3), (5, w5, b5), (7, w7, b7)):
        _check(f"w{k}", wk, x.device, torch.bfloat16, (k, c, c))
        _check(f"b{k}", bk, x.device, torch.float32, (c,))
    lib = build.library("time_conv")
    fn = lib.tmr_time_conv
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty_like(x)
    p = build.ptr
    err = fn(p(x), p(w3), p(w5), p(w7), p(b3), p(b5), p(b7), p(out), b, w, c,
             build.stream_ptr(x.device))
    build.check(err, "time_conv")
    LAUNCHES["time_conv"] += 1
    return out


def time_conv(x, w3, b3, w5, b5, w7, b7):
    """(B, W, C) -> (B, W, C); the branch-wise max of the TimeConv block."""
    if x.device.type == "cpu":
        return time_conv_plain(x, w3, b3, w5, b5, w7, b7)
    if x.device.type == "cuda":
        return time_conv_cuda(x, w3, b3, w5, b5, w7, b7)
    raise ValueError(f"time_conv: unsupported device {x.device}")
