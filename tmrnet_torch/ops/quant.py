"""Symmetric int8 quantization and the int8 matmul with a dequantizing
epilogue.

Port of `tmrnet_tpu/ops/quant.py`: `quantize_per_tensor` (:26-31),
`quantize_per_channel` (:34-42), the Pallas TPU kernel `int8_matmul`
(:66-97, pallas_call at :80) and `quantized_matmul` (:100-106). The CUDA
kernel is `csrc/int8_matmul.cu` on the int8 tile of `csrc/int8_gemm.cuh`,
whose headers say what bounds it.

    out = f32(a_q @ b_q, summed exactly) * (a_scale * b_scale[n])

The scale product is taken in f32 before it multiplies the f32 sum, as the
TPU kernel does, so kernel and plain version agree bit for bit. The TPU
kernel's block sizes were its tiling and are not carried over.
`int8_matmul` takes the kernel for CUDA tensors and the plain version for
CPU tensors; anything else raises.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from tmrnet_torch.kernels import build
from tmrnet_torch.kernels.build import LAUNCHES

OUT_DTYPES = (torch.float32, torch.bfloat16)


def quantize_per_tensor(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantization: x ~ x_q * scale (0-d f32).
    Divides by the scale (not by a multiply with its reciprocal), rounds half
    to even and clips to +-127, as JAX does."""
    amax = x.abs().max().float()
    scale = torch.clamp(amax, min=1e-8) / 127.0
    q = torch.clamp(torch.round(x.float() / scale), -127, 127)
    return q.to(torch.int8), scale


def quantize_per_channel(w: torch.Tensor, axis: int = 1
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-channel int8 quantization along `axis` (1 for a
    (K, N) weight, 3 for an HWIO conv weight); scales (w.shape[axis],)."""
    axis = axis % w.dim()
    reduce_dims = tuple(i for i in range(w.dim()) if i != axis)
    amax = torch.amax(w.abs().float(), dim=reduce_dims, keepdim=True)
    scale = torch.clamp(amax, min=1e-8) / 127.0
    q = torch.clamp(torch.round(w.float() / scale), -127, 127)
    return q.to(torch.int8), scale.reshape(-1)


def dequantize(acc: torch.Tensor, a_scale, b_scale,
               out_dtype=torch.float32) -> torch.Tensor:
    """The epilogue of the int8 kernels on an exact (..., N) sum held in
    f64: f32(acc) * (a_scale * b_scale), the scale product in f32 first."""
    a_scale = torch.as_tensor(a_scale, dtype=torch.float32, device=acc.device)
    b_scale = torch.as_tensor(b_scale, dtype=torch.float32, device=acc.device)
    return (acc.float() * (a_scale.reshape(()) * b_scale)).to(out_dtype)


def int8_matmul_plain(a_q, b_q, a_scale, b_scale, out_dtype=torch.float32):
    """The Pallas kernel's math (tmrnet_tpu/ops/quant.py:45-60) in plain
    PyTorch. PyTorch has no integer matmul on CUDA and f32 is not exact for
    these sums, so the product is taken in f64, exact below 2^53."""
    return dequantize(a_q.double() @ b_q.double(), a_scale, b_scale, out_dtype)


def check_operand(name, t, device, dtype, shape=None):
    if t.device != device:
        raise ValueError(f"int8 kernel: {name} on {t.device}, operands on "
                         f"{device}")
    if t.dtype != dtype:
        raise TypeError(f"int8 kernel: {name} dtype {t.dtype}, want {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"int8 kernel: {name} shape {tuple(t.shape)}, want "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"int8 kernel: {name} is not contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"int8 kernel: {name} is not 16-byte aligned")


def check_scales(a_scale, b_scale, n, device):
    """a_scale: one f32 on the card (kept there: no host sync per call);
    b_scale: (n,) f32."""
    if not isinstance(a_scale, torch.Tensor) or a_scale.numel() != 1:
        raise ValueError("int8 kernel: the activation scale must be a "
                         "one-element f32 tensor on the card")
    check_operand("a_scale", a_scale, device, torch.float32)
    check_operand("b_scale", b_scale, device, torch.float32, (n,))


def int8_matmul_cuda(a_q, b_q, a_scale, b_scale, out_dtype=torch.float32):
    """Launch csrc/int8_matmul.cu. a_q (M, K), b_q (K, N) int8 contiguous;
    a_scale one f32, b_scale (N,) f32, all on one CUDA device; K % 16 == 0
    and N % 16 == 0."""
    if a_q.device.type != "cuda":
        raise ValueError("int8_matmul_cuda: a_q is not on CUDA")
    if a_q.dim() != 2 or b_q.dim() != 2 or a_q.shape[1] != b_q.shape[0]:
        raise ValueError(f"int8_matmul_cuda: a_q {tuple(a_q.shape)}, "
                         f"b_q {tuple(b_q.shape)}")
    m, k = a_q.shape
    n = b_q.shape[1]
    if k % 16 or n % 16 or m == 0 or k == 0:
        raise ValueError(f"int8_matmul_cuda: needs K % 16 == 0, N % 16 == 0 "
                         f"and nonempty operands, got M={m}, K={k}, N={n}")
    if out_dtype not in OUT_DTYPES:
        raise TypeError(f"int8_matmul_cuda: out_dtype {out_dtype}")
    check_operand("a_q", a_q, a_q.device, torch.int8)
    check_operand("b_q", b_q, a_q.device, torch.int8)
    check_scales(a_scale, b_scale, n, a_q.device)
    fn = build.library("int8_matmul").tmr_int8_matmul
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty((m, n), dtype=out_dtype, device=a_q.device)
    q = build.ptr
    err = fn(q(a_q), q(b_q), q(a_scale), q(b_scale), q(out), m, n, k,
             int(out_dtype == torch.bfloat16), build.stream_ptr(a_q.device))
    build.check(err, "int8_matmul")
    LAUNCHES["int8_matmul"] += 1
    return out


def int8_matmul(a_q, b_q, a_scale, b_scale, out_dtype=torch.float32):
    """(M, K) int8 @ (K, N) int8 -> out_dtype, dequantized by a_scale
    (one value) * b_scale (N,)."""
    if a_q.device.type == "cpu":
        return int8_matmul_plain(a_q, b_q, a_scale, b_scale, out_dtype)
    if a_q.device.type == "cuda":
        return int8_matmul_cuda(a_q, b_q, a_scale, b_scale, out_dtype)
    raise ValueError(f"int8_matmul: unsupported device {a_q.device}")


def quantized_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Float (M, K) @ (K, N) computed through int8: dynamic per-tensor
    activation quantization + per-channel weight quantization."""
    x_q, x_scale = quantize_per_tensor(x)
    w_q, w_scale = quantize_per_channel(w, axis=1)
    return int8_matmul(x_q, w_q, x_scale, w_scale)
