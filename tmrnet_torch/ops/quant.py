"""Symmetric int8 quantization and the int8 matmul with a dequantizing
epilogue.

Port of `tmrnet_tpu/ops/quant.py`: `quantize_per_tensor` (:26-31),
`quantize_per_channel` (:34-42), the Pallas TPU kernel `int8_matmul`
(:66-97, pallas_call at :80) and `quantized_matmul` (:100-106). The CUDA
kernel is `csrc/int8_matmul.cu` on the int8 wgmma block of
`csrc/wgmma_s8_gemm.cuh`, whose headers say what bounds it.

    out = f32(a_q @ b_q, summed exactly) * (a_scale * b_scale[n])

The scale product is taken in f32 before it multiplies the f32 sum, as the
TPU kernel does, so kernel and plain version agree bit for bit. The TPU
kernel's block sizes were its tiling and are not carried over.
`int8_matmul` takes the kernel for CUDA tensors and the plain version for
CPU tensors; anything else raises. `plan_int8_matmul` decides how the kernel
cuts a call into blocks (`Int8Plan` serves the conv's plan too); `kmajor_b`
keeps the (N, K) copy of b_q that the kernel reads.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Tuple

import torch

from tmrnet_torch.kernels import build
from tmrnet_torch.kernels.build import LAUNCHES
from tmrnet_torch.kernels.prepared import copy_beside

OUT_DTYPES = (torch.float32, torch.bfloat16)

_SMEM_SM = 233472          # an SM's shared memory, 1 KB of it per block reserved
SMS = 132                  # an H100 SXM's SMs: blocks per wave
BM, BK = 128, 128          # rows of a tile (two warpgroups of 64); bytes of K a chunk
_BLOCKS_BY_REGS = {64: 3, 128: 2, 256: 1}   # the kernels' launch bounds
# The (tile width, ring depth) pairs csrc/int8_matmul.cu is built for
# (TMR_I8M_PLANS): each one plan_int8_matmul picks at some shape.
MATMUL_PLANS = ((64, 3), (64, 4), (128, 3), (256, 4))
# The matmul's cost model, in cycles of an SM: its share of device memory
# (3.35 TB/s over 132 SMs at ~1.75 GHz), a block's fixed cost (prologue,
# epilogue, launch), the latency before its first chunk, and a chunk's load
# latency from L2 and from device memory under load. Fitted on an H100 to
# the int8 gate's products (PERF.md, experimental/kernel_timing.py
# --all-plans), with the physical rates held fixed.
_HBM_BYTES_CYCLE = 14.5
_FIXED, _FIRST, _LAT_L2, _LAT_HBM = 1500, 3000, 1000, 10000


@dataclasses.dataclass(frozen=True)
class Int8Plan:
    """How the int8 wgmma block (csrc/wgmma_s8_gemm.cuh) cuts one call:
    output tiles of BM = 128 rows by bn columns, K chunks through a ring of
    `nstage` stages."""
    bn: int
    nstage: int
    bm = BM

    @property
    def smem(self) -> int:
        """A block's shared memory, as `smem_bytes` in the kernels computes
        it: the ring of BM + bn rows of 128 bytes a stage, + 1 KB of slack
        to align it."""
        return self.nstage * (BM + self.bn) * BK + 1024

    @property
    def blocks_per_sm(self) -> int:
        """As many as the registers allow and the rings fit an SM."""
        return min(_BLOCKS_BY_REGS[self.bn], _SMEM_SM // (self.smem + 1024))


def matmul_plan_cost(plan: Int8Plan, m: int, k: int, n: int,
                     out_bytes: int = 4):
    """The plan's sort key: the modelled cycles of an SM, then more blocks
    an SM, then the deeper ring. An SM runs waves of `blocks_per_sm` tiles
    (over 132 SMs); a wave takes the longer of
    - its blocks' shared work: each block's K chunks at 4 bn cycles of int8
      tensor work (4,096 products a cycle) plus 2 (BM + bn) cycles of copies
      (64 bytes a cycle from L2), or its bytes to and from device memory (the
      output, and A's rows once a row block: the grid runs a row block's
      column tiles side by side) at an SM's share of 3.35 TB/s, whichever
      is longer, plus a fixed cost a block;
    - one block's chain: the latency before its first chunk, each chunk the
      longer of its work and its load latency over the chunks in flight (the
      ring depth less 2; from device memory once a row block, else from L2),
      then its output's stores.
    At the gate's products the output is up to 94% of the bytes, so the
    stores and the tiles an SM holds, not the tensor cores, decide."""
    bn, blocks = plan.bn, plan.blocks_per_sm
    col_tiles = -(-n // bn)
    waves = -(-(-(-m // BM) * col_tiles) // (SMS * blocks))
    nk = -(-k // BK)
    chunk = 4 * bn + 2 * (BM + bn)
    out = out_bytes * BM * bn
    work = max(nk * chunk, (out + BM * k / col_tiles) / _HBM_BYTES_CYCLE) + _FIXED
    latency = _LAT_L2 + (_LAT_HBM - _LAT_L2) / col_tiles
    chain = (_FIRST + nk * max(chunk, latency / (plan.nstage - 2))
             + out / _HBM_BYTES_CYCLE)
    return waves * max(blocks * work, chain), -blocks, -plan.nstage


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


def check_matmul_shape(m: int, k: int, n: int) -> None:
    """What the kernel takes: K and N multiples of 16, nonempty operands,
    M and N below 2^31."""
    if k % 16 or n % 16 or m < 1 or k < 16 or n < 16:
        raise ValueError(f"int8_matmul_cuda: needs K % 16 == 0, N % 16 == 0 "
                         f"and nonempty operands, got M={m}, K={k}, N={n}")
    if m >= 2 ** 31 or n >= 2 ** 31:
        raise ValueError(f"int8_matmul_cuda: M={m}, N={n} too large (< 2^31)")


@functools.lru_cache(maxsize=256)
def plan_int8_matmul(m: int, k: int, n: int, out_bytes: int = 4) -> Int8Plan:
    """The plan of one (M, K) @ (K, N) call with `out_bytes` a result value
    (4 for f32, 2 for bf16): of the plans the kernel is built for, the one
    of least `matmul_plan_cost`."""
    check_matmul_shape(m, k, n)
    plans = (Int8Plan(bn, s) for bn, s in MATMUL_PLANS)
    return min(plans, key=lambda p: matmul_plan_cost(p, m, k, n, out_bytes))


def _transpose(b_q: torch.Tensor) -> torch.Tensor:
    return b_q.t().contiguous()


def kmajor_b(b_q: torch.Tensor) -> torch.Tensor:
    """b_q (K, N) as the kernel reads it: (N, K) contiguous (K-major, as the
    integer wgmma requires of B). Made once per change of b_q and kept beside
    b_q for as long as b_q lives (`kernels.prepared.copy_beside`); a b_q
    made afresh on each call, as `quantized_matmul`'s weight is, gets its
    copy afresh."""
    return copy_beside(b_q, _transpose)


@functools.lru_cache(maxsize=None)
def _entries():
    """The library's two C entries, their argument types set once."""
    lib = build.library("int8_matmul")
    run, smem = lib.tmr_int8_matmul, lib.tmr_int8_matmul_smem
    run.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    run.restype = ctypes.c_int
    smem.argtypes = [ctypes.c_int] * 2
    smem.restype = ctypes.c_int
    return run, smem


def int8_matmul_cuda(a_q, b_q, a_scale, b_scale, out_dtype=torch.float32,
                     plan: Int8Plan = None):
    """Launch csrc/int8_matmul.cu under `plan` (default `plan_int8_matmul`).
    a_q (M, K), b_q (K, N) int8 contiguous; a_scale one f32, b_scale (N,)
    f32, all on one CUDA device; K % 16 == 0 and N % 16 == 0."""
    if a_q.device.type != "cuda":
        raise ValueError("int8_matmul_cuda: a_q is not on CUDA")
    if a_q.dim() != 2 or b_q.dim() != 2 or a_q.shape[1] != b_q.shape[0]:
        raise ValueError(f"int8_matmul_cuda: a_q {tuple(a_q.shape)}, "
                         f"b_q {tuple(b_q.shape)}")
    m, k = a_q.shape
    n = b_q.shape[1]
    check_matmul_shape(m, k, n)
    if out_dtype not in OUT_DTYPES:
        raise TypeError(f"int8_matmul_cuda: out_dtype {out_dtype}")
    check_operand("a_q", a_q, a_q.device, torch.int8)
    check_operand("b_q", b_q, a_q.device, torch.int8)
    check_scales(a_scale, b_scale, n, a_q.device)
    out_bytes = torch.finfo(out_dtype).bits // 8
    plan = plan or plan_int8_matmul(m, k, n, out_bytes)
    run, smem_of = _entries()
    smem = smem_of(plan.bn, plan.nstage)
    if smem != plan.smem:
        raise RuntimeError(f"int8_matmul: the kernel lays out {smem} bytes "
                           f"of shared memory for {plan}, the plan {plan.smem}")
    bk = kmajor_b(b_q)
    out = torch.empty((m, n), dtype=out_dtype, device=a_q.device)
    q = build.ptr
    err = run(q(a_q), q(bk), q(a_scale), q(b_scale), q(out), m, n, k,
              int(out_dtype == torch.bfloat16), plan.bn, plan.nstage,
              build.stream_ptr(a_q.device))
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
