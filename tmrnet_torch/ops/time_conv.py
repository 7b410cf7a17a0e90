"""TimeConv pyramid: max(x, causal2max(x), conv3+b3, conv5+b5, conv7+b7).

Port of the Pallas TPU kernel `tmrnet_tpu/ops/time_conv.py::time_conv_fused`
(:76-97, pallas_call at :82); the CUDA kernel is `csrc/time_conv.cu`, whose
header says what bounds it and how it is built.

x (B, W, C); weights in the flax layout (k, Cin, Cout); biases (C,).
`time_conv` takes the kernel for CUDA tensors and the plain version for CPU
tensors; anything else raises. `plan_time_conv` decides how the kernel cuts
a call into blocks.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch
import torch.nn.functional as F

from tmrnet_torch.kernels import build
from tmrnet_torch.kernels.build import LAUNCHES

# Shared memory a Hopper block may opt into.
_SMEM_BLOCK_MAX = 232448
# time_conv.cu's block: one warpgroup on a tile of BM x BN; x rows staged
# with a halo of 3 (the k = 7 branch) on each side; a ring of NSTAGE K
# chunks.
BM, BN, HALO, NSTAGE = 64, 64, 3, 5


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


@dataclasses.dataclass(frozen=True)
class TimeConvPlan:
    """How csrc/time_conv.cu cuts one call: blocks of BM rows of B*W by BN
    columns of C; K chunks of `kc` input channels (the kernel's template
    argument); x staged `ck` channels at a time (once for all three
    branches where ck == c)."""
    c: int
    kc: int
    ck: int

    @property
    def smem(self) -> int:
        return time_conv_layout_bytes(self)


def time_conv_layout_bytes(plan: TimeConvPlan) -> int:
    """A block's shared memory, as `Layout` in csrc/time_conv.cu computes
    it: the ring (NSTAGE chunks of kc x BN bf16), the staged x tile (BM + 6
    rows of ck + 8 bf16; two buffers where C takes more than one chunk),
    one zero row of ck, and 1 KB of slack to align the ring."""
    x_bytes = (BM + 2 * HALO) * (plan.ck + 8) * 2
    nbuf = 2 if plan.c > plan.ck else 1
    return NSTAGE * plan.kc * BN * 2 + nbuf * x_bytes + plan.ck * 2 + 1024


def time_conv_grid(b: int, w: int, plan: TimeConvPlan):
    """The kernel's grid: (row tiles of BM over B*W, column tiles of BN)."""
    return -(-b * w // BM), plan.c // BN


@functools.lru_cache(maxsize=64)
def plan_time_conv(b: int, w: int, c: int) -> TimeConvPlan:
    """The plan of one call: K chunks of 128 input channels where C allows
    (half the chunks of 64, each chunk's fixed steps paid half as often),
    and the widest channel chunk (a multiple of kc dividing C, C itself
    where it fits) that fits a block's shared memory."""
    if c % 64 or b < 1 or w < 1:
        raise ValueError(f"time_conv_cuda: needs C % 64 == 0 and a nonempty "
                         f"batch, got B={b}, W={w}, C={c}")
    if b * w * c > 2**31 - 1:
        raise ValueError(f"time_conv_cuda: B*W*C = {b * w * c} elements, "
                         f"more than 32-bit offsets reach")
    kc = 128 if c % 128 == 0 else 64
    for ck in range(c, 0, -kc):
        plan = TimeConvPlan(c, kc, ck)
        if c % ck == 0 and plan.smem <= _SMEM_BLOCK_MAX:
            return plan
    raise ValueError(f"time_conv_cuda: no channel chunk of C={c} fits "
                     f"shared memory")


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


@functools.lru_cache(maxsize=None)
def _entries():
    """The library's two C entries, their argument types set once."""
    lib = build.library("time_conv")
    run, smem = lib.tmr_time_conv, lib.tmr_time_conv_smem
    run.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    run.restype = ctypes.c_int
    smem.argtypes = [ctypes.c_int] * 3
    smem.restype = ctypes.c_int
    return run, smem


def time_conv_cuda(x, w3, b3, w5, b5, w7, b7):
    """Launch csrc/time_conv.cu under `plan_time_conv`. x (B, W, C) bf16;
    w_k (k, C, C) bf16; b_k (C,) f32; C a multiple of 64; all contiguous on
    one CUDA device."""
    if x.device.type != "cuda":
        raise ValueError("time_conv_cuda: x is not on CUDA")
    if x.dim() != 3:
        raise ValueError(f"time_conv_cuda: x shape {tuple(x.shape)}")
    b, w, c = x.shape
    plan = plan_time_conv(b, w, c)
    _check("x", x, x.device, torch.bfloat16, x.shape)
    for k, wk, bk in ((3, w3, b3), (5, w5, b5), (7, w7, b7)):
        _check(f"w{k}", wk, x.device, torch.bfloat16, (k, c, c))
        _check(f"b{k}", bk, x.device, torch.float32, (c,))
    run, smem_of = _entries()
    smem = smem_of(c, plan.kc, plan.ck)
    if smem != plan.smem:
        raise RuntimeError(f"time_conv: the kernel lays out {smem} bytes of "
                           f"shared memory, the plan {plan.smem}")
    out = torch.empty_like(x)
    p = build.ptr
    err = run(p(x), p(w3), p(w5), p(w7), p(b3), p(b5), p(b7), p(out), b, w, c,
              plan.kc, plan.ck, build.stream_ptr(x.device))
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
