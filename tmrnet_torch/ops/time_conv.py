"""TimeConv pyramid: max(x, causal2max(x), conv3+b3, conv5+b5, conv7+b7).

Port of the Pallas TPU kernel `tmrnet_tpu/ops/time_conv.py::time_conv_fused`
(:76-97, pallas_call at :82). Two CUDA kernels, chosen by the operands'
dtype (`time_conv_dtype`: x and the weights in one dtype, bf16 or f32;
anything else on the card raises): `csrc/time_conv.cu` in bf16 on the
tensor cores and `csrc/time_conv_f32.cu` in f32 on the FFMA units (no
TF32). Each source's header says what bounds it and how it is built.

x (B, W, C); weights in the flax layout (k, Cin, Cout); biases (C,) f32.
The op `torch.ops.tmrnet.time_conv` (`kernels/library.py`) takes the
kernel for CUDA tensors and the plain version for CPU tensors; anything
else raises. A column slice (tensor parallelism over the model axis,
`parallel/tensor.py`) takes x (B, W, Cin) whole, weights (k, Cin, Cout)
and biases (Cout,) of the output channels [c0, c0 + Cout), and gives
(B, W, Cout): the convolutions read every input channel, the identity
and causal-max branches x's channels from c0. It is the op
`torch.ops.tmrnet.time_conv_slice`; `tmrnet::time_conv`, the whole width
(c0 = 0, Cout = Cin), keeps its schema, so exported artifacts load.
`time_conv` calls the op; where autograd records (grad
enabled and an input that requires it) it goes through `TimeConvFunction`,
whose forward calls the op once and whose backward recomputes the block in
plain f32 ops from the saved inputs (`time_conv_plain`, in the flax
module's nesting of the max), with no second launch. A caller whose
weights are not in the kernel's layout and dtype (a module's f32
parameters) passes `prepared`, copies that are, and the weights themselves
for the gradient. `plan_time_conv` (bf16) and `plan_time_conv_f32` decide
how a kernel cuts a launch into blocks. The kernels' offsets are 32-bit,
so one launch takes at most `time_conv_max_rows(W, C)` rows of B; a call
past that launches once per piece of at most that many rows (rows are
independent along B, so the output is the same).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional

import torch
import torch.nn.functional as F

from tmrnet_torch.device import at_least_f32
from tmrnet_torch.kernels import build, library

# Shared memory a Hopper block may opt into.
_SMEM_BLOCK_MAX = 232448
# time_conv.cu's block: one warpgroup on a tile of BM x BN; x rows staged
# with a halo of 3 (the k = 7 branch) on each side; a ring of NSTAGE K
# chunks.
BM, BN, HALO, NSTAGE = 64, 64, 3, 5
# time_conv_f32.cu's block: 256 threads on a tile of BM x BN; K chunks of
# F32_KC channels, the 15 taps' weights and x's BM + 6 rows (F32_LDX floats
# apart) and a zero row staged a chunk at a time.
F32_THREADS, F32_KC, F32_LDX, TAPS = 256, 16, 20, 15


def time_conv_plain(x, w3, b3, w5, b5, w7, b7, c0: int = 0):
    """The math of `time_conv_reference` (tmrnet_tpu/ops/time_conv.py
    :100-116), in f32 (f64 for f64 inputs), result in x's dtype. The max
    is nested as the flax TimeConv nests it (`tmrnet_tpu/models/blocks.py
    :88-91`), max(max(max(x, b1), max(b2, b3)), b4) with b1-b3 the convs
    and b4 = max(x, shifted x): the values do not depend on the nesting,
    but the split of a tie's gradient (torch.maximum and jnp.maximum halve
    it) does, and the backward differentiates this function. A column
    slice: w_k (k, Cin, Cout), the identity and b4 over x's channels [c0,
    c0 + Cout)."""
    xa = at_least_f32(x)
    xt = xa.transpose(1, 2)                                   # (B, C, W)
    xf = xa[..., c0:c0 + w3.shape[2]]

    def conv(wk, bk):
        k = wk.shape[0]
        wt = at_least_f32(wk).permute(2, 1, 0)                # (Cout, Cin, k)
        out = F.conv1d(xt, wt, at_least_f32(bk), padding=k // 2)
        return out.transpose(1, 2)

    shifted = F.pad(xf, (0, 0, 1, 0))[:, :-1, :]
    b4 = torch.maximum(xf, shifted)
    out = torch.maximum(torch.maximum(torch.maximum(xf, conv(w3, b3)),
                                      torch.maximum(conv(w5, b5),
                                                    conv(w7, b7))), b4)
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


def time_conv_grid(b: int, w: int, plan: TimeConvPlan,
                   cols: Optional[int] = None):
    """The kernel's grid: (row tiles of BM over B*W, column tiles of BN
    over the output's `cols` channels, default the plan's C)."""
    return -(-b * w // BM), (plan.c if cols is None else cols) // BN


def time_conv_max_rows(w: int, c: int) -> int:
    """The most rows of B one launch takes: B*W*C elements within the
    kernel's 32-bit offsets."""
    return (2**31 - 1) // (w * c)


@functools.lru_cache(maxsize=64)
def plan_time_conv(b: int, w: int, c: int) -> TimeConvPlan:
    """The plan of one launch: K chunks of 128 input channels where C allows
    (half the chunks of 64, each chunk's fixed steps paid half as often),
    and the widest channel chunk (a multiple of kc dividing C, C itself
    where it fits) that fits a block's shared memory."""
    if c % 64 or b < 1 or w < 1:
        raise ValueError(f"time_conv_cuda: needs C % 64 == 0 and a nonempty "
                         f"batch, got B={b}, W={w}, C={c}")
    if b > time_conv_max_rows(w, c):
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


def time_conv_dtype(x_dtype, w_dtypes) -> torch.dtype:
    """Which kernel takes the operands on the card: x's dtype where it and
    the three weights' are one, bf16 (csrc/time_conv.cu) or f32
    (csrc/time_conv_f32.cu); else TypeError (mixed dtypes, f16, f64)."""
    dtypes = {x_dtype, *w_dtypes}
    if len(dtypes) != 1 or x_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(
            f"time_conv_cuda: x {x_dtype} and weights "
            f"{', '.join(str(d) for d in w_dtypes)}: the card's kernels take "
            f"bf16 or f32, x and the weights in one dtype")
    return x_dtype


@dataclasses.dataclass(frozen=True)
class TimeConvF32Plan:
    """How csrc/time_conv_f32.cu cuts a call: `rows` rows of B a launch (the
    32-bit limit), `pieces` launches, a full launch's `grid` (row tiles of
    BM over rows x W, column tiles of BN over Cout) and a block's shared
    memory `smem` (the 15 taps' weights of a chunk, F32_KC x BN each, and
    BM + 6 + 1 staged rows of F32_LDX floats)."""
    rows: int
    pieces: int
    grid: tuple
    smem: int


def time_conv_f32_smem() -> int:
    """A block's shared memory, as `SMEM` in csrc/time_conv_f32.cu."""
    return (TAPS * F32_KC * BN + (BM + 2 * HALO + 1) * F32_LDX) * 4


def plan_time_conv_f32(b: int, w: int, c: int, cout: int) -> TimeConvF32Plan:
    """The f32 kernel's plan of a call of B rows: C and Cout multiples of
    64 (BN, and whole float4 loads); pieces of at most
    `time_conv_max_rows(W, C)` rows."""
    if c % BN or cout % BN or cout < BN or b < 1 or w < 1:
        raise ValueError(f"time_conv_cuda: needs C and Cout multiples of 64 "
                         f"and a nonempty batch, got B={b}, W={w}, C={c}, "
                         f"Cout={cout}")
    rows = time_conv_max_rows(w, c)
    if rows < 1:
        raise ValueError(f"time_conv_cuda: one row of W*C = {w * c} elements "
                         f"passes 32-bit offsets")
    rows = min(b, rows)
    return TimeConvF32Plan(rows, -(-b // rows),
                           (-(-rows * w // BM), cout // BN),
                           time_conv_f32_smem())


@functools.lru_cache(maxsize=None)
def _f32_entries():
    """The f32 library's two C entries, their argument types set once."""
    lib = build.library("time_conv_f32")
    run, smem = lib.tmr_time_conv_f32, lib.tmr_time_conv_f32_smem
    run.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    run.restype = ctypes.c_int
    smem.argtypes = []
    smem.restype = ctypes.c_int
    return run, smem


@functools.lru_cache(maxsize=None)
def _entries():
    """The library's two C entries, their argument types set once."""
    lib = build.library("time_conv")
    run, smem = lib.tmr_time_conv, lib.tmr_time_conv_smem
    run.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    run.restype = ctypes.c_int
    smem.argtypes = [ctypes.c_int] * 3
    smem.restype = ctypes.c_int
    return run, smem


def run_in_pieces(launch, x: torch.Tensor, rows: int,
                  cols: Optional[int] = None) -> torch.Tensor:
    """`launch(x_piece, out_piece)` over pieces of at most `rows` rows of
    x's first axis, each writing its rows of one output like x (of `cols`
    channels where given); one call where x fits."""
    out = (torch.empty_like(x) if cols is None else
           x.new_empty(tuple(x.shape[:-1]) + (cols,)))
    for start in range(0, x.shape[0], rows):
        launch(x[start:start + rows], out[start:start + rows])
    return out


def check_time_conv_operands(x, w3, b3, w5, b5, w7, b7, c0: int = 0):
    """The kernels' checks of their operands: x (B, W, C) bf16 or f32; w_k
    (k, C, Cout) in x's dtype (`time_conv_dtype`); b_k (Cout,) f32; C and
    Cout multiples of 64, the slice's first channel c0 too, c0 + Cout <= C;
    all contiguous on one CUDA device. Returns (rows of B a launch takes,
    the plan: a `TimeConvPlan` in bf16, a `TimeConvF32Plan` in f32,
    Cout)."""
    if x.device.type != "cuda":
        raise ValueError("time_conv_cuda: x is not on CUDA")
    if x.dim() != 3 or w3.dim() != 3:
        raise ValueError(f"time_conv_cuda: x shape {tuple(x.shape)}, w3 "
                         f"shape {tuple(w3.shape)}")
    dtype = time_conv_dtype(x.dtype, (w3.dtype, w5.dtype, w7.dtype))
    b, w, c = x.shape
    cout = w3.shape[2]
    if cout % 64 or c0 % 64 or cout < 1 or c0 < 0 or c0 + cout > c:
        raise ValueError(f"time_conv_cuda: needs C % 64 == 0 for a column "
                         f"slice of {cout} channels from {c0} of C={c}")
    rows = time_conv_max_rows(w, c)
    if rows < 1:
        raise ValueError(f"time_conv_cuda: one row of W*C = {w * c} elements "
                         f"passes 32-bit offsets")
    # the plan depends on C alone: one for every piece
    plan = (plan_time_conv(min(b, rows), w, c) if dtype == torch.bfloat16
            else plan_time_conv_f32(b, w, c, cout))
    _check("x", x, x.device, dtype, x.shape)
    for k, wk, bk in ((3, w3, b3), (5, w5, b5), (7, w7, b7)):
        _check(f"w{k}", wk, x.device, dtype, (k, c, cout))
        _check(f"b{k}", bk, x.device, torch.float32, (cout,))
    return rows, plan, cout


def time_conv_cuda(x, w3, b3, w5, b5, w7, b7, c0: int = 0):
    """Launch csrc/time_conv.cu (bf16 operands) under `plan_time_conv` or
    csrc/time_conv_f32.cu (f32) under `plan_time_conv_f32`, once per piece
    of at most `time_conv_max_rows` rows of B. x (B, W, C); w_k (k, C,
    Cout) in x's dtype; b_k (Cout,) f32: the output channels [c0, c0 +
    Cout) (the whole width by default, Cout = C), (B, W, Cout) in x's
    dtype; C, Cout and c0 multiples of 64; all contiguous on one CUDA
    device."""
    rows, plan, cout = check_time_conv_operands(x, w3, b3, w5, b5, w7, b7,
                                                c0)
    if x.dtype == torch.float32:
        return _time_conv_f32_cuda(x, (w3, b3, w5, b5, w7, b7), rows, plan,
                                   cout, c0)
    w, c = x.shape[1:]
    run, smem_of = _entries()
    smem = smem_of(c, plan.kc, plan.ck)
    if smem != plan.smem:
        raise RuntimeError(f"time_conv: the kernel lays out {smem} bytes "
                           f"of shared memory, the plan {plan.smem}")
    p = build.ptr

    def launch(xp, out):
        err = run(p(xp), p(w3), p(w5), p(w7), p(b3), p(b5), p(b7), p(out),
                  xp.shape[0], w, c, cout, c0, plan.kc, plan.ck,
                  build.stream_ptr(x.device))
        build.check(err, "time_conv")
        build.count("time_conv", x.device)

    return run_in_pieces(launch, x, rows, cout)


def _time_conv_f32_cuda(x, weights, rows, plan, cout, c0):
    """csrc/time_conv_f32.cu over the pieces of `rows` rows; its float4
    loads want every operand 16-byte aligned."""
    w3, b3, w5, b5, w7, b7 = weights
    for name, t in zip(("x", "w3", "b3", "w5", "b5", "w7", "b7"),
                       (x, *weights)):
        if t.data_ptr() % 16:
            raise ValueError(f"time_conv_cuda: {name} is not 16-byte aligned")
    w, c = x.shape[1:]
    run, smem_of = _f32_entries()
    if smem_of() != plan.smem:
        raise RuntimeError(f"time_conv_f32: the kernel lays out {smem_of()} "
                           f"bytes of shared memory, the plan {plan.smem}")
    p = build.ptr

    def launch(xp, out):
        err = run(p(xp), p(w3), p(w5), p(w7), p(b3), p(b5), p(b7), p(out),
                  xp.shape[0], w, c, cout, c0, build.stream_ptr(x.device))
        build.check(err, "time_conv_f32")
        build.count("time_conv_f32", x.device)

    return run_in_pieces(launch, x, rows, cout)


def _time_conv_fake(x, w3, b3, w5, b5, w7, b7, c0: int = 0):
    if x.device.type == "cuda":
        check_time_conv_operands(x, w3, b3, w5, b5, w7, b7, c0)
    return x.new_empty(tuple(x.shape[:-1]) + (w3.shape[2],))


_OPERANDS = ("(Tensor x, Tensor w3, Tensor b3, Tensor w5, Tensor b5, "
             "Tensor w7, Tensor b7")
time_conv_op = library.define(
    "time_conv", _OPERANDS + ") -> Tensor", time_conv_cuda, time_conv_plain,
    _time_conv_fake)
time_conv_slice_op = library.define(
    "time_conv_slice", _OPERANDS + ", int c0) -> Tensor", time_conv_cuda,
    time_conv_plain, _time_conv_fake)


def _op_call(x, weights, c0):
    """The whole-width op where the weights are square and c0 is 0, else
    the column slice's."""
    if c0 == 0 and weights[0].shape[2] == x.shape[-1]:
        return time_conv_op(x, *weights)
    return time_conv_slice_op(x, *weights, c0)


class TimeConvFunction(torch.autograd.Function):
    """Forward: the op, once, on `prepared` where given, else on the
    weights. Backward: `time_conv_plain` in f32 from the saved x and
    weights (over the same column slice)."""

    @staticmethod
    def forward(ctx, x, prepared, c0, *weights):
        ctx.save_for_backward(x, *weights)
        ctx.c0 = c0
        return _op_call(x, prepared or weights, c0)

    @staticmethod
    def backward(ctx, grad):
        x, *weights = ctx.saved_tensors
        need = ctx.needs_input_grad[:1] + ctx.needs_input_grad[3:]
        with torch.enable_grad():
            inputs = [at_least_f32(t.detach()).requires_grad_(n)
                      for t, n in zip([x, *weights], need)]
            out = time_conv_plain(*inputs, c0=ctx.c0)
            wanted = [t for t in inputs if t.requires_grad]
            grads = iter(torch.autograd.grad(out, wanted,
                                             grad.to(out.dtype))
                         if wanted else ())
        got = [next(grads).to(t.dtype) if n else None
               for t, n in zip([x, *weights], need)]
        return (got[0], None, None, *got[1:])


def time_conv(x, w3, b3, w5, b5, w7, b7, prepared=None, c0: int = 0):
    """(B, W, C) -> (B, W, Cout); the branch-wise max of the TimeConv
    block over the output channels [c0, c0 + Cout) of (k, C, Cout)
    weights (the whole width by default), differentiable in x and the
    weights. prepared: (w3, b3, w5, b5, w7, b7) in the kernel's layout and
    dtypes, run in place of the weights."""
    weights = (w3, b3, w5, b5, w7, b7)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, *weights)):
        return TimeConvFunction.apply(x, prepared, c0, *weights)
    return _op_call(x, prepared or weights, c0)
