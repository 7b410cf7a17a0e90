"""Non-local memory read: out[b] = softmax(q[b] . k[b]^T / sqrt(F)) . v[b].

Port of the Pallas TPU kernel `tmrnet_tpu/ops/nl_attention.py::nl_attention`
(:39-64, pallas_call at :50); the CUDA kernel is `csrc/nl_attention.cu`,
whose header says what bounds it and how it is built: one block per row,
k and v brought into shared memory by two bulk copies, math in f32, output
in q's dtype.

The op `torch.ops.tmrnet.nl_attention` (`kernels/library.py`) takes the
kernel for CUDA tensors and the plain version for CPU tensors; anything
else raises. One launch takes any B: the kernel's row offsets are 64-bit.
`nl_attention` calls the op; where autograd records (grad enabled and an
input that requires it) it goes through `NLAttentionFunction`, whose
forward calls the op once and whose backward recomputes the plain version
in f32 from the saved q, k and v, with no second launch, for dq, dk and
dv.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tmrnet_torch.device import at_least_f32
from tmrnet_torch.kernels import build, library

# Shared memory a Hopper block may opt into.
_SMEM_BLOCK_MAX = 232448


def nl_attention_plain(q: torch.Tensor, k: torch.Tensor,
                       v: torch.Tensor) -> torch.Tensor:
    """The math of `nl_attention_reference` (tmrnet_tpu/ops/nl_attention.py
    :67-75): f32 logits * (1/F)**0.5, softmax over the window, f32 weighted
    sum (f64 for f64 inputs), result in q's dtype."""
    f = q.shape[-1]
    logits = torch.einsum("bf,bwf->bw", at_least_f32(q),
                          at_least_f32(k)) * (1.0 / f) ** 0.5
    attn = torch.softmax(logits, dim=-1)
    return torch.einsum("bw,bwf->bf", attn, at_least_f32(v)).to(q.dtype)


def nl_attention_smem_bytes(w: int, f: int, itemsize: int) -> int:
    """A block's shared memory, as `Layout` in csrc/nl_attention.cu
    computes it: k and v (w * f elements each), q as f32, the w logits as
    f32 (rounded up to 4), two mbarriers."""
    return 2 * w * f * itemsize + 4 * f + 4 * (-(-w // 4) * 4) + 16


def check_nl_attention_shape(w: int, f: int, itemsize: int) -> int:
    """Raise ValueError where the kernel cannot take a window of w rows of f
    elements of `itemsize` bytes; else return its shared-memory bytes."""
    if w < 1 or f < 1:
        raise ValueError(f"nl_attention_cuda: empty window or row (W={w}, "
                         f"F={f})")
    if (f * itemsize) % 16:
        raise ValueError(f"nl_attention_cuda: a row of F={f} elements of "
                         f"{itemsize} bytes is not a multiple of 16 bytes, "
                         f"which the bulk copies need")
    smem = nl_attention_smem_bytes(w, f, itemsize)
    if smem > _SMEM_BLOCK_MAX:
        raise ValueError(f"nl_attention_cuda: k and v of W={w} x F={f} "
                         f"elements of {itemsize} bytes take {smem} bytes of "
                         f"shared memory, a block has {_SMEM_BLOCK_MAX}")
    return smem


@functools.lru_cache(maxsize=None)
def _entries():
    """The library's two C entries, their argument types set once."""
    lib = build.library("nl_attention")
    run, smem = lib.tmr_nl_attention, lib.tmr_nl_attention_smem
    run.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    run.restype = ctypes.c_int
    smem.argtypes = [ctypes.c_int] * 3
    smem.restype = ctypes.c_int
    return run, smem


def check_nl_attention_operands(q, k, v) -> int:
    """The kernel's checks of its operands, but their alignment: q (B, F);
    k, v (B, W, F); contiguous CUDA tensors of one dtype (bf16 or f32) on
    one device; B > 0. Returns the block's shared-memory bytes."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda":
            raise ValueError(f"nl_attention_cuda: {name} is not on CUDA")
        if t.dtype != q.dtype or t.dtype not in (torch.bfloat16, torch.float32):
            raise TypeError(f"nl_attention_cuda: {name} dtype {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"nl_attention_cuda: {name} is not contiguous")
    if q.dim() != 2 or k.dim() != 3 or k.shape != v.shape \
            or k.shape[0] != q.shape[0] or k.shape[2] != q.shape[1]:
        raise ValueError(f"nl_attention_cuda: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if not (q.device == k.device == v.device):
        raise ValueError("nl_attention_cuda: tensors on different devices")
    if q.shape[0] == 0:
        raise ValueError("nl_attention_cuda: empty batch")
    return check_nl_attention_shape(k.shape[1], q.shape[1], q.element_size())


def nl_attention_cuda(q: torch.Tensor, k: torch.Tensor,
                      v: torch.Tensor) -> torch.Tensor:
    """Launch csrc/nl_attention.cu. q (B, F); k, v (B, W, F); all
    contiguous, 16-byte aligned CUDA tensors of one dtype (bf16 or f32)."""
    want = check_nl_attention_operands(q, k, v)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"nl_attention_cuda: {name} is not 16-byte "
                             f"aligned, which the bulk copies need")
    b, f = q.shape
    w = k.shape[1]
    run, smem_of = _entries()
    smem = smem_of(w, f, q.element_size())
    if smem != want:
        raise RuntimeError(f"nl_attention: the kernel lays out {smem} bytes of "
                           f"shared memory, the wrapper {want}")
    out = torch.empty_like(q)
    p = build.ptr
    err = run(p(q), p(k), p(v), p(out), b, w, f,
              int(q.dtype == torch.float32), build.stream_ptr(q.device))
    build.check(err, "nl_attention")
    build.count("nl_attention", q.device)
    return out


def _nl_attention_fake(q, k, v):
    if q.device.type == "cuda":
        check_nl_attention_operands(q, k, v)
    return torch.empty_like(q)


nl_attention_op = library.define(
    "nl_attention", "(Tensor q, Tensor k, Tensor v) -> Tensor",
    nl_attention_cuda, nl_attention_plain, _nl_attention_fake)


class NLAttentionFunction(torch.autograd.Function):
    """Forward: the op, once. Backward: the plain version in f32 from the
    saved inputs."""

    @staticmethod
    def forward(ctx, q, k, v):
        ctx.save_for_backward(q, k, v)
        return nl_attention_op(q, k, v)

    @staticmethod
    def backward(ctx, grad):
        saved = ctx.saved_tensors
        need = ctx.needs_input_grad
        with torch.enable_grad():
            inputs = [at_least_f32(t.detach()).requires_grad_(n)
                      for t, n in zip(saved, need)]
            out = nl_attention_plain(*inputs)
            wanted = [t for t in inputs if t.requires_grad]
            grads = iter(torch.autograd.grad(out, wanted,
                                             grad.to(out.dtype))
                         if wanted else ())
        return tuple(next(grads).to(t.dtype) if n else None
                     for t, n in zip(saved, need))


def nl_attention(q: torch.Tensor, k: torch.Tensor,
                 v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T / sqrt(F)) v; q (B, F), k/v (B, W, F) -> (B, F),
    differentiable in q, k and v."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return NLAttentionFunction.apply(q, k, v)
    return nl_attention_op(q, k, v)
