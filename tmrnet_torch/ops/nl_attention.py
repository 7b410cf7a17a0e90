"""Non-local memory read: out[b] = softmax(q[b] . k[b]^T / sqrt(F)) . v[b].

Port of the Pallas TPU kernel `tmrnet_tpu/ops/nl_attention.py::nl_attention`
(:39-64, pallas_call at :50); the CUDA kernel is `csrc/nl_attention.cu`,
whose header says what bounds it and how it is built: one block per row,
k and v brought into shared memory by two bulk copies, math in f32, output
in q's dtype.

`nl_attention` takes the kernel for CUDA tensors and the plain version for
CPU tensors; anything else raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tmrnet_torch.kernels import build
from tmrnet_torch.kernels.build import LAUNCHES

# Shared memory a Hopper block may opt into.
_SMEM_BLOCK_MAX = 232448


def nl_attention_plain(q: torch.Tensor, k: torch.Tensor,
                       v: torch.Tensor) -> torch.Tensor:
    """The math of `nl_attention_reference` (tmrnet_tpu/ops/nl_attention.py
    :67-75): f32 logits * (1/F)**0.5, softmax over the window, f32 weighted
    sum, result in q's dtype."""
    f = q.shape[-1]
    logits = torch.einsum("bf,bwf->bw", q.float(), k.float()) * (1.0 / f) ** 0.5
    attn = torch.softmax(logits, dim=-1)
    return torch.einsum("bw,bwf->bf", attn, v.float()).to(q.dtype)


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


def nl_attention_cuda(q: torch.Tensor, k: torch.Tensor,
                      v: torch.Tensor) -> torch.Tensor:
    """Launch csrc/nl_attention.cu. q (B, F); k, v (B, W, F); all
    contiguous, 16-byte aligned CUDA tensors of one dtype (bf16 or f32)."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda":
            raise ValueError(f"nl_attention_cuda: {name} is not on CUDA")
        if t.dtype != q.dtype or t.dtype not in (torch.bfloat16, torch.float32):
            raise TypeError(f"nl_attention_cuda: {name} dtype {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"nl_attention_cuda: {name} is not contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"nl_attention_cuda: {name} is not 16-byte "
                             f"aligned, which the bulk copies need")
    if q.dim() != 2 or k.dim() != 3 or k.shape != v.shape \
            or k.shape[0] != q.shape[0] or k.shape[2] != q.shape[1]:
        raise ValueError(f"nl_attention_cuda: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if not (q.device == k.device == v.device):
        raise ValueError("nl_attention_cuda: tensors on different devices")
    b, f = q.shape
    w = k.shape[1]
    if b == 0:
        raise ValueError("nl_attention_cuda: empty batch")
    want = check_nl_attention_shape(w, f, q.element_size())
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
    LAUNCHES["nl_attention"] += 1
    return out


def nl_attention(q: torch.Tensor, k: torch.Tensor,
                 v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T / sqrt(F)) v; q (B, F), k/v (B, W, F) -> (B, F)."""
    if q.device.type == "cpu":
        return nl_attention_plain(q, k, v)
    if q.device.type == "cuda":
        return nl_attention_cuda(q, k, v)
    raise ValueError(f"nl_attention: unsupported device {q.device}")
