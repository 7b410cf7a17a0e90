"""Non-local memory read: out[b] = softmax(q[b] . k[b]^T / sqrt(F)) . v[b].

Port of the Pallas TPU kernel `tmrnet_tpu/ops/nl_attention.py::nl_attention`
(:39-64, pallas_call at :50) as a Triton kernel for Hopper.

Bound on the H100: bytes. One query per row means 2*W*F multiply-adds for
(2W+1)*F loaded values: at B=32, W=30, F=512 it is ~2 MB of bf16 for
~2 MFLOP, a few FLOP per byte, far below the card's ridge. There is no
tensor-core work in it. Design: one program per row streams k and v once
in (W padded to a power of two) x 128 tiles, keeps the W logits in
registers, masks the padded window slots to -inf, and writes the (F,) row;
the (B, W) attention matrix never reaches device memory. Math in f32,
output in q's dtype.

`nl_attention` takes the kernel for CUDA tensors and the plain version for
CPU tensors; anything else raises.
"""

from __future__ import annotations

import torch

from tmrnet_torch.kernels.build import LAUNCHES

_kernel_cache = {}
_BLOCK_F = 128


def nl_attention_plain(q: torch.Tensor, k: torch.Tensor,
                       v: torch.Tensor) -> torch.Tensor:
    """The math of `nl_attention_reference` (tmrnet_tpu/ops/nl_attention.py
    :67-75): f32 logits * (1/F)**0.5, softmax over the window, f32 weighted
    sum, result in q's dtype."""
    f = q.shape[-1]
    logits = torch.einsum("bf,bwf->bw", q.float(), k.float()) * (1.0 / f) ** 0.5
    attn = torch.softmax(logits, dim=-1)
    return torch.einsum("bw,bwf->bf", attn, v.float()).to(q.dtype)


def _triton_kernel():
    if "k" in _kernel_cache:
        return _kernel_cache["k"]
    import triton
    import triton.language as tl

    @triton.jit
    def _nl_attention_kernel(q_ptr, k_ptr, v_ptr, o_ptr, W, F, scale,
                             BLOCK_W: tl.constexpr, BLOCK_F: tl.constexpr):
        row = tl.program_id(0).to(tl.int64)
        offs_w = tl.arange(0, BLOCK_W)
        offs_f = tl.arange(0, BLOCK_F)
        wmask = offs_w < W
        kv_base = row * W * F
        logits = tl.zeros((BLOCK_W,), dtype=tl.float32)
        for f0 in range(0, F, BLOCK_F):
            fmask = (f0 + offs_f) < F
            q = tl.load(q_ptr + row * F + f0 + offs_f, mask=fmask,
                        other=0.0).to(tl.float32)
            kt = tl.load(k_ptr + kv_base + offs_w[:, None] * F + f0
                         + offs_f[None, :],
                         mask=wmask[:, None] & fmask[None, :],
                         other=0.0).to(tl.float32)
            logits += tl.sum(kt * q[None, :], axis=1)
        logits = tl.where(wmask, logits * scale, float("-inf"))
        e = tl.exp(logits - tl.max(logits, axis=0))
        e = tl.where(wmask, e, 0.0)
        attn = e / tl.sum(e, axis=0)
        for f0 in range(0, F, BLOCK_F):
            fmask = (f0 + offs_f) < F
            vt = tl.load(v_ptr + kv_base + offs_w[:, None] * F + f0
                         + offs_f[None, :],
                         mask=wmask[:, None] & fmask[None, :],
                         other=0.0).to(tl.float32)
            out = tl.sum(attn[:, None] * vt, axis=0)
            tl.store(o_ptr + row * F + f0 + offs_f,
                     out.to(o_ptr.dtype.element_ty), mask=fmask)

    _kernel_cache["k"] = (triton, _nl_attention_kernel)
    return _kernel_cache["k"]


def nl_attention_cuda(q: torch.Tensor, k: torch.Tensor,
                      v: torch.Tensor) -> torch.Tensor:
    """Launch the Triton kernel. q (B, F); k, v (B, W, F); all contiguous
    CUDA tensors of one dtype (bf16 or f32)."""
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
    b, f = q.shape
    w = k.shape[1]
    if b == 0 or w == 0:
        raise ValueError("nl_attention_cuda: empty batch or window")
    triton, kern = _triton_kernel()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        kern[(b,)](q, k, v, out, w, f, (1.0 / f) ** 0.5,
                   BLOCK_W=max(16, triton.next_power_of_2(w)),
                   BLOCK_F=_BLOCK_F, num_warps=4)
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
