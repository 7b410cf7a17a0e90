"""The namespace `tmrnet`: the main path's kernels as `torch.library`
ops, `torch.ops.tmrnet.{nl_attention, time_conv, fused_bottleneck,
fused_bottleneck_tiled}`, and `time_conv_slice`, the time_conv kernels
over a column slice (tensor parallelism; its own op, so that
`time_conv`'s schema, which exported artifacts hold, is unchanged).
Every op takes bf16 or f32: the time_conv ops launch `csrc/time_conv.cu`
or `csrc/time_conv_f32.cu` by dtype, the bottleneck ops
`csrc/fused_bottleneck{,_tiled}.cu` or `csrc/fused_bottleneck{,_tiled}_f32.cu`
(their schemas are those of the bf16-only ops before them, so artifacts
exported with those still load).

Each op has three implementations, registered by the module of its kernel
(`ops/nl_attention.py`, `ops/time_conv.py`,
`experimental/fused_bottleneck.py`, `experimental/fused_bottleneck_tiled.py`;
importing `tmrnet_torch.ops` imports all four):
- CUDA: the kernel's launch (the `*_cuda` wrapper, which counts it in
  `build.LAUNCHES`), or an error; nothing falls back on the card;
- CPU: the plain PyTorch version;
- fake: the output's shape and dtype for tracing and `torch.export`. For a
  fake CUDA tensor it also runs the kernel's checks of dtypes, shapes,
  contiguity and plan, so that an export for the card fails at export time
  on operands the kernel refuses (what it cannot see there, the data
  pointers' alignment, the wrapper checks at launch). Real tensors on any
  other device (`meta` reaches the fake implementation too) raise.

An exported program holds each op as one node and launches it through the
dispatcher, so loading one needs these registrations (`import
tmrnet_torch.ops`). The ops are defined through `torch.library.Library`,
whose dispatch costs less host time a call than `torch.library.custom_op`'s
Python wrapper.
"""

from __future__ import annotations

from typing import Callable

import torch

LIB = torch.library.Library("tmrnet", "DEF")


def define(name: str, schema: str, cuda: Callable, cpu: Callable,
           fake: Callable):
    """Define `tmrnet::<name><schema>` with its CUDA, CPU and fake
    implementations; returns its overload, `torch.ops.tmrnet.<name>`."""
    def fake_or_refuse(x, *rest):
        if x.device.type not in ("cpu", "cuda"):
            raise ValueError(f"{name}: unsupported device {x.device}")
        return fake(x, *rest)

    LIB.define(name + schema)
    LIB.impl(name, cuda, "CUDA")
    LIB.impl(name, cpu, "CPU")
    torch.library.register_fake(f"tmrnet::{name}", fake_or_refuse, lib=LIB)
    return getattr(torch.ops.tmrnet, name).default
