"""Device and dtype resolution shared by the port's entry points."""

from __future__ import annotations

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def resolve_device(device="cuda") -> torch.device:
    """The entry points run on the card unless the caller asks for the CPU.
    Asking for CUDA without a card raises; nothing falls back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if dev.type == "cuda" and dev.index >= torch.cuda.device_count():
        raise RuntimeError(f"{dev} is not present: "
                           f"{torch.cuda.device_count()} cards are visible")
    return dev


def torch_dtype(name) -> torch.dtype:
    if isinstance(name, torch.dtype):
        return name
    try:
        return _DTYPES[str(name)]
    except KeyError:
        raise ValueError(f"unsupported dtype {name!r}") from None


def at_least_f32(t: torch.Tensor) -> torch.Tensor:
    """t in f32, or in its own dtype where that is wider (f64)."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def exact_f32(compute_dtype, device) -> bool:
    """Whether a run in `compute_dtype` on `device` keeps TF32 off: f32 on
    CUDA, where cuDNN runs f32 convolutions in TF32 (10 bits of mantissa)
    by default, so that f32 on the card means f32 as on the CPU."""
    return (torch_dtype(compute_dtype) == torch.float32
            and torch.device(device).type == "cuda")


def set_precision(compute_dtype, device) -> None:
    """Where `exact_f32`, turn TF32 off for cuDNN's convolutions and
    cuBLAS's products; else leave both settings as they are."""
    if exact_f32(compute_dtype, device):
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
