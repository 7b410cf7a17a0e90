"""Build and load the CUDA C++ kernels under `tmrnet_torch/csrc/`.

Each `csrc/*.cu` file is compiled by `nvcc` for `sm_90a` into a shared
library with a plain C interface and loaded with `ctypes` (no PyTorch headers,
so a build takes seconds). Builds go at first use into
`build/tmrnet_torch_kernels/` at the repository root; a library's file name
carries a hash of its source and of the shared headers, so an edited source
is rebuilt. `build_all()` starts one `nvcc` per source, all at once.

Processes that share the checkout (ranks of a data-parallel run) build a
library once: its build holds a lock file beside it, and a process that
finds the lock held waits for it and then loads what the other built.

Every C entry point returns `cudaGetLastError()` after its launch;
`check()` raises when that is not 0 (cudaSuccess).

`LAUNCHES` counts kernel launches by name: each wrapper adds one where it
launches its kernel, and nowhere else. The engines' kernels (the four
bf16 ones and their f32 counterparts `time_conv_f32`,
`fused_bottleneck_f32` and `fused_bottleneck_tiled_f32`, the last two
one kernel of `csrc/fused_bottleneck_f32.cu` counted by wrapper), whose
in-process shards run on several cards, count through `count`, which also
adds one to `LAUNCHES_BY_DEVICE[(name, card index)]`.
"""

from __future__ import annotations

import collections
import ctypes
import fcntl
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tmrnet_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
SOURCES = ("nl_attention", "time_conv", "time_conv_f32", "fused_bottleneck",
           "fused_bottleneck_f32", "fused_bottleneck_tiled", "int8_matmul",
           "int8_conv3x3")

LAUNCHES: collections.Counter = collections.Counter()
LAUNCHES_BY_DEVICE: collections.Counter = collections.Counter()

_libs: Dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    LAUNCHES.clear()
    LAUNCHES_BY_DEVICE.clear()


def count(name: str, device) -> None:
    """One launch of kernel `name` on `device` (a CUDA device)."""
    LAUNCHES[name] += 1
    LAUNCHES_BY_DEVICE[(name, device.index)] += 1


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(f"nvcc not found at {path}; set CUDA_HOME")
    return str(path)


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for f in [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def _start_build(name: str):
    """Start nvcc for one source unless its library is already built;
    returns (final path, tmp path, process or None, lock or None). The
    lock (held until the library is in place) makes another process that
    builds the same library wait, then find it built."""
    out = _lib_path(name)
    if out.exists():
        return out, None, None, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lock = open(out.with_suffix(".lock"), "w")
    fcntl.flock(lock, fcntl.LOCK_EX)
    if out.exists():
        lock.close()
        return out, None, None, None
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return out, tmp, proc, lock


def build_all(names: Iterable[str] = SOURCES) -> Dict[str, ctypes.CDLL]:
    """Build (in parallel) and load every named kernel library."""
    pending = {n: _start_build(n) for n in names if n not in _libs}
    errors = []
    for name, (out, tmp, proc, lock) in pending.items():
        if proc is not None:
            log, _ = proc.communicate()
            if proc.returncode == 0:
                os.replace(tmp, out)
            lock.close()
            if proc.returncode != 0:
                errors.append(f"nvcc failed for {name}.cu:\n{log}")
                continue
        _libs[name] = ctypes.CDLL(str(out))
    if errors:
        raise RuntimeError("\n".join(errors))
    return dict(_libs)


def library(name: str) -> ctypes.CDLL:
    lib = _libs.get(name)
    if lib is None:
        lib = build_all([name])[name]
    return lib


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_ptr(device) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
