"""Kernel build, loading and launch counts (see `build.py`); the main
path's kernels as `torch.library` ops (see `library.py`)."""

from tmrnet_torch.kernels.build import LAUNCHES, build_all, reset_launches  # noqa: F401
