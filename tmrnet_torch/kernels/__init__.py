"""Kernel build, loading and launch counts (see `build.py`)."""

from tmrnet_torch.kernels.build import LAUNCHES, build_all, reset_launches  # noqa: F401
