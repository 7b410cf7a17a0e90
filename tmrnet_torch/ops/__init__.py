"""Hand-written Hopper kernels outside the backbone, each with its plain
PyTorch version: `nl_attention`, `time_conv` and `int8_matmul` (CUDA C++),
and the int8 quantizers.

Importing this package registers the main path's kernels as the
`torch.library` ops `torch.ops.tmrnet.*` (`kernels/library.py`), the
backbone's two among them, which a loaded export needs; `time_conv` takes
bf16 or f32 (`csrc/time_conv.cu` or `csrc/time_conv_f32.cu`)."""

from tmrnet_torch.experimental.fused_bottleneck import fused_bottleneck  # noqa: F401
from tmrnet_torch.experimental.fused_bottleneck_tiled import (  # noqa: F401
    fused_bottleneck_tiled,
)
from tmrnet_torch.ops.nl_attention import nl_attention  # noqa: F401
from tmrnet_torch.ops.quant import (  # noqa: F401
    int8_matmul,
    quantize_per_channel,
    quantize_per_tensor,
    quantized_matmul,
)
from tmrnet_torch.ops.time_conv import time_conv  # noqa: F401
