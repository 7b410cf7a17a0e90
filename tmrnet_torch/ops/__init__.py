"""Hand-written Hopper kernels outside the backbone, each with its plain
PyTorch version: `nl_attention`, `time_conv` and `int8_matmul` (CUDA C++),
and the int8 quantizers."""

from tmrnet_torch.ops.nl_attention import nl_attention  # noqa: F401
from tmrnet_torch.ops.quant import (  # noqa: F401
    int8_matmul,
    quantize_per_channel,
    quantize_per_tensor,
    quantized_matmul,
)
from tmrnet_torch.ops.time_conv import time_conv  # noqa: F401
