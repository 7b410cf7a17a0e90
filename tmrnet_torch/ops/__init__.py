"""Hand-written Hopper kernels of the TMRNet head, each with its plain
PyTorch version: `nl_attention` (Triton) and `time_conv` (CUDA C++)."""
