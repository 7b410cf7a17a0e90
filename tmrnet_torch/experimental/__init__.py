"""The fused-bottleneck kernel of the folded ResNet backbone."""
