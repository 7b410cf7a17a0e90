"""ResNet v1.5 backbone (the stride on the 3x3 conv), NHWC at the interface.

Port of `tmrnet_tpu/models/resnet.py:21-99`. Frames come in as (N, H, W, 3)
and activations stay in `channels_last` memory, so a block's input viewed as
NHWC is contiguous. Unfolded, every conv is followed by BatchNorm (eps
1e-5): in eval mode by default; with `train=True` with flax's training
semantics (`batch_norm`). Folded (BN pre-folded into the convs, `models/fold_bn.py`),
every stride-1 identity block runs as one fused-bottleneck kernel, the
role `tmrnet_tpu/experimental/fused_resnet.py::apply_fused_resnet` (:68-108)
plays in JAX; the stem and the strided/projection blocks stay on
`torch.nn.functional.conv2d`, as JAX leaves them to XLA. ResNet-50 has 12
such identity blocks. `kernel` picks the fused kernel as
`apply_fused_resnet(kernel=...)` does (:87-105): "block" sends every
identity block to `fused_bottleneck`; "tiled" sends those with C < 2048 to
`fused_bottleneck_tiled` (10 in ResNet-50) and the others (stage 4's 2) to
`fused_bottleneck`. The ops take the trunk's compute dtype: on the card bf16
runs the tensor-core kernels and f32 the FFMA ones (no TF32), as JAX folds
a trunk in either dtype.

`remat=True` recomputes each bottleneck in the backward pass, as JAX's
`nn.remat(Bottleneck)` does (:89-90): `torch.utils.checkpoint` keeps a
block's input and reruns its forward when its gradient is needed. The
stem and the pooling are not recomputed. BatchNorm in training updates
its running statistics in the first forward only: the recompute runs
under `_RECOMPUTE.active`, which `batch_norm` reads (thread-local, since
loader threads may run models too).

Names follow the flax tree: `conv1`, `bn1`, `layer{l}_{i}.conv1..3`,
`.bn1..3`, `.downsample_conv`, `.downsample_bn`.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Sequence

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from tmrnet_torch.experimental.fused_bottleneck import fused_bottleneck
from tmrnet_torch.experimental.fused_bottleneck_tiled import fused_bottleneck_tiled
from tmrnet_torch.device import at_least_f32
from tmrnet_torch.kernels.prepared import Prepared
from tmrnet_torch.parallel.mesh import current_shard

EXPANSION = 4
BN_EPS = 1e-5
# flax BatchNorm's momentum: running = 0.9 * running + 0.1 * batch.
BN_MOMENTUM = 0.9
FUSED_KERNELS = ("block", "tiled")
# Identity blocks this wide stay on the block kernel under kernel="tiled"
# (fused_resnet.py:91: the TPU's VMEM could not hold stage 4's weights twice).
TILED_MAX_C = 2048

# Set while torch.utils.checkpoint recomputes a block in the backward pass.
_RECOMPUTE = threading.local()


@contextlib.contextmanager
def _recomputing():
    previous = getattr(_RECOMPUTE, "active", False)
    _RECOMPUTE.active = True
    try:
        yield
    finally:
        _RECOMPUTE.active = previous


def _remat_contexts():
    """checkpoint's context_fn: nothing in the first forward, the
    recompute flag in the recomputation."""
    return contextlib.nullcontext(), _recomputing()


def check_fused_kernel(kernel: str) -> str:
    if kernel not in FUSED_KERNELS:
        raise ValueError(f"fused kernel {kernel!r}: want one of {FUSED_KERNELS}")
    return kernel


def conv(layer: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """The layer's conv in x's dtype, its weight and bias cast to it;
    grouped where the layer is (ResNeSt's split-attention conv)."""
    bias = None if layer.bias is None else layer.bias.to(x.dtype)
    return F.conv2d(x, layer.weight.to(x.dtype), bias, layer.stride,
                    layer.padding, layer.dilation, layer.groups)


def batch_norm(layer: nn.BatchNorm2d, x: torch.Tensor,
               train: bool = False) -> torch.Tensor:
    """Eval mode: BatchNorm over the running statistics, its parameters
    cast to x's dtype.

    train=True, flax's BatchNorm in training (`tmrnet_tpu/models/resnet.py`
    :38-41): x normalized by its batch mean and biased variance over N*H*W,
    computed in f32 (the f32 scale and bias applied before the one rounding
    to x's dtype), and the running statistics updated as 0.9 * running +
    0.1 * batch with the biased variance. `F.batch_norm` would write the
    unbiased variance, so it only fills scratch buffers (momentum 1: the
    batch mean and unbiased variance), and the update is made here, but
    not in a remat block's recomputation, which computes the same batch
    statistics a second time.

    In a data-parallel train step over several processes
    (`parallel/mesh.py::current_shard`) the statistics are the global
    batch's, as JAX's SPMD BatchNorm over a batch-sharded input takes them
    (`_GlobalBatchNorm`); over one rank the local statistics are the
    global ones, and the step is the one-process step bit for bit."""
    if not train:
        cast = lambda t: t.to(x.dtype)
        return F.batch_norm(x, cast(layer.running_mean),
                            cast(layer.running_var), cast(layer.weight),
                            cast(layer.bias), False, 0.0, BN_EPS)
    shard = current_shard()
    if shard is None or shard.world == 1:
        c = x.shape[1]
        n = x.numel() // c
        mean = torch.zeros(c, dtype=torch.promote_types(x.dtype,
                                                        torch.float32),
                           device=x.device)
        var = torch.zeros_like(mean)
        y = F.batch_norm(x, mean, var, layer.weight, layer.bias, True, 1.0,
                         BN_EPS)
        var = var * ((n - 1) / n)
    else:
        y, mean, var = _GlobalBatchNorm.apply(x, layer.weight, layer.bias,
                                              shard)
    if getattr(_RECOMPUTE, "active", False):
        return y
    with torch.no_grad():
        m = 1.0 - BN_MOMENTUM
        layer.running_mean.mul_(BN_MOMENTUM).add_(mean, alpha=m)
        layer.running_var.mul_(BN_MOMENTUM).add_(var, alpha=m)
        layer.num_batches_tracked.add_(1)
    return y


class _GlobalBatchNorm(torch.autograd.Function):
    """Train-mode BatchNorm over the global batch of which x is this rank's
    part (a shard of several ranks), its statistics and its input
    gradient's two per-channel reductions summed over the ranks
    (SyncBatchNorm's scheme, in an autograd Function whose backward makes
    its own collective).

    Forward: each rank's count, mean and sum of squared deviations (f32,
    or f64 for f64 input, `torch.var_mean`) go into its own row of a
    (world, 2C + 1) f64 buffer that one all-reduce sums, so that every
    rank holds every rank's; they combine into the global mean and biased
    variance (the parallel variance formula, without the cancellation of
    a summed sum of squares). Backward: dy's sum and dy * x_hat's sum over
    the rank's positions, all-reduced, give the input gradient
    w * rstd * (dy - sum(dy) / N - x_hat * sum(dy * x_hat) / N); the
    weight's and bias's gradients are the rank's own sums (the train state
    sums them over the ranks). Under remat the recomputation runs the
    forward's all-reduce again: every rank recomputes the same blocks in
    the same order, so the collectives pair up."""

    @staticmethod
    def forward(ctx, x, weight, bias, shard):
        c = x.shape[1]
        dims = [d for d in range(x.dim()) if d != 1]
        shape = [1] * x.dim()
        shape[1] = c
        n = x.numel() // c
        xf = at_least_f32(x)
        var_r, mean_r = torch.var_mean(xf, dim=dims, correction=0)
        rows = torch.zeros((shard.world, 2 * c + 1), dtype=torch.float64,
                           device=x.device)
        rows[shard.rank, :c] = mean_r.double()
        rows[shard.rank, c:2 * c] = var_r.double() * n
        rows[shard.rank, 2 * c] = n
        dist.all_reduce(rows, group=shard.group)
        means, m2s, counts = rows[:, :c], rows[:, c:2 * c], rows[:, 2 * c:]
        total = counts.sum()
        mean64 = (counts * means).sum(0) / total
        var64 = (m2s + counts * (means - mean64) ** 2).sum(0) / total
        mean, var = mean64.to(xf.dtype), var64.to(xf.dtype)
        rstd = torch.rsqrt(var + BN_EPS)
        y = (xf - mean.view(shape)) * (weight.to(xf.dtype) * rstd).view(shape)\
            + bias.to(xf.dtype).view(shape)
        # the count stays on the device: a host read would stall the
        # stream at every BatchNorm
        ctx.save_for_backward(x, weight, mean, rstd, total)
        ctx.group, ctx.dims, ctx.shape = shard.group, dims, shape
        ctx.mark_non_differentiable(mean, var)
        return y.to(x.dtype), mean, var

    @staticmethod
    def backward(ctx, gy, _mean, _var):
        x, weight, mean, rstd, total = ctx.saved_tensors
        dims, shape, c = ctx.dims, ctx.shape, x.shape[1]
        g = at_least_f32(gy)
        xhat = (at_least_f32(x) - mean.view(shape)) * rstd.view(shape)
        sum_g = g.sum(dims)
        sum_gx = (g * xhat).sum(dims)
        both = torch.cat([sum_g, sum_gx])
        dist.all_reduce(both, group=ctx.group)
        n = total.to(g.dtype)
        gx = (weight.to(g.dtype) * rstd).view(shape) * (
            g - (both[:c] / n).view(shape) - xhat * (both[c:] / n).view(shape))
        return gx.to(x.dtype), sum_gx.to(weight.dtype), \
            sum_g.to(weight.dtype), None


class Bottleneck(nn.Module):
    def __init__(self, in_feats: int, planes: int, strides: int = 1,
                 folded: bool = False, kernel: str = "block"):
        super().__init__()
        out_feats = planes * EXPANSION
        self.strides = strides
        self.folded = folded
        self.kernel = check_fused_kernel(kernel)
        mk = lambda i, o, k, s, p: nn.Conv2d(i, o, k, s, p, bias=folded)
        self.conv1 = mk(in_feats, planes, 1, 1, 0)
        self.conv2 = mk(planes, planes, 3, strides, 1)
        self.conv3 = mk(planes, out_feats, 1, 1, 0)
        self.projection = strides != 1 or in_feats != out_feats
        if self.projection:
            self.downsample_conv = mk(in_feats, out_feats, 1, strides, 0)
        if not folded:
            self.bn1 = nn.BatchNorm2d(planes, eps=BN_EPS)
            self.bn2 = nn.BatchNorm2d(planes, eps=BN_EPS)
            self.bn3 = nn.BatchNorm2d(out_feats, eps=BN_EPS)
            if self.projection:
                self.downsample_bn = nn.BatchNorm2d(out_feats, eps=BN_EPS)
        self._prepared = {}     # the fused kernel's copies, by dtype

    def fused_weights(self, dtype: torch.dtype):
        """(w1 (C, P), b1, w2 (3, 3, P, P), b2, w3 (P, C), b3) for the
        fused kernel: weights in `dtype`, biases in f32; copies made once
        and made again only when a parameter changed (`kernels.prepared`)."""
        def make(*params):
            w = lambda t: t.permute(2, 3, 1, 0).to(dtype).contiguous()
            w1, b1, w2, b2, w3, b3 = params
            return (w(w1)[0, 0], b1.float().contiguous(), w(w2),
                    b2.float().contiguous(), w(w3)[0, 0],
                    b3.float().contiguous())

        params = [t for layer in (self.conv1, self.conv2, self.conv3)
                  for t in (layer.weight, layer.bias)]
        prepared = self._prepared.setdefault(dtype, Prepared())
        return prepared.get(params, make)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        """x: (N, C, H, W) in channels_last memory; train: BatchNorm on the
        batch's statistics, updating the running ones (unfolded only)."""
        if self.folded and not self.projection:
            xh = x.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)
            op = (fused_bottleneck_tiled
                  if self.kernel == "tiled" and xh.shape[-1] < TILED_MAX_C
                  else fused_bottleneck)
            y = op(xh, *self.fused_weights(x.dtype))
            return y.permute(0, 3, 1, 2)
        bn = (lambda name, y: y) if self.folded else (
            lambda name, y: batch_norm(getattr(self, name), y, train))
        y = torch.relu(bn("bn1", conv(self.conv1, x)))
        y = torch.relu(bn("bn2", conv(self.conv2, y)))
        y = bn("bn3", conv(self.conv3, y))
        residual = x
        if self.projection:
            residual = bn("downsample_bn", conv(self.downsample_conv, x))
        return torch.relu(y + residual)


class ResNet(nn.Module):
    def __init__(self, stage_sizes: Sequence[int] = (3, 4, 6, 3),
                 width: int = 64, folded: bool = False,
                 compute_dtype: torch.dtype = torch.float32,
                 kernel: str = "block", remat: bool = False):
        super().__init__()
        self.stage_sizes = tuple(stage_sizes)
        self.folded = folded
        self.remat = remat
        self.compute_dtype = compute_dtype
        self.conv1 = nn.Conv2d(3, width, 7, 2, 3, bias=folded)
        if not folded:
            self.bn1 = nn.BatchNorm2d(width, eps=BN_EPS)
        in_feats = width
        for l, n_blocks in enumerate(self.stage_sizes):
            planes = width * 2 ** l
            for i in range(n_blocks):
                strides = 2 if l > 0 and i == 0 else 1
                self.add_module(f"layer{l + 1}_{i}", Bottleneck(
                    in_feats, planes, strides, folded, kernel))
                in_feats = planes * EXPANSION
        self.num_features = in_feats

    def activation_elements(self, h: int, w: int) -> int:
        """Elements of the largest activation one h x w frame makes: the
        stem's conv output or a stage's output (each stride 2 rounds up)."""
        half = lambda n: -(-n // 2)
        h, w = half(h), half(w)
        most = h * w * self.conv1.out_channels
        h, w = half(h), half(w)                       # the max-pool
        for l in range(len(self.stage_sizes)):
            if l:
                h, w = half(h), half(w)
            most = max(most, h * w * self.conv1.out_channels * 2 ** l
                       * EXPANSION)
        return most

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        """x: (N, H, W, 3) -> (N, num_features); train as in
        `Bottleneck.forward` (a folded backbone is for inference only);
        under remat, while autograd records, each block is recomputed in
        the backward pass."""
        if train and self.folded:
            raise ValueError("a folded backbone is for inference only; "
                             "train the unfolded one")
        x = x.to(self.compute_dtype).permute(0, 3, 1, 2)
        x = x.contiguous(memory_format=torch.channels_last)
        x = conv(self.conv1, x)
        if not self.folded:
            x = batch_norm(self.bn1, x, train)
        x = F.max_pool2d(torch.relu(x), 3, 2, 1)
        remat = self.remat and torch.is_grad_enabled()
        for l, n_blocks in enumerate(self.stage_sizes):
            for i in range(n_blocks):
                block = getattr(self, f"layer{l + 1}_{i}")
                if remat:
                    x = checkpoint(block, x, train, use_reentrant=False,
                                   context_fn=_remat_contexts)
                else:
                    x = block(x, train)
        return x.mean(dim=(2, 3))
