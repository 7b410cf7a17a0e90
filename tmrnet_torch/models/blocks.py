"""TMRNet temporal-memory blocks: NLBlock and the multi-scale TimeConv.

Port of `tmrnet_tpu/models/blocks.py:21-92` (reference
`NLBlock_MutiConv6_3.py:10-79`). Parameters stay in f32 (flax's
param_dtype) and are cast to the compute dtype at use, as flax does. Module
and parameter names follow the flax tree, so the weight bridge
(`models/convert.py`) only transposes layouts. The dropout of the flax
NLBlock acts with `train=True` (`dropout`); the head's two ops are
autograd Functions (`ops/`), so both blocks train.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from tmrnet_torch.kernels.prepared import Prepared
from tmrnet_torch.ops.nl_attention import nl_attention
from tmrnet_torch.ops.time_conv import time_conv
from tmrnet_torch.parallel.mesh import current_shard
from tmrnet_torch.parallel.tensor import (copy_in, gather, shard_of, split,
                                          sum_partials)

# flax LayerNorm's default epsilon (torch's default is 1e-5).
LAYER_NORM_EPS = 1e-6


def dense(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """flax Dense in x's dtype: kernel and bias cast to it."""
    return F.linear(x, layer.weight.to(x.dtype), layer.bias.to(x.dtype))


def column_linear(layer: nn.Linear, x: torch.Tensor,
                  keep_slice: bool = False) -> torch.Tensor:
    """`dense`, or where the rules slice the layer's outputs over the model
    group (`parallel/tensor.py`): this rank's output columns, from x whole
    and the rank's slice of the bias, then gathered over the group (kept
    as the slice under keep_slice, for a row-parallel layer after it)."""
    shard = shard_of(layer.weight)
    if shard is None:
        return dense(layer, x)
    y = F.linear(copy_in(x, shard), layer.weight.to(x.dtype),
                 split(layer.bias, shard).to(x.dtype))
    return y if keep_slice else gather(y, shard)


def row_linear(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """`dense`, or where the rules slice the layer's inputs over the model
    group: x is then the rank's slice of them (the kept slice of the
    column-parallel layer before it, which the rules slice where they
    slice this one), and the partial product is summed over the group,
    then the bias added once."""
    shard = shard_of(layer.weight)
    if shard is None:
        return dense(layer, x)
    y = sum_partials(F.linear(x, layer.weight.to(x.dtype)), shard)
    return y + layer.bias.to(x.dtype)


def dropout(x: torch.Tensor, rate: float, train: bool,
            generator: Optional[torch.Generator] = None,
            columns: Optional[Tuple[int, int, int]] = None) -> torch.Tensor:
    """flax nn.Dropout: in training, each element kept with probability
    1 - rate (a Bernoulli mask drawn from `generator`, on x's device) and
    scaled by 1 / (1 - rate); x itself outside training or at rate 0.
    In a data-parallel train step (`parallel/mesh.py::current_shard`), x
    is this rank's rows [lo, hi) of the global batch: the mask is drawn
    at the global batch's shape and its rows [lo, hi) kept, so that a rank
    masks what a one-process step over the global batch masks there.
    columns (lo, hi, whole): x holds the columns [lo, hi) of a last axis
    of `whole` (a model group's slice): the mask is drawn at the whole
    width and those columns kept."""
    if not train or rate == 0.0:
        return x
    if rate >= 1.0:
        return torch.zeros_like(x)
    keep = 1.0 - rate
    shard = current_shard()
    shape = list(x.shape)
    if columns is not None:
        shape[-1] = columns[2]
    if shard is not None:
        if x.shape[0] != shard.hi - shard.lo:
            raise ValueError(f"dropout over {x.shape[0]} rows in a shard of "
                             f"{shard.hi - shard.lo}")
        shape[0] = shard.size
    mask = torch.empty(shape, device=x.device).bernoulli_(
        keep, generator=generator)
    if shard is not None:
        mask = mask[shard.lo:shard.hi]
    if columns is not None:
        mask = mask[..., columns[0]:columns[1]]
    return torch.where(mask.bool(), x / keep, torch.zeros((), dtype=x.dtype,
                                                          device=x.device))


class NLBlock(nn.Module):
    """Non-local read of the memory window Lt by the clip embedding St, then
    LayerNorm (f32 statistics, eps 1e-6), ReLU, a linear layer and a residual
    add. The attention always runs through `ops.nl_attention`. Under
    tensor parallelism the four projections are column-parallel
    (`column_linear`): q, k and v are gathered over the model group and
    the attention runs whole on every rank (its 1/sqrt(F) the whole F's);
    `out` is gathered before the residual."""

    def __init__(self, feature_dim: int = 512,
                 compute_dtype: torch.dtype = torch.float32,
                 dropout: float = 0.2):
        super().__init__()
        f = feature_dim
        self.feature_dim = f
        self.compute_dtype = compute_dtype
        self.dropout = dropout
        self.query = nn.Linear(f, f)
        self.key = nn.Linear(f, f)
        self.value = nn.Linear(f, f)
        self.out = nn.Linear(f, f)
        self.layer_norm = nn.LayerNorm(f, eps=LAYER_NORM_EPS)

    def forward(self, st: torch.Tensor, lt: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """st: (B, F); lt: (B, W, F) -> (B, F); train: dropout after the
        output layer, its mask from `generator`."""
        cdt = self.compute_dtype
        q = column_linear(self.query, st.to(cdt))
        k = column_linear(self.key, lt.to(cdt)).contiguous()
        v = column_linear(self.value, lt.to(cdt)).contiguous()
        attended = nl_attention(q.contiguous(), k, v)
        out = F.layer_norm(attended.float(), (self.feature_dim,),
                           self.layer_norm.weight.float(),
                           self.layer_norm.bias.float(),
                           LAYER_NORM_EPS).to(cdt)
        out = column_linear(self.out, torch.relu(out))
        out = dropout(out, self.dropout, train, generator)
        return st + out.to(st.dtype)


class TimeConv(nn.Module):
    """Elementwise max of Conv1d k=3/5/7 (SAME), a causal 2-max and the
    identity over the window. Always runs through `ops.time_conv`; the
    kernel gets the weights in the flax layout (k, Cin, Cout), in the
    compute dtype, as copies made once and made again only when a parameter
    changed (a `load_state_dict`, an optimizer's step or another in-place
    edit, a `.to()`). The copies carry no gradient; the parameters go to
    `time_conv` beside them, so its backward reaches them. Under tensor
    parallelism each rank holds the output channels [c0, c0 + C / M) of
    the three convolutions (`parallel/tensor.py`): the kernel computes
    them over the whole window and its identity and causal-max branches
    read x's channels from c0 (`ops.time_conv`'s column slice); the
    slices are gathered over the model group."""

    def __init__(self, feature_dim: int = 512,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        f = feature_dim
        self.compute_dtype = compute_dtype
        self.conv_k3 = nn.Conv1d(f, f, 3, padding=1)
        self.conv_k5 = nn.Conv1d(f, f, 5, padding=2)
        self.conv_k7 = nn.Conv1d(f, f, 7, padding=3)
        self._prepared = Prepared()

    def kernel_args(self):
        """(w3, b3, w5, b5, w7, b7) as `ops.time_conv` takes them, prepared
        (`kernels.prepared`) from the six parameters (a bias's slice where
        the weights are sliced)."""
        params = [p for conv in (self.conv_k3, self.conv_k5, self.conv_k7)
                  for p in (conv.weight, conv.bias)]
        shard = shard_of(self.conv_k3.weight)

        def make(*params):
            args = []
            for weight, bias in zip(params[::2], params[1::2]):
                args.append(weight.permute(2, 1, 0).to(self.compute_dtype)
                            .contiguous())
                if shard is not None:
                    lo, hi = shard.bounds(bias.shape[0])
                    bias = bias[lo:hi]
                args.append(bias.float().contiguous())
            return tuple(args)

        return self._prepared.get(params, make)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, W, F) -> (B, W, F); with grad disabled the kernel reads
        the prepared copies alone (an export holds those, not the
        parameters)."""
        xc = x.to(self.compute_dtype).contiguous()
        shard = shard_of(self.conv_k3.weight)
        c0 = 0 if shard is None else shard.bounds(xc.shape[-1])[0]
        if not torch.is_grad_enabled():
            out = time_conv(xc, *self.kernel_args(), c0=c0)
        else:
            if shard is not None:
                xc = copy_in(xc, shard)
            weights = [p for conv in (self.conv_k3, self.conv_k5,
                                      self.conv_k7)
                       for p in (conv.weight.permute(2, 1, 0),
                                 conv.bias if shard is None
                                 else split(conv.bias, shard))]
            out = time_conv(xc, *weights, prepared=self.kernel_args(), c0=c0)
        return (out if shard is None else gather(out, shard)).to(x.dtype)
