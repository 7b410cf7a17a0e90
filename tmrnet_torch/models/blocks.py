"""TMRNet temporal-memory blocks: NLBlock and the multi-scale TimeConv.

Port of `tmrnet_tpu/models/blocks.py:21-92` (reference
`NLBlock_MutiConv6_3.py:10-79`). Parameters stay in f32 (flax's
param_dtype) and are cast to the compute dtype at use, as flax does. Module
and parameter names follow the flax tree, so the weight bridge
(`models/convert.py`) only transposes layouts. Inference only: the dropout
layers of the flax blocks are identities here.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from tmrnet_torch.kernels.prepared import Prepared
from tmrnet_torch.ops.nl_attention import nl_attention
from tmrnet_torch.ops.time_conv import time_conv

# flax LayerNorm's default epsilon (torch's default is 1e-5).
LAYER_NORM_EPS = 1e-6


def dense(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """flax Dense in x's dtype: kernel and bias cast to it."""
    return F.linear(x, layer.weight.to(x.dtype), layer.bias.to(x.dtype))


class NLBlock(nn.Module):
    """Non-local read of the memory window Lt by the clip embedding St, then
    LayerNorm (f32 statistics, eps 1e-6), ReLU, a linear layer and a residual
    add. The attention always runs through `ops.nl_attention`."""

    def __init__(self, feature_dim: int = 512,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        f = feature_dim
        self.feature_dim = f
        self.compute_dtype = compute_dtype
        self.query = nn.Linear(f, f)
        self.key = nn.Linear(f, f)
        self.value = nn.Linear(f, f)
        self.out = nn.Linear(f, f)
        self.layer_norm = nn.LayerNorm(f, eps=LAYER_NORM_EPS)

    def forward(self, st: torch.Tensor, lt: torch.Tensor) -> torch.Tensor:
        """st: (B, F); lt: (B, W, F) -> (B, F)."""
        cdt = self.compute_dtype
        q = dense(self.query, st.to(cdt))
        k = dense(self.key, lt.to(cdt)).contiguous()
        v = dense(self.value, lt.to(cdt)).contiguous()
        attended = nl_attention(q.contiguous(), k, v)
        out = F.layer_norm(attended.float(), (self.feature_dim,),
                           self.layer_norm.weight.float(),
                           self.layer_norm.bias.float(),
                           LAYER_NORM_EPS).to(cdt)
        out = dense(self.out, torch.relu(out))
        return st + out.to(st.dtype)


class TimeConv(nn.Module):
    """Elementwise max of Conv1d k=3/5/7 (SAME), a causal 2-max and the
    identity over the window. Always runs through `ops.time_conv`; the
    weights are handed over in the flax layout (k, Cin, Cout), in the
    compute dtype, as copies made once and made again only when a parameter
    changed (a `load_state_dict` or another in-place edit, a `.to()`). The
    copies carry no gradient: the module is for inference."""

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
        (`kernels.prepared`) from the six parameters."""
        params = [p for conv in (self.conv_k3, self.conv_k5, self.conv_k7)
                  for p in (conv.weight, conv.bias)]

        def make(*params):
            args = []
            for weight, bias in zip(params[::2], params[1::2]):
                args.append(weight.permute(2, 1, 0).to(self.compute_dtype)
                            .contiguous())
                args.append(bias.float().contiguous())
            return tuple(args)

        return self._prepared.get(params, make)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, W, F) -> (B, W, F)."""
        cdt = self.compute_dtype
        return time_conv(x.to(cdt).contiguous(), *self.kernel_args()).to(x.dtype)
