"""Unidirectional LSTM, weight-compatible with torch.nn.LSTM.

Port of `tmrnet_tpu/models/lstm.py:20-69`: one matmul computes the input
projection of every step, then a Python loop over T runs the recurrence in
the compute dtype (h and c stay in it, as in JAX), from zeros or from a
given `initial_state`. Gates are ordered i, f, g, o; parameters are named
as in the flax module (weight_ih (4H, In), weight_hh (4H, H), bias_ih,
bias_hh).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn


class LSTM(nn.Module):
    def __init__(self, input_dim: int, hidden_dim: int,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        h = hidden_dim
        self.hidden_dim = h
        self.compute_dtype = compute_dtype
        self.weight_ih = nn.Parameter(torch.empty(4 * h, input_dim))
        self.weight_hh = nn.Parameter(torch.empty(4 * h, h))
        self.bias_ih = nn.Parameter(torch.empty(4 * h))
        self.bias_hh = nn.Parameter(torch.empty(4 * h))

    def forward(self, x: torch.Tensor,
                initial_state: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
        """x: (B, T, In); initial_state: (h0, c0), each (B, H), zeros if
        None -> (outputs (B, T, H), (h, c) after the last step)."""
        cdt = self.compute_dtype
        b, t, _ = x.shape
        x_proj = torch.einsum("btd,gd->btg", x.to(cdt), self.weight_ih.to(cdt))
        x_proj = x_proj + (self.bias_ih + self.bias_hh).to(cdt)
        w_hh_t = self.weight_hh.to(cdt).t()
        if initial_state is None:
            h = torch.zeros(b, self.hidden_dim, dtype=cdt, device=x.device)
            c = torch.zeros_like(h)
        else:
            h, c = (s.to(cdt) for s in initial_state)
        ys = []
        for step in range(t):
            gates = x_proj[:, step] + h @ w_hh_t
            i, f, g, o = gates.chunk(4, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            ys.append(h)
        return torch.stack(ys, dim=1), (h, c)
