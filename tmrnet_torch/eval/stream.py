"""Live-stream inference: a batch of independent video streams, one frame a
step each.

Port of `tmrnet_tpu/eval/stream.py` (StreamState :36-50,
StreamingInference :53-248). Per stream the state holds a `seq`-frame
ring of backbone features for each trunk (extractor and TMR), a
`window`-slot ring of LFB features (the stream's bank, most recent first)
and a frame count, all on the device. A step runs both backbones on the
new frames only, the two LSTMs over their rings, gathers the memory window
(before any previous clip exists a slot repeats the earliest available
row, and a stream with no previous clip reads its own feature: the clamped
windows of `memory_window_rows`) and scores through `TMRNet.head`.
Outputs equal `VideoInference.run_video`'s from the stream's first full
clip (frame seq-1) on; earlier steps report valid=False. A step returns a
new state; the state passed in is left as it was.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Tuple

import numpy as np
import torch

from tmrnet_torch.config import ExperimentConfig
from tmrnet_torch.data.device_feed import DevicePrep
from tmrnet_torch.device import resolve_device, torch_dtype
from tmrnet_torch.eval.infer import load_weights


@dataclasses.dataclass
class StreamState:
    """The device-resident carry of B streams."""

    ext_ring: torch.Tensor   # (B, seq, F) extractor backbone features
    tmr_ring: torch.Tensor   # (B, seq, F) TMR-trunk backbone features
    bank_ring: torch.Tensor  # (B, window, hidden) LFB features, newest first
    count: torch.Tensor      # (B,) int32 frames seen


class StreamingInference:
    """state_dict: TMR model weights (head tmr or nl_only);
    extractor_state_dict: the extractor's (head lfb); fused_kernel as in
    `ClipInference`."""

    def __init__(self, cfg: ExperimentConfig,
                 state_dict: Mapping[str, torch.Tensor],
                 extractor_state_dict: Mapping[str, torch.Tensor],
                 device="cuda", fused_kernel: str = "block"):
        self.device = resolve_device(device)
        if cfg.model.head not in ("tmr", "nl_only"):
            raise ValueError(f"head {cfg.model.head!r}: streams score a "
                             f"memory head (tmr or nl_only)")
        self.cfg = cfg
        self.seq = cfg.data.sequence_length
        self.window = cfg.memory.window
        self.hidden = cfg.model.hidden_dim
        self.cdt = torch_dtype(cfg.model.compute_dtype)
        self.extractor = load_weights(
            dataclasses.replace(cfg.model, head="lfb"), extractor_state_dict,
            self.device, fused_kernel)
        self.model = load_weights(cfg.model, state_dict, self.device,
                                  fused_kernel)
        self.feature_dim = self.model.backbone.num_features
        self.prep = DevicePrep(cfg.data, self.cdt, self.device)
        self._all_active = {}

    def init_state(self, num_streams: int) -> StreamState:
        b, dev = num_streams, self.device
        ring = lambda n, f: torch.zeros((b, n, f), dtype=self.cdt, device=dev)
        return StreamState(
            ext_ring=ring(self.seq, self.feature_dim),
            tmr_ring=ring(self.seq, self.feature_dim),
            bank_ring=ring(self.window, self.hidden),
            count=torch.zeros((b,), dtype=torch.int32, device=dev))

    def _mask(self, mask) -> torch.Tensor:
        return torch.as_tensor(np.asarray(mask, bool)).to(self.device)

    @torch.inference_mode()
    def reset_streams(self, state: StreamState, mask) -> StreamState:
        """Slots where mask (B,) is True restart as fresh streams (rings
        and counts zero), so a finished stream's slot takes a new video
        without touching the others."""
        m = self._mask(mask)
        z = lambda t: torch.where(m.view(-1, *([1] * (t.dim() - 1))),
                                  torch.zeros_like(t), t)
        return StreamState(ext_ring=z(state.ext_ring),
                           tmr_ring=z(state.tmr_ring),
                           bank_ring=z(state.bank_ring), count=z(state.count))

    @torch.inference_mode()
    def step(self, state: StreamState, frames, active=None
             ) -> Tuple[StreamState, torch.Tensor, torch.Tensor, torch.Tensor]:
        """frames: (B, H, W, 3), uint8 or float, host or device (device
        frames are not copied). active: optional (B,) bool; slots marked
        False ignore their frame this step: state frozen bit for bit,
        valid False. Returns (state, preds (B,), probs (B, classes) f32,
        valid (B,)) on the device; valid is False until a stream has seen
        seq frames."""
        if not isinstance(frames, torch.Tensor):
            frames = torch.from_numpy(np.ascontiguousarray(frames))
        b = frames.shape[0]
        if active is None:      # all active: a cached mask, no copy a step
            act = self._all_active.get(b)
            if act is None:
                act = self._all_active[b] = torch.ones(
                    (b,), dtype=torch.bool, device=self.device)
        else:
            act = self._mask(active)
        x = self.prep(frames.to(self.device))
        a3 = act[:, None, None]

        def push(ring, feats):
            moved = torch.cat([ring[:, 1:], feats[:, None].to(ring.dtype)], 1)
            return torch.where(a3, moved, ring)

        ext_ring = push(state.ext_ring, self.extractor.backbone(x))
        tmr_ring = push(state.tmr_ring, self.model.backbone(x))
        _, (st_e, _) = self.extractor.encoder.lstm(ext_ring)   # LFB feature
        _, (st_t, _) = self.model.encoder.lstm(tmr_ring)       # St

        count = state.count + act.to(state.count.dtype)
        clips_seen = count - self.seq + 1
        # Slot k reads bank[k] while k < the previous clips available, else
        # the oldest of them; with none, the stream's own feature.
        bank = state.bank_ring
        valid_prev = torch.clamp(clips_seen - 1, min=0)
        oldest = torch.clamp(valid_prev - 1, min=0)
        k = torch.arange(self.window, device=self.device)
        idx = torch.minimum(k[None, :], oldest[:, None].long())
        memory = torch.gather(bank, 1, idx[:, :, None].expand(-1, -1, self.hidden))
        memory = torch.where((valid_prev > 0)[:, None, None], memory,
                             st_e[:, None, :].to(memory.dtype))
        logits = self.model.head(st_t, memory)

        has_clip = (clips_seen >= 1) & act
        pushed = torch.cat([st_e[:, None].to(bank.dtype), bank[:, :-1]], 1)
        bank_ring = torch.where(has_clip[:, None, None], pushed, bank)
        probs = torch.softmax(logits.float(), dim=-1)
        new = StreamState(ext_ring=ext_ring, tmr_ring=tmr_ring,
                          bank_ring=bank_ring, count=count)
        return new, probs.argmax(dim=-1), probs, has_clip
