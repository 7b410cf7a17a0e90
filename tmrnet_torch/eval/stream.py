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
new state; the state passed in is left as it was. `step` does the host's
part (frames to the card, the active mask, inference mode) and calls
`_step_impl`, which takes tensors on the card only, as JAX's does
(`tmrnet_tpu/eval/stream.py:147`): `eval/saved.py::export_stream`
exports it. `reset_state` is the slot reset, weight-free.

`StreamingInference(devices=[...])`, JAX's `StreamingInference(mesh=)`
(:53-112: the B axis sharded over the data axis, the weights replicated)
in one process over local cards: the B slots split into contiguous
groups, one a listed device, each group's rings and counts on its device
(`ShardedStreamState`), a one-device engine a distinct device (a repeated
device shares it). A step copies every group's frames and mask to its
device, launches every group's step before it waits on any, and gathers
(preds, probs, valid) in slot order on the first device; B must divide
over the devices.
"""

from __future__ import annotations

import dataclasses
from typing import List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from tmrnet_torch.config import ExperimentConfig
from tmrnet_torch.data.device_feed import DevicePrep
from tmrnet_torch.device import torch_dtype
from tmrnet_torch.eval.infer import (_engine_device, load_weights,
                                     on_device, replicas, shard_devices)


@dataclasses.dataclass
class StreamState:
    """The device-resident carry of B streams."""

    ext_ring: torch.Tensor   # (B, seq, F) extractor backbone features
    tmr_ring: torch.Tensor   # (B, seq, F) TMR-trunk backbone features
    bank_ring: torch.Tensor  # (B, window, hidden) LFB features, newest first
    count: torch.Tensor      # (B,) int32 frames seen


@dataclasses.dataclass
class ShardedStreamState:
    """The carry of B streams in contiguous groups, one a device; the
    fields read as the whole (B, ...) tensors, gathered on the first
    group's device (what `eval/serve.py` checkpoints)."""

    groups: List[StreamState]

    def _whole(self, name: str) -> torch.Tensor:
        first = self.groups[0].count.device
        return torch.cat([getattr(g, name).to(first) for g in self.groups])

    ext_ring = property(lambda self: self._whole("ext_ring"))
    tmr_ring = property(lambda self: self._whole("tmr_ring"))
    bank_ring = property(lambda self: self._whole("bank_ring"))
    count = property(lambda self: self._whole("count"))


def reset_state(state: StreamState, mask: torch.Tensor) -> StreamState:
    """The state with the slots where mask (B,) bool is True zeroed: rings
    and counts, a fresh stream each."""
    z = lambda t: torch.where(mask.view(-1, *([1] * (t.dim() - 1))),
                              torch.zeros_like(t), t)
    return StreamState(ext_ring=z(state.ext_ring), tmr_ring=z(state.tmr_ring),
                       bank_ring=z(state.bank_ring), count=z(state.count))


class StreamingInference:
    """state_dict: TMR model weights (head tmr or nl_only);
    extractor_state_dict: the extractor's (head lfb); fused_kernel,
    mesh and devices as in `ClipInference` (devices: the slots split into
    contiguous groups, one a device). TF32 stays as the caller set it, as
    in `ClipInference`."""

    def __init__(self, cfg: ExperimentConfig,
                 state_dict: Mapping[str, torch.Tensor],
                 extractor_state_dict: Mapping[str, torch.Tensor],
                 device="cuda", fused_kernel: str = "block", mesh=None,
                 devices: Optional[Sequence] = None):
        devices = shard_devices(devices, mesh, "StreamingInference")
        if devices:
            device = devices[0]
        self.device = _engine_device(mesh, device, "StreamingInference")
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
        # The groups: (device, the one-device engine there), one a listed
        # device.
        self.groups = None
        if devices and len(devices) > 1:
            self.groups = replicas(devices, (self,), lambda d: (
                StreamingInference(cfg, state_dict, extractor_state_dict,
                                   device=d, fused_kernel=fused_kernel),))

    def init_state(self, num_streams: int):
        """Zero rings and counts for `num_streams` slots; over several
        devices a `ShardedStreamState`, whose slot count must divide over
        them (JAX: "B must divide by the data-axis size")."""
        if self.groups is not None:
            n = len(self.groups)
            if num_streams % n:
                raise ValueError(f"{num_streams} streams do not divide over "
                                 f"the {n} devices")
            return ShardedStreamState([eng._zero_state(num_streams // n)
                                       for _, eng in self.groups])
        return self._zero_state(num_streams)

    def _zero_state(self, num_streams: int) -> StreamState:
        b, dev = num_streams, self.device
        ring = lambda n, f: torch.zeros((b, n, f), dtype=self.cdt, device=dev)
        return StreamState(
            ext_ring=ring(self.seq, self.feature_dim),
            tmr_ring=ring(self.seq, self.feature_dim),
            bank_ring=ring(self.window, self.hidden),
            count=torch.zeros((b,), dtype=torch.int32, device=dev))

    def _mask(self, mask) -> torch.Tensor:
        return torch.as_tensor(np.asarray(mask, bool)).to(self.device)

    def _group_states(self, state) -> List[StreamState]:
        """The groups' states of `state`: a ShardedStreamState's own, or a
        whole StreamState (e.g. restored by `eval/serve.py`) cut into the
        groups and moved to their devices."""
        if isinstance(state, ShardedStreamState):
            if len(state.groups) != len(self.groups):
                raise ValueError(f"a state of {len(state.groups)} groups "
                                 f"for {len(self.groups)} devices")
            return state.groups
        if state.count.shape[0] % len(self.groups):
            raise ValueError(f"{state.count.shape[0]} streams do not divide "
                             f"over the {len(self.groups)} devices")
        cut = [torch.tensor_split(t, len(self.groups)) for t in (
            state.ext_ring, state.tmr_ring, state.bank_ring, state.count)]
        return [StreamState(*(c[i].to(d) for c in cut))
                for i, (d, _) in enumerate(self.groups)]

    @staticmethod
    def _cut(x, n: int) -> list:
        """Host or device rows (B, ...) in n contiguous groups."""
        if isinstance(x, torch.Tensor):
            return list(torch.tensor_split(x, n))
        return np.array_split(np.asarray(x), n)

    @torch.inference_mode()
    def reset_streams(self, state, mask):
        """Slots where mask (B,) is True restart as fresh streams (rings
        and counts zero), so a finished stream's slot takes a new video
        without touching the others; over several devices each group on
        its own."""
        if self.groups is not None:
            groups = self._group_states(state)
            masks = self._cut(np.asarray(mask, bool), len(groups))
            return ShardedStreamState([
                reset_state(g, eng._mask(m))
                for g, (_, eng), m in zip(groups, self.groups, masks)])
        return reset_state(state, self._mask(mask))

    @torch.inference_mode()
    def step(self, state: StreamState, frames, active=None
             ) -> Tuple[StreamState, torch.Tensor, torch.Tensor, torch.Tensor]:
        """frames: (B, H, W, 3), uint8 or float, host or device (device
        frames are not copied). active: optional (B,) bool; slots marked
        False ignore their frame this step: state frozen bit for bit,
        valid False. Returns (state, preds (B,), probs (B, classes) f32,
        valid (B,)) on the device; valid is False until a stream has seen
        seq frames."""
        if self.groups is not None:
            return self._sharded_step(state, frames, active)
        frames, act = self._inputs(frames, active)
        return self._step_impl(state, frames, act)

    def _inputs(self, frames, active) -> Tuple[torch.Tensor, torch.Tensor]:
        """frames and the active mask on this engine's device."""
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
        return frames.to(self.device), act

    def _sharded_step(self, state, frames, active):
        """`step` over the groups: every group's frames and mask copied to
        its device before any step is launched, every step launched (under
        its device's guard) before any is waited on, the outputs gathered
        on the first device in slot order."""
        n = len(self.groups)
        groups = self._group_states(state)
        if frames.shape[0] != sum(g.count.shape[0] for g in groups):
            raise ValueError(f"{frames.shape[0]} frames for "
                             f"{sum(g.count.shape[0] for g in groups)} "
                             f"streams")
        acts = [None] * n if active is None else self._cut(
            np.asarray(active, bool), n)
        inputs = [eng._inputs(f, a) for (_, eng), f, a in zip(
            self.groups, self._cut(frames, n), acts)]
        outs = []
        for (d, eng), g, (f, a) in zip(self.groups, groups, inputs):
            with on_device(d):
                outs.append(eng._step_impl(g, f, a))
        gather = lambda k: torch.cat([o[k].to(self.device) for o in outs])
        return (ShardedStreamState([o[0] for o in outs]), gather(1),
                gather(2), gather(3))

    def _step_impl(self, state: StreamState, frames: torch.Tensor,
                   act: torch.Tensor
                   ) -> Tuple[StreamState, torch.Tensor, torch.Tensor,
                              torch.Tensor]:
        """One step on tensors on the card: frames (B, H, W, 3) of the
        wire's dtype, act (B,) bool."""
        x = self.prep(frames)
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
