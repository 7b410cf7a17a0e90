"""Clip, video and corpus inference engines.

Port of `tmrnet_tpu/eval/infer.py` (`memoryless_head` :41-52,
`ClipInference` :65-192, `VideoInference` :195-740).

`ClipInference`: each batch runs prep -> memory-window gather -> forward ->
f32 softmax -> argmax on the card, with softmax averaging over crops for
multi-crop batches; head `stage1` scores the clip's last step with no bank.
`run()` takes an iterable of host batches `(clips_uint8, labels, rows,
pad)` and the per-row first-row table (`FeatureBank.first_rows`); the
window rows are computed on the host as in JAX (:146-154). The dataset and
loader come in a later slice.

`VideoInference`: whole videos with the backbone once per frame (the clip
engine runs it `sequence_length` times per frame), the LSTM over every
sliding window of the cached per-frame features, the video's LFB features
from the extractor in the same pass, and the memory head over all clip
positions at once. Where JAX pads each video to a length bucket (one XLA
program per bucket), the port runs the true length: windows only look back,
so the outputs are the same. The trunk runs over chunks of at most
`trunk_chunk` frames (`plan_trunk_chunk` picks it from the card's limits).
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from tmrnet_torch.config import ExperimentConfig
from tmrnet_torch.data.device_feed import DevicePrep
from tmrnet_torch.device import resolve_device, torch_dtype
from tmrnet_torch.memory.lfb import FeatureBank, memory_window_rows
from tmrnet_torch.models.tmrnet import TMRNet, build_model


def memoryless_head(head: str) -> bool:
    """True for heads scored frame-only, with no feature bank. The 'lfb'
    extractor emits features, not logits, and cannot be scored."""
    if head == "lfb":
        raise ValueError(
            "model.head='lfb' is the feature extractor (emits (B, hidden) "
            "features, not logits) and cannot be scored; use head 'stage1' "
            "for the frame-only baseline or 'tmr'/'nl_only' for memory heads")
    return head not in ("tmr", "nl_only")


@dataclasses.dataclass
class InferenceResult:
    """Per-clip predictions in clip row order."""

    preds: np.ndarray          # (num_clips,) argmax phase ids
    scores: np.ndarray         # (num_clips, num_classes) softmax
    rows: np.ndarray           # (num_clips,) bank rows
    accuracy: float            # clip-level accuracy vs last-frame labels


def load_weights(cfg_model, state_dict, device, fused_kernel):
    """`build_model` for `cfg_model` with `state_dict` loaded (strict)."""
    model = build_model(cfg_model, device, fused_kernel)
    model.load_state_dict(dict(state_dict), strict=True)
    return model


class ClipInference:
    """Batched clip inference with the memory-window gather on the card.

    state_dict: the model's weights (folded when cfg.model.folded), e.g.
    from `models.convert.from_jax_variables`, loaded with strict=True.
    bank: the feature bank on the engine's device, for the memory heads
    (tmr, nl_only); head stage1 reads none.
    fused_kernel: "block" or "tiled", the folded identity blocks' kernel
    (`models/tmrnet.py::build_backbone`); the same state dict serves both.
    """

    def __init__(self, cfg: ExperimentConfig,
                 state_dict: Mapping[str, torch.Tensor],
                 bank: Optional[FeatureBank] = None, device="cuda",
                 fused_kernel: str = "block"):
        self.device = resolve_device(device)
        self.memoryless = memoryless_head(cfg.model.head)
        if not self.memoryless:
            if bank is None:
                raise ValueError(f"head {cfg.model.head!r} reads the feature "
                                 f"bank; pass one")
            if bank.features.device != self.device:
                raise ValueError(f"bank on {bank.features.device}, engine on "
                                 f"{self.device}")
        self.cfg = cfg
        self.window = cfg.memory.window
        self.model = load_weights(cfg.model, state_dict, self.device,
                                  fused_kernel)
        self.prep = DevicePrep(cfg.data, cfg.model.compute_dtype, self.device)
        self.bank = bank

    @torch.inference_mode()
    def infer(self, clips: torch.Tensor, idx: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """clips (B, T, H, W, 3) and window rows idx (B, window), both on the
        engine's device (idx None for head stage1) -> (argmax (B,), f32
        softmax (B, classes))."""
        clips = self.prep(clips)
        if self.memoryless:
            # stage1 emits logits for every step; score the clip's last frame
            logits = self.model(clips)[:, -1, :]
        else:
            logits = self.model(clips, self.bank.features[idx])
        probs = torch.softmax(logits.float(), dim=-1)
        return probs.argmax(dim=-1), probs

    def window_rows(self, rows: np.ndarray, first_rows: np.ndarray) -> np.ndarray:
        return memory_window_rows(rows, first_rows[rows], self.window)

    def run(self, batches: Iterable, first_rows=None) -> InferenceResult:
        """batches: (clips, labels, rows, pad) host batches; clips uint8
        (B, T, H, W, 3), or (B, ncrops, T, H, W, 3) for multi-crop; the last
        `pad` entries are padding. first_rows: per-row first-row table (the
        memory heads; stage1 takes none)."""
        if not self.memoryless:
            if isinstance(first_rows, torch.Tensor):
                first_rows = first_rows.cpu().numpy()
            first_rows = np.asarray(first_rows, np.int64)
        preds_all, scores_all, rows_all, labels_all = [], [], [], []
        for clips, labels, rows, pad in batches:
            rows = np.asarray(rows, np.int64)
            ncrops = 1
            if clips.ndim == 6:
                ncrops = clips.shape[1]
                clips = clips.reshape((-1,) + clips.shape[2:])
            idx = None
            if not self.memoryless:
                idx = torch.from_numpy(self.window_rows(
                    np.repeat(rows, ncrops), first_rows)).to(self.device)
            clips_d = torch.from_numpy(np.ascontiguousarray(clips)).to(self.device)
            _, probs = self.infer(clips_d, idx)
            probs = probs.cpu().numpy()
            if ncrops > 1:
                probs = probs.reshape(len(rows), ncrops, -1).mean(axis=1)
            b = len(rows) - pad
            preds_all.append(np.argmax(probs[:b], axis=-1))
            scores_all.append(probs[:b])
            rows_all.append(rows[:b])
            labels_all.append(np.asarray(labels)[:b])
        preds = np.concatenate(preds_all)
        labels = np.concatenate(labels_all)
        return InferenceResult(
            preds=preds, scores=np.concatenate(scores_all),
            rows=np.concatenate(rows_all),
            accuracy=float((preds == labels).mean()) if preds.size else 0.0)


# JAX's bucket policy (`VideoInference(pad_frames=2048, bucket_step=1024)`).
PAD_FRAMES, BUCKET_STEP = 2048, 1024
# corpus_heads scores up to this many same-bucket videos in one head call.
HEAD_GROUP = 8
# Limits of the auto trunk chunk (`plan_trunk_chunk`): a tensor's elements
# within what 32-bit index paths of convolutions reach; fused_bottleneck's
# grid (one row of blocks per image); the largest activations of a frame
# alive at once (a projection block's branch output, its residual and their
# sum); and the share of the card's allocatable memory the trunk may take.
INDEX_LIMIT = 2**31 - 1
MAX_IMAGES = 65535
LIVE_ACTIVATIONS = 4
MEMORY_SHARE = 0.5


def plan_trunk_chunk(frame_elements: int, itemsize: int,
                     available_bytes: Optional[int] = None) -> int:
    """The auto trunk chunk: the largest power of two of frames whose
    largest activation (`frame_elements` a frame, `ResNet.
    activation_elements`) stays within INDEX_LIMIT elements, that
    fused_bottleneck takes (MAX_IMAGES), and, given `available_bytes`,
    whose LIVE_ACTIVATIONS such tensors of `itemsize` bytes fit in
    MEMORY_SHARE of them. At 224^2 (802,816 elements a frame) the index
    limit alone gives 2,048 frames."""
    limit = min(INDEX_LIMIT // frame_elements, MAX_IMAGES)
    if available_bytes is not None:
        limit = min(limit, int(available_bytes * MEMORY_SHARE)
                    // (LIVE_ACTIVATIONS * frame_elements * itemsize))
    if limit < 1:
        raise ValueError(f"one frame's activations ({frame_elements} "
                         f"elements) exceed the trunk's limits")
    return 1 << (limit.bit_length() - 1)


def corpus_lengths(videos: Sequence, lengths: Optional[Sequence[int]]
                   ) -> List[int]:
    """Frame counts of `videos` (arrays, tensors or zero-arg loaders);
    loaders have no shape until called, so they need `lengths`."""
    if lengths is None and any(callable(v) for v in videos):
        raise ValueError("lengths is required when videos are callables "
                         "(lazy loaders have no shape until materialized)")
    return [int(lengths[i]) if callable(v) else int(v.shape[0])
            for i, v in enumerate(videos)]


def load_video(video, n: int, index: int):
    """Materialize one video (call a loader) and check its declared length:
    a silent mismatch would shift every later video's rows."""
    frames = video() if callable(video) else video
    if frames.shape[0] != n:
        raise ValueError(f"corpus video {index}: loader returned "
                         f"{frames.shape[0]} frames, declared {n}")
    return frames


class VideoInference:
    """Full-video inference: backbone once per frame, sliding LSTM windows,
    the LFB features of the same pass, the memory head over every clip
    position.

    state_dict: TMR model weights (head tmr or nl_only: trunk, LSTM, head).
    extractor_state_dict: the frozen extractor's (head lfb: trunk, LSTM),
    whose LSTM's last steps are the video's bank rows. With cfg.model.head
    'lfb' the engine holds the extractor alone and only builds banks
    (`bank_features`). fused_kernel as in `ClipInference`.
    backbone_chunk (default cfg.eval.backbone_chunk): frames per trunk
    launch; 0 = auto (`trunk_chunk`), -1 = all of a call's frames at once,
    > 0 = that many.
    """

    def __init__(self, cfg: ExperimentConfig,
                 state_dict: Mapping[str, torch.Tensor],
                 extractor_state_dict: Mapping[str, torch.Tensor],
                 device="cuda", fused_kernel: str = "block",
                 backbone_chunk: Optional[int] = None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.seq = cfg.data.sequence_length
        self.window = cfg.memory.window
        self.hidden = cfg.model.hidden_dim
        self.cdt = torch_dtype(cfg.model.compute_dtype)
        self.backbone_chunk = (cfg.eval.backbone_chunk
                               if backbone_chunk is None else backbone_chunk)
        self.extractor = load_weights(
            dataclasses.replace(cfg.model, head="lfb"), extractor_state_dict,
            self.device, fused_kernel)
        self.model = (self.extractor if cfg.model.head == "lfb" else
                      load_weights(cfg.model, state_dict, self.device,
                                   fused_kernel))
        self.prep = DevicePrep(cfg.data, self.cdt, self.device)
        self._chunks = {}

    def bucket_frames(self, n: int) -> int:
        """JAX's padded length for an n-frame video: pow-2 up to PAD_FRAMES,
        then the next multiple of BUCKET_STEP. The port pads nothing; it
        groups videos by bucket in `corpus_heads`, as JAX does."""
        if n <= PAD_FRAMES:
            return min(PAD_FRAMES, 1 << max(0, (n - 1).bit_length()))
        return -(-n // BUCKET_STEP) * BUCKET_STEP

    def trunk_chunk(self, n: int, frame_hw: Tuple[int, int]) -> int:
        """Frames per trunk launch for a call of n frames of frame_hw. Auto
        (backbone_chunk 0) is `plan_trunk_chunk` with the card's allocatable
        memory (free plus what PyTorch holds unused), decided once per frame
        size."""
        if self.backbone_chunk > 0:
            return self.backbone_chunk
        if self.backbone_chunk < 0:
            return max(n, 1)
        key = tuple(int(s) for s in frame_hw)
        if key not in self._chunks:
            available = None
            if self.device.type == "cuda":
                free, _ = torch.cuda.mem_get_info(self.device)
                available = (free + torch.cuda.memory_reserved(self.device)
                             - torch.cuda.memory_allocated(self.device))
            self._chunks[key] = plan_trunk_chunk(
                self.model.backbone.activation_elements(*key),
                self.cdt.itemsize, available)
        return self._chunks[key]

    def _stage(self, frames) -> torch.Tensor:
        """Frames onto the engine's device: uint8 as they are (prep casts
        them per chunk), others in the compute dtype. Tensors already there
        stay there (a host round trip of a whole video costs more than its
        backbone pass)."""
        if not isinstance(frames, torch.Tensor):
            frames = torch.from_numpy(np.ascontiguousarray(frames))
        dtype = None if frames.dtype == torch.uint8 else self.cdt
        return frames.to(device=self.device, dtype=dtype)

    def _window_features(self, feats: torch.Tensor) -> torch.Tensor:
        """(N, F) per-frame features -> (N-seq+1, seq, F) sliding windows,
        a view of feats."""
        return feats.unfold(0, self.seq, 1).transpose(1, 2)

    def _backbone_all_frames(self, backbone, frames: torch.Tensor
                             ) -> torch.Tensor:
        """Input prep + trunk over all N frames on the device, in chunks of
        `trunk_chunk` frames, prep inside each chunk (so no normalized copy
        of the whole video is made) -> (N, F)."""
        n = frames.shape[0]
        step = self.trunk_chunk(n, frames.shape[1:3])
        return torch.cat([backbone(self.prep(frames[i:i + step]))
                          for i in range(0, n, step)])

    def _embed(self, model, windows: torch.Tensor) -> torch.Tensor:
        """The LSTM of `model` over (C, seq, F) windows -> the last step
        (C, hidden): the LFB feature (extractor) or St (TMR model)."""
        _, (h, _) = model.encoder.lstm(windows)
        return h

    def _scorer(self) -> TMRNet:
        if not isinstance(self.model, TMRNet):
            raise ValueError(f"head {self.cfg.model.head!r} has no memory "
                             f"head to score (want tmr or nl_only)")
        return self.model

    @torch.inference_mode()
    def bank_features(self, frames) -> torch.Tensor:
        """One video's per-clip LFB features, (N-seq+1, hidden) in the
        compute dtype on the device, with one backbone pass per frame.
        frames: (N, H, W, 3) uint8 or float, host or device."""
        n = int(frames.shape[0])
        if n - self.seq + 1 <= 0:
            return torch.zeros((0, self.hidden), dtype=self.cdt,
                               device=self.device)
        feats = self._backbone_all_frames(self.extractor.backbone,
                                          self._stage(frames))
        return self._embed(self.extractor, self._window_features(feats))

    @torch.inference_mode()
    def corpus_features(self, blocks: Iterable) -> Tuple[torch.Tensor,
                                                          torch.Tensor]:
        """Both trunks over an iterable of (n, H, W, 3) frame blocks (host
        or device) -> (extractor, tmr) per-frame features, concatenated on
        the device."""
        fe, ft = [], []
        for block in blocks:
            block = self._stage(block)
            fe.append(self._backbone_all_frames(self.extractor.backbone, block))
            ft.append(self._backbone_all_frames(self.model.backbone, block))
        return torch.cat(fe), torch.cat(ft)

    @torch.inference_mode()
    def corpus_heads(self, fe: torch.Tensor, ft: torch.Tensor,
                     ns: Sequence[int]) -> list:
        """Per-video LSTM and memory head over slices of the corpus feature
        buffers; ns: true video lengths, in corpus order. Videos with clip
        positions go by bucket (`bucket_frames`) into groups of up to
        HEAD_GROUP, one head call per group over all its clip positions,
        each video's windows clamped at its own first row. Returns
        [(preds (k,) int64, probs (k, classes) f32)], k = max(0, n-seq+1)."""
        model = self._scorer()
        starts = np.concatenate([[0], np.cumsum(ns)[:-1]]).astype(int)
        groups = {}
        for i, n in enumerate(ns):
            if n - self.seq + 1 > 0:
                groups.setdefault(self.bucket_frames(n), []).append(i)
        out = [(np.zeros(0, np.int64),
                np.zeros((0, self.cfg.model.num_classes), np.float32))
               for _ in ns]
        for _, vids in sorted(groups.items()):
            for g in range(0, len(vids), HEAD_GROUP):
                group = vids[g:g + HEAD_GROUP]
                spans = [slice(starts[i], starts[i] + ns[i]) for i in group]
                ks = [ns[i] - self.seq + 1 for i in group]
                bank = self._embed(self.extractor, torch.cat(
                    [self._window_features(fe[s]) for s in spans]))
                st = self._embed(model, torch.cat(
                    [self._window_features(ft[s]) for s in spans]))
                rows = torch.arange(sum(ks), device=self.device)
                firsts = torch.repeat_interleave(
                    torch.tensor(np.cumsum([0] + ks[:-1]), device=self.device),
                    torch.tensor(ks, device=self.device))
                memory = bank[memory_window_rows(rows, firsts, self.window)]
                probs = torch.softmax(model.head(st, memory).float(), dim=-1)
                preds = probs.argmax(dim=-1).cpu().numpy()
                probs = probs.cpu().numpy()
                for i, a, k in zip(group, np.cumsum([0] + ks[:-1]), ks):
                    out[i] = (preds[a:a + k], probs[a:a + k])
        return out

    def _frame_blocks(self, videos: Sequence, ns: Sequence[int], chunk: int,
                      pad_last: bool):
        """Blocks of `chunk` frames on the device, cut from the videos in
        order and across their boundaries, each video materialized only
        while the cut crosses it; the last block zero-padded to `chunk`
        (pad_last) or left short."""
        buf, have = [], 0
        for i, video in enumerate(videos):
            frames = load_video(video, ns[i], i)
            pos = 0
            while pos < ns[i]:
                take = min(chunk - have, ns[i] - pos)
                buf.append(self._stage(frames[pos:pos + take]))
                pos += take
                have += take
                if have == chunk:
                    yield torch.cat(buf) if len(buf) > 1 else buf[0]
                    buf, have = [], 0
        if have:
            if pad_last:
                buf.append(buf[0].new_zeros((chunk - have,)
                                            + tuple(buf[0].shape[1:])))
            yield torch.cat(buf) if len(buf) > 1 else buf[0]

    def run_corpus(self, videos: Sequence, lengths: Optional[Sequence[int]]
                   = None, chunk: int = 2048) -> list:
        """Whole-test-set inference: the flat frame stream of all videos
        through both trunks in blocks of `chunk` frames (blocks cross video
        boundaries; the final partial block is zero-padded), then
        `corpus_heads`. videos: (N_i, H, W, 3) arrays or tensors, or
        zero-arg callables returning them (lazy: each is materialized only
        while the stream crosses it); lengths: required with callables.
        Returns [(preds, probs)] like run_videos."""
        if not videos:
            return []
        ns = corpus_lengths(videos, lengths)
        chunk = min(chunk, sum(ns))
        fe, ft = self.corpus_features(self._frame_blocks(videos, ns, chunk,
                                                         pad_last=True))
        return self.corpus_heads(fe, ft, ns)

    def run_videos(self, frames_list: Sequence) -> list:
        """Several videos at once: their frames through the trunks as one
        stream in `trunk_chunk` blocks (no padding), then `corpus_heads`.
        frames_list: (N_i, H, W, 3) arrays or tensors -> [(preds (k_i,),
        probs (k_i, classes))], k_i = max(0, N_i - seq + 1)."""
        if not frames_list:
            return []
        ns = [int(f.shape[0]) for f in frames_list]
        chunk = self.trunk_chunk(sum(ns), frames_list[0].shape[1:3])
        fe, ft = self.corpus_features(self._frame_blocks(
            frames_list, ns, chunk, pad_last=False))
        return self.corpus_heads(fe, ft, ns)

    def run_video(self, frames) -> Tuple[np.ndarray, np.ndarray]:
        """frames: (N, H, W, 3) uint8 or float, host or device -> (preds,
        probs) for the video's N - seq + 1 clip positions (empty when
        N < seq)."""
        return self.run_videos([frames])[0]
