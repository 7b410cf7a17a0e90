"""Clip, video and corpus inference engines.

Port of `tmrnet_tpu/eval/infer.py` (`memoryless_head` :41-52,
`ClipInference` :65-192, `VideoInference` :195-740).

`ClipInference`: each batch runs prep -> memory-window gather -> forward ->
f32 softmax -> argmax on the card, with softmax averaging over crops for
multi-crop batches; head `stage1` scores the clip's last step with no bank.
`run(ds)` scores a `ClipDataset` through a `ClipLoader` and
`device_prefetch`, as JAX's does; `run_batches` takes an iterable of host
batches `(clips, labels, rows, pad)` and the per-row first-row table
(`FeatureBank.first_rows`). The window rows are computed on the host as in
JAX (:146-154), clamped or, under `memory.compat_cross_video`, the
reference's cross-video table.

`VideoInference`: whole videos with the backbone once per frame (the clip
engine runs it `sequence_length` times per frame), the LSTM over every
sliding window of the cached per-frame features, the video's LFB features
from the extractor in the same pass, and the memory head over all clip
positions at once. Where JAX pads each video to a length bucket (one XLA
program per bucket), the port runs the true length: windows only look back,
so the outputs are the same. The trunk runs over chunks of at most
`trunk_chunk` frames (`plan_trunk_chunk` picks it from the card's limits).

`ClipInference(devices=[...])`, JAX's `ClipInference(mesh=)` (:65-192,
batches pre-sharded over the data axis, the weights and bank replicated)
in one process over local cards: a replica of the model, its prep and a
copy of the bank on each listed device (a device may repeat: one replica
serves each repeat), each batch (crops flattened) cut with its window
rows into contiguous shards, one a device, every shard copied to its
device before any forward, each forward under its device's guard, the
softmax rows gathered in order on the first device. A batch whose size
does not divide over the devices runs whole on the first, as JAX's
`build_lfb` places such a batch replicated (`train/loop.py:651-655`).
`replicas`, `on_device` and `run_shards` are the pattern: `build_lfb`
shares all three, the stream engine the first two.

The sequence-parallel pass, JAX's `VideoInference(mesh=)` (:205-242,
`corpus_features` :531-546) in one process over local cards:
`VideoInference(devices=[...])` keeps a replica of both trunks on each
listed device (a device may repeat: one replica serves each repeat), cuts
each trunk chunk's frames into contiguous shards, one a device, launches
each shard on its device and gathers the features on the first, where the
LSTMs and the head run. A corpus block that does not divide over the
devices runs whole on the first, as JAX leaves such a block unsharded
(:537-538). JAX's pass is single-controller, and so is this one: a mesh
over several processes is still refused.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Iterable, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from tmrnet_torch.config import ExperimentConfig
from tmrnet_torch.data.device_feed import DevicePrep, device_prefetch
from tmrnet_torch.data.indexing import memory_window_rows, quirk_window_table
from tmrnet_torch.data.pipeline import ClipDataset, ClipLoader
from tmrnet_torch.device import resolve_device, torch_dtype
from tmrnet_torch.memory.lfb import FeatureBank
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


def _engine_device(mesh, device, what: str) -> torch.device:
    """The engine's device: a one-process mesh's, else `device`; a mesh
    over several processes raises."""
    from tmrnet_torch.parallel.mesh import require_single_controller

    require_single_controller(mesh, what)
    return mesh.device if mesh is not None else resolve_device(device)


def load_weights(cfg_model, state_dict, device, fused_kernel):
    """`build_model` for `cfg_model` with `state_dict` loaded (strict)."""
    model = build_model(cfg_model, device, fused_kernel)
    model.load_state_dict(dict(state_dict), strict=True)
    return model


def shard_devices(devices, mesh, what: str) -> Optional[List[torch.device]]:
    """The listed devices of an engine's in-process shards, resolved (an
    absent card raises); None for no list. A mesh beside them raises."""
    if not devices:
        return None
    if mesh is not None:
        raise ValueError(f"{what} takes a mesh or devices, not both")
    return [resolve_device(d) for d in devices]


def replicas(devices: Sequence[torch.device], own, make) -> list:
    """[(device, replica)], one a listed device: `own` (a tuple) serves the
    first device, `make(device)` builds one tuple for each other distinct
    device, and a repeated device shares its replica."""
    made = {devices[0]: own}
    for d in devices:
        if d not in made:
            made[d] = make(d)
    return [(d, *made[d]) for d in devices]


def on_device(device: torch.device):
    """The guard a shard launches under: our kernels launch on the current
    card."""
    return (torch.cuda.device(device) if device.type == "cuda"
            else contextlib.nullcontext())


def run_shards(shards: Sequence[tuple], out_device: torch.device, fn,
               *tensors):
    """`tensors` (None passes through) cut along dim 0 into contiguous
    shards, one a (device, *replica) of `shards`; every shard copied to its
    device before any launch (a copy from the first card queues behind the
    work already on it), `fn(*replica, *parts)` launched for each under its
    device's guard before any is waited on, and the output tensors
    concatenated in order on `out_device`."""
    cut = [torch.tensor_split(t, len(shards)) if t is not None
           else [None] * len(shards) for t in tensors]
    parts = [(sh, [c[i] if c[i] is None else c[i].to(sh[0]) for c in cut])
             for i, sh in enumerate(shards)]
    outs = []
    for sh, args in parts:
        if args[0].shape[0]:
            with on_device(sh[0]):
                outs.append(fn(*sh[1:], *args))
    return torch.cat([o.to(out_device) for o in outs])


class ClipInference:
    """Batched clip inference with the memory-window gather on the card.

    state_dict: the model's weights (folded when cfg.model.folded), e.g.
    from `models.convert.from_jax_variables`, loaded with strict=True.
    bank: the feature bank on the engine's device, for the memory heads
    (tmr, nl_only); head stage1 reads none.
    fused_kernel: "block" or "tiled", the folded identity blocks' kernel
    (`models/tmrnet.py::build_backbone`); the same state dict serves both.
    mesh: a data mesh of one process (its device is the engine's); one
    over several processes raises (`parallel/mesh.py::
    require_single_controller`), as in JAX's engines.
    devices: each batch sharded over these devices (the first is the
    engine's; `device` is not read); one device, or None, is the
    one-device engine.
    TF32 stays as the caller set it: for f32 on the card as on the CPU,
    call `device.set_precision` first (the CLI's commands do).
    """

    def __init__(self, cfg: ExperimentConfig,
                 state_dict: Mapping[str, torch.Tensor],
                 bank: Optional[FeatureBank] = None, device="cuda",
                 fused_kernel: str = "block", mesh=None,
                 devices: Optional[Sequence] = None):
        devices = shard_devices(devices, mesh, "ClipInference")
        if devices:
            device = devices[0]
        self.device = _engine_device(mesh, device, "ClipInference")
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
        # The shards: (device, its model, prep and bank features), one a
        # listed device.
        self.shards = None
        if devices and len(devices) > 1:
            features = None if self.memoryless else bank.features
            self.shards = replicas(
                devices, (self.model, self.prep, features),
                lambda d: (load_weights(cfg.model, state_dict, d,
                                        fused_kernel),
                           DevicePrep(cfg.data, cfg.model.compute_dtype, d),
                           None if features is None else features.to(d)))

    def _probs(self, model, prep, features, clips, idx) -> torch.Tensor:
        """One device's forward: f32 softmax (B, classes)."""
        clips = prep(clips)
        if features is None:
            # stage1 emits logits for every step; score the clip's last frame
            logits = model(clips)[:, -1, :]
        else:
            logits = model(clips, features[idx])
        return torch.softmax(logits.float(), dim=-1)

    @torch.inference_mode()
    def infer(self, clips: torch.Tensor, idx: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """clips (B, T, H, W, 3) and window rows idx (B, window), both on the
        engine's device (idx None for head stage1) -> (argmax (B,), f32
        softmax (B, classes)) on it. Over several devices, a B that divides
        runs in contiguous shards (`run_shards`), another whole on the
        first device."""
        if self.shards is None or clips.shape[0] % len(self.shards):
            features = None if self.memoryless else self.bank.features
            probs = self._probs(self.model, self.prep, features, clips, idx)
        else:
            probs = run_shards(self.shards, self.device, self._probs, clips,
                               idx)
        return probs.argmax(dim=-1), probs

    def window_rows(self, rows: np.ndarray, first_rows: np.ndarray) -> np.ndarray:
        return memory_window_rows(rows, first_rows[rows], self.window)

    def run(self, ds: ClipDataset) -> InferenceResult:
        """Score every clip of a dataset: a ClipLoader over
        `eval.batch_clips` clips (`data.num_workers`, `data.prefetch`,
        `data.use_process_workers`), the memory windows clamped at each
        video's first row or, under `memory.compat_cross_video`, the
        reference's cross-video table, the batches copied ahead to the card
        (`device_prefetch`). Accuracy over the clips that are not
        padding."""
        d = self.cfg.data
        loader = ClipLoader(ds, self.cfg.eval.batch_clips, shuffle=False,
                            num_workers=d.num_workers, prefetch=d.prefetch,
                            use_processes=d.use_process_workers)
        if self.cfg.memory.compat_cross_video:
            table = quirk_window_table(ds.seq_len, ds.manifest.video_lengths,
                                       self.window)
            window_idx = lambda r: table[r]
        else:
            first_rows = ds.first_rows
            window_idx = lambda r: self.window_rows(r, first_rows)
        return self._score(self._host_batch(clips, labels, rows, pad,
                                            window_idx)
                           for clips, labels, rows, pad in loader.epoch(0))

    def run_batches(self, batches: Iterable, first_rows=None
                    ) -> InferenceResult:
        """batches: (clips, labels, rows, pad) host batches; clips uint8
        (B, T, H, W, 3), or (B, ncrops, T, H, W, 3) for multi-crop; the last
        `pad` entries are padding. first_rows: per-row first-row table (the
        memory heads; stage1 takes none)."""
        if not self.memoryless:
            if isinstance(first_rows, torch.Tensor):
                first_rows = first_rows.cpu().numpy()
            first_rows = np.asarray(first_rows, np.int64)
        window_idx = lambda r: self.window_rows(r, first_rows)
        return self._score(self._host_batch(clips, labels, rows, pad,
                                            window_idx)
                           for clips, labels, rows, pad in batches)

    def _host_batch(self, clips, labels, rows, pad, window_idx):
        """One host batch for the wire: crops flattened into the batch,
        non-uint8 clips cast to the compute dtype (uint8 ships as it is),
        and the window rows of every crop (None for a memoryless head)."""
        rows = np.asarray(rows, np.int64)
        ncrops = 1
        if clips.ndim == 6:
            ncrops = clips.shape[1]
            clips = clips.reshape((-1,) + clips.shape[2:])
        if clips.dtype != np.uint8:
            clips = torch.as_tensor(np.ascontiguousarray(clips)).to(self.prep.cdt)
        idx = None if self.memoryless else window_idx(np.repeat(rows, ncrops))
        return clips, idx, np.asarray(labels), rows, pad, ncrops

    def _score(self, host_batches) -> InferenceResult:
        """Forward the batches of `_host_batch`, copied to the engine's
        device ahead of use; softmax averaged over crops; predictions,
        scores, rows and labels of the rows that are not padding."""
        preds_all, scores_all, rows_all, labels_all = [], [], [], []
        for clips, idx, labels, rows, pad, ncrops in device_prefetch(
                host_batches, device=self.device, array_indices=(0, 1)):
            _, probs = self.infer(clips, idx)
            probs = probs.cpu().numpy()
            if ncrops > 1:
                probs = probs.reshape(len(rows), ncrops, -1).mean(axis=1)
            b = len(rows) - pad
            preds_all.append(np.argmax(probs[:b], axis=-1))
            scores_all.append(probs[:b])
            rows_all.append(rows[:b])
            labels_all.append(labels[:b])
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


def _available_bytes(device: torch.device) -> Optional[int]:
    """What the card can still allocate (free plus what PyTorch holds
    unused); None off a card."""
    if device.type != "cuda":
        return None
    free, _ = torch.cuda.mem_get_info(device)
    return (free + torch.cuda.memory_reserved(device)
            - torch.cuda.memory_allocated(device))


def plan_trunk_chunk(frame_elements: int, itemsize: int,
                     available_bytes: Optional[int] = None) -> int:
    """The auto trunk chunk: the largest power of two of frames whose
    largest activation (`frame_elements` a frame, the backbone's
    `activation_elements`) stays within INDEX_LIMIT elements, that
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
    > 0 = that many. mesh as in `ClipInference`.
    devices: the sequence-parallel pass over these devices (the first is
    the engine's; `device` is not read); one device, or None, is the
    one-device engine. TF32 stays as the caller set it, as in
    `ClipInference`.
    """

    def __init__(self, cfg: ExperimentConfig,
                 state_dict: Mapping[str, torch.Tensor],
                 extractor_state_dict: Mapping[str, torch.Tensor],
                 device="cuda", fused_kernel: str = "block",
                 backbone_chunk: Optional[int] = None, mesh=None,
                 devices: Optional[Sequence] = None):
        devices = shard_devices(devices, mesh, "VideoInference")
        if devices:
            device = devices[0]
        self.device = _engine_device(mesh, device, "VideoInference")
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
        # The sequence-parallel shards: (device, its prep, {id of a trunk
        # on the first device: its replica there}), one a listed device.
        self.shards = None
        if devices and len(devices) > 1:
            def make(d):
                ext = load_weights(dataclasses.replace(cfg.model, head="lfb"),
                                   extractor_state_dict, d, fused_kernel)
                mod = (ext if cfg.model.head == "lfb" else load_weights(
                    cfg.model, state_dict, d, fused_kernel))
                return (DevicePrep(cfg.data, self.cdt, d),
                        {id(self.extractor.backbone): ext.backbone,
                         id(self.model.backbone): mod.backbone})

            self.shards = replicas(devices, (self.prep, {
                id(m.backbone): m.backbone
                for m in (self.extractor, self.model)}), make)

    @staticmethod
    def bucket_frames(n: int) -> int:
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
        size; in the sequence-parallel pass, a shard's plan on the card with
        the least times the shards (a card's shards run one after another)."""
        if self.backbone_chunk > 0:
            return self.backbone_chunk
        if self.backbone_chunk < 0:
            return max(n, 1)
        key = tuple(int(s) for s in frame_hw)
        if key not in self._chunks:
            devices = ([self.device] if self.shards is None else
                       list(dict.fromkeys(d for d, _, _ in self.shards)))
            per = min(plan_trunk_chunk(
                self.model.backbone.activation_elements(*key),
                self.cdt.itemsize, _available_bytes(d)) for d in devices)
            self._chunks[key] = per * (1 if self.shards is None
                                       else len(self.shards))
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

    def _backbone_all_frames(self, backbone, frames: torch.Tensor,
                             shard: bool = True) -> torch.Tensor:
        """Input prep + trunk over all N frames on the device, in chunks of
        `trunk_chunk` frames, prep inside each chunk (so no normalized copy
        of the whole video is made) -> (N, F). In the sequence-parallel
        pass (unless `shard` is False) each chunk is cut into the shards."""
        n = frames.shape[0]
        step = self.trunk_chunk(n, frames.shape[1:3])
        run = (self._sharded_trunk if self.shards is not None and shard
               else lambda b, f: b(self.prep(f)))
        return torch.cat([run(backbone, frames[i:i + step])
                          for i in range(0, n, step)])

    def _sharded_trunk(self, backbone, frames: torch.Tensor) -> torch.Tensor:
        """One chunk's frames in contiguous shards, each through the trunk's
        replica on its device, the features gathered in order on the first
        device (`run_shards`)."""
        return run_shards(self.shards, self.device,
                          lambda prep, trunks, part:
                          trunks[id(backbone)](prep(part)), frames)

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
    def corpus_features(self, blocks: Iterable, even_only: bool = True
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Both trunks over an iterable of (n, H, W, 3) frame blocks (host
        or device) -> (extractor, tmr) per-frame features, concatenated on
        the device. In the sequence-parallel pass a block whose frames do
        not divide over the devices runs whole on the first (unless not
        `even_only`: `run_videos`, whose videos JAX pads to buckets that
        divide, shards every block)."""
        fe, ft = [], []
        for block in blocks:
            block = self._stage(block)
            shard = self.shards is not None and (
                not even_only or block.shape[0] % len(self.shards) == 0)
            fe.append(self._backbone_all_frames(self.extractor.backbone,
                                                block, shard))
            ft.append(self._backbone_all_frames(self.model.backbone, block,
                                                shard))
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
            frames_list, ns, chunk, pad_last=False), even_only=False)
        return self.corpus_heads(fe, ft, ns)

    def run_video(self, frames) -> Tuple[np.ndarray, np.ndarray]:
        """frames: (N, H, W, 3) uint8 or float, host or device -> (preds,
        probs) for the video's N - seq + 1 clip positions (empty when
        N < seq)."""
        return self.run_videos([frames])[0]
