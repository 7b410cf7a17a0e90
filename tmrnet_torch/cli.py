"""Command line of the port: `python -m tmrnet_torch <command>`.

  prepare     videos -> 1-fps cut-margin frames (PNG trees or packed
              .npy videos); needs a decoder (imageio+pyav or cv2)
  manifest    frames dir + phase annotations -> manifest pickle/CSV
  synth       the synthetic memory-dependent dataset of the
              learning-efficacy study -> packed videos + annotations
  pack        a manifest's frames -> per-video raw .npy + its manifest
  stats       channel mean/std of a manifest's frames (meanStd tool)
  train-bank  stage-1 memory-bank training (trunk + LSTM + fc)
  build-lfb   the frozen extractor's feature bank of a manifest -> .npz
  train-tmr   stage-2 TMRNet / only-non-local training over a bank
  test        test-set inference -> predictions .npz, per-class
              precision/recall and accuracy
  stream      online streaming inference, one frame a stream a step ->
              JSONL rows
  serve       serving daemon: JSONL frame events on stdin (or TCP clients
              with --listen) -> predictions on stdout (or the owning
              connection)
  parity      reference .pth + frames -> Main.m protocol table, one command
  export      predictions -> <video>-phase.txt trees (export_phase_copy.py)
  evaluate    relaxed-boundary protocol scoring (MATLAB Main.m, in Python)
  export-ckpt the port's checkpoint -> reference-format .pth
  export-model the clip or stream step -> a torch.export artifact (.pt2,
              weights held as constants) that `stream --artifact` and
              `serve --artifact` run with no model code or checkpoint
  doctor      preflight of a host: versions, the card, nvcc, the native
              preprocess, and (when pointed at them) a manifest,
              checkpoint, bank, artifact or mesh, and the kernels
  migrate     a reference command line -> the equivalent commands of the
              port, with notes

Port of `tmrnet_tpu/cli.py` (`load_config` :48-57, `_phase_names` :68,
`_load_manifest` :74, `_clip_labels` :145, `_dataset` :153-175,
`_video_dataset` :177-232, `cmd_prepare` :277-310, `cmd_manifest`
:314-347, `cmd_synth` :349-401, `cmd_pack` :404-448, `cmd_stats` :451-476, `cmd_train_bank` :479-515, `cmd_build_lfb`
:517-575, `cmd_train_tmr` :577-630, `cmd_test` :632-824, `cmd_stream`
:843-1038, `cmd_serve` :1041-1152, `cmd_parity` :1155-1214, `cmd_export`
:1217-1262, `cmd_evaluate` :1265-1320, `cmd_export_ckpt` :1323-1340,
`_stream_artifact_engine` :827-840, `cmd_export_model` :1343-1393,
`cmd_migrate` :1396-1418, `cmd_doctor` :1421-1600, their parsers).
Weights come from the port's own checkpoints (`--ckpt`, `--stage1-ckpt`,
`--extractor-ckpt`: `utils/checkpoint.py`) or from reference-format `.pth` files (`--torch-ckpt`, `--extractor-torch-ckpt`,
`--torch-init`; `_restore_variables` :233-275 and `_extractor_for`
:122-142). `test`, `stream` and `serve` take the model from `--ckpt` or
`--torch-ckpt` and the frozen extractor from a stage-1 checkpoint
(`--extractor-ckpt`), an extractor `.pth` (`--extractor-torch-ckpt`) or,
with neither, the model's trunk and LSTM; or from an `export-model
--stream` artifact (`--artifact`), whose sidecar's config replaces the
loaded one. Entry points that run a model run on the card unless `--device
cpu` asks for the CPU (an artifact runs on the device it was exported on,
which `--device` must name); `doctor` fails its device check without a
card unless `--device cpu`; `prepare`, `manifest`, `synth`, `pack`,
`stats`, `export`, `evaluate`, `export-ckpt` and `migrate` touch no card
and take no `--device`. `train-bank`, `build-lfb` and `train-tmr` train
or build straight from video files with `--videos DIR --annotations DIR`
(`--val-videos DIR` for the trainers' val set): clips decode on the host,
float32 in [0, 1] with no mean or std, which the card casts and does not
normalize. `prepare` and `--videos` need a decoder, imageio+pyav or cv2,
and exit naming both where neither imports, before they list a directory
(the card's machine has none: prepare elsewhere with `--pack`). Not
ported: Orbax checkpoints and `--artifact` under `mesh.multihost`. The learning-efficacy study that
drives `synth` through `evaluate` is `python -m
tmrnet_torch.experimental.efficacy_study`.

The (data x model) grid across processes (`_mesh_for`, JAX :85-119):
under `--set mesh.multihost=true` each process joins a
`torch.distributed` group (torchrun's environment, or
`mesh.coordinator`, `mesh.num_processes` and `mesh.process_id` together)
and drives one card, cuda:(LOCAL_RANK % cards) (gloo ranks on the CPU
with `--device cpu`): `train-bank` and `train-tmr` train on the rows of
each rank's data index of every global batch of data.batch_clips (which
must divide over the data ranks), with `--set mesh.model_parallel=M` over
M ranks a model group, each holding its slices of the layers that JAX's
tensor-parallel rules shard (`parallel/tensor.py`); `build-lfb` builds
each rank's rows (clip engine) or videos (video engine), `test --engine
corpus` and `stream` partition the videos: they take every rank as a data
rank, since the engines replicate the weights (JAX's do, `infer.py
:231-236`). Rank 0 writes every output file and prints the summary line;
the outputs equal a one-process run's. For example

    torchrun --nproc-per-node 8 -m tmrnet_torch train-tmr ... \
        --set mesh.multihost=true --set mesh.model_parallel=2

Without mesh.multihost every command runs on one card, except that `--set
mesh.data_parallel=N` (N > 1) shards the work of one process over cuda:0
.. cuda:N-1 (N CPU shards with `--device cpu`), as JAX's commands do over
a process-local mesh: `test --engine video|corpus` and `build-lfb
--engine video` run the sequence-parallel pass
(`eval/infer.py::VideoInference(devices=)`); `test --engine clip`,
`build-lfb --engine clip` and `parity` shard each batch
(`ClipInference(devices=)`, `train/loop.py::build_lfb(devices=)`), whose
size (`eval.batch_clips` for the clip engine, `data.batch_clips` for a
bank build) must divide by N; `stream` and `serve` split their slots
(`eval/stream.py::StreamingInference(devices=)`), the slot count rounded
up to a multiple of N, the surplus slots idle on blank frames (JAX
:932-935, :1075-1078). The trainers and `--artifact` (which bakes one
card) refuse it, and N above the visible cards exits. JAX builds a mesh
over every visible device by itself; the port takes N explicitly.

Config: --config <json> loads an ExperimentConfig (a JSON written by either
package; fields the port lacks are skipped, and a `config_ignored` line on
stderr names those that JAX would honour at another value than its
default), else --preset <name> one of the presets of `config.PRESETS`;
then --set a.b=c applies dotted overrides (a field the port lacks
raises).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import pickle
import signal
import sys
from typing import Dict, List, Optional

import numpy as np

from tmrnet_torch.config import (CHOLEC80_PHASES, M2CAI_PHASES, PRESETS,
                                 ExperimentConfig, apply_override,
                                 get_preset, ignored_fields)


def load_config(args) -> ExperimentConfig:
    if getattr(args, "config", None):
        with open(args.config) as f:
            text = f.read()
        cfg = ExperimentConfig.from_json(text)
        ignored = ignored_fields(text)
        if ignored:
            print(json.dumps({"config_ignored": ignored}), file=sys.stderr,
                  flush=True)
    elif getattr(args, "preset", None):
        cfg = get_preset(args.preset)
    else:
        cfg = ExperimentConfig()
    for o in getattr(args, "set", None) or []:
        cfg = apply_override(cfg, o)
    return cfg


def phase_names(protocol: str):
    return CHOLEC80_PHASES if protocol == "cholec80" else M2CAI_PHASES


def restore_state(cfg: ExperimentConfig, head: str,
                  torch_ckpt: Optional[str] = None,
                  ckpt: Optional[str] = None) -> Dict:
    """The unfolded state dict of `head` from a reference `.pth`, through
    the port's import, or from the weights of a port checkpoint directory
    (its best, else its newest step); a checkpoint that lacks a key the
    head needs raises and names it."""
    from tmrnet_torch.models.torch_import import require_complete

    state = (checkpoint_weights(ckpt) if ckpt
             else reference_weights(cfg, head, torch_ckpt))
    require_complete(state, dataclasses.replace(cfg.model, head=head))
    return state


def reference_weights(cfg: ExperimentConfig, head: str, path: str) -> Dict:
    """The keys of a reference `.pth` that `head` has, as the port's state
    dict (unfolded); possibly a subset of the head's."""
    from tmrnet_torch.models.torch_import import (
        convert_reference_checkpoint, load_torch_state_dict)

    return convert_reference_checkpoint(load_torch_state_dict(path), head,
                                        cfg.model.stage_sizes)


def checkpoint_weights(ckpt_dir: str) -> Dict:
    """The port's state dict of a port checkpoint directory's weights."""
    from tmrnet_torch.models.convert import from_jax_variables
    from tmrnet_torch.utils.checkpoint import CheckpointManager

    if not os.path.isdir(ckpt_dir):
        raise SystemExit(f"checkpoint dir not found: {ckpt_dir}")
    return from_jax_variables(CheckpointManager(ckpt_dir).restore_weights())


def init_with(cfg: ExperimentConfig, head: str, weights: Dict) -> Dict:
    """A fresh init of `head` (flax's distributions, seed 0 as JAX's
    restore inits with PRNGKey(0)) with every entry of `weights` it has
    put over it: the strict=False bootstrap of the reference's trainers.
    An entry of another shape raises."""
    from tmrnet_torch.models.tmrnet import init_state_dict

    state = init_state_dict(dataclasses.replace(cfg.model, head=head), 0)
    bad = [f"{k} {tuple(v.shape)} (want {tuple(state[k].shape)})"
           for k, v in weights.items()
           if k in state and tuple(v.shape) != tuple(state[k].shape)]
    if bad:
        raise ValueError(f"init weights' shapes differ from the model's: "
                         f"{', '.join(bad)}")
    state.update({k: v for k, v in weights.items() if k in state})
    return state


def extractor_state(cfg: ExperimentConfig, state: Dict,
                    extractor_torch_ckpt: Optional[str] = None,
                    extractor_ckpt: Optional[str] = None) -> Dict:
    """The frozen extractor's weights, the `backbone.*` and `encoder.*`
    entries of: a port stage-1 checkpoint directory when given (head
    stage1, JAX's `_extractor_for`), else an extractor `.pth` (head lfb),
    else the model's own. The extractor's backbone is `cfg.model`'s, so a
    checkpoint of another backbone raises and names the missing keys."""
    if extractor_ckpt:
        state = restore_state(cfg, "stage1", ckpt=extractor_ckpt)
    elif extractor_torch_ckpt:
        state = restore_state(cfg, "lfb", extractor_torch_ckpt)
    return {k: v for k, v in state.items()
            if k.startswith(("backbone.", "encoder."))}


def extractor_for(cfg: ExperimentConfig, state: Dict, args) -> Dict:
    """`extractor_state` from a command's `--extractor-ckpt` or
    `--extractor-torch-ckpt`, where it has them."""
    return extractor_state(cfg, state,
                           getattr(args, "extractor_torch_ckpt", None),
                           getattr(args, "extractor_ckpt", None))


def folded_weights(cfg: ExperimentConfig, *states: Dict):
    """The states as the engines take them: BN folded into the convs under
    `model.folded` (only a folded backbone launches the fused identity
    blocks' kernels), else as they are."""
    from tmrnet_torch.models.fold_bn import fold_variables

    if not cfg.model.folded:
        return states
    return tuple(fold_variables(s) for s in states)


def eval_transform(cfg: ExperimentConfig):
    """The test-time transform of `data`: uint8 out under
    `data.device_normalize` (the card normalizes), else normalized
    float32."""
    from tmrnet_torch.data.transforms import EvalTransform

    d = cfg.data
    return EvalTransform(d.crop_size, d.resize, d.test_crop_type, d.mean,
                         d.std, normalize=not d.device_normalize)


def load_manifest(path: str, split: str = "train"):
    """A manifest by extension: `.csv`, else a reference pickle: its train
    split, or under split 'val' its second split where it has one (else
    the first)."""
    from tmrnet_torch.data.manifests import load_csv_manifest, load_pickle_manifest

    if path.endswith(".csv"):
        return load_csv_manifest(path)
    primary, secondary = load_pickle_manifest(path)
    if split == "val" and secondary is not None:
        return secondary
    return primary


def clip_labels(manifest, seq_len: int) -> np.ndarray:
    """Per-clip last-frame labels in bank-row order (accuracy and the
    per-class report read the same ones)."""
    parts = [v.labels[seq_len - 1:][: max(0, len(v) + 1 - seq_len)]
             for v in manifest.videos]
    return np.concatenate(parts) if parts else np.zeros(0, np.int64)


def dataset(cfg: ExperimentConfig, manifest):
    """The test-time ClipDataset of a manifest; clips stay uint8 under
    `data.device_normalize` (the card normalizes them)."""
    from tmrnet_torch.data.pipeline import ClipDataset

    return ClipDataset(manifest, cfg.data.sequence_length,
                       transform=eval_transform(cfg))


def train_dataset(cfg: ExperimentConfig, manifest):
    """The training ClipDataset of a manifest: TrainTransform (one
    augmentation draw per clip and epoch), uint8 out under
    `data.device_normalize`, else normalized on the host, through the C++
    library under `data.use_native_preproc`."""
    from tmrnet_torch.data.pipeline import ClipDataset
    from tmrnet_torch.data.transforms import TrainTransform

    d = cfg.data
    tf = TrainTransform(d.crop_size, d.resize, d.use_flip, d.rotate_degrees,
                        d.color_jitter, hue=d.color_jitter_hue, mean=d.mean,
                        std=d.std, use_native=d.use_native_preproc,
                        normalize=not d.device_normalize)
    return ClipDataset(manifest, d.sequence_length, transform=tf)


VIDEO_SUFFIXES = (".mp4", ".avi", ".mkv")


def require_decoder() -> None:
    """Exit naming both decoders where neither imageio+pyav nor cv2
    imports; called before any directory is listed or file probed."""
    from tmrnet_torch.data.video import NoDecoderError
    from tmrnet_torch.data.video import require_decoder as require

    try:
        require()
    except NoDecoderError as e:
        raise SystemExit(str(e))


def video_dataset(cfg: ExperimentConfig, videos_dir: str,
                  annotation_root: Optional[str], train: bool):
    """The video-direct dataset of a directory of videos (the fork's
    HystDataset direction, `test-resnet.py:139-203`): clips decode
    straight from the files, every data.source_fps // data.fps-th frame;
    labels from the phase annotations at source fps. A video keeps the
    contiguous annotated prefix of its sampled frames (the reader decodes
    frames 0..n-1 in order, so a gap would shift every later label):
    one whose annotations miss frame 0 is skipped, one whose annotations
    end early is truncated, each with a warning on stderr."""
    from tmrnet_torch.data.manifests import _natural_key, read_phase_annotation
    from tmrnet_torch.data.pipeline import VideoClipDataset
    from tmrnet_torch.data.transforms import (VideoEvalTransform,
                                              VideoTrainTransform)
    from tmrnet_torch.data.video import VideoClipReader, probe_num_frames

    require_decoder()
    if not annotation_root:
        raise SystemExit("--videos requires --annotations <dir>")
    d = cfg.data
    stride = max(1, d.source_fps // d.fps)
    name_to_id = {n: i for i, n in enumerate(d.phase_names)}
    paths, counts, labels = [], [], []
    for fname in sorted(os.listdir(videos_dir), key=_natural_key):
        if not fname.endswith(VIDEO_SUFFIXES):
            continue
        vid = os.path.splitext(fname)[0]
        ann_path = os.path.join(annotation_root, f"{vid}-phase.txt")
        if not os.path.exists(ann_path):
            continue
        ann = read_phase_annotation(ann_path, name_to_id)
        raw = probe_num_frames(os.path.join(videos_dir, fname))
        n_sampled = -(-raw // stride)
        n = 0
        while n < n_sampled and stride * n in ann:
            n += 1
        if n == 0:
            print(f"warning: {fname}: annotations do not cover frame 0; "
                  f"skipping video", file=sys.stderr)
            continue
        if n < n_sampled:
            print(f"warning: {fname}: annotations end at sampled frame "
                  f"{n}/{n_sampled}; truncating", file=sys.stderr)
        paths.append(os.path.join(videos_dir, fname))
        counts.append(n)
        labels.append(np.asarray([ann[stride * k] for k in range(n)],
                                 np.int64))
    if not paths:
        raise SystemExit(f"no annotated videos found under {videos_dir}")
    reader = VideoClipReader(paths, counts, d.sequence_length, stride=stride)
    tf = (VideoTrainTransform(d.crop_size) if train
          else VideoEvalTransform(d.crop_size))
    return VideoClipDataset(reader, labels, transform=tf)


def frame_loader(cfg: ExperimentConfig):
    """The daemon's frame loader: a path (`<file>.npy#<idx>` or an image
    file) -> one transformed frame, uint8 under `data.device_normalize`,
    else normalized float32. Numpy and cv2 only: decode threads run it."""
    from tmrnet_torch.data.pipeline import load_frame

    tf = eval_transform(cfg)
    return lambda path: tf(np.stack([load_frame(path)]))[0]


def _card_precision(cfg: ExperimentConfig, device):
    """Returns `device` once f32 on it means f32: under
    model.compute_dtype=float32 on CUDA, TF32 goes off for cuDNN and cuBLAS
    (`device.set_precision`). A folded ResNet trunk then runs its identity
    blocks on the f32 bottleneck kernels (fused_bottleneck_f32,
    fused_bottleneck_tiled_f32: FFMA, no TF32)."""
    from tmrnet_torch.device import set_precision

    set_precision(cfg.model.compute_dtype, device)
    return device


def _mesh_for(cfg: ExperimentConfig, args, batch: Optional[int] = None,
              what: str = "data.batch_clips", grid: bool = False):
    """(the command's device, its mesh or None). Under mesh.multihost: join
    the process group before any other CUDA call
    (`eval/distributed.py::local_eval_mesh`), the device is the rank's, a
    `mesh` line on stderr names the rank, the world, the backend, the
    device and the rank's data and model indexes; a global batch `batch`
    (default data.batch_clips; 0: none) that does not divide over the data
    ranks (every rank, unless `grid`: the trainers') exits. Else: --device,
    and no mesh; mesh.model_parallel > 1 then exits, as the grid runs over
    processes."""
    from tmrnet_torch.device import resolve_device

    if not cfg.mesh.multihost:
        if cfg.mesh.model_parallel > 1:
            raise SystemExit(
                f"mesh.model_parallel={cfg.mesh.model_parallel}: the grid "
                f"runs one process a card; launch the ranks with --set "
                f"mesh.multihost=true (torchrun ... -m tmrnet_torch ...)")
        return _card_precision(cfg, resolve_device(args.device)), None
    from tmrnet_torch.eval.distributed import local_eval_mesh

    try:
        mesh = local_eval_mesh(cfg, args.device)
    except ValueError as e:
        raise SystemExit(str(e))
    _card_precision(cfg, mesh.device)
    print(json.dumps({"mesh": {"rank": mesh.rank, "world": mesh.world,
                               "backend": mesh.backend,
                               "device": str(mesh.device),
                               "data_index": mesh.data_index,
                               "model_index": mesh.model_index,
                               "shape": mesh.shape}}),
          file=sys.stderr, flush=True)
    if batch is None:
        batch = cfg.data.batch_clips
    ranks = mesh.dp if grid else mesh.world
    if batch and batch % ranks:
        raise SystemExit(f"{what}={batch} must be divisible by the "
                         f"{ranks} {'data ranks' if grid else 'processes'}; "
                         f"adjust {what}")
    return mesh.device, mesh


def _sp_devices(cfg: ExperimentConfig, args, what: str,
                allowed: bool = True, batches=()):
    """The devices of one process's shards under --set
    mesh.data_parallel=N (N > 1) without mesh.multihost: cuda:0 ..
    cuda:N-1, or N CPU shards with --device cpu; None without the
    setting (or under multihost, where N is the data axis of the grid).
    The shards are the video engines' sequence-parallel pass, the clip
    engine's batches and the stream engine's slots. `what` (a command
    that runs none of them) refuses it by name; a config key of
    `batches` whose batch does not divide by N exits naming it, and N
    above the visible cards exits."""
    from tmrnet_torch.device import resolve_device

    n = cfg.mesh.data_parallel
    if cfg.mesh.multihost or n in (-1, 1):
        return None
    if not allowed:
        raise SystemExit(
            f"{what} runs on one card in one process: mesh.data_parallel={n} "
            f"without mesh.multihost shards the work of `test`, `build-lfb`, "
            f"`parity`, `stream` and `serve` only (launch ranks with --set "
            f"mesh.multihost=true for the grid)")
    if n < 1:
        raise SystemExit(f"mesh.data_parallel={n}: want -1 or N >= 1")
    for key in batches:
        section, field = key.split(".")
        b = getattr(getattr(cfg, section), field)
        if b % n:
            raise SystemExit(f"{key}={b} must be divisible by "
                             f"mesh.data_parallel={n}; adjust {key}")
    dev = resolve_device(args.device)
    if dev.type == "cpu":
        return [dev] * n
    import torch

    have = torch.cuda.device_count()
    if n > have:
        raise SystemExit(f"mesh.data_parallel={n}: the in-process shards "
                         f"take one card each, and {have} are visible")
    return [torch.device("cuda", i) for i in range(n)]


def _round_slots(slots: int, devices) -> int:
    """The slot count rounded up to a multiple of the stream engine's
    devices (JAX :932-935): the surplus slots idle on blank frames."""
    n = len(devices) if devices else 1
    return -(-slots // n) * n


def _refuse_artifact_shards(args, devices) -> None:
    if args.artifact and devices:
        raise SystemExit(f"--artifact runs on the one device it was "
                         f"exported on: mesh.data_parallel={len(devices)} "
                         f"is not supported with it")


def _writes(mesh) -> bool:
    """Whether this process writes the outputs: rank 0, or no mesh."""
    return mesh is None or mesh.rank == 0


def cmd_prepare(args) -> int:
    """Decode each video under --videos, keep every --stride-th frame, cut
    its black margins and resize it to --size² (cv2's INTER_AREA): a PNG
    tree a video (frame<25*k>.png, the reference's layout) or, with
    --pack, one raw uint8 `<video>.npy` (`data/packed.py`), which
    `manifest --frames` reads alike. Videos run on --workers threads;
    the lines print in the videos' order."""
    from concurrent.futures import ThreadPoolExecutor

    from tmrnet_torch.data.manifests import _natural_key
    from tmrnet_torch.data.video import extract_frames, extract_frames_packed

    require_decoder()
    videos = sorted((f for f in os.listdir(args.videos)
                     if f.endswith(VIDEO_SUFFIXES)), key=_natural_key)
    if args.pack:
        os.makedirs(args.out, exist_ok=True)

    def one(v: str):
        name = os.path.splitext(v)[0]
        src = os.path.join(args.videos, v)
        if args.pack:
            out = os.path.join(args.out, name + ".npy")
            n = extract_frames_packed(src, out, stride=args.stride,
                                      size=args.size,
                                      cut_margin=not args.no_cutmargin)
            return name, n, out
        out = os.path.join(args.out, name)
        written = extract_frames(src, out, stride=args.stride,
                                 size=args.size,
                                 cut_margin=not args.no_cutmargin)
        return name, len(written), out

    # the decode and the resize release the GIL, so threads scale
    workers = args.workers or min(len(videos) or 1, os.cpu_count() or 1)
    with ThreadPoolExecutor(max_workers=workers) as pool:
        for name, n, out in pool.map(one, videos):
            print(f"{name}: {n} frames -> {out}")
    return 0


def cmd_manifest(args) -> int:
    """Walk frame directories and packed `.npy` videos with their phase
    annotations into a manifest: CSV by extension (or an extension-less
    --out under data.manifest_format 'csv'), else the reference's pickle,
    split in two by --train-videos."""
    from tmrnet_torch.data.manifests import (build_manifest_from_frames,
                                             save_csv_manifest,
                                             save_pickle_manifest,
                                             split_manifest)

    cfg = load_config(args)
    frames = args.frames or cfg.data.data_root
    annotations = args.annotations or cfg.data.annotation_root
    if not os.path.isdir(frames):
        raise SystemExit(f"frames dir not found: {frames} "
                         f"(pass --frames or set data.data_root)")
    m = build_manifest_from_frames(frames, annotations,
                                   phase_names(args.protocol),
                                   sample_stride=args.stride)
    print(f"{len(m.videos)} videos, {m.num_frames} frames")
    as_csv = (args.out.endswith(".csv")
              or (not args.out.endswith((".pkl", ".pickle"))
                  and cfg.data.manifest_format == "csv"))
    if as_csv:
        save_csv_manifest(args.out, m)
    elif args.train_videos:
        a, b = split_manifest(m, (0, args.train_videos),
                              (args.train_videos, len(m.videos)))
        save_pickle_manifest(args.out, a, b)
    else:
        save_pickle_manifest(args.out, m)
    print(f"wrote {args.out}")
    return 0


def cmd_synth(args) -> int:
    """Write the synthetic memory-dependent dataset of the learning-efficacy
    study (`data/synthetic.py`): packed `.npy` video splits and phase
    annotations, which `manifest --stride 1` and every command after it
    read unchanged; a JSON line with the task's memoryless ceiling."""
    from tmrnet_torch.data.synthetic import (MULTISCALE_PAIR, MULTISCALE_SEQ,
                                             MULTISCALE_SPEC,
                                             MULTISCALE_WINDOW,
                                             ambiguous_phases,
                                             check_multiscale_spec,
                                             frame_only_ceiling,
                                             multiscale_frame_only_ceiling,
                                             multiscale_pair_ceiling,
                                             write_synthetic_dataset)

    splits = {"train": args.train, "val": args.val, "test": args.test}
    splits = {k: v for k, v in splits.items() if v > 0}
    if not splits:
        raise SystemExit("nothing to generate: all of --train/--val/--test "
                         "are 0")
    dur = (args.dur_min, args.dur_max)
    if args.task == "multiscale":
        check_multiscale_spec()
        out = write_synthetic_dataset(args.out_dir, splits, seed=args.seed,
                                      hw=args.hw, task="multiscale")
        print(json.dumps({
            "out": out,
            "videos": sum(splits.values()),
            "task": "multiscale",
            "num_phases": len(MULTISCALE_SPEC),
            "seq": MULTISCALE_SEQ,
            "window": MULTISCALE_WINDOW,
            "designed_pair": list(MULTISCALE_PAIR),
            "pair_ceiling_setwise": multiscale_pair_ceiling(),
            "frame_only_ceiling": round(multiscale_frame_only_ceiling(), 4),
        }))
        return 0
    out = write_synthetic_dataset(args.out_dir, splits, seed=args.seed,
                                  num_phases=args.phases, dur_range=dur,
                                  hw=args.hw)
    print(json.dumps({
        "out": out,
        "videos": sum(splits.values()),
        "ambiguous_phases": ambiguous_phases()[: args.phases],
        "frame_only_ceiling": round(
            frame_only_ceiling(args.phases, args.seq, dur), 4),
    }))
    return 0


def cmd_pack(args) -> int:
    """Pack a manifest's frames into per-video raw uint8 `.npy` files and a
    manifest whose paths read them back (`<file>.npy#<idx>`,
    `data/packed.py`): image trees where cv2 decodes them, packed
    manifests anywhere. A pickle keeps its split structure; a `.csv` holds
    one split."""
    from tmrnet_torch.data.manifests import (load_csv_manifest,
                                             load_pickle_manifest,
                                             save_csv_manifest,
                                             save_pickle_manifest)
    from tmrnet_torch.data.packed import pack_manifest, split_packed_path

    if args.manifest.endswith(".csv"):
        splits = [load_csv_manifest(args.manifest)]
    else:
        primary, secondary = load_pickle_manifest(args.manifest)
        splits = [primary] + ([secondary] if secondary is not None else [])
    ids = [v.video_id for m in splits for v in m.videos]
    if len(set(ids)) != len(ids):
        dup = sorted({i for i in ids if ids.count(i) > 1})
        raise SystemExit(f"video ids shared across splits {dup}: their "
                         "packed .npy files would collide")
    packed = [pack_manifest(m, args.out_dir, workers=args.workers or None)
              for m in splits]
    if args.manifest_out.endswith(".csv"):
        if len(packed) > 1:
            raise SystemExit("a CSV manifest holds one split; pack the "
                             "6-list pickle to a .pkl instead")
        save_csv_manifest(args.manifest_out, packed[0])
    else:
        save_pickle_manifest(args.manifest_out, packed[0],
                             packed[1] if len(packed) > 1 else None)
    files = sorted({split_packed_path(p)[0]
                    for m in packed for p in m.flat_paths()})
    print(json.dumps({
        "videos": sum(len(m.videos) for m in packed),
        "frames": sum(m.num_frames for m in packed),
        "packed_files": len(files),
        "bytes": sum(os.path.getsize(f) for f in files),
        "manifest": args.manifest_out,
    }))
    return 0


def cmd_stats(args) -> int:
    """Channel mean and std of a manifest's frames (its train split, every
    --subsample-th frame): the reference's mean of per-image statistics
    over 224x224 PIL resizes, or with --population the statistics of all
    pixels pooled; --no-resize takes the frames as they are."""
    from concurrent.futures import ThreadPoolExecutor

    from tmrnet_torch.data.pipeline import load_frame
    from tmrnet_torch.data.stats import channel_stats, resize_224

    paths = load_manifest(args.manifest).flat_paths()[:: max(1, args.subsample)]

    def load(p):
        img = load_frame(p)
        return img if args.no_resize else resize_224(img)

    workers = args.workers or min(len(paths) or 1, os.cpu_count() or 1)
    per_image = not args.population
    if workers > 1:
        # the decode releases the GIL; the accumulator consumes in order
        with ThreadPoolExecutor(max_workers=workers) as pool:
            mean, std = channel_stats(pool.map(load, paths, chunksize=16),
                                      per_image=per_image)
    else:
        mean, std = channel_stats((load(p) for p in paths),
                                  per_image=per_image)
    print(json.dumps({"mean": mean.tolist(), "std": std.tolist(),
                      "frames": len(paths)}))
    return 0


def cmd_build_lfb(args) -> int:
    """The bank of a manifest, or of the videos under --videos, from the
    extractor's weights (head lfb: a `.pth`, or the trunk and LSTM of a
    port checkpoint, `--ckpt`), built by the video engine (default for a
    manifest; one backbone pass per frame) or the clip engine, which crop
    types outside 1/2/3 and --videos fall back to. Under mesh.multihost
    the clip engine splits each batch over the ranks and the video engine
    the videos; rank 0 writes the bank. Under mesh.data_parallel=N in one
    process the clip engine shards each batch over N devices and the
    video engine runs the sequence-parallel pass."""
    from tmrnet_torch.train.loop import build_lfb

    cfg = load_config(args)
    if not (args.manifest or args.videos):
        raise SystemExit("build-lfb needs --manifest or --videos")
    if args.engine is None:
        args.engine = ("clip" if args.videos
                       or cfg.data.test_crop_type not in (1, 2, 3)
                       else "video")
    if args.engine == "video" and args.videos:
        # before the dataset's probe and the weights' load
        raise SystemExit("build-lfb --engine video needs a frame manifest")
    devices = _sp_devices(cfg, args, "build-lfb", batches=(
        () if args.engine == "video" else ("data.batch_clips",)))
    device, mesh = _mesh_for(cfg, args, batch=(
        0 if args.engine == "video" else cfg.data.batch_clips))
    ds = (video_dataset(cfg, args.videos, args.annotations, False)
          if args.videos else dataset(cfg, load_manifest(args.manifest)))
    state = restore_state(cfg, "lfb", args.torch_ckpt, args.ckpt)
    extractor, = folded_weights(cfg, extractor_state(cfg, state))
    del state
    bank = build_lfb(cfg, extractor, ds, cache_path=args.out, force=True,
                     engine=args.engine, device=device, mesh=mesh,
                     devices=devices)
    if _writes(mesh):
        print(f"bank: {bank.num_rows} rows x {bank.feature_dim} -> "
              f"{args.out}")
    return 0


def _finish_training(hist, mesh=None) -> int:
    if not _writes(mesh):
        return 0
    if not hist:
        # preempted before the first epoch completed: the replay
        # checkpoint is saved; the same command resumes
        print("preempted before any completed epoch; checkpoint saved -- "
              "re-run to resume")
        return 0
    best = max(hist, key=lambda h: h.val_acc)
    print(f"best epoch {best.epoch}: val_acc={best.val_acc:.4f}")
    return 0


def _check_val_flags(args) -> None:
    """A trainer's val set comes from the source of its train set: frame
    manifests with --val-manifest, videos with --val-videos."""
    if args.videos and args.val_manifest:
        raise SystemExit("--val-manifest takes a frame manifest; with "
                         "--videos pass --val-videos DIR")
    if args.val_videos and not args.videos:
        raise SystemExit("--val-videos needs --videos (the train set's "
                         "videos)")


def _video_train_val(cfg: ExperimentConfig, args):
    """A trainer's (train, val or None) video-direct datasets."""
    return (video_dataset(cfg, args.videos, args.annotations, True),
            video_dataset(cfg, args.val_videos, args.annotations, False)
            if args.val_videos else None)


def cmd_train_bank(args) -> int:
    """Stage-1 training on a manifest's train split, validated on
    --val-manifest (or the manifest's second split, else the same clips),
    or on the videos under --videos, validated on --val-videos (no val set
    without it); fresh flax-distributed weights, or a reference `.pth`
    over them (--torch-init)."""
    from tmrnet_torch.train.loop import train_stage1
    from tmrnet_torch.utils.logging import MetricLogger

    cfg = load_config(args)
    _check_val_flags(args)
    _sp_devices(cfg, args, "train-bank", allowed=False)
    device, mesh = _mesh_for(cfg, args, grid=True)     # before the logger
    if args.videos:
        train_ds, val_ds = _video_train_val(cfg, args)
    else:
        path = args.train_manifest or cfg.data.manifest_path
        train_ds = train_dataset(cfg, load_manifest(path))
        val_ds = dataset(cfg, load_manifest(args.val_manifest or path,
                                            "val"))
    init = None
    if args.torch_init:
        init = init_with(cfg, "stage1", reference_weights(cfg, "stage1",
                                                          args.torch_init))
    _, hist = train_stage1(cfg, train_ds, val_ds, init_state_dict=init,
                           mesh=mesh, log=MetricLogger(args.log_dir),
                           device=device)
    return _finish_training(hist, mesh)


def cmd_train_tmr(args) -> int:
    """Stage-2 training of model.head (tmr, or nl_only) over the train
    split's bank (--lfb), validated on --val-manifest over --val-lfb, or
    on the videos under --videos, validated on --val-videos; from a fresh
    init with a stage-1 checkpoint's trunk and LSTM
    transplanted (--stage1-ckpt) or a reference `.pth` over it
    (--torch-init)."""
    from tmrnet_torch.memory.lfb import load_bank
    from tmrnet_torch.train.loop import train_stage2
    from tmrnet_torch.utils.logging import MetricLogger

    cfg = load_config(args)
    _check_val_flags(args)
    _sp_devices(cfg, args, "train-tmr", allowed=False)
    device, mesh = _mesh_for(cfg, args, grid=True)     # before the logger
    head = cfg.model.head if cfg.model.head in ("tmr", "nl_only") else "tmr"
    if args.videos:
        train_ds, val_ds = _video_train_val(cfg, args)
    else:
        train_ds = train_dataset(cfg, load_manifest(
            args.train_manifest or cfg.data.manifest_path))
        val_ds = (dataset(cfg, load_manifest(args.val_manifest, "val"))
                  if args.val_manifest else None)
    bank = load_bank(args.lfb, device=device,
                     seq_len=cfg.data.sequence_length,
                     video_lengths=train_ds.manifest.video_lengths)
    val_bank = load_bank(args.val_lfb, device=device) if args.val_lfb else None
    init = None
    if args.torch_init:
        init = init_with(cfg, head, reference_weights(cfg, head,
                                                      args.torch_init))
    elif args.stage1_ckpt:
        # the stage-1 trunk and LSTM over a fresh head (the reference's
        # strict=False bootstrap, `train_non-local_mutiConv_resnet.py:707`)
        s1 = checkpoint_weights(args.stage1_ckpt)
        init = init_with(cfg, head, {k: v for k, v in s1.items()
                                     if k.startswith(("backbone.",
                                                      "encoder."))})
    _, hist = train_stage2(cfg, train_ds, bank, val_ds, val_bank,
                           init_state_dict=init, mesh=mesh,
                           log=MetricLogger(args.log_dir), device=device)
    return _finish_training(hist, mesh)


def _video_engine_results(cfg, state, extractor, manifest, device,
                          mesh=None, devices=None):
    """`test --engine video|corpus`: every video's (preds, probs) from a
    VideoInference, the whole set as one stream (eval.corpus), same-bucket
    groups of eval.video_batch videos, or one video at a time; under a
    mesh, the corpus engine over each rank's videos, gathered; over
    `devices`, the sequence-parallel pass."""
    from tmrnet_torch.data.pipeline import load_frame
    from tmrnet_torch.eval.distributed import run_corpus_distributed
    from tmrnet_torch.eval.infer import VideoInference

    tf = eval_transform(cfg)

    def load_video(video):
        return tf(np.stack([load_frame(p) for p in video.frame_paths]))

    videos = manifest.videos
    if mesh is not None:
        return run_corpus_distributed(
            cfg, state, extractor, [len(v) for v in videos],
            lambda i: load_video(videos[i]), mesh=mesh)
    engine = VideoInference(cfg, state, extractor, device=device,
                            devices=devices)
    if cfg.eval.corpus:
        return engine.run_corpus([(lambda v=v: load_video(v)) for v in videos],
                                 lengths=[len(v) for v in videos],
                                 chunk=cfg.eval.corpus_chunk)
    vb = max(1, cfg.eval.video_batch)
    if vb == 1:
        return [engine.run_video(load_video(v)) for v in videos]
    results = [None] * len(videos)
    groups = {}
    for vi, video in enumerate(videos):
        groups.setdefault(engine.bucket_frames(len(video)), []).append(vi)
    for _, vis in sorted(groups.items()):
        for c in range(0, len(vis), vb):
            chunk = vis[c:c + vb]
            outs = engine.run_videos([load_video(videos[vi]) for vi in chunk])
            for vi, out in zip(chunk, outs):
                results[vi] = out
    return results


def cmd_test(args) -> int:
    """Score a manifest: predictions `.npz` (preds, scores, rows), the
    reference's prediction pickles with --ref-pickle, and a JSON line of
    clip accuracy and per-class precision/recall. Engines: clip (over a
    bank read from --lfb or built), video and corpus (the bank built in the
    same pass); the default is corpus, clip for crop types 0/5/10,
    memory.compat_cross_video, --lfb or --load-lfb, and for a memoryless
    head (stage1). Under mesh.multihost only the corpus engine runs, its
    videos partitioned over the ranks (`eval/distributed.py`); rank 0
    writes the outputs. Under mesh.data_parallel=N in one process the
    clip engine (and its bank build) shards each batch over N devices,
    the video engines run the sequence-parallel pass."""
    from tmrnet_torch.eval.infer import (ClipInference, InferenceResult,
                                         memoryless_head)
    from tmrnet_torch.eval.metrics import classification_metrics
    from tmrnet_torch.memory.lfb import load_bank
    from tmrnet_torch.train.loop import build_lfb

    cfg = load_config(args)
    try:
        memoryless = memoryless_head(cfg.model.head)
    except ValueError as e:
        raise SystemExit(str(e))
    if memoryless:
        if args.engine not in (None, "clip"):
            raise SystemExit(
                f"--engine {args.engine} runs the memory head; "
                f"model.head={cfg.model.head} scores with --engine clip")
        if args.lfb or args.load_lfb:
            raise SystemExit(
                f"model.head={cfg.model.head} is frame-only and cannot "
                "consume --lfb/--load-lfb; drop the bank flags or set "
                "--set model.head=tmr|nl_only")
        args.engine = "clip"
    if args.engine is None:
        args.engine = ("clip" if (cfg.data.test_crop_type not in (1, 2, 3)
                                  or cfg.memory.compat_cross_video
                                  or args.lfb or args.load_lfb)
                       else "corpus")
    if cfg.mesh.multihost and args.engine != "corpus":
        raise SystemExit(
            "test under mesh.multihost runs --engine corpus only (the videos "
            "are partitioned over the processes; the other engines run in "
            "one process)")
    if args.engine == "corpus":
        cfg = cfg.replace(eval=dataclasses.replace(cfg.eval, corpus=True))
        args.engine = "video"
    if args.engine == "video":
        if cfg.data.test_crop_type not in (1, 2, 3):
            raise SystemExit(
                f"--engine video/corpus needs a deterministic frame-wise "
                f"crop (test_crop_type 1/2/3, got "
                f"{cfg.data.test_crop_type}); use --engine clip")
        if cfg.memory.compat_cross_video:
            raise SystemExit(
                "--engine video builds per-video memory windows; the "
                "reference cross-video quirk (memory.compat_cross_video) "
                "requires --engine clip")
    builds = (args.engine == "clip" and not memoryless
              and not (args.lfb and os.path.exists(args.lfb)))
    devices = _sp_devices(cfg, args, "test", batches=(
        () if args.engine == "video" else ("eval.batch_clips",)
        + (("data.batch_clips",) if builds else ())))
    device, mesh = _mesh_for(cfg, args, batch=0)
    m = load_manifest(args.manifest)
    seq = cfg.data.sequence_length
    labels = clip_labels(m, seq)
    state = restore_state(cfg, cfg.model.head, args.torch_ckpt, args.ckpt)
    if args.engine == "video":
        state, extractor = folded_weights(
            cfg, state, extractor_for(cfg, state, args))
        results = _video_engine_results(cfg, state, extractor, m, device,
                                        mesh, devices)
        preds = np.concatenate([r[0] for r in results])
        res = InferenceResult(
            preds=preds, scores=np.concatenate([r[1] for r in results]),
            rows=np.arange(len(preds)),
            accuracy=float((preds == labels).mean()) if preds.size else 0.0)
    else:
        ds = dataset(cfg, m)
        bank = None
        if not memoryless and args.lfb and os.path.exists(args.lfb):
            bank = load_bank(args.lfb, device=device, seq_len=seq,
                             video_lengths=m.video_lengths)
        elif not memoryless:
            extractor, = folded_weights(
                cfg, extractor_for(cfg, state, args))
            bank = build_lfb(cfg, extractor, ds, cache_path=args.lfb,
                             force=not args.load_lfb, device=device,
                             devices=devices)
            del extractor
        state, = folded_weights(cfg, state)
        res = ClipInference(cfg, state, bank, device=device,
                            devices=devices).run(ds)
    if not _writes(mesh):
        return 0
    np.savez(args.out, preds=res.preds, scores=res.scores, rows=res.rows)
    if args.ref_pickle:
        # the reference's pair (`test_..._2fc_copy.py:421-450`): the
        # predictions, and the max softmax probability of each clip
        with open(args.ref_pickle, "wb") as f:
            pickle.dump([int(x) for x in res.preds], f)
        with open(args.ref_pickle + ".score.pkl", "wb") as f:
            pickle.dump([float(x) for x in res.scores.max(axis=1)], f)
    cm = classification_metrics(labels, res.preds, cfg.model.num_classes)
    print(json.dumps({
        "clip_accuracy": res.accuracy,
        "num_clips": int(res.preds.size),
        "precision_per_class": np.round(cm["precision"], 4).tolist(),
        "recall_per_class": np.round(cm["recall"], 4).tolist(),
        "out": args.out,
    }))
    return 0


def _stream_artifact_engine(args, cfg: ExperimentConfig):
    """(the `ArtifactStreamEngine` of --artifact, the config it was
    exported with, which replaces `cfg`). The artifact holds both trunks,
    so an extractor flag is an error, and runs on the one device it was
    exported on: `--device` must name its kind, and `mesh.multihost` is
    refused. Precision follows the artifact's recorded compute_dtype on
    its device (`device.set_precision`: TF32 off for an f32 artifact on
    the card). A file that does not load exits and names `doctor
    --artifact`."""
    from tmrnet_torch.device import resolve_device, set_precision
    from tmrnet_torch.eval.saved import ArtifactStreamEngine, load_artifact

    device = resolve_device(args.device)
    if args.extractor_ckpt or args.extractor_torch_ckpt:
        raise SystemExit("--artifact holds the extractor too; drop "
                         "--extractor-ckpt / --extractor-torch-ckpt")
    if cfg.mesh.multihost:
        raise SystemExit("--artifact runs on the one device it was exported "
                         "on; mesh.multihost is not supported with it")
    try:
        engine = ArtifactStreamEngine(load_artifact(args.artifact))
    except ValueError:
        raise
    except Exception as e:
        raise SystemExit(
            f"--artifact {args.artifact}: not a loadable artifact ({e}); "
            "preflight with `doctor --artifact` -- re-export if the torch "
            "version changed (the sidecar records the producer)")
    if engine.device.type != device.type:
        raise SystemExit(f"--artifact {args.artifact} was exported for "
                         f"{engine.device}; --device is {device}")
    if engine.meta.get("config"):
        cfg = ExperimentConfig.from_json(json.dumps(engine.meta["config"]))
    # the artifact's dtype, not the command line's: an f32 step on the card
    # runs cuDNN with TF32 off, as the engine it was exported from did
    set_precision(engine.meta["compute_dtype"], engine.device)
    return engine, cfg


def cmd_stream(args) -> int:
    """Online streaming inference: every manifest video plays as a 1-fps
    stream through eval/stream.py's StreamingInference, one frame a stream
    a step, over --max-streams slots; a finished video's slot takes the
    next video (reset_streams). Writes one JSONL row a (video, frame),
    valid from the stream's first full clip on, where the predictions
    equal `test --engine video`'s; prints a summary line.

    Under mesh.multihost (JAX :860-870, :994-1038) the videos are
    partitioned over the ranks (`eval/distributed.py::partition_videos`),
    each rank streams its own on its card, and rank 0 writes the gathered
    rows grouped by video in manifest order (the interleaving of a
    one-process run's steps is a rank's own). With --artifact the model
    is the exported step (`eval/saved.py`) over its slot count; surplus
    slots idle on blank frames. Under mesh.data_parallel=N in one process
    the slots split over N devices, their count rounded up to a multiple
    of N (the surplus idle on blank frames, as JAX's)."""
    from collections import deque

    from tmrnet_torch.data.pipeline import load_frame
    from tmrnet_torch.eval.distributed import partition_videos
    from tmrnet_torch.eval.stream import StreamingInference

    cfg = load_config(args)
    devices = _sp_devices(cfg, args, "stream")
    _refuse_artifact_shards(args, devices)
    engine = mesh = None
    if args.artifact:
        engine, cfg = _stream_artifact_engine(args, cfg)
    else:
        device, mesh = _mesh_for(cfg, args, batch=0)
    if cfg.data.test_crop_type not in (1, 2, 3):
        raise SystemExit(
            "stream needs a deterministic frame-wise crop (test_crop_type "
            f"1/2/3, got {cfg.data.test_crop_type}): multi-crop and per-clip "
            "random crops have no streaming equivalent")
    m = load_manifest(args.manifest)
    n_videos = len(m.videos)
    if n_videos == 0:
        raise SystemExit("manifest has no videos")
    if engine is None:
        state = restore_state(cfg, cfg.model.head, args.torch_ckpt,
                              args.ckpt)
        state, extractor = folded_weights(
            cfg, state, extractor_for(cfg, state, args))
        engine = StreamingInference(cfg, state, extractor, device=device,
                                    devices=devices)
        del state, extractor

    tf = eval_transform(cfg)
    seq = cfg.data.sequence_length
    lengths = [len(v) for v in m.videos]
    if args.max_steps:
        lengths = [min(n, args.max_steps) for n in lengths]
    my_videos = list(range(n_videos))
    if mesh is not None:
        my_videos = partition_videos(lengths, mesh.world)[mesh.rank]
        # every frame's prediction, -1 where none, merged at the end
        dist_preds = {v: np.full(lengths[v], -1, np.int64)
                      for v in my_videos}
    # Videos queue for the slots, one slot a video under -1; 64 by default
    # bounds the decoded videos held in host memory.
    n_mine = max(len(my_videos), 1)
    max_streams = n_mine if args.max_streams < 0 else args.max_streams
    num_slots = (engine.slots if args.artifact else
                 _round_slots(min(max_streams or n_mine, n_mine), devices))
    stream = engine.init_state(num_slots)

    # A video is decoded, only its streamed prefix, when its slot starts,
    # and freed when it ends.
    loaded = {}

    def assign(v: int) -> int:
        paths = m.videos[v].frame_paths[: lengths[v]]
        loaded[v] = tf(np.stack([load_frame(p) for p in paths]))
        return v

    pending = deque(my_videos)
    slot_video = [assign(pending.popleft()) if pending else -1
                  for _ in range(num_slots)]
    slot_t = [0] * num_slots
    blank = (np.zeros_like(next(iter(loaded.values()))[0]) if loaded
             else None)
    correct = total = steps = 0
    with (open(args.out, "w") if mesh is None
          else contextlib.nullcontext()) as f:
        while any(v >= 0 for v in slot_video):
            frames = np.stack([loaded[v][slot_t[i]] if v >= 0 else blank
                               for i, v in enumerate(slot_video)])
            stream, preds, _, valid = engine.step(stream, frames)
            preds, valid = preds.cpu().numpy(), valid.cpu().numpy()
            steps += 1
            reset = [False] * num_slots
            for i, v in enumerate(slot_video):
                if v < 0:
                    continue
                t, video = slot_t[i], m.videos[v]
                ok = bool(valid[i]) and t >= seq - 1
                if f is not None:
                    f.write(json.dumps({
                        "video": video.video_id, "frame": t,
                        "pred": int(preds[i]) if ok else None,
                        "valid": ok}) + "\n")
                elif ok:
                    dist_preds[v][t] = int(preds[i])
                if ok:
                    correct += int(preds[i] == video.labels[t])
                    total += 1
                slot_t[i] += 1
                if slot_t[i] >= lengths[v]:     # done: recycle the slot
                    reset[i] = True
                    del loaded[v]
                    slot_video[i] = (assign(pending.popleft())
                                     if pending else -1)
                    slot_t[i] = 0
            if any(reset):
                stream = engine.reset_streams(stream, reset)
    summary = {"streams": n_videos, "slots": num_slots, "steps": int(steps)}
    if mesh is not None:
        correct, total = _merge_streams(args.out, m, lengths, dist_preds,
                                        mesh)
        if not _writes(mesh):
            return 0
        summary["processes"] = mesh.world
    acc = correct / total if total else 0.0
    print(json.dumps({**summary, "clip_accuracy": round(acc, 6),
                      "predictions": total, "out": args.out}))
    return 0


def _merge_streams(out: str, manifest, lengths, dist_preds, mesh):
    """The ranks' per-frame predictions (-1: none) gathered; rank 0
    writes the JSONL grouped by video in manifest order. Returns
    (correct, predictions) over every video."""
    from tmrnet_torch.eval.distributed import (gather_video_results, owners,
                                               partition_videos)

    parts = partition_videos(lengths, mesh.world)
    local = {v: (p, np.zeros((len(p), 1), np.float32))
             for v, p in dist_preds.items()}
    merged = gather_video_results(local, owners(parts, len(lengths)),
                                  lengths, seq_len=1, num_classes=1,
                                  mesh=mesh)
    correct = total = 0
    with (open(out, "w") if _writes(mesh)
          else contextlib.nullcontext()) as f:
        for v, (preds, _) in enumerate(merged):
            video = manifest.videos[v]
            for t in range(lengths[v]):
                ok = bool(preds[t] >= 0)
                if f is not None:
                    f.write(json.dumps({
                        "video": video.video_id, "frame": t,
                        "pred": int(preds[t]) if ok else None,
                        "valid": ok}) + "\n")
                if ok:
                    correct += int(preds[t] == video.labels[t])
                    total += 1
    return correct, total


def cmd_serve(args) -> int:
    """Serving daemon: JSONL protocol on stdin/stdout, or over TCP with
    --listen, over B stream slots (eval/serve.py). Streams join on their
    first frame, leave on "end", and any number of them multiplex onto the
    fixed slots; `{"step": true}` runs one tick. With --artifact the
    model, the slot count and the config are the artifact's
    (`eval/saved.py`). Under mesh.data_parallel=N the slots split over N
    devices of this process, --slots rounded up to a multiple of N; the
    daemon is one process, so mesh.multihost exits, and
    mesh.model_parallel > 1 exits as on every command."""
    if args.listen and args.input != "-":
        # fail before the (slow) weight restore and engine build
        raise SystemExit("--listen and --input are exclusive "
                         "(TCP clients replace the input file)")
    from tmrnet_torch.eval.serve import serve_loop
    from tmrnet_torch.eval.stream import StreamingInference

    cfg = load_config(args)
    if cfg.mesh.multihost:
        # JAX's StreamingInference refuses a mesh over processes
        raise SystemExit("serve runs in one process (its stream engine "
                         "takes no mesh over processes): drop "
                         "mesh.multihost, or shard its slots over this "
                         "process's cards with mesh.data_parallel=N")
    devices = _sp_devices(cfg, args, "serve")
    _refuse_artifact_shards(args, devices)
    device, _ = _mesh_for(cfg, args, batch=0)
    engine, num_slots = None, _round_slots(args.slots, devices)
    if args.artifact:
        engine, cfg = _stream_artifact_engine(args, cfg)
        num_slots = engine.slots
        if args.slots not in (0, num_slots):
            print(json.dumps({"note": f"--slots {args.slots} ignored: the "
                              f"artifact was exported with {num_slots} "
                              "slots"}), file=sys.stderr, flush=True)
    if cfg.data.test_crop_type not in (1, 2, 3):
        raise SystemExit(
            "serve needs a deterministic frame-wise crop (test_crop_type "
            f"1/2/3, got {cfg.data.test_crop_type}): multi-crop and per-clip "
            "random crops have no streaming equivalent")
    if engine is None:
        state = restore_state(cfg, cfg.model.head, args.torch_ckpt,
                              args.ckpt)
        state, extractor = folded_weights(
            cfg, state, extractor_for(cfg, state, args))
        engine = StreamingInference(cfg, state, extractor, device=device,
                                    devices=devices)
        del state, extractor

    server = None
    if args.listen:
        from tmrnet_torch.eval.serve_net import JsonlTcpServer

        host, _, port = args.listen.rpartition(":")
        server = JsonlTcpServer(host or "127.0.0.1", int(port))
        # advertise the bound address (port may have been 0 = ephemeral)
        print(json.dumps({"listening": {"host": server.host,
                                        "port": server.port}}),
              file=sys.stderr, flush=True)

    # SIGTERM (the standard daemon shutdown) must unwind through
    # serve_loop's finally so the state checkpoint is written — but never
    # mid-tick, where it would checkpoint half-updated bookkeeping; the
    # guard defers the exit to the tick boundary. SIGINT alike.
    guard = {"busy": False, "stop": False}

    def _on_term(*_):
        if guard["busy"]:
            guard["stop"] = True
            if server is not None:
                server.stop()   # unblock lines() so the boundary arrives
        else:
            sys.exit(0)

    signal.signal(signal.SIGTERM, _on_term)
    signal.signal(signal.SIGINT, _on_term)

    d = cfg.data
    in_f = sys.stdin if args.input == "-" else open(args.input)
    try:
        summary = serve_loop(
            engine, num_slots,
            server.lines() if server is not None else in_f,
            server if server is not None else sys.stdout,
            frame_loader(cfg),
            emit_probs=args.probs,
            # build and load the kernels at startup, not on the first
            # request, on frames of the wire's dtype
            warmup_shape=(None if args.no_warmup
                          else (d.crop_size, d.crop_size, 3)),
            warmup_dtype=np.uint8 if d.device_normalize else np.float32,
            state_dir=args.state_dir,
            checkpoint_every=args.checkpoint_every,
            term_guard=guard,
            decode_workers=args.decode_workers,
            decode_timeout=args.decode_timeout,
            tick_interval=args.tick_interval,
            idle_ticks=args.idle_ticks,
            stats_every=args.stats_every,
            # readiness: the warmup is done, steady-state latency from
            # here — probes should key on this line, not on "listening"
            on_ready=lambda: print(json.dumps({"ready": True}),
                                   file=sys.stderr, flush=True))
    finally:
        if server is not None:
            server.stop()
        if in_f is not sys.stdin:
            in_f.close()
    print(json.dumps({"summary": summary}), file=sys.stderr)
    return 0



def protocol_json(rep) -> Dict:
    """The keys of a ProtocolReport that `parity` and `evaluate` write."""
    return {
        "mean_accuracy": rep.mean_accuracy,
        "std_accuracy": rep.std_accuracy,
        "mean_jaccard": rep.mean_jaccard,
        "std_jaccard": rep.std_jaccard,
        "mean_precision": rep.mean_precision,
        "mean_recall": rep.mean_recall,
        "jaccard_per_phase": rep.jaccard_per_phase.tolist(),
    }


def cmd_parity(args) -> int:
    """One command from a reference .pth and frames to the Main.m protocol
    table: the bank from the extractor's weights (the clip engine), clip
    inference over the reference's memory windows (which cross video
    boundaries, memory.compat_cross_video, unless --set says otherwise),
    the phase trees exported, and the relaxed-boundary scoring under
    --protocol, else the config's eval.protocol (JAX's parity reads only
    --protocol, so a preset's m2cai would score as cholec80 there). Under
    mesh.data_parallel=N the bank build and the clip engine shard each
    batch over N devices of this process; it runs in one process, so
    mesh.multihost exits."""
    from tmrnet_torch.eval.export import export_predictions, load_exported
    from tmrnet_torch.eval.infer import ClipInference
    from tmrnet_torch.eval.metrics import evaluate_protocol
    from tmrnet_torch.train.loop import build_lfb

    cfg = load_config(args)
    if cfg.mesh.multihost:
        raise SystemExit("parity runs in one process (its clip engine takes "
                         "no mesh over processes): drop mesh.multihost, or "
                         "shard its batches over this process's cards with "
                         "mesh.data_parallel=N")
    devices = _sp_devices(cfg, args, "parity", batches=(
        "eval.batch_clips", "data.batch_clips"))
    device, _ = _mesh_for(cfg, args, batch=0)
    protocol = args.protocol or cfg.eval.protocol
    if not any(o.startswith("memory.compat_cross_video")
               for o in args.set or []):
        cfg = cfg.replace(memory=dataclasses.replace(
            cfg.memory, compat_cross_video=True))
    m = load_manifest(args.manifest)
    ds = dataset(cfg, m)
    state = restore_state(cfg, cfg.model.head, args.torch_ckpt)
    extractor, = folded_weights(
        cfg, extractor_for(cfg, state, args))
    os.makedirs(args.workdir, exist_ok=True)
    bank = build_lfb(cfg, extractor, ds,
                     cache_path=args.lfb or os.path.join(args.workdir,
                                                         "lfb.npz"),
                     force=not args.load_lfb, device=device,
                     devices=devices)
    del extractor
    state, = folded_weights(cfg, state)
    res = ClipInference(cfg, state, bank, device=device,
                        devices=devices).run(ds)
    np.savez(os.path.join(args.workdir, "predictions.npz"),
             preds=res.preds, scores=res.scores, rows=res.rows)
    pred_dir = os.path.join(args.workdir, "phase")
    gt_dir = os.path.join(args.workdir, "gt-phase")
    export_predictions(m, res.preds, cfg.data.sequence_length,
                       pred_dir=pred_dir, gt_dir=gt_dir,
                       fps=cfg.eval.export_fps)
    gts, preds = load_exported(pred_dir, gt_dir,
                               [v.video_id for v in m.videos],
                               phase_names=phase_names(protocol))
    rep = evaluate_protocol(gts, preds, protocol=protocol, quirk_compat=True)
    print(rep.format_table())
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump({"clip_accuracy": res.accuracy, **protocol_json(rep)},
                      f, indent=2)
    return 0


def stream_predictions(path: str, manifest) -> np.ndarray:
    """The valid rows of a `stream` JSONL as clip predictions in bank-row
    order (video-major, frame-ascending)."""
    by_video = {}
    with open(path) as f:
        for line in f:
            r = json.loads(line)
            if r.get("valid"):
                by_video.setdefault(r["video"], []).append(
                    (r["frame"], r["pred"]))
    parts = [np.asarray([p for _, p in sorted(by_video.get(v.video_id, []))],
                        np.int64) for v in manifest.videos]
    return np.concatenate(parts) if parts else np.zeros(0, np.int64)


def cmd_export(args) -> int:
    """Predictions -> per-video phase files (and the gt tree): a `test`
    `.npz`, a `stream` `.jsonl` or a reference test script's pickle."""
    from tmrnet_torch.eval.export import export_predictions

    cfg = load_config(args)
    m = load_manifest(args.manifest)
    if args.preds.endswith(".jsonl"):
        preds = stream_predictions(args.preds, m)
    elif args.preds.endswith((".pkl", ".pickle")):
        # The reference's test script writes its per-clip predictions with
        # pickle.dump, a list of 0-d torch tensors (`test_..._2fc_copy.py:
        # 424,443-450`), not with torch.save, so torch.load cannot read
        # it: plain pickle does, as in JAX. It runs what the file names, so
        # read only files you trust.
        with open(args.preds, "rb") as f:
            obj = pickle.load(f)
        preds = np.asarray([int(np.asarray(v)) for v in obj], np.int64)
    else:
        preds = np.load(args.preds)["preds"]
    stats = export_predictions(m, preds, cfg.data.sequence_length,
                               pred_dir=args.pred_dir or cfg.eval.pred_dir,
                               gt_dir=args.gt_dir or cfg.eval.gt_dir,
                               fps=cfg.eval.export_fps,
                               video_name_fmt=args.name_fmt)
    print(json.dumps(stats))
    return 0


def cmd_evaluate(args) -> int:
    """Relaxed-boundary protocol scoring of exported phase trees: the
    table of Main.m, and with --json-out its numbers."""
    import re

    from tmrnet_torch.eval.export import load_exported
    from tmrnet_torch.eval.metrics import evaluate_protocol

    cfg = load_config(args)
    pred_dir = args.pred_dir or cfg.eval.pred_dir
    gt_dir = args.gt_dir or cfg.eval.gt_dir
    protocol = args.protocol or cfg.eval.protocol
    relaxed = (args.relaxed_seconds if args.relaxed_seconds is not None
               else cfg.eval.relaxed_seconds)
    video_ids = args.videos or sorted(
        f[: -len("-phase.txt")] for f in os.listdir(gt_dir)
        if f.endswith("-phase.txt"))
    # Main.m and Main_m2cai.m iterate a numeric range of videos (41:80,
    # 1:14); --video-range, or eval.test_videos of a --preset or --config,
    # selects the same from the gt listing. An id without a trailing
    # number is outside every range.
    vrange = args.video_range or (
        tuple(cfg.eval.test_videos) if (args.preset or args.config) else None)
    if not args.videos and vrange:
        def num(vid):
            found = re.search(r"(\d+)\D*$", vid)
            return int(found.group(1)) if found else None

        video_ids = [v for v in video_ids
                     if num(v) is not None and vrange[0] <= num(v) <= vrange[1]]
        if not video_ids:
            raise SystemExit(
                f"no videos in {gt_dir} fall in range {vrange}; "
                f"pass --videos or widen --video-range")
    gts, preds = load_exported(pred_dir, gt_dir, video_ids,
                               phase_names=phase_names(protocol),
                               matlab_compat=args.matlab_compat)
    rep = evaluate_protocol(gts, preds, protocol=protocol, fps=args.fps,
                            quirk_compat=not args.no_quirk,
                            relaxed_seconds=relaxed)
    print(rep.format_table())
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump({
                **protocol_json(rep),
                "precision_per_phase": rep.precision_per_phase.tolist(),
                "recall_per_phase": rep.recall_per_phase.tolist(),
                "accuracy_per_video": rep.accuracy_per_video.tolist(),
                "videos": list(video_ids),
            }, f, indent=2)
    return 0


def cmd_export_ckpt(args) -> int:
    """The port's checkpoint (its best, else its newest step) ->
    reference-format .pth of head model.head, which the reference's
    tooling loads with a plain load_state_dict and `--torch-ckpt` reads
    back."""
    import torch

    from tmrnet_torch.models.torch_import import export_reference_checkpoint

    cfg = load_config(args)
    head = cfg.model.head
    state = restore_state(cfg, head, ckpt=args.ckpt)
    sd = export_reference_checkpoint(state, head, cfg.model.stage_sizes)
    torch.save(sd, args.out)
    print(f"wrote {args.out} ({len(sd)} tensors, head={head})")
    return 0


def cmd_export_model(args) -> int:
    """The inference step with the weights held in it, exported through
    `torch.export` (`eval/saved.py`): a deployment host runs it with
    torch and the port's kernels, no model code and no checkpoint load.
    The reference re-instantiates the model from source and loads a .pth
    every run (`test_..._2fc_copy.py:371-379`). --stream exports the serve
    daemon's step (both trunks, the rings, the head), which `serve
    --artifact` and `stream --artifact` run; BN folds there under --set
    model.folded=true, as `serve` folds it."""
    from tmrnet_torch.device import resolve_device
    from tmrnet_torch.eval.saved import (export_inference, export_stream,
                                         save_artifact)

    cfg = load_config(args)
    device = _card_precision(cfg, resolve_device(args.device))
    head = cfg.model.head
    if args.stream:
        if head not in ("tmr", "nl_only"):
            raise SystemExit(f"--stream needs a memory head (tmr/nl_only), "
                             f"got {head!r}")
        if args.fold_bn:
            raise SystemExit("--fold-bn is not supported with --stream; "
                             "fold the stream step's two trunks with --set "
                             "model.folded=true, as serve does")
        state = restore_state(cfg, head, args.torch_ckpt, args.ckpt)
        state, extractor = folded_weights(
            cfg, state, extractor_for(cfg, state, args))
        batch = args.slots
        program, meta = export_stream(cfg, state, extractor, batch, device)
    else:
        if args.fold_bn:
            # BN is an affine map at inference: folded into the convs, the
            # artifact holds no BN op (models/fold_bn.py)
            cfg = cfg.replace(model=dataclasses.replace(cfg.model,
                                                        folded=True))
        state, = folded_weights(
            cfg, restore_state(cfg, head, args.torch_ckpt, args.ckpt))
        batch = args.batch or cfg.eval.batch_clips
        program, meta = export_inference(cfg, state, batch, device)
    nbytes = save_artifact(args.out, program, meta)
    print(json.dumps({"out": args.out, "bytes": nbytes, "head": head,
                      "kind": meta.get("kind", "clip"), "batch": batch,
                      "device": meta["device"], "inputs": meta["inputs"]}))
    return 0


def doctor_smoke(device) -> List:
    """(op, max |op - plain|, max |plain|) for each of the four ops of
    `torch.ops.tmrnet` launched once on `device` at a small legal shape
    (bf16, seeded), against its plain version in f32 on the CPU."""
    import torch

    from tmrnet_torch.experimental.fused_bottleneck import fused_bottleneck
    from tmrnet_torch.experimental.fused_bottleneck_tiled import \
        fused_bottleneck_tiled
    from tmrnet_torch.ops.nl_attention import nl_attention_op
    from tmrnet_torch.ops.time_conv import time_conv_op

    gen = torch.Generator().manual_seed(0)
    rand = lambda *shape, scale=1.0: torch.randn(*shape, generator=gen) * scale
    weights = lambda c, p: (rand(c, p, scale=c ** -0.5), rand(p, scale=0.1),
                            rand(3, 3, p, p, scale=(9 * p) ** -0.5),
                            rand(p, scale=0.1), rand(p, c, scale=p ** -0.5),
                            rand(c, scale=0.1))
    conv = [t for k in (3, 5, 7)
            for t in (rand(k, 512, 512, scale=(k * 512) ** -0.5),
                      rand(512, scale=0.1))]
    block = (torch.relu(rand(2, 14, 14, 256)), *weights(256, 64))
    cases = (("nl_attention", nl_attention_op,
              (rand(4, 512), rand(4, 30, 512), rand(4, 30, 512))),
             ("time_conv", time_conv_op, (rand(4, 30, 512), *conv)),
             ("fused_bottleneck", fused_bottleneck, block),
             ("fused_bottleneck_tiled", fused_bottleneck_tiled, block))
    out = []
    for name, op, inputs in cases:
        # activations and weights in bf16, biases (1-D) in f32
        inputs = [t if t.dim() == 1 else t.bfloat16() for t in inputs]
        want = op(*[t.float() for t in inputs])
        got = op(*[t.to(device) for t in inputs]).float().cpu()
        out.append((name, float((got - want).abs().max()),
                    float(want.abs().max())))
    return out


def cmd_migrate(args) -> int:
    """Print the port's command(s) for a reference command line, the notes
    first as `#` lines (`migrate.py`)."""
    import shlex

    from tmrnet_torch.migrate import MigrateError, translate

    tokens = list(args.tokens or [])
    if tokens and tokens[0] == "--":
        tokens = tokens[1:]
    if args.cmd and tokens:
        raise SystemExit(f"pass the reference command once, as --cmd '...' "
                         f"or as the tokens after --, not both (got "
                         f"{tokens!r} beside --cmd)")
    if args.cmd:
        tokens = shlex.split(args.cmd)
    if not tokens:
        raise SystemExit("pass the reference command: migrate -- python "
                         "train_non-local_mutiConv_resnet.py -t 90 ... "
                         "(or --cmd '...')")
    try:
        out = translate(tokens)
    except MigrateError as e:
        raise SystemExit(str(e))
    for note in out["notes"]:
        print(f"# {note}")
    for cmd in out["commands"]:
        print(cmd)
    return 0


def mesh_report(cfg: ExperimentConfig, args) -> str:
    """doctor --mesh: the grid as JAX prints it ({'data': dp, 'model':
    M}); under mesh.multihost this rank's place in it, after joining the
    group; without, how the configured grid runs."""
    m = cfg.mesh
    if m.multihost:
        _, mesh = _mesh_for(cfg, args, batch=0, grid=True)
        return (f"{mesh.shape} over {mesh.world} processes over "
                f"{mesh.backend}, this one rank {mesh.rank} (data "
                f"{mesh.data_index}, model {mesh.model_index}) on "
                f"{mesh.device}")
    mp = max(1, m.model_parallel)
    if m.data_parallel in (-1, 1) and mp == 1:
        return (f"one process on {_mesh_for(cfg, args, batch=0)[0]} (no "
                f"mesh)")
    dp = max(1, m.data_parallel)
    shape = {"data": dp, "model": mp}
    text = (f"{shape} over {dp * mp} processes, one a card: launch them "
            f"with --set mesh.multihost=true (torchrun --nproc-per-node "
            f"{dp * mp})")
    if mp == 1:
        devices = _sp_devices(cfg, args, "doctor")
        text += (f"; in one process, the sequence-parallel pass of the "
                 f"video engines, the clip engine's batches and the stream "
                 f"slots over {[str(d) for d in devices]}")
    return text


def cmd_doctor(args) -> int:
    """A host's preflight before a long job or a deployment: versions, the
    card, nvcc, the native preprocess, and (when pointed at them) a
    manifest, a checkpoint, a bank, an artifact or the config's mesh, and
    with --smoke the kernels built and each op against its plain version.
    One `[status] check: detail` line each; exit 1 iff a check FAILs,
    warns are advisory. The reference has no equivalent."""
    import platform
    import subprocess

    import torch

    counts = {"ok": 0, "warn": 0, "FAIL": 0}

    def add(status: str, name: str, detail: str) -> None:
        counts[status] += 1
        print(f"[{status:>4}] {name}: {detail}", flush=True)

    on_cpu = args.device == "cpu"
    add("ok", "versions",
        f"python {platform.python_version()}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}, numpy {np.__version__}")
    if torch.cuda.is_available():
        props = torch.cuda.get_device_properties(0)
        add("ok", "devices", f"{torch.cuda.device_count()} x cuda "
            f"({props.name}, sm_{props.major}{props.minor})")
    elif on_cpu:
        add("ok", "devices", "no CUDA card; the CPU path (--device cpu)")
    else:
        add("FAIL", "devices", "CUDA is not available; pass --device cpu "
            "to check this host's CPU path")

    from tmrnet_torch.kernels.build import _nvcc

    try:
        nvcc = _nvcc()
        out = subprocess.run([nvcc, "--version"], capture_output=True,
                             text=True, timeout=60).stdout
        release = [line for line in out.splitlines() if "release" in line]
        add("ok", "nvcc", f"{nvcc}: {(release or ['?'])[-1].strip()}")
    except (RuntimeError, OSError, subprocess.SubprocessError) as e:
        add("warn" if on_cpu else "FAIL", "nvcc",
            f"{e} -- the kernels are built with it at first use")

    from tmrnet_torch.data import native

    try:
        native.load_library()
        add("ok", "native", "libtmrnet_data built with g++ and loadable")
    except (RuntimeError, OSError) as e:
        add("warn", "native", f"C++ preprocess unavailable ({e}); "
            "data.use_native_preproc=true raises under "
            "data.device_normalize=false")

    if args.manifest:
        try:
            from tmrnet_torch.data.manifests import load_pickle_manifest
            from tmrnet_torch.data.packed import (packed_file_of,
                                                  split_packed_path)

            vids = list(load_manifest(args.manifest).videos)
            if not args.manifest.endswith(".csv"):
                # a two-split pickle carries train and val: check both
                val = load_pickle_manifest(args.manifest)[1]
                if val is not None:
                    vids += list(val.videos)
            det = (f"{len(vids)} videos, "
                   f"{sum(len(v.frame_paths) for v in vids)} frames")
            missing = sum(1 for v in vids if v.frame_paths and not
                          os.path.exists(packed_file_of(v.frame_paths[0])
                                         or v.frame_paths[0]))
            # every packed index against its pack's length (a header
            # read): one out of range would fail mid-epoch
            bad_packs = []
            for v in vids:
                packs = {}
                for p in v.frame_paths:
                    if packed_file_of(p):
                        f, idx = split_packed_path(p)
                        packs.setdefault(f, []).append(idx)
                for f, idxs in packs.items():
                    if os.path.exists(f):
                        n = int(np.load(f, mmap_mode="r").shape[0])
                        if max(idxs) >= n:
                            bad_packs.append(
                                f"{v.video_id} ({os.path.basename(f)}: "
                                f"frame {max(idxs)} >= {n})")
            if bad_packs:
                add("FAIL", "manifest",
                    f"{det}; packed index out of range for "
                    f"{len(bad_packs)} video(s): {bad_packs[:3]} -- the "
                    "manifest and packs are out of sync (re-run pack)")
            elif missing:
                add("warn", "manifest",
                    f"{det}; first frame missing on disk for {missing} "
                    f"video(s) -- paths may be relative to another root")
            else:
                add("ok", "manifest", det)
        except Exception as e:      # a check must report, not crash doctor
            add("FAIL", "manifest", f"{args.manifest}: {e}")

    if args.checkpoint:
        try:
            from tmrnet_torch.utils.checkpoint import CheckpointManager

            if not os.path.isdir(args.checkpoint):
                raise FileNotFoundError("not a directory")
            cm = CheckpointManager(args.checkpoint)
            step = cm.latest_step()
            if step is None:
                add("warn", "checkpoint",
                    f"{args.checkpoint}: no steps found")
            else:
                meta = json.dumps(cm.metadata(step))
                add("ok", "checkpoint",
                    f"latest step {step}, meta {meta[:120]}")
        except Exception as e:
            add("FAIL", "checkpoint", f"{args.checkpoint}: {e}")

    if args.lfb:
        try:
            from tmrnet_torch.memory.lfb import load_bank

            bank = load_bank(args.lfb, device="cpu")   # .npz or g_LFB .pkl
            add("ok", "lfb", f"bank ({bank.num_rows}, {bank.feature_dim}) "
                f"{bank.features.dtype}")
        except Exception as e:
            add("FAIL", "lfb", f"{args.lfb}: {e}")

    if args.artifact:
        try:
            from tmrnet_torch.eval.saved import load_artifact

            art = load_artifact(args.artifact)
            m = art.meta
            if m.get("kind") == "stream":
                ident = (f"kind=stream slots={m.get('slots')} "
                         f"seq={m.get('seq')} window={m.get('window')}")
            else:
                ident = f"head={art.head or '?'}"
            ins = m.get("inputs") or [
                {"shape": list(shape), "dtype": str(dtype)}
                for shape, dtype in art.inputs]
            det = (f"{ident} device={art.device} "
                   f"torch={m.get('torch_version', '?')} inputs={ins}")
            if not m:
                add("warn", "artifact", det + " -- sidecar .json missing "
                    "(calling convention unknown to loaders)")
            else:
                add("ok", "artifact", det)
        except Exception as e:
            add("FAIL", "artifact", f"{args.artifact}: {e}")

    if args.mesh:
        try:
            add("ok", "mesh", mesh_report(load_config(args), args))
        except (Exception, SystemExit) as e:
            add("FAIL", "mesh", str(e))

    if args.smoke:
        import time

        try:
            from tmrnet_torch.device import resolve_device
            from tmrnet_torch.kernels.build import SOURCES, build_all

            device = resolve_device(args.device)
            if device.type == "cuda":
                t0 = time.perf_counter()
                build_all()
                add("ok", "smoke", f"built the {len(SOURCES)} kernel "
                    f"libraries in {time.perf_counter() - t0:.1f} s")
            for name, err, scale in doctor_smoke(device):
                add("ok" if err <= 2e-2 * scale else "FAIL", "smoke",
                    f"{name} on {device}: max |op - plain| {err:.3g}, "
                    f"limit 2e-2 x max |plain| = {2e-2 * scale:.3g}")
        except Exception as e:
            add("FAIL", "smoke", f"{type(e).__name__}: {e}")

    print(f"doctor: {counts['ok']} ok, {counts['warn']} warn, "
          f"{counts['FAIL']} fail")
    return 1 if counts["FAIL"] else 0


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="python -m tmrnet_torch",
                                     description=__doc__.splitlines()[0])
    sub = parser.add_subparsers(dest="command", required=True)

    def config_args(sp):
        sp.add_argument("--preset", choices=sorted(PRESETS),
                        help="a preset config (--config wins over it)")
        sp.add_argument("--config", help="path to ExperimentConfig json")
        sp.add_argument("--set", action="append", metavar="KEY=VALUE",
                        help="dotted config override, repeatable")

    def device_arg(sp):
        sp.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")

    sp = sub.add_parser("prepare", help="videos -> 1-fps cut-margin frames")
    sp.add_argument("--videos", required=True)
    sp.add_argument("--out", required=True)
    sp.add_argument("--stride", type=int, default=25)
    sp.add_argument("--size", type=int, default=250)
    sp.add_argument("--no-cutmargin", action="store_true")
    sp.add_argument("--pack", action="store_true",
                    help="write one raw uint8 <video>.npy per video instead "
                         "of a PNG tree (data/packed.py); `manifest "
                         "--frames` walks packs and directories alike")
    sp.add_argument("--workers", type=int, default=0,
                    help="videos extracted in parallel (0 = one per core)")
    sp.set_defaults(fn=cmd_prepare)

    sp = sub.add_parser("manifest", help="frames dir -> manifest pickle/CSV")
    config_args(sp)
    sp.add_argument("--frames", help="default: data.data_root")
    sp.add_argument("--annotations", help="default: data.annotation_root")
    sp.add_argument("--out", required=True)
    sp.add_argument("--protocol", default="cholec80",
                    choices=["cholec80", "m2cai"])
    sp.add_argument("--stride", type=int, default=25)
    sp.add_argument("--train-videos", type=int, default=0,
                    help="first N videos to the train split (0 = single "
                         "split)")
    sp.set_defaults(fn=cmd_manifest)

    sp = sub.add_parser("synth", help="generate the synthetic memory-"
                                      "dependent dataset (efficacy study)")
    sp.add_argument("--out-dir", required=True)
    sp.add_argument("--train", type=int, default=8,
                    help="train-split videos (frames-train/)")
    sp.add_argument("--val", type=int, default=2)
    sp.add_argument("--test", type=int, default=4)
    sp.add_argument("--task", choices=("pairs", "multiscale"),
                    default="pairs",
                    help="'pairs' = the memory-required task; 'multiscale' "
                         "= the 12-phase tmr-vs-nl_only ranking task "
                         "(fixed spec; run with memory.window="
                         "MULTISCALE_WINDOW and data.sequence_length="
                         "MULTISCALE_SEQ from data/synthetic.py)")
    sp.add_argument("--phases", type=int, default=7)
    sp.add_argument("--dur-min", type=int, default=15,
                    help="min frames per phase")
    sp.add_argument("--dur-max", type=int, default=25)
    sp.add_argument("--hw", type=int, default=32, help="frame side length")
    sp.add_argument("--seq", type=int, default=10,
                    help="clip length, only for the printed frame-only "
                         "ceiling estimate")
    sp.add_argument("--seed", type=int, default=0)
    sp.set_defaults(fn=cmd_synth)

    sp = sub.add_parser("pack", help="frames -> per-video raw .npy "
                                     "(zero-decode reads)")
    sp.add_argument("--manifest", required=True,
                    help="source manifest (pickle or CSV; image files, which "
                         "need cv2, or packed frames)")
    sp.add_argument("--out-dir", required=True,
                    help="directory for the <video_id>.npy packs")
    sp.add_argument("--manifest-out", required=True,
                    help="where to write the packed manifest (.pkl keeps "
                         "the source's split structure; .csv for one split)")
    sp.add_argument("--workers", type=int, default=0,
                    help="videos packed in parallel (0 = min(8, cores))")
    sp.set_defaults(fn=cmd_pack)

    sp = sub.add_parser("stats", help="channel mean/std (meanStd tool)")
    sp.add_argument("--workers", type=int, default=0,
                    help="parallel frame decodes (0 = one per core)")
    sp.add_argument("--manifest", required=True)
    sp.add_argument("--subsample", type=int, default=1)
    sp.add_argument("--no-resize", action="store_true",
                    help="skip the reference's 224x224 resize step (PIL's)")
    sp.add_argument("--population", action="store_true",
                    help="population std over all pixels instead of the "
                         "reference's mean of per-image stds")
    sp.set_defaults(fn=cmd_stats)

    def video_args(sp, source, videos_help, val=False):
        """--videos in a group with the frame-manifest flag `source`, which
        it replaces; --val-videos beside the trainers' --val-manifest."""
        g = sp.add_mutually_exclusive_group()
        g.add_argument(source[0], help=source[1])
        g.add_argument("--videos", metavar="DIR", help=videos_help + " "
                       "(needs imageio+pyav or cv2 to decode)")
        if val:
            sp.add_argument("--val-videos", metavar="DIR",
                            help="with --videos: the val set's videos "
                                 "(default: no val set)")
        sp.add_argument("--annotations", metavar="DIR",
                        help="phase annotations (<video>-phase.txt), "
                             "required with --videos")

    def weights_args(sp, torch_help, artifact=False):
        g = sp.add_mutually_exclusive_group(required=True)
        g.add_argument("--ckpt", help="the port's checkpoint dir (its best, "
                                      "else its newest step)")
        g.add_argument("--torch-ckpt", help=torch_help)
        if artifact:
            g.add_argument("--artifact",
                           help="run from an export-model --stream artifact "
                                "instead of model code and checkpoints (the "
                                "slot count and the data pipeline come from "
                                "its sidecar)")

    def extractor_args(sp):
        g = sp.add_mutually_exclusive_group()
        g.add_argument("--extractor-ckpt",
                       help="the port's stage-1 checkpoint dir: its trunk "
                            "and LSTM build the bank; default: the model's")
        g.add_argument("--extractor-torch-ckpt",
                       help="reference-format .pth of the LFB extractor "
                            "(head lfb); default: the model's trunk and "
                            "LSTM")

    sp = sub.add_parser("train-bank", help="stage-1 memory-bank training")
    config_args(sp)
    video_args(sp, ("--train-manifest", "default: data.manifest_path (its "
                                        "train split)"),
               "train straight from the video files under DIR instead of "
               "a frame manifest", val=True)
    sp.add_argument("--val-manifest",
                    help="default: the train manifest's second split")
    sp.add_argument("--torch-init", help="reference .pth to initialize from")
    sp.add_argument("--log-dir", default="./runs/train-bank")
    device_arg(sp)
    sp.set_defaults(fn=cmd_train_bank)

    sp = sub.add_parser("build-lfb", help="build the feature bank")
    config_args(sp)
    video_args(sp, ("--manifest", "the frame manifest (pickle or CSV)"),
               "build from the video files under DIR instead of a frame "
               "manifest (the clip engine)")
    weights_args(sp, "reference-format .pth of the extractor (head lfb)")
    sp.add_argument("--engine", choices=["clip", "video"], default=None,
                    help="'video' builds the bank at one backbone pass per "
                         "frame (crop types 1/2/3); default: video, falling "
                         "back to clip for other crop types and --videos")
    sp.add_argument("--out", required=True)
    device_arg(sp)
    sp.set_defaults(fn=cmd_build_lfb)

    sp = sub.add_parser("train-tmr", help="stage-2 TMRNet training")
    config_args(sp)
    video_args(sp, ("--train-manifest", "default: data.manifest_path (its "
                                        "train split)"),
               "train straight from the video files under DIR instead of "
               "a frame manifest", val=True)
    sp.add_argument("--val-manifest")
    sp.add_argument("--lfb", required=True,
                    help="the train split's bank (.npz, or a g_LFB .pkl "
                         "checked against the manifest)")
    sp.add_argument("--val-lfb", help="the val split's bank")
    sp.add_argument("--stage1-ckpt",
                    help="the port's stage-1 checkpoint dir: its trunk and "
                         "LSTM start the model")
    sp.add_argument("--torch-init", help="reference .pth to initialize from")
    sp.add_argument("--log-dir", default="./runs/train-tmr")
    device_arg(sp)
    sp.set_defaults(fn=cmd_train_tmr)

    sp = sub.add_parser("test", help="test-set inference -> predictions npz")
    config_args(sp)
    sp.add_argument("--manifest", required=True)
    weights_args(sp, "reference-format .pth of the model (head model.head)")
    extractor_args(sp)
    sp.add_argument("--lfb", help="test-set bank: .npz cache, or a g_LFB "
                                  ".pkl checked against the manifest")
    sp.add_argument("--load-lfb", action="store_true",
                    help="read the bank from memory.cache_path (or --lfb) "
                         "where it exists instead of building it")
    sp.add_argument("--engine", choices=["clip", "video", "corpus"],
                    default=None,
                    help="'clip' = batched clips over a bank; 'video' = "
                         "the full-video engine (backbone once per frame, "
                         "bank built in the same pass); 'corpus' = the "
                         "video engine over the whole set as one stream. "
                         "Default: corpus, falling back to clip for crop "
                         "types 0/5/10, compat_cross_video, --lfb or "
                         "--load-lfb")
    sp.add_argument("--out", default="./predictions.npz")
    sp.add_argument("--ref-pickle",
                    help="also write the predictions in the reference's "
                         "pickle format (<path> + <path>.score.pkl)")
    device_arg(sp)
    sp.set_defaults(fn=cmd_test)

    sp = sub.add_parser("stream", help="online streaming inference "
                                       "(one frame/stream/step, JSONL out)")
    config_args(sp)
    sp.add_argument("--manifest", required=True)
    weights_args(sp, "reference-format .pth of the model (head model.head)",
                 artifact=True)
    extractor_args(sp)
    sp.add_argument("--max-steps", type=int, default=0,
                    help="cap the number of streamed frames per video")
    sp.add_argument("--max-streams", type=int, default=64,
                    help="stream slots; a finished video's slot takes the "
                         "next (default 64 bounds the decoded videos in "
                         "host memory; -1 = one slot per video)")
    sp.add_argument("--out", default="./stream_preds.jsonl")
    device_arg(sp)
    sp.set_defaults(fn=cmd_stream)

    sp = sub.add_parser("serve", help="serving daemon: JSONL frame events "
                                      "on stdin -> predictions on stdout")
    config_args(sp)
    weights_args(sp, "reference-format .pth of the model (head model.head)",
                 artifact=True)
    extractor_args(sp)
    device_arg(sp)
    sp.add_argument("--slots", type=int, default=16,
                    help="stream slots (max concurrent streams); an "
                         "artifact's own count replaces it")
    sp.add_argument("--probs", action="store_true",
                    help="include per-class probabilities in output rows")
    sp.add_argument("--input", default="-",
                    help="protocol input file ('-' = stdin)")
    sp.add_argument("--no-warmup", action="store_true",
                    help="skip the startup warmup step (kernel builds)")
    sp.add_argument("--state-dir",
                    help="checkpoint serving state here (crash recovery: "
                         "a restarted daemon resumes live streams)")
    sp.add_argument("--checkpoint-every", type=int, default=64,
                    help="ticks between serving-state checkpoints")
    sp.add_argument("--decode-workers", type=int, default=4,
                    help="frame-decode pool threads (0 = decode inline in "
                         "the protocol loop)")
    sp.add_argument("--decode-timeout", type=float, default=5.0,
                    help="seconds before a tick drops a frame whose decode "
                         "hasn't finished (the stream freezes that tick)")
    sp.add_argument("--tick-interval", type=float, default=0.0,
                    help="self-ticking: flush pending frames every this "
                         "many wall-clock seconds (1.0 for 1-fps OR feeds) "
                         "instead of waiting for {\"step\": true} lines; "
                         "0 = client-driven ticks only")
    sp.add_argument("--stats-every", type=int, default=0,
                    help="print a JSON stats heartbeat (tick, rows, live "
                         "streams, rolling latency p50/p95) to stderr "
                         "every N ticks; 0 = only the exit summary")
    sp.add_argument("--idle-ticks", type=int, default=0,
                    help="evict a stream that contributed no frame to this "
                         "many consecutive ticks (one {'evicted': true} row "
                         "is emitted); 0 = streams live until "
                         "end/disconnect")
    sp.add_argument("--listen", metavar="HOST:PORT",
                    help="serve the JSONL protocol over TCP instead of "
                         "stdin/stdout: each stream's rows route to the "
                         "connection that owns it, and a dropped "
                         "connection frees its streams' slots (port 0 = "
                         "ephemeral, bound address printed to stderr)")
    sp.set_defaults(fn=cmd_serve)

    sp = sub.add_parser("parity", help="reference .pth + frames -> Main.m "
                                       "protocol table in one command")
    config_args(sp)
    sp.add_argument("--manifest", required=True,
                    help="test manifest (pickle/CSV) over the frames")
    sp.add_argument("--torch-ckpt", required=True,
                    help="reference stage-2 .pth (TMRNet weights)")
    sp.add_argument("--extractor-torch-ckpt",
                    help="reference .pth of the LFB extractor (head lfb); "
                         "default: --torch-ckpt's trunk and LSTM")
    sp.add_argument("--lfb", help="bank cache path (default workdir/lfb.npz)")
    sp.add_argument("--load-lfb", action="store_true",
                    help="read the bank at --lfb where it exists")
    sp.add_argument("--workdir", default="./parity")
    sp.add_argument("--protocol", default=None,
                    choices=["cholec80", "m2cai"],
                    help="default: the config's eval.protocol (cholec80)")
    sp.add_argument("--json-out")
    device_arg(sp)
    sp.set_defaults(fn=cmd_parity)

    sp = sub.add_parser("export", help="predictions (npz, stream jsonl or "
                                       "reference pickle) -> phase trees")
    config_args(sp)
    sp.add_argument("--manifest", required=True)
    sp.add_argument("--preds", required=True,
                    help=".npz from `test`, .jsonl from `stream`, or a "
                         "reference test script's .pkl")
    sp.add_argument("--pred-dir",
                    help="default: eval.pred_dir (./eval/phase)")
    sp.add_argument("--gt-dir",
                    help="default: eval.gt_dir (./eval/gt-phase)")
    sp.add_argument("--name-fmt", default="{vid}-phase.txt",
                    help="per-video file name; a cutMargin tree has "
                         "bare-number video ids, so pass "
                         "'video{vid}-phase.txt' for the names Main.m "
                         "iterates (video41..video80)")
    sp.set_defaults(fn=cmd_export)

    sp = sub.add_parser("evaluate", help="relaxed-boundary protocol scoring")
    config_args(sp)
    sp.add_argument("--pred-dir",
                    help="default: eval.pred_dir (./eval/phase)")
    sp.add_argument("--gt-dir",
                    help="default: eval.gt_dir (./eval/gt-phase)")
    sp.add_argument("--protocol", default=None,
                    choices=["cholec80", "m2cai"],
                    help="default: the config's eval.protocol (cholec80)")
    sp.add_argument("--fps", type=int, default=None,
                    help="frames a second of the label streams (default "
                         "1 for cholec80, 25 for m2cai)")
    sp.add_argument("--videos", nargs="*")
    sp.add_argument("--relaxed-seconds", type=int, default=None,
                    help="boundary relaxation (default eval.relaxed_seconds"
                         " = 10, Evaluate.m:13)")
    sp.add_argument("--video-range", nargs=2, type=int, metavar=("LO", "HI"),
                    help="score only gt files whose trailing video number "
                         "falls in [LO, HI] (Main.m's 41:80, Main_m2cai.m's "
                         "1:14); a --preset or --config defaults it to "
                         "eval.test_videos")
    sp.add_argument("--no-quirk", action="store_true",
                    help="the intended early relaxation, not MATLAB's quirk")
    sp.add_argument("--json-out")
    sp.add_argument("--matlab-compat", action="store_true",
                    help="drop each phase file's first row as "
                         "ReadPhaseLabel.m's fgets does (the reference's "
                         "exports have no header, so Main.m loses frame 0 "
                         "of every video)")
    sp.set_defaults(fn=cmd_evaluate)

    sp = sub.add_parser("export-ckpt", help="the port's checkpoint -> "
                                            "reference-format .pth")
    config_args(sp)
    sp.add_argument("--ckpt", required=True,
                    help="the port's checkpoint dir (its best, else its "
                         "newest step)")
    sp.add_argument("--out", required=True, help="output .pth path")
    sp.set_defaults(fn=cmd_export_ckpt)

    sp = sub.add_parser("export-model",
                        help="export the inference step through "
                             "torch.export (weights held in the artifact; "
                             "runs with torch and the port's kernels)")
    config_args(sp)
    weights_args(sp, "reference-format .pth of the model (head model.head)")
    sp.add_argument("--out", required=True,
                    help="artifact path (.pt2; the sidecar <out>.json "
                         "carries the calling convention)")
    sp.add_argument("--batch", type=int, default=0,
                    help="exported batch size (fixed shape; default "
                         "eval.batch_clips). Export one artifact per "
                         "deployed batch size")
    sp.add_argument("--fold-bn", action="store_true",
                    help="fold BatchNorm into the conv weights before "
                         "export (the artifact holds no BN op)")
    sp.add_argument("--stream", action="store_true",
                    help="export the serve daemon's per-tick stream step "
                         "instead of the clip step (run it with `serve "
                         "--artifact <out>` or `stream --artifact <out>`)")
    sp.add_argument("--slots", type=int, default=16,
                    help="--stream: the slot count the artifact takes "
                         "(default 16)")
    extractor_args(sp)
    sp.add_argument("--device", default="cuda",
                    help="the device the artifact runs on: cuda (default) "
                         "or cpu")
    sp.set_defaults(fn=cmd_export_model)

    sp = sub.add_parser("migrate", help="reference command line -> the "
                                        "port's equivalent command(s)")
    sp.add_argument("--cmd", help="the reference command as one quoted "
                                  "string (instead of the tokens)")
    sp.add_argument("tokens", nargs=argparse.REMAINDER,
                    help="the reference command, e.g. migrate -- python "
                         "train_non-local_mutiConv_resnet.py -t 90 -e 25 "
                         "--LFB_l 30")
    sp.set_defaults(fn=cmd_migrate)

    sp = sub.add_parser("doctor", help="host preflight: versions, the "
                                       "card, nvcc, artifacts")
    config_args(sp)
    sp.add_argument("--manifest", help="check a manifest pickle/CSV (every "
                                       "packed index against its pack)")
    sp.add_argument("--checkpoint", help="check a port checkpoint directory")
    sp.add_argument("--lfb", help="check a feature bank (.npz or g_LFB "
                                  ".pkl)")
    sp.add_argument("--artifact", help="load an export-model artifact and "
                                       "report its calling convention")
    sp.add_argument("--mesh", action="store_true",
                    help="set up the config's mesh and report it")
    sp.add_argument("--smoke", action="store_true",
                    help="build the kernels and run each of the four ops "
                         "once against its plain version")
    device_arg(sp)
    sp.set_defaults(fn=cmd_doctor)
    return parser


def _in_group() -> bool:
    """Whether this process is in a torch.distributed group; no group can
    exist where torch.distributed was never imported, and the host
    commands (`migrate`, `prepare`, ...) never import torch."""
    dist = sys.modules.get("torch.distributed")
    return dist is not None and dist.is_available() and dist.is_initialized()


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    joined = _in_group()
    rc = args.fn(args)
    if not joined and _in_group():
        from tmrnet_torch.parallel.mesh import shutdown

        shutdown()      # the group this command joined (mesh.multihost)
    return rc
