"""Configuration for the PyTorch port: the fields of the JAX package's
`ModelConfig`, `MemoryConfig`, `DataConfig` and `EvalConfig` that the
inference engines, the data layer and the CLI read.

Own copy of those fields (names, defaults, meaning) of
`tmrnet_tpu/config.py` (the phase names :22-43, DataConfig :50-93 but for
num_classes, ModelConfig :97-123, TrainConfig
:125-200, MemoryConfig :200-210 but for feature_dim, EvalConfig :214-245
but for checkpoint, MeshConfig :249-262), of `ExperimentConfig.from_json`
(:283-300), of the
six `PRESETS` and `get_preset` (:308-434) and of `apply_override`
(:395-428), so the port never imports the JAX package. The presets are
JAX's but for `data.num_classes`, which the port lacks (it reads
`model.num_classes`, which the m2cai preset sets to 8 in both packages),
and for `ExperimentConfig.name` (:268), which nothing in the port reads:
a preset is known by its key in `PRESETS`. Later slices add the fields
they read.

`from_json` skips keys the port's dataclasses lack, so a JSON written by
either package's `to_json` loads here; `ignored_fields` names those of
them that set, to another value than JAX's default, a field that changes
what JAX computes. `apply_override` on a field the port lacks raises, as
JAX's does on one it lacks.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, Tuple

# Cholec80 normalization constants (reference `meanStd.py:27-63`).
CHOLEC80_MEAN: Tuple[float, float, float] = (0.41757566, 0.26098573, 0.25888634)
CHOLEC80_STD: Tuple[float, float, float] = (0.21938758, 0.1983, 0.19342837)

# Phase names; their order defines the label ids (reference
# `get_paths_labels.py:49-54`; M2CAI16 adds TrocarPlacement first).
CHOLEC80_PHASES: Tuple[str, ...] = (
    "Preparation", "CalotTriangleDissection", "ClippingCutting",
    "GallbladderDissection", "GallbladderPackaging", "CleaningCoagulation",
    "GallbladderRetraction")
M2CAI_PHASES: Tuple[str, ...] = ("TrocarPlacement",) + CHOLEC80_PHASES


@dataclass(frozen=True)
class DataConfig:
    """Frames, manifests, the host pipeline, frame geometry and input
    normalization: uint8 frames are cast to the compute dtype and, under
    `device_normalize`, become (x - mean*255) / (std*255) on the card."""

    # Frames dir (one subdir or packed .npy per video) and the phase
    # annotations, the `manifest` command's defaults.
    data_root: str = "./data/frames"
    annotation_root: str = "./data/phase_annotations"
    # 'pickle' (the reference's 3/6-list) or 'csv' (frame,class,id): the
    # format of an extension-less `manifest --out`.
    manifest_format: str = "pickle"
    # Frames per clip: the reference runs 10-frame 1-fps clips.
    sequence_length: int = 10
    fps: int = 1
    source_fps: int = 25  # raw video fps; keep every (source_fps // fps)-th
    # Image geometry: decode -> resize 250 -> crop 224.
    resize: int = 250
    crop_size: int = 224
    # The manifest the trainers read when no --train-manifest is given.
    manifest_path: str = "./train_val_paths_labels.pkl"
    # Training augmentation (data/transforms.py::TrainTransform): use_flip
    # is the reference's --flip, which gates the colour jitter and the
    # rotation only (the horizontal flip runs in both stacks).
    use_flip: bool = True
    rotate_degrees: float = 5.0
    color_jitter: float = 0.1
    color_jitter_hue: float = 0.05
    # Test-time crop type (the reference's --crop): 0 random / 1 center /
    # 2 or 3 resize-only / 5 five-crop / 10 ten-crop (data/transforms.py).
    test_crop_type: int = 1
    mean: Tuple[float, float, float] = CHOLEC80_MEAN
    std: Tuple[float, float, float] = CHOLEC80_STD
    phase_names: Tuple[str, ...] = CHOLEC80_PHASES
    # The host pipeline (data/pipeline.py::ClipLoader): clips per batch of
    # the LFB build, batches assembled ahead, decode workers, and forked
    # processes instead of threads.
    batch_clips: int = 40
    prefetch: int = 2
    num_workers: int = 8
    use_process_workers: bool = False
    device_normalize: bool = False
    # The host normalization of TrainTransform through the port's C++
    # library (data/native.py), built at first use; a failed build raises.
    use_native_preproc: bool = True


@dataclass(frozen=True)
class ModelConfig:
    """Backbone + temporal head architecture."""

    backbone: str = "resnet50"  # resnet50 | resnest50 | tiny (tests)
    # Stage depths; (3,4,6,3) = ResNet-50 or ResNeSt-50.
    stage_sizes: Tuple[int, ...] = (3, 4, 6, 3)
    width: int = 64
    hidden_dim: int = 512  # LSTM hidden size
    num_classes: int = 7
    # 'stage1' (trunk + LSTM + fc on every step), 'lfb' (trunk + LSTM, the
    # last step's features), 'tmr' (TimeConv + NLBlock memory head) or
    # 'nl_only' (NLBlock alone).
    head: str = "tmr"
    # Dropout rates in training: after the stage-1 LSTM, after fc_h_c, and
    # after the NLBlock's output layer.
    dropout_stage1: float = 0.2
    dropout_head: float = 0.5
    dropout_nl: float = 0.2
    # bfloat16 on the card; float32 for parity, on the CPU or the card
    # (unfolded there: the folded identity blocks' kernels are bf16)
    compute_dtype: str = "bfloat16"
    # Inference-only: BatchNorm pre-folded into conv weights (models/fold_bn).
    folded: bool = False
    # Each ResNet bottleneck recomputed in the backward pass (ResNeSt
    # ignores it, as JAX's does); the trainers set it from train.remat.
    remat: bool = False


@dataclass(frozen=True)
class TrainConfig:
    """Optimizer, schedule and loop settings (train/optim.py,
    train/loop.py)."""

    epochs: int = 25
    optimizer: str = "sgd"  # sgd | adam
    lr: float = 5e-4
    momentum: float = 0.9
    weight_decay: float = 5e-4
    dampening: float = 0.0
    nesterov: bool = False
    # The trunk (stage 1: the backbone; stage 2: backbone and LSTM) trains
    # at lr * trunk_lr_scale, the rest at lr.
    trunk_lr_scale: float = 0.1
    # 'step' (StepLR) | 'plateau' (ReduceLROnPlateau on val loss) |
    # 'constant'.
    schedule: str = "plateau"
    step_size: int = 5
    gamma: float = 0.1
    plateau_factor: float = 0.1
    plateau_patience: int = 10
    # Class-balanced weighted CE, summed, on each clip's last frame.
    class_weighting: bool = True
    label_smoothing: float = 0.0
    seed: int = 0
    log_every: int = 50
    # One held-out val batch every N train steps (0 = off).
    val_minibatch_every: int = 0
    # Stop after this many epochs without a new best (0 = off).
    early_stop_patience: int = 0
    # Log the first clip of every Nth train batch as images (0 = off).
    log_images_every: int = 0
    checkpoint_dir: str = "./checkpoints"
    keep_checkpoints: int = 3
    resume: bool = True
    # SIGTERM/SIGINT finish the step, save a checkpoint marked for epoch
    # replay and return; a second signal interrupts.
    preempt_save: bool = True
    # save() returns once the state is copied to the host and writes it in
    # a background thread; the best's copy and the trainer's exit wait.
    async_checkpoint: bool = False
    # Recompute each ResNet bottleneck in the backward pass: less memory
    # for a longer step (the trainers' model.remat).
    remat: bool = False
    # JAX donates the state to its jitted step; the port's step updates the
    # model in place either way.
    donate_state: bool = True
    # The mean gradient of k micro-batches, an optimizer step every k-th.
    grad_accum: int = 1
    # Global-norm gradient clip before the optimizer (0 = off).
    grad_clip: float = 0.0


@dataclass(frozen=True)
class MemoryConfig:
    """Long-term Feature Bank settings."""

    window: int = 30
    # The bank's `.npz` cache, read instead of a build under load_cached.
    cache_path: str = "./LFB/lfb.npz"
    load_cached: bool = True
    # The reference's window walk crosses video boundaries
    # (`train_non-local_mutiConv_resnet.py:315-322`); True replicates it in
    # the clip engine (data/indexing.py::quirk_window_table), False clamps
    # at the video's first row (the paper's intent).
    compat_cross_video: bool = False


@dataclass(frozen=True)
class EvalConfig:
    """Inference and scoring settings."""

    # Clips per batch of the clip engine.
    batch_clips: int = 64
    # Where `export` writes the phase files and `evaluate` reads them
    # (their --pred-dir / --gt-dir default to these), `evaluate`'s protocol
    # (cholec80 | m2cai, `eval/metrics.py`), its boundary relaxation in
    # seconds, the frame-id step of exported rows (25*k,
    # `export_phase_copy.py:63-73`) and the videos it scores (an inclusive
    # range of video numbers, Main.m's 41:80).
    pred_dir: str = "./eval/phase"
    gt_dir: str = "./eval/gt-phase"
    protocol: str = "cholec80"
    relaxed_seconds: int = 10
    export_fps: int = 25
    test_videos: Tuple[int, int] = (41, 80)
    # `test --engine video`: videos of one length bucket scored together
    # (VideoInference.run_videos).
    video_batch: int = 1
    # The video engines run the backbone over frame chunks of this many
    # frames: 0 = auto (`eval/infer.py::plan_trunk_chunk`), -1 = never
    # (all frames of a call at once), > 0 = that many.
    backbone_chunk: int = 0
    # `test --engine video` over the whole set as one flat frame stream in
    # blocks of corpus_chunk frames (VideoInference.run_corpus).
    corpus: bool = False
    corpus_chunk: int = 4096


@dataclass(frozen=True)
class MeshConfig:
    """The (data x model) grid across processes (`parallel/mesh.py`): one
    process a card, `torch.distributed` between them (NCCL on cards, gloo
    on the CPU); tensor parallelism over the model axis
    (`parallel/tensor.py`). Without multihost, data_parallel N > 1 is the
    video engines' sequence-parallel pass over N local cards
    (`eval/infer.py::VideoInference(devices=)`). The axis names are JAX's
    and name nothing in the port."""

    data_axis: str = "data"
    model_axis: str = "model"
    # -1: every process over M on the data axis; else the world size / M.
    data_parallel: int = -1
    # M: ranks of one model group, each holding a slice of the parameters
    # that the TP rules shard.
    model_parallel: int = 1
    # Rendezvous with the other processes (init_process_group) when True.
    multihost: bool = False
    # An explicit rendezvous, all three set together (e.g. --set
    # mesh.coordinator=host:1234): a tcp:// init; empty/-1 = torchrun's
    # environment (env://).
    coordinator: str = ""
    num_processes: int = -1
    process_id: int = -1


@dataclass(frozen=True)
class ExperimentConfig:
    """The sections of the JAX ExperimentConfig that the port reads."""

    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    memory: MemoryConfig = field(default_factory=MemoryConfig)
    eval: EvalConfig = field(default_factory=EvalConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)

    def replace(self, **kw) -> "ExperimentConfig":
        return dataclasses.replace(self, **kw)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, sort_keys=True)

    @staticmethod
    def from_json(text: str) -> "ExperimentConfig":
        """The config of a JSON object; keys (sections or fields) the port
        lacks are skipped, lists become tuples."""

        def build(cls, d):
            kwargs = {}
            for f in dataclasses.fields(cls):
                if f.name not in d:
                    continue
                v = d[f.name]
                if f.name in _SECTIONS and cls is ExperimentConfig:
                    v = build(_SECTIONS[f.name], v)
                elif isinstance(v, list):
                    v = tuple(v)
                kwargs[f.name] = v
            return cls(**kwargs)

        return build(ExperimentConfig, json.loads(text))


_SECTIONS = {"data": DataConfig, "model": ModelConfig, "train": TrainConfig,
             "memory": MemoryConfig, "eval": EvalConfig, "mesh": MeshConfig}

# Fields of JAX's config that the port lacks and that change what JAX
# computes, at JAX's defaults (`tmrnet_tpu/config.py` :83, :104, :116-118,
# :204): class and feature widths, the parameter dtype and the kernel
# switch.
JAX_ONLY_DEFAULTS: Dict[str, Any] = {
    "data.num_classes": 7,
    "memory.feature_dim": 512,
    "model.feature_dim": 2048,
    "model.param_dtype": "float32",
    "model.use_pallas": False,
}


def ignored_fields(text: str) -> Dict[str, Any]:
    """The fields of JAX_ONLY_DEFAULTS that a config JSON sets to another
    value than JAX's default: what `from_json` skips but JAX would honour."""
    d = json.loads(text)
    out = {}
    for dotted, default in JAX_ONLY_DEFAULTS.items():
        section, name = dotted.split(".")
        value = (d.get(section) or {}).get(name, default)
        if value != default:
            out[dotted] = value
    return out


def _preset_memorybank() -> ExperimentConfig:
    """Stage-1 memory-bank model (ResNet-50 + LSTM, 10-frame clips, 224px),
    reference `train_singlenet_phase_1fc.py`."""
    return ExperimentConfig(
        model=ModelConfig(head="stage1"),
        train=TrainConfig(lr=5e-4, optimizer="sgd", schedule="plateau"))


def _preset_nl_only() -> ExperimentConfig:
    """Non-local head alone over a 40-row window,
    reference `train_only_non-local_pretrained.py:44`."""
    return ExperimentConfig(
        model=ModelConfig(head="nl_only"),
        memory=MemoryConfig(window=40),
        train=TrainConfig(lr=5e-7))


def _preset_tmr_resnet() -> ExperimentConfig:
    """TMRNet (TimeConv + NLBlock) on ResNet-50,
    reference `train_non-local_mutiConv_resnet.py:41,49`."""
    return ExperimentConfig(
        model=ModelConfig(head="tmr"),
        memory=MemoryConfig(window=30),
        train=TrainConfig(lr=5e-7))


def _preset_tmr_resnest() -> ExperimentConfig:
    """TMRNet on the ResNeSt-50 trunk (the best accuracy),
    reference `train_non-local_mutiConv_resnest.py`."""
    return ExperimentConfig(
        model=ModelConfig(backbone="resnest50", head="tmr"),
        memory=MemoryConfig(window=30),
        train=TrainConfig(lr=5e-7))


def _preset_inference() -> ExperimentConfig:
    """Inference over the 40-video Cholec80 test split."""
    return ExperimentConfig(
        model=ModelConfig(head="tmr", compute_dtype="bfloat16"),
        memory=MemoryConfig(window=30),
        eval=EvalConfig(batch_clips=128))


def _preset_m2cai() -> ExperimentConfig:
    """The M2CAI16 workflow challenge: 8 phases (TrocarPlacement first),
    videos 1-14 scored at 25 fps (`Main_m2cai.m`, `Evaluate_m2cai.m`)."""
    base = _preset_tmr_resnet()
    return ExperimentConfig(
        data=dataclasses.replace(base.data, phase_names=M2CAI_PHASES),
        model=dataclasses.replace(base.model, num_classes=8),
        memory=base.memory,
        train=base.train,
        eval=EvalConfig(protocol="m2cai", test_videos=(1, 14)))


PRESETS = {
    "memorybank": _preset_memorybank,
    "tmr-nl-only": _preset_nl_only,
    "tmr-resnet50": _preset_tmr_resnet,
    "tmr-resnest50": _preset_tmr_resnest,
    "inference-e2e": _preset_inference,
    "tmr-resnet50-m2cai": _preset_m2cai,
}


def get_preset(name: str) -> ExperimentConfig:
    if name not in PRESETS:
        raise KeyError(f"unknown preset {name!r}; available: {sorted(PRESETS)}")
    return PRESETS[name]()


def _coerce(value: str, current: Any) -> Any:
    if isinstance(current, bool):
        return value.lower() in ("1", "true", "yes")
    if isinstance(current, int):
        return int(value)
    if isinstance(current, float):
        return float(value)
    if isinstance(current, tuple):
        parts = [p for p in value.split(",") if p]
        elem = current[0] if current else value
        return tuple(_coerce(p, elem) for p in parts)
    return value


def apply_override(cfg: ExperimentConfig, dotted: str) -> ExperimentConfig:
    """A dotted `--set` override: apply_override(cfg, "model.folded=true").
    Values coerce to the field's current type (bools accept 1/true/yes,
    tuples split on commas); a field the port lacks raises."""
    key, eq, value = dotted.partition("=")
    if not eq:
        raise ValueError(f"override {dotted!r}: expected KEY=VALUE")
    parts = key.strip().split(".")

    def rec(node, path):
        if len(path) == 1:
            return dataclasses.replace(
                node, **{path[0]: _coerce(value, getattr(node, path[0]))})
        child = getattr(node, path[0])
        return dataclasses.replace(node, **{path[0]: rec(child, path[1:])})

    return rec(cfg, parts)
