"""Translate reference command lines into `python -m tmrnet_torch`
invocations.

Port of `tmrnet_tpu/migrate.py` (the flag tables :47-114, `_parse_flags`
:117, `_common_sets` :152, `_render` :215, the emitters :233-345,
`translate` :350). The reference spreads its workflow over ~16 scripts,
each with its own argparse surface (e.g. `code/Training memory bank model/
train_singlenet_phase_1fc.py:32-50`, `code/Training TMRNet/
train_non-local_mutiConv_resnet.py:30-53`, `code/eval/python/
test_singlenet_phase_non-local_pretrained_2fc_copy.py:17-27`). Feed it the
command you used to run the reference and it prints the equivalent
command(s), including the unit conversions (the reference's batch sizes
are FRAMES, ours are clips; `--sgdadjust 0/1` is schedule=step/plateau;
`--multi 0` collapses the two-lr param groups).

    python -m tmrnet_torch migrate -- \
        python train_non-local_mutiConv_resnet.py -t 90 -e 25 --LFB_l 30

Every emitted command parses through the port's CLI with resolvable --set
keys. Flags with no equivalent (-g/--gpu) or reference bugs (type=bool
argparse treating the string 'False' as True) become notes instead of
silent drops. The commands and notes are JAX's but for the program name
and these:
- the -g/--gpu note names the port's `--device` and `mesh.multihost`;
- the 6-class eval driver sets `model.num_classes=6` alone: the port has
  no `data.num_classes` (the model's is the one both packages read);
- the port's `build-lfb` and `test` need weights (there is no random init
  to build a bank or score with), so where the reference command names
  none they get a placeholder, `--ckpt <stage1-ckpt-dir>` (the stage-1
  checkpoint that `train-bank` writes, train.checkpoint_dir) and
  `--torch-ckpt <model.pth>`, with a note.
"""

from __future__ import annotations

import os
import shlex
from typing import Dict, List, Optional, Sequence, Tuple


class MigrateError(ValueError):
    pass


# Placeholders for the weights the port's build-lfb and test require where
# the reference command names none.
STAGE1_CKPT = "<stage1-ckpt-dir>"
MODEL_PTH = "<model.pth>"
_WEIGHTS_NOTE = ("the port's {cmd} needs weights: replace {flag} {path} "
                 "with yours")


def _boolish(v: str) -> bool:
    return str(v).strip().lower() not in ("0", "false", "no", "")


def _quote(s: str) -> str:
    return shlex.quote(str(s))


# ---------------------------------------------------------------------------
# Reference flag surfaces (aliases -> canonical names), per driver family.
# All reference flags take a value (argparse type=..., no store_true).
# ---------------------------------------------------------------------------

_TRAIN_COMMON = {
    "gpu": ("-g", "--gpu"),
    "seq": ("-s", "--seq"),
    "train": ("-t", "--train"),
    "val": ("-v", "--val"),
    "opt": ("-o", "--opt"),
    "multi": ("-m", "--multi"),
    "epo": ("-e", "--epo"),
    "work": ("-w", "--work"),
    "flip": ("-f", "--flip"),
    "crop": ("-c", "--crop"),
    "lr": ("-l", "--lr"),
    "momentum": ("--momentum",),
    "weightdecay": ("--weightdecay",),
    "dampening": ("--dampening",),
    "nesterov": ("--nesterov",),
    "sgdadjust": ("--sgdadjust",),
    "sgdstep": ("--sgdstep",),
    "sgdgamma": ("--sgdgamma",),
}

_STAGE2_EXTRA = {
    "LFB_l": ("--LFB_l",),
    "load_LFB": ("--load_LFB",),
    "model_path": ("--model_path",),
}

# the fork's renamed stage-1 flags (train_memorybank.py:398-421)
_FORK_TRAIN = dict(_TRAIN_COMMON)
_FORK_TRAIN.update({
    "csv_train": ("--csv_train",),
    "csv_valid": ("--csv_valid",),
    "seq": ("-s", "--seq", "--num_frames"),
    "work": ("-w", "--work", "--num_workers"),
    "epo": ("-e", "--epo", "--epochs"),
    "train": ("-t", "--train", "--train_bs"),
    "val": ("-v", "--val", "--val_bs"),
    "lr": ("-l", "--lr"),
    "opt": ("-o", "--opt"),
})

_VIDEO_DIRECT = dict(_TRAIN_COMMON)
_VIDEO_DIRECT.update(_STAGE2_EXTRA)
_VIDEO_DIRECT.update({
    "train_csv": ("--train_csv",),
    "val_csv": ("--val_csv",),
    "mount_point": ("--mount_point",),
    "save_dir": ("--save_dir",),
})

_EVAL_COMMON = {
    "gpu": ("-g", "--gpu"),
    "seq": ("-s", "--seq"),
    "test": ("-t", "--test"),
    "work": ("-w", "--work"),
    "name": ("-n", "--name"),
    "crop": ("-c", "--crop"),
    "LFB_l": ("--LFB_l",),
    "load_LFB": ("--load_LFB",),
}

_EVAL_CSV = dict(_EVAL_COMMON)
_EVAL_CSV.update({
    "csv": ("--csv",),
    "model": ("--model",),
    "lfb_model": ("--lfb_model",),
})


def _parse_flags(argv: Sequence[str], spec: Dict[str, Tuple[str, ...]],
                 notes: List[str]) -> Dict[str, str]:
    lookup = {a: canon for canon, aliases in spec.items() for a in aliases}
    flags: Dict[str, str] = {}
    i = 0
    while i < len(argv):
        tok = argv[i]
        if not tok.startswith("-"):
            notes.append(f"ignored stray argument {tok!r}")
            i += 1
            continue
        if "=" in tok:
            name, val = tok.split("=", 1)
            i += 1
        else:
            name = tok
            if i + 1 >= len(argv):
                raise MigrateError(f"flag {name} expects a value "
                                   "(every reference flag takes one)")
            val = argv[i + 1]
            i += 2
        canon = lookup.get(name)
        if canon is None:
            notes.append(f"unrecognized reference flag {name} {val!r} "
                         "(dropped)")
            continue
        flags[canon] = val
    return flags


# ---------------------------------------------------------------------------
# Shared flag -> --set translation
# ---------------------------------------------------------------------------


def _common_sets(flags: Dict[str, str], notes: List[str]
                 ) -> List[Tuple[str, str]]:
    sets: List[Tuple[str, str]] = []
    seq = int(flags.get("seq", 10))
    if "seq" in flags and seq != 10:
        sets.append(("data.sequence_length", str(seq)))
    for src, dst in (("train", "data.batch_clips"),
                     ("val", "eval.batch_clips"),
                     ("test", "eval.batch_clips")):
        if src in flags:
            frames = int(flags[src])
            clips = max(1, frames // seq)
            sets.append((dst, str(clips)))
            notes.append(f"reference batch sizes are FRAMES: "
                         f"{frames} frames = {clips} clips of {seq} "
                         f"({dst}={clips})")
    if "opt" in flags:
        sets.append(("train.optimizer",
                     "adam" if int(flags["opt"]) == 1 else "sgd"))
    if "multi" in flags and int(flags["multi"]) == 0:
        sets.append(("train.trunk_lr_scale", "1.0"))
        notes.append("--multi 0 (single param group): the trunk trains at "
                     "full lr instead of lr/10")
    if "epo" in flags:
        sets.append(("train.epochs", flags["epo"]))
    if "work" in flags:
        sets.append(("data.num_workers", flags["work"]))
    if "flip" in flags:
        sets.append(("data.use_flip",
                     "true" if _boolish(flags["flip"]) else "false"))
    if "crop" in flags:
        sets.append(("data.test_crop_type", flags["crop"]))
    if "lr" in flags:
        sets.append(("train.lr", flags["lr"]))
    if "momentum" in flags:
        sets.append(("train.momentum", flags["momentum"]))
    if "weightdecay" in flags:
        sets.append(("train.weight_decay", flags["weightdecay"]))
    if "dampening" in flags:
        sets.append(("train.dampening", flags["dampening"]))
    if "nesterov" in flags:
        sets.append(("train.nesterov",
                     "true" if _boolish(flags["nesterov"]) else "false"))
        if flags["nesterov"].strip().lower() == "false":
            notes.append("heads-up: the reference's argparse type=bool "
                         "treats the string 'False' as True — translating "
                         "the intended meaning (nesterov off)")
    if "sgdadjust" in flags:
        sets.append(("train.schedule",
                     "plateau" if int(flags["sgdadjust"]) == 1 else "step"))
    if "sgdstep" in flags:
        sets.append(("train.step_size", flags["sgdstep"]))
    if "sgdgamma" in flags:
        sets.append(("train.gamma", flags["sgdgamma"]))
    if "LFB_l" in flags:
        sets.append(("memory.window", flags["LFB_l"]))
    if "gpu" in flags:
        notes.append("-g/--gpu has no equivalent (the port runs on the "
                     "card unless --device cpu; one process a card comes "
                     "from mesh.multihost) — dropped")
    return sets


def _render(sub: str, preset: Optional[str],
            args: Sequence[Tuple[str, Optional[str]]],
            sets: Sequence[Tuple[str, str]]) -> str:
    parts = ["python -m tmrnet_torch", sub]
    if preset:
        parts.append(f"--preset {preset}")
    for k, v in args:
        parts.append(k if v is None else f"{k} {_quote(v)}")
    for k, v in sets:
        parts.append(f"--set {k}={v}")
    return " ".join(parts)


# ---------------------------------------------------------------------------
# Per-family emitters
# ---------------------------------------------------------------------------


def _emit_train1(argv, preset, spec, notes):
    flags = _parse_flags(argv, spec, notes)
    sets = _common_sets(flags, notes)
    args = []
    if "csv_train" in flags:
        args.append(("--train-manifest", flags["csv_train"]))
        if "csv_valid" in flags:
            args.append(("--val-manifest", flags["csv_valid"]))
    else:
        args.append(("--train-manifest", "train_val_paths_labels.pkl"))
        notes.append("the reference hard-codes its manifest paths "
                     "(`train_singlenet_phase_1fc.py:429-432`); point "
                     "--train-manifest at yours — a 6-list pickle carries "
                     "both splits (val loads from the same file)")
    return [_render("train-bank", preset, args, sets)]


def _emit_train2(argv, preset, spec, notes, videos=False):
    flags = _parse_flags(argv, spec, notes)
    sets = _common_sets(flags, notes)
    bank = "./LFB/lfb.npz"
    if videos:
        mount = flags.get("mount_point", "<videos-dir>")
        data_args = [("--videos", mount)]
        notes.append("video-direct fork driver: clips decode straight from "
                     ".mp4 files under --videos (the fork's "
                     "--train_csv/--mount_point listing); labels come from "
                     "--annotations <phase-annotation dir>")
        notes.append("note: this reference driver is broken as published "
                     "(undefined names, SURVEY §2.9) — the translation "
                     "follows its intent")
    else:
        data_args = [("--train-manifest", "train_val_paths_labels.pkl")]
        notes.append("the reference hard-codes its manifest paths; point "
                     "--train-manifest at yours")
    bl_args = [("--manifest", "train_val_paths_labels.pkl")]
    if videos:
        notes.append("build-lfb needs a frame manifest (the video engine "
                     "extracts per-frame features once per video)")
    if "model_path" in flags:
        bl_args.append(("--torch-ckpt", flags["model_path"]))
    else:
        bl_args.append(("--ckpt", STAGE1_CKPT))
        notes.append(_WEIGHTS_NOTE.format(cmd="build-lfb", flag="--ckpt",
                                          path=STAGE1_CKPT))
    bl_args.append(("--out", bank))
    tt_args = list(data_args) + [("--lfb", bank)]
    if "model_path" in flags:
        tt_args.append(("--torch-init", flags["model_path"]))
        notes.append("--model_path loads the stage-1 .pth both as the "
                     "frozen LFB extractor (build-lfb --torch-ckpt) and as "
                     "the head's strict=False init (train-tmr --torch-init),"
                     " like the reference "
                     "(`train_non-local_mutiConv_resnet.py:707,774`)")
    cmds = [_render("build-lfb", preset, bl_args, sets),
            _render("train-tmr", preset, tt_args, sets)]
    if _boolish(flags.get("load_LFB", "True")):
        notes.append("--load_LFB True: skip the build-lfb step if the bank "
                     "already exists — or pass a reference g_LFB .pkl "
                     "straight to --lfb (both formats load)")
    return cmds


def _emit_test(argv, preset, spec, notes, six_class=False):
    flags = _parse_flags(argv, spec, notes)
    sets = _common_sets(flags, notes)
    if six_class:
        sets.append(("model.num_classes", "6"))
        notes.append("the mutiConv6_3 eval driver is the fork's 6-class "
                     "model (`test_..._mutiConv6_3.py:126-168`)")
    args = [("--manifest", flags.get("csv", "test_paths.pkl"))]
    model = flags.get("name") or flags.get("model")
    if not model:
        model = MODEL_PTH
        notes.append(_WEIGHTS_NOTE.format(cmd="test", flag="--torch-ckpt",
                                          path=MODEL_PTH))
    args.append(("--torch-ckpt", model))
    if "lfb_model" in flags:
        args.append(("--extractor-torch-ckpt", flags["lfb_model"]))
    if "csv" not in flags:
        notes.append("the reference hard-codes ./test_paths_hyst.pkl "
                     "(`test_..._2fc_copy.py:462-466`); point --manifest "
                     "at your test pickle")
    notes.append("add --ref-pickle preds.pkl for reference-format "
                 "prediction/score pickles; then chain "
                 "`export --name-fmt 'video{vid}-phase.txt'` and "
                 "`evaluate` for the Main.m protocol tables")
    return [_render("test", preset, args, sets)]


def _emit_export(argv, notes):
    spec = {"seq": ("-s", "--seq"), "name": ("-n", "--name")}
    flags = _parse_flags(argv, spec, notes)
    sets = []
    if "seq" in flags and int(flags["seq"]) != 10:
        sets.append(("data.sequence_length", flags["seq"]))
    args = [("--manifest", "cholec80.pkl"),
            ("--preds", flags.get("name", "predictions.npz")),
            ("--name-fmt", "video{vid}-phase.txt")]
    notes.append("--preds accepts the reference's prediction .pkl or this "
                 "framework's .npz; the manifest is the reference's "
                 "cholec80.pkl (nested per-video pickle) or any manifest")
    return [_render("export", None, args, sets)]


def _emit_manifest_test(argv, notes):
    spec = {"data": ("--data",), "cholec": ("--cholec",),
            "test_label": ("--test_label",)}
    flags = _parse_flags(argv, spec, notes)
    data = flags.get("data", "<data-root>")
    args = [("--frames", os.path.join(data, "frames")),
            ("--annotations", os.path.join(data, "phase_annotations")),
            ("--out", flags.get("test_label", "test_paths.pkl"))]
    notes.append("writes the 3-list test pickle (no --train-videos split); "
                 "the reference script also has the undeclared "
                 "args.outfile bug (SURVEY §2.9-6), not carried here")
    return [_render("manifest", None, args, [])]


_M2CAI_NOTE = ("Main_m2cai.m: 8 phases, videos 1-14, fps 25 — all from "
               "--protocol m2cai")


def translate(tokens: Sequence[str]) -> Dict[str, List[str]]:
    """tokens: the reference command line, split (e.g. via shlex).
    Returns {"commands": [...], "notes": [...]}."""
    script, argv = None, []
    for i, t in enumerate(tokens):
        base = os.path.basename(t)
        if base.endswith((".py", ".m")):
            script, argv = base, list(tokens[i + 1:])
            break
    if script is None:
        raise MigrateError(
            "no reference script (.py/.m) found in the command — pass the "
            "command you used to run the reference, e.g. "
            "migrate -- python train_non-local_mutiConv_resnet.py -t 90")

    notes: List[str] = []
    t2 = dict(_TRAIN_COMMON, **_STAGE2_EXTRA)
    if script == "train_singlenet_phase_1fc.py":
        cmds = _emit_train1(argv, "memorybank", _TRAIN_COMMON, notes)
    elif script == "train_memorybank.py":
        cmds = _emit_train1(argv, "memorybank", _FORK_TRAIN, notes)
        notes.append("the fork driver is broken as published (stray "
                     "pdb.set_trace, scheduler never constructed — SURVEY "
                     "§2.9-2); the translation follows its intent")
    elif script == "test-new-ds.py":
        flags = _parse_flags(argv, _VIDEO_DIRECT, notes)
        sets = _common_sets(flags, notes)
        cmds = [_render("train-bank", "memorybank",
                        [("--videos", flags.get("mount_point",
                                                "<videos-dir>"))], sets)]
        notes.append("video-direct stage-1 (broken in the reference, "
                     "SURVEY §2.9-3): clips decode straight from .mp4 "
                     "under --videos; labels via --annotations")
    elif script == "train_non-local_mutiConv_resnet.py":
        cmds = _emit_train2(argv, "tmr-resnet50", t2, notes)
    elif script == "train_non-local_mutiConv_resnest.py":
        cmds = _emit_train2(argv, "tmr-resnest50", t2, notes)
    elif script == "train_only_non-local_pretrained.py":
        cmds = _emit_train2(argv, "tmr-nl-only", t2, notes)
    elif script == "test-resnet.py":
        cmds = _emit_train2(argv, "tmr-resnet50", _VIDEO_DIRECT, notes,
                            videos=True)
    elif script == "test_singlenet_phase_non-local_pretrained_2fc_copy.py":
        cmds = _emit_test(argv, "tmr-resnet50", _EVAL_COMMON, notes)
    elif script == ("test_singlenet_phase_non-local_pretrained_2fc_copy"
                    "_mutiConv6_3.py"):
        cmds = _emit_test(argv, "tmr-resnet50", _EVAL_CSV, notes,
                          six_class=True)
    elif script == ("test_singlenet_phase_non-local_pretrained_2fc_copy"
                    "_mutiConv6_resnest.py"):
        cmds = _emit_test(argv, "tmr-resnest50", _EVAL_COMMON, notes)
    elif script == "export_phase_copy.py":
        cmds = _emit_export(argv, notes)
    elif script == "update_get_paths_labels.py":
        cmds = _emit_manifest_test(argv, notes)
    elif script == "get_paths_labels.py":
        cmds = [_render("manifest", None,
                        [("--frames", "<root>/cutMargin"),
                         ("--annotations", "<root>/phase_annotations"),
                         ("--train-videos", "32"),
                         ("--out", "train_val_paths_labels.pkl")], [])]
        notes.append("the reference script takes no flags (paths "
                     "hard-coded); 32/8 is its train/val video split, and "
                     "video dirs sort numerically exactly like its "
                     "sort(key=int)")
    elif script == "meanStd.py":
        cmds = [_render("stats", None,
                        [("--manifest", "train_val_paths_labels.pkl")], [])]
        notes.append("default stats reproduce meanStd.py exactly (224 "
                     "resize, mean of per-image means/stds); "
                     "--population --no-resize gives pooled-pixel stats")
    elif script == "video2frame_cutmargin.py":
        cmds = [_render("prepare", None,
                        [("--videos", "<videos-dir>"),
                         ("--out", "<frames-dir>")], [])]
        notes.append("the reference script hard-codes its paths; prepare "
                     "decodes at 1 fps, cutmargins (reference-exact "
                     "bounding box) and resizes to 250 px")
    elif script == "Main.m":
        cmds = [_render("evaluate", None,
                        [("--pred-dir", "./eval/phase"),
                         ("--gt-dir", "./eval/gt-phase"),
                         ("--protocol", "cholec80")], [])]
        notes.append("the full Python port of Main.m/Evaluate.m (relaxed "
                     "10 s boundaries, MATLAB nanmean/clamp semantics); "
                     "add --matlab-compat to also reproduce "
                     "ReadPhaseLabel.m's unconditional first-row drop")
    elif script == "Main_m2cai.m":
        cmds = [_render("evaluate", None,
                        [("--pred-dir", "./eval/phase"),
                         ("--gt-dir", "./eval/gt-phase"),
                         ("--protocol", "m2cai")], [])]
        notes.append(_M2CAI_NOTE)
    else:
        raise MigrateError(
            f"unknown reference script {script!r} — known scripts: the 5 "
            "training drivers, 3 eval drivers, export_phase_copy.py, "
            "get_paths_labels.py / update_get_paths_labels.py, meanStd.py, "
            "video2frame_cutmargin.py, Main.m / Main_m2cai.m")
    return {"commands": cmds, "notes": notes}
