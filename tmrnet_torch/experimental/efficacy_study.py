"""Learning-efficacy study: the stage-1 -> LFB -> stage-2 pipeline learns
temporal structure, end to end through the port's command line.

    python -m tmrnet_torch.experimental.efficacy_study --work DIR
        [--seeds 0 1] [--full-scale] [--device cuda|cpu] ...

Port of `scripts/efficacy_study.py` (`run_cli` :34, `common_overrides`
:50-79, `train_and_score` :82, `multiscale_metrics` :107, `score_arm`
:142, `run_study` :175, `main` :220-300), over the synthetic
memory-dependent task of `tmrnet_torch/data/synthetic.py`: phases 1/4 and
3/6 are pixel-identical, told apart only by the phase before them, which
lies outside the 10-frame clip but inside the 30-row memory window. Every
step runs through `tmrnet_torch.cli.main` in this process: synth ->
manifest -> train-bank -> test (the stage-1 arm) -> build-lfb (train, val)
-> train-tmr (each head) -> test -> export -> evaluate. The arms, the
rows (stdout JSON lines and `efficacy_results.json`) and the margin
summary are JAX's.

The tiny default (backbone tiny, f32) runs on the CPU only (`--device
cpu`): the card's kernels need C and P to be multiples of 64.
`--full-scale` is ResNet-50 at 224² crops of 250² frames, hidden 512,
bf16; `--set model.compute_dtype=float32` makes it f32 (TF32 off, as the
commands set it). What the card adds, printed in the first JSON line:
`--device` on every command that takes it; on the card, in bf16 and in
f32, `model.folded=true` on `test` and `build-lfb` (the identity blocks
run the fused kernels, bf16 or f32 by the trunk's dtype); and, where cv2
does not import,
`data.use_flip=false` (crop and flip only, since the colour jitter and
the rotation are cv2's), named by `recipe`. After each seed's rows, a
JSON line gives each command's seconds.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import sys
import time

from tmrnet_torch.cli import main as cli_main

# Commands of the study that run a model and so take --device.
DEVICE_COMMANDS = ("train-bank", "build-lfb", "train-tmr", "test")
FULL_SCALE = {"hw": 250, "hidden": 512, "backbone": "resnet50",
              "compute_dtype": "bfloat16"}


def have_cv2() -> bool:
    """Whether cv2, which the colour jitter and the rotation need,
    imports."""
    try:
        import cv2  # noqa: F401
    except ImportError:
        return False
    return True


def card_sets(device: str) -> tuple:
    """Overrides every arm takes on `device`: on the card where cv2 does
    not import, crop and flip only; else none (JAX's recipe)."""
    return (("data.use_flip=false",) if device != "cpu" and not have_cv2()
            else ())


def recipe(device: str) -> str:
    """The augmentation `card_sets(device)` leaves: the reference's
    (crop, flip, colour jitter, rotation) or crop and flip alone."""
    return "crop_and_flip" if card_sets(device) else "reference"


def set_value(argv, key: str, default: str) -> str:
    """The value a command line's `--set`s give `key` (the last one wins,
    as in the CLI), else `default`."""
    value = default
    for a, b in zip(argv, argv[1:]):
        if a == "--set" and b.startswith(key + "="):
            value = b.split("=", 1)[1]
    return value


def run_cli(argv, device: str = "cuda", clock=None) -> str:
    """One in-process CLI invocation (with --device where the command takes
    it); returns captured stdout. `clock`, a dict, gains the command's
    seconds under its name."""
    argv = [str(a) for a in argv]
    if argv[0] in DEVICE_COMMANDS:
        argv += ["--device", device]
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(argv)
    if clock is not None:
        clock[argv[0]] = clock.get(argv[0], 0.0) + time.perf_counter() - t0
    out = buf.getvalue()
    if rc != 0:
        raise RuntimeError(f"CLI {argv[0]} failed rc={rc}:\n{out}")
    return out


def last_json(text: str) -> dict:
    lines = [ln for ln in text.strip().splitlines() if ln.startswith("{")]
    return json.loads(lines[-1]) if lines else {}


def common_overrides(work: str, seed: int, hw: int = 32, hidden: int = 32,
                     batch: int = 16, backbone: str = "tiny",
                     compute_dtype: str = "float32",
                     task: str = "pairs", extra_sets=()) -> list:
    """Config shared by every arm. The tiny defaults run on the CPU (the
    task's structure, not its scale, is what the study measures); the
    full scale is ResNet-50 at 224px, bf16. task='multiscale' switches to
    the 12-phase tmr-vs-nl_only ranking task (window 40,
    `data/synthetic.py::MULTISCALE_SPEC`)."""
    sets = [
        f"data.crop_size={224 if hw >= 224 else hw - 4}",
        f"data.resize={hw}",
        "data.mean=0.5,0.5,0.5", "data.std=0.25,0.25,0.25",
        f"data.batch_clips={batch}", "data.num_workers=2", "data.prefetch=2",
        f"model.backbone={backbone}", f"model.hidden_dim={hidden}",
        f"model.compute_dtype={compute_dtype}",
        f"train.seed={seed}", "train.schedule=constant",
        "train.log_every=1000",
    ]
    if task == "multiscale":
        from tmrnet_torch.data.synthetic import MULTISCALE_SEQ, MULTISCALE_WINDOW

        sets += ["model.num_classes=12",
                 f"memory.window={MULTISCALE_WINDOW}",
                 f"data.sequence_length={MULTISCALE_SEQ}"]
    else:
        sets.append("memory.window=30")
    sets.extend(extra_sets)
    return [x for s in sets for x in ("--set", s)]


def folded_sets(device: str) -> list:
    """`test` and `build-lfb` on the card fold BN, so that the identity
    blocks run the fused kernels, bf16 or f32 by the trunk's dtype; the
    CPU's run unfolded."""
    return ["--set", "model.folded=true"] if device != "cpu" else []


def train_and_score(work: str, seed: int, head: str, stage1_dir: str,
                    epochs: int, lr: float, scale: dict = {},
                    task: str = "pairs", stage2_sets=(), device: str = "cuda",
                    clock=None) -> dict:
    """Stage-2 training (tmr | nl_only) and protocol scoring of the result.
    stage2_sets: extra overrides applied ONLY to the stage-2 arms (e.g.
    train.optimizer=adam to ablate the head optimizer while keeping the
    stage-1 baseline arm canonical)."""
    ckpt = os.path.join(work, f"ckpt-{head}-s{seed}")
    s2 = {**scale, "extra_sets":
          tuple(scale.get("extra_sets", ())) + tuple(stage2_sets)}
    ov = common_overrides(work, seed, task=task, **s2)
    run_cli(["train-tmr",
             "--train-manifest", f"{work}/train.pkl",
             "--val-manifest", f"{work}/val.pkl",
             "--lfb", f"{work}/lfb_train.npz",
             "--val-lfb", f"{work}/lfb_val.npz",
             "--stage1-ckpt", stage1_dir,
             "--log-dir", f"{work}/logs-{head}-s{seed}",
             *ov, "--set", f"model.head={head}",
             "--set", f"train.epochs={epochs}", "--set", f"train.lr={lr}",
             "--set", f"train.checkpoint_dir={ckpt}"], device, clock)
    return score_arm(work, seed, head, ckpt, extractor=stage1_dir,
                     scale=s2, task=task, device=device, clock=clock)


def multiscale_metrics(manifest_path: str, preds_path: str,
                       seq: int = 0) -> dict:
    """Task-specific scores for the 12-phase multiscale task: accuracy on
    the DESIGNED pair (phases 5 vs 11, provably a coin flip for any model
    reading the window as an unordered row multiset, nl_only included),
    and unrelaxed macro-Jaccard over all phases. The 7-phase reference
    protocol scorer does not apply here."""
    import numpy as np

    from tmrnet_torch.data.indexing import clip_start_indices
    from tmrnet_torch.data.manifests import load_pickle_manifest
    from tmrnet_torch.data.synthetic import (MULTISCALE_PAIR, MULTISCALE_SEQ,
                                             MULTISCALE_SPEC)

    seq = seq or MULTISCALE_SEQ
    m, _ = load_pickle_manifest(manifest_path)
    starts = clip_start_indices(seq, m.video_lengths)
    y = m.flat_labels()[starts + seq - 1]
    p = np.load(preds_path)["preds"]
    assert len(p) == len(y), (len(p), len(y))
    mask = np.isin(y, MULTISCALE_PAIR)
    jac = []
    for c in range(len(MULTISCALE_SPEC)):
        inter = int(((p == c) & (y == c)).sum())
        union = int(((p == c) | (y == c)).sum())
        if union:
            jac.append(inter / union)
    return {"pair_accuracy": float((p[mask] == y[mask]).mean()),
            "macro_jaccard": float(np.mean(jac))}


def score_arm(work: str, seed: int, arm: str, ckpt: str,
              extractor: str = "", scale: dict = {},
              task: str = "pairs", device: str = "cuda", clock=None) -> dict:
    """test -> export -> evaluate for one trained arm; returns its numbers
    (multiscale: test -> pair and Jaccard scores, since the reference
    protocol scorer is 7-phase)."""
    ov = common_overrides(work, seed, task=task, **scale)
    preds = f"{work}/preds-{arm}-s{seed}.npz"
    argv = ["test", "--manifest", f"{work}/test.pkl", "--ckpt", ckpt,
            "--out", preds, *ov, "--set", f"model.head={arm}",
            *folded_sets(device)]
    if extractor:
        argv += ["--extractor-ckpt", extractor]
    t = last_json(run_cli(argv, device, clock))
    if task == "multiscale":
        ms = multiscale_metrics(f"{work}/test.pkl", preds)
        return {"arm": arm, "seed": seed, "task": task,
                "clip_accuracy": t["clip_accuracy"], **ms}
    pred_dir = f"{work}/eval-{arm}-s{seed}/phase"
    gt_dir = f"{work}/eval-{arm}-s{seed}/gt-phase"
    run_cli(["export", "--manifest", f"{work}/test.pkl", "--preds", preds,
             "--pred-dir", pred_dir, "--gt-dir", gt_dir], device, clock)
    jout = f"{work}/protocol-{arm}-s{seed}.json"
    run_cli(["evaluate", "--pred-dir", pred_dir, "--gt-dir", gt_dir,
             "--json-out", jout], device, clock)
    with open(jout) as f:
        rep = json.load(f)
    return {"arm": arm, "seed": seed,
            "clip_accuracy": t["clip_accuracy"],
            "protocol_accuracy": rep["mean_accuracy"],
            "protocol_jaccard": rep["mean_jaccard"]}


def scale_sets(scale: dict) -> list:
    """A scale's `extra_sets` as `--set` arguments."""
    return [x for s in scale.get("extra_sets", ()) for x in ("--set", s)]


def scale_dtype(scale: dict) -> str:
    """The compute dtype of a scale: its own, or the last of its
    `extra_sets` that names one."""
    return set_value(scale_sets(scale), "model.compute_dtype",
                     scale.get("compute_dtype", "float32"))


def check_scale(scale: dict, device: str) -> None:
    """Refuse, by name, a model the card's kernels cannot run (the tiny
    backbone, in either dtype); then, before anything is written, a card
    that is not there."""
    from tmrnet_torch.device import resolve_device

    backbone = scale.get("backbone", "tiny")
    if device != "cpu" and backbone == "tiny":
        raise SystemExit(
            f"the study's {backbone} model in {scale_dtype(scale)} runs on "
            f"the CPU only: the card's kernels need C and P to be multiples "
            f"of 64; pass --full-scale (ResNet-50) for the card, or --device "
            f"cpu")
    resolve_device(device)


def run_study(work: str, seed: int = 0, videos=(8, 2, 4),
              epochs1: int = 6, epochs2: int = 6,
              lr1: float = 0.05, lr2: float = 0.001,
              heads=("tmr", "nl_only"), hw: int = 32,
              dur=(15, 25), scale: dict = {}, task: str = "pairs",
              stage2_sets=(), device: str = "cuda", clock=None) -> list:
    """The whole pipeline for one seed. Returns one result dict per arm
    (stage1 and each stage-2 head); `clock`, a dict, gains each command's
    seconds."""
    check_scale(scale, device)
    scale = {**scale, "extra_sets": tuple(scale.get("extra_sets", ()))
             + card_sets(device)}
    os.makedirs(work, exist_ok=True)
    # 1) dataset and manifests (data seed fixed: every seed trains on the
    #    same videos; train.seed varies init, shuffles and augmentations)
    hw = scale.get("hw", hw)
    if not os.path.exists(f"{work}/test.pkl"):
        run_cli(["synth", "--out-dir", work, "--train", videos[0],
                 "--val", videos[1], "--test", videos[2], "--hw", hw,
                 "--dur-min", dur[0], "--dur-max", dur[1], "--seed", 0,
                 "--task", task], device, clock)
        for split in ("train", "val", "test"):
            run_cli(["manifest", "--frames", f"{work}/frames-{split}",
                     "--annotations", f"{work}/annotations",
                     "--stride", 1, "--out", f"{work}/{split}.pkl"],
                    device, clock)
    ov = common_overrides(work, seed, task=task, **scale)

    # 2) stage-1 memory-bank model (the frame-only baseline arm)
    s1 = f"{work}/ckpt-stage1-s{seed}"
    run_cli(["train-bank", "--train-manifest", f"{work}/train.pkl",
             "--val-manifest", f"{work}/val.pkl",
             "--log-dir", f"{work}/logs-s1-s{seed}", *ov,
             "--set", f"train.epochs={epochs1}", "--set", f"train.lr={lr1}",
             "--set", f"train.checkpoint_dir={s1}"], device, clock)
    results = [score_arm(work, seed, "stage1", s1, scale=scale, task=task,
                         device=device, clock=clock)]

    # 3) LFB banks from the frozen stage-1 extractor
    for split in ("train", "val"):
        run_cli(["build-lfb", "--manifest", f"{work}/{split}.pkl",
                 "--ckpt", s1, "--out", f"{work}/lfb_{split}.npz", *ov,
                 *folded_sets(device)], device, clock)

    # 4) stage-2 heads over the bank
    for head in heads:
        results.append(train_and_score(work, seed, head, s1, epochs2, lr2,
                                       scale=scale, task=task,
                                       stage2_sets=stage2_sets,
                                       device=device, clock=clock))
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--work", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1])
    ap.add_argument("--epochs1", type=int, default=6)
    ap.add_argument("--epochs2", type=int, default=6)
    ap.add_argument("--lr1", type=float, default=0.05)
    # stage-2 heads sit on a residual attention stack: JAX's study measured
    # 0.02 destabilizing around step ~50 (loss -> 1e21 -> NaN); 1e-3 trains
    # to val_acc 1.0 in two epochs on the synthetic task
    ap.add_argument("--lr2", type=float, default=0.001)
    ap.add_argument("--train-videos", type=int, default=8)
    ap.add_argument("--val-videos", type=int, default=2)
    ap.add_argument("--test-videos", type=int, default=4)
    ap.add_argument("--dur-min", type=int, default=15,
                    help="phase duration range; shorter videos keep the "
                         "host-bound full-scale run short")
    ap.add_argument("--dur-max", type=int, default=25)
    ap.add_argument("--heads", nargs="+", default=["tmr", "nl_only"])
    ap.add_argument("--task", choices=("pairs", "multiscale"),
                    default="pairs",
                    help="'multiscale' runs the 12-phase tmr-vs-nl_only "
                         "ranking task (window 40; --dur-min/--dur-max "
                         "ignored: the spec fixes durations)")
    ap.add_argument("--full-scale", action="store_true",
                    help="the real ResNet-50 at 224px crops, hidden 512, "
                         "bf16: the card's configuration")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; needs --full-scale) or cpu")
    ap.add_argument("--set", dest="extra_sets", action="append", default=[],
                    help="extra key=value config overrides applied to every "
                         "arm (e.g. --set train.grad_clip=5.0)")
    ap.add_argument("--stage2-set", dest="stage2_sets", action="append",
                    default=[],
                    help="extra overrides applied only to the stage-2 arms "
                         "(e.g. --stage2-set train.optimizer=adam keeps the "
                         "stage-1 baseline canonical)")
    args = ap.parse_args(argv)
    scale = dict(FULL_SCALE) if args.full_scale else {}
    if args.extra_sets:
        scale = {**scale, "extra_sets": tuple(args.extra_sets)}
    dtype = scale_dtype(scale)
    sets = scale_sets({"extra_sets": scale.get("extra_sets", ())
                       + card_sets(args.device)})
    print(json.dumps({"study": {
        "device": args.device, "full_scale": args.full_scale,
        "compute_dtype": dtype,
        "device_flag_on": list(DEVICE_COMMANDS),
        "folded_on": ["test", "build-lfb"] if folded_sets(args.device)
        else [],
        "recipe": recipe(args.device),
        "card_sets": list(card_sets(args.device)),
        "use_flip": set_value(sets, "data.use_flip", "true").lower()
        in ("true", "1")}}), flush=True)
    all_rows = []
    for seed in args.seeds:
        clock = {}
        rows = run_study(args.work, seed,
                         videos=(args.train_videos, args.val_videos,
                                 args.test_videos),
                         epochs1=args.epochs1, epochs2=args.epochs2,
                         lr1=args.lr1, lr2=args.lr2, heads=tuple(args.heads),
                         dur=(args.dur_min, args.dur_max), scale=scale,
                         task=args.task,
                         stage2_sets=tuple(args.stage2_sets),
                         device=args.device, clock=clock)
        all_rows.extend(rows)
        for r in rows:
            print(json.dumps(r))
        print(json.dumps({"seed": seed, "seconds": clock}), flush=True)
    with open(os.path.join(args.work, "efficacy_results.json"), "w") as f:
        json.dump(all_rows, f, indent=2)
    # margin summary
    by_arm = {}
    for r in all_rows:
        by_arm.setdefault(r["arm"], []).append(r["clip_accuracy"])
    base = sum(by_arm["stage1"]) / len(by_arm["stage1"])
    for arm, accs in sorted(by_arm.items()):
        mean = sum(accs) / len(accs)
        print(f"{arm:8s} clip_acc mean={mean:.4f} "
              f"(margin vs stage1: {mean - base:+.4f}) seeds={accs}")
    if args.task == "multiscale":
        by_pair = {}
        for r in all_rows:
            by_pair.setdefault(r["arm"], []).append(r["pair_accuracy"])
        for arm, accs in sorted(by_pair.items()):
            mean = sum(accs) / len(accs)
            print(f"{arm:8s} pair_acc mean={mean:.4f} seeds="
                  f"{[round(a, 4) for a in accs]}  (setwise ceiling 0.5)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
