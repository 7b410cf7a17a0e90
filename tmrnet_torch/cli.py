"""Command line of the port: `python -m tmrnet_torch <command>`.

  manifest   frames dir + phase annotations -> manifest pickle/CSV
  build-lfb  the frozen extractor's feature bank of a manifest -> .npz
  test       test-set inference -> predictions .npz, per-class
             precision/recall and accuracy
  serve      serving daemon: JSONL frame events on stdin (or TCP clients
             with --listen) -> predictions on stdout (or the owning
             connection)

Port of `tmrnet_tpu/cli.py` (`_load_manifest` :74, `_clip_labels` :145,
`_dataset` :153-175, `cmd_manifest` :314-347, `cmd_build_lfb` :517-575,
`cmd_test` :632-824, `cmd_serve` :1041-1152, their parsers), with
weights from reference-format `.pth` files only (`--torch-ckpt`,
`--extractor-torch-ckpt`; `_restore_variables` :233-275 and
`_extractor_for` :122-142). Entry points run on the card unless `--device
cpu` asks for the CPU. Not ported: video-direct datasets (`--videos`; the
card's machine has no decoder), Orbax checkpoints (`--ckpt`), meshes.

Config: --config <json> loads an ExperimentConfig (a JSON written by either
package; fields the port lacks are skipped, and a `config_ignored` line on
stderr names those that JAX would honour at another value than its
default); --set a.b=c applies dotted overrides (a field the port lacks
raises).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import pickle
import signal
import sys
from typing import Dict, List, Optional

import numpy as np

from tmrnet_torch.config import (CHOLEC80_PHASES, M2CAI_PHASES, ExperimentConfig,
                                 apply_override, ignored_fields)


def load_config(args) -> ExperimentConfig:
    if getattr(args, "config", None):
        with open(args.config) as f:
            text = f.read()
        cfg = ExperimentConfig.from_json(text)
        ignored = ignored_fields(text)
        if ignored:
            print(json.dumps({"config_ignored": ignored}), file=sys.stderr,
                  flush=True)
    else:
        cfg = ExperimentConfig()
    for o in getattr(args, "set", None) or []:
        cfg = apply_override(cfg, o)
    return cfg


def restore_state(cfg: ExperimentConfig, head: str, torch_ckpt: str) -> Dict:
    """The unfolded state dict of `head` from a reference `.pth`, through
    the port's import; a checkpoint that lacks a key the head needs
    raises and names it."""
    from tmrnet_torch.models.torch_import import (
        convert_reference_checkpoint, load_torch_state_dict, require_complete)

    state = convert_reference_checkpoint(load_torch_state_dict(torch_ckpt),
                                         head, cfg.model.stage_sizes)
    require_complete(state, dataclasses.replace(cfg.model, head=head))
    return state


def extractor_state(cfg: ExperimentConfig, state: Dict,
                    extractor_torch_ckpt: Optional[str]) -> Dict:
    """The frozen extractor's weights: head `lfb` from its own `.pth` when
    given, else the `backbone.*` and `encoder.*` entries of the model's."""
    if extractor_torch_ckpt:
        state = restore_state(cfg, "lfb", extractor_torch_ckpt)
    return {k: v for k, v in state.items()
            if k.startswith(("backbone.", "encoder."))}


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


def load_manifest(path: str):
    """A manifest by extension: `.csv`, else a reference pickle (the train
    split of a 6-list)."""
    from tmrnet_torch.data.manifests import load_csv_manifest, load_pickle_manifest

    if path.endswith(".csv"):
        return load_csv_manifest(path)
    return load_pickle_manifest(path)[0]


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


def frame_loader(cfg: ExperimentConfig):
    """The daemon's frame loader: a path (`<file>.npy#<idx>` or an image
    file) -> one transformed frame, uint8 under `data.device_normalize`,
    else normalized float32. Numpy and cv2 only: decode threads run it."""
    from tmrnet_torch.data.pipeline import load_frame

    tf = eval_transform(cfg)
    return lambda path: tf(np.stack([load_frame(path)]))[0]


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
    phases = CHOLEC80_PHASES if args.protocol == "cholec80" else M2CAI_PHASES
    m = build_manifest_from_frames(frames, annotations, phases,
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


def cmd_build_lfb(args) -> int:
    """The bank of a manifest from the extractor's `.pth` (head lfb), built
    by the video engine (default; one backbone pass per frame) or the clip
    engine, which crop types outside 1/2/3 fall back to."""
    from tmrnet_torch.device import resolve_device
    from tmrnet_torch.train.loop import build_lfb

    device = resolve_device(args.device)
    cfg = load_config(args)
    if args.engine is None:
        args.engine = ("clip" if cfg.data.test_crop_type not in (1, 2, 3)
                       else "video")
    ds = dataset(cfg, load_manifest(args.manifest))
    state = restore_state(cfg, "lfb", args.torch_ckpt)
    extractor, = folded_weights(cfg, extractor_state(cfg, state, None))
    del state
    bank = build_lfb(cfg, extractor, ds, cache_path=args.out, force=True,
                     engine=args.engine, device=device)
    print(f"bank: {bank.num_rows} rows x {bank.feature_dim} -> {args.out}")
    return 0


def _video_engine_results(cfg, state, extractor, manifest, device):
    """`test --engine video|corpus`: every video's (preds, probs) from a
    VideoInference, the whole set as one stream (eval.corpus), same-bucket
    groups of eval.video_batch videos, or one video at a time."""
    from tmrnet_torch.data.pipeline import load_frame
    from tmrnet_torch.eval.infer import VideoInference

    engine = VideoInference(cfg, state, extractor, device=device)
    tf = eval_transform(cfg)

    def load_video(video):
        return tf(np.stack([load_frame(p) for p in video.frame_paths]))

    videos = manifest.videos
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
    head (stage1)."""
    from tmrnet_torch.device import resolve_device
    from tmrnet_torch.eval.infer import (ClipInference, InferenceResult,
                                         memoryless_head)
    from tmrnet_torch.eval.metrics import classification_metrics
    from tmrnet_torch.memory.lfb import load_bank
    from tmrnet_torch.train.loop import build_lfb

    device = resolve_device(args.device)
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
    m = load_manifest(args.manifest)
    seq = cfg.data.sequence_length
    labels = clip_labels(m, seq)
    state = restore_state(cfg, cfg.model.head, args.torch_ckpt)
    if args.engine == "video":
        state, extractor = folded_weights(
            cfg, state, extractor_state(cfg, state, args.extractor_torch_ckpt))
        results = _video_engine_results(cfg, state, extractor, m, device)
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
                cfg, extractor_state(cfg, state, args.extractor_torch_ckpt))
            bank = build_lfb(cfg, extractor, ds, cache_path=args.lfb,
                             force=not args.load_lfb, device=device)
            del extractor
        state, = folded_weights(cfg, state)
        res = ClipInference(cfg, state, bank, device=device).run(ds)
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


def cmd_serve(args) -> int:
    """Serving daemon: JSONL protocol on stdin/stdout, or over TCP with
    --listen, over B stream slots (eval/serve.py). Streams join on their
    first frame, leave on "end", and any number of them multiplex onto the
    fixed slots; `{"step": true}` runs one tick."""
    if args.listen and args.input != "-":
        # fail before the (slow) weight restore and engine build
        raise SystemExit("--listen and --input are exclusive "
                         "(TCP clients replace the input file)")
    from tmrnet_torch.device import resolve_device
    from tmrnet_torch.eval.serve import serve_loop
    from tmrnet_torch.eval.stream import StreamingInference

    device = resolve_device(args.device)
    cfg = load_config(args)
    if cfg.data.test_crop_type not in (1, 2, 3):
        raise SystemExit(
            "serve needs a deterministic frame-wise crop (test_crop_type "
            f"1/2/3, got {cfg.data.test_crop_type}): multi-crop and per-clip "
            "random crops have no streaming equivalent")
    state = restore_state(cfg, cfg.model.head, args.torch_ckpt)
    state, extractor = folded_weights(
        cfg, state, extractor_state(cfg, state, args.extractor_torch_ckpt))
    engine = StreamingInference(cfg, state, extractor, device=device)
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
            engine, args.slots,
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


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="python -m tmrnet_torch",
                                     description=__doc__.splitlines()[0])
    sub = parser.add_subparsers(dest="command", required=True)

    def config_args(sp):
        sp.add_argument("--config", help="path to ExperimentConfig json")
        sp.add_argument("--set", action="append", metavar="KEY=VALUE",
                        help="dotted config override, repeatable")

    def device_arg(sp):
        sp.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")

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

    sp = sub.add_parser("build-lfb", help="build the feature bank")
    config_args(sp)
    sp.add_argument("--manifest", required=True)
    sp.add_argument("--torch-ckpt", required=True,
                    help="reference-format .pth of the extractor (head lfb)")
    sp.add_argument("--engine", choices=["clip", "video"], default=None,
                    help="'video' builds the bank at one backbone pass per "
                         "frame (crop types 1/2/3); default: video, falling "
                         "back to clip for other crop types")
    sp.add_argument("--out", required=True)
    device_arg(sp)
    sp.set_defaults(fn=cmd_build_lfb)

    sp = sub.add_parser("test", help="test-set inference -> predictions npz")
    config_args(sp)
    sp.add_argument("--manifest", required=True)
    sp.add_argument("--torch-ckpt", required=True,
                    help="reference-format .pth of the model (head "
                         "model.head)")
    sp.add_argument("--extractor-torch-ckpt",
                    help="reference-format .pth of the LFB extractor (head "
                         "lfb); default: the model's trunk and LSTM")
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

    sp = sub.add_parser("serve", help="serving daemon: JSONL frame events "
                                      "on stdin -> predictions on stdout")
    config_args(sp)
    sp.add_argument("--torch-ckpt", required=True,
                    help="reference-format .pth of the model (head "
                         "model.head)")
    sp.add_argument("--extractor-torch-ckpt",
                    help="reference-format .pth of the LFB extractor (head "
                         "lfb); default: the model's trunk and LSTM")
    device_arg(sp)
    sp.add_argument("--slots", type=int, default=16,
                    help="stream slots (max concurrent streams)")
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
    return parser


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)
