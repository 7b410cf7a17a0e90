"""Command line of the port: `python -m tmrnet_torch <command>`.

  serve   serving daemon: JSONL frame events on stdin (or TCP clients with
          --listen) -> predictions on stdout (or the owning connection)

Port of `tmrnet_tpu/cli.py::cmd_serve` (:1041-1152) and its parser
(:1805-1856), with weights from reference-format `.pth` files only
(`--torch-ckpt`, `--extractor-torch-ckpt`; `_restore_variables` :233-275
and `_extractor_for` :122-142). Entry points run on the card unless
`--device cpu` asks for the CPU.

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
import signal
import sys
from typing import Dict, List, Optional

import numpy as np

from tmrnet_torch.config import ExperimentConfig, apply_override, ignored_fields


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


def frame_loader(cfg: ExperimentConfig):
    """The daemon's frame loader: a path (`<file>.npy#<idx>` or an image
    file) -> one transformed frame, uint8 under `data.device_normalize`,
    else normalized float32. Numpy and cv2 only: decode threads run it."""
    from tmrnet_torch.data.pipeline import load_frame
    from tmrnet_torch.data.transforms import EvalTransform

    d = cfg.data
    tf = EvalTransform(d.crop_size, d.resize, d.test_crop_type, d.mean,
                       d.std, normalize=not d.device_normalize)
    return lambda path: tf(np.stack([load_frame(path)]))[0]


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
    from tmrnet_torch.models.fold_bn import fold_variables

    device = resolve_device(args.device)
    cfg = load_config(args)
    if cfg.data.test_crop_type not in (1, 2, 3):
        raise SystemExit(
            "serve needs a deterministic frame-wise crop (test_crop_type "
            f"1/2/3, got {cfg.data.test_crop_type}): multi-crop and per-clip "
            "random crops have no streaming equivalent")
    state = restore_state(cfg, cfg.model.head, args.torch_ckpt)
    extractor = extractor_state(cfg, state, args.extractor_torch_ckpt)
    if cfg.model.folded:
        # BN folded into the convs; only a folded backbone launches the
        # fused identity-block kernels
        state, extractor = fold_variables(state), fold_variables(extractor)
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

    sp = sub.add_parser("serve", help="serving daemon: JSONL frame events "
                                      "on stdin -> predictions on stdout")
    sp.add_argument("--config", help="path to ExperimentConfig json")
    sp.add_argument("--set", action="append", metavar="KEY=VALUE",
                    help="dotted config override, repeatable")
    sp.add_argument("--torch-ckpt", required=True,
                    help="reference-format .pth of the model (head "
                         "model.head)")
    sp.add_argument("--extractor-torch-ckpt",
                    help="reference-format .pth of the LFB extractor (head "
                         "lfb); default: the model's trunk and LSTM")
    sp.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
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
