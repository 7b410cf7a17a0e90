"""Frames/s of `chip_smoke.py`'s clip slice (phase 4: full-width TMRNet,
BN folded, bf16, 3 requests of 32 uint8 clips of 10 224x224 frames over a
4096x512 bank), or the step latency of its stream slice (phase 4d: the
TMRNet and the LFB extractor, 16 streams of uint8 224x224 frames, one
frame a stream a step), run several times in one process, of this
checkout or of another one, such as an older commit unpacked by `git
archive`:

    python3 tmrnet_torch/experimental/clip_slice_timing.py [--root DIR]
        [--runs 5] [--slice clip|stream] [--fused-kernel block|tiled]
        [--steps 48]

Run it as a file, not with `-m`: `chip_smoke` and `tmrnet_torch` are then
imported from the root given, so two trees are compared by running the
script once for each, in turns, in one call on one card. A clip run is
the smoke's own `run_slice` (a warm-up request, then the timed ones, host
clock around work that ends in a copy to the host, launch counts and the
CPU check in f32 held); one untimed run comes first. A stream run builds
the smoke's engines (`engine_setup`), steps 16 streams `--steps` times
and times the steps after 4 warm-up ones, host clock around each step
and the copy of its outputs to the host; every step's launches are held
to 24 fused_bottleneck, 1 time_conv and 1 nl_attention. Prints one JSON
line with the card's name and power limit and each run's frames/s (clip)
or step p50 and p99 ms (stream); exits 1 if a run's checks failed.

Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

STREAMS, WARM = 16, 4
PER_STEP = {"fused_bottleneck": 24, "time_conv": 1, "nl_attention": 1}
PER_FORWARD = {
    "block": {"fused_bottleneck": 12, "time_conv": 1, "nl_attention": 1},
    "tiled": {"fused_bottleneck_tiled": 10, "fused_bottleneck": 2,
              "time_conv": 1, "nl_attention": 1},
}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root",
                        default=str(Path(__file__).resolve().parents[2]))
    parser.add_argument("--runs", type=int, default=5)
    parser.add_argument("--slice", choices=("clip", "stream"),
                        default="clip")
    parser.add_argument("--fused-kernel", choices=sorted(PER_FORWARD),
                        default="block")
    parser.add_argument("--steps", type=int, default=48)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    sys.path.insert(0, str(Path(args.root).resolve()))

    import torch

    import chip_smoke
    from tmrnet_torch.kernels.build import build_all

    if not torch.cuda.is_available():
        raise RuntimeError("clip_slice_timing needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    build_all()
    card = chip_smoke.card_line()
    if args.slice == "stream":
        runs, ok = stream_runs(torch, chip_smoke, args)
        print(json.dumps({"root": args.root, "slice": "stream",
                          "streams": STREAMS, "steps": args.steps,
                          "runs": runs, "card": card, "ok": ok}))
        return 0 if ok else 1
    setup = chip_smoke.slice_setup(torch, args.seed)
    rates, ok = [], True
    for i in range(args.runs + 1):
        _, fps, _, good = chip_smoke.run_slice(
            torch, setup, card, args.fused_kernel,
            PER_FORWARD[args.fused_kernel])
        ok &= good
        if i:
            rates.append(fps)
    print(json.dumps({"root": args.root, "fused_kernel": args.fused_kernel,
                      "frames_per_s": rates, "card": card, "ok": ok}))
    return 0 if ok else 1


def stream_runs(torch, chip_smoke, args):
    """`--runs` runs of the stream slice: ([{p50_ms, p99_ms}], ok)."""
    import time

    import numpy as np

    from tmrnet_torch.eval.stream import StreamingInference
    from tmrnet_torch.kernels.build import LAUNCHES, reset_launches

    ecfg, weights = chip_smoke.engine_setup(args.seed)
    img = chip_smoke.IMG
    frames = np.random.default_rng(args.seed + 4).integers(
        0, 256, (args.steps, STREAMS, img, img, 3), dtype=np.uint8)
    runs, ok = [], True
    for _ in range(args.runs):
        engine = StreamingInference(ecfg, *weights, fused_kernel="block")
        state = engine.init_state(STREAMS)
        times = []
        for t in range(args.steps):
            torch.cuda.synchronize()
            reset_launches()
            t0 = time.perf_counter()
            state, _, probs, valid = engine.step(state, frames[t])
            probs.cpu(), valid.cpu()
            if t >= WARM:
                times.append((time.perf_counter() - t0) * 1e3)
            ok &= dict(LAUNCHES) == PER_STEP
        runs.append({"p50_ms": float(np.percentile(times, 50)),
                     "p99_ms": float(np.percentile(times, 99))})
        del engine, state
    return runs, ok


if __name__ == "__main__":
    sys.exit(main())
