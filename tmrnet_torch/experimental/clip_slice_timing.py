"""Frames/s of `chip_smoke.py`'s clip slice (phase 4: full-width TMRNet,
BN folded, bf16, 3 requests of 32 uint8 clips of 10 224x224 frames over a
4096x512 bank), run several times in one process, of this checkout or of
another one, such as an older commit unpacked by `git archive`:

    python3 tmrnet_torch/experimental/clip_slice_timing.py [--root DIR]
        [--runs 5] [--fused-kernel block|tiled]

Run it as a file, not with `-m`: `chip_smoke` and `tmrnet_torch` are then
imported from the root given, so two trees are compared by running the
script once for each, in turns, in one call on one card. Each run is the
smoke's own `run_slice` (a warm-up request, then the timed ones, host
clock around work that ends in a copy to the host, launch counts and the
CPU check in f32 held); one untimed run comes first. Prints one JSON line
with the card's name and power limit and the frames/s of each run; exits
1 if a run's checks failed.

Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

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
    parser.add_argument("--fused-kernel", choices=sorted(PER_FORWARD),
                        default="block")
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


if __name__ == "__main__":
    sys.exit(main())
