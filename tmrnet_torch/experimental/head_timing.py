"""The card's own time of the head's two kernels, `nl_attention` and
`time_conv`, at the main path's shapes (32 clips, window 30, width 512).

    python3 tmrnet_torch/experimental/head_timing.py [--root DIR] [--out FILE]

`--root` names the checkout whose `tmrnet_torch` is timed (default: the one
holding this file), so the same measurement reads another tree, such as an
older commit unpacked by `git archive`. Run it as a file, not with `-m`:
then `tmrnet_torch` is imported from the root given. Prints one JSON line
(and writes it to `--out`): per kernel `device_ms`, from `graph_ms`, with
the card's name and power limit. (`chip_smoke.py` records the same
`device_ms` beside `ms`, back-to-back eager calls, which for a kernel of a
few microseconds time the host's launch path.)

Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

CLIPS, WINDOW, HIDDEN = 32, 30, 512


def graph_ms(torch, fn, launches=20, replays=10):
    """The card's time of one call of fn: `launches` calls captured in one
    CUDA graph, the graph replayed `replays` times between two events, so
    the host's launch path is out of the measurement."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * launches)


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    parser.add_argument("--out", default=None)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("head_timing: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.root).resolve()))
    from tmrnet_torch.ops.nl_attention import nl_attention_cuda
    from tmrnet_torch.ops.time_conv import time_conv_cuda

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    bf = lambda shape, s=1.0: (torch.randn(shape, generator=gen, device=dev)
                               * s).to(torch.bfloat16)
    q, k, v = bf((CLIPS, HIDDEN)), bf((CLIPS, WINDOW, HIDDEN)), bf((CLIPS, WINDOW, HIDDEN))
    x = bf((CLIPS, WINDOW, HIDDEN))
    ws = []
    for ksz in (3, 5, 7):
        ws += [bf((ksz, HIDDEN, HIDDEN), (1.0 / (ksz * HIDDEN)) ** 0.5),
               torch.randn((HIDDEN,), generator=gen, device=dev) * 0.02]

    rec = {"root": args.root}
    cases = {"nl_attention": lambda: nl_attention_cuda(q, k, v),
             "time_conv": lambda: time_conv_cuda(x, *ws)}
    for name, fn in cases.items():
        rec[name] = dict(device_ms=graph_ms(torch, fn))
    rec["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    line = json.dumps(rec)
    print(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
