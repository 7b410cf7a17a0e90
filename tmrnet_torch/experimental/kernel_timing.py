"""The card's own time of the port's kernels: the head's `nl_attention` and
`time_conv` at the main path's shapes (32 clips, window 30, width 512),
`int8_conv3x3` at the int8 gate's four 3x3 convs (B frames of H x H, P ->
P channels; B = 128 by default), and `int8_matmul` at the gate's products
(per stage C -> P and P -> C, the chain's two 1x1s, and P -> P, its "mm"
row; M = B H W) and a square 8192^3 product.

    python3 tmrnet_torch/experimental/kernel_timing.py [--root DIR]
        [--batch 128] [--all-plans] [--out FILE]

`--root` names the checkout whose `tmrnet_torch` is timed (default: the one
holding this file), so the same measurement reads another tree, such as an
older commit unpacked by `git archive`. Run it as a file, not with `-m`:
then `tmrnet_torch` is imported from the root given. Every time is
`graph_ms`, 20 launches in a CUDA graph, replayed, so the host's launch path
is out of it (`chip_smoke.py` records the same `device_ms` beside `ms`,
back-to-back eager calls, which for a kernel of a few microseconds time the
host). The int8 kernels are held to their plain versions bit for bit at
each shape, their weights' prepared copies made before the capture, with
TOP/s from the device time; `--all-plans` also times every plan each kernel
is built for, each checked the same way, beside the plan's choice (in a tree
whose kernel has plans: `plan_int8_conv3x3`, `plan_int8_matmul`).
`int8_matmul`'s `device_ms_chain` sums the gate chain's 8 products. Prints
one JSON line (and writes it to `--out`) with the card's name and power
limit; exits 1 if a check failed.

Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

CLIPS, WINDOW, HIDDEN = 32, 30, 512
# The int8 gate's stages (tmrnet_torch/experimental/int8_gate.py): H = W, P.
GATE_STAGES = (("stage1", 56, 64), ("stage2", 28, 128), ("stage3", 14, 256),
               ("stage4", 7, 512))
SQUARE = 8192


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


def time_head(torch, dev, gen):
    """{kernel: {"device_ms"}} for the two head kernels."""
    from tmrnet_torch.ops.nl_attention import nl_attention_cuda
    from tmrnet_torch.ops.time_conv import time_conv_cuda

    bf = lambda shape, s=1.0: (torch.randn(shape, generator=gen, device=dev)
                               * s).to(torch.bfloat16)
    q, k, v = bf((CLIPS, HIDDEN)), bf((CLIPS, WINDOW, HIDDEN)), bf((CLIPS, WINDOW, HIDDEN))
    x = bf((CLIPS, WINDOW, HIDDEN))
    ws = []
    for ksz in (3, 5, 7):
        ws += [bf((ksz, HIDDEN, HIDDEN), (1.0 / (ksz * HIDDEN)) ** 0.5),
               torch.randn((HIDDEN,), generator=gen, device=dev) * 0.02]
    cases = {"nl_attention": lambda: nl_attention_cuda(q, k, v),
             "time_conv": lambda: time_conv_cuda(x, *ws)}
    return {name: dict(device_ms=graph_ms(torch, fn)) for name, fn in cases.items()}


def time_int8_conv(torch, dev, gen, batch, all_plans):
    """(record, all bit-exact) of `int8_conv3x3` at the gate's stages."""
    from tmrnet_torch.experimental import quant_conv

    rec, ok = {"batch": batch, "stages": []}, True
    for name, h, p in GATE_STAGES:
        x = torch.randint(-127, 128, (batch, h, h, p), generator=gen,
                          device=dev, dtype=torch.int8)
        w = torch.randint(-127, 128, (3, 3, p, p), generator=gen, device=dev,
                          dtype=torch.int8)
        xs = torch.rand((), generator=gen, device=dev) * 0.1
        ws = torch.rand((p,), generator=gen, device=dev) * 0.01
        want = quant_conv.int8_conv3x3_plain(x, w, xs, ws)
        ops = 2.0 * batch * h * h * 9 * p * p
        plans = {"default": None}
        if all_plans:
            plans["default"] = quant_conv.plan_int8_conv3x3(batch, h, h, p, p)
            for bn, ns in quant_conv.PLANS:     # in the plan's own class
                plans[f"bn{bn}x{ns}"] = type(plans["default"])(bn, ns)
        row = {"stage": name, "shape": [batch, h, h, p, p]}
        for key, plan in plans.items():
            kw = {} if plan is None else {"plan": plan}
            fn = lambda: quant_conv.int8_conv3x3_cuda(x, w, xs, ws, **kw)
            same = bool(torch.equal(fn(), want))
            ok &= same
            dms = graph_ms(torch, fn)
            entry = {"device_ms": dms, "tops": ops / dms / 1e9, "bit_exact": same}
            if plan is not None:
                entry["plan"] = [plan.bn, plan.nstage]
            row[key] = entry
        rec["stages"].append(row)
        del x, want
        torch.cuda.empty_cache()
    rec["device_ms_sum"] = sum(r["default"]["device_ms"] for r in rec["stages"])
    return rec, ok


def gate_products(batch):
    """(name, M, K, N, in the chain) of the int8 gate's products at B =
    batch frames, and the square one."""
    out = []
    for name, h, p in GATE_STAGES:
        m, c = batch * h * h, 4 * p
        out += [(f"{name} C->P", m, c, p, True), (f"{name} P->C", m, p, c, True),
                (f"{name} P->P", m, p, p, False)]
    return out + [("square", SQUARE, SQUARE, SQUARE, False)]


def time_int8_matmul(torch, dev, gen, batch, all_plans):
    """(record, all bit-exact) of `int8_matmul` at the gate's products."""
    from tmrnet_torch.ops import quant

    # a tree from before the kernel had plans has no plan_int8_matmul
    plan_of = getattr(quant, "plan_int8_matmul", None)
    rec, ok = {"batch": batch, "shapes": []}, True
    for name, m, k, n, chain in gate_products(batch):
        a = torch.randint(-127, 128, (m, k), generator=gen, device=dev,
                          dtype=torch.int8)
        b = torch.randint(-127, 128, (k, n), generator=gen, device=dev,
                          dtype=torch.int8)
        a_s = torch.rand((), generator=gen, device=dev) * 0.1
        b_s = torch.rand((n,), generator=gen, device=dev) * 0.01
        want = quant.int8_matmul_plain(a, b, a_s, b_s)
        plans = {"default": None}
        if all_plans and plan_of is not None:
            plans["default"] = plan_of(m, k, n)
            for bn, ns in quant.MATMUL_PLANS:
                plans[f"bn{bn}x{ns}"] = quant.Int8Plan(bn, ns)
        row = {"shape": name, "mkn": [m, k, n], "chain": chain}
        for key, plan in plans.items():
            kw = {} if plan is None else {"plan": plan}
            fn = lambda: quant.int8_matmul_cuda(a, b, a_s, b_s, **kw)
            same = bool(torch.equal(fn(), want))
            ok &= same
            dms = graph_ms(torch, fn)
            entry = {"device_ms": dms, "tops": 2.0 * m * k * n / dms / 1e9,
                     "bit_exact": same}
            if plan is not None:
                entry["plan"] = [plan.bn, plan.nstage]
            row[key] = entry
        rec["shapes"].append(row)
        del a, b, want
        torch.cuda.empty_cache()
    rec["device_ms_chain"] = sum(r["default"]["device_ms"]
                                 for r in rec["shapes"] if r["chain"])
    return rec, ok


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    parser.add_argument("--batch", type=int, default=128)
    parser.add_argument("--all-plans", action="store_true")
    parser.add_argument("--out", default=None)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("kernel_timing: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.root).resolve()))

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    rec = {"root": args.root, **time_head(torch, dev, gen)}
    rec["int8_conv3x3"], ok = time_int8_conv(torch, dev, gen, args.batch,
                                             args.all_plans)
    rec["int8_matmul"], ok_mm = time_int8_matmul(torch, dev, gen, args.batch,
                                                 args.all_plans)
    ok &= ok_mm
    rec["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    line = json.dumps(rec)
    print(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
