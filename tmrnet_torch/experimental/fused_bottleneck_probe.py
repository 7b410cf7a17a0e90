"""Where a fused-bottleneck kernel spends its time on the card, per stage.

    python -m tmrnet_torch.experimental.fused_bottleneck_probe [--batch 320]
        [--iters 10] [--seed 0] [--kernel block|tiled]

Builds the kernel (`--kernel block`: csrc/fused_bottleneck.cu at
ResNet-50's four identity-block stages; `--kernel tiled`:
csrc/fused_bottleneck_tiled.cu at the three stages the tiled path gives it)
five ways -- the library build and the probes its header describes
(without the weight copies, without the wgmma, without the epilogues, and
with per-block %globaltimer stamps) -- and runs each on the same seeded
inputs under the wrapper's plan. Per stage it prints the ms of each build
(CUDA events over --iters launches) and, from the stamps, the mean
microseconds a block
spends in its prologue, until its first chunk, in each of the three
phases, and in all; then one JSON line with all of it, and the card's name
and power limit. A probe's output is wrong by design (it skips work); the
library never loads a probe build. Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import os
import subprocess

import torch

from tmrnet_torch.experimental.fused_bottleneck import plan_bottleneck
from tmrnet_torch.experimental.fused_bottleneck_tiled import plan_bottleneck_tiled
from tmrnet_torch.kernels import build

# ResNet-50's stride-1 identity blocks per stage at 224x224: (H, C, P).
STAGES = ((56, 256, 64), (28, 512, 128), (14, 1024, 256), (7, 2048, 512))
VARIANTS = {"full": (), "no_b": ("-DTMR_PROBE_NO_B",),
            "no_mma": ("-DTMR_PROBE_NO_MMA",),
            "no_epilogue": ("-DTMR_PROBE_NO_EPILOGUE",),
            "trace": ("-DTMR_PROBE_TRACE",)}
SPANS = ("prologue", "to_first_chunk", "phase1", "phase2", "phase3")
# Per kernel: its source (C entry tmr_<source>), its plan, the plan's fields
# the C entry takes after (N, H, W, C, P), the stages it runs at.
KERNELS = {
    "block": ("fused_bottleneck", plan_bottleneck,
              ("th", "wn", "nstage", "overlay"), STAGES),
    "tiled": ("fused_bottleneck_tiled", plan_bottleneck_tiled,
              ("th", "wn", "r", "nstage", "nres", "overlay"), STAGES[:3]),
}


def build_variants(kernel):
    """One nvcc per variant of `kernel`'s source, all at once; returns
    {name: CDLL}."""
    source, _, fields, _ = KERNELS[kernel]
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = build.CSRC / f"{source}.cu"
    procs = {}
    for name, flags in VARIANTS.items():
        out = build.BUILD_DIR / f"probe_{source}_{name}_{os.getpid()}.so"
        cmd = [build._nvcc(), *build.NVCC_FLAGS, *flags, "-I", str(build.CSRC),
               "-o", str(out), str(src)]
        procs[name] = (out, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (out, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for probe {name}:\n{log}")
        lib = ctypes.CDLL(str(out))
        out.unlink()  # loaded; a probe build is not kept
        fn = getattr(lib, f"tmr_{source}")
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * (5 + len(fields))
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        libs[name] = lib
    return libs


def time_ms(fn, iters):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def probe_stage(kernel, libs, n, h, c, p, iters, gen):
    dev = torch.device("cuda")
    r = lambda shape, s=1.0: torch.randn(shape, generator=gen, device=dev) * s
    x = torch.relu(r((n, h, h, c))).to(torch.bfloat16)
    ws = (r((c, p), (2.0 / c) ** 0.5).to(torch.bfloat16), r((p,), 0.05),
          r((3, 3, p, p), (2.0 / (9 * p)) ** 0.5).to(torch.bfloat16),
          r((p,), 0.05), r((p, c), 0.25 * (2.0 / p) ** 0.5).to(torch.bfloat16),
          r((c,), 0.05))
    out = torch.empty_like(x)
    source, plan_fn, fields, _ = KERNELS[kernel]
    plan = plan_fn(n, h, h, c, p)
    plan_args = [int(getattr(plan, f)) for f in fields]
    ptrs = [build.ptr(t) for t in (x, *ws, out)]
    stream = build.stream_ptr(dev)

    def call(lib):
        build.check(getattr(lib, f"tmr_{source}")(
            *ptrs, n, h, h, c, p, *plan_args, stream), f"{source} probe")

    row = {"kernel": source, "stage": f"{h}x{h}x{c} P={p}", "batch": n,
           "plan": dataclasses.asdict(plan)}
    for name, lib in libs.items():
        if name != "trace":
            row[f"{name}_ms"] = time_ms(lambda: call(lib), iters)
    blocks = n * -(-h // plan.th)
    lib = libs["trace"]
    for _ in range(2):
        call(lib)
    torch.cuda.synchronize()
    buf = (ctypes.c_ulonglong * (min(blocks, 65536) * 6))()
    build.check(lib.tmr_probe_trace_read(buf, min(blocks, 65536)), "probe trace")
    stamps = torch.tensor(list(buf), dtype=torch.float64).reshape(-1, 6)
    spans = (stamps[:, 1:] - stamps[:, :-1]).mean(0) / 1e3
    row["block_us"] = dict(zip(SPANS, spans.tolist()))
    row["block_us"]["total"] = ((stamps[:, 5] - stamps[:, 0]).mean() / 1e3).item()
    row["span_us"] = ((stamps[:, 5].max() - stamps[:, 0].min()) / 1e3).item()
    row["blocks"] = blocks
    return row


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--batch", type=int, default=320)
    parser.add_argument("--iters", type=int, default=10)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--kernel", choices=sorted(KERNELS), default="block")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("fused_bottleneck_probe: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    libs = build_variants(args.kernel)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    rows = []
    for h, c, p in KERNELS[args.kernel][3]:
        row = probe_stage(args.kernel, libs, args.batch, h, c, p, args.iters, gen)
        rows.append(row)
        us = row["block_us"]
        print(f"{row['kernel']} stage {row['stage']}: full "
              f"{row['full_ms']:.4f} ms, no weight copies "
              f"{row['no_b_ms']:.4f}, no wgmma {row['no_mma_ms']:.4f}, "
              f"no epilogues {row['no_epilogue_ms']:.4f}; per block (us, "
              f"{row['blocks']} blocks): " +
              ", ".join(f"{k} {v:.2f}" for k, v in us.items()) +
              f"; traced kernel span {row['span_us']:.1f} us", flush=True)
        torch.cuda.empty_cache()
    print(json.dumps({"fused_bottleneck_probe": rows, "card": card}))
    print(card)


if __name__ == "__main__":
    main()
