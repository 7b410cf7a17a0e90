"""Where the f32 bottleneck kernel spends its time on the card, per stage.

    python -m tmrnet_torch.experimental.fused_bottleneck_f32_probe
        [--batch 320] [--iters 3] [--seed 0]

Builds csrc/fused_bottleneck_f32.cu twice with `-Xptxas -v` -- with the
library's flags, and as the stats probe bottleneck_f32.cuh's header
describes (per-launch sums of clock64() spans) -- and prints each build's
registers and spills, and the card's active clusters per cluster size
(`card_clusters`) beside the table the CPU's plans count over. Then, at
ResNet-50's four identity-block stages on the same seeded inputs under
`plan_bottleneck_f32` over the card's clusters: each build's ms (CUDA
events over --iters launches, builds in turns: each, then each again in
reverse), and from the stats build the mean cycles a CTA spends until
phase 1's end, the halo copy's end, phase 2's end and in all, the cycles a
consumer warp waits for its chunks, and the cycles the products alone
would take at 128 FFMA a cycle. Last, one JSON line with all of it, and
the card's name and power limit. Every build is checked against
`fused_bottleneck_plain` within 1e-5 of max |plain|; the wrappers never
load a probe build. Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess

import torch

from tmrnet_torch.experimental import fused_bottleneck as fb
from tmrnet_torch.kernels import build

STAGES = ((56, 256, 64), (28, 512, 128), (14, 1024, 256), (7, 2048, 512))
VARIANTS = {"full": (), "stats": ("-DTMR_PROBE_F32_STATS",)}
SOURCE = "fused_bottleneck_f32"


def build_variants():
    """One nvcc a variant, all at once; returns ({name: the three C
    entries}, {name: (registers, spill lines)}, the stats build's
    `tmr_f32_stats`)."""
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, flags in VARIANTS.items():
        out = build.BUILD_DIR / f"probe_f32_{name}.so"
        cmd = [build._nvcc(), *build.NVCC_FLAGS, *flags, "-Xptxas", "-v",
               "-I", str(build.CSRC), "-o", str(out),
               str(build.CSRC / f"{SOURCE}.cu")]
        procs[name] = (out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    entries, ptxas = {}, {}
    for name, (out, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        regs = sorted({int(x.split("Used ")[1].split()[0])
                       for x in log.splitlines() if "Used " in x})
        spills = [x.strip() for x in log.splitlines() if "spill" in x
                  and "0 bytes spill stores, 0 bytes spill loads" not in x]
        ptxas[name] = (regs, spills)
        entries[name] = fb.f32_entries(str(out))
    stats = ctypes.CDLL(str(procs["stats"][0])).tmr_f32_stats
    stats.argtypes = [ctypes.c_void_p, ctypes.c_int]
    return entries, ptxas, stats


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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=320)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    entries, ptxas, stats = build_variants()
    for name, (regs, spills) in ptxas.items():
        print(f"{name}: {regs} registers a thread, spills "
              f"{spills if spills else 'none'}")
    active = fb.card_clusters(torch.cuda.current_device())
    print(f"active clusters (size, clusters) {active}, the CPU plans' "
          f"{fb.F32_ACTIVE_CLUSTERS}")
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    rand = lambda shape, s=1.0: torch.randn(shape, generator=gen,
                                            device="cuda") * s
    n, out, ok = args.batch, [], True
    for h, c, p in STAGES:
        x = torch.relu(rand((n, h, h, c)))
        ops = (x, rand((c, p), (2.0 / c) ** 0.5), rand((p,), 0.05),
               rand((3, 3, p, p), (2.0 / (9 * p)) ** 0.5), rand((p,), 0.05),
               rand((p, c), 0.25 * (2.0 / p) ** 0.5), rand((c,), 0.05))
        want = fb.fused_bottleneck_plain(*ops)
        shape = (n, h, h, c, p)
        plan = fb.plan_bottleneck_f32(*shape, active)
        launch = lambda name: fb.launch_f32(
            SOURCE, "probe", *ops, shape, plan, entries=entries[name])
        row = dict(stage=f"{h}x{h}x{c} P={p}", cluster=plan.cs,
                   tile=[plan.bm, plan.bn], span=plan.span,
                   nstage=plan.nstage, waves=plan.waves,
                   real_share=plan.real_share, ms={})
        for name in list(VARIANTS) + list(VARIANTS)[::-1]:
            got = launch(name)
            rel = ((got - want).abs().max() / want.abs().max()).item()
            ok &= rel <= 1e-5
            row["ms"].setdefault(name, []).append(
                time_ms(lambda: launch(name), args.iters))
        buf = (ctypes.c_ulonglong * 8)()
        stats(buf, 1)
        launch("stats")
        torch.cuda.synchronize()
        stats(buf, 1)
        ctas = buf[3]
        row["cycles"] = dict(
            phase1=buf[4] / ctas, halo=buf[5] / ctas, phase2=buf[6] / ctas,
            cta=buf[2] / ctas, wait_per_warp=buf[0] / ctas / 8,
            products=plan.bm * (2 * c * p + 9 * p * p) / 128)
        print(f"{row['stage']}: cluster {plan.cs}, tile {plan.bm}x{plan.bn}, "
              f"{plan.waves} waves; ms "
              + ", ".join(f"{k} {'/'.join(f'{v:.3f}' for v in vs)}"
                          for k, vs in row["ms"].items())
              + "; cycles a CTA "
              + ", ".join(f"{k} {v:.0f}" for k, v in row["cycles"].items()))
        out.append(row)
        del x, ops, want
        torch.cuda.empty_cache()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(json.dumps({"batch": n, "ptxas": ptxas, "active_clusters": active,
                      "stages": out, "ok": ok}))
    print(card.strip())
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
