"""The learning-efficacy study's grid at full width: named arms of
`efficacy_study.py`, their seeds run side by side, rows with the
recipe beside them.

    python -m tmrnet_torch.experimental.efficacy_grid --arm P1
        [--seeds 0 1 2] [--work build/eff] [--out build/eff-rows]
    python -m tmrnet_torch.experimental.efficacy_grid --collect DIR
        --into docs/efficacy_torch_h100.json

Each arm is the study's command line (`ARMS`); each seed runs as its own
`python -m tmrnet_torch.experimental.efficacy_study` process in its own
work directory, all seeds of a call at once on the one card (the seeds'
`seconds` then share the host's cores). Its stdout goes to
`OUT/<arm>-s<seed>.log` and each stage's epochs (`metrics.jsonl`) to
`OUT/<arm>-logs-<stage>-s<seed>.jsonl`; the arm's rows, JAX's keys plus
`recipe` (the arm), `augment` (the study's `recipe`), `use_flip`,
`compute_dtype`,
`task`, `seconds` (the seed's commands, summed) and the card's name and
power limit (`nvidia-smi --query-gpu=name,power.limit`), go to
`OUT/<arm>.json`. `--collect` merges every `<arm>.json` under a
directory into one file, the arms in `ARMS`' order, replacing the rows
of an arm and seed it already holds.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import shutil
import subprocess
import sys
import time

# docs/QUALITY.md's full-scale command, both heads
PAIRS = ("--epochs1", "20", "--epochs2", "4", "--lr1", "0.003", "--lr2",
         "0.001", "--train-videos", "3", "--val-videos", "1",
         "--test-videos", "2", "--full-scale", "--set",
         "train.grad_clip=5.0", "--heads", "tmr", "nl_only")
# the multi-scale task at JAX's 16 / 4 / 8 videos and 6 + 10 epochs, with
# the full-scale learning rates and clip of PAIRS
MULTISCALE = ("--task", "multiscale", "--epochs1", "6", "--epochs2", "10",
              "--lr1", "0.003", "--lr2", "0.001", "--train-videos", "16",
              "--val-videos", "4", "--test-videos", "8", "--full-scale",
              "--set", "train.grad_clip=5.0", "--heads", "tmr", "nl_only")
ARMS = {
    # JAX's recipe (the reference's augmentation where cv2 imports), bf16
    "P1": PAIRS,
    "P2": PAIRS + ("--set", "model.compute_dtype=float32"),
    # the first full-width run's recipe: crop and flip only
    "P3": PAIRS + ("--set", "data.use_flip=false"),
    "P4": PAIRS + ("--stage2-set", "train.optimizer=adam"),
    "P5": PAIRS + ("--epochs2", "8"),
    "M1": MULTISCALE + ("--stage2-set", "train.optimizer=adam"),
    "M2": MULTISCALE,
}


def card() -> dict:
    """The card's name and power limit as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    name, limit = (s.strip() for s in out.split(","))
    return {"card": name, "power_limit": limit}


def seed_rows(arm: str, seed: int, log: str, where: dict) -> list:
    """The rows of one seed's study log, with the grid's keys."""
    with open(log) as f:
        lines = [json.loads(ln) for ln in f if ln.startswith("{")]
    head = lines[0]["study"]
    rows = [r for r in lines[1:] if "arm" in r]
    seconds = next(r["seconds"] for r in lines if "seconds" in r)
    task = "multiscale" if "--task" in ARMS[arm] else "pairs"
    return [{**r, "recipe": arm, "augment": head["recipe"],
             "use_flip": head["use_flip"],
             "compute_dtype": head["compute_dtype"], "task": task,
             "seed": seed, "seconds": round(sum(seconds.values()), 1),
             **where} for r in rows]


def run_arm(arm: str, seeds, work: str, out: str) -> list:
    """Every seed of `arm` at once, one process each; the rows."""
    os.makedirs(out, exist_ok=True)
    where = card()
    procs = []
    for seed in seeds:
        log = os.path.join(out, f"{arm}-s{seed}.log")
        argv = [sys.executable, "-m",
                "tmrnet_torch.experimental.efficacy_study", "--work",
                os.path.join(work, f"{arm}-s{seed}"), "--seeds", str(seed),
                *ARMS[arm]]
        procs.append((seed, log, subprocess.Popen(
            argv, stdout=open(log, "w"), stderr=subprocess.STDOUT)))
    t0 = time.perf_counter()
    failed = [seed for seed, _, p in procs if p.wait() != 0]
    for seed in seeds:     # each stage's epochs, beside the log
        for log in glob.glob(os.path.join(work, f"{arm}-s{seed}", "logs-*",
                                          "metrics.jsonl")):
            name = os.path.basename(os.path.dirname(log))
            shutil.copy(log, os.path.join(out, f"{arm}-{name}.jsonl"))
    rows = [r for seed, log, p in procs if p.returncode == 0
            for r in seed_rows(arm, seed, log, where)]
    with open(os.path.join(out, f"{arm}.json"), "w") as f:
        json.dump(rows, f, indent=1)
    print(json.dumps({"arm": arm, "seeds": list(seeds), "failed": failed,
                      "wall_seconds": round(time.perf_counter() - t0, 1),
                      **where}))
    for r in rows:
        print(json.dumps(r))
    if failed:
        raise SystemExit(f"{arm}: seeds {failed} failed; see their logs "
                         f"under {out}")
    return rows


def collect(src: str, into: str) -> list:
    """Merge every `<arm>.json` under `src` into `into`."""
    rows = []
    if os.path.exists(into):
        with open(into) as f:
            rows = json.load(f)
    for path in glob.glob(os.path.join(src, "*.json")):
        arm = os.path.basename(path)[:-5]
        if arm not in ARMS:
            continue
        with open(path) as f:
            new = json.load(f)
        done = {(r["recipe"], r["seed"]) for r in new}
        rows = [r for r in rows if (r["recipe"], r["seed"]) not in done]
        rows += new
    order = list(ARMS)
    rows.sort(key=lambda r: (order.index(r["recipe"]), r["seed"]))
    with open(into, "w") as f:
        json.dump(rows, f, indent=1)
        f.write("\n")
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arm", choices=sorted(ARMS))
    ap.add_argument("--seeds", type=int, nargs="+", default=[0])
    ap.add_argument("--work", default="build/eff")
    ap.add_argument("--out", default="build/eff-rows")
    ap.add_argument("--collect", metavar="DIR")
    ap.add_argument("--into", default="docs/efficacy_torch_h100.json")
    args = ap.parse_args(argv)
    if args.collect:
        rows = collect(args.collect, args.into)
        print(json.dumps({"rows": len(rows), "into": args.into}))
        return 0
    if not args.arm:
        ap.error("--arm or --collect")
    run_arm(args.arm, args.seeds, args.work, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
