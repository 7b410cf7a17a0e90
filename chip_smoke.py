#!/usr/bin/env python3
"""Smoke run of the PyTorch port (tmrnet_torch) on one CUDA card.

    python3 chip_smoke.py [--seed N]

Phases, in order; any failure exits nonzero:
1. the card: `nvidia-smi` name and power limit;
2. the build: every CUDA kernel of the clip-inference path, from the sources
   in tmrnet_torch/csrc, one nvcc per source in parallel;
3. each kernel against its plain PyTorch version at the main path's shapes:
   bf16 inputs, the plain version in f32 (TF32 off) on the same inputs,
   max |kernel - plain| / max |plain| <= 2e-2; times of the kernel, the
   plain version and one PyTorch library chain for the same function;
4. the slice: full-width TMRNet (ResNet-50, BN folded, hidden 512, window
   30, 7 classes, bf16) with seeded random weights through the weight
   bridge, a 4096x512 bf16 bank on the card, and ClipInference answering 3
   requests of 32 uint8 clips of 10 224x224 frames; launch counts must be
   12 fused_bottleneck, 1 time_conv and 1 nl_attention per forward; the
   first 2 clips rerun on the CPU in f32 through the plain ops must match
   the card's softmax within 2e-2 and agree on the argmax;
5. a JSON line of per-kernel numbers, the card's name and power limit, and
   last the line {"ok": true, "device": {...}}.

It needs a CUDA card and the rest of the repository beside it.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

CLIPS, SEQ, IMG, WINDOW, BANK_ROWS, HIDDEN, CLASSES = 32, 10, 224, 30, 4096, 512, 7
REQUESTS = 3
TOL = 2e-2
# Published H100 SXM peaks (dense): bf16 tensor cores, f32 outside them, HBM.
PEAK_BF16, PEAK_F32, HBM_BYTES_S = 989e12, 67e12, 3.35e12
# ResNet-50 stride-1 identity blocks per stage at 224x224: (H, C, P, count).
STAGES = ((56, 256, 64, 2), (28, 512, 128, 3), (14, 1024, 256, 5),
          (7, 2048, 512, 2))


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, iters=10, warmup=2):
    for _ in range(warmup):
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


def bound(flops, nbytes, peak):
    t_ops, t_bytes = flops / peak * 1e3, nbytes / HBM_BYTES_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def compare(torch, name, got, want):
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    rel = err / scale if scale > 0 else err
    ok = bool(np.isfinite(rel)) and rel <= TOL
    print(f"  {name}: max_abs_err {err:.4g}, /max|ref| {rel:.4g} "
          f"(limit {TOL}) {'ok' if ok else 'FAIL'}")
    return err, ok


def check_kernels(torch, seed):
    """Phase 3: each kernel against its plain version; returns records."""
    import torch.nn.functional as F

    from tmrnet_torch.experimental.fused_bottleneck import (
        fused_bottleneck_cuda, fused_bottleneck_plain)
    from tmrnet_torch.ops.nl_attention import nl_attention_cuda, nl_attention_plain
    from tmrnet_torch.ops.time_conv import time_conv_cuda, time_conv_plain

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    f32 = lambda shape, s=1.0: torch.randn(shape, generator=gen, device=dev) * s
    bf = lambda shape, s=1.0: f32(shape, s).to(torch.bfloat16)
    records, all_ok = [], True

    # 1. nl_attention: q (B, F), k/v (B, W, F), W = 30.
    q = bf((CLIPS, HIDDEN))
    k = bf((CLIPS, WINDOW, HIDDEN))
    v = bf((CLIPS, WINDOW, HIDDEN))
    err, ok = compare(torch, "nl_attention", nl_attention_cuda(q, k, v),
                      nl_attention_plain(q.float(), k.float(), v.float()))
    all_ok &= ok
    scale = (1.0 / HIDDEN) ** 0.5
    lib = lambda: torch.einsum(
        "bw,bwf->bf", torch.softmax(
            torch.einsum("bf,bwf->bw", q, k).float() * scale, -1).to(q.dtype), v)
    qf, kf, vf = q.float(), k.float(), v.float()
    b_ms, b_by = bound(4 * CLIPS * WINDOW * HIDDEN,
                       2 * (CLIPS * HIDDEN * 2 + 2 * CLIPS * WINDOW * HIDDEN),
                       PEAK_F32)
    records.append(dict(
        name="nl_attention", route="triton",
        source="tmrnet_torch/ops/nl_attention.py",
        replaces="tmrnet_tpu/ops/nl_attention.py:39", max_abs_err=err,
        ms=time_ms(torch, lambda: nl_attention_cuda(q, k, v), 50),
        plain_ms=time_ms(torch, lambda: nl_attention_plain(qf, kf, vf), 50),
        bound_ms=b_ms, bound_by=b_by, library_ms=time_ms(torch, lib, 50)))

    # 2. time_conv: x (B, W, C), weights (k, C, C).
    c = HIDDEN
    x = bf((CLIPS, WINDOW, c))
    ws = []
    for ksz in (3, 5, 7):
        ws += [bf((ksz, c, c), (1.0 / (ksz * c)) ** 0.5), f32((c,), 0.02)]
    wsf = [t.float() for t in ws]
    err, ok = compare(torch, "time_conv", time_conv_cuda(x, *ws),
                      time_conv_plain(x.float(), *wsf))
    all_ok &= ok
    wt = [(ws[2 * i].permute(2, 1, 0).contiguous(), ws[2 * i + 1].to(x.dtype))
          for i in range(3)]

    def tc_lib():
        xt = x.transpose(1, 2)
        out = torch.maximum(xt, F.pad(xt, (1, 0))[:, :, :-1])
        for (w_, b_), ksz in zip(wt, (3, 5, 7)):
            out = torch.maximum(out, F.conv1d(xt, w_, b_, padding=ksz // 2))
        return out.transpose(1, 2)

    m = CLIPS * WINDOW
    b_ms, b_by = bound(2 * m * c * c * 15,
                       2 * (2 * m * c + 15 * c * c) + 4 * 3 * c, PEAK_BF16)
    records.append(dict(
        name="time_conv", route="cuda", source="tmrnet_torch/csrc/time_conv.cu",
        replaces="tmrnet_tpu/ops/time_conv.py:76", max_abs_err=err,
        ms=time_ms(torch, lambda: time_conv_cuda(x, *ws), 20),
        plain_ms=time_ms(torch, lambda: time_conv_plain(x.float(), *wsf), 20),
        bound_ms=b_ms, bound_by=b_by, library_ms=time_ms(torch, tc_lib, 20)))

    # 3. fused_bottleneck at each stage, N = B*T frames; per-forward numbers
    # weight each stage by its count of identity blocks.
    n = CLIPS * SEQ
    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, flops=0.0, bytes=0.0)
    max_err = 0.0
    for h, cc, p, count in STAGES:
        xs = torch.relu(bf((n, h, h, cc)))
        w1 = bf((cc, p), (2.0 / cc) ** 0.5)
        w2 = bf((3, 3, p, p), (2.0 / (9 * p)) ** 0.5)
        w3 = bf((p, cc), 0.25 * (2.0 / p) ** 0.5)
        b1, b2, b3 = (f32((s,), 0.05) for s in (p, p, cc))
        args = (xs, w1, b1, w2, b2, w3, b3)
        argsf = tuple(t.float() for t in args)
        err, ok = compare(torch, f"fused_bottleneck {h}x{h}x{cc} P={p}",
                          fused_bottleneck_cuda(*args),
                          fused_bottleneck_plain(*argsf))
        all_ok &= ok
        max_err = max(max_err, err)
        # cuDNN chain on the same NHWC data (channels_last views).
        xc = xs.permute(0, 3, 1, 2)
        cw1 = w1.t().reshape(p, cc, 1, 1).contiguous(memory_format=torch.channels_last)
        cw2 = w2.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        cw3 = w3.t().reshape(cc, p, 1, 1).contiguous(memory_format=torch.channels_last)
        cb = [t.to(torch.bfloat16) for t in (b1, b2, b3)]

        def chain():
            y = torch.relu(F.conv2d(xc, cw1, cb[0]))
            y = torch.relu(F.conv2d(y, cw2, cb[1], padding=1))
            return torch.relu(F.conv2d(y, cw3, cb[2]) + xc)

        ms = time_ms(torch, lambda: fused_bottleneck_cuda(*args), 5, 1)
        plain = time_ms(torch, lambda: fused_bottleneck_plain(*argsf), 3, 1)
        library = time_ms(torch, chain, 5, 1)
        flops = 2.0 * n * h * h * (cc * p + 9 * p * p + p * cc)
        nbytes = 2.0 * (2 * n * h * h * cc + 2 * cc * p + 9 * p * p) + 4 * (2 * p + cc)
        print(f"    stage {h}x{h}: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
              f"cuDNN chain {library:.4f} ms, bound "
              f"{bound(flops, nbytes, PEAK_BF16)[0]:.4f} ms, x{count} per forward")
        for key, val in (("ms", ms), ("plain_ms", plain), ("library_ms", library),
                         ("flops", flops), ("bytes", nbytes)):
            tot[key] += count * val
        del xs, args, argsf, xc
    b_ms, b_by = bound(tot["flops"], tot["bytes"], PEAK_BF16)
    records.append(dict(
        name="fused_bottleneck", route="cuda",
        source="tmrnet_torch/csrc/fused_bottleneck.cu",
        replaces="tmrnet_tpu/experimental/fused_bottleneck.py:58",
        max_abs_err=max_err, ms=tot["ms"], plain_ms=tot["plain_ms"],
        bound_ms=b_ms, bound_by=b_by, library_ms=tot["library_ms"]))
    torch.cuda.empty_cache()
    return records, all_ok


def run_slice(torch, seed, card):
    """Phase 4: full-width clip inference on the card, launch counts, and
    the first 2 clips against an f32 CPU run of the same model."""
    from tmrnet_torch.config import DataConfig, ExperimentConfig, MemoryConfig, ModelConfig
    from tmrnet_torch.eval.infer import ClipInference
    from tmrnet_torch.kernels.build import LAUNCHES, reset_launches
    from tmrnet_torch.memory.lfb import FeatureBank
    from tmrnet_torch.models.convert import from_jax_variables, random_variables
    from tmrnet_torch.models.fold_bn import fold_variables

    cfg = ModelConfig(backbone="resnet50", head="tmr", hidden_dim=HIDDEN,
                      num_classes=CLASSES, compute_dtype="bfloat16", folded=True)
    unfolded = ModelConfig(backbone="resnet50", head="tmr", hidden_dim=HIDDEN,
                           num_classes=CLASSES, compute_dtype="float32")
    state = fold_variables(from_jax_variables(random_variables(unfolded, seed)))
    ecfg = ExperimentConfig(data=DataConfig(device_normalize=True), model=cfg,
                            memory=MemoryConfig(window=WINDOW))

    rng = np.random.default_rng(seed + 1)
    bank_np = rng.standard_normal((BANK_ROWS, HIDDEN), dtype=np.float32)
    first_rows = np.repeat(np.arange(0, BANK_ROWS, 1024), 1024).astype(np.int32)
    bank = FeatureBank(torch.from_numpy(bank_np).to("cuda", torch.bfloat16),
                       torch.from_numpy(first_rows).cuda())
    requests = []
    for _ in range(REQUESTS + 1):
        clips = rng.integers(0, 256, (CLIPS, SEQ, IMG, IMG, 3), dtype=np.uint8)
        rows = rng.integers(0, BANK_ROWS, CLIPS)
        requests.append((clips, rng.integers(0, CLASSES, CLIPS), rows, 0))

    engine = ClipInference(ecfg, state, bank, device="cuda")
    engine.run(requests[:1], first_rows)          # warm-up, not counted
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    res = engine.run(requests[1:], first_rows)
    dt = time.perf_counter() - t0
    counts = dict(LAUNCHES)
    frames = REQUESTS * CLIPS * SEQ
    print(f"slice: {frames} frames in {dt:.4f} s = {frames / dt:.1f} frames/s "
          f"on {card}")
    want = {"fused_bottleneck": 12 * REQUESTS, "time_conv": REQUESTS,
            "nl_attention": REQUESTS}
    print(f"slice: launches {counts} over {REQUESTS} forwards "
          f"(want {want})")
    ok = counts == want
    scores = res.scores
    ok &= scores.shape == (REQUESTS * CLIPS, CLASSES) and bool(np.isfinite(scores).all())

    # The first 2 clips of the first timed request on the CPU, in f32.
    cpu_cfg = ecfg.replace(model=ModelConfig(
        backbone="resnet50", head="tmr", hidden_dim=HIDDEN, num_classes=CLASSES,
        compute_dtype="float32", folded=True))
    cpu_bank = FeatureBank(bank.features.float().cpu(), bank.first_rows.cpu())
    cpu_engine = ClipInference(cpu_cfg, state, cpu_bank, device="cpu")
    clips, labels, rows, _ = requests[1]
    ref = cpu_engine.run([(clips[:2], labels[:2], rows[:2], 0)], first_rows)
    err = float(np.abs(scores[:2] - ref.scores).max())
    top2 = np.sort(ref.scores, axis=-1)[:, -2:]
    margin = top2[:, 1] - top2[:, 0]
    # A clip whose two best classes lie within twice the tolerance may
    # legitimately swap between bf16 and f32; every other argmax must agree.
    decided = margin > 2 * TOL
    agree = bool((res.preds[:2] == ref.preds)[decided].all())
    print(f"slice: card vs CPU f32 probs max_abs_err {err:.4g} (limit {TOL}), "
          f"argmax card {res.preds[:2].tolist()} cpu {ref.preds.tolist()} "
          f"(top-2 margins {margin.round(4).tolist()}) "
          f"{'ok' if err <= TOL and agree else 'FAIL'}")
    ok &= err <= TOL and agree
    return counts, frames / dt, ok


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from tmrnet_torch.kernels.build import build_all

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    card = card_line()
    print(f"card: {card}")
    t0 = time.perf_counter()
    build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s")

    print("kernels vs plain versions (bf16 kernel, f32 plain):")
    records, ok = check_kernels(torch, args.seed)
    if not ok:
        print("chip_smoke: a kernel disagrees with its plain version",
              file=sys.stderr)
        return 1
    counts, fps, ok = run_slice(torch, args.seed, card)
    for rec in records:
        rec["launches"] = counts.get(rec["name"], 0)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in records]}))
    print(card)
    if not ok:
        print("chip_smoke: the slice failed", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
