#!/usr/bin/env python3
"""Smoke run of the PyTorch port (tmrnet_torch) on one CUDA card.

    python3 chip_smoke.py [--seed N]

Phases, in order; any failure exits nonzero:
1. the card: `nvidia-smi` name and power limit;
2. the build: every CUDA kernel of the port's paths, from the sources in
   tmrnet_torch/csrc, one nvcc per source in parallel;
3. each kernel against its plain PyTorch version at its path's shapes, with
   times of the kernel, the plain version and one PyTorch library call or
   chain for the same function (for nl_attention and time_conv, kernels of
   a few to tens of microseconds, and for the int8 kernels per gate shape,
   also the card's own time, `device_ms`: launches captured in a CUDA graph
   and replayed, beside `ms`, back-to-back eager calls, which at that size
   time the host's launch path): the bf16
   kernels (nl_attention, time_conv, fused_bottleneck,
   fused_bottleneck_tiled) against the plain version in f32 (TF32 off) on
   the same inputs, max |kernel - plain| / max |plain|
   <= 2e-2; the two bottleneck kernels per ResNet-50 stage at N = 320
   frames, with the achieved TFLOP/s and the kernel / cuDNN-chain ratio
   beside the bound (their JSON records carry these per-stage numbers
   under "stages"); the int8 kernels (int8_matmul, int8_conv3x3) at the
   int8 gate's shapes (B = 128 frames) and a square 8192^3 product, bit for
   bit; int8_matmul's record carries per product its plan, device ms,
   eager ms, TOP/s, bound and torch._int_mm under "shapes" (its device_ms
   sums the chain's 8), int8_conv3x3's per stage its plan, device ms,
   TOP/s, bound, torch._int_mm on a prebuilt im2col and a bf16 cuDNN
   conv3x3 under "stages";
4. the block slice: full-width TMRNet (ResNet-50, BN folded, hidden 512,
   window 30, 7 classes, bf16) with seeded random weights through the
   weight bridge, a 4096x512 bf16 bank on the card, and ClipInference
   answering 3 requests of 32 uint8 clips of 10 224x224 frames; launch
   counts must be 12 fused_bottleneck, 1 time_conv and 1 nl_attention per
   forward; the first 2 clips rerun on the CPU in f32 through the plain ops
   must match the card's softmax within 2e-2 and agree on the argmax;
4b. the tiled slice: the same model, weights, bank and requests through
   ClipInference(fused_kernel="tiled"); 10 fused_bottleneck_tiled, 2
   fused_bottleneck, 1 time_conv and 1 nl_attention launches per forward;
   the same CPU check on the first 2 clips, and its softmax within 2e-2 of
   the block slice's on all 96 clips;
4c. the video slice: VideoInference at the same width (device_normalize,
   10-frame clips, window 30) with two seeded weight sets, the TMR model
   and the LFB extractor; run_video on one 1,500-frame uint8 224x224 video
   (block path) and run_corpus over videos of 1,500, 1,100 and 9 frames
   (tiled path; the 9-frame video gives empty outputs), launch counts from
   the chunk plan (the identity blocks' kernels per trunk chunk x 2
   trunks, time_conv and nl_attention per head call); the corpus's first
   video against run_video within 2e-2 and the argmax rule of the clip
   slices; bank_features against the extractor run clip-wise on the card
   at 64 positions (0, 1 and the last among them) within 2e-2 of max
   |feature|; ClipInference over those positions, reading a bank built by
   build_lfb_video, against run_video within 2e-2; a 14-frame video on the
   card against the engine in f32 on the CPU within 2e-2; frames/s of
   run_video and run_corpus and the auto trunk chunk;
4d. the stream slice: StreamingInference, 16 streams x 48 steps of uint8
   224x224 frames, stream 3 inactive at steps 20-24, stream 5 reset at step
   30; 24 fused_bottleneck, 1 time_conv and 1 nl_attention launches every
   step; inactive slots frozen bit for bit; every stream's valid outputs
   against run_video over the frames it took (split at the reset) within
   2e-2; step p50 and p99 ms after 4 warm-up steps and stream-frames/s;
5. the int8 gate (tmrnet_torch.experimental.int8_gate) at B = 128 over the
   four stages: the int8 bottleneck chain through the kernels equal to the
   same chain through the plain versions, 2 int8_matmul and 1 int8_conv3x3
   launches per chain, and the gate's rows (bf16 ms, int8 ms, rates,
   speedups);
6. a JSON line of per-kernel numbers, the card's name and power limit, and
   last the line {"ok": true, "device": {...}}.

It needs a CUDA card and the rest of the repository beside it.
"""

import argparse
import dataclasses
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
# Published H100 SXM peaks (dense): bf16 and int8 tensor cores, f32 outside
# them, HBM.
PEAK_BF16, PEAK_I8, PEAK_F32, HBM_BYTES_S = 989e12, 1979e12, 67e12, 3.35e12
# ResNet-50 stride-1 identity blocks per stage at 224x224: (H, C, P, count).
STAGES = ((56, 256, 64, 2), (28, 512, 128, 3), (14, 1024, 256, 5),
          (7, 2048, 512, 2))
TILED_MAX_C = 2048      # wider identity blocks stay on fused_bottleneck
GATE_BATCH = 128        # frames per int8 gate stage
# Videos of the video slice: a short Cholec80 test video at 1 fps, another,
# and one shorter than a clip; streams and steps of the stream slice.
VIDEO_LENGTHS = (1500, 1100, 9)
STREAMS, STREAM_STEPS = 16, 48
SQUARE = 8192           # the square int8 product


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


def print_head(rec):
    print(f"    device {rec['device_ms']:.5f} ms, eager {rec['ms']:.5f} ms, "
          f"plain {rec['plain_ms']:.5f} ms, library {rec['library_ms']:.5f} "
          f"ms, bound {rec['bound_ms']:.5f} ms ({rec['bound_by']})")


def check_kernels(torch, seed):
    """Phase 3: each kernel against its plain version; returns records."""
    import torch.nn.functional as F

    from tmrnet_torch.experimental.fused_bottleneck import (
        fused_bottleneck_cuda, fused_bottleneck_plain)
    from tmrnet_torch.experimental.fused_bottleneck_tiled import (
        fused_bottleneck_tiled_cuda)
    from tmrnet_torch.experimental.kernel_timing import graph_ms
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
        name="nl_attention", route="cuda",
        source="tmrnet_torch/csrc/nl_attention.cu",
        replaces="tmrnet_tpu/ops/nl_attention.py:39", max_abs_err=err,
        ms=time_ms(torch, lambda: nl_attention_cuda(q, k, v), 50),
        device_ms=graph_ms(torch, lambda: nl_attention_cuda(q, k, v)),
        plain_ms=time_ms(torch, lambda: nl_attention_plain(qf, kf, vf), 50),
        bound_ms=b_ms, bound_by=b_by, library_ms=time_ms(torch, lib, 50)))
    print_head(records[-1])

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
        device_ms=graph_ms(torch, lambda: time_conv_cuda(x, *ws)),
        plain_ms=time_ms(torch, lambda: time_conv_plain(x.float(), *wsf), 20),
        bound_ms=b_ms, bound_by=b_by, library_ms=time_ms(torch, tc_lib, 20)))
    print_head(records[-1])

    # 3 and 4. fused_bottleneck at each stage, and fused_bottleneck_tiled at
    # the stages the tiled path gives it (C < 2048), on the same inputs,
    # N = B*T frames; per-forward numbers weight each stage by its count of
    # identity blocks.
    n = CLIPS * SEQ
    keys = ("ms", "plain_ms", "library_ms", "flops", "bytes")
    tot = {k: dict.fromkeys(keys, 0.0) for k in ("block", "tiled")}
    max_err = dict(block=0.0, tiled=0.0)
    stages = dict(block=[], tiled=[])
    for h, cc, p, count in STAGES:
        xs = torch.relu(bf((n, h, h, cc)))
        w1 = bf((cc, p), (2.0 / cc) ** 0.5)
        w2 = bf((3, 3, p, p), (2.0 / (9 * p)) ** 0.5)
        w3 = bf((p, cc), 0.25 * (2.0 / p) ** 0.5)
        b1, b2, b3 = (f32((s,), 0.05) for s in (p, p, cc))
        args = (xs, w1, b1, w2, b2, w3, b3)
        argsf = tuple(t.float() for t in args)
        want = fused_bottleneck_plain(*argsf)
        kernels = {"block": fused_bottleneck_cuda}
        if cc < TILED_MAX_C:
            kernels["tiled"] = fused_bottleneck_tiled_cuda
        for path, kernel in kernels.items():
            err, ok = compare(torch, f"{kernel.__name__[:-5]} {h}x{h}x{cc} P={p}",
                              kernel(*args), want)
            all_ok &= ok
            max_err[path] = max(max_err[path], err)
        del want
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

        plain = time_ms(torch, lambda: fused_bottleneck_plain(*argsf), 3, 1)
        library = time_ms(torch, chain, 5, 1)
        flops = 2.0 * n * h * h * (cc * p + 9 * p * p + p * cc)
        nbytes = 2.0 * (2 * n * h * h * cc + 2 * cc * p + 9 * p * p) + 4 * (2 * p + cc)
        b_ms = bound(flops, nbytes, PEAK_BF16)[0]
        for path, kernel in kernels.items():
            ms = time_ms(torch, lambda: kernel(*args), 5, 1)
            tflops = flops / ms / 1e9
            print(f"    {path} stage {h}x{h}: kernel {ms:.4f} ms "
                  f"({tflops:.1f} TFLOP/s), plain {plain:.4f} ms, cuDNN chain "
                  f"{library:.4f} ms (kernel / cuDNN {ms / library:.3f}), "
                  f"bound {b_ms:.4f} ms, x{count} per forward")
            stages[path].append(dict(
                stage=f"{h}x{h}x{cc} P={p}", per_forward=count, ms=ms,
                tflops=tflops, library_ms=library, bound_ms=b_ms))
            for key, val in (("ms", ms), ("plain_ms", plain),
                             ("library_ms", library), ("flops", flops),
                             ("bytes", nbytes)):
                tot[path][key] += count * val
        del xs, args, argsf, xc
    for path, name, source, replaces in (
            ("block", "fused_bottleneck", "tmrnet_torch/csrc/fused_bottleneck.cu",
             "tmrnet_tpu/experimental/fused_bottleneck.py:58"),
            ("tiled", "fused_bottleneck_tiled",
             "tmrnet_torch/csrc/fused_bottleneck_tiled.cu",
             "tmrnet_tpu/experimental/fused_bottleneck_tiled.py:123")):
        t = tot[path]
        b_ms, b_by = bound(t["flops"], t["bytes"], PEAK_BF16)
        records.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            max_abs_err=max_err[path], ms=t["ms"], plain_ms=t["plain_ms"],
            bound_ms=b_ms, bound_by=b_by, library_ms=t["library_ms"],
            stages=stages[path]))
    torch.cuda.empty_cache()
    return records, all_ok


def check_engine_shapes(torch, seed, records):
    """Phase 3, the engines' shapes: the bf16 kernels against their plain
    versions (f32) at the shapes the video and stream slices give them --
    the head kernels at the corpus's head call (the clip positions of the
    slice's videos that share a bucket), at a head group of 8 videos of
    5,500 clips (44,000 rows) and at a stream step (16 rows); the
    bottleneck kernels at each stage at a stream step (16 frames) and at a
    full auto trunk chunk (2,048 frames at 224x224). Each record's
    max_abs_err becomes the largest over its shapes; the errors and eager
    ms per shape go under "engine_shapes"."""
    from tmrnet_torch.experimental.fused_bottleneck import (
        fused_bottleneck_cuda, fused_bottleneck_plain)
    from tmrnet_torch.experimental.fused_bottleneck_tiled import (
        fused_bottleneck_tiled_cuda)
    from tmrnet_torch.ops.nl_attention import nl_attention_cuda, nl_attention_plain
    from tmrnet_torch.ops.time_conv import time_conv_cuda, time_conv_plain

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 5)
    bf = lambda shape, s=1.0: (torch.randn(shape, generator=gen, device=dev)
                               * s).to(torch.bfloat16)
    by_name = {r["name"]: r for r in records}
    all_ok = True

    def check(name, shape, kernel, plain, args):
        nonlocal all_ok
        err, ok = compare(torch, f"{name} {shape}", kernel(*args),
                          plain(*(t.float() for t in args)))
        all_ok &= ok
        ms = time_ms(torch, lambda: kernel(*args), 5, 1)
        rec = by_name[name]
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        rec.setdefault("engine_shapes", []).append(
            dict(shape=shape, max_abs_err=err, ms=ms))
        print(f"    eager {ms:.4f} ms")

    corpus_rows = sum(n - SEQ + 1 for n in VIDEO_LENGTHS[:2])
    for b in (corpus_rows, 8 * 5500, STREAMS):
        check("nl_attention", f"B={b}", nl_attention_cuda, nl_attention_plain,
              (bf((b, HIDDEN)), bf((b, WINDOW, HIDDEN)),
               bf((b, WINDOW, HIDDEN))))
        ws = []
        for ksz in (3, 5, 7):
            ws += [bf((ksz, HIDDEN, HIDDEN), (1.0 / (ksz * HIDDEN)) ** 0.5),
                   bf((HIDDEN,), 0.02).float()]
        check("time_conv", f"B={b}", time_conv_cuda, time_conv_plain,
              (bf((b, WINDOW, HIDDEN)), *ws))
    for n in (STREAMS, 2048):
        for h, cc, p, _ in STAGES:
            args = (torch.relu(bf((n, h, h, cc))), bf((cc, p), (2.0 / cc) ** 0.5),
                    bf((p,), 0.05).float(),
                    bf((3, 3, p, p), (2.0 / (9 * p)) ** 0.5),
                    bf((p,), 0.05).float(),
                    bf((p, cc), 0.25 * (2.0 / p) ** 0.5), bf((cc,), 0.05).float())
            kernels = [("fused_bottleneck", fused_bottleneck_cuda)]
            if cc < TILED_MAX_C:
                kernels.append(("fused_bottleneck_tiled",
                                fused_bottleneck_tiled_cuda))
            for name, kernel in kernels:
                check(name, f"N={n} {h}x{h}x{cc} P={p}", kernel,
                      fused_bottleneck_plain, args)
            del args
            torch.cuda.empty_cache()
    return all_ok


def int_mm_ms(torch, a, b, scale, iters):
    """The library yardstick of the int8 kernels: one torch._int_mm call
    (cuBLASLt int8) and the same f32 epilogue; None where it refuses the
    shapes."""
    try:
        return time_ms(torch, lambda: torch._int_mm(a, b).float() * scale,
                       iters, 1)
    except RuntimeError as exc:
        print(f"    torch._int_mm refused {tuple(a.shape)} @ {tuple(b.shape)}: "
              f"{str(exc).splitlines()[0]}")
        return None


def check_int8_kernels(torch, seed):
    """Phase 3, int8: int8_matmul and int8_conv3x3 against their plain
    versions, bit for bit, at the int8 gate's shapes (B = 128 frames per
    stage) and for int8_matmul also a square 8192^3 product. Each record
    sums one bottleneck chain per stage: two 1x1 products (C -> P, P -> C)
    and one 3x3 conv (P -> P), f32 output; int8_matmul's also its numbers
    per product (the gate's P -> P "mm" row and the square one beside the
    chain's) and int8_conv3x3's per stage, with the card's own time
    (CUDA-graph replays, the weight's prepared copy made before the
    capture)."""
    import torch.nn.functional as F

    from tmrnet_torch.experimental.kernel_timing import graph_ms
    from tmrnet_torch.experimental.int8_gate import STAGES as GATE_STAGES
    from tmrnet_torch.experimental.quant_conv import (
        im2col3x3, int8_conv3x3_cuda, int8_conv3x3_plain, plan_int8_conv3x3)
    from tmrnet_torch.ops.quant import (
        int8_matmul_cuda, int8_matmul_plain, plan_int8_matmul)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 2)
    i8 = lambda *shape: torch.randint(-127, 128, shape, generator=gen,
                                      device=dev, dtype=torch.int8)
    scales = lambda n: (torch.rand((), generator=gen, device=dev) * 0.1,
                        torch.rand((n,), generator=gen, device=dev) * 0.01)
    all_ok = True
    tot = {k: dict(ms=0.0, plain_ms=0.0, library_ms=0.0, ops=0.0, bytes=0.0)
           for k in ("mm", "conv")}
    library_ok = dict(mm=True, conv=True)
    max_err = dict(mm=0.0, conv=0.0)
    mm_shapes, conv_stages = [], []

    def exact(name, got, want):
        same = bool(torch.equal(got, want))
        diff = (got - want).abs().max().item()
        print(f"  {name}: bit-exact {same} (max_abs_err {diff:.4g}) "
              f"{'ok' if same else 'FAIL'}")
        return same, diff

    def matmul(name, m, k, n, chain, iters=10):
        nonlocal all_ok
        a, b = i8(m, k), i8(k, n)
        a_s, b_s = scales(n)
        ok, err = exact(f"int8_matmul {name} {m}x{k}x{n}",
                        int8_matmul_cuda(a, b, a_s, b_s),
                        int8_matmul_plain(a, b, a_s, b_s))
        all_ok &= ok
        max_err["mm"] = max(max_err["mm"], err)
        kernel = lambda: int8_matmul_cuda(a, b, a_s, b_s)
        ms = time_ms(torch, kernel, iters, 2)
        device = graph_ms(torch, kernel)
        plain = time_ms(torch, lambda: int8_matmul_plain(a, b, a_s, b_s), 3, 1)
        library = int_mm_ms(torch, a, b, a_s * b_s, iters)
        ops, nbytes = 2.0 * m * k * n, m * k + k * n + 4.0 * m * n
        b_ms, b_by = bound(ops, nbytes, PEAK_I8)
        plan = plan_int8_matmul(m, k, n)
        lib_s = "n/a" if library is None else f"{library:.4f}"
        print(f"    kernel device {device:.5f} ms ({ops / device / 1e9:.1f} "
              f"TOP/s), eager {ms:.4f} ms, plain {plain:.4f} ms, "
              f"torch._int_mm {lib_s} ms, bound {b_ms:.5f} ms ({b_by}), plan "
              f"{plan}")
        mm_shapes.append(dict(
            shape=name, mkn=[m, k, n], chain=chain,
            plan=[plan.bm, plan.bn, plan.nstage], device_ms=device, ms=ms,
            tops=ops / device / 1e9, bound_ms=b_ms, bound_by=b_by,
            library_ms=library, plain_ms=plain))
        if chain:
            for key, val in (("ms", ms), ("plain_ms", plain), ("ops", ops),
                             ("bytes", nbytes)):
                tot["mm"][key] += val
            library_ok["mm"] &= library is not None
            tot["mm"]["library_ms"] += library or 0.0

    for stage, h, c, p in GATE_STAGES:
        m = GATE_BATCH * h * h
        matmul(f"{stage} C->P", m, c, p, True)
        matmul(f"{stage} P->C", m, p, c, True)
        matmul(f"{stage} P->P", m, p, p, False)     # the gate's mm row
        # the 3x3 conv, P -> P
        x, w = i8(GATE_BATCH, h, h, p), i8(3, 3, p, p)
        x_s, w_s = scales(p)
        ok, err = exact(f"int8_conv3x3 {GATE_BATCH}x{h}x{h}x{p}",
                        int8_conv3x3_cuda(x, w, x_s, w_s),
                        int8_conv3x3_plain(x, w, x_s, w_s))
        all_ok &= ok
        max_err["conv"] = max(max_err["conv"], err)
        conv = lambda: int8_conv3x3_cuda(x, w, x_s, w_s)
        ms = time_ms(torch, conv, 10, 2)
        device = graph_ms(torch, conv)
        plain = time_ms(torch, lambda: int8_conv3x3_plain(x, w, x_s, w_s), 3, 1)
        col, w2d = im2col3x3(x), w.reshape(9 * p, p)
        library = int_mm_ms(torch, col, w2d, x_s * w_s, 10)
        del col
        xc = (x.float() * 0.05).to(torch.bfloat16).permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        wc = (w.float() * 0.005).to(torch.bfloat16).permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        cudnn = time_ms(torch, lambda: F.conv2d(xc, wc, padding=1), 10, 2)
        ops = 2.0 * m * 9 * p * p
        nbytes = m * p + 9.0 * p * p + 4.0 * m * p
        lib_s = "n/a" if library is None else f"{library:.4f}"
        b_ms, b_by = bound(ops, nbytes, PEAK_I8)
        plan = plan_int8_conv3x3(GATE_BATCH, h, h, p, p)
        print(f"    kernel device {device:.5f} ms ({ops / device / 1e9:.1f} "
              f"TOP/s), eager {ms:.4f} ms, plain {plain:.4f} ms, "
              f"torch._int_mm on an int8 im2col {lib_s} ms, bf16 cuDNN "
              f"conv3x3 {cudnn:.4f} ms, bound {b_ms:.5f} ms ({b_by}), plan "
              f"{plan}")
        conv_stages.append(dict(
            stage=f"{GATE_BATCH}x{h}x{h}x{p} P={p}",
            plan=[plan.bm, plan.bn, plan.nstage], device_ms=device, ms=ms,
            tops=ops / device / 1e9, bound_ms=b_ms, bound_by=b_by,
            library_ms=library, cudnn_bf16_ms=cudnn, plain_ms=plain))
        for key, val in (("ms", ms), ("plain_ms", plain), ("ops", ops),
                         ("bytes", nbytes)):
            tot["conv"][key] += val
        library_ok["conv"] &= library is not None
        tot["conv"]["library_ms"] += library or 0.0
        del x, xc
    matmul("square", SQUARE, SQUARE, SQUARE, False, iters=5)
    torch.cuda.empty_cache()

    records = []
    for key, name, source, replaces in (
            ("mm", "int8_matmul", "tmrnet_torch/csrc/int8_matmul.cu",
             "tmrnet_tpu/ops/quant.py:66"),
            ("conv", "int8_conv3x3", "tmrnet_torch/csrc/int8_conv3x3.cu",
             "tmrnet_tpu/experimental/quant_conv.py:47")):
        t = tot[key]
        b_ms, b_by = bound(t["ops"], t["bytes"], PEAK_I8)
        records.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            max_abs_err=max_err[key], ms=t["ms"], plain_ms=t["plain_ms"],
            bound_ms=b_ms, bound_by=b_by,
            library_ms=t["library_ms"] if library_ok[key] else None))
    records[0].update(device_ms=sum(r["device_ms"] for r in mm_shapes
                                    if r["chain"]), shapes=mm_shapes)
    records[1].update(device_ms=sum(st["device_ms"] for st in conv_stages),
                      stages=conv_stages)
    return records, all_ok


def slice_setup(torch, seed):
    """The slices' model config, folded seeded weights, bank on the card
    and 1 + REQUESTS host requests (the first is the warm-up)."""
    from tmrnet_torch.config import DataConfig, ExperimentConfig, MemoryConfig, ModelConfig
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
    return dict(ecfg=ecfg, state=state, bank=bank, first_rows=first_rows,
                requests=requests)


def run_slice(torch, setup, card, fused_kernel, want_per_forward):
    """Phase 4 / 4b: full-width clip inference on the card through the
    `fused_kernel` path, launch counts, and the first 2 clips against an f32
    CPU run of the same path. Returns (counts, frames/s, scores, ok)."""
    from tmrnet_torch.config import ModelConfig
    from tmrnet_torch.eval.infer import ClipInference
    from tmrnet_torch.kernels.build import LAUNCHES, reset_launches
    from tmrnet_torch.memory.lfb import FeatureBank

    ecfg, state, bank = setup["ecfg"], setup["state"], setup["bank"]
    first_rows, requests = setup["first_rows"], setup["requests"]
    tag = f"{fused_kernel} slice"
    engine = ClipInference(ecfg, state, bank, device="cuda",
                           fused_kernel=fused_kernel)
    engine.run(requests[:1], first_rows)          # warm-up, not counted
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    res = engine.run(requests[1:], first_rows)
    dt = time.perf_counter() - t0
    counts = dict(LAUNCHES)
    frames = REQUESTS * CLIPS * SEQ
    print(f"{tag}: {frames} frames in {dt:.4f} s = {frames / dt:.1f} frames/s "
          f"on {card}")
    want = {k: v * REQUESTS for k, v in want_per_forward.items()}
    print(f"{tag}: launches {counts} over {REQUESTS} forwards "
          f"(want {want})")
    ok = counts == want
    scores = res.scores
    ok &= scores.shape == (REQUESTS * CLIPS, CLASSES) and bool(np.isfinite(scores).all())

    # The first 2 clips of the first timed request on the CPU, in f32.
    cpu_cfg = ecfg.replace(model=ModelConfig(
        backbone="resnet50", head="tmr", hidden_dim=HIDDEN, num_classes=CLASSES,
        compute_dtype="float32", folded=True))
    cpu_bank = FeatureBank(bank.features.float().cpu(), bank.first_rows.cpu())
    cpu_engine = ClipInference(cpu_cfg, state, cpu_bank, device="cpu",
                               fused_kernel=fused_kernel)
    clips, labels, rows, _ = requests[1]
    ref = cpu_engine.run([(clips[:2], labels[:2], rows[:2], 0)], first_rows)
    err = float(np.abs(scores[:2] - ref.scores).max())
    top2 = np.sort(ref.scores, axis=-1)[:, -2:]
    margin = top2[:, 1] - top2[:, 0]
    # A clip whose two best classes lie within twice the tolerance may
    # legitimately swap between bf16 and f32; every other argmax must agree.
    decided = margin > 2 * TOL
    agree = bool((res.preds[:2] == ref.preds)[decided].all())
    print(f"{tag}: card vs CPU f32 probs max_abs_err {err:.4g} (limit {TOL}), "
          f"argmax card {res.preds[:2].tolist()} cpu {ref.preds.tolist()} "
          f"(top-2 margins {margin.round(4).tolist()}) "
          f"{'ok' if err <= TOL and agree else 'FAIL'}")
    ok &= err <= TOL and agree
    del engine
    torch.cuda.empty_cache()
    return counts, frames / dt, scores, ok


def engine_setup(seed):
    """The engines' config (the slices' model, device_normalize, 10-frame
    clips, window 30) and two independently seeded folded weight sets:
    the TMR model (head tmr) and the extractor (head lfb)."""
    from tmrnet_torch.config import DataConfig, ExperimentConfig, MemoryConfig, ModelConfig
    from tmrnet_torch.models.convert import from_jax_variables, random_variables
    from tmrnet_torch.models.fold_bn import fold_variables

    cfg = ModelConfig(backbone="resnet50", head="tmr", hidden_dim=HIDDEN,
                      num_classes=CLASSES, compute_dtype="bfloat16", folded=True)
    ecfg = ExperimentConfig(data=DataConfig(device_normalize=True,
                                            sequence_length=SEQ),
                            model=cfg, memory=MemoryConfig(window=WINDOW))
    weights = [fold_variables(from_jax_variables(random_variables(
        dataclasses.replace(cfg, head=head, compute_dtype="float32",
                            folded=False), seed + k)))
        for k, head in ((0, "tmr"), (100, "lfb"))]
    return ecfg, weights


def argmax_agrees(name, preds, want_preds, want_probs):
    """The slices' argmax rule: where the reference's two best classes lie
    more than twice the tolerance apart, the argmax must agree."""
    top2 = np.sort(want_probs, axis=-1)[:, -2:]
    decided = top2[:, 1] - top2[:, 0] > 2 * TOL
    agree = bool((preds == want_preds)[decided].all())
    print(f"  {name}: argmax agrees on {int(decided.sum())} decided of "
          f"{len(preds)} {'ok' if agree else 'FAIL'}")
    return agree


def probs_close(name, got, want):
    """The slices' probability check: max |got - want| within TOL."""
    err = float(np.abs(np.asarray(got, np.float32) - want).max())
    ok = bool(np.isfinite(err)) and err <= TOL
    print(f"  {name}: max_abs_err {err:.4g} (limit {TOL}) "
          f"{'ok' if ok else 'FAIL'}")
    return ok


def video_counts(trunk_chunks, head_calls, fused_kernel):
    """Launches of a video-engine call: the identity blocks' kernels per
    trunk chunk of each of the two trunks, #1 and #2 per head call."""
    per_trunk = ({"fused_bottleneck": 12} if fused_kernel == "block" else
                 {"fused_bottleneck_tiled": 10, "fused_bottleneck": 2})
    want = {k: v * 2 * trunk_chunks for k, v in per_trunk.items()}
    want.update(time_conv=head_calls, nl_attention=head_calls)
    return want


def run_video_slice(torch, seed, card):
    """Phase 4c: whole videos at full width. run_video on one 1,500-frame
    video (block path) and run_corpus over videos of 1,500, 1,100 and 9
    frames (tiled path), launch counts from the chunk plan; the corpus's
    first video against run_video; bank_features against the extractor run
    clip-wise at 64 positions; ClipInference over a bank built by
    build_lfb_video against run_video at those positions; a 14-frame video
    against the engine in f32 on the CPU. Returns (counts by path, the
    block engine, ok)."""
    from tmrnet_torch.eval.infer import ClipInference, VideoInference
    from tmrnet_torch.kernels.build import LAUNCHES, reset_launches
    from tmrnet_torch.train.loop import build_lfb_video

    ecfg, weights = engine_setup(seed)
    rng = np.random.default_rng(seed + 3)
    lengths = VIDEO_LENGTHS
    videos = [rng.integers(0, 256, (n, IMG, IMG, 3), dtype=np.uint8)
              for n in lengths]
    block = VideoInference(ecfg, *weights, fused_kernel="block")
    tiled = VideoInference(ecfg, *weights, fused_kernel="tiled")
    for engine in (block, tiled):                 # warm-up, not counted
        engine.run_corpus([videos[0][:64], videos[2]], chunk=64)
    torch.cuda.synchronize()
    counts, ok = {}, True

    chunk = block.trunk_chunk(lengths[0], (IMG, IMG))
    reset_launches()
    t0 = time.perf_counter()
    preds, probs = block.run_video(videos[0])
    dt = time.perf_counter() - t0
    counts["video"] = dict(LAUNCHES)
    want = video_counts(-(-lengths[0] // chunk), 1, "block")
    ok_n = counts["video"] == want
    print(f"video slice: run_video {lengths[0]} frames in {dt:.4f} s = "
          f"{lengths[0] / dt:.1f} frames/s, trunk chunk {chunk} (auto) on "
          f"{card}; launches {counts['video']} (want {want}) "
          f"{'ok' if ok_n else 'FAIL'}")
    k = lengths[0] - SEQ + 1
    ok &= ok_n and probs.shape == (k, CLASSES) and bool(np.isfinite(probs).all())
    # Where run_video's time goes (outside the counted run): the frames'
    # copy to the card, both trunks, both LSTMs and the head.
    t0 = time.perf_counter()
    staged = torch.from_numpy(videos[0]).to(block.device)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    fe, ft = block.corpus_features([staged])
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    block.corpus_heads(fe, ft, [lengths[0]])
    t3 = time.perf_counter()
    print(f"video slice: run_video split: copy to the card "
          f"{(t1 - t0) * 1e3:.1f} ms, both trunks {(t2 - t1) * 1e3:.1f} ms, "
          f"LSTMs + head + copy back {(t3 - t2) * 1e3:.1f} ms")
    del staged, fe, ft

    total = sum(lengths)
    corpus_chunk = min(2048, total)               # run_corpus's own cut
    blocks = -(-total // corpus_chunk)
    per_block = -(-corpus_chunk // tiled.trunk_chunk(corpus_chunk, (IMG, IMG)))
    groups = {}
    for n in lengths:
        if n >= SEQ:
            groups[tiled.bucket_frames(n)] = groups.get(tiled.bucket_frames(n), 0) + 1
    head_calls = sum(-(-g // 8) for g in groups.values())
    reset_launches()
    t0 = time.perf_counter()
    corpus = tiled.run_corpus(videos, chunk=corpus_chunk)
    dt = time.perf_counter() - t0
    counts["corpus"] = dict(LAUNCHES)
    want = video_counts(blocks * per_block, head_calls, "tiled")
    ok_n = counts["corpus"] == want
    print(f"video slice: run_corpus {lengths} ({total} frames, {blocks} "
          f"blocks of {corpus_chunk}) in {dt:.4f} s = {total / dt:.1f} "
          f"frames/s on {card}; launches {counts['corpus']} (want {want}) "
          f"{'ok' if ok_n else 'FAIL'}")
    ok &= ok_n
    short = corpus[2][0].shape == (0,) and corpus[2][1].shape == (0, CLASSES)
    print(f"  the {lengths[2]}-frame video gives empty outputs "
          f"{'ok' if short else 'FAIL'}")
    ok &= short and all(c[1].shape == (n - SEQ + 1, CLASSES)
                        for c, n in zip(corpus[:2], lengths))
    ok &= probs_close("run_corpus (tiled) vs run_video (block), video 0 probs",
                corpus[0][1], probs)
    ok &= argmax_agrees("run_corpus vs run_video", corpus[0][0], preds, probs)

    positions = np.unique(np.concatenate([[0, 1, k - 1], rng.choice(
        np.arange(2, k - 1), min(61, k - 3), replace=False)]))
    clips = np.stack([videos[0][p:p + SEQ] for p in positions])
    feats = block.bank_features(videos[0])
    with torch.inference_mode():
        clipwise = block.extractor(block.prep(
            torch.from_numpy(clips).to(block.device)))
    ok &= compare(torch, f"bank_features vs LFBExtractor clip-wise at "
                  f"{len(positions)} positions",
                  feats[torch.from_numpy(positions).to(block.device)],
                  clipwise)[1]
    bank = build_lfb_video(ecfg, weights[1], videos[:1], fused_kernel="block")
    clip_engine = ClipInference(ecfg, weights[0], bank, fused_kernel="block")
    res = clip_engine.run([(clips, np.zeros(len(positions)), positions, 0)],
                          bank.first_rows)
    ok &= probs_close("ClipInference over build_lfb_video's bank vs run_video",
                res.scores, probs[positions])
    ok &= argmax_agrees("ClipInference vs run_video", res.preds,
                        preds[positions], probs[positions])

    cpu_cfg = ecfg.replace(model=dataclasses.replace(ecfg.model,
                                                     compute_dtype="float32"))
    cpu = VideoInference(cpu_cfg, *weights, device="cpu")
    p_cpu, pr_cpu = cpu.run_video(videos[0][:14])
    p_card, pr_card = block.run_video(videos[0][:14])
    ok &= probs_close("14-frame video, card vs CPU f32", pr_card, pr_cpu)
    ok &= argmax_agrees("card vs CPU f32", p_card, p_cpu, pr_cpu)
    del tiled, clip_engine, bank, videos
    torch.cuda.empty_cache()
    return counts, block, ok


def run_stream_slice(torch, seed, card, video_engine):
    """Phase 4d: 16 streams, 48 steps of uint8 224x224 frames; stream 3
    inactive at steps 20-24, stream 5 reset at step 30. Each stream's valid
    outputs against run_video over the frames it took (split at the
    reset), inactive slots frozen bit for bit, launches per step; step
    p50 / p99 ms and stream-frames/s. Returns (counts, ok)."""
    from tmrnet_torch.eval.stream import StreamingInference
    from tmrnet_torch.kernels.build import LAUNCHES, reset_launches

    streams, steps, warm = STREAMS, STREAM_STEPS, 4
    inactive, reset = (3, range(20, 25)), (5, 30)
    ecfg, weights = engine_setup(seed)
    frames = np.random.default_rng(seed + 4).integers(
        0, 256, (steps, streams, IMG, IMG, 3), dtype=np.uint8)
    engine = StreamingInference(ecfg, *weights, fused_kernel="block")
    state = engine.init_state(streams)
    lives = [[[]] for _ in range(streams)]        # frames taken, per life
    outs = [[[]] for _ in range(streams)]         # valid probs, per life
    per_step = {"fused_bottleneck": 24, "time_conv": 1, "nl_attention": 1}
    ok, times, taken = True, [], 0
    torch.cuda.synchronize()
    reset_launches()
    for t in range(steps):
        if t == reset[1]:
            state = engine.reset_streams(state, np.arange(streams) == reset[0])
            lives[reset[0]].append([])
            outs[reset[0]].append([])
        active = np.ones(streams, bool)
        if t in inactive[1]:
            active[inactive[0]] = False
        before = dict(LAUNCHES)
        old = state
        t0 = time.perf_counter()
        state, preds, probs, valid = engine.step(
            state, frames[t], None if active.all() else active)
        probs, valid = probs.cpu().numpy(), valid.cpu().numpy()
        dt = time.perf_counter() - t0
        if t >= warm:
            times.append(dt)
            taken += int(active.sum())
        step_counts = {k: v - before.get(k, 0) for k, v in LAUNCHES.items()}
        ok &= step_counts == per_step
        for s in np.flatnonzero(~active):
            ok &= not valid[s] and all(bool(torch.equal(a[s], b[s])) for a, b in (
                (state.ext_ring, old.ext_ring), (state.tmr_ring, old.tmr_ring),
                (state.bank_ring, old.bank_ring), (state.count, old.count)))
        for s in np.flatnonzero(active):
            lives[s][-1].append(frames[t, s])
            ok &= bool(valid[s]) == (len(lives[s][-1]) >= SEQ)
            if valid[s]:
                outs[s][-1].append(probs[s])
    counts = dict(LAUNCHES)
    want = {k: v * steps for k, v in per_step.items()}
    ok &= counts == want
    ms = np.array(times) * 1e3
    print(f"stream slice: {streams} streams x {steps} steps, launches {counts} "
          f"(want {want}, each step {per_step}); inactive slots frozen; "
          f"{'ok' if ok else 'FAIL'}")
    print(f"stream slice: step p50 {np.percentile(ms, 50):.3f} ms, p99 "
          f"{np.percentile(ms, 99):.3f} ms over {len(ms)} steps after {warm} "
          f"warm-up, {taken / sum(times):.1f} stream-frames/s on {card}")
    flat = [(np.stack(f), o) for s in range(streams)
            for f, o in zip(lives[s], outs[s])]
    offline = video_engine.run_videos([f for f, _ in flat])
    for (f, o), (_, want_probs) in zip(flat, offline):
        ok &= len(o) == len(want_probs) == len(f) - SEQ + 1
    ok &= probs_close(f"{len(flat)} stream lives vs run_video on the frames each "
                f"took", np.concatenate([np.stack(o) for _, o in flat if o]),
                np.concatenate([w for _, w in offline]))
    del engine, state, frames
    torch.cuda.empty_cache()
    return counts, ok


def run_gate(torch, seed, card):
    """Phase 5: the int8 gate at B = 128 over the four stages: the int8
    bottleneck chain through the kernels against the same chain through the
    plain versions (bit for bit), launch counts, and the gate's rows."""
    from tmrnet_torch.experimental import int8_gate
    from tmrnet_torch.kernels.build import LAUNCHES, reset_launches

    dev = torch.device("cuda")
    inputs = [int8_gate.make_inputs(st, GATE_BATCH, dev, seed)
              for st in int8_gate.STAGES]
    reset_launches()
    outs = [int8_gate.bottleneck_int8(*int8_gate.int8_chain_args(d))
            for d in inputs]
    torch.cuda.synchronize()
    counts = dict(LAUNCHES)
    chains = len(int8_gate.STAGES)
    want = {"int8_matmul": 2 * chains, "int8_conv3x3": chains}
    ok = counts == want
    print(f"gate: launches {counts} over {chains} chains (want {want}) "
          f"{'ok' if ok else 'FAIL'}")
    for st, d, out in zip(int8_gate.STAGES, inputs, outs):
        plain = int8_gate.bottleneck_int8(*int8_gate.int8_chain_args(d),
                                          plain=True)
        same = bool(torch.equal(out, plain))
        nonzero = int(torch.count_nonzero(out))
        print(f"gate: {st[0]} int8 chain kernels vs plain bit-exact {same}, "
              f"{nonzero} of {out.numel()} outputs nonzero "
              f"{'ok' if same and nonzero else 'FAIL'}")
        ok &= same and nonzero > 0
    del inputs, outs
    torch.cuda.empty_cache()
    for st in int8_gate.STAGES:
        row = int8_gate.measure_stage(st, GATE_BATCH, iters=10, seed=seed)
        print("gate row: " + json.dumps(row))
    print(f"gate: on {card}")
    return counts, ok


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
    print("kernels vs plain versions at the engines' shapes:")
    ok &= check_engine_shapes(torch, args.seed, records)
    print("int8 kernels vs plain versions (bit for bit):")
    int8_records, ok8 = check_int8_kernels(torch, args.seed)
    records += int8_records
    if not (ok and ok8):
        print("chip_smoke: a kernel disagrees with its plain version",
              file=sys.stderr)
        return 1
    setup = slice_setup(torch, args.seed)
    by_path = {}
    block_counts, _, block_scores, ok_block = run_slice(
        torch, setup, card, "block",
        {"fused_bottleneck": 12, "time_conv": 1, "nl_attention": 1})
    by_path["block"] = block_counts
    tiled_counts, _, tiled_scores, ok_tiled = run_slice(
        torch, setup, card, "tiled",
        {"fused_bottleneck_tiled": 10, "fused_bottleneck": 2, "time_conv": 1,
         "nl_attention": 1})
    by_path["tiled"] = tiled_counts
    diff = float(np.abs(tiled_scores - block_scores).max())
    ok_paths = bool(diff <= TOL)
    print(f"tiled slice vs block slice: probs max_abs_diff {diff:.4g} over "
          f"{len(tiled_scores)} clips (limit {TOL}) "
          f"{'ok' if ok_paths else 'FAIL'}")
    del setup
    torch.cuda.empty_cache()
    video_counts_, video_engine, ok_video = run_video_slice(torch, args.seed, card)
    by_path.update(video_counts_)
    by_path["stream"], ok_stream = run_stream_slice(torch, args.seed, card,
                                                    video_engine)
    del video_engine
    torch.cuda.empty_cache()
    by_path["gate"], ok_gate = run_gate(torch, args.seed, card)
    ok = (ok_block and ok_tiled and ok_paths and ok_video and ok_stream
          and ok_gate)
    for rec in records:
        rec["launches_by_path"] = {p: c[rec["name"]] for p, c in by_path.items()
                                   if rec["name"] in c}
        rec["launches"] = sum(rec["launches_by_path"].values())
        ok &= rec["launches"] > 0
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "device_ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "launches_by_path", "stages", "shapes", "engine_shapes")
    print(json.dumps({"kernels": [{k: r[k] for k in keys if k in r}
                                  for r in records]}))
    print(card)
    if not ok:
        print("chip_smoke: a slice, an engine or the gate failed",
              file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
