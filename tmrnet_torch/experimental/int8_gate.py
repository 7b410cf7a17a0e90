"""The int8 gate on the card: a ResNet-50 bottleneck at each stage's shape,
in bf16 on cuDNN against an int8 chain through the port's int8 kernels.

Port of `scripts/bench_int8_gate.py`. For each stage (B frames of H x H,
C in, P mid channels) it times three chains and prints one JSON row:

- bneck: the whole identity bottleneck, bf16 (1x1 -> 3x3 -> 1x1 + residual,
  cuDNN, channels_last) against int8 (`int8_matmul` -> `int8_conv3x3` ->
  `int8_matmul`, requantized to int8 between them);
- conv3: the 3x3 conv alone, bf16 cuDNN against `int8_conv3x3` + requant;
- mm: a P x P 1x1 alone, bf16 cuDNN against `int8_matmul` + requant.

    python -m tmrnet_torch.experimental.int8_gate [--batch 128]
        [--stages stage1,stage2,stage3,stage4] [--what bneck,conv3,mm]

Each time is CUDA events around a loop that feeds an op's output back as
its next input, divided by the loop's length. The JAX script ran the loop at
two trip counts and took the difference to cancel a remote TPU's dispatch
and fetch round trip (:48-61); on a local card the events bracket the
device work itself, so that is not carried over. Rows carry the card's name;
operations per second count 2 M K N per product, as the JAX script does.
"""

from __future__ import annotations

import argparse
import json
from typing import Callable, Dict

import torch
import torch.nn.functional as F

from tmrnet_torch.device import resolve_device
from tmrnet_torch.experimental.quant_conv import int8_conv3x3, int8_conv3x3_plain
from tmrnet_torch.ops.quant import int8_matmul, int8_matmul_plain

# Own copy of the JAX script's table (:26-31): (name, H = W, C in, P mid).
# Its fifth column, the TPU kernel's batch tile, has no counterpart here.
STAGES = (
    ("stage1", 56, 256, 64),
    ("stage2", 28, 512, 128),
    ("stage3", 14, 1024, 256),
    ("stage4", 7, 2048, 512),
)
ACT_SCALE = 0.05   # the gate's fixed activation scale
W_SCALE = 0.005    # and weight scale


def requant(y: torch.Tensor, scale: float) -> torch.Tensor:
    """f32 -> int8 at a fixed scale; multiplies by 1/scale, as the JAX
    script does (:36-37), unlike the quantizers, which divide."""
    return torch.clamp(torch.round(y * (1.0 / scale)), -127, 127).to(torch.int8)


def bottleneck_bf16(y, w1, b1, w2, b2, w3, b3):
    """The gate's bf16 chain (:99-108). y (B, C, H, W) channels_last; conv
    weights OIHW channels_last; biases (C,) in y's dtype."""
    z = torch.relu(F.conv2d(y, w1) + b1)
    z = torch.relu(F.conv2d(z, w2, padding=1) + b2)
    z = F.conv2d(z, w3) + b3
    return torch.relu(z + y)


def bottleneck_int8(yq, w1q, s1, w2q, s2, w3q, s3, act_scale, plain=False):
    """The gate's int8 chain (:110-121). yq (B, H, W, C) int8 NHWC; w1q
    (C, P), w2q (3, 3, P, P), w3q (P, C) int8; s1..s3 per-channel f32
    scales; act_scale a one-element f32 tensor on yq's device holding
    ACT_SCALE. plain=True runs the kernels' plain versions instead."""
    matmul = int8_matmul_plain if plain else int8_matmul
    conv = int8_conv3x3_plain if plain else int8_conv3x3
    b, h, w, c = yq.shape
    p = w1q.shape[1]
    z = matmul(yq.reshape(b * h * w, c), w1q, act_scale, s1)
    z = requant(torch.relu(z), ACT_SCALE).reshape(b, h, w, p)
    z = conv(z, w2q, act_scale, s2)
    z = requant(torch.relu(z), ACT_SCALE)
    z = matmul(z.reshape(b * h * w, p), w3q, act_scale, s3)
    z = z.reshape(b, h, w, c) + yq.float() * ACT_SCALE
    return requant(torch.relu(z), ACT_SCALE)


def make_inputs(stage, batch: int, device, seed: int = 0) -> Dict:
    """The gate's operands for one stage (:91-107), random from `seed`."""
    _, h, c, p = stage
    gen = torch.Generator(device=device).manual_seed(seed)
    rnd = lambda *shape: torch.randn(shape, generator=gen, device=device)
    bf = lambda t, s: (t * s).to(torch.bfloat16)
    x = bf(rnd(batch, h, h, c), 0.1)
    xm = bf(rnd(batch, h, h, p), 0.1)
    w1 = bf(rnd(1, 1, c, p), 0.05)
    w2 = bf(rnd(3, 3, p, p), 0.05)
    w3 = bf(rnd(1, 1, p, c), 0.05)
    w11 = bf(rnd(1, 1, p, p), 0.05)
    q = lambda t, s: requant(t.float(), s)
    full = lambda n: torch.full((n,), W_SCALE, dtype=torch.float32, device=device)
    return dict(
        x=x, xm=xm, w1=w1, w2=w2, w3=w3, w11=w11,
        xq=q(x, ACT_SCALE), xmq=q(xm, ACT_SCALE),
        w1q=q(w1, W_SCALE).reshape(c, p), w2q=q(w2, W_SCALE),
        w3q=q(w3, W_SCALE).reshape(p, c), w11q=q(w11, W_SCALE).reshape(p, p),
        sm=full(p), sc=full(c),
        act_scale=torch.tensor(ACT_SCALE, dtype=torch.float32, device=device))


def int8_chain_args(d: Dict):
    """bottleneck_int8's operands from make_inputs' dict."""
    return (d["xq"], d["w1q"], d["sm"], d["w2q"], d["sm"], d["w3q"], d["sc"],
            d["act_scale"])


def _nchw(t):
    """NHWC -> an NCHW view in channels_last memory (no copy)."""
    return t.permute(0, 3, 1, 2)


def _oihw(t):
    """HWIO conv weight -> OIHW in channels_last memory."""
    return t.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)


def time_chain(fn: Callable, x, *args, iters: int = 20, warmup: int = 3) -> float:
    """Milliseconds per step of x <- fn(x, *args), by CUDA events."""
    y = x
    for _ in range(warmup):
        y = fn(y, *args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    y = x
    start.record()
    for _ in range(iters):
        y = fn(y, *args)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def measure_stage(stage, batch: int, what=("bneck", "conv3", "mm"),
                  iters: int = 20, seed: int = 0, device="cuda") -> Dict:
    """One row of the gate: times in ms, rates in TFLOP/s (bf16) and TOP/s
    (int8), speedup = bf16 time / int8 time."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError("the int8 gate times the card: it needs a CUDA device")
    name, h, c, p = stage
    d = make_inputs(stage, batch, dev, seed)
    m = batch * h * h
    row = {"stage": name, "batch": batch,
           "device": torch.cuda.get_device_name(dev)}
    zero = lambda n: torch.zeros((n,), dtype=torch.bfloat16, device=dev)

    def record(key, flops, bf16_ms, int8_ms):
        row.update({f"{key}_bf16_ms": bf16_ms, f"{key}_int8_ms": int8_ms,
                    f"{key}_bf16_tflops": flops / bf16_ms / 1e9,
                    f"{key}_int8_tops": flops / int8_ms / 1e9,
                    f"{key}_speedup": bf16_ms / int8_ms})

    if "bneck" in what:
        ws = (_oihw(d["w1"]), zero(p)[:, None, None], _oihw(d["w2"]),
              zero(p)[:, None, None], _oihw(d["w3"]), zero(c)[:, None, None])
        qargs = int8_chain_args(d)
        record("bneck", 2 * m * (c * p + 9 * p * p + p * c),
               time_chain(bottleneck_bf16, _nchw(d["x"]), *ws, iters=iters),
               time_chain(bottleneck_int8, qargs[0], *qargs[1:], iters=iters))
    if "conv3" in what:
        record("conv3", 2 * m * 9 * p * p,
               time_chain(lambda y, w: F.conv2d(y, w, padding=1),
                          _nchw(d["xm"]), _oihw(d["w2"]), iters=iters),
               time_chain(lambda y, w, s, a: requant(
                   int8_conv3x3(y, w, a, s), ACT_SCALE),
                   d["xmq"], d["w2q"], d["sm"], d["act_scale"], iters=iters))
    if "mm" in what:
        def mm_int8(y, w, s, a):
            out = int8_matmul(y.reshape(m, p), w, a, s)
            return requant(out, ACT_SCALE).reshape(batch, h, h, p)

        record("mm", 2 * m * p * p,
               time_chain(lambda y, w: F.conv2d(y, w), _nchw(d["xm"]),
                          _oihw(d["w11"]), iters=iters),
               time_chain(mm_int8, d["xmq"], d["w11q"], d["sm"],
                          d["act_scale"], iters=iters))
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--stages", default=",".join(s[0] for s in STAGES))
    ap.add_argument("--what", default="bneck,conv3,mm")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    want = set(args.stages.split(","))
    what = tuple(args.what.split(","))
    for stage in STAGES:
        if stage[0] in want:
            print(json.dumps(measure_stage(stage, args.batch, what, args.iters,
                                           args.seed)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
