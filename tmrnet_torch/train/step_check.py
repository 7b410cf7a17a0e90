"""How far one train step's parameter deltas land from a reference step's.

The backbone's deltas are compared by cosine, the head's and the LSTM's
by relative error in norm, per tensor and over each group's deltas laid
end to end. A bf16 step cannot be held per tensor alone: a BatchNorm in
train mode leaves its input gradient summing to zero over positions, so
the gradients of the tensors upstream of one (the biases before a 1x1
conv and its BatchNorm most of all) cancel down to bf16's rounding, and
JAX's own bf16 step lands far from its f32 step there too
(`tests/test_torch_train_bf16.py`). So a step in bf16 is judged against
the f32 step beside the same step in bf16 on another implementation (the
plain versions on the CPU): a tensor that this second bf16 step resolves
(lands within `RESOLVED_MAX` of the f32 step) must land within
`TENSOR_LIMIT`, or within twice the second step's distance, which is
never more than 0.5 (cosine 0.5 for the backbone); a tensor that it does
not resolve is counted apart and held only by the groups' aggregates.
A step in f32 resolves every tensor but those that `rounding_only`
names, and is held per tensor at `TENSOR_LIMIT`.

`AGG_LIMITS` holds each backbone's limits on the aggregates, taken from
a CPU reading at full width (`python3 chip_smoke.py --step-reading
BACKBONE`: the bf16 step against the f32 step, both on the CPU, at the
seeds and clips of the card check), never from a card run: a trunk limit
refuses only deltas unrelated to the f32 step (1 - cosine near 1 over
millions of values), a head limit about twice the reading.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Tuple

import torch

TENSOR_LIMIT = 5e-2     # per tensor: 1 - cosine (backbone), relative error
RESOLVED_MAX = 0.25     # a reference bf16 step this close resolves a tensor
AGG_LIMITS = {
    # CPU reading, bf16 against f32, 8 threads: trunk 0.8721 (stage 2)
    # and 0.8705 (stage 1), head 0.0706 and 0.0638
    "resnet50": {"trunk": 0.95, "head": 0.15},
    # CPU reading, bf16 against f32, 8 threads: trunk 0.9195 (stage 2)
    # and 0.9374 (stage 1), head 0.1182 and 0.0975
    "resnest50": {"trunk": 0.98, "head": 0.25},
}


def is_trunk(name: str) -> bool:
    return name.startswith("backbone.")


def rounding_only(name: str) -> bool:
    """A bias that feeds a BatchNorm in train mode (ResNeSt's split
    attention: fc1, then bn1): the batch mean takes it out again, so its
    gradient is zero but for rounding, and its delta (weight decay and
    that rounding) says nothing of the step."""
    return name.endswith(".splat.fc1.bias")


def _distance(trunk: bool, got: torch.Tensor, want: torch.Tensor) -> float:
    g, w = got.flatten().double(), want.flatten().double()
    if trunk:
        return 1 - float(torch.nn.functional.cosine_similarity(g, w, dim=0))
    return float((g - w).norm() / w.norm())


def distance(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """1 - cosine(got, want) for a backbone tensor, |got - want| / |want|
    for any other."""
    return _distance(is_trunk(name), got, want)


def worst_by_group(dist: Mapping[str, float]) -> Dict[str, Tuple[str, float]]:
    """{"trunk": (name, distance), "head": (name, distance)}: each group's
    tensor furthest away in `dist` (name -> distance)."""
    out: Dict[str, Tuple[str, float]] = {}
    for k, d in dist.items():
        group = "trunk" if is_trunk(k) else "head"
        if group not in out or not d <= out[group][1]:
            out[group] = (k, d)
    return out


def aggregate(got: Mapping[str, torch.Tensor],
              want: Mapping[str, torch.Tensor]) -> Dict[str, float]:
    """{"trunk": 1 - cosine of all backbone deltas laid end to end,
    "head": relative error of all other deltas laid end to end}, for the
    groups `want` has."""
    out = {}
    for group, trunk in (("trunk", True), ("head", False)):
        keys = [k for k in want if is_trunk(k) == trunk]
        if keys:
            out[group] = _distance(trunk,
                                   torch.cat([got[k].flatten() for k in keys]),
                                   torch.cat([want[k].flatten() for k in keys]))
    return out


def verdicts(got: Mapping[str, torch.Tensor], ref: Mapping[str, torch.Tensor],
             want: Mapping[str, torch.Tensor]
             ) -> Dict[str, Tuple[str, float, float]]:
    """Per tensor (verdict, distance of got, distance of ref), both from
    want; verdict "limit" (within TENSOR_LIMIT), "bf16" (ref resolves the
    tensor and got lands within twice ref's distance), "unresolved" (ref
    lands further than RESOLVED_MAX) or "FAIL"."""
    out = {}
    for k, w in want.items():
        d, r = distance(k, got[k], w), distance(k, ref[k], w)
        if not math.isfinite(d):
            v = "FAIL"
        elif d <= TENSOR_LIMIT:
            v = "limit"
        elif not r <= RESOLVED_MAX:
            v = "unresolved"
        elif d <= 2 * r:
            v = "bf16"
        else:
            v = "FAIL"
        out[k] = (v, d, r)
    return out
