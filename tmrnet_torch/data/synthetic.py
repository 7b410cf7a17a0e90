"""Procedurally generated phase-structured videos whose labels need
temporal memory: the dataset of the learning-efficacy study
(`tmrnet_torch/experimental/efficacy_study.py`, `python -m tmrnet_torch
synth`).

Own copy of `tmrnet_tpu/data/synthetic.py` (`PHASE_TOKENS` :47, `_PALETTE`
:51, `ambiguous_phases` :63, `render_frames` :69, `generate_video` :81,
`write_synthetic_dataset` :95, the multi-scale task `MULTISCALE_SPEC`
:232-248, `check_multiscale_spec` :251, `generate_video_multiscale` :292,
the ceilings :303-345), numpy only. It draws from
`np.random.default_rng(seed)` in the same order, so one seed writes
byte-equal `.npy` packs and annotation files in either package.

* Each video is one monotonic pass through phases ``0..P-1`` (like a
  surgery), each phase lasting a random number of frames.
* Every phase renders as a solid "token" appearance (colour + noise).
  Ambiguous pairs of phases share a token: with the default
  ``PHASE_TOKENS`` map, phases 1 and 4 look pixel-identical, as do 3
  and 6. A frame-only (or single-clip) model cannot do better than a
  coin flip on a clip that lies entirely inside an ambiguous phase.
* The phases preceding the two members of each ambiguous pair render
  distinctly (0 vs 3, and 2 vs 5), and phase durations are chosen so the
  memory window always reaches back into the preceding phase. A model
  that reads the long-term feature bank can therefore disambiguate every
  frame; a model without memory cannot.

With durations in ``[dur_min, dur_max]`` and clip length ``seq``, a clip
whose frames all lie inside an ambiguous phase is undecidable without
memory; the expected frame-only accuracy ceiling is

    1 - (ambiguous phases / P) * E[(dur - seq + 1) / dur] * 0.5

(~0.84 for the defaults), while the memory ceiling is ~1.0 as long as
``window + seq - 2 >= dur_max`` (the window gather looks back ``window``
clip rows, each summarizing ``seq`` frames).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from tmrnet_torch.config import CHOLEC80_PHASES

# Token (appearance) id per phase. Phases 1 & 4 share token 1; phases 3 & 6
# share token 3. Their predecessors (0 vs 3, 2 vs 5) render distinctly, so
# the ambiguity is exactly resolvable by looking one phase back.
PHASE_TOKENS: Tuple[int, ...] = (0, 1, 2, 3, 1, 5, 3)

# Visually well-separated base colors (survive the train stack's ±10%
# brightness/contrast jitter with large margins).
_PALETTE = np.array([
    (200, 40, 40),    # 0 red
    (40, 180, 40),    # 1 green
    (40, 80, 220),    # 2 blue
    (230, 200, 40),   # 3 yellow
    (180, 40, 200),   # 4 magenta
    (40, 200, 200),   # 5 cyan
    (240, 130, 30),   # 6 orange
    (150, 150, 150),  # 7 gray
], dtype=np.int16)


def ambiguous_phases(tokens: Sequence[int] = PHASE_TOKENS) -> List[int]:
    """Phases whose token is shared with at least one other phase."""
    return [p for p, t in enumerate(tokens)
            if sum(1 for u in tokens if u == t) > 1]


def render_frames(tokens: np.ndarray, hw: int,
                  rng: np.random.Generator) -> np.ndarray:
    """Token id per frame -> (N, hw, hw, 3) uint8 frames: solid token color
    + per-frame brightness offset + iid pixel noise."""
    base = _PALETTE[np.asarray(tokens) % len(_PALETTE)]          # (N, 3)
    frames = np.broadcast_to(base[:, None, None, :],
                             (len(tokens), hw, hw, 3)).astype(np.int16)
    brightness = rng.integers(-12, 13, (len(tokens), 1, 1, 1), dtype=np.int16)
    noise = rng.integers(-25, 26, frames.shape, dtype=np.int16)
    return np.clip(frames + brightness + noise, 0, 255).astype(np.uint8)


def generate_video(rng: np.random.Generator, num_phases: int = 7,
                   dur_range: Tuple[int, int] = (15, 25), hw: int = 32,
                   tokens: Sequence[int] = PHASE_TOKENS,
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """One video: phases 0..num_phases-1 in order with random durations.
    Returns (frames uint8 (N,hw,hw,3), labels int64 (N,))."""
    if len(tokens) < num_phases:
        raise ValueError(f"need >= {num_phases} tokens, got {len(tokens)}")
    durs = rng.integers(dur_range[0], dur_range[1] + 1, num_phases)
    labels = np.repeat(np.arange(num_phases, dtype=np.int64), durs)
    frame_tokens = np.asarray(tokens, np.int64)[labels]
    return render_frames(frame_tokens, hw, rng), labels


def write_synthetic_dataset(
    out_dir: str,
    splits: Dict[str, int],
    seed: int = 0,
    num_phases: int = 7,
    dur_range: Tuple[int, int] = (15, 25),
    hw: int = 32,
    tokens: Sequence[int] = PHASE_TOKENS,
    phase_names: Optional[Sequence[str]] = None,
    task: str = "pairs",
) -> Dict[str, str]:
    """Write a synthetic dataset in the exact on-disk layout the real
    pipeline consumes: packed raw uint8 `.npy` videos (`data/packed.py`)
    under ``<out_dir>/frames-<split>/`` plus ``<vid>-phase.txt``
    annotations (header + ``frame_idx<TAB>PhaseName`` rows) under
    ``<out_dir>/annotations/``, so ``python -m tmrnet_torch manifest
    --stride 1`` builds manifests for every split unchanged.

    splits: ordered {split_name: num_videos}; video ids are numeric and
    globally unique across splits (numeric dir-order parity preserved).
    Returns {split_name: frames_dir} (+ {"annotations": dir}).

    task: 'pairs' (the original memory-required task above) or 'multiscale'
    (the 12-phase tmr-vs-nl_only ranking task, MULTISCALE_SPEC; labels are
    written numerically — the annotation reader takes digit labels).
    """
    if task not in ("pairs", "multiscale"):
        raise ValueError(f"unknown synthetic task {task!r}")
    if task == "multiscale":
        num_phases = len(MULTISCALE_SPEC)
        names = [str(i) for i in range(num_phases)]
    else:
        names = list(phase_names or CHOLEC80_PHASES)
    if len(names) < num_phases:
        raise ValueError(f"need >= {num_phases} phase names")
    rng = np.random.default_rng(seed)
    ann_dir = os.path.join(out_dir, "annotations")
    os.makedirs(ann_dir, exist_ok=True)
    out: Dict[str, str] = {"annotations": ann_dir}
    vid = 0
    for split, count in splits.items():
        frames_dir = os.path.join(out_dir, f"frames-{split}")
        os.makedirs(frames_dir, exist_ok=True)
        out[split] = frames_dir
        for _ in range(count):
            vid += 1
            if task == "multiscale":
                frames, labels = generate_video_multiscale(rng, hw)
            else:
                frames, labels = generate_video(rng, num_phases, dur_range,
                                                hw, tokens)
            np.save(os.path.join(frames_dir, f"{vid}.npy"), frames)
            with open(os.path.join(ann_dir, f"{vid}-phase.txt"), "w") as f:
                f.write("Frame\tPhase\n")
                for j, lab in enumerate(labels.tolist()):
                    f.write(f"{j}\t{names[lab]}\n")
    return out


# --------------------------------------------------------------------------
# Multi-scale task: RANK tmr vs nl_only.
#
# The paper's named contribution over the plain non-local ablation is the
# multi-scale TimeConv pyramid (reference `Training TMRNet/
# NLBlock_MutiConv6_3.py:43-79`): parallel temporal convs (k in {3,5,7})
# over the memory window BEFORE attention. The original task above cannot
# rank the two heads (both saturate at ~1.0) because presence of a single
# marker anywhere in the window is enough — a capability single-row
# attention already has.
#
# This task is built on an architectural separation instead:
#
#   * NLBlock attends with ONE query over per-row features and carries no
#     positional encoding (models/blocks.py NLBlock), so for a fixed clip
#     embedding its output is a function of the MULTISET of window-row
#     features. Any two classes whose window-row multisets are identically
#     distributed are PROVABLY indistinguishable to the nl_only head.
#   * TimeConv computes per-row features from a LOCAL NEIGHBORHOOD of up to
#     7 adjacent rows before attention, so tmr is a function of the multiset
#     of row NEIGHBORHOODS — it can detect local temporal arrangements that
#     leave the row multiset unchanged.
#
# Construction (12 phases, monotonic; tokens F/X/F/Y/F2/T repeated twice):
#
#   0 lead F | 1 X | 2 gap F (CLOSE 3-4)  | 3 Y | 4 tail F2 | 5 AMB T
#   6 fill F | 7 X | 8 gap F (FAR 9-11)   | 9 Y | 10 tail F2 | 11 AMB T
#
# Phases 5 and 11 render identically (token T); the only difference in
# their histories is the X->Y gap: 3-4 frames (close) vs 9-11 (far).
# The task runs at clip length seq=4 (MULTISCALE_SEQ) and memory window
# 40. The clip length matters doubly, and earlier variants of this spec
# failed on exactly this point (measured, JAX's docs/QUALITY.md): bank rows are
# LAST-STEP LSTM features, so a row STRONGLY encodes only the tokens at
# its end — marker content at the clip's START is washed out by the
# clip's own rollout (an X-CONTAINMENT linear probe reads at AUC 0.83 vs
# 0.97+ for last-frame content; seq=10 additionally required inter-row
# retention and both heads sat at chance). The construction therefore
# counts distances between STRONG rows — rows whose last frame is inside
# a marker: the last strong-X row and the first strong-Y row are exactly
# gap+1 apart, which must fit the k=7 TimeConv span of 6 (C6) with
# margin. Durations are chosen so:
#
#   C1 no single seq-frame row ever spans both X's end and Y's start
#      (gap+2 > seq), so every individual row is class-uninformative;
#   C2 TimeConv's k=7 kernel spans rows up to 6 apart: the nearest
#      X-containing and Y-containing rows are gap-(seq-2) apart = 1-2 for
#      the close gap (bridgeable by k=5/7) and >= 7 for the far gap —
#      unbridgeable INFORMATION-THEORETICALLY: a row ending >= seq frames
#      after X contains no X frame at all, and the nearest Y row is >6
#      away regardless of what features retain;
#   C3 the OTHER block's structure stays out of the window: min distance
#      from an AMB_b query to AMB_a content is fill+X+gap+Y+tail >= 44 =
#      window+seq frames, so old-T rows never leak in, while both X and Y
#      of the OWN block stay fully inside (deepest X frame at offset
#      o<=amb_max-seq: o+tail+Y+gap+X <= 6+4+8+11+8 = 37 <= 40);
#   C4 the window never clamps at video start for AMB_a queries (clip
#      start >= lead+X+gap+Y+tail-(seq-1) >= 40 >= window), so
#      clamp-duplicate row MULTIPLICITY cannot leak class either;
#   C5 every segment visible from the two AMB windows shares its token
#      and duration distribution across blocks (gap/lead/fill all F),
#      so the row multisets of the two classes are identically
#      distributed and nl_only is at chance on the pair;
#   C6 the close conjunction is detectable WITHOUT any feature retention:
#      the last strong-X row and first strong-Y row are gap+1 <= 5 apart,
#      inside the k=7 span of 6 (the lesson of the failed seq=6 variant,
#      whose strong rows sat 6-7 apart: only washed-out clip-start
#      containment was within reach, and both heads stayed at chance).
#
# The remaining five phase pairs (0,6), (1,7), (2,8), (3,9), (4,10) also
# share tokens; most are decidable from marker PRESENCE (which nl_only has:
# e.g. phase 7's window contains T, phase 1's does not), giving the 3-way
# ranking stage1 < nl_only < tmr on overall accuracy, while pair (5,11)
# accuracy isolates the architectural claim: ~0.5 for stage1 AND nl_only,
# high for tmr. Measured results (JAX package): docs/QUALITY.md
# "Multi-scale".
# --------------------------------------------------------------------------

# (token, dur_min, dur_max) per phase; tokens index _PALETTE.
MULTISCALE_SPEC: Tuple[Tuple[int, int, int], ...] = (
    (7, 26, 30),   # 0  lead    F (gray)
    (1, 6, 8),     # 1  marker  X (green)
    (7, 3, 4),     # 2  gap     F — CLOSE
    (2, 6, 8),     # 3  marker  Y (blue)
    (3, 2, 4),     # 4  tail    F2 (yellow)
    (0, 8, 10),    # 5  AMB     T (red)
    (7, 27, 30),   # 6  fill    F
    (1, 6, 8),     # 7  marker  X
    (7, 9, 11),    # 8  gap     F — FAR
    (2, 6, 8),     # 9  marker  Y
    (3, 2, 4),     # 10 tail    F2
    (0, 8, 10),    # 11 AMB     T
)
MULTISCALE_SEQ = 4          # data.sequence_length for this task
MULTISCALE_WINDOW = 40      # memory.window for this task
MULTISCALE_PAIR = (5, 11)   # the designed multi-scale-only ambiguous pair


def check_multiscale_spec(spec: Sequence[Tuple[int, int, int]] = MULTISCALE_SPEC,
                          seq: Optional[int] = None,
                          window: int = MULTISCALE_WINDOW) -> None:
    """Assert the C1-C5 duration arithmetic above for a (possibly edited)
    spec — a regression gate for the task's provable properties."""
    seq = MULTISCALE_SEQ if seq is None else seq
    tok = [s[0] for s in spec]
    lo = [s[1] for s in spec]
    hi = [s[2] for s in spec]
    if len(spec) != 12 or tok[:6] != tok[6:]:
        raise ValueError("multiscale spec: 12 phases, tokens repeated 2x6")
    for a, b in ((1, 7), (3, 9), (4, 10), (5, 11)):
        if (lo[a], hi[a]) != (lo[b], hi[b]):
            raise ValueError(f"C5: durations of phases {a},{b} must match")
    if lo[2] + 2 <= seq:
        raise ValueError("C1: a row can span both X's end and Y's start "
                         "(need close gap + 2 > seq)")
    # nearest X-containing and Y-containing rows are gap-(seq-2) apart;
    # k=7 reaches rows up to 6 apart
    if hi[2] - (seq - 2) > 6:
        raise ValueError("C2: close gap unbridgeable by k=7 TimeConv")
    if lo[8] - (seq - 2) < 7:
        raise ValueError("C2: far gap bridgeable by k=7 TimeConv")
    # C3a: other block out of window for AMB_b queries (worst offset -seq+1)
    if lo[6] + lo[7] + lo[8] + lo[9] + lo[10] < window + seq:
        raise ValueError("C3: AMB_a content leaks into AMB_b windows")
    # C3b: own X fully inside the window at the deepest AMB offset
    worst = (hi[5] - seq) + hi[10] + hi[9] + hi[8] + hi[7]
    if worst > window:
        raise ValueError("C3: far-block X falls off the window edge")
    # C4: no clamp for AMB_a queries
    if lo[0] + lo[1] + lo[2] + lo[3] + lo[4] - (seq - 1) < window:
        raise ValueError("C4: AMB_a windows clamp at video start")
    # C6: retention-free reachability — the last STRONG-X row (last frame
    # in X) and first STRONG-Y row are gap+1 apart; k=7 spans 6
    if hi[2] + 1 > 6:
        raise ValueError("C6: close-gap strong rows outside the k=7 span "
                         "(LSTM rows only strongly encode their last "
                         "frames; see module comment)")


def generate_video_multiscale(
    rng: np.random.Generator, hw: int = 32,
    spec: Sequence[Tuple[int, int, int]] = MULTISCALE_SPEC,
) -> Tuple[np.ndarray, np.ndarray]:
    """One multi-scale-task video. Returns (frames uint8, labels int64)."""
    durs = np.array([rng.integers(lo, hi + 1) for _, lo, hi in spec])
    labels = np.repeat(np.arange(len(spec), dtype=np.int64), durs)
    frame_tokens = np.asarray([s[0] for s in spec], np.int64)[labels]
    return render_frames(frame_tokens, hw, rng), labels


def multiscale_pair_ceiling() -> float:
    """Accuracy ceiling ON THE DESIGNED PAIR (phases 5 vs 11) for any model
    that reads the window as an unordered multiset of per-row features —
    which includes the frame-only stage1 AND the nl_only head (see module
    comment, C1-C5): exactly a coin flip."""
    return 0.5


def multiscale_frame_only_ceiling(seq: Optional[int] = None, n_mc: int = 4000,
                                  seed: int = 7) -> float:
    """Monte-Carlo Bayes ceiling of a MEMORYLESS model on the multi-scale
    task: the optimal classifier over the clip's own token string (clips
    are scored by their last frame). Ambiguous phase pairs are coin flips,
    and pure-F clips additionally split across FOUR phases (lead, close
    gap, fill, far gap) with unequal mass, so the ceiling lands just
    BELOW 0.5 (measured 0.484 at the shipped spec)."""
    seq = MULTISCALE_SEQ if seq is None else seq
    rng = np.random.default_rng(seed)
    from collections import Counter, defaultdict

    post: dict = defaultdict(Counter)
    total = 0
    for _ in range(n_mc):
        durs = [rng.integers(lo, hi + 1) for _, lo, hi in MULTISCALE_SPEC]
        labels = np.repeat(np.arange(12), durs)
        toks = np.asarray([s[0] for s in MULTISCALE_SPEC])[labels]
        for s in range(len(labels) - seq + 1):
            post[tuple(toks[s:s + seq])][int(labels[s + seq - 1])] += 1
            total += 1
    correct = sum(max(c.values()) for c in post.values())
    return correct / total


def frame_only_ceiling(num_phases: int = 7, seq: int = 10,
                       dur_range: Tuple[int, int] = (15, 25),
                       tokens: Sequence[int] = PHASE_TOKENS) -> float:
    """Expected accuracy ceiling of a memoryless model on this task: clips
    fully inside an ambiguous phase are a coin flip; everything else is
    decidable from the clip itself."""
    amb = len(ambiguous_phases(tokens))
    durs = np.arange(dur_range[0], dur_range[1] + 1, dtype=np.float64)
    undecidable = float(np.mean(np.maximum(durs - seq + 1, 0) / durs))
    return 1.0 - (amb / num_phases) * undecidable * 0.5
