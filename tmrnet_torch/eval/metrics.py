"""Phase-recognition scoring: the relaxed-boundary protocol of the
reference MATLAB scripts and the trainers' clip-level report.

Own copy, numpy only, of `tmrnet_tpu/eval/metrics.py` (`_PROTOCOLS`
:36-56, `VideoScores` :59, `_runs` :69, `relaxed_evaluate` :80-161,
`ProtocolReport` :164-201, `_nanmean` / `_nanstd1` :204-221,
`aggregate_videos` :224-266, `evaluate_protocol` :269-305,
`read_phase_file` :308-354, `write_phase_file` :357-373 and
`classification_metrics` :376-403), itself a port of
`code/eval/result/matlab-eval/{Main,Evaluate,Main_m2cai,Evaluate_m2cai,
ReadPhaseLabel}.m`: per-phase Jaccard, precision and recall with a
10-second relaxed boundary and phase-specific transition forgiveness, and
per-video accuracy, aggregated over videos as mean +/- std with MATLAB's
nanmean and clamping. A label stream's connected components are its runs.

The MATLAB quirk is reproduced by default (`quirk_compat=True`): at
`Evaluate.m:40` the early-transition mask is computed over the *last* t
elements of a ground-truth run, but MATLAB's logical indexing with a mask
shorter than the array applies it to the *first* t elements. The
published numbers were produced with it; `quirk_compat=False` applies the
mask to the last t elements, the documented intent. `aggregate_videos`
keeps `Main.m`'s mix of `mean` (Jaccard, recall) and `nanmean`
(precision) over phases, with ddof=1.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# Per-protocol transition forgiveness:
#   phase_id (1-based) -> (late_ok, early_ok)
# where `late_ok` are diff values forgiven at the start of a GT run (predicting
# the *previous* phase late) and `early_ok` at its end (predicting a *future*
# phase early). From `Evaluate.m:36-48` (cholec80, 7 phases) and
# `Evaluate_m2cai.m:36-47` (m2cai, 8 phases; same rules shifted by one because
# of the extra leading TrocarPlacement phase).
_DEFAULT_RELAX = ((-1,), (1,))
_PROTOCOLS: Dict[str, Dict] = {
    "cholec80": {
        "num_phases": 7,
        "relax": {
            4: ((-1,), (1, 2)),
            5: ((-1,), (1, 2)),
            6: ((-1, -2), (1, 2)),
            7: ((-1, -2), (1, 2)),
        },
    },
    "m2cai": {
        "num_phases": 8,
        "relax": {
            5: ((-1,), (1, 2)),
            6: ((-1,), (1, 2)),
            7: ((-1, -2), (1, 2)),
            8: ((-1, -2), (1, 2)),
        },
    },
}


@dataclasses.dataclass
class VideoScores:
    """Relaxed metrics for one video. Arrays have length num_phases; NaN marks
    phases absent from the ground truth (excluded from nan-aggregations)."""

    jaccard: np.ndarray
    precision: np.ndarray
    recall: np.ndarray
    accuracy: float


def _runs(mask: np.ndarray) -> List[Tuple[int, int]]:
    """Connected runs of True in a 1-D bool array as (start, end_exclusive)."""
    if mask.ndim != 1:
        raise ValueError("mask must be 1-D")
    padded = np.concatenate([[False], mask, [False]])
    delta = np.diff(padded.astype(np.int8))
    starts = np.flatnonzero(delta == 1)
    ends = np.flatnonzero(delta == -1)
    return list(zip(starts.tolist(), ends.tolist()))


def relaxed_evaluate(
    gt: np.ndarray,
    pred: np.ndarray,
    fps: int = 1,
    protocol: str = "cholec80",
    relaxed_seconds: int = 10,
    quirk_compat: bool = True,
) -> VideoScores:
    """Score one video's per-frame phase predictions against ground truth.

    Args:
      gt, pred: 1-D int arrays of 0-based phase labels, same length.
      fps: frames per second of the label stream (1 for cholec80 txt exports,
        25 for m2cai, matching `Main.m:19` / `Main_m2cai.m:19`).
      protocol: 'cholec80' or 'm2cai'.
      relaxed_seconds: boundary relaxation in seconds (10 in the protocol).
      quirk_compat: reproduce the MATLAB logical-indexing quirk (see module doc).
    """
    spec = _PROTOCOLS[protocol]
    nph = spec["num_phases"]
    gt = np.asarray(gt, dtype=np.int64) + 1  # 1-based like the MATLAB scripts
    pred = np.asarray(pred, dtype=np.int64) + 1
    if gt.shape != pred.shape or gt.ndim != 1:
        raise ValueError(f"shape mismatch: gt {gt.shape} vs pred {pred.shape}")
    n = gt.size
    if n == 0:
        # MATLAB sum([])/0 yields NaN; surface the same instead of a
        # ZeroDivisionError for a header-only / empty phase file
        return VideoScores(jaccard=np.full(nph, np.nan),
                           precision=np.full(nph, np.nan),
                           recall=np.full(nph, np.nan), accuracy=np.nan)
    ori_t = relaxed_seconds * fps

    diff = pred - gt
    updated = diff.copy()

    for phase in range(1, nph + 1):
        late_ok, early_ok = spec["relax"].get(phase, _DEFAULT_RELAX)
        for start, end in _runs(gt == phase):
            cur = diff[start:end].copy()
            t = min(ori_t, cur.size)
            # Late transition: forgive the first t frames of the run.
            head = cur[:t]
            head[np.isin(head, late_ok)] = 0
            cur[:t] = head
            # Early transition: mask computed over the last t frames...
            tail_mask = np.isin(cur[cur.size - t:], early_ok)
            if quirk_compat:
                # ...but applied to the FIRST t positions (MATLAB
                # shorter-logical-index semantics, `Evaluate.m:40`).
                seg = cur[:t]
                seg[tail_mask] = 0
                cur[:t] = seg
            else:
                seg = cur[cur.size - t:]
                seg[tail_mask] = 0
                cur[cur.size - t:] = seg
            updated[start:end] = cur

    jacc = np.full(nph, np.nan)
    prec = np.full(nph, np.nan)
    rec = np.full(nph, np.nan)
    hit = updated == 0
    for phase in range(1, nph + 1):
        gt_mask = gt == phase
        if not gt_mask.any():
            continue  # NaN row: phase absent from GT (`Evaluate.m:59-66`)
        union = gt_mask | (pred == phase)
        tp = int(hit[union].sum())
        jacc[phase - 1] = 100.0 * tp / int(union.sum())
        sum_pred = int((pred == phase).sum())
        sum_gt = int(gt_mask.sum())
        # MATLAB x/0 -> Inf (0/0 -> NaN); Inf is clamped to 100 in aggregation.
        if sum_pred == 0:
            prec[phase - 1] = np.nan if tp == 0 else np.inf
        else:
            prec[phase - 1] = 100.0 * tp / sum_pred
        rec[phase - 1] = 100.0 * tp / sum_gt

    acc = 100.0 * float(hit.sum()) / n
    return VideoScores(jaccard=jacc, precision=prec, recall=rec, accuracy=acc)


@dataclasses.dataclass
class ProtocolReport:
    """Aggregate over videos, replicating `Main.m:52-111` semantics."""

    # (num_phases,) nanmean over videos, after clamping values >100 to 100.
    jaccard_per_phase: np.ndarray
    precision_per_phase: np.ndarray
    recall_per_phase: np.ndarray
    jaccard_std_per_phase: np.ndarray
    precision_std_per_phase: np.ndarray
    recall_std_per_phase: np.ndarray
    mean_jaccard: float
    std_jaccard: float
    mean_precision: float
    std_precision: float
    mean_recall: float
    std_recall: float
    mean_accuracy: float
    std_accuracy: float
    accuracy_per_video: np.ndarray
    phase_names: Tuple[str, ...] = ()

    def format_table(self) -> str:
        lines = ["=" * 48,
                 f"{'Phase':>25}|{'Jacc':>6}|{'Prec':>6}|{'Rec':>6}|",
                 "=" * 48]
        names = self.phase_names or tuple(
            f"phase{i}" for i in range(len(self.jaccard_per_phase)))
        for i, name in enumerate(names):
            lines.append(
                f"{name:>25}|{self.jaccard_per_phase[i]:6.2f}|"
                f"{self.precision_per_phase[i]:6.2f}|{self.recall_per_phase[i]:6.2f}|")
            lines.append("-" * 45)
        lines.append("=" * 48)
        lines.append(f"Mean jaccard: {self.mean_jaccard:5.2f} +- {self.std_jaccard:5.2f}")
        lines.append(f"Mean accuracy: {self.mean_accuracy:5.2f} +- {self.std_accuracy:5.2f}")
        lines.append(f"Mean precision: {self.mean_precision:5.2f} +- {self.std_precision:5.2f}")
        lines.append(f"Mean recall: {self.mean_recall:5.2f} +- {self.std_recall:5.2f}")
        return "\n".join(lines)


def _nanmean(x, axis=None):
    # all-NaN slices (a phase absent from a video) are expected; NaN out is
    # the MATLAB behavior, so silence numpy's "Mean of empty slice" warning
    import warnings

    with np.errstate(invalid="ignore"), warnings.catch_warnings():
        warnings.simplefilter("ignore", category=RuntimeWarning)
        out = np.nanmean(x, axis=axis)
    return out


def _nanstd1(x):
    """MATLAB nanstd: ddof=1, NaN-excluded."""
    x = np.asarray(x, dtype=np.float64)
    ok = ~np.isnan(x)
    if ok.sum() < 2:
        return float("nan") if ok.sum() == 0 else 0.0
    return float(np.std(x[ok], ddof=1))


def aggregate_videos(
    scores: Sequence[VideoScores],
    phase_names: Tuple[str, ...] = (),
) -> ProtocolReport:
    """Aggregate per-video scores exactly as `Main.m` does: clamp >100 to 100,
    nanmean per phase over videos, plain/nan mean over phases (matching the
    script's mix of mean/nanmean per metric), std with ddof=1."""
    if not scores:
        raise ValueError("no videos to aggregate")
    jac = np.stack([s.jaccard for s in scores], axis=1)   # (nph, nvid)
    prc = np.stack([s.precision for s in scores], axis=1)
    rcl = np.stack([s.recall for s in scores], axis=1)
    acc = np.array([s.accuracy for s in scores], dtype=np.float64)

    with np.errstate(invalid="ignore"):
        jac = np.where(jac > 100.0, 100.0, jac)
        prc = np.where(prc > 100.0, 100.0, prc)
        rcl = np.where(rcl > 100.0, 100.0, rcl)

    jac_pp = _nanmean(jac, axis=1)
    prc_pp = _nanmean(prc, axis=1)
    rcl_pp = _nanmean(rcl, axis=1)

    return ProtocolReport(
        jaccard_per_phase=jac_pp,
        precision_per_phase=prc_pp,
        recall_per_phase=rcl_pp,
        jaccard_std_per_phase=np.array([_nanstd1(jac[i]) for i in range(jac.shape[0])]),
        precision_std_per_phase=np.array([_nanstd1(prc[i]) for i in range(prc.shape[0])]),
        recall_std_per_phase=np.array([_nanstd1(rcl[i]) for i in range(rcl.shape[0])]),
        # Main.m uses mean() for jaccard/recall but nanmean() for precision
        # (`Main.m:59,71,83`).
        mean_jaccard=float(np.mean(jac_pp)),
        std_jaccard=float(np.std(jac_pp, ddof=1)),
        mean_precision=float(_nanmean(prc_pp)),
        std_precision=_nanstd1(prc_pp),
        mean_recall=float(np.mean(rcl_pp)),
        std_recall=float(np.std(rcl_pp, ddof=1)),
        mean_accuracy=float(np.mean(acc)),
        std_accuracy=float(np.std(acc, ddof=1)) if acc.size > 1 else 0.0,
        accuracy_per_video=acc,
        phase_names=phase_names,
    )


def evaluate_protocol(
    gts: Sequence[np.ndarray],
    preds: Sequence[np.ndarray],
    protocol: str = "cholec80",
    fps: Optional[int] = None,
    phase_names: Tuple[str, ...] = (),
    quirk_compat: bool = True,
    relaxed_seconds: int = 10,
) -> ProtocolReport:
    """Full protocol: score every video and aggregate.

    fps defaults follow the MATLAB mains: 1 for cholec80 (`Main.m:19`),
    25 for m2cai (`Main_m2cai.m:19`). relaxed_seconds is the boundary
    relaxation (10 in both protocols, `Evaluate.m:13`).
    """
    if fps is None:
        fps = 1 if protocol == "cholec80" else 25
    if len(gts) != len(preds):
        raise ValueError("gts and preds must have the same number of videos")
    scores = [
        relaxed_evaluate(g, p, fps=fps, protocol=protocol,
                         quirk_compat=quirk_compat,
                         relaxed_seconds=relaxed_seconds)
        for g, p in zip(gts, preds)
    ]
    if not phase_names:
        from tmrnet_torch.config import CHOLEC80_PHASES, M2CAI_PHASES

        phase_names = CHOLEC80_PHASES if protocol == "cholec80" else M2CAI_PHASES
    return aggregate_videos(scores, phase_names=phase_names)


# ---------------------------------------------------------------------------
# Phase txt I/O (the Python<->MATLAB interchange format, `ReadPhaseLabel.m` /
# `export_phase_copy.py:63-73`): a header line, then "frame_id \t phase" rows
# with frame ids 25*k.
# ---------------------------------------------------------------------------


def read_phase_file(path: str, phase_names: Optional[Sequence[str]] = None,
                    matlab_compat: bool = False
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Read a video<N>-phase.txt; returns (frame_ids, labels) int arrays.

    Accepts both numeric labels and phase-name labels (the official cholec80
    annotation txts use names; exports use numeric ids).

    phase_names: the protocol's name->id order for name-labeled files.
    Default (None) is cholec80 order with TrocarPlacement appended — for
    M2CAI name-labeled files pass M2CAI_PHASES: its 7 shared names map to
    DIFFERENT ids there (Preparation is 1 after TrocarPlacement=0, ...).

    matlab_compat: drop the first ROW unconditionally like
    `ReadPhaseLabel.m:8` (fgets before textscan) — the reference exports
    are headerless (`export_phase_copy.py` header writes are commented
    out), so the real MATLAB scorer silently loses each file's frame-0
    row; enable this to reproduce Main.m's numbers bit-exactly. Default
    keeps row 0 and skips only an actual header line."""
    if phase_names is None:
        from tmrnet_torch.config import CHOLEC80_PHASES, M2CAI_PHASES

        name_to_id = {n: i for i, n in enumerate(CHOLEC80_PHASES)}
        for i, n in enumerate(M2CAI_PHASES):
            name_to_id.setdefault(n, i)
    else:
        name_to_id = {n: i for i, n in enumerate(phase_names)}
    frames: List[int] = []
    labels: List[int] = []
    with open(path, "r") as f:
        first = True
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if first:
                first = False
                if matlab_compat:
                    continue            # ReadPhaseLabel.m drops line 1
                # Header row ("Frame Phase") is skipped like
                # `ReadPhaseLabel.m:8`; tolerate headerless files.
                if not parts[0].lstrip("-").isdigit():
                    continue
            frames.append(int(parts[0]))
            lab = parts[1]
            labels.append(int(lab) if lab.lstrip("-").isdigit() else name_to_id[lab])
    return np.asarray(frames, dtype=np.int64), np.asarray(labels, dtype=np.int64)


def write_phase_file(path: str, labels: np.ndarray, fps: int = 25,
                     header: bool = False) -> None:
    """Write a phase txt with frame ids fps*k (`export_phase_copy.py:63-67`)."""
    import os

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        if header:
            f.write("Frame\tPhase\n")
        for k, lab in enumerate(np.asarray(labels).tolist()):
            f.write(f"{fps * k}\t{int(lab)}\n")


# ---------------------------------------------------------------------------
# Clip-level classification metrics, as the reference trainers' sklearn
# report computes them (`train_singlenet_phase_1fc.py:655-658`).
# ---------------------------------------------------------------------------


def classification_metrics(labels: np.ndarray, preds: np.ndarray,
                           num_classes: int) -> Dict[str, np.ndarray]:
    """Per-class precision, recall and f1, accuracy and the confusion
    matrix; a class never predicted (or never present) scores 0, as
    sklearn's zero_division=0. Labels or predictions outside
    [0, num_classes) raise: a -1 padding label would otherwise wrap to the
    last class."""
    labels = np.asarray(labels).ravel()
    preds = np.asarray(preds).ravel()
    for name, arr in (("labels", labels), ("preds", preds)):
        if arr.size and (arr.min() < 0 or arr.max() >= num_classes):
            raise ValueError(f"{name} outside [0, {num_classes}): "
                             f"min={arr.min()} max={arr.max()}")
    cm = np.zeros((num_classes, num_classes), dtype=np.int64)
    np.add.at(cm, (labels, preds), 1)
    tp = np.diag(cm).astype(np.float64)
    pred_tot = cm.sum(axis=0).astype(np.float64)
    gt_tot = cm.sum(axis=1).astype(np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        prec = np.where(pred_tot > 0, tp / pred_tot, 0.0)
        rec = np.where(gt_tot > 0, tp / gt_tot, 0.0)
        f1 = np.where(prec + rec > 0, 2 * prec * rec / (prec + rec), 0.0)
    return {
        "precision": prec,
        "recall": rec,
        "f1": f1,
        "accuracy": float(tp.sum() / max(1, cm.sum())),
        "confusion": cm,
    }
