"""A constructed witness that TimeConv can express the multi-scale task's
distinction: one k=7 channel whose taps are built, not learned.

    python -m tmrnet_torch.experimental.timeconv_witness --work DIR

Port of `scripts/timeconv_witness.py` (`xy_detectors` :45-72,
`pair_windows` :75-79, `witness_statistic` :82-104, `auc` :107-115, `main`
:118-140), over the files that `experimental/headlevel_multiscale.py`
builds in DIR (manifests and banks). Taps at offsets -3..-1 carry u, a
least-squares X-ness detector of a bank row, taps +1..+3 carry v, a
Y-ness detector: between a close X->Y pair the channel sees both, for the
far gap no position does. The max over window positions separates the
pair; the AUC of that statistic for the close class on the train and test
pair windows, and the best threshold's accuracy, go to stdout as one JSON
line. Numpy over the bank files: no device.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def xy_detectors(work: str):
    """Least-squares linear detectors of X-ness / Y-ness on the train bank's
    rows (with a bias column): a row is X-ish when any frame of its clip
    lies in an X phase (1 or 7), Y-ish in a Y phase (3 or 9)."""
    from tmrnet_torch.data.indexing import clip_start_indices
    from tmrnet_torch.data.manifests import load_pickle_manifest
    from tmrnet_torch.data.synthetic import MULTISCALE_SEQ
    from tmrnet_torch.memory.lfb import load_bank

    m, _ = load_pickle_manifest(f"{work}/train.pkl")
    bank = load_bank(f"{work}/lfb_train.npz", device="cpu")
    feats = bank.features.numpy().astype(np.float64)
    starts = clip_start_indices(MULTISCALE_SEQ, m.video_lengths)
    labels = m.flat_labels()
    spans = labels[starts[:, None] + np.arange(MULTISCALE_SEQ)[None, :]]
    a = np.concatenate([feats, np.ones((len(feats), 1))], 1)

    def fit(target):
        w, *_ = np.linalg.lstsq(a, target.astype(np.float64), rcond=None)
        return w

    u = fit(np.isin(spans, (1, 7)).any(1))   # clip contains an X frame
    v = fit(np.isin(spans, (3, 9)).any(1))   # clip contains a Y frame
    return u, v


def pair_windows(work: str, split: str):
    """The pair clips' memory windows (f64) and binary labels."""
    from tmrnet_torch.experimental.headlevel_multiscale import pair_tensors

    _, lt, yb = pair_tensors(work, split)
    return np.asarray(lt, np.float64), yb


def witness_statistic(lt: np.ndarray, u: np.ndarray, v: np.ndarray,
                      half: int = 3) -> np.ndarray:
    """max over window positions p of (Y-ness summed over the `half` more
    recent rows before p + X-ness summed over the `half` older rows after
    it): one k=7 TimeConv channel with the constructed taps, reduced over
    positions. Window rows run most recent first, so "X before Y in time"
    puts the X rows at larger indices."""
    n, w, _ = lt.shape
    la = np.concatenate([lt, np.ones((n, w, 1))], -1)
    xness = la @ u   # (n, w)
    yness = la @ v
    stat = np.full((n,), -np.inf)
    for p in range(w):
        lo_y, hi_y = max(p - half, 0), p
        lo_x, hi_x = p + 1, min(p + half, w - 1) + 1
        if lo_y == hi_y or lo_x == hi_x:
            continue
        s = yness[:, lo_y:hi_y].sum(1) + xness[:, lo_x:hi_x].sum(1)
        stat = np.maximum(stat, s)
    return stat


def auc(stat: np.ndarray, y: np.ndarray) -> float:
    """The Mann-Whitney AUC of `stat` for the class y == 1 (NaN without
    both classes)."""
    order = np.argsort(stat)
    ranks = np.empty_like(order, dtype=np.float64)
    ranks[order] = np.arange(1, len(stat) + 1)
    pos = y == 1
    n1, n0 = int(pos.sum()), int((~pos).sum())
    if not n1 or not n0:
        return float("nan")
    return float((ranks[pos].sum() - n1 * (n1 + 1) / 2) / (n1 * n0))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--work", required=True)
    args = ap.parse_args(argv)
    u, v = xy_detectors(args.work)
    out = {}
    for split in ("train", "test"):
        lt, yb = pair_windows(args.work, split)
        s = witness_statistic(lt, u, v)
        # the close gap (class 5, label 0) holds the conjunction: the AUC
        # is the close class's
        a = auc(s, 1 - yb)
        accs = [np.mean((s >= t) == (yb == 0)) for t in np.unique(s)]
        out[split] = {"auc_close": round(a, 4),
                      "best_threshold_acc": round(float(max(accs)), 4),
                      "n": len(yb)}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
