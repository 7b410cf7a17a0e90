"""The port's relaxed-boundary protocol (`tmrnet_torch/eval/metrics.py`)
against the JAX package's (`tmrnet_tpu/eval/metrics.py`), numpy on both
sides: `relaxed_evaluate`, `aggregate_videos` and `evaluate_protocol` on
seeded random label streams (240 videos for each protocol and quirk mode)
and on hand-picked cases (one phase, an empty video, decreasing
transitions, a run shorter than the boundary), with NaN and Inf in the
same places and every value within 1e-12; the tables equal; the phase
files written byte for byte as JAX writes them and read back as JAX reads
them (numeric and named labels, M2CAI's name order, `matlab_compat`)."""

import dataclasses

import numpy as np
import pytest

from tmrnet_tpu.config import M2CAI_PHASES as JAX_M2CAI_PHASES
from tmrnet_tpu.eval import metrics as jax_metrics
from tmrnet_torch.config import CHOLEC80_PHASES, M2CAI_PHASES
from tmrnet_torch.eval import metrics

ATOL = 1e-12
VIDEOS = 240
NUM_PHASES = {"cholec80": 7, "m2cai": 8}


def _same(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    ok = np.isfinite(want)
    np.testing.assert_allclose(got[ok], want[ok], rtol=0, atol=ATOL)
    np.testing.assert_array_equal(got[np.isinf(want)], want[np.isinf(want)])


def _same_scores(got, want):
    for f in ("jaccard", "precision", "recall", "accuracy"):
        _same(getattr(got, f), getattr(want, f))


def _same_reports(got, want):
    for f in dataclasses.fields(want):
        if f.name == "phase_names":
            assert tuple(got.phase_names) == tuple(want.phase_names)
        else:
            _same(getattr(got, f.name), getattr(want, f.name))
    assert got.format_table() == want.format_table()


def _stream(rng, nph, n):
    """Runs of phases of 1-60 frames that mostly step forward, sometimes
    back or by two."""
    labels, ph = [], int(rng.integers(0, nph))
    while len(labels) < n:
        labels += [ph] * int(rng.integers(1, 60))
        ph = int(np.clip(ph + rng.choice([-2, -1, 1, 1, 1, 2]), 0, nph - 1))
    return np.asarray(labels[:n], np.int64)


def _prediction(rng, gt, nph):
    """gt with its boundaries moved, neighbouring phases swapped in and
    stretches of noise, so every relaxation rule fires somewhere."""
    pred = np.roll(gt, int(rng.integers(-15, 16)))
    n = len(gt)
    for _ in range(int(rng.integers(0, 6))):
        a = int(rng.integers(0, n))
        b = min(n, a + int(rng.integers(1, 30)))
        pred[a:b] = np.clip(gt[a:b] + rng.choice([-2, -1, 1, 2]), 0, nph - 1)
    if rng.random() < 0.3:
        a = int(rng.integers(0, n))
        pred[a:a + 20] = rng.integers(0, nph, len(pred[a:a + 20]))
    return pred


def _videos(protocol, seed):
    rng = np.random.default_rng(seed)
    nph = NUM_PHASES[protocol]
    out = []
    for _ in range(VIDEOS):
        gt = _stream(rng, nph, int(rng.integers(1, 400)))
        out.append((gt, _prediction(rng, gt, nph)))
    return out


@pytest.mark.parametrize("quirk", [True, False])
@pytest.mark.parametrize("protocol", ["cholec80", "m2cai"])
def test_relaxed_evaluate_matches_jax_on_random_streams(protocol, quirk):
    videos = _videos(protocol, 11 + quirk + 2 * (protocol == "m2cai"))
    rng = np.random.default_rng(5)
    inf = nan = 0
    for gt, pred in videos:
        fps = int(rng.choice([1, 2, 25]))
        relaxed = int(rng.choice([1, 5, 10]))
        kw = dict(fps=fps, protocol=protocol, relaxed_seconds=relaxed,
                  quirk_compat=quirk)
        got = metrics.relaxed_evaluate(gt, pred, **kw)
        _same_scores(got, jax_metrics.relaxed_evaluate(gt, pred, **kw))
        inf += int(np.isinf(got.precision).any())
        nan += int(np.isnan(got.jaccard).any())
    # the streams reach the protocol's corners: phases absent from a video
    # (NaN rows) and phases predicted but absent (a precision of Inf)
    assert nan > VIDEOS // 2 and inf > 0


@pytest.mark.parametrize("quirk", [True, False])
@pytest.mark.parametrize("protocol", ["cholec80", "m2cai"])
def test_aggregate_and_protocol_match_jax(protocol, quirk):
    videos = _videos(protocol, 31 + quirk)
    for lo in range(0, VIDEOS, 40):      # 6 test sets of 1 to 40 videos
        group = videos[lo:lo + 1 + lo // 8]
        gts, preds = [g for g, _ in group], [p for _, p in group]
        kw = dict(protocol=protocol, quirk_compat=quirk)
        _same_reports(metrics.evaluate_protocol(gts, preds, **kw),
                      jax_metrics.evaluate_protocol(gts, preds, **kw))
        scores = [metrics.relaxed_evaluate(g, p, **kw) for g, p in group]
        jax_scores = [jax_metrics.relaxed_evaluate(g, p, **kw)
                      for g, p in group]
        names = tuple(f"p{k}" for k in range(NUM_PHASES[protocol]))
        _same_reports(metrics.aggregate_videos(scores, names),
                      jax_metrics.aggregate_videos(jax_scores, names))


def _runs_of(*runs):
    return np.concatenate([np.full(n, ph, np.int64) for ph, n in runs])


CASES = {
    # one phase throughout, predicted right and then a phase late
    "one_phase": (_runs_of((3, 50)), _runs_of((2, 5), (3, 45))),
    # an empty video: NaN everywhere, as MATLAB's sum([])/0
    "empty": (np.zeros(0, np.int64), np.zeros(0, np.int64)),
    # decreasing transitions: 4 -> 2 -> 1, predicted early and late
    "decreasing": (_runs_of((4, 30), (2, 30), (1, 30)),
                   _runs_of((4, 25), (2, 40), (1, 20), (4, 5))),
    # a run shorter than the 10-frame boundary, with the early mask's
    # quirk on the first frames of the run
    "short_run": (_runs_of((0, 20), (1, 4), (2, 20)),
                  _runs_of((0, 18), (2, 6), (1, 2), (2, 18))),
    # every phase once, each transition predicted two phases early
    "all_phases": (_runs_of(*[(k, 12) for k in range(7)]),
                   _runs_of((0, 9), *[(min(k + 2, 6), 3) if i else (k, 9)
                                       for k in range(1, 7) for i in (1, 0)],
                            (6, 3))),
}


@pytest.mark.parametrize("quirk", [True, False])
@pytest.mark.parametrize("protocol", ["cholec80", "m2cai"])
@pytest.mark.parametrize("case", list(CASES))
def test_hand_picked_cases_match_jax(case, protocol, quirk):
    gt, pred = CASES[case]
    assert gt.shape == pred.shape
    kw = dict(protocol=protocol, quirk_compat=quirk)
    got = metrics.relaxed_evaluate(gt, pred, **kw)
    _same_scores(got, jax_metrics.relaxed_evaluate(gt, pred, **kw))
    if case == "empty":
        assert np.isnan(got.accuracy) and np.isnan(got.jaccard).all()
        return
    gts, preds = [gt, gt[::-1].copy()], [pred, pred[::-1].copy()]
    _same_reports(metrics.evaluate_protocol(gts, preds, **kw),
                  jax_metrics.evaluate_protocol(gts, preds, **kw))


def test_the_quirk_changes_the_scores():
    """The early-transition mask lands on a run's first frames under the
    quirk and on its last without: an early prediction of the next phase
    is forgiven only without it."""
    gt = _runs_of((0, 30), (1, 30))
    pred = _runs_of((0, 25), (1, 35))
    quirk = metrics.relaxed_evaluate(gt, pred, quirk_compat=True)
    intended = metrics.relaxed_evaluate(gt, pred, quirk_compat=False)
    assert intended.accuracy == 100.0 and quirk.accuracy < 100.0


def test_aggregation_keeps_main_m_mix():
    """Main.m takes mean() over phases for Jaccard and recall (a phase
    absent from every video makes them NaN) and nanmean() for precision."""
    gt, pred = _runs_of((0, 20), (1, 20)), _runs_of((0, 20), (1, 20))
    rep = metrics.evaluate_protocol([gt, gt], [pred, pred])
    assert np.isnan(rep.mean_jaccard) and np.isnan(rep.mean_recall)
    assert rep.mean_precision == 100.0 and rep.mean_accuracy == 100.0
    _same_reports(rep, jax_metrics.evaluate_protocol([gt, gt], [pred, pred]))


def test_phase_names_are_jax_s():
    assert M2CAI_PHASES == JAX_M2CAI_PHASES
    assert CHOLEC80_PHASES == JAX_M2CAI_PHASES[1:]


@pytest.mark.parametrize("fps,header", [(25, False), (1, False), (25, True)])
def test_write_phase_file_bytes_equal_jax(tmp_path, fps, header):
    labels = _stream(np.random.default_rng(fps + header), 7, 75)
    metrics.write_phase_file(str(tmp_path / "port" / "v-phase.txt"), labels,
                             fps=fps, header=header)
    jax_metrics.write_phase_file(str(tmp_path / "jax" / "v-phase.txt"),
                                 labels, fps=fps, header=header)
    port = (tmp_path / "port" / "v-phase.txt").read_bytes()
    assert port == (tmp_path / "jax" / "v-phase.txt").read_bytes()
    assert port.startswith(b"Frame\tPhase\n" if header else b"0\t")
    frames, back = metrics.read_phase_file(str(tmp_path / "port" /
                                               "v-phase.txt"))
    np.testing.assert_array_equal(back, labels)
    np.testing.assert_array_equal(frames, fps * np.arange(len(labels)))


def _read_both(path, *args):
    got = metrics.read_phase_file(str(path), *args)
    want = jax_metrics.read_phase_file(str(path), *args)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype == np.int64
    return got


@pytest.mark.parametrize("matlab_compat", [False, True])
def test_read_phase_file_matches_jax(tmp_path, matlab_compat):
    """Named cholec80 labels after a header, named M2CAI labels (whose
    shared names map to other ids under M2CAI's order), numeric labels
    with no header; matlab_compat drops the first row whatever it is (the
    header where there is one, else frame 0), the default only a header."""
    named = tmp_path / "named.txt"
    named.write_text("Frame\tPhase\n" + "".join(
        f"{25 * k}\t{CHOLEC80_PHASES[k % 7]}\n" for k in range(9)))
    frames, labels = _read_both(named, None, matlab_compat)
    np.testing.assert_array_equal(labels, np.arange(9) % 7)
    np.testing.assert_array_equal(frames, 25 * np.arange(9))
    _, m2cai = _read_both(named, M2CAI_PHASES, matlab_compat)
    np.testing.assert_array_equal(m2cai, labels + 1)
    trocar = tmp_path / "trocar.txt"
    trocar.write_text("Frame\tPhase\n0\tTrocarPlacement\n25\tPreparation\n")
    # the default map takes TrocarPlacement's id from M2CAI's order (0),
    # as JAX's does
    np.testing.assert_array_equal(_read_both(trocar, None, matlab_compat)[1],
                                  [0, 0])
    np.testing.assert_array_equal(
        _read_both(trocar, M2CAI_PHASES, matlab_compat)[1], [0, 1])
    numeric = tmp_path / "numeric.txt"
    numeric.write_text("0\t2\n\n1\t3\n2\t-1\n")
    frames, labels = _read_both(numeric, None, matlab_compat)
    np.testing.assert_array_equal(labels, [3, -1] if matlab_compat
                                  else [2, 3, -1])
    np.testing.assert_array_equal(frames, [1, 2] if matlab_compat
                                  else [0, 1, 2])


def test_classification_metrics_matches_jax():
    rng = np.random.default_rng(3)
    labels, preds = rng.integers(0, 7, 500), rng.integers(0, 6, 500)
    got = metrics.classification_metrics(labels, preds, 7)
    want = jax_metrics.classification_metrics(labels, preds, 7)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])
