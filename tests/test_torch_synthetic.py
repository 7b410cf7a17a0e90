"""The port's synthetic dataset (`tmrnet_torch/data/synthetic.py`) against
the JAX package's (`tmrnet_tpu/data/synthetic.py`): for both tasks and a
few seeds, the same frames and labels byte for byte, the same packs and
annotation files on disk, the same ceilings, and the same checks of the
multi-scale spec."""

import numpy as np
import pytest

from tmrnet_torch.data import synthetic as port
from tmrnet_tpu.data import synthetic as ref

SEEDS = (0, 1, 7)


def _tree(root):
    return {p.relative_to(root).as_posix(): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_constants_equal():
    assert port.PHASE_TOKENS == ref.PHASE_TOKENS
    np.testing.assert_array_equal(port._PALETTE, ref._PALETTE)
    assert port._PALETTE.dtype == ref._PALETTE.dtype
    assert port.MULTISCALE_SPEC == ref.MULTISCALE_SPEC
    assert (port.MULTISCALE_SEQ, port.MULTISCALE_WINDOW,
            port.MULTISCALE_PAIR) == (ref.MULTISCALE_SEQ,
                                      ref.MULTISCALE_WINDOW,
                                      ref.MULTISCALE_PAIR)
    assert port.ambiguous_phases() == ref.ambiguous_phases() == [1, 3, 4, 6]
    assert port.CHOLEC80_PHASES == ref.CHOLEC80_PHASES


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("kw", [{}, {"num_phases": 5, "dur_range": (3, 6),
                                     "hw": 9}])
def test_generate_video_byte_equal(seed, kw):
    fa, la = port.generate_video(np.random.default_rng(seed), **kw)
    fb, lb = ref.generate_video(np.random.default_rng(seed), **kw)
    assert fa.dtype == fb.dtype == np.uint8 and la.dtype == lb.dtype
    assert fa.tobytes() == fb.tobytes() and la.tobytes() == lb.tobytes()


@pytest.mark.parametrize("seed", SEEDS)
def test_generate_video_multiscale_byte_equal(seed):
    fa, la = port.generate_video_multiscale(np.random.default_rng(seed), 12)
    fb, lb = ref.generate_video_multiscale(np.random.default_rng(seed), 12)
    assert fa.shape == fb.shape and fa.tobytes() == fb.tobytes()
    assert la.tobytes() == lb.tobytes()
    assert sorted(set(la.tolist())) == list(range(12))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("task", ["pairs", "multiscale"])
def test_write_synthetic_dataset_byte_equal(tmp_path, seed, task):
    splits = {"train": 2, "val": 1, "test": 1}
    kw = dict(seed=seed, hw=10, task=task)
    if task == "pairs":
        kw["dur_range"] = (4, 9)
    out_a = port.write_synthetic_dataset(str(tmp_path / "a"), splits, **kw)
    out_b = ref.write_synthetic_dataset(str(tmp_path / "b"), splits, **kw)
    assert {k: v.replace(str(tmp_path / "a"), "") for k, v in out_a.items()} \
        == {k: v.replace(str(tmp_path / "b"), "") for k, v in out_b.items()}
    a, b = _tree(tmp_path / "a"), _tree(tmp_path / "b")
    assert sorted(a) == sorted(b)
    assert len([k for k in a if k.endswith(".npy")]) == 4
    assert a == b


def test_write_synthetic_dataset_refusals(tmp_path):
    for mod, d in ((port, "a"), (ref, "b")):
        with pytest.raises(ValueError, match="unknown synthetic task"):
            mod.write_synthetic_dataset(str(tmp_path / d), {"t": 1},
                                        task="nope")
        with pytest.raises(ValueError, match="need >= 7 phase names"):
            mod.write_synthetic_dataset(str(tmp_path / d), {"t": 1},
                                        phase_names=("a", "b"))
        with pytest.raises(ValueError, match="need >= 9 tokens"):
            mod.generate_video(np.random.default_rng(0), num_phases=9)


@pytest.mark.parametrize("args", [(), (7, 10, (15, 25)), (5, 4, (6, 12)),
                                  (7, 30, (10, 20))])
def test_frame_only_ceiling_equal(args):
    assert port.frame_only_ceiling(*args) == ref.frame_only_ceiling(*args)


def test_multiscale_ceilings_equal():
    assert port.multiscale_pair_ceiling() == ref.multiscale_pair_ceiling()
    for seq, n_mc in ((None, 60), (3, 40)):
        assert (port.multiscale_frame_only_ceiling(seq, n_mc=n_mc, seed=3)
                == ref.multiscale_frame_only_ceiling(seq, n_mc=n_mc, seed=3))


def test_check_multiscale_spec_holds_and_refuses_alike():
    port.check_multiscale_spec()
    ref.check_multiscale_spec()
    spec = list(ref.MULTISCALE_SPEC)
    bad = {
        "tokens repeated": spec[:11],
        "C5": spec[:7] + [(1, 5, 8)] + spec[8:],
        "C1": spec[:2] + [(7, 1, 4)] + spec[3:8] + [(7, 1, 4)] + spec[9:],
        "C3": spec[:6] + [(7, 5, 30)] + spec[7:],
    }
    for what, s in bad.items():
        errors = []
        for mod in (port, ref):
            with pytest.raises(ValueError) as e:
                mod.check_multiscale_spec(s)
            errors.append(str(e.value))
        assert errors[0] == errors[1], what
    # another clip length moves the same checks
    for seq in (2, 8):
        got = []
        for mod in (port, ref):
            try:
                mod.check_multiscale_spec(seq=seq)
                got.append(None)
            except ValueError as e:
                got.append(str(e))
        assert got[0] == got[1]
