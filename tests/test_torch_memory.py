"""The port's feature bank against the JAX package's: window rows, the
device gather, in-place updates, bank creation, and `.npz` files moving
between the two packages."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from tmrnet_tpu.data.indexing import memory_window_rows as jax_window_rows
from tmrnet_tpu.memory import lfb as jax_lfb
from tmrnet_torch.memory import lfb

torch.set_num_threads(2)

SEQ, LENGTHS = 3, (7, 12, 2, 9)


def _table():
    return np.repeat(lfb.video_first_rows(SEQ, LENGTHS),
                     lfb.clips_per_video(SEQ, LENGTHS))


@pytest.mark.parametrize("window", [1, 5, 30])
def test_memory_window_rows_matches_jax(window):
    table = _table()
    rows = np.array([0, 3, 4, 9, 15, len(table) - 1], np.int64)
    want = jax_window_rows(rows, table[rows], window)
    np.testing.assert_array_equal(lfb.memory_window_rows(rows, table[rows], window), want)
    got = lfb.memory_window_rows(torch.from_numpy(rows),
                                 torch.from_numpy(table[rows]), window)
    np.testing.assert_array_equal(got.numpy(), want)


def test_gather_memory_windows_matches_jax():
    rng = np.random.RandomState(0)
    table = _table()
    feats = rng.randn(len(table), 6).astype(np.float32)
    rows = np.array([5, 0, 17, 11], np.int32)
    want = jax_lfb.gather_memory_windows(jnp.asarray(feats), jnp.asarray(rows),
                                         jnp.asarray(table[rows], jnp.int32), 4)
    got = lfb.gather_memory_windows(torch.from_numpy(feats),
                                    torch.from_numpy(rows),
                                    torch.from_numpy(table[rows]), 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="align"):
        lfb.gather_memory_windows(torch.from_numpy(feats),
                                  torch.from_numpy(rows),
                                  torch.from_numpy(table), 4)


def test_create_and_update_bank_match_jax():
    jb = jax_lfb.FeatureBank.create(SEQ, LENGTHS, 4)
    tb = lfb.FeatureBank.create(SEQ, LENGTHS, 4, device="cpu")
    np.testing.assert_array_equal(tb.first_rows.numpy(), np.asarray(jb.first_rows))
    assert tb.first_rows.dtype == torch.int32 and tb.num_rows == jb.num_rows
    rows = np.array([2, 9, 0], np.int32)
    vals = np.arange(12, dtype=np.float32).reshape(3, 4)
    want = jax_lfb.update_bank(jb.features, jnp.asarray(rows), jnp.asarray(vals))
    out = lfb.update_bank(tb.features, torch.from_numpy(rows), torch.from_numpy(vals))
    assert out is tb.features                      # written in place
    np.testing.assert_array_equal(tb.features.numpy(), np.asarray(want))


def test_npz_round_trip_between_packages(tmp_path):
    rng = np.random.RandomState(1)
    feats = rng.randn(20, 8).astype(np.float32)
    firsts = np.repeat(np.array([0, 12], np.int32), [12, 8])
    jax_lfb.save_bank(str(tmp_path / "jax.npz"), jax_lfb.FeatureBank(
        jnp.asarray(feats), jnp.asarray(firsts)))
    tb = lfb.load_bank(str(tmp_path / "jax.npz"), device="cpu")
    np.testing.assert_array_equal(tb.features.numpy(), feats)
    np.testing.assert_array_equal(tb.first_rows.numpy(), firsts)

    lfb.save_bank(str(tmp_path / "torch.npz"), tb)
    jb = jax_lfb.load_bank(str(tmp_path / "torch.npz"))
    np.testing.assert_array_equal(np.asarray(jb.features), feats)
    np.testing.assert_array_equal(np.asarray(jb.first_rows), firsts)
    with np.load(tmp_path / "jax.npz") as a, np.load(tmp_path / "torch.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for name in a.files:
            assert a[name].dtype == b[name].dtype
            np.testing.assert_array_equal(a[name], b[name])


def test_bf16_bank_saves_as_float32(tmp_path):
    feats = torch.randn(4, 3, generator=torch.Generator().manual_seed(0))
    bank = lfb.FeatureBank(feats.bfloat16(), torch.zeros(4, dtype=torch.int32))
    lfb.save_bank(str(tmp_path / "b.npz"), bank)
    back = lfb.load_bank(str(tmp_path / "b.npz"), dtype=torch.bfloat16, device="cpu")
    assert torch.equal(back.features, bank.features)
