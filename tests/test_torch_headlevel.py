"""The multi-scale companions on the CPU against the JAX package's scripts:
`experimental/headlevel_multiscale.py` against `scripts/
headlevel_multiscale.py` (the `HeadOnly` forward on JAX's weights carried
across, one Adam step against `optax.adam`, `pair_tensors` on the same
manifest and bank files) and `experimental/timeconv_witness.py` against
`scripts/timeconv_witness.py` (`witness_statistic`, `auc`, `xy_detectors`
and `main`).

HeadOnly at hidden 32, window 40, f32: the forward within 1e-5 (rtol and
atol); one Adam step (lr 1e-3): the gradients within 1e-5 of JAX's
(relative to the largest gradient of the model), and every parameter
element whose
JAX gradient is at least GRAD_FLOOR = 1e-6 in magnitude within 2e-6 of
optax's after the step (Adam moves each by up to 1e-3). Below the floor
the first step's update, g / (|g| + 1e-8), follows rounding noise: the
key projection's bias has no gradient in exact arithmetic (it adds one
constant to every logit of the softmax), and its noise, normalised by
Adam, moves it by up to 1e-3 either way in both packages. The pair
tensors equal exactly (gathers of the same f32 rows); the witness's
numbers within 1e-10 (the same float64 numpy)."""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from scripts import headlevel_multiscale as jax_head
from scripts import timeconv_witness as jax_witness
from tmrnet_torch import cli
from tmrnet_torch.experimental import headlevel_multiscale as head
from tmrnet_torch.experimental import timeconv_witness as witness
from tmrnet_torch.memory.lfb import FeatureBank, save_bank
from tmrnet_torch.models.convert import from_jax_variables

torch.set_num_threads(2)

HIDDEN, WINDOW, B = 32, 40, 16
FORWARD_TOL = dict(rtol=1e-5, atol=1e-5)
ADAM_ATOL, GRAD_RTOL, GRAD_FLOOR = 2e-6, 1e-5, 1e-6
WITNESS_TOL = dict(rtol=1e-10, atol=1e-10)


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    st = rng.standard_normal((B, HIDDEN), dtype=np.float32)
    lt = rng.standard_normal((B, WINDOW, HIDDEN), dtype=np.float32)
    return st, lt, rng.integers(0, 2, B)


def _flax(use_time_conv, st, lt, seed=3):
    model = jax_head.HeadOnly(hidden=HIDDEN, use_time_conv=use_time_conv)
    params = model.init(jax.random.key(seed), jnp.asarray(st[:2]),
                        jnp.asarray(lt[:2]))
    port = head.HeadOnly(HIDDEN, use_time_conv)
    port.load_state_dict(from_jax_variables(jax.tree_util.tree_map(
        np.asarray, params)), strict=True)
    return model, params, port


@pytest.mark.parametrize("use_time_conv", [True, False])
def test_head_only_forward_matches_flax(use_time_conv):
    st, lt, _ = _inputs()
    model, params, port = _flax(use_time_conv, st, lt)
    want = np.asarray(model.apply(params, jnp.asarray(st), jnp.asarray(lt)))
    with torch.no_grad():
        got = port(torch.from_numpy(st), torch.from_numpy(lt)).numpy()
    assert got.shape == (B, 2)
    np.testing.assert_allclose(got, want, **FORWARD_TOL)
    assert (port.time_conv is not None) == use_time_conv


@pytest.mark.parametrize("use_time_conv", [True, False])
def test_one_adam_step_matches_optax(use_time_conv):
    st, lt, y = _inputs(1)
    model, params, port = _flax(use_time_conv, st, lt, seed=4)
    tx = optax.adam(1e-3)

    def loss_fn(p):
        logits = model.apply(p, jnp.asarray(st), jnp.asarray(lt))
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(y)).mean()

    loss, grads = jax.value_and_grad(loss_fn)(params)
    updates, _ = tx.update(grads, tx.init(params), params)
    flat = lambda tree: from_jax_variables(jax.tree_util.tree_map(
        np.asarray, tree))
    want, want_grads, before = (flat(optax.apply_updates(params, updates)),
                                flat(grads), flat(params))
    got_loss = head.adam_step(port, 1e-3)(torch.from_numpy(st),
                                          torch.from_numpy(lt),
                                          torch.from_numpy(y))
    np.testing.assert_allclose(float(got_loss), float(loss), rtol=1e-5)
    got = port.state_dict()
    assert set(got) == set(want)
    grads = dict(port.named_parameters())
    scale = max(float(np.abs(g.numpy()).max()) for g in want_grads.values())
    checked = 0
    for k, w in want.items():
        g, wg = grads[k].grad.numpy(), want_grads[k].numpy()
        np.testing.assert_allclose(g, wg, rtol=0, atol=GRAD_RTOL * scale,
                                   err_msg=k)
        live = np.abs(wg) >= GRAD_FLOOR
        np.testing.assert_allclose(got[k].numpy()[live], w.numpy()[live],
                                   rtol=0, atol=ADAM_ATOL, err_msg=k)
        assert (got[k] != before[k]).numpy()[live].all(), k
        checked += int(live.sum())
    assert checked > 0.9 * sum(v.numel() for v in want.values())


def test_init_head_is_seeded():
    a = head.init_head(HIDDEN, True, 5).state_dict()
    b = head.init_head(HIDDEN, True, 5).state_dict()
    c = head.init_head(HIDDEN, True, 6).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["fc_c.weight"], c["fc_c.weight"])


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    """synth --task multiscale (2 train videos, 1 test), the manifests and
    a seeded bank a split, written by the port's command line and
    `save_bank`: the files `pair_tensors` and the witness read."""
    d = tmp_path_factory.mktemp("multiscale")
    assert cli.main(["synth", "--out-dir", str(d), "--train", "2", "--val",
                     "0", "--test", "1", "--hw", "8", "--seed", "0",
                     "--task", "multiscale"]) == 0
    rng = np.random.default_rng(7)
    for split in ("train", "test"):
        assert cli.main(["manifest", "--frames", str(d / f"frames-{split}"),
                         "--annotations", str(d / "annotations"),
                         "--stride", "1", "--out",
                         str(d / f"{split}.pkl")]) == 0
        from tmrnet_torch.data.manifests import load_pickle_manifest
        from tmrnet_torch.data.synthetic import MULTISCALE_SEQ

        m, _ = load_pickle_manifest(str(d / f"{split}.pkl"))
        bank = FeatureBank.create(MULTISCALE_SEQ, m.video_lengths, HIDDEN,
                                  device="cpu")
        bank.features.copy_(torch.from_numpy(rng.standard_normal(
            tuple(bank.features.shape), dtype=np.float32)))
        save_bank(str(d / f"lfb_{split}.npz"), bank)
    return str(d)


@pytest.mark.parametrize("split", ["train", "test"])
def test_pair_tensors_equal_jax(work, split):
    got = head.pair_tensors(work, split)
    want = jax_head.pair_tensors(work, split)
    assert len(got[2]) > 0 and 0 < got[2].sum() < len(got[2])
    for g, w in zip(got, want):
        assert g.shape == np.asarray(w).shape
        np.testing.assert_array_equal(g, np.asarray(w))
    assert got[1].shape[1:] == (WINDOW, HIDDEN)


def test_witness_functions_equal_jax(work):
    rng = np.random.default_rng(9)
    lt = rng.standard_normal((50, WINDOW, 17))
    u, v = rng.standard_normal(18), rng.standard_normal(18)
    stat = witness.witness_statistic(lt, u, v)
    np.testing.assert_allclose(stat, jax_witness.witness_statistic(lt, u, v),
                               **WITNESS_TOL)
    y = rng.integers(0, 2, 50)
    assert witness.auc(stat, y) == pytest.approx(jax_witness.auc(stat, y),
                                                 abs=1e-10)
    assert np.isnan(witness.auc(stat, np.ones(50, int)))
    for g, w in zip(witness.xy_detectors(work), jax_witness.xy_detectors(work)):
        np.testing.assert_allclose(g, w, **WITNESS_TOL)


def test_witness_main_equals_jax(work, capsys):
    assert witness.main(["--work", work]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert jax_witness.main(["--work", work]) == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got == want and set(got) == {"train", "test"}


def test_headlevel_refuses_the_card_without_full_scale(tmp_path):
    """On the card (the default) the tiny model is refused by name before
    anything is written."""
    with pytest.raises(SystemExit, match="--full-scale"):
        head.main(["--work", str(tmp_path / "w")])
    assert not (tmp_path / "w").exists()


def test_train_head_runs_on_the_cpu(work):
    """A few steps of each head on the pair tensors: JAX's row keys,
    accuracies in [0, 1]."""
    st, lt, y = head.pair_tensors(work, "train")
    st_te, lt_te, y_te = head.pair_tensors(work, "test")
    for tc in (True, False):
        row = head.train_head(st, lt, y, st_te, lt_te, y_te, tc, 0, HIDDEN,
                              steps=3, batch=8, device="cpu")
        assert set(row) == {"head", "seed", "train_acc", "test_acc"}
        assert row["head"] == ("tmr" if tc else "nl_only")
        assert 0 <= row["train_acc"] <= 1 and 0 <= row["test_acc"] <= 1
