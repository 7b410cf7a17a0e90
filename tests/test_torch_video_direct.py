"""The port's video-direct datasets against JAX's, on mp4s written by cv2
with phase annotations at source fps.

- `cli.video_dataset` against JAX's `_video_dataset`: the videos kept (an
  annotation that misses frame 0 skips a video, one that ends early
  truncates it, each with a warning), the label arrays, `first_rows` and
  the manifest view equal; `get_clip(row, epoch)` within 1e-7 for the
  eval and the train transform (the same `clip_rng` seeds); `clip_labels`
  the label `get_clip` returns, row for row; a `ClipLoader` of process
  workers gives the thread workers' batches.
- The first stage-1 train step on a video-direct batch (the loaders'
  first shuffled batch of float [0, 1] clips, prepared as the card
  prepares them: cast, not normalized) in both packages from the same
  variables (`from_jax_variables`), dropout 0: the loss and the updated
  weights within rtol 1e-3 / atol 1e-4.
- `train-bank --videos` -> `build-lfb --videos --ckpt` -> `train-tmr
  --videos` through the port's `main(..., "--device", "cpu")` at the
  sizes of `tests/test_video_direct.py:151-182`: each exits 0, the
  trainers print their best epoch, the bank has a row a clip.
- The refusals: without a decoder `train-bank --videos`, `build-lfb
  --videos` and `train-tmr --videos` exit naming both before they list
  anything; `--engine video --videos`, `--videos` without
  `--annotations`, `build-lfb` with neither source or both, and a val
  set from the other source than the train set's.
"""

import os
import sys

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

import jax
import jax.numpy as jnp

from tmrnet_tpu import cli as jax_cli
from tmrnet_tpu.config import CHOLEC80_PHASES
from tmrnet_tpu.config import DataConfig as JaxDataConfig
from tmrnet_tpu.config import ExperimentConfig as JaxExperimentConfig
from tmrnet_tpu.config import ModelConfig as JaxModelConfig
from tmrnet_tpu.config import TrainConfig as JaxTrainConfig
from tmrnet_tpu.data import pipeline as jax_pipeline
from tmrnet_tpu.data.device_feed import DevicePrep as JaxDevicePrep
from tmrnet_tpu.models.tmrnet import build_model as jax_build_model
from tmrnet_tpu.train import losses as jax_losses
from tmrnet_tpu.train.optim import make_optimizer as jax_make_optimizer
from tmrnet_tpu.train.optim import slow_modules_for_head as jax_slow
from tmrnet_tpu.train.state import create_train_state
from tmrnet_tpu.train.steps import make_stage1_steps as jax_stage1_steps
from tmrnet_torch import cli
from tmrnet_torch.config import DataConfig, ExperimentConfig, ModelConfig
from tmrnet_torch.config import TrainConfig
from tmrnet_torch.data import pipeline
from tmrnet_torch.data.device_feed import DevicePrep
from tmrnet_torch.memory.lfb import load_bank
from tmrnet_torch.models.convert import from_jax_variables
from tmrnet_torch.models.tmrnet import build_model
from tmrnet_torch.train import losses
from tmrnet_torch.train.optim import make_optimizer, slow_modules_for_head
from tmrnet_torch.train.state import TrainState
from tmrnet_torch.train.steps import make_stage1_steps

torch.set_num_threads(2)

SEQ, CROP, BATCH, NCLS = 3, 32, 8, 7
MODEL = dict(backbone="tiny", stage_sizes=(1, 1), width=8, hidden_dim=16,
             num_classes=NCLS, head="stage1", compute_dtype="float32",
             dropout_stage1=0.0, dropout_head=0.0, dropout_nl=0.0)
TRAIN = dict(optimizer="sgd", lr=0.05, momentum=0.9, weight_decay=5e-4,
             trunk_lr_scale=0.1)
# the sizes of tests/test_video_direct.py:151-182
COMMON = ["--set", "model.backbone=tiny", "--set", "model.stage_sizes=1,1",
          "--set", "model.width=8", "--set", "model.hidden_dim=16",
          "--set", "data.sequence_length=3", "--set", "data.crop_size=32",
          "--set", "data.batch_clips=8", "--set", "data.num_workers=2",
          "--set", "memory.window=4", "--set", "train.epochs=1",
          "--set", "model.compute_dtype=float32"]


def _write_tree(root, seconds=(12, 10), fps=25, hw=64):
    """Videos of random frames and their annotations at source fps (a
    phase every 100 frames), as tests/test_video_direct.py writes them;
    video03's annotations start late, video04's end early."""
    vdir, ann = root / "videos", root / "ann"
    vdir.mkdir()
    ann.mkdir()
    rng = np.random.RandomState(0)
    lengths = list(seconds) + [4, 8]
    for v, sec in enumerate(lengths, start=1):
        w = cv2.VideoWriter(str(vdir / f"video{v:02d}.mp4"),
                            cv2.VideoWriter_fourcc(*"mp4v"), fps, (hw, hw))
        for k in range(sec * fps):
            w.write(rng.randint(0, 255, (hw, hw, 3), dtype=np.uint8))
        w.release()
        first, last = {3: (50, sec * fps), 4: (0, 130)}.get(v, (0, sec * fps))
        with open(ann / f"video{v:02d}-phase.txt", "w") as f:
            f.write("Frame\tPhase\n")
            for k in range(first, last):
                f.write(f"{k}\t{CHOLEC80_PHASES[(k // 100) % 7]}\n")
    (vdir / "readme.txt").write_text("not a video")
    return str(vdir), str(ann)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return _write_tree(tmp_path_factory.mktemp("videos"))


def _configs():
    data = dict(sequence_length=SEQ, crop_size=CROP, batch_clips=BATCH,
                num_workers=2, device_normalize=True)
    return (JaxExperimentConfig(data=JaxDataConfig(**data)),
            ExperimentConfig(data=DataConfig(**data)))


@pytest.fixture(scope="module")
def datasets(tree):
    """Both packages' datasets, train and eval, with their stderr."""
    import contextlib
    import io

    jcfg, pcfg = _configs()
    out = {}
    for name, make, cfg in (("jax", jax_cli._video_dataset, jcfg),
                            ("port", cli.video_dataset, pcfg)):
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            out[name] = {train: make(cfg, tree[0], tree[1], train)
                         for train in (True, False)}
        out[name + "_err"] = err.getvalue()
    return out


def test_video_dataset_matches_jax(datasets):
    for train in (True, False):
        j, p = datasets["jax"][train], datasets["port"][train]
        assert p.reader.paths == j.reader.paths
        np.testing.assert_array_equal(p.reader.num_frames, j.reader.num_frames)
        assert p.reader.stride == j.reader.stride == 25
        assert len(p.labels) == len(j.labels) == 3
        for a, b in zip(p.labels, j.labels):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(p.first_rows, j.first_rows)
        assert p.num_clips == j.num_clips == 10 + 8 + 4
        assert p.manifest.video_lengths == j.manifest.video_lengths
        np.testing.assert_array_equal(p.manifest.flat_labels(),
                                      j.manifest.flat_labels())
    assert datasets["port_err"] == datasets["jax_err"]
    err = datasets["port_err"]
    assert "video03.mp4: annotations do not cover frame 0; skipping" in err
    assert "video04.mp4: annotations end at sampled frame 6/8" in err
    assert [os.path.basename(p) for p in
            datasets["port"][True].reader.paths] == [
        "video01.mp4", "video02.mp4", "video04.mp4"]


@pytest.mark.parametrize("train", [False, True])
def test_get_clip_matches_jax(datasets, train):
    j, p = datasets["jax"][train], datasets["port"][train]
    for epoch in (0, 1):
        for row in range(p.num_clips):
            pc, pl = p.get_clip(row, epoch)
            jc, jl = j.get_clip(row, epoch)
            assert pc.dtype == np.float32 and pc.shape == (SEQ, CROP, CROP, 3)
            np.testing.assert_allclose(pc, jc, rtol=0, atol=1e-7)
            assert pl == jl == p.clip_labels[row]
            assert p.clip_location(row) == j.clip_location(row)
            assert 0.0 <= pc.min() and pc.max() <= 1.0
    assert p.clip_labels.dtype == np.int64
    assert len(p.clip_labels) == p.num_clips


def test_process_workers_match_threads(datasets):
    ds = datasets["port"][False]
    got = list(pipeline.ClipLoader(ds, BATCH, num_workers=2,
                                   use_processes=True).epoch(0))
    want = list(pipeline.ClipLoader(ds, BATCH, num_workers=2).epoch(0))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        for a, b in zip(g[:3], w[:3]):
            np.testing.assert_array_equal(a, b)
        assert g[3] == w[3]


def _first_batch(loader_cls, ds):
    return next(iter(loader_cls(ds, BATCH, shuffle=True, num_workers=2,
                                seed=0, drop_remainder=True).epoch(0)))


def test_first_video_direct_stage1_step_matches_jax(datasets):
    jds, pds = datasets["jax"][True], datasets["port"][True]
    jclips, jlabels, jrows, _ = _first_batch(jax_pipeline.ClipLoader, jds)
    pclips, plabels, prows, _ = _first_batch(pipeline.ClipLoader, pds)
    np.testing.assert_array_equal(prows, jrows)
    np.testing.assert_array_equal(plabels, jlabels)
    np.testing.assert_allclose(pclips, jclips, rtol=0, atol=1e-7)
    assert pclips.dtype == np.float32

    model = jax_build_model(JaxModelConfig(**MODEL))
    variables = model.init(jax.random.PRNGKey(7),
                           jnp.zeros((1, SEQ, CROP, CROP, 3)))
    w = np.asarray(jax_losses.balanced_class_weights(
        jds.manifest.flat_labels(), NCLS), np.float32)
    np.testing.assert_allclose(
        losses.balanced_class_weights(pds.manifest.flat_labels(), NCLS), w,
        rtol=1e-6)
    tx = jax_make_optimizer(JaxTrainConfig(**TRAIN), variables["params"],
                            jax_slow("stage1"))
    jstate = create_train_state(model, variables, tx)
    jtrain, _ = jax_stage1_steps(class_weights=w, donate=False,
                                 prep=JaxDevicePrep(JaxDataConfig(
                                     device_normalize=True), "float32"))
    jstate, jm = jtrain(jstate, jnp.asarray(jclips), jnp.asarray(jlabels),
                        jax.random.PRNGKey(0))

    before = from_jax_variables(jax.tree_util.tree_map(np.asarray, variables))
    pmodel = build_model(ModelConfig(**MODEL), device="cpu")
    pmodel.load_state_dict(before)
    pstate = TrainState(pmodel, make_optimizer(TrainConfig(**TRAIN), pmodel,
                                               slow_modules_for_head("stage1")))
    prep = DevicePrep(DataConfig(device_normalize=True), "float32", "cpu")
    seen = []
    ptrain, _ = make_stage1_steps(class_weights=torch.from_numpy(w),
                                  prep=lambda x: seen.append(x) or prep(x))
    pm = ptrain(pstate, torch.from_numpy(pclips), torch.from_numpy(plabels),
                torch.Generator().manual_seed(0))
    # the float [0, 1] clip reaches the model as it is: cast, not normalized
    assert torch.equal(prep(seen[0]), torch.from_numpy(pclips))

    assert float(pm["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-3)
    after = from_jax_variables(jax.tree_util.tree_map(np.asarray,
                                                      jstate.variables))
    got = pstate.model.state_dict()
    moved = 0.0
    for k, want in after.items():
        if "num_batches" in k:
            continue
        np.testing.assert_allclose(got[k].numpy(), want.numpy(), rtol=1e-3,
                                   atol=1e-4, err_msg=k)
        moved = max(moved, float(np.abs(want.numpy()
                                        - before[k].numpy()).max()))
    assert moved > 1e-4


def test_cli_video_direct_two_stages(tree, tmp_path, capsys):
    videos, ann = tree
    cpu = ["--device", "cpu"]
    assert cli.main(["train-bank", "--videos", videos, "--annotations", ann,
                     "--val-videos", videos, "--log-dir",
                     str(tmp_path / "runs"), "--set",
                     f"train.checkpoint_dir={tmp_path / 'ck1'}",
                     *COMMON, *cpu]) == 0
    assert "best epoch 0" in capsys.readouterr().out
    lfb = str(tmp_path / "lfb.npz")
    assert cli.main(["build-lfb", "--videos", videos, "--annotations", ann,
                     "--ckpt", str(tmp_path / "ck1"), "--out", lfb,
                     *COMMON, *cpu]) == 0
    assert capsys.readouterr().out.startswith("bank: 22 rows x 16")
    bank = load_bank(lfb, device="cpu")
    assert torch.isfinite(bank.features).all()
    assert cli.main(["train-tmr", "--videos", videos, "--annotations", ann,
                     "--val-videos", videos, "--lfb", lfb, "--val-lfb", lfb,
                     "--stage1-ckpt", str(tmp_path / "ck1"),
                     "--log-dir", str(tmp_path / "runs2"), "--set",
                     f"train.checkpoint_dir={tmp_path / 'ck2'}", "--set",
                     "model.head=tmr", *COMMON, *cpu]) == 0
    assert "best epoch 0" in capsys.readouterr().out
    assert (tmp_path / "ck2" / "best.json").exists()


def test_video_flags_refuse(tree, tmp_path, monkeypatch):
    videos, ann = tree
    cpu = ["--device", "cpu"]
    lfb_argv = ["build-lfb", "--videos", videos, "--annotations", ann,
                "--ckpt", str(tmp_path), "--out", str(tmp_path / "b.npz")]
    with pytest.raises(SystemExit, match="--engine video needs a frame"):
        cli.main([*lfb_argv, "--engine", "video", *cpu])
    with pytest.raises(SystemExit, match="needs --manifest or --videos"):
        cli.main(["build-lfb", "--ckpt", str(tmp_path), "--out",
                  str(tmp_path / "b.npz"), *cpu])
    with pytest.raises(SystemExit, match="requires --annotations"):
        cli.main(["train-bank", "--videos", videos, *cpu])
    with pytest.raises(SystemExit):      # --val-videos is the trainers'
        cli.main([*lfb_argv, "--val-videos", videos, *cpu])
    with pytest.raises(SystemExit) as e:    # one source of frames
        cli.main([*lfb_argv, "--manifest", "m.pkl", *cpu])
    assert e.value.code == 2
    for argv, match in (
            (["--videos", videos, "--val-manifest", "v.pkl"],
             "with --videos pass --val-videos"),
            (["--train-manifest", "t.pkl", "--val-videos", videos],
             "--val-videos needs --videos")):
        for cmd in (["train-bank"], ["train-tmr", "--lfb", "b.npz"]):
            with pytest.raises(SystemExit, match=match):
                cli.main([*cmd, *argv, "--annotations", ann, *cpu])

    for mod in ("cv2", "av", "imageio", "imageio.v3"):
        monkeypatch.setitem(sys.modules, mod, None)
    listed = []
    real = os.listdir
    monkeypatch.setattr(os, "listdir", lambda p=".": listed.append(p) or
                        real(p))
    for argv in (["train-bank", "--videos", videos, "--annotations", ann,
                  "--set", f"train.checkpoint_dir={tmp_path / 'ck'}"],
                 lfb_argv,
                 ["train-tmr", "--videos", videos, "--annotations", ann,
                  "--lfb", str(tmp_path / "b.npz"), "--set",
                  f"train.checkpoint_dir={tmp_path / 'ck'}"]):
        with pytest.raises(SystemExit, match="imageio\\+pyav.*cv2"):
            cli.main([*argv, *COMMON, *cpu])
    assert listed == []
    assert not (tmp_path / "ck").exists() and not (tmp_path / "b.npz").exists()
