"""The two-stage workflow through the CLIs, on the CPU in f32:

    manifest -> train-bank -> build-lfb --ckpt -> train-tmr -> test --ckpt

`python -m tmrnet_torch ... --device cpu` against `python -m tmrnet_tpu`
with the same arguments: the same `--config` JSON (written by the JAX
package, dropout 0), packed frames with phase annotations split into a
train and a val manifest, and reference `.pth` weights (`--torch-init`)
so that both packages start from the same weights. The train-bank and
train-tmr best checkpoints' metrics agree (the same best epoch and val
accuracy, val loss within 1e-3 relative), the banks built from the
stage-1 checkpoints within 1e-3 of max |feature|, and `test --ckpt`'s
predictions are equal with scores within 1e-3. Each command runs once
per package. Then the port's `train-tmr --stage1-ckpt` (the stage-1 trunk
and LSTM over a fresh head), and what the training commands refuse.
"""

import json

import numpy as np
import pytest
import torch

from tmrnet_tpu import cli as jax_cli
from tmrnet_tpu.config import (CHOLEC80_PHASES, DataConfig, EvalConfig,
                               ExperimentConfig, MemoryConfig, ModelConfig,
                               TrainConfig)
from tmrnet_tpu.models.torch_import import export_reference_checkpoint
from tmrnet_torch import cli
from tmrnet_torch.config import ModelConfig as PortModelConfig
from tmrnet_torch.models.convert import random_variables

from tests.test_torch_cli_test import _Capture

torch.set_num_threads(2)

SEQ, HW, CROP, CLASSES = 3, 40, 32, 5
SPLITS = {"train": (14, 11), "val": (9, 6, 2)}
MODEL = dict(backbone="tiny", stage_sizes=(1, 1), width=8, hidden_dim=16,
             num_classes=CLASSES, head="tmr", compute_dtype="float32",
             dropout_stage1=0.0, dropout_head=0.0, dropout_nl=0.0)
JAX_ARGS = ["--set", "mesh.data_parallel=1"]
PORT_ARGS = ["--device", "cpu"]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli_train")
    cfg = ExperimentConfig(
        data=DataConfig(sequence_length=SEQ, resize=HW, crop_size=CROP,
                        test_crop_type=1, device_normalize=True,
                        batch_clips=4, num_workers=2),
        model=ModelConfig(**MODEL), memory=MemoryConfig(window=4),
        train=TrainConfig(epochs=2, lr=0.05, log_every=100,
                          plateau_patience=0),
        eval=EvalConfig(batch_clips=8))
    (d / "cfg.json").write_text(cfg.to_json())
    for head, seed in (("stage1", 71), ("tmr", 72)):
        variables = random_variables(PortModelConfig(**dict(MODEL, head=head)),
                                     seed)
        sd = export_reference_checkpoint(variables, head, (1, 1))
        torch.save({k: torch.from_numpy(v) for k, v in sd.items()},
                   d / f"{head}.pth")
    (d / "ann").mkdir()
    rng = np.random.default_rng(73)
    for split, lengths in SPLITS.items():
        (d / split).mkdir()
        for v, n in enumerate(lengths):
            vid = f"video{split}{v}"
            np.save(d / split / f"{vid}.npy",
                    rng.integers(0, 256, (n, HW, HW, 3), dtype=np.uint8))
            rows = [f"{25 * k}\t{CHOLEC80_PHASES[(k // 3 + v) % CLASSES]}\n"
                    for k in range(n)]
            (d / "ann" / f"{vid}-phase.txt").write_text(
                "Frame\tPhase\n" + "".join(rows))
    return d


def _chain(main, files, out, extra):
    out.mkdir()
    cfg = ["--config", str(files / "cfg.json")]
    p = lambda name: str(out / name)
    for split in SPLITS:
        assert main(["manifest", *cfg, "--frames", str(files / split),
                     "--annotations", str(files / "ann"),
                     "--out", p(f"{split}.pkl")]) == 0
    manifests = ["--train-manifest", p("train.pkl"), "--val-manifest",
                 p("val.pkl")]
    assert main(["train-bank", *cfg, *manifests, "--torch-init",
                 str(files / "stage1.pth"), "--log-dir", p("log1"), "--set",
                 f"train.checkpoint_dir={p('ck1')}", *extra]) == 0
    for split in SPLITS:
        assert main(["build-lfb", *cfg, "--manifest", p(f"{split}.pkl"),
                     "--ckpt", p("ck1"), "--engine", "clip",
                     "--out", p(f"bank_{split}.npz"), *extra]) == 0
    assert main(["train-tmr", *cfg, *manifests, "--lfb", p("bank_train.npz"),
                 "--val-lfb", p("bank_val.npz"), "--torch-init",
                 str(files / "tmr.pth"), "--log-dir", p("log2"), "--set",
                 f"train.checkpoint_dir={p('ck2')}", *extra]) == 0
    assert main(["test", *cfg, "--manifest", p("val.pkl"), "--ckpt",
                 p("ck2"), "--lfb", p("bank_val.npz"), "--out",
                 p("preds.npz"), *extra]) == 0


@pytest.fixture(scope="module")
def runs(files):
    with _Capture() as capture:
        _chain(jax_cli.main, files, files / "jax", JAX_ARGS)
        jax_out = capture.readouterr().out
        _chain(cli.main, files, files / "port", PORT_ARGS)
        port_out = capture.readouterr().out
    return dict(jax=files / "jax", port=files / "port", jax_out=jax_out,
                port_out=port_out)


@pytest.mark.parametrize("ck", ["ck1", "ck2"])
def test_best_checkpoints_agree(runs, ck):
    j = json.loads((runs["jax"] / ck / "best.json").read_text())["metrics"]
    p = json.loads((runs["port"] / ck / "best.json").read_text())["metrics"]
    assert set(p) == set(j)
    assert p["epoch"] == j["epoch"]
    assert p["val_acc"] == pytest.approx(j["val_acc"])
    assert p["val_loss"] == pytest.approx(j["val_loss"], rel=1e-3)


@pytest.mark.parametrize("split", list(SPLITS))
def test_banks_from_the_stage1_checkpoints_agree(runs, split):
    with np.load(runs["jax"] / f"bank_{split}.npz") as z, \
            np.load(runs["port"] / f"bank_{split}.npz") as w:
        scale = np.abs(z["features"]).max()
        np.testing.assert_allclose(w["features"], z["features"], rtol=0,
                                   atol=1e-3 * scale)


def test_predictions_from_the_stage2_checkpoint_agree(runs):
    with np.load(runs["jax"] / "preds.npz") as z, \
            np.load(runs["port"] / "preds.npz") as w:
        np.testing.assert_array_equal(w["preds"], z["preds"])
        np.testing.assert_allclose(w["scores"], z["scores"], rtol=0,
                                   atol=1e-3)
    summary = lambda out: {k: v for k, v in json.loads(
        out.strip().splitlines()[-1]).items() if k != "out"}
    assert summary(runs["port_out"]) == summary(runs["jax_out"])
    assert "best epoch" in runs["port_out"]


def test_train_tmr_from_a_stage1_checkpoint(files, runs, capsys):
    """--stage1-ckpt: the stage-1 best's trunk and LSTM over a fresh
    head; the run trains and writes its best."""
    out = runs["port"]
    cfg = cli.load_config(type("A", (), {"config": str(files / "cfg.json"),
                                         "set": []})())
    s1 = cli.checkpoint_weights(str(out / "ck1"))
    init = cli.init_with(cfg, "tmr", {k: v for k, v in s1.items()
                                      if k.startswith(("backbone.",
                                                       "encoder."))})
    for k in init:
        if k.startswith(("backbone.", "encoder.")):
            assert torch.equal(init[k], s1[k]), k
    fresh = cli.init_with(cfg, "tmr", {})
    assert torch.equal(init["fc_c.weight"], fresh["fc_c.weight"])
    assert cli.main(["train-tmr", "--config", str(files / "cfg.json"),
                     "--train-manifest", str(out / "train.pkl"),
                     "--lfb", str(out / "bank_train.npz"), "--stage1-ckpt",
                     str(out / "ck1"), "--log-dir", str(out / "log3"),
                     "--set", f"train.checkpoint_dir={out / 'ck3'}",
                     "--set", "train.epochs=1", *PORT_ARGS]) == 0
    assert "best epoch 0" in capsys.readouterr().out
    assert (out / "ck3" / "best" / "state.pt").exists()


def test_training_commands_refuse(files, runs, monkeypatch):
    out = runs["port"]
    base = ["--config", str(files / "cfg.json"), "--train-manifest",
            str(out / "train.pkl")]
    for argv in (["train-bank", *base, "--videos", "x"],
                 ["train-tmr", *base, "--lfb", "x", "--videos", "x"],
                 ["test", "--manifest", "m", "--ckpt", "x",
                  "--extractor-ckpt", "x", "--extractor-torch-ckpt", "y"],
                 ["test", "--manifest", "m", "--ckpt", "x", "--torch-ckpt",
                  "y"],
                 ["build-lfb", "--manifest", "m", "--out", "o"]):
        with pytest.raises(SystemExit) as exc:      # argparse errors
            cli.main(argv)
        assert exc.value.code == 2
    # remat and async checkpoints train (one epoch), the last save durable
    # when the command returns
    ck = out / "ck_options"
    assert cli.main(["train-bank", *base, "--set", "train.remat=true",
                     "--set", "train.async_checkpoint=true", "--set",
                     "train.epochs=1", "--set", f"train.checkpoint_dir={ck}",
                     "--log-dir", str(out / "log_options"), *PORT_ARGS]) == 0
    step = max(int(p.name[5:]) for p in ck.glob("step_????????"))
    assert (ck / f"step_{step:08d}" / "state.pt").exists()
    assert (ck / "best" / "state.pt").exists()
    with pytest.raises(SystemExit, match="checkpoint dir not found"):
        cli.main(["build-lfb", "--config", str(files / "cfg.json"),
                  "--manifest", str(out / "val.pkl"), "--ckpt",
                  str(out / "none"), "--out", str(out / "x.npz"),
                  *PORT_ARGS])
    from tmrnet_torch import device

    monkeypatch.setattr(device, "resolve_device",
                        lambda d: torch.device("cuda", 0))
    # head tmr at model.compute_dtype=float32 passes the dtype check on a
    # (faked) card, turning TF32 off there, and goes on to its bank; so
    # does a folded trunk in f32 (the f32 bottleneck kernels take it)
    from tmrnet_torch.memory import lfb

    class ReachedTheBank(Exception):
        pass

    def load_bank(path, **kw):
        assert kw["device"] == torch.device("cuda", 0)
        raise ReachedTheBank(path)

    monkeypatch.setattr(lfb, "load_bank", load_bank)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    with pytest.raises(ReachedTheBank):
        cli.main(["train-tmr", *base, "--lfb", "x"])
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    with pytest.raises(ReachedTheBank):
        cli.main(["train-tmr", *base, "--lfb", "x", "--set",
                  "model.folded=true"])
    assert not torch.backends.cudnn.allow_tf32
