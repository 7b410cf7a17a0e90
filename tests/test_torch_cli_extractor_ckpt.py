"""The checkpoint flags of `test`, `stream` and `serve`, on the CPU in f32.

A stage-1 checkpoint directory (head stage1) and a stage-2 one (head tmr)
of the port, written by its CheckpointManager from seeded weights, and
their `export-ckpt` `.pth` files. Bit for bit:
- `test` (engines video and clip), `stream` and `serve` with
  `--extractor-ckpt <stage-1 dir>` equal the same commands with
  `--extractor-torch-ckpt <its .pth>`, and differ from the runs whose
  extractor is the model's own trunk and LSTM;
- `serve --ckpt <stage-2 dir>` equals `serve --torch-ckpt <its .pth>`,
  with and without an extractor flag.
Both extractor flags together are an argparse error; a stage-1
checkpoint of another backbone than the config's raises and names the
missing keys.
"""

import json

import numpy as np
import pytest
import torch

from tmrnet_torch import cli
from tmrnet_torch.config import (DataConfig, ExperimentConfig, MemoryConfig,
                                 ModelConfig, TrainConfig)
from tmrnet_torch.config import CHOLEC80_PHASES
from tmrnet_torch.models.tmrnet import build_model, init_state_dict
from tmrnet_torch.train.optim import make_optimizer, slow_modules_for_head
from tmrnet_torch.train.state import TrainState
from tmrnet_torch.utils.checkpoint import CheckpointManager

from tests.test_torch_cli_test import _Capture

torch.set_num_threads(2)

SEQ, HW, CROP, CLASSES = 3, 40, 32, 5
LENGTHS = (9, 6)
MODEL = dict(backbone="tiny", stage_sizes=(1, 1), width=8, hidden_dim=16,
             num_classes=CLASSES, head="tmr", compute_dtype="float32")
PORT_ARGS = ["--device", "cpu"]


def _checkpoint(path, head, seed):
    cfg = ModelConfig(**dict(MODEL, head=head))
    model = build_model(cfg, device="cpu")
    model.load_state_dict(init_state_dict(cfg, seed))
    state = TrainState(model, make_optimizer(TrainConfig(), model,
                                             slow_modules_for_head(head)))
    CheckpointManager(str(path)).save(state, 1, metrics={"epoch": 0},
                                      is_best=True)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("extractor_ckpt")
    cfg = ExperimentConfig(
        data=DataConfig(sequence_length=SEQ, resize=HW, crop_size=CROP,
                        test_crop_type=1, device_normalize=True),
        model=ModelConfig(**MODEL), memory=MemoryConfig(window=4))
    (d / "cfg.json").write_text(cfg.to_json())
    (d / "frames").mkdir()
    (d / "ann").mkdir()
    rng = np.random.default_rng(81)
    for v, n in enumerate(LENGTHS):
        np.save(d / "frames" / f"video{v}.npy",
                rng.integers(0, 256, (n, HW, HW, 3), dtype=np.uint8))
        rows = [f"{25 * k}\t{CHOLEC80_PHASES[(k // 2 + v) % CLASSES]}\n"
                for k in range(n)]
        (d / "ann" / f"video{v}-phase.txt").write_text(
            "Frame\tPhase\n" + "".join(rows))
    _checkpoint(d / "ck1", "stage1", 82)
    _checkpoint(d / "ck2", "tmr", 83)
    c = ["--config", str(d / "cfg.json")]
    with _Capture():
        assert cli.main(["manifest", *c, "--frames", str(d / "frames"),
                         "--annotations", str(d / "ann"), "--out",
                         str(d / "m.pkl")]) == 0
        assert cli.main(["export-ckpt", *c, "--set", "model.head=stage1",
                         "--ckpt", str(d / "ck1"), "--out",
                         str(d / "s1.pth")]) == 0
        assert cli.main(["export-ckpt", *c, "--ckpt", str(d / "ck2"),
                         "--out", str(d / "tmr.pth")]) == 0
    lines = []
    for t in range(6):
        lines.append({"id": "a", "image": f"{d}/frames/video0.npy#{t}"})
        lines.append({"id": "b", "image": f"{d}/frames/video1.npy#{t}"})
        lines.append({"step": True})
    (d / "events.jsonl").write_text("".join(json.dumps(o) + "\n"
                                            for o in lines))
    return d


def _extractor(d, kind):
    return {"ckpt": ["--extractor-ckpt", str(d / "ck1")],
            "pth": ["--extractor-torch-ckpt", str(d / "s1.pth")],
            "own": []}[kind]


def _model(d, kind):
    return {"ckpt": ["--ckpt", str(d / "ck2")],
            "pth": ["--torch-ckpt", str(d / "tmr.pth")]}[kind]


@pytest.mark.parametrize("engine", ["video", "clip"])
def test_test_extractor_ckpt_equals_its_pth(files, tmp_path, engine):
    d = files
    scores = {}
    for kind in ("ckpt", "pth", "own"):
        out = tmp_path / f"{kind}.npz"
        with _Capture():
            assert cli.main(["test", "--config", str(d / "cfg.json"),
                             "--manifest", str(d / "m.pkl"),
                             *_model(d, "ckpt"), *_extractor(d, kind),
                             "--engine", engine, "--out", str(out),
                             *PORT_ARGS]) == 0
        with np.load(out) as z:
            scores[kind] = z["scores"]
    assert scores["ckpt"].shape == (sum(n - SEQ + 1 for n in LENGTHS),
                                    CLASSES)
    np.testing.assert_array_equal(scores["ckpt"], scores["pth"])
    assert not np.array_equal(scores["ckpt"], scores["own"])


def test_stream_extractor_ckpt_equals_its_pth(files, tmp_path):
    d = files
    rows = {}
    for kind in ("ckpt", "pth", "own"):
        out = tmp_path / f"{kind}.jsonl"
        with _Capture():
            assert cli.main(["stream", "--config", str(d / "cfg.json"),
                             "--manifest", str(d / "m.pkl"),
                             *_model(d, "ckpt"), *_extractor(d, kind),
                             "--max-streams", "2", "--out", str(out),
                             *PORT_ARGS]) == 0
        rows[kind] = out.read_text()
    assert rows["ckpt"] == rows["pth"]
    assert sum(json.loads(x)["valid"] for x in rows["ckpt"].splitlines())


def _serve(d, capsys, model, extractor):
    assert cli.main(["serve", "--config", str(d / "cfg.json"), "--input",
                     str(d / "events.jsonl"), *_model(d, model),
                     *_extractor(d, extractor), "--slots", "2", "--probs",
                     *PORT_ARGS]) == 0
    return [json.loads(x) for x in capsys.readouterr().out.splitlines()]


@pytest.mark.parametrize("extractor", ["ckpt", "pth", "own"])
def test_serve_ckpt_equals_its_pth(files, capsys, extractor):
    """serve --ckpt against serve --torch-ckpt, with each extractor."""
    got = _serve(files, capsys, "ckpt", extractor)
    want = _serve(files, capsys, "pth", extractor)
    assert got == want
    assert len(got) == 12 and sum(r["valid"] for r in got) == 8


def test_serve_extractor_ckpt_equals_its_pth(files, capsys):
    rows = {kind: _serve(files, capsys, "ckpt", kind)
            for kind in ("ckpt", "pth", "own")}
    assert rows["ckpt"] == rows["pth"]
    assert [r["probs"] for r in rows["ckpt"] if r["valid"]] != [
        r["probs"] for r in rows["own"] if r["valid"]]


@pytest.mark.parametrize("command", ["test", "stream", "serve"])
def test_both_extractor_flags_are_an_error(files, command):
    d = files
    argv = [command, "--config", str(d / "cfg.json"), "--torch-ckpt",
            str(d / "tmr.pth"), "--extractor-ckpt", str(d / "ck1"),
            "--extractor-torch-ckpt", str(d / "s1.pth"), *PORT_ARGS]
    if command != "serve":
        argv += ["--manifest", str(d / "m.pkl")]
    with pytest.raises(SystemExit) as exc:
        cli.main(argv)
    assert exc.value.code == 2


def test_an_extractor_of_another_backbone_names_its_missing_keys(files):
    """The extractor is built with the config's backbone, as in JAX: the
    tiny stage-1 checkpoint under model.backbone=resnest50 lacks its
    keys."""
    cfg = ExperimentConfig(model=ModelConfig(**dict(
        MODEL, backbone="resnest50")))
    with pytest.raises(KeyError, match="stem_conv1"):
        cli.extractor_state(cfg, {}, extractor_ckpt=str(files / "ck1"))
    got = cli.extractor_state(ExperimentConfig(model=ModelConfig(**MODEL)),
                              {}, extractor_ckpt=str(files / "ck1"))
    assert got and all(k.startswith(("backbone.", "encoder.")) for k in got)
