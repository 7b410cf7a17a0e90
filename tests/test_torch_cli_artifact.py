"""`python -m tmrnet_torch export-model | stream --artifact | serve
--artifact | doctor` on the CPU (`--device cpu`).

`export-model --stream` from reference-format `.pth` files, then `stream
--artifact` over packed tiny videos and `serve --artifact` over a protocol
file: their rows equal the same commands run with `--torch-ckpt` on the
same weights (the artifact holds the engine's ops in the engine's order,
so the predictions are equal and the probabilities within 1e-6). Also the
clip export's summary line and sidecar, what the artifact flags refuse,
and `doctor`'s lines and exit code.

Tiny widths: a ResNet of stage sizes (2, 1) and width 8 (stage 1's second
block is an identity block, which the folded model,
`--set model.folded=true`, sends to `fused_bottleneck`), hidden 16, window
4, 4-frame clips of 32x32 cropped from 40x40 frames."""

import contextlib
import io
import json
import os
import pickle

import numpy as np
import pytest
import torch

from tmrnet_torch import cli
from tmrnet_torch.config import (CHOLEC80_PHASES, DataConfig, EvalConfig,
                                 ExperimentConfig, MemoryConfig, ModelConfig)
from tmrnet_torch.data.manifests import load_pickle_manifest, save_pickle_manifest
from tmrnet_torch.eval.saved import load_artifact
from tmrnet_torch.memory.lfb import FeatureBank, save_bank
from tmrnet_torch.models.convert import from_jax_variables, random_variables
from tmrnet_torch.models.torch_import import export_reference_checkpoint

torch.set_num_threads(2)

PROB_TOL = 1e-6
SEQ, HW, CROP, CLASSES, WINDOW, SLOTS = 4, 40, 32, 5, 4, 2
LENGTHS = (9, 3, 7)
MODEL = dict(backbone="resnet50", stage_sizes=(2, 1), width=8, hidden_dim=16,
             num_classes=CLASSES, head="tmr", compute_dtype="float32")
CPU = ["--device", "cpu"]
FOLDED = ["--set", "model.folded=true"]


def _main(argv):
    """cli.main(argv) with stdout captured: (its exit code, its lines)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    return rc, buf.getvalue().splitlines()


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The config, the model's and the extractor's `.pth`, packed videos
    with annotations and their manifest, a stream artifact exported from
    the `.pth` files and the export's summary line."""
    d = tmp_path_factory.mktemp("cli_artifact")
    cfg = ExperimentConfig(
        data=DataConfig(sequence_length=SEQ, resize=HW, crop_size=CROP,
                        test_crop_type=1, device_normalize=True),
        model=ModelConfig(**MODEL), memory=MemoryConfig(window=WINDOW),
        eval=EvalConfig(batch_clips=3))
    (d / "cfg.json").write_text(cfg.to_json())
    for name, head, seed in (("model", "tmr", 51), ("extractor", "lfb", 52)):
        state = from_jax_variables(random_variables(
            ModelConfig(**dict(MODEL, head=head)), seed))
        if head == "tmr":       # spread the softmax
            state = dict(state, **{k: state[k] * 4 for k in ("fc_c.weight",
                                                             "fc_c.bias")})
        torch.save(export_reference_checkpoint(state, head, (2, 1)),
                   d / f"{name}.pth")
    (d / "frames").mkdir()
    (d / "ann").mkdir()
    rng = np.random.default_rng(53)
    for v, n in enumerate(LENGTHS):
        np.save(d / "frames" / f"video{v + 1:02d}.npy",
                rng.integers(0, 256, (n, HW, HW, 3), dtype=np.uint8))
        rows = [f"{25 * k}\t{CHOLEC80_PHASES[(k // 2 + v) % CLASSES]}\n"
                for k in range(n)]
        (d / "ann" / f"video{v + 1:02d}-phase.txt").write_text(
            "Frame\tPhase\n" + "".join(rows))
    assert _main(["manifest", "--config", str(d / "cfg.json"), "--frames",
                  str(d / "frames"), "--annotations", str(d / "ann"),
                  "--out", str(d / "m.pkl")])[0] == 0
    rc, lines = _main(["export-model", *_weights(d), "--stream", "--slots",
                       str(SLOTS), "--out", str(d / "stream.pt2"), *FOLDED,
                       *CPU])
    assert rc == 0
    return d, json.loads(lines[-1])


def _weights(d):
    return ["--config", str(d / "cfg.json"), "--torch-ckpt",
            str(d / "model.pth"), "--extractor-torch-ckpt",
            str(d / "extractor.pth")]


def _rows(path):
    return [json.loads(line) for line in path.read_text().splitlines()]


def test_export_model_stream_summary(files):
    d, line = files
    assert line["out"] == str(d / "stream.pt2")
    assert line["bytes"] == os.path.getsize(d / "stream.pt2") > 0
    assert (line["head"], line["kind"], line["batch"], line["device"]) == (
        "tmr", "stream", SLOTS, "cpu")
    assert line["inputs"][4] == {"shape": [SLOTS, CROP, CROP, 3],
                                 "dtype": "uint8"}
    side = json.loads((d / "stream.pt2.json").read_text())
    assert side["config"]["model"]["folded"] is True
    assert (side["kind"], side["slots"], side["seq"], side["window"]) == (
        "stream", SLOTS, SEQ, WINDOW)


def test_stream_artifact_rows_equal_torch_ckpt(files):
    d, _ = files
    out = {}
    for name, extra in (("artifact", ["--artifact", str(d / "stream.pt2")]),
                        ("ckpt", _weights(d)[2:] + FOLDED
                         + ["--max-streams", str(SLOTS)])):
        rc, lines = _main(["stream", "--config", str(d / "cfg.json"),
                           "--manifest", str(d / "m.pkl"), *extra, "--out",
                           str(d / f"{name}.jsonl"), *CPU])
        assert rc == 0
        out[name] = (_rows(d / f"{name}.jsonl"), json.loads(lines[-1]))
    rows, summary = out["artifact"]
    assert rows == out["ckpt"][0]
    assert {k: v for k, v in summary.items() if k != "out"} == {
        k: v for k, v in out["ckpt"][1].items() if k != "out"}
    assert summary["slots"] == SLOTS
    assert sum(r["valid"] for r in rows) == sum(n - SEQ + 1 for n in LENGTHS
                                               if n >= SEQ)


def _events(d):
    """Two streams join, one ends and a third takes its slot."""
    lines = []
    for t in range(6):
        lines.append({"id": "or-1", "image": f"{d}/frames/video01.npy#{t}"})
        if t < 4:
            lines.append({"id": "or-2",
                          "image": f"{d}/frames/video03.npy#{t}"})
        if t == 4:
            lines.append({"id": "or-2", "end": True})
            lines.append({"id": "or-3", "image": f"{d}/frames/video03.npy#6"})
        if t == 5:
            lines.append({"id": "or-3", "image": f"{d}/frames/video03.npy#5"})
        lines.append({"step": True})
    path = d / "events.jsonl"
    path.write_text("".join(json.dumps(o) + "\n" for o in lines))
    return str(path)


def test_serve_artifact_rows_equal_torch_ckpt(files, capsys):
    d, _ = files
    events = _events(d)
    got = {}
    for name, extra in (("artifact", ["--artifact", str(d / "stream.pt2"),
                                      "--slots", "5"]),
                        ("ckpt", _weights(d)[2:] + FOLDED
                         + ["--slots", str(SLOTS)])):
        assert cli.main(["serve", "--config", str(d / "cfg.json"), *extra,
                         "--input", events, "--probs", *CPU]) == 0
        cap = capsys.readouterr()
        got[name] = ([json.loads(x) for x in cap.out.splitlines()],
                     [json.loads(x) for x in cap.err.splitlines()])
    rows, err = got["artifact"]
    want, _ = got["ckpt"]
    assert len(rows) == len(want) > 0
    for a, b in zip(rows, want):
        pa, pb = a.pop("probs", None), b.pop("probs", None)
        assert a == b
        if pb is not None:
            assert np.abs(np.subtract(pa, pb)).max() <= PROB_TOL
    assert sum(1 for r in rows if r.get("pred") is not None) >= 3
    assert err[0] == {"note": f"--slots 5 ignored: the artifact was "
                              f"exported with {SLOTS} slots"}
    assert {"ready": True} in err and "summary" in err[-1]


def test_export_model_clip_and_fold_bn(files, tmp_path):
    d, _ = files
    for name, extra in (("plain", []), ("folded", ["--fold-bn"])):
        out = tmp_path / f"{name}.pt2"
        rc, lines = _main(["export-model", *_weights(d)[:4], "--out",
                           str(out), *extra, *CPU])
        assert rc == 0
        line = json.loads(lines[-1])
        assert (line["kind"], line["batch"], line["head"]) == ("clip", 3, "tmr")
        assert line["inputs"] == [
            {"shape": [3, SEQ, CROP, CROP, 3], "dtype": "uint8"},
            {"shape": [3, WINDOW, 16], "dtype": "float32"}]
        art = load_artifact(str(out))
        assert art.meta["config"]["model"]["folded"] is (name == "folded")
        targets = {str(n.target) for n in art.program.graph.nodes}
        assert ("tmrnet.fused_bottleneck.default" in targets) is (
            name == "folded")
        assert {"tmrnet.time_conv.default",
                "tmrnet.nl_attention.default"} <= targets
    rng = np.random.default_rng(54)
    clips = rng.integers(0, 256, (3, SEQ, CROP, CROP, 3), dtype=np.uint8)
    memory = rng.standard_normal((3, WINDOW, 16)).astype(np.float32)
    plain, folded = (load_artifact(str(tmp_path / f"{n}.pt2"))(clips, memory)
                     for n in ("plain", "folded"))
    np.testing.assert_allclose(folded[1].numpy(), plain[1].numpy(),
                               rtol=2e-5, atol=2e-5)     # f32 folding rounds


def test_artifact_commands_refuse(files, tmp_path):
    d, _ = files
    export = ["export-model", *_weights(d), "--out", str(tmp_path / "x.pt2"),
              *CPU]
    with pytest.raises(SystemExit, match="model.folded=true"):
        cli.main(export + ["--stream", "--fold-bn"])
    with pytest.raises(SystemExit, match="memory head"):
        cli.main(export + ["--stream", "--set", "model.head=stage1"])
    stream = ["stream", "--config", str(d / "cfg.json"), "--manifest",
              str(d / "m.pkl"), "--out", str(tmp_path / "s.jsonl"), *CPU]
    junk = tmp_path / "junk.pt2"
    junk.write_bytes(b"not an artifact")
    with pytest.raises(SystemExit, match="doctor --artifact"):
        cli.main(stream + ["--artifact", str(junk)])
    with pytest.raises(SystemExit, match="extractor"):
        cli.main(stream + ["--artifact", str(d / "stream.pt2"),
                           "--extractor-torch-ckpt", str(d / "extractor.pth")])
    with pytest.raises(SystemExit, match="mesh.multihost"):
        cli.main(stream + ["--artifact", str(d / "stream.pt2"), "--set",
                           "mesh.multihost=true"])
    # --artifact excludes --ckpt and --torch-ckpt: an argparse error
    with pytest.raises(SystemExit) as exc:
        cli.main(stream + ["--artifact", str(d / "stream.pt2"),
                           "--torch-ckpt", str(d / "model.pth")])
    assert exc.value.code == 2
    assert _main(["export-model", *_weights(d)[:4], "--batch", "2", "--out",
                  str(tmp_path / "clip.pt2"), *CPU])[0] == 0
    with pytest.raises(ValueError, match="not a stream artifact"):
        cli.main(["serve", "--artifact", str(tmp_path / "clip.pt2"),
                  "--input", str(tmp_path / "none.jsonl"), *CPU])


def _doctor(argv):
    rc, lines = _main(["doctor", *argv, *CPU])
    checks = {}
    for line in lines[:-1]:
        status, rest = line[1:].split("] ", 1)
        checks.setdefault(rest.split(":", 1)[0], []).append(status.strip())
    return rc, checks, lines


def test_doctor_lines_and_exit_code(files, tmp_path):
    d, _ = files
    bank = FeatureBank.create(SEQ, LENGTHS, 16, device="cpu")
    save_bank(str(tmp_path / "bank.npz"), bank)
    (tmp_path / "ck").mkdir()
    rc, checks, lines = _doctor([
        "--config", str(d / "cfg.json"), "--manifest", str(d / "m.pkl"),
        "--lfb", str(tmp_path / "bank.npz"), "--artifact",
        str(d / "stream.pt2"), "--checkpoint", str(tmp_path / "ck"),
        "--mesh", "--smoke"])
    assert rc == 0, lines
    for name in ("versions", "devices", "native", "manifest", "lfb",
                 "artifact", "mesh"):
        assert checks[name] == ["ok"], (name, lines)
    assert checks["checkpoint"] == ["warn"]       # a directory with no step
    assert checks["smoke"] == ["ok"] * 4          # the four ops on the CPU
    assert any("kind=stream slots=2" in x for x in lines)
    assert lines[-1].startswith("doctor: ") and lines[-1].endswith(" 0 fail")

    # a packed index past its pack: FAIL, exit 1
    m, _ = load_pickle_manifest(str(d / "m.pkl"))
    video = m.videos[0]
    video.frame_paths[-1] = video.frame_paths[-1].rpartition("#")[0] + "#99"
    save_pickle_manifest(str(tmp_path / "bad.pkl"), m)
    rc, checks, lines = _doctor(["--manifest", str(tmp_path / "bad.pkl")])
    assert rc == 1 and checks["manifest"] == ["FAIL"]
    assert "frame 99 >= 9" in "\n".join(lines)

    # an artifact without its sidecar: warn, exit 0; a junk file: FAIL
    (tmp_path / "bare.pt2").write_bytes((d / "stream.pt2").read_bytes())
    rc, checks, lines = _doctor(["--artifact", str(tmp_path / "bare.pt2")])
    assert rc == 0 and checks["artifact"] == ["warn"]
    assert "sidecar" in "\n".join(lines)
    (tmp_path / "junk.pt2").write_bytes(pickle.dumps("not an artifact"))
    rc, checks, _ = _doctor(["--artifact", str(tmp_path / "junk.pt2"),
                             "--checkpoint", str(tmp_path / "none")])
    assert rc == 1
    assert checks["artifact"] == ["FAIL"] and checks["checkpoint"] == ["FAIL"]


@pytest.mark.parametrize("command", ["stream", "serve"])
def test_f32_artifact_turns_tf32_off_on_a_card(files, command, monkeypatch):
    # An f32 stream artifact on a (faked) card under a bf16 command line:
    # the artifact's dtype sets the precision, so cuDNN and cuBLAS run f32
    # with TF32 off, as the engine it was exported from did.
    from tmrnet_torch import device
    from tmrnet_torch.eval import saved

    d, _ = files
    card = torch.device("cuda", 0)

    class ReachedTheStep(Exception):
        pass

    class CardEngine:
        def __init__(self, artifact):
            self.meta, self.device = artifact.meta, card
            self.slots = int(artifact.meta["slots"])

        def init_state(self, num_streams):
            raise ReachedTheStep(num_streams)

    monkeypatch.setattr(device, "resolve_device", lambda d: card)
    monkeypatch.setattr(saved, "ArtifactStreamEngine", CardEngine)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    assert json.loads((d / "stream.pt2.json").read_text())[
        "compute_dtype"] == "float32"
    argv = [command, "--config", str(d / "cfg.json"), "--set",
            "model.compute_dtype=bfloat16", "--artifact",
            str(d / "stream.pt2")]
    argv += (["--manifest", str(d / "m.pkl"), "--out", str(d / "x.jsonl")]
             if command == "stream" else ["--input", _events(d)])
    with pytest.raises(ReachedTheStep):
        cli.main(argv)
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32
