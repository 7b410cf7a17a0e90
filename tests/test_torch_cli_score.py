"""The scoring workflow through both CLIs on the CPU in f32:

    test | stream -> export -> evaluate,   parity,   export-ckpt

`python -m tmrnet_torch ... --device cpu` against `python -m tmrnet_tpu`
with the same arguments over the same `--config` JSON (written by the JAX
package), reference `.pth` files (written by the port's export) and packed
frames with phase annotations. `stream` over 2 slots for 5 videos (slots
recycled) equals the port's `test --engine video` row for row, and JAX's
`stream` wherever the video engine's two best classes lie more than
2 * 1e-4 apart. `export` of the same `.npz`, `.jsonl` and reference
pickle writes phase trees byte-equal to JAX's; `evaluate` writes the same
JSON file and table as JAX's, with and without `--video-range`,
`--no-quirk`, `--matlab-compat` and a `--preset`; without `--pred-dir`
and `--gt-dir` both use eval.pred_dir and eval.gt_dir. `parity` equals JAX's
(softmax within 1e-4, protocol JSON within 1e-6) on the tiny ResNet and
the tiny ResNeSt, and scores by eval.protocol where --protocol is not
given. `export-ckpt` of a port checkpoint gives JAX's model,
read through JAX's `.pth` import, the port's outputs within 1e-4. Every
preset's fields equal JAX's `get_preset`'s. Also what the commands
refuse."""

import dataclasses
import json
import pickle

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tmrnet_tpu import cli as jax_cli
from tmrnet_tpu.config import (CHOLEC80_PHASES, DataConfig, EvalConfig,
                               ExperimentConfig, MemoryConfig, ModelConfig)
from tmrnet_tpu.config import get_preset as jax_get_preset
from tmrnet_torch import cli
from tmrnet_torch.config import M2CAI_PHASES, PRESETS, get_preset
from tmrnet_torch.config import ModelConfig as PortModelConfig
from tmrnet_torch.models.convert import from_jax_variables, random_variables
from tmrnet_torch.models.torch_import import export_reference_checkpoint

from tests.test_torch_cli_test import _Capture

torch.set_num_threads(2)

SEQ, HW, CROP, CLASSES, WINDOW = 4, 40, 32, 7, 4
LENGTHS = (13, 4, 9, 3, 21)          # 35 clip positions; one video has none
CLIPS = sum(max(0, n - SEQ + 1) for n in LENGTHS)
MODEL = dict(backbone="tiny", stage_sizes=(1, 1), width=8, hidden_dim=16,
             num_classes=CLASSES, head="tmr", compute_dtype="float32")
BACKBONES = ("tiny", "resnest50")
ATOL, JSON_ATOL = 1e-4, 1e-6
JAX_ARGS = ["--set", "mesh.data_parallel=1"]
PORT_ARGS = ["--device", "cpu"]


def _write_pth(path, head, seed, backbone="tiny"):
    state = from_jax_variables(random_variables(
        PortModelConfig(**dict(MODEL, head=head, backbone=backbone)), seed))
    if head == "tmr":           # spread the 7-class softmax
        state = dict(state, **{k: state[k] * 4 for k in ("fc_c.weight",
                                                         "fc_c.bias")})
    torch.save(export_reference_checkpoint(state, head, (1, 1)), path)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The config JSON, the model's and the extractor's `.pth` for each
    backbone, packed 40x40 videos with `<video>-phase.txt` annotations,
    and the manifest."""
    d = tmp_path_factory.mktemp("cli_score")
    cfg = ExperimentConfig(
        data=DataConfig(sequence_length=SEQ, resize=HW, crop_size=CROP,
                        test_crop_type=1, device_normalize=True,
                        batch_clips=8, num_workers=2),
        model=ModelConfig(**MODEL), memory=MemoryConfig(window=WINDOW),
        eval=EvalConfig(batch_clips=8))
    (d / "cfg.json").write_text(cfg.to_json())
    for k, backbone in enumerate(BACKBONES):
        _write_pth(d / f"{backbone}_model.pth", "tmr", 81 + 2 * k, backbone)
        _write_pth(d / f"{backbone}_extractor.pth", "lfb", 82 + 2 * k,
                   backbone)
    (d / "frames").mkdir()
    (d / "ann").mkdir()
    rng = np.random.default_rng(83)
    for v, n in enumerate(LENGTHS):
        np.save(d / "frames" / f"video{v + 1:02d}.npy",
                rng.integers(0, 256, (n, HW, HW, 3), dtype=np.uint8))
        rows = [f"{25 * k}\t{CHOLEC80_PHASES[(k // 3 + v) % CLASSES]}\n"
                for k in range(n)]
        (d / "ann" / f"video{v + 1:02d}-phase.txt").write_text(
            "Frame\tPhase\n" + "".join(rows))
    with _Capture():
        assert cli.main(["manifest", "--config", str(d / "cfg.json"),
                         "--frames", str(d / "frames"), "--annotations",
                         str(d / "ann"), "--out", str(d / "m.pkl")]) == 0
    return d


def _run(main, argv):
    """main(argv) with stdout captured: its lines."""
    with _Capture() as cap:
        assert main(argv) == 0
    return cap.readouterr().out.strip().splitlines()


def _base(files, command, backbone="tiny"):
    return [command, "--config", str(files / "cfg.json"), "--manifest",
            str(files / "m.pkl"), "--torch-ckpt",
            str(files / f"{backbone}_model.pth"), "--extractor-torch-ckpt",
            str(files / f"{backbone}_extractor.pth")]


def _rows(path):
    return [json.loads(line) for line in path.read_text().splitlines()]


@pytest.fixture(scope="module")
def streams(files):
    """The port's `test --engine video`, and `stream --max-streams 2` of
    both packages; the summary lines."""
    out = files / "streams"
    out.mkdir()
    _run(cli.main, _base(files, "test") + [
        "--engine", "video", "--out", str(out / "video.npz"), *PORT_ARGS])
    summaries = {}
    for name, main, extra in (("port", cli.main, PORT_ARGS),
                              ("jax", jax_cli.main, JAX_ARGS)):
        lines = _run(main, _base(files, "stream") + [
            "--max-streams", "2", "--out", str(out / f"{name}.jsonl"),
            *extra])
        summaries[name] = json.loads(lines[-1])
    return out, summaries


def _bank_order(rows):
    """The valid rows' predictions in bank-row order, and the rows before
    each video's first full clip."""
    by_video = {}
    for r in rows:
        by_video.setdefault(r["video"], []).append(r)
    preds, warm = [], []
    for vid in sorted(by_video):
        vrows = sorted(by_video[vid], key=lambda r: r["frame"])
        assert [r["frame"] for r in vrows] == list(range(len(vrows)))
        warm += vrows[:SEQ - 1]
        assert all(r["valid"] for r in vrows[SEQ - 1:])
        preds += [r["pred"] for r in vrows[SEQ - 1:]]
    return np.asarray(preds), warm


def test_stream_equals_the_video_engine(streams):
    out, summaries = streams
    preds, warm = _bank_order(_rows(out / "port.jsonl"))
    assert all(not r["valid"] and r["pred"] is None for r in warm)
    with np.load(out / "video.npz") as z:
        np.testing.assert_array_equal(preds, z["preds"])
    assert len(preds) == CLIPS
    # the slot plan: 2 slots over videos of 13, 4, 9, 3, 21 frames; slot 1
    # takes videos 2, 3 and 5 (4 + 9 + 21 steps)
    summary = summaries["port"]
    assert {k: summary[k] for k in ("streams", "slots", "steps",
                                    "predictions", "out")} == dict(
        streams=len(LENGTHS), slots=2, steps=34, predictions=CLIPS,
        out=str(out / "port.jsonl"))
    with np.load(out / "video.npz") as z:
        labels = cli.clip_labels(cli.load_manifest(str(out.parent / "m.pkl")),
                                 SEQ)
        assert summary["clip_accuracy"] == round(
            float((z["preds"] == labels).mean()), 6)


def test_stream_rows_match_jax(streams):
    out, summaries = streams
    port, jax = _rows(out / "port.jsonl"), _rows(out / "jax.jsonl")
    key = lambda r: (r["video"], r["frame"])
    assert sorted(map(key, port)) == sorted(map(key, jax))
    assert ([r for r in port if not r["valid"]]
            == [r for r in jax if not r["valid"]])
    got, _ = _bank_order(port)
    want, _ = _bank_order(jax)
    with np.load(out / "video.npz") as z:
        top2 = np.sort(z["scores"], axis=-1)[:, -2:]
    decided = top2[:, 1] - top2[:, 0] > 2 * ATOL
    assert decided.sum() >= CLIPS - 2
    np.testing.assert_array_equal(got[decided], want[decided])
    for k in ("streams", "slots", "steps", "predictions"):
        assert summaries["port"][k] == summaries["jax"][k], k


def _tree(root):
    return {p.relative_to(root).as_posix(): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


@pytest.fixture(scope="module")
def exports(files, streams):
    """Both packages' `export` of the video engine's `.npz`, the port's
    stream `.jsonl` and a reference pickle of 0-d tensors."""
    out, _ = streams
    with np.load(out / "video.npz") as z:
        preds = z["preds"]
    with open(out / "ref.pkl", "wb") as f:
        pickle.dump([torch.tensor(int(p)) for p in preds], f)
    inputs = {"npz": out / "video.npz", "jsonl": out / "port.jsonl",
              "pkl": out / "ref.pkl"}
    trees = {}
    for kind, path in inputs.items():
        for name, main in (("port", cli.main), ("jax", jax_cli.main)):
            root = out / f"export_{kind}_{name}"
            lines = _run(main, [
                "export", "--config", str(files / "cfg.json"), "--manifest",
                str(files / "m.pkl"), "--preds", str(path), "--pred-dir",
                str(root / "phase"), "--gt-dir", str(root / "gt-phase")])
            trees[kind, name] = (root, lines)
    return trees


@pytest.mark.parametrize("kind", ["npz", "jsonl", "pkl"])
def test_export_trees_equal_jax(exports, kind):
    (port, port_lines), (jax, jax_lines) = (exports[kind, "port"],
                                            exports[kind, "jax"])
    tree = _tree(port)
    assert tree == _tree(jax) and port_lines == jax_lines
    assert len(tree) == 2 * len(LENGTHS)
    first = tree["phase/video01-phase.txt"].decode().splitlines()
    assert first[:SEQ - 1] == [f"{25 * k}\t0" for k in range(SEQ - 1)]
    assert len(first) == LENGTHS[0]
    # the three inputs carry the same predictions
    assert tree == _tree(exports["npz", "port"][0])


EVALUATE = {
    "fps1": ["--fps", "1"],
    "range": ["--fps", "1", "--video-range", "2", "4"],
    "no_quirk": ["--no-quirk", "--relaxed-seconds", "3"],
    "matlab": ["--matlab-compat", "--fps", "1"],
    "preset": ["--preset", "tmr-resnet50", "--video-range", "1", "5"],
    "videos": ["--videos", "video05", "video02", "--protocol", "m2cai"],
}


@pytest.mark.parametrize("variant", list(EVALUATE))
def test_evaluate_json_equals_jax(exports, tmp_path, variant):
    root = exports["npz", "port"][0]
    args = ["evaluate", "--pred-dir", str(root / "phase"), "--gt-dir",
            str(root / "gt-phase"), *EVALUATE[variant]]
    tables = {}
    for name, main in (("port", cli.main), ("jax", jax_cli.main)):
        tables[name] = _run(main, args + ["--json-out",
                                          str(tmp_path / f"{name}.json")])
    port = (tmp_path / "port.json").read_text()
    assert port == (tmp_path / "jax.json").read_text()
    assert tables["port"] == tables["jax"]
    videos = json.loads(port)["videos"]
    assert videos == {"range": ["video02", "video03", "video04"],
                      "videos": ["video05", "video02"]}.get(
        variant, [f"video{v + 1:02d}" for v in range(len(LENGTHS))])


def test_export_and_evaluate_default_to_the_config_dirs(files, exports,
                                                        tmp_path):
    """Without --pred-dir / --gt-dir, `export` writes and `evaluate` reads
    eval.pred_dir / eval.gt_dir."""
    root = exports["npz", "port"][0]
    dirs = ["--set", f"eval.pred_dir={tmp_path / 'phase'}",
            "--set", f"eval.gt_dir={tmp_path / 'gt-phase'}"]
    _run(cli.main, ["export", "--config", str(files / "cfg.json"),
                    "--manifest", str(files / "m.pkl"), "--preds",
                    str(root.parent / "video.npz"), *dirs])
    assert _tree(tmp_path) == _tree(root)
    for name, argv in (("set", dirs),
                       ("flags", ["--pred-dir", str(root / "phase"),
                                  "--gt-dir", str(root / "gt-phase")])):
        _run(cli.main, ["evaluate", "--fps", "1", *argv, "--json-out",
                        str(tmp_path / f"{name}.json")])
    assert (tmp_path / "set.json").read_text() \
        == (tmp_path / "flags.json").read_text()


def test_evaluate_preset_defaults_to_its_range(exports):
    """A --preset's eval.test_videos (41-80 for tmr-resnet50) selects from
    the gt listing, as JAX's does: none of videos 1-5 falls in it."""
    root = exports["npz", "port"][0]
    for main in (cli.main, jax_cli.main):
        with pytest.raises(SystemExit, match="fall in range"):
            main(["evaluate", "--pred-dir", str(root / "phase"), "--gt-dir",
                  str(root / "gt-phase"), "--preset", "tmr-resnet50"])


@pytest.fixture(scope="module")
def parities(files):
    """`parity` of both packages for each backbone, JSON out."""
    runs = {}
    for backbone in BACKBONES:
        for name, main, extra in (("port", cli.main, PORT_ARGS),
                                  ("jax", jax_cli.main, JAX_ARGS)):
            work = files / f"parity_{backbone}_{name}"
            lines = _run(main, _base(files, "parity", backbone) + [
                "--set", f"model.backbone={backbone}", "--workdir",
                str(work), "--json-out", str(work / "report.json"), *extra])
            runs[backbone, name] = (work, lines)
    return runs


@pytest.mark.parametrize("backbone", BACKBONES)
def test_parity_matches_jax(parities, backbone):
    (port, port_lines), (jax, jax_lines) = (parities[backbone, "port"],
                                            parities[backbone, "jax"])
    with np.load(port / "predictions.npz") as z, \
            np.load(jax / "predictions.npz") as w:
        assert z["scores"].shape == (CLIPS, CLASSES)
        np.testing.assert_allclose(z["scores"], w["scores"], rtol=0,
                                   atol=ATOL)
        np.testing.assert_array_equal(z["rows"], w["rows"])
        top2 = np.sort(w["scores"], axis=-1)[:, -2:]
        decided = top2[:, 1] - top2[:, 0] > 2 * ATOL
        np.testing.assert_array_equal(z["preds"][decided], w["preds"][decided])
        same_preds = np.array_equal(z["preds"], w["preds"])
    got = json.loads((port / "report.json").read_text())
    want = json.loads((jax / "report.json").read_text())
    assert list(got) == list(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=0,
                                   atol=JSON_ATOL, err_msg=key)
    assert _tree(port / "gt-phase") == _tree(jax / "gt-phase")
    if same_preds:
        assert _tree(port / "phase") == _tree(jax / "phase")
        assert port_lines == jax_lines


def test_parity_uses_the_reference_windows(files, parities):
    """parity forces memory.compat_cross_video: its predictions equal the
    port's `test --engine clip` under it, and its JSON `evaluate` on its
    own export."""
    work = parities["tiny", "port"][0]
    out = work / "test_clip.npz"
    _run(cli.main, _base(files, "test") + [
        "--engine", "clip", "--set", "memory.compat_cross_video=true",
        "--lfb", str(work / "lfb.npz"), "--out", str(out), *PORT_ARGS])
    with np.load(out) as z, np.load(work / "predictions.npz") as w:
        np.testing.assert_array_equal(z["scores"], w["scores"])
    _run(cli.main, ["evaluate", "--pred-dir", str(work / "phase"),
                    "--gt-dir", str(work / "gt-phase"), "--json-out",
                    str(work / "evaluate.json")])
    got = json.loads((work / "evaluate.json").read_text())
    report = json.loads((work / "report.json").read_text())
    assert {k: v for k, v in got.items() if k in report} == {
        k: v for k, v in report.items() if k != "clip_accuracy"}


def test_parity_scores_by_the_config_protocol(files, parities):
    """Without --protocol, parity scores by eval.protocol: under m2cai its
    JSON equals `evaluate --protocol m2cai` on its export."""
    work = parities["tiny", "port"][0]
    m2cai = work.parent / "parity_tiny_port_m2cai"
    _run(cli.main, _base(files, "parity") + [
        "--set", "eval.protocol=m2cai", "--lfb", str(work / "lfb.npz"),
        "--load-lfb", "--workdir", str(m2cai), "--json-out",
        str(m2cai / "report.json"), *PORT_ARGS])
    _run(cli.main, ["evaluate", "--pred-dir", str(m2cai / "phase"),
                    "--gt-dir", str(m2cai / "gt-phase"), "--protocol",
                    "m2cai", "--json-out", str(m2cai / "evaluate.json")])
    got = json.loads((m2cai / "evaluate.json").read_text())
    report = json.loads((m2cai / "report.json").read_text())
    assert len(report["jaccard_per_phase"]) == len(M2CAI_PHASES)
    assert {k: v for k, v in got.items() if k in report} == {
        k: v for k, v in report.items() if k != "clip_accuracy"}


def test_export_ckpt_round_trips_through_jax(files, tmp_path):
    """A port checkpoint -> export-ckpt -> JAX's `.pth` import gives JAX's
    model the port's logits; `test --torch-ckpt` on the `.pth` equals
    `test --ckpt` on the checkpoint."""
    from tmrnet_torch.models.tmrnet import build_model
    from tmrnet_torch.train.state import TrainState
    from tmrnet_torch.utils.checkpoint import CheckpointManager

    cfg = PortModelConfig(**MODEL)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(from_jax_variables(random_variables(cfg, 91)))
    state = TrainState(model, torch.optim.SGD(model.parameters(), lr=0.1))
    CheckpointManager(str(tmp_path / "ck")).save(state, 3, {"val_acc": 0.5},
                                                 is_best=True)
    pth = tmp_path / "export.pth"
    lines = _run(cli.main, ["export-ckpt", "--config", str(files / "cfg.json"),
                            "--ckpt", str(tmp_path / "ck"), "--out", str(pth)])
    assert lines[-1].startswith(f"wrote {pth}") and "head=tmr" in lines[-1]

    jcfg = ExperimentConfig.from_json((files / "cfg.json").read_text())
    jmodel, variables = jax_cli._restore_variables(jcfg, "tmr", None,
                                                   str(pth), CROP)
    rng = np.random.default_rng(92)
    clips = rng.standard_normal((3, SEQ, CROP, CROP, 3)).astype(np.float32)
    memory = rng.standard_normal((3, WINDOW, 16)).astype(np.float32)
    want = np.asarray(jmodel.apply(variables, jnp.asarray(clips),
                                   jnp.asarray(memory)))
    with torch.no_grad():
        got = model(torch.from_numpy(clips), torch.from_numpy(memory)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)

    outs = {}
    for name, weights in (("pth", ["--torch-ckpt", str(pth)]),
                          ("ckpt", ["--ckpt", str(tmp_path / "ck")])):
        outs[name] = tmp_path / f"{name}.npz"
        _run(cli.main, ["test", "--config", str(files / "cfg.json"),
                        "--manifest", str(files / "m.pkl"), *weights,
                        "--engine", "video", "--out", str(outs[name]),
                        *PORT_ARGS])
    with np.load(outs["pth"]) as z, np.load(outs["ckpt"]) as w:
        np.testing.assert_array_equal(z["scores"], w["scores"])


def _fields(cfg):
    return {(section.name, f.name): getattr(getattr(cfg, section.name),
                                            f.name)
            for section in dataclasses.fields(cfg)
            if dataclasses.is_dataclass(getattr(cfg, section.name))
            for f in dataclasses.fields(getattr(cfg, section.name))}


@pytest.mark.parametrize("name", sorted(PRESETS))
def test_presets_equal_jax(name, tmp_path):
    port, jax = get_preset(name), jax_get_preset(name)
    assert jax.name == name and not hasattr(port, "name")
    fields, jax_fields = _fields(port), _fields(jax)
    assert fields and all(k in jax_fields for k in fields)
    assert {k: v for k, v in fields.items()} == {
        k: jax_fields[k] for k in fields}
    # --preset, then --set; --config wins over --preset
    args = cli.build_parser().parse_args(
        ["evaluate", "--pred-dir", "p", "--gt-dir", "g", "--preset", name,
         "--set", "eval.relaxed_seconds=3"])
    cfg = cli.load_config(args)
    assert cfg.eval.relaxed_seconds == 3
    assert cfg.replace(eval=port.eval) == port
    (tmp_path / "c.json").write_text(jax.to_json())
    args.config, args.set = str(tmp_path / "c.json"), []
    assert cli.load_config(args) == port
    args.config = None
    assert cli.load_config(args) == port


def test_m2cai_preset_scores_eight_phases():
    cfg = get_preset("tmr-resnet50-m2cai")
    assert (cfg.model.num_classes, cfg.eval.protocol, cfg.eval.test_videos,
            len(cfg.data.phase_names)) == (8, "m2cai", (1, 14), 8)


def test_scoring_commands_refuse(files, streams, tmp_path, monkeypatch):
    stream = _base(files, "stream") + ["--out", str(tmp_path / "s.jsonl")]
    # stream --artifact takes the model from the artifact: beside
    # --torch-ckpt an argparse error; a file that does not load exits and
    # names `doctor --artifact`
    with pytest.raises(SystemExit) as exc:
        cli.main(stream + ["--artifact", "a.tmrx"])
    assert exc.value.code == 2
    artifact_only = [a for a in stream if a not in (
        "--torch-ckpt", str(files / "tiny_model.pth"),
        "--extractor-torch-ckpt", str(files / "tiny_extractor.pth"))]
    (tmp_path / "a.tmrx").write_bytes(b"not an artifact")
    with pytest.raises(SystemExit, match="doctor --artifact"):
        cli.main(artifact_only + ["--artifact", str(tmp_path / "a.tmrx"),
                                  *PORT_ARGS])
    # mesh.multihost streams as rank 0 of a one-process group: from --set
    # with an explicit rendezvous, and from a JAX config JSON under
    # torchrun's environment (env://); the rows, grouped by video, equal
    # the plain run's per video, and the group is left when it ends
    from tests.test_torch_multiprocess_train import free_port

    jax_mesh = tmp_path / "mesh.json"
    cfg = json.loads((files / "cfg.json").read_text())
    cfg["mesh"]["multihost"] = True
    jax_mesh.write_text(json.dumps(cfg))
    by_video = lambda rows: {v: sorted((r["frame"], r["pred"], r["valid"])
                                       for r in rows if r["video"] == v)
                             for v in {r["video"] for r in rows}}
    want = by_video(_rows(streams[0] / "port.jsonl"))
    one = ["--max-streams", "2", *PORT_ARGS]
    rendezvous = ["--set", "mesh.multihost=true", "--set",
                  f"mesh.coordinator=127.0.0.1:{free_port()}", "--set",
                  "mesh.num_processes=1", "--set", "mesh.process_id=0"]
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", str(free_port()))
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    for name, argv in (
            ("set", _base(files, "stream") + rendezvous),
            ("env", ["stream", "--config", str(jax_mesh)]
             + _base(files, "stream")[3:])):
        out = tmp_path / f"mh_{name}.jsonl"
        lines = _run(cli.main, argv + one + ["--out", str(out)])
        assert json.loads(lines[-1])["processes"] == 1
        rows = _rows(out)
        assert [(r["video"], r["frame"]) for r in rows] == sorted(
            (r["video"], r["frame"]) for r in rows)
        assert by_video(rows) == want
        assert not torch.distributed.is_initialized()
    with pytest.raises(SystemExit, match="deterministic frame-wise"):
        cli.main(stream + ["--set", "data.test_crop_type=5", *PORT_ARGS])
    # export and evaluate take no --device; the others default to the card
    for argv in (["export", "--manifest", "m.pkl", "--preds", "p.npz"],
                 ["evaluate", "--pred-dir", "p", "--gt-dir", "g"],
                 ["export-ckpt", "--ckpt", "c", "--out", "o.pth"]):
        with pytest.raises(SystemExit) as exc:
            cli.main(argv + ["--device", "cpu"])
        assert exc.value.code == 2
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (stream, _base(files, "parity") + ["--workdir",
                                                   str(tmp_path / "w")]):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cli.main(argv)
    assert not (tmp_path / "s.jsonl").exists()
    assert not (tmp_path / "w").exists()
    # a prediction count the manifest does not give
    np.savez(tmp_path / "short.npz", preds=np.zeros(CLIPS - 1, np.int64))
    with pytest.raises(ValueError, match="count mismatch"):
        cli.main(["export", "--config", str(files / "cfg.json"), "--manifest",
                  str(files / "m.pkl"), "--preds", str(tmp_path / "short.npz"),
                  "--pred-dir", str(tmp_path / "p")])
