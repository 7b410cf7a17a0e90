"""What the learning-efficacy study adds on the card, on the CPU: the
reference's recipe where cv2 imports and crop and flip alone where it does
not (`card_sets`, `recipe`), BN folded on `test` / `build-lfb` on the card
in both dtypes (`folded_sets`), the scale check that lets ResNet-50 run in either
dtype and refuses the tiny model, the first JSON line that names all of
it; and `experimental/efficacy_grid.py`'s arms, rows and merge. The
commands themselves are stubbed: the card's runs go through the chip."""

import json
import sys
import types

import pytest

from tmrnet_torch import device as port_device
from tmrnet_torch.experimental import efficacy_grid as grid
from tmrnet_torch.experimental import efficacy_study as study


@pytest.fixture(params=["cv2", "no_cv2"])
def cv2(request, monkeypatch):
    """cv2 importable (a stand-in module) or made absent."""
    present = request.param == "cv2"
    monkeypatch.setitem(sys.modules, "cv2",
                        types.ModuleType("cv2") if present else None)
    return present


def test_card_sets_follow_cv2(cv2):
    assert study.have_cv2() is cv2
    assert study.card_sets("cuda") == (() if cv2 else
                                       ("data.use_flip=false",))
    assert study.card_sets("cuda:1") == study.card_sets("cuda")
    assert study.recipe("cuda") == ("reference" if cv2 else "crop_and_flip")
    assert study.card_sets("cpu") == () and study.recipe("cpu") == "reference"


@pytest.mark.parametrize("dtype,folded", [("bfloat16", True),
                                          ("float32", True)])
def test_folded_sets_fold_bf16_only(dtype, folded):
    # the card folds whichever dtype the study runs in (an f32 trunk runs
    # the f32 bottleneck kernels); the CPU in neither
    scale = {**study.FULL_SCALE,
             "extra_sets": (f"model.compute_dtype={dtype}",)}
    assert study.scale_dtype(scale) == dtype
    assert study.folded_sets("cuda") == (
        ["--set", "model.folded=true"] if folded else [])
    assert study.folded_sets("cpu") == []


def test_the_last_set_wins():
    argv = ["--set", "model.compute_dtype=bfloat16", "--set", "x=1",
            "--set", "model.compute_dtype=float32"]
    assert study.set_value(argv, "model.compute_dtype", "x") == "float32"
    assert study.set_value(["--set", "x=1"], "model.compute_dtype",
                           "bfloat16") == "bfloat16"
    assert study.set_value(argv, "x", "0") == "1"
    scale = {**study.FULL_SCALE,
             "extra_sets": ("model.compute_dtype=float32",)}
    assert study.scale_dtype(study.FULL_SCALE) == "bfloat16"
    assert study.scale_dtype(scale) == "float32"
    assert study.scale_dtype({}) == "float32"


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_check_scale_on_the_card(dtype, monkeypatch):
    seen = []
    monkeypatch.setattr(port_device, "resolve_device", seen.append)
    full = {**study.FULL_SCALE,
            "extra_sets": (f"model.compute_dtype={dtype}",)}
    study.check_scale(full, "cuda")
    assert seen == ["cuda"]
    with pytest.raises(SystemExit, match=f"tiny model in {dtype} runs on the "
                                         f"CPU only"):
        study.check_scale({"compute_dtype": dtype}, "cuda")
    study.check_scale({"compute_dtype": dtype}, "cpu")
    assert seen == ["cuda", "cpu"]


class _Commands:
    """A stand-in for the CLI: records each command line and answers what
    the study reads back (the test's clip accuracy, the protocol table)."""

    def __init__(self):
        self.argv = []

    def __call__(self, argv, device="cuda", clock=None):
        argv = [str(a) for a in argv]
        self.argv.append(argv)
        if argv[0] == "test":
            return json.dumps({"clip_accuracy": 0.5})
        if argv[0] == "evaluate":
            out = argv[argv.index("--json-out") + 1]
            with open(out, "w") as f:
                json.dump({"mean_accuracy": 50.0, "mean_jaccard": 40.0}, f)
        return ""

    def folded(self, name):
        return ["model.folded=true" in a for a in self.argv if a[0] == name]


@pytest.mark.parametrize("sets,stage2,want_s1,want_s2", [
    ((), (), True, True),                                    # bf16
    (("model.compute_dtype=float32",), (), True, True),      # f32 throughout
    ((), ("model.compute_dtype=float32",), True, True),      # f32 head only
])
def test_study_folds_the_bf16_commands_only(tmp_path, monkeypatch, sets,
                                            stage2, want_s1, want_s2):
    cmds = _Commands()
    monkeypatch.setattr(study, "run_cli", cmds)
    monkeypatch.setattr(port_device, "resolve_device", lambda d: d)
    scale = {**study.FULL_SCALE, "extra_sets": sets}
    rows = study.run_study(str(tmp_path), heads=("tmr",), scale=scale,
                           stage2_sets=stage2, device="cuda")
    assert [r["arm"] for r in rows] == ["stage1", "tmr"]
    assert cmds.folded("build-lfb") == [want_s1, want_s1]
    assert cmds.folded("test") == [want_s1, want_s2]
    # the trainers never fold
    assert not any(cmds.folded("train-bank") + cmds.folded("train-tmr"))


@pytest.mark.parametrize("extra,dtype,flip_set", [
    ([], "bfloat16", False),
    (["--set", "model.compute_dtype=float32"], "float32", False),
    (["--set", "data.use_flip=false"], "bfloat16", True)])
def test_first_line_names_the_recipe(tmp_path, monkeypatch, capsys, cv2,
                                     extra, dtype, flip_set):
    monkeypatch.setattr(study, "run_study", lambda *a, **k: [
        {"arm": "stage1", "seed": 0, "clip_accuracy": 0.5}])
    assert study.main(["--work", str(tmp_path), "--seeds", "0",
                       "--full-scale", *extra]) == 0
    head = json.loads(capsys.readouterr().out.splitlines()[0])["study"]
    assert head["compute_dtype"] == dtype
    assert head["folded_on"] == ["test", "build-lfb"]
    assert head["recipe"] == ("reference" if cv2 else "crop_and_flip")
    assert head["use_flip"] is (cv2 and not flip_set)


@pytest.mark.parametrize("arm", sorted(grid.ARMS))
def test_grid_arms_are_the_studys_command_lines(arm, tmp_path, monkeypatch):
    """Every arm parses as the study's command line, full scale, both
    heads, with its own recipe."""
    seen = {}

    def fake_run_study(work, seed, **kw):
        seen.update(kw, seed=seed)
        return [{"arm": "stage1", "seed": seed, "clip_accuracy": 0.5,
                 "pair_accuracy": 0.5}]

    monkeypatch.setattr(study, "run_study", fake_run_study)
    study.main(["--work", str(tmp_path), "--seeds", "1", *grid.ARMS[arm]])
    assert seen["heads"] == ("tmr", "nl_only") and seen["seed"] == 1
    assert seen["scale"]["backbone"] == "resnet50"
    assert seen["task"] == ("multiscale" if arm.startswith("M") else "pairs")
    assert seen["epochs2"] == {"P5": 8, "M1": 10, "M2": 10}.get(arm, 4)
    sets = seen["scale"]["extra_sets"]
    assert "train.grad_clip=5.0" in sets
    assert ("model.compute_dtype=float32" in sets) is (arm == "P2")
    assert ("data.use_flip=false" in sets) is (arm == "P3")
    assert (seen["stage2_sets"] == ("train.optimizer=adam",)) is (
        arm in ("P4", "M1"))


def _log(path, recipe, dtype, flip, rows):
    lines = [{"study": {"recipe": recipe, "compute_dtype": dtype,
                        "use_flip": flip}}, *rows,
             {"seed": 2, "seconds": {"train-bank": 100.0, "test": 5.5}}]
    path.write_text("".join(json.dumps(x) + "\n" for x in lines)
                    + "stage1   clip_acc mean=0.5\n")


def test_grid_rows_and_merge(tmp_path):
    where = {"card": "NVIDIA H100 80GB HBM3", "power_limit": "700.00 W"}
    log = tmp_path / "P3-s2.log"
    _log(log, "reference", "bfloat16", False,
         [{"arm": "stage1", "seed": 2, "clip_accuracy": 0.7},
          {"arm": "tmr", "seed": 2, "clip_accuracy": 0.9}])
    rows = grid.seed_rows("P3", 2, str(log), where)
    assert [r["arm"] for r in rows] == ["stage1", "tmr"]
    assert rows[1] == {"arm": "tmr", "seed": 2, "clip_accuracy": 0.9,
                       "recipe": "P3", "augment": "reference",
                       "use_flip": False, "compute_dtype": "bfloat16",
                       "task": "pairs", "seconds": 105.5, **where}
    out = tmp_path / "out"
    out.mkdir()
    (out / "P3.json").write_text(json.dumps(rows))
    (out / "P1.json").write_text(json.dumps([{**rows[0], "recipe": "P1"}]))
    (out / "notes.json").write_text("[]")
    into = tmp_path / "all.json"
    merged = grid.collect(str(out), str(into))
    assert [(r["recipe"], r["arm"]) for r in merged] == [
        ("P1", "stage1"), ("P3", "stage1"), ("P3", "tmr")]
    # a second collect of a rerun replaces that arm and seed's rows
    (out / "P3.json").write_text(json.dumps(rows[:1]))
    (out / "P1.json").unlink()
    merged = grid.collect(str(out), str(into))
    assert [(r["recipe"], r["arm"]) for r in merged] == [
        ("P1", "stage1"), ("P3", "stage1")]
    assert json.loads(into.read_text()) == merged
