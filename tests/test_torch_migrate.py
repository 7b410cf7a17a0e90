"""The port's reference-command translator (`tmrnet_torch/migrate.py`)
against JAX's (`tmrnet_tpu/migrate.py`) on every case of
`tests/test_migrate.py`: the same commands and notes, but for the program
name and the differences the port's module names (the -g/--gpu note, no
`data.num_classes` on the 6-class driver, placeholder weights where the
port's `build-lfb` and `test` need them); every emitted command parses
through the port's parser with resolvable `--set` keys; the port's `test`
scores 6 classes from `model.num_classes=6` alone; and `main(["migrate",
...])` in both forms, with its refusals."""

import shlex

import numpy as np
import pytest
import torch

from tmrnet_tpu.migrate import MigrateError as JaxMigrateError
from tmrnet_tpu.migrate import translate as jax_translate
from tmrnet_torch import cli
from tmrnet_torch.config import ExperimentConfig, apply_override
from tmrnet_torch.migrate import (MODEL_PTH, STAGE1_CKPT, MigrateError,
                                  translate)

torch.set_num_threads(2)

SIX = ("test_singlenet_phase_non-local_pretrained_2fc_copy_mutiConv6_3.py")
# Every reference command of tests/test_migrate.py (:30-184).
CASES = [
    "python train_singlenet_phase_1fc.py -t 100 -v 40 -e 25 -w 8 -f 0 -c 1 "
    "-l 5e-4 -o 1 --sgdadjust 0 --sgdstep 3 --sgdgamma 0.5",
    "python 'Training TMRNet/train_non-local_mutiConv_resnet.py' -t 90 "
    "--LFB_l 30 --multi 0 --model_path ./LFB/FBmodel/x.pth --load_LFB False",
    "python train_non-local_mutiConv_resnest.py --LFB_l 40",
    "python train_only_non-local_pretrained.py --LFB_l 40",
    "python train_memorybank.py --csv_train tr.csv --csv_valid va.csv "
    "--train_bs 100 --num_frames 10 --epochs 5 --lr 1e-3",
    "python test_singlenet_phase_non-local_pretrained_2fc_copy.py -n "
    "model.pth -t 1600 -c 3 --LFB_l 30",
    f"python {SIX} --csv test.csv --model m.pth --lfb_model lfb.pth",
    "python test_singlenet_phase_non-local_pretrained_2fc_copy_mutiConv6"
    "_resnest.py -n r.pth",
    "python export_phase_copy.py -n preds.pkl",
    "python update_get_paths_labels.py --data /d --test_label t.pkl",
    "python get_paths_labels.py",
    "python meanStd.py",
    "python video2frame_cutmargin.py",
    "octave Main.m",
    "octave Main_m2cai.m",
    "python export_phase_copy.py -n p.pkl",
    "python test-resnet.py --mount_point /videos -t 90",
    "python test-new-ds.py --mount_point /v",
    "python train_singlenet_phase_1fc.py --mystery 7",
    "python train_singlenet_phase_1fc.py -g True --nesterov False",
    "python train_non-local_mutiConv_resnet.py -t 90",
    # the cases above with the weights the port needs missing
    "python test_singlenet_phase_non-local_pretrained_2fc_copy.py -t 160",
    f"python {SIX} --csv test.csv",
]
JAX_GPU_NOTE = ("-g/--gpu has no equivalent (devices are auto-detected; a "
                "multi-chip mesh comes from mesh.data_parallel) — dropped")
PORT_GPU_NOTE = ("-g/--gpu has no equivalent (the port runs on the card "
                 "unless --device cpu; one process a card comes from "
                 "mesh.multihost) — dropped")
WEIGHTS = {"build-lfb": ("--ckpt", STAGE1_CKPT),
           "test": ("--torch-ckpt", MODEL_PTH)}


def _validate(cmd: str):
    """Parse a port command through the port's parser and resolve its
    --set keys against the port's config."""
    tokens = shlex.split(cmd)
    assert tokens[:3] == ["python", "-m", "tmrnet_torch"], cmd
    args = cli.build_parser().parse_args(tokens[3:])
    if getattr(args, "set", None) or getattr(args, "preset", None):
        cli.load_config(args)       # raises on a key the port lacks
    return args


def _sets(args) -> dict:
    return dict(s.split("=", 1) for s in (args.set or []))


def _expected(jax_out):
    """JAX's commands and notes as the port should give them."""
    cmds = []
    for c in jax_out["commands"]:
        c = c.replace("python -m tmrnet_tpu ", "python -m tmrnet_torch ")
        cmds.append(c.replace(" --set data.num_classes=6", ""))
    notes = [PORT_GPU_NOTE if n == JAX_GPU_NOTE else n
             for n in jax_out["notes"]]
    return cmds, notes


def _without_placeholders(port_out):
    """The port's commands with the placeholder weights taken out, its
    notes without their notes, and which commands had one."""
    cmds, filled = [], []
    for c in port_out["commands"]:
        tokens = shlex.split(c)
        flag, path = WEIGHTS.get(tokens[3], (None, None))
        if flag and path in tokens:
            i = tokens.index(path)
            assert tokens[i - 1] == flag
            c = c.replace(f" {flag} {shlex.quote(path)}", "")
            filled.append(tokens[3])
        cmds.append(c)
    notes = [n for n in port_out["notes"]
             if not n.startswith("the port's ")]
    return cmds, notes, filled


@pytest.mark.parametrize("refcmd", CASES)
def test_translate_matches_jax(refcmd):
    tokens = shlex.split(refcmd)
    want_cmds, want_notes = _expected(jax_translate(tokens))
    got = translate(tokens)
    cmds, notes, filled = _without_placeholders(got)
    assert cmds == want_cmds
    assert notes == want_notes
    # a placeholder exactly where JAX's command names no weights, and one
    # note for each
    jax_cmds = jax_translate(tokens)["commands"]
    want_filled = [shlex.split(c)[3] for c in jax_cmds
                   if shlex.split(c)[3] in WEIGHTS
                   and "--torch-ckpt" not in shlex.split(c)]
    assert filled == want_filled
    assert len(got["notes"]) == len(notes) + len(filled)
    for c in got["commands"]:
        _validate(c)


def test_port_config_lacks_data_num_classes():
    with pytest.raises(Exception, match="num_classes"):
        apply_override(ExperimentConfig(), "data.num_classes=6")
    out = translate(shlex.split(f"python {SIX} --csv t.csv --model m.pth"))
    s = _sets(_validate(out["commands"][0]))
    assert s == {"model.num_classes": "6"}
    assert "data.num_classes=6" in jax_translate(
        shlex.split(f"python {SIX} --csv t.csv --model m.pth"))["commands"][0]


def test_emitted_commands_parse_as_the_port_reads_them():
    """The checks of tests/test_migrate.py on the port's parser."""
    (cmd,) = translate(shlex.split(CASES[0]))["commands"]
    args = _validate(cmd)
    assert args.command == "train-bank" and args.preset == "memorybank"
    s = _sets(args)
    assert s["data.batch_clips"] == "10" and s["eval.batch_clips"] == "4"
    assert s["train.schedule"] == "step" and s["train.optimizer"] == "adam"
    assert s["data.use_flip"] == "false"

    bl, tt = [_validate(c) for c in translate(shlex.split(CASES[1]))
              ["commands"]]
    assert bl.command == "build-lfb" and tt.command == "train-tmr"
    assert bl.torch_ckpt == tt.torch_init == "./LFB/FBmodel/x.pth"
    assert bl.ckpt is None and tt.lfb == bl.out
    assert _sets(tt)["train.trunk_lr_scale"] == "1.0"

    bl, tt = [_validate(c) for c in translate(shlex.split(CASES[-3]))
              ["commands"]]
    assert bl.ckpt == STAGE1_CKPT and bl.torch_ckpt is None

    bl, tt = [_validate(c) for c in translate(shlex.split(CASES[16]))
              ["commands"]]
    assert tt.videos == "/videos" and tt.command == "train-tmr"
    assert bl.manifest and bl.videos is None
    a = _validate(translate(shlex.split(CASES[17]))["commands"][0])
    assert a.command == "train-bank" and a.videos == "/v"
    a = _validate(translate(["python", "video2frame_cutmargin.py"])
                  ["commands"][0])
    assert a.command == "prepare" and a.videos == "<videos-dir>"
    a = _validate(translate(["octave", "Main_m2cai.m"])["commands"][0])
    assert a.command == "evaluate" and a.protocol == "m2cai"
    a = _validate(translate(shlex.split(CASES[6]))["commands"][0])
    assert a.manifest == "test.csv" and a.torch_ckpt == "m.pth"
    assert a.extractor_torch_ckpt == "lfb.pth"


@pytest.mark.parametrize("tokens", [["python", "not_a_driver.py"],
                                    ["ls", "-la"]])
def test_refusals_match_jax(tokens):
    with pytest.raises(JaxMigrateError) as want:
        jax_translate(tokens)
    with pytest.raises(MigrateError) as got:
        translate(tokens)
    assert str(got.value) == str(want.value)


def test_cli_migrate_command(capsys):
    assert cli.main(["migrate", "--cmd",
                     "python train_non-local_mutiConv_resnet.py -t 90"]) == 0
    lines = capsys.readouterr().out.splitlines()
    cmds = [x for x in lines if not x.startswith("#")]
    notes = [x[2:] for x in lines if x.startswith("# ")]
    want = translate(["python", "train_non-local_mutiConv_resnet.py", "-t",
                      "90"])
    assert cmds == want["commands"] and notes == want["notes"]
    assert len(cmds) == 2 and all("tmrnet_torch" in c for c in cmds)
    assert cli.main(["migrate", "--", "octave", "Main.m"]) == 0
    assert "evaluate" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="pass the reference command"):
        cli.main(["migrate"])
    with pytest.raises(SystemExit, match="unknown reference script"):
        cli.main(["migrate", "--cmd", "python not_a_driver.py"])
    with pytest.raises(SystemExit):
        cli.main(["migrate", "--device", "cpu", "--cmd", "octave Main.m"])


def test_six_class_translation_scores_six_classes(tmp_path, capsys):
    """The 6-class driver's translation, its placeholders filled, runs
    the port's `test` with `model.num_classes=6` from the command alone:
    six columns of scores."""
    from tmrnet_tpu.config import CHOLEC80_PHASES
    from tmrnet_tpu.models.torch_import import export_reference_checkpoint
    from tmrnet_torch.config import ModelConfig
    from tmrnet_torch.models.convert import random_variables

    tiny = dict(backbone="tiny", stage_sizes=(1, 1), width=8, hidden_dim=16,
                compute_dtype="float32")
    variables = random_variables(ModelConfig(num_classes=6, head="tmr",
                                             **tiny), 3)
    sd = export_reference_checkpoint(variables, "tmr", (1, 1))
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()},
               tmp_path / "m6.pth")
    (tmp_path / "frames").mkdir()
    (tmp_path / "ann").mkdir()
    rng = np.random.default_rng(4)
    for v, n in enumerate((7, 5)):
        np.save(tmp_path / "frames" / f"video{v + 1}.npy",
                rng.integers(0, 256, (n, 40, 40, 3), dtype=np.uint8))
        (tmp_path / "ann" / f"video{v + 1}-phase.txt").write_text(
            "Frame\tPhase\n" + "".join(f"{25 * k}\t{CHOLEC80_PHASES[k % 6]}\n"
                                       for k in range(n)))
    assert cli.main(["manifest", "--frames", str(tmp_path / "frames"),
                     "--annotations", str(tmp_path / "ann"),
                     "--out", str(tmp_path / "t.pkl")]) == 0
    (cmd,) = translate(shlex.split(
        f"python {SIX} --csv {tmp_path / 't.pkl'} --model "
        f"{tmp_path / 'm6.pth'}"))["commands"]
    tokens = shlex.split(cmd)[3:]
    sets = [f"model.{k}={v}" for k, v in
            (("backbone", "tiny"), ("stage_sizes", "1,1"), ("width", 8),
             ("hidden_dim", 16), ("compute_dtype", "float32"))]
    sets += ["data.sequence_length=3", "data.resize=40", "data.crop_size=32",
             "memory.window=4"]
    out = tmp_path / "p.npz"
    assert cli.main([*tokens, *[x for s in sets for x in ("--set", s)],
                     "--out", str(out), "--device", "cpu"]) == 0
    capsys.readouterr()
    with np.load(out) as z:
        assert z["scores"].shape == (5 + 3, 6)
        assert np.isfinite(z["scores"]).all()
