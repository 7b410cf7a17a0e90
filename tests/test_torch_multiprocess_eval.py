"""`test`, `build-lfb` and `stream` under mesh.multihost over gloo ranks on
the CPU against one process.

Each rank is `python -m tmrnet_torch <command> --device cpu --set
mesh.multihost=true` with an explicit rendezvous (`mesh.coordinator`,
`mesh.num_processes`, `mesh.process_id`) on a free localhost port; the
one-process run is `tmrnet_torch.cli.main` with the same arguments,
without the mesh. Over packed videos, a tiny model in f32 and reference
`.pth` files:

- `test` (the corpus engine, videos partitioned) over 2 and 3 ranks: the
  predictions, softmax and rows of rank 0's `.npz` equal one process's,
  byte for byte; rank 0 alone prints the summary;
- `build-lfb --engine video` over 2 ranks: the bank equal byte for byte;
  `--engine clip` (each batch split over the ranks) within 1e-6;
- `stream --max-streams 2` over 2 ranks: rank 0's JSONL equal byte for
  byte to a one-rank run's under mesh.multihost (rows grouped by video),
  and per video to the one-process run's rows;
- and one training command over a grid: `train-bank --set
  mesh.model_parallel=2` over 2 ranks (1 x 2) against one process.
"""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from tmrnet_torch import cli
from tmrnet_torch.config import (CHOLEC80_PHASES, DataConfig, EvalConfig,
                                 ExperimentConfig, MemoryConfig, ModelConfig)
from tmrnet_torch.models.convert import from_jax_variables, random_variables
from tmrnet_torch.models.torch_import import export_reference_checkpoint

from tests.test_torch_cli_test import _Capture
from tests.test_torch_multiprocess_train import free_port

ROOT = pathlib.Path(__file__).resolve().parents[1]
SEQ, HW, CROP, CLASSES, WINDOW = 4, 40, 32, 7, 4
LENGTHS = (13, 4, 9, 3, 21)          # 35 clip positions; one video has none
MODEL = dict(backbone="tiny", stage_sizes=(1, 1), width=8, hidden_dim=16,
             num_classes=CLASSES, head="tmr", compute_dtype="float32")
CHILD_TIMEOUT = 120


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The config JSON, the model's and the extractor's `.pth`, packed
    40x40 videos with phase annotations, and the manifest."""
    d = tmp_path_factory.mktemp("mp_eval")
    cfg = ExperimentConfig(
        data=DataConfig(sequence_length=SEQ, resize=HW, crop_size=CROP,
                        test_crop_type=1, device_normalize=True,
                        batch_clips=8, num_workers=2),
        model=ModelConfig(**MODEL), memory=MemoryConfig(window=WINDOW),
        eval=EvalConfig(batch_clips=8, corpus_chunk=16))
    (d / "cfg.json").write_text(cfg.to_json())
    for head, seed in (("tmr", 91), ("lfb", 92)):
        state = from_jax_variables(random_variables(
            ModelConfig(**dict(MODEL, head=head)), seed))
        if head == "tmr":       # spread the 7-class softmax
            state = dict(state, **{k: state[k] * 4 for k in ("fc_c.weight",
                                                             "fc_c.bias")})
        torch.save(export_reference_checkpoint(state, head, (1, 1)),
                   d / f"{head}.pth")
    (d / "frames").mkdir()
    (d / "ann").mkdir()
    rng = np.random.default_rng(93)
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


def base(files, command):
    argv = [command, "--config", str(files / "cfg.json"), "--manifest",
            str(files / "m.pkl"), "--device", "cpu"]
    if command == "build-lfb":
        return argv + ["--torch-ckpt", str(files / "lfb.pth")]
    return argv + ["--torch-ckpt", str(files / "tmr.pth"),
                   "--extractor-torch-ckpt", str(files / "lfb.pth")]


def one_process(argv):
    """cli.main(argv) in this process on one thread, as the ranks run:
    its stdout lines."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with _Capture() as cap:
            assert cli.main(argv) == 0
    finally:
        torch.set_num_threads(threads)
    return cap.readouterr().out.strip().splitlines()


def ranks(argv, world):
    """`python -m tmrnet_torch` argv on `world` gloo ranks: each rank's
    stdout, each asserted to exit 0."""
    port = free_port()
    mh = ["--set", "mesh.multihost=true",
          "--set", f"mesh.coordinator=127.0.0.1:{port}",
          "--set", f"mesh.num_processes={world}"]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "tmrnet_torch", *argv, *mh,
         "--set", f"mesh.process_id={r}"], cwd=ROOT, env=env, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=CHILD_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{out}"
    return outs


def summaries(out):
    """The summary lines of a command's output (not its `mesh` line)."""
    return [d for d in (json.loads(ln) for ln in out.splitlines()
                        if ln.startswith("{")) if "mesh" not in d]


@pytest.fixture(scope="module")
def single_test(files):
    out = files / "single.npz"
    lines = one_process(base(files, "test") + ["--engine", "corpus",
                                               "--out", str(out)])
    return out, json.loads(lines[-1])


@pytest.mark.parametrize("world", [2, 3])
def test_cli_test_over_ranks_equals_one_process(files, single_test, world,
                                                tmp_path):
    """`test --engine corpus` over 2 and 3 ranks (5 videos, one without a
    clip, split 2/2/1 over 3): rank 0's predictions, softmax and rows equal
    one process's byte for byte; rank 0 alone prints the summary, which
    equals one process's."""
    want, want_summary = single_test
    out = tmp_path / "mh.npz"
    outs = ranks(base(files, "test") + ["--engine", "corpus", "--out",
                                        str(out)], world)
    got_summary = summaries(outs[0])[-1]
    assert got_summary == dict(want_summary, out=str(out))
    assert all(not summaries(o) for o in outs[1:])
    with np.load(want) as a, np.load(out) as b:
        assert sorted(a.files) == sorted(b.files) == ["preds", "rows",
                                                      "scores"]
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
            assert a[k].tobytes() == b[k].tobytes(), k


def test_cli_build_lfb_over_ranks_equals_one_process(files, tmp_path):
    """`build-lfb --engine video` over 2 ranks (videos partitioned, the
    owned rows gathered): the bank equals one process's byte for byte;
    `--engine clip` (each batch of 8 split 4/4): within 1e-6. Rank 0 alone
    reports."""
    for engine, exact in (("video", True), ("clip", False)):
        want, got = tmp_path / f"one_{engine}.npz", tmp_path / f"mh_{engine}.npz"
        one_process(base(files, "build-lfb") + ["--engine", engine,
                                                "--out", str(want)])
        outs = ranks(base(files, "build-lfb") + ["--engine", engine,
                                                 "--out", str(got)], 2)
        assert "bank:" in outs[0] and "bank:" not in outs[1]
        with np.load(want) as a, np.load(got) as b:
            assert np.array_equal(a["first_rows"], b["first_rows"])
            assert a["features"].shape == b["features"].shape == (35, 16)
            assert float(np.abs(a["features"]).min()) > 0
            if exact:
                assert a["features"].tobytes() == b["features"].tobytes()
            else:
                np.testing.assert_allclose(b["features"], a["features"],
                                           rtol=1e-6, atol=1e-6)


def test_cli_stream_over_ranks_equals_one_process(files, tmp_path):
    """`stream --max-streams 2` over 2 ranks: rank 0 writes the rows grouped
    by video in manifest order, byte for byte those of one rank under
    mesh.multihost, and per video the one-process run's rows; the summary
    counts the same predictions and names the processes."""
    argv = base(files, "stream") + ["--max-streams", "2"]
    one = summaries("\n".join(one_process(
        argv + ["--out", str(tmp_path / "one.jsonl")])))[-1]
    s1 = summaries(ranks(argv + ["--out", str(tmp_path / "r1.jsonl")],
                         1)[0])[-1]
    outs = ranks(argv + ["--out", str(tmp_path / "r2.jsonl")], 2)
    s2 = summaries(outs[0])[-1]
    assert not summaries(outs[1])
    assert (tmp_path / "r2.jsonl").read_bytes() == (
        tmp_path / "r1.jsonl").read_bytes()
    by_video = lambda path: {
        v: sorted((r["frame"], r["pred"], r["valid"]) for r in rows
                  if r["video"] == v)
        for rows in [[json.loads(ln) for ln in path.read_text().splitlines()]]
        for v in {r["video"] for r in rows}}
    assert by_video(tmp_path / "r2.jsonl") == by_video(tmp_path / "one.jsonl")
    assert (s1["processes"], s2["processes"]) == (1, 2)
    for s in (s1, s2):
        assert (s["predictions"], s["clip_accuracy"], s["streams"]) == (
            one["predictions"], one["clip_accuracy"], one["streams"])
    assert one["predictions"] == sum(max(0, n - SEQ + 1) for n in LENGTHS)


def test_cli_train_bank_over_a_grid_equals_one_process(files, tmp_path):
    """The counterpart of JAX's `test_cli_train_bank_explicit_mesh`:
    `train-bank --set mesh.model_parallel=2` as two gloo ranks (a 1 x 2
    grid under mesh.multihost) trains, each rank's mesh line names its
    model index, rank 0 alone prints the summary, and the checkpoint's
    metrics equal one process's run (1e-5) and its weights are whole."""
    from tmrnet_torch.models.convert import from_jax_variables
    from tmrnet_torch.utils.checkpoint import CheckpointManager

    def argv(name):
        return ["train-bank", "--config", str(files / "cfg.json"),
                "--train-manifest", str(files / "m.pkl"), "--device",
                "cpu", "--set", "train.epochs=1", "--set",
                f"train.checkpoint_dir={tmp_path / name}", "--log-dir",
                str(tmp_path / f"log_{name}")]

    one_process(argv("one"))
    outs = ranks(argv("grid") + ["--set", "mesh.model_parallel=2"], 2)
    meshes = [json.loads(ln)["mesh"] for o in outs for ln in o.splitlines()
              if ln.startswith('{"mesh"')]
    assert sorted(m["model_index"] for m in meshes) == [0, 1]
    assert all(m["shape"] == {"data": 1, "model": 2} for m in meshes)
    assert ["best epoch" in o for o in outs] == [True, False]
    grid, one = (CheckpointManager(str(tmp_path / n)) for n in ("grid",
                                                                "one"))
    assert grid.all_steps() == one.all_steps()
    got = grid.metadata(grid.latest_step())["metrics"]
    want = one.metadata(one.latest_step())["metrics"]
    for k in ("val_acc", "train_acc", "val_loss"):
        assert got[k] == pytest.approx(want[k], rel=1e-5), k
    saved = from_jax_variables(CheckpointManager._load(
        grid._step_dir(grid.latest_step()))["variables"])
    ref = from_jax_variables(CheckpointManager._load(
        one._step_dir(one.latest_step()))["variables"])
    assert {k: v.shape for k, v in saved.items()} == {
        k: v.shape for k, v in ref.items()}
    for k, v in saved.items():
        np.testing.assert_allclose(v.numpy(), ref[k].numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=k)
