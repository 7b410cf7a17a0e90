"""`python -m tmrnet_torch manifest | build-lfb | test --device cpu`
against `python -m tmrnet_tpu` with the same arguments: both CLIs read the
same `--config` JSON (written by the JAX package), the same reference
`.pth` files and the same packed frames with their phase annotations. The
manifest pickles are equal byte for byte; the banks of both build engines
within 1e-4 of max |feature|; the predictions `.npz` and the
`--ref-pickle` pair equal in predictions with scores within 1e-4 absolute,
for `--engine clip` (over each package's own clip-engine bank, `--lfb`),
`video` (`eval.video_batch=2`) and `corpus`; the JSON summary lines equal.
Each command runs once per package. Also what the port's CLI refuses, and
its engine defaults."""

import json
import pickle

import numpy as np
import pytest
import torch

from tmrnet_tpu import cli as jax_cli
from tmrnet_tpu.config import DataConfig, EvalConfig, ExperimentConfig
from tmrnet_tpu.config import CHOLEC80_PHASES, MemoryConfig, ModelConfig
from tmrnet_tpu.models.torch_import import export_reference_checkpoint
from tmrnet_torch import cli
from tmrnet_torch.config import ModelConfig as PortModelConfig
from tmrnet_torch.models.convert import random_variables

torch.set_num_threads(2)

SEQ, HW, CROP, CLASSES, CLIPS = 4, 40, 32, 5, 35
LENGTHS = (13, 4, 9, 3, 21)          # 35 clip positions; one video has none
MODEL = dict(backbone="tiny", stage_sizes=(1, 1), width=8, hidden_dim=16,
             num_classes=CLASSES, head="tmr", compute_dtype="float32")
ATOL = 1e-4
# The JAX CLI builds a mesh over the test process's 8 virtual CPU devices
# unless told otherwise; the port takes the CPU explicitly.
JAX_ARGS = ["--set", "mesh.data_parallel=1"]
PORT_ARGS = ["--device", "cpu"]
TESTS = {"clip": ["--engine", "clip", "--lfb", "{out}/bank_clip.npz"],
         "video": ["--engine", "video", "--set", "eval.video_batch=2"],
         "corpus": ["--engine", "corpus"]}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The config JSON, the model's and the extractor's `.pth`, and packed
    videos of 40x40 frames with `<video>-phase.txt` annotations."""
    d = tmp_path_factory.mktemp("cli_test")
    cfg = ExperimentConfig(
        data=DataConfig(sequence_length=SEQ, resize=HW, crop_size=CROP,
                        test_crop_type=1, device_normalize=True,
                        batch_clips=8, num_workers=2),
        model=ModelConfig(**MODEL), memory=MemoryConfig(window=4),
        eval=EvalConfig(batch_clips=8))
    (d / "cfg.json").write_text(cfg.to_json())
    for name, head, seed in (("model", "tmr", 51), ("extractor", "lfb", 52)):
        variables = random_variables(PortModelConfig(**dict(MODEL, head=head)),
                                     seed)
        sd = export_reference_checkpoint(variables, head, (1, 1))
        torch.save({k: torch.from_numpy(v) for k, v in sd.items()},
                   d / f"{name}.pth")
    (d / "frames").mkdir()
    (d / "ann").mkdir()
    rng = np.random.default_rng(53)
    for v, n in enumerate(LENGTHS):
        np.save(d / "frames" / f"video{v + 1:02d}.npy",
                rng.integers(0, 256, (n, HW, HW, 3), dtype=np.uint8))
        rows = [f"{25 * k}\t{CHOLEC80_PHASES[(k // 3 + v) % CLASSES]}\n"
                for k in range(n)]
        (d / "ann" / f"video{v + 1:02d}-phase.txt").write_text(
            "Frame\tPhase\n" + "".join(rows))
    return d


def _chain(main, files, out, extra, capsys):
    """manifest, build-lfb (clip and video engines), then test with each
    engine; returns each test's JSON summary line."""
    out.mkdir()
    cfg = ["--config", str(files / "cfg.json")]
    assert main(["manifest", *cfg, "--frames", str(files / "frames"),
                 "--annotations", str(files / "ann"),
                 "--out", str(out / "m.pkl")]) == 0
    for engine in ("clip", "video"):
        assert main(["build-lfb", *cfg, "--manifest", str(out / "m.pkl"),
                     "--torch-ckpt", str(files / "extractor.pth"), "--engine",
                     engine, "--out", str(out / f"bank_{engine}.npz"),
                     *extra]) == 0
    capsys.readouterr()
    summaries = {}
    for name, args in TESTS.items():
        assert main(["test", *cfg, "--manifest", str(out / "m.pkl"),
                     "--torch-ckpt", str(files / "model.pth"),
                     "--extractor-torch-ckpt", str(files / "extractor.pth"),
                     *[a.format(out=out) for a in args],
                     "--out", str(out / f"{name}.npz"),
                     "--ref-pickle", str(out / f"{name}.pkl"), *extra]) == 0
        summaries[name] = json.loads(
            capsys.readouterr().out.strip().splitlines()[-1])
    return summaries


@pytest.fixture(scope="module")
def runs(files, tmp_path_factory):
    """Both CLIs' chains, run once each."""
    capsys = _Capture()
    with capsys:
        jax_sum = _chain(jax_cli.main, files, files / "jax", JAX_ARGS, capsys)
        port_sum = _chain(cli.main, files, files / "port", PORT_ARGS, capsys)
    return dict(jax=files / "jax", port=files / "port", jax_sum=jax_sum,
                port_sum=port_sum)


class _Capture:
    """capsys for a module fixture: stdout captured while inside."""

    def __enter__(self):
        import contextlib
        import io

        self.buf = io.StringIO()
        self._cm = contextlib.redirect_stdout(self.buf)
        self._cm.__enter__()
        return self

    def __exit__(self, *exc):
        return self._cm.__exit__(*exc)

    def readouterr(self):
        text = self.buf.getvalue()
        self.buf.seek(0)
        self.buf.truncate()
        return type("Captured", (), {"out": text})()


def test_manifest_pickles_equal(runs):
    jax_bytes = (runs["jax"] / "m.pkl").read_bytes()
    assert (runs["port"] / "m.pkl").read_bytes() == jax_bytes
    paths, labels, num_each = pickle.loads(jax_bytes)
    assert num_each == list(LENGTHS) and len(paths) == sum(LENGTHS)


@pytest.mark.parametrize("engine", ["clip", "video"])
def test_banks_match_jax(runs, engine):
    with np.load(runs["jax"] / f"bank_{engine}.npz") as z:
        want, want_first = z["features"], z["first_rows"]
    with np.load(runs["port"] / f"bank_{engine}.npz") as z:
        got, got_first = z["features"], z["first_rows"]
    assert got.shape == (CLIPS, 16)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL * np.abs(want).max())
    np.testing.assert_array_equal(got_first, want_first)
    with np.load(runs["port"] / "bank_clip.npz") as z:
        np.testing.assert_allclose(got, z["features"], rtol=0,
                                   atol=ATOL * np.abs(want).max())


@pytest.mark.parametrize("engine", list(TESTS))
def test_predictions_match_jax(runs, engine):
    with np.load(runs["jax"] / f"{engine}.npz") as z:
        want = {k: z[k] for k in ("preds", "scores", "rows")}
    with np.load(runs["port"] / f"{engine}.npz") as z:
        got = {k: z[k] for k in ("preds", "scores", "rows")}
    assert got["scores"].shape == (CLIPS, CLASSES)
    np.testing.assert_array_equal(got["preds"], want["preds"])
    np.testing.assert_array_equal(got["rows"], want["rows"])
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=0, atol=ATOL)
    for suffix in ("", ".score.pkl"):
        load = lambda root: pickle.loads((root / f"{engine}.pkl{suffix}")
                                         .read_bytes())
        mine, theirs = load(runs["port"]), load(runs["jax"])
        if suffix:          # the max softmax of each clip
            np.testing.assert_allclose(mine, theirs, rtol=0, atol=ATOL)
            np.testing.assert_allclose(mine, got["scores"].max(axis=1))
        else:
            assert mine == theirs == got["preds"].tolist()
    port, jax = runs["port_sum"][engine], runs["jax_sum"][engine]
    assert port["num_clips"] == jax["num_clips"] == CLIPS
    for key in ("clip_accuracy", "precision_per_class", "recall_per_class"):
        assert port[key] == jax[key], key


def test_engines_agree(runs):
    scores = {}
    for engine in TESTS:
        with np.load(runs["port"] / f"{engine}.npz") as z:
            scores[engine] = z["scores"]
    for engine in ("video", "corpus"):
        np.testing.assert_allclose(scores[engine], scores["clip"], rtol=0,
                                   atol=ATOL)


def _base(files, runs, command="test"):
    args = [command, "--config", str(files / "cfg.json"), "--manifest",
            str(runs["port"] / "m.pkl"), *PORT_ARGS]
    if command == "test":
        args += ["--torch-ckpt", str(files / "model.pth"), "--out",
                 str(runs["port"] / "refused.npz")]
    else:
        args += ["--torch-ckpt", str(files / "extractor.pth"), "--out",
                 str(runs["port"] / "refused_bank.npz")]
    return args


def test_port_cli_refuses(files, runs):
    base = _base(files, runs)
    with pytest.raises(SystemExit, match="feature extractor"):
        cli.main(base + ["--set", "model.head=lfb"])
    for extra in (["--engine", "video"], ["--engine", "corpus"]):
        with pytest.raises(SystemExit, match="runs the memory head"):
            cli.main(base + ["--set", "model.head=stage1", *extra])
    for extra in (["--lfb", "x.npz"], ["--load-lfb"]):
        with pytest.raises(SystemExit, match="frame-only"):
            cli.main(base + ["--set", "model.head=stage1", *extra])
    for engine in ("video", "corpus"):
        with pytest.raises(SystemExit, match="deterministic frame-wise"):
            cli.main(base + ["--engine", engine, "--set",
                             "data.test_crop_type=5"])
        with pytest.raises(SystemExit, match="cross-video"):
            cli.main(base + ["--engine", engine, "--set",
                             "memory.compat_cross_video=true"])
    # test takes no --videos, --videos excludes build-lfb's --manifest,
    # and --ckpt (a port checkpoint) and --torch-ckpt exclude each other
    for command, flag in (("test", "--videos"), ("test", "--ckpt"),
                          ("build-lfb", "--videos"), ("build-lfb", "--ckpt")):
        with pytest.raises(SystemExit) as exc:
            cli.main(_base(files, runs, command) + [flag, "x"])
        assert exc.value.code == 2
    # a g_LFB pickle of another dataset's row count
    bad = runs["port"] / "bad_bank.pkl"
    bad.write_bytes(pickle.dumps(np.zeros((CLIPS + 1, 16), np.float32)))
    with pytest.raises(ValueError, match="clip positions"):
        cli.main(base + ["--lfb", str(bad)])


class _Chosen(Exception):
    pass


def test_engine_defaults(files, runs, monkeypatch):
    """test: corpus by default; clip for crop types 0/5/10,
    compat_cross_video, --lfb and --load-lfb. build-lfb: video, clip for
    crop types outside 1/2/3."""
    from tmrnet_torch.eval import infer
    from tmrnet_torch.train import loop

    def video(cfg, *a):
        raise _Chosen("corpus" if cfg.eval.corpus else "video")

    def clip(self, ds):
        raise _Chosen("clip")

    def bank(cfg, extractor, ds, engine="clip", **kw):
        raise _Chosen(engine)

    monkeypatch.setattr(cli, "_video_engine_results", video)
    monkeypatch.setattr(infer.ClipInference, "run", clip)
    monkeypatch.setattr(loop, "build_lfb", bank)
    lfb = str(runs["port"] / "bank_clip.npz")
    cases = [([], "corpus"), (["--engine", "video"], "video"),
             (["--set", "data.test_crop_type=0"], "clip"),
             (["--set", "data.test_crop_type=10"], "clip"),
             (["--set", "memory.compat_cross_video=true"], "clip"),
             (["--lfb", lfb], "clip")]
    for extra, want in cases:
        with pytest.raises(_Chosen, match=f"^{want}$"):
            cli.main(_base(files, runs) + extra)
    # --load-lfb without a bank on disk builds one with the clip engine
    with pytest.raises(_Chosen, match="^clip$"):
        cli.main(_base(files, runs) + ["--load-lfb", "--lfb",
                                       str(runs["port"] / "none.npz")])
    for extra, want in (([], "video"),
                        (["--set", "data.test_crop_type=5"], "clip"),
                        (["--engine", "clip"], "clip")):
        with pytest.raises(_Chosen, match=f"^{want}$"):
            cli.main(_base(files, runs, "build-lfb") + extra)


def test_clip_engine_builds_a_missing_bank(files, runs, capsys):
    """`test --engine clip --lfb <new path>` builds the bank with the clip
    engine, writes it there, and scores as over build-lfb's bank."""
    path = runs["port"] / "built.npz"
    assert cli.main(_base(files, runs) + [
        "--engine", "clip", "--lfb", str(path), "--extractor-torch-ckpt",
        str(files / "extractor.pth"), "--out",
        str(runs["port"] / "built_preds.npz")]) == 0
    capsys.readouterr()
    with np.load(path) as z, np.load(runs["port"] / "bank_clip.npz") as w:
        np.testing.assert_array_equal(z["features"], w["features"])
    with np.load(runs["port"] / "built_preds.npz") as z, \
            np.load(runs["port"] / "clip.npz") as w:
        np.testing.assert_array_equal(z["scores"], w["scores"])


def test_sequence_parallel_commands_equal_one_device(files, runs):
    """`--set mesh.data_parallel=2` without mesh.multihost: `build-lfb
    --engine video` and `test --engine video|corpus` run the
    sequence-parallel pass over two CPU shards and write the one-device
    runs' outputs (1e-6)."""
    out = runs["port"] / "sp"
    out.mkdir()
    sp = ["--set", "mesh.data_parallel=2"]
    cfg = ["--config", str(files / "cfg.json")]
    assert cli.main(["build-lfb", *cfg, "--manifest", str(runs["port"] /
                                                          "m.pkl"),
                     "--torch-ckpt", str(files / "extractor.pth"),
                     "--engine", "video", "--out", str(out / "bank.npz"),
                     *PORT_ARGS, *sp]) == 0
    with np.load(out / "bank.npz") as got, \
            np.load(runs["port"] / "bank_video.npz") as want:
        np.testing.assert_allclose(got["features"], want["features"],
                                   rtol=1e-6, atol=1e-6)
    for name in ("video", "corpus"):
        assert cli.main(["test", *cfg, "--manifest", str(runs["port"] /
                                                         "m.pkl"),
                         "--torch-ckpt", str(files / "model.pth"),
                         "--extractor-torch-ckpt",
                         str(files / "extractor.pth"), *TESTS[name],
                         "--out", str(out / f"{name}.npz"), *PORT_ARGS,
                         *sp]) == 0
        with np.load(out / f"{name}.npz") as got, \
                np.load(runs["port"] / f"{name}.npz") as want:
            np.testing.assert_array_equal(got["preds"], want["preds"])
            np.testing.assert_allclose(got["scores"], want["scores"],
                                       rtol=1e-6, atol=1e-6)
