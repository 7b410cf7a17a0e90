"""Guards of the port: it imports nothing of JAX, of the JAX package or of
its `scripts` (which import JAX), and its entry points refuse to run
without CUDA unless asked for the CPU."""

import ast
import dataclasses
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from tmrnet_torch.config import DataConfig, ExperimentConfig, ModelConfig
from tmrnet_torch.eval.infer import ClipInference, VideoInference
from tmrnet_torch.eval.stream import StreamingInference
from tmrnet_torch.memory.lfb import FeatureBank, load_bank
from tmrnet_torch.models.tmrnet import build_model
from tmrnet_torch.train.loop import build_lfb, build_lfb_video

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "tmrnet_tpu",
             "scripts")
PORT_FILES = sorted((ROOT / "tmrnet_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "id", None) == "__import__"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_nothing_of_jax(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


def test_importing_the_port_leaves_jax_out():
    code = ("import sys, tmrnet_torch, tmrnet_torch.eval.infer, "
            "tmrnet_torch.eval.stream, tmrnet_torch.train.loop, "
            "tmrnet_torch.models.convert, tmrnet_torch.memory.lfb, "
            "tmrnet_torch.ops, tmrnet_torch.ops.quant, "
            "tmrnet_torch.experimental.fused_bottleneck_tiled, "
            "tmrnet_torch.experimental.quant_conv, "
            "tmrnet_torch.experimental.int8_gate, tmrnet_torch.cli, "
            "tmrnet_torch.config, tmrnet_torch.eval.serve, "
            "tmrnet_torch.eval.serve_net, tmrnet_torch.models.torch_import, "
            "tmrnet_torch.data.packed, tmrnet_torch.data.pipeline, "
            "tmrnet_torch.data.transforms, tmrnet_torch.data.indexing, "
            "tmrnet_torch.data.manifests, tmrnet_torch.data.device_feed, "
            "tmrnet_torch.eval.metrics, tmrnet_torch.eval.export, "
            "tmrnet_torch.train.losses, "
            "tmrnet_torch.train.optim, tmrnet_torch.train.state, "
            "tmrnet_torch.train.steps, tmrnet_torch.train.step_check, "
            "tmrnet_torch.utils.checkpoint, "
            "tmrnet_torch.utils.logging, tmrnet_torch.parallel, "
            "tmrnet_torch.parallel.mesh, tmrnet_torch.eval.distributed, "
            "tmrnet_torch.entry, tmrnet_torch.eval.saved, "
            "tmrnet_torch.kernels.library, tmrnet_torch.data.synthetic, "
            "tmrnet_torch.data.stats, tmrnet_torch.migrate, "
            "tmrnet_torch.data.video, tmrnet_torch.data.cutmargin, "
            "tmrnet_torch.experimental.efficacy_study, "
            "tmrnet_torch.experimental.efficacy_grid, "
            "tmrnet_torch.experimental.headlevel_multiscale, "
            "tmrnet_torch.experimental.timeconv_witness; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}]; print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


CFG = ModelConfig(backbone="tiny", hidden_dim=16, compute_dtype="float32")


def test_entry_points_need_cuda_unless_cpu(no_cuda, tmp_path):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(CFG)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FeatureBank.create(3, [5, 6], 16)
    bank = FeatureBank.create(3, [5, 6], 16, device="cpu")
    from tmrnet_torch.memory.lfb import save_bank

    save_bank(str(tmp_path / "b.npz"), bank)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_bank(str(tmp_path / "b.npz"))
    state = build_model(CFG, device="cpu").state_dict()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ClipInference(ExperimentConfig(model=CFG), state, bank)
    engine = ClipInference(ExperimentConfig(model=CFG), state, bank, device="cpu")
    res = engine.run_batches([(np.zeros((1, 2, 32, 32, 3), np.uint8),
                               np.zeros(1), np.array([3]), 0)],
                             bank.first_rows)
    assert res.scores.shape == (1, 7)

    cfg = ExperimentConfig(model=CFG, data=DataConfig(sequence_length=2))
    ext = build_model(dataclasses.replace(CFG, head="lfb"), device="cpu").state_dict()
    video = np.zeros((3, 32, 32, 3), np.uint8)
    for make in (lambda **kw: VideoInference(cfg, state, ext, **kw),
                 lambda **kw: StreamingInference(cfg, state, ext, **kw),
                 lambda **kw: build_lfb_video(cfg, ext, [video], **kw)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
        make(device="cpu")
    # the dataset-taking paths: build_lfb (both engines), run(ds) and
    # device_prefetch
    from tmrnet_torch.data.device_feed import device_prefetch
    from tmrnet_torch.data.manifests import Manifest, VideoRecord
    from tmrnet_torch.data.pipeline import ClipDataset, array_frame_loader

    frames = {f"f{i}": video[i] for i in range(3)}
    ds = ClipDataset(Manifest([VideoRecord("v", list(frames), np.zeros(3, int))]),
                     2, frame_loader=array_frame_loader(frames))
    for engine in ("clip", "video"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build_lfb(cfg, ext, ds, cache_path=str(tmp_path / "x.npz"),
                      engine=engine)
        built = build_lfb(cfg, ext, ds, engine=engine, device="cpu",
                          cache_path=str(tmp_path / f"{engine}.npz"))
        assert built.num_rows == 2 and built.features.device.type == "cpu"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        next(device_prefetch([(video,)]))
    assert next(device_prefetch([(video,)], device="cpu"))[0].device.type == "cpu"
    res = ClipInference(cfg, state, built, device="cpu").run(ds)
    assert res.scores.shape == (2, 7)
    preds, probs = VideoInference(cfg, state, ext, device="cpu").run_video(video)
    assert preds.shape == (2,) and probs.shape == (2, 7)
    stream = StreamingInference(cfg, state, ext, device="cpu")
    out = stream.step(stream.init_state(2), video[:2])
    assert all(t.device.type == "cpu" for t in out[1:])

    # the reference .pkl bank, and the serve CLI and the engine its restore
    # builds, from a reference .pth
    import pickle

    from tmrnet_torch import cli
    from tmrnet_torch.models.torch_import import export_reference_checkpoint

    with open(tmp_path / "b.pkl", "wb") as f:
        pickle.dump(np.zeros((4, 16), np.float32), f)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_bank(str(tmp_path / "b.pkl"))
    assert load_bank(str(tmp_path / "b.pkl"), device="cpu").num_rows == 4
    tmr_cfg = dataclasses.replace(CFG, head="tmr", stage_sizes=(1, 1))
    torch.save(export_reference_checkpoint(
        build_model(tmr_cfg, device="cpu").state_dict(), "tmr", (1, 1)),
        tmp_path / "m.pth")
    cfg = ExperimentConfig(model=tmr_cfg, data=DataConfig(sequence_length=2))
    (tmp_path / "cfg.json").write_text(cfg.to_json())
    (tmp_path / "in.jsonl").write_text("")
    argv = ["serve", "--config", str(tmp_path / "cfg.json"), "--torch-ckpt",
            str(tmp_path / "m.pth"), "--input", str(tmp_path / "in.jsonl"),
            "--no-warmup"]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(argv)
    assert cli.main(argv + ["--device", "cpu"]) == 0
    # build-lfb and test refuse before reading anything
    for command in ("build-lfb", "test"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cli.main([command, "--manifest", "m.pkl", "--torch-ckpt", "m.pth",
                      "--out", str(tmp_path / "o.npz")])
    restored = cli.restore_state(cfg, "tmr", str(tmp_path / "m.pth"))
    ext = cli.extractor_state(cfg, restored, None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        StreamingInference(cfg, restored, ext)
    StreamingInference(cfg, restored, ext, device="cpu")
    # export-model (and the export it runs) refuses before reading
    # anything; doctor's device check fails, and the command exits 1,
    # unless --device cpu; serve --artifact runs where --device says
    from tmrnet_torch.eval.saved import export_inference

    with pytest.raises(RuntimeError, match="device='cpu'"):
        export_inference(cfg, restored, 1)
    art = str(tmp_path / "a.pt2")
    argv = ["export-model", "--config", str(tmp_path / "cfg.json"),
            "--torch-ckpt", str(tmp_path / "m.pth"), "--stream", "--slots",
            "1", "--out", art]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(argv)
    assert cli.main(argv + ["--device", "cpu"]) == 0
    argv = ["serve", "--artifact", art, "--input", str(tmp_path / "in.jsonl")]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(argv)
    assert cli.main(argv + ["--device", "cpu"]) == 0
    assert cli.main(["doctor"]) == 1
    assert cli.main(["doctor", "--device", "cpu"]) == 0


def test_engine_refuses_a_bank_on_another_device():
    bank = FeatureBank(torch.zeros(4, 16, device="meta"),
                       torch.zeros(4, dtype=torch.int32))
    state = build_model(CFG, device="cpu").state_dict()
    with pytest.raises(ValueError, match="bank on meta"):
        ClipInference(ExperimentConfig(model=CFG), state, bank, device="cpu")


def test_int8_gate_needs_cuda(no_cuda):
    from tmrnet_torch.experimental import int8_gate

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        int8_gate.main(["--stages", "stage4", "--batch", "1"])
    with pytest.raises(ValueError, match="needs a CUDA device"):
        int8_gate.measure_stage(int8_gate.STAGES[-1], 1, device="cpu")


def test_trainers_need_cuda_unless_cpu(no_cuda, tmp_path):
    """train_stage1, train_stage2 and the train-bank / train-tmr commands
    refuse to run without a card unless asked for the CPU, before reading
    anything; remat, async checkpoints and the native preprocess run on
    the CPU; a mesh other than a data mesh raises by name, a rank without
    a card raises, and a one-process gloo mesh trains as no mesh does."""
    from tmrnet_torch import cli
    from tmrnet_torch.config import TrainConfig
    from tmrnet_torch.data.manifests import Manifest, VideoRecord
    from tmrnet_torch.data.pipeline import ClipDataset, array_frame_loader
    from tmrnet_torch.data.transforms import TrainTransform
    from tmrnet_torch.train.loop import train_stage1, train_stage2

    frames = {f"f{i}": np.zeros((32, 32, 3), np.uint8) for i in range(5)}
    ds = ClipDataset(Manifest([VideoRecord("v", list(frames),
                                           np.arange(5) % 2)]),
                     2, frame_loader=array_frame_loader(frames))
    model = dataclasses.replace(CFG, stage_sizes=(1, 1))
    cfg = ExperimentConfig(model=model,
                           data=DataConfig(sequence_length=2, batch_clips=2,
                                           num_workers=1),
                           train=TrainConfig(epochs=1, log_every=1,
                                             checkpoint_dir=str(tmp_path)))
    bank = FeatureBank.create(2, [5], 16, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_stage1(cfg, ds)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_stage2(cfg, ds, bank)
    listed = []
    real = os.listdir
    for argv in (["train-bank", "--train-manifest", "m.pkl"],
                 ["train-tmr", "--train-manifest", "m.pkl", "--lfb", "b"],
                 ["train-bank", "--videos", str(tmp_path), "--annotations",
                  str(tmp_path)],
                 ["train-tmr", "--videos", str(tmp_path), "--annotations",
                  str(tmp_path), "--lfb", "b"],
                 ["build-lfb", "--videos", str(tmp_path), "--annotations",
                  str(tmp_path), "--ckpt", str(tmp_path), "--out", "b"]):
        # before a video directory is listed
        os.listdir = lambda p=".": listed.append(p) or real(p)
        try:
            with pytest.raises(RuntimeError, match="device='cpu'"):
                cli.main(argv)
        finally:
            os.listdir = real
    assert listed == []
    _, hist = train_stage1(cfg, ds, device="cpu")
    assert len(hist) == 1
    state, hist = train_stage2(
        cfg.replace(train=dataclasses.replace(
            cfg.train, checkpoint_dir=str(tmp_path / "s2"))), ds, bank,
        device="cpu")
    assert len(hist) == 1 and state.step == 2
    assert all(p.device.type == "cpu" for p in state.model.parameters())
    # remat, async checkpoints and model.remat alone train on the CPU; an
    # async run's last checkpoint is durable when the trainer returns
    for i, (section, kw) in enumerate((("train", dict(remat=True)),
                                       ("train", dict(async_checkpoint=True)),
                                       ("model", dict(remat=True)))):
        ck = tmp_path / f"opt{i}"
        opt = cfg.replace(train=dataclasses.replace(
            cfg.train, checkpoint_dir=str(ck)))
        opt = opt.replace(**{section: dataclasses.replace(
            getattr(opt, section), **kw)})
        state, hist = train_stage1(opt, ds, device="cpu")
        assert len(hist) == 1 and state.step == 2
        assert (ck / f"step_{state.step:08d}" / "state.pt").exists()
        assert (ck / f"step_{state.step:08d}.json").exists()
    for fn in (lambda: train_stage1(cfg, ds, mesh=object(), device="cpu"),
               lambda: train_stage2(cfg, ds, bank, mesh=object(),
                                    device="cpu")):
        with pytest.raises(NotImplementedError, match="mesh"):
            fn()
    # a rank without its card raises, and joins no group; a data mesh of
    # one gloo process on the CPU trains both stages to the weights of the
    # run without one, bit for bit (a sum over one rank is the identity)
    from tests.test_torch_multiprocess_train import free_port
    from tmrnet_torch.parallel.mesh import (initialize_multihost, make_mesh,
                                            shutdown)

    with pytest.raises(RuntimeError, match="device='cpu'"):
        initialize_multihost(f"127.0.0.1:{free_port()}", 1, 0)
    assert not torch.distributed.is_initialized()
    initialize_multihost(f"127.0.0.1:{free_port()}", 1, 0, device="cpu")
    try:
        mesh = make_mesh(device="cpu")
        for i, train in enumerate((
                lambda c: train_stage1(c, ds, mesh=mesh),
                lambda c: train_stage2(c, ds, bank, mesh=mesh))):
            ck = lambda name: cfg.replace(train=dataclasses.replace(
                cfg.train, checkpoint_dir=str(tmp_path / f"{name}{i}")))
            got, _ = train(ck("mesh"))
            want, _ = (train_stage1(ck("plain"), ds, device="cpu") if i == 0
                       else train_stage2(ck("plain"), ds, bank,
                                         device="cpu"))
            for k, v in want.model.state_dict().items():
                assert torch.equal(got.model.state_dict()[k], v), k
    finally:
        shutdown()
    clip = np.random.default_rng(5).integers(0, 256, (2, 40, 40, 3),
                                             dtype=np.uint8)
    native = TrainTransform(32, 40, False, use_native=True)(clip, 0, 1)
    plain = TrainTransform(32, 40, False)(clip, 0, 1)
    assert native.dtype == np.float32 and native.shape == (2, 32, 32, 3)
    np.testing.assert_allclose(native, plain, rtol=0, atol=1e-6)


def test_host_commands_and_the_study_without_cuda(no_cuda, tmp_path):
    """synth, manifest, stats, pack, migrate and prepare run without a
    card and take no --device; the efficacy study on the card (its default) refuses before
    it writes anything, and runs its first command on the CPU when asked."""
    from tmrnet_torch import cli
    from tmrnet_torch.experimental import efficacy_study

    d = str(tmp_path / "ds")
    steps = [["synth", "--out-dir", d, "--train", "1", "--val", "0",
              "--test", "1", "--hw", "8", "--dur-min", "2", "--dur-max", "3"],
             ["manifest", "--frames", f"{d}/frames-train", "--annotations",
              f"{d}/annotations", "--stride", "1", "--out", f"{d}/m.pkl"],
             ["stats", "--manifest", f"{d}/m.pkl", "--no-resize"],
             ["stats", "--manifest", f"{d}/m.pkl", "--population"],
             ["pack", "--manifest", f"{d}/m.pkl", "--out-dir", f"{d}/p",
              "--manifest-out", f"{d}/p.csv"],
             ["migrate", "--cmd", "python train_non-local_mutiConv_resnet.py "
              "-t 90"],
             ["migrate", "--", "octave", "Main.m"]]
    cv2 = pytest.importorskip("cv2")
    (tmp_path / "v").mkdir()
    w = cv2.VideoWriter(str(tmp_path / "v" / "video1.mp4"),
                        cv2.VideoWriter_fourcc(*"mp4v"), 25, (32, 32))
    for i in range(30):
        w.write(np.full((32, 32, 3), 40 + i, np.uint8))
    w.release()
    steps += [["prepare", "--videos", str(tmp_path / "v"), "--out",
               str(tmp_path / f"frames{i}"), "--size", "24", *extra]
              for i, extra in enumerate(([], ["--pack"]))]
    for argv in steps:
        assert cli.main(argv) == 0, argv
        with pytest.raises(SystemExit):
            # after the command's name: migrate's tokens take the rest
            cli.main(argv[:1] + ["--device", "cpu"] + argv[1:])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        efficacy_study.main(["--work", str(tmp_path / "w"), "--full-scale"])
    assert not (tmp_path / "w").exists()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        efficacy_study.run_study(str(tmp_path / "w"),
                                 scale=efficacy_study.FULL_SCALE)
    assert not (tmp_path / "w").exists()
    assert efficacy_study.run_cli(["synth", "--out-dir", str(tmp_path / "c"),
                                   "--train", "1", "--val", "0", "--test",
                                   "0", "--hw", "8"], device="cpu")
