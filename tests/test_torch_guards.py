"""Guards of the port: it imports nothing of JAX or of the JAX package, and
its entry points refuse to run without CUDA unless asked for the CPU."""

import ast
import dataclasses
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
from tmrnet_torch.train.loop import build_lfb_video

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "tmrnet_tpu")
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
            "tmrnet_torch.experimental.int8_gate; "
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
    res = engine.run([(np.zeros((1, 2, 32, 32, 3), np.uint8), np.zeros(1),
                       np.array([3]), 0)], bank.first_rows)
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
    preds, probs = VideoInference(cfg, state, ext, device="cpu").run_video(video)
    assert preds.shape == (2,) and probs.shape == (2, 7)
    stream = StreamingInference(cfg, state, ext, device="cpu")
    out = stream.step(stream.init_state(2), video[:2])
    assert all(t.device.type == "cpu" for t in out[1:])


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
