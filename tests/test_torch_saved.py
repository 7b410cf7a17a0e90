"""The port's artifacts (`tmrnet_torch/eval/saved.py`) on the CPU: each
exported clip step and stream step, saved and loaded back, against the
port's eager engine on the same inputs (max |diff| <= 1e-6; the same ops
in the same order, so 0 is expected) and against the JAX package's own
`export_inference` / `export_stream` artifact from the same weights, moved
across by `from_jax_variables` (1e-4: f32 on both, the same math summed in
another order by XLA and PyTorch's CPU kernels). The exported graph holds
each kernel as one `tmrnet.*` node.

Tiny widths: a ResNet of stage sizes (2, 1) and width 8, so that stage 1's
second block is a stride-1 identity block, which the folded model sends
to `fused_bottleneck` (or `fused_bottleneck_tiled`); hidden 16, window 3,
4-frame clips of 32x32."""

import collections
import dataclasses
import json
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tmrnet_tpu.config import DataConfig as JaxDataConfig
from tmrnet_tpu.config import ExperimentConfig as JaxExperimentConfig
from tmrnet_tpu.config import MemoryConfig as JaxMemoryConfig
from tmrnet_tpu.config import ModelConfig as JaxModelConfig
from tmrnet_tpu.eval import saved as jax_saved
from tmrnet_tpu.models.fold_bn import fold_variables as jax_fold_variables
from tmrnet_torch.config import DataConfig, ExperimentConfig, MemoryConfig, ModelConfig
from tmrnet_torch.data.device_feed import DevicePrep
from tmrnet_torch.eval.infer import ClipInference, load_weights
from tmrnet_torch.eval.saved import (ArtifactStreamEngine, export_inference,
                                     export_stream, load_artifact,
                                     save_artifact)
from tmrnet_torch.eval.stream import StreamingInference
from tmrnet_torch.memory.lfb import FeatureBank
from tmrnet_torch.models.convert import from_jax_variables, random_variables
from tmrnet_torch.models.fold_bn import fold_variables

torch.set_num_threads(2)

EXACT, JAX_TOL = 1e-6, 1e-4
SEQ, HW, HID, WIN, CLASSES, BATCH = 4, 32, 16, 3, 7, 2
MODEL = dict(backbone="resnet50", stage_sizes=(2, 1), width=8,
             hidden_dim=HID, num_classes=CLASSES, compute_dtype="float32")


def _configs(head, device_normalize=False, folded=False):
    model = dict(MODEL, head=head, folded=folded)
    data = dict(crop_size=HW, resize=HW, sequence_length=SEQ,
                device_normalize=device_normalize)
    return (ExperimentConfig(model=ModelConfig(**model),
                             data=DataConfig(**data),
                             memory=MemoryConfig(window=WIN)),
            JaxExperimentConfig(model=JaxModelConfig(**model),
                                data=JaxDataConfig(**data),
                                memory=JaxMemoryConfig(window=WIN)))


def _weights(head, seed, folded=False):
    """(port state dict, JAX variables) of the same random weights, BN
    folded by each package's own fold where `folded`."""
    variables = random_variables(ModelConfig(**dict(MODEL, head=head)), seed)
    state = from_jax_variables(variables)
    jax_vars = jax.tree_util.tree_map(jnp.asarray, variables)
    if folded:
        state, jax_vars = fold_variables(state), jax_fold_variables(jax_vars)
    return state, jax_vars


def _inputs(cfg, seed):
    rng = np.random.default_rng(seed)
    shape = (BATCH, SEQ, HW, HW, 3)
    clips = (rng.integers(0, 256, shape, dtype=np.uint8)
             if cfg.data.device_normalize
             else rng.standard_normal(shape).astype(np.float32))
    memory = rng.standard_normal((BATCH, WIN, HID)).astype(np.float32)
    return clips, memory


def _kernel_nodes(program):
    return collections.Counter(
        str(n.target).split(".")[1] for n in program.graph.nodes
        if n.op == "call_function" and str(n.target).startswith("tmrnet."))


def _round_trip(tmp_path, program, meta, name="a.pt2"):
    path = str(tmp_path / name)
    assert save_artifact(path, program, meta) == os.path.getsize(path) > 0
    return load_artifact(path)


def _eager(cfg, state, clips, memory):
    """The port's eager engines on the same inputs: ClipInference over a
    bank that holds the memory windows (heads tmr, nl_only, stage1), or the
    extractor's features (head lfb)."""
    head = cfg.model.head
    if head == "lfb":
        model = load_weights(cfg.model, state, "cpu", "block")
        prep = DevicePrep(cfg.data, cfg.model.compute_dtype, "cpu")
        with torch.no_grad():
            return model(prep(torch.from_numpy(clips))).float()
    bank = FeatureBank(torch.from_numpy(memory.reshape(-1, HID)),
                       torch.zeros(BATCH * WIN, dtype=torch.int32))
    engine = ClipInference(cfg, state, bank, device="cpu")
    idx = torch.arange(BATCH * WIN).view(BATCH, WIN)
    return engine.infer(torch.from_numpy(clips),
                        None if head == "stage1" else idx)


def _jax_artifact(jcfg, jax_vars, tmp_path):
    blob, meta = jax_saved.export_inference(jcfg, jax_vars, BATCH,
                                            platforms=("cpu",))
    path = str(tmp_path / "jax.bin")
    jax_saved.save_artifact(path, blob, meta)
    return jax_saved.load_artifact(path)


@pytest.mark.parametrize("head,device_normalize,folded", [
    ("tmr", False, False), ("nl_only", False, False),
    ("stage1", False, False), ("lfb", False, False),
    ("tmr", True, True), ("stage1", True, True)],
    ids=["tmr", "nl_only", "stage1", "lfb", "tmr-u8-folded",
         "stage1-u8-folded"])
def test_clip_artifact_equals_eager_and_jax(head, device_normalize, folded,
                                            tmp_path):
    cfg, jcfg = _configs(head, device_normalize, folded)
    state, jax_vars = _weights(head, 21, folded)
    program, meta = export_inference(cfg, state, BATCH, device="cpu")
    want_nodes = {"nl_attention": 1, "time_conv": 1} if head == "tmr" else (
        {"nl_attention": 1} if head == "nl_only" else {})
    if folded:
        want_nodes["fused_bottleneck"] = 1
    assert _kernel_nodes(program) == want_nodes
    art = _round_trip(tmp_path, program, meta)
    assert art.head == head and art.device == torch.device("cpu")
    clips, memory = _inputs(cfg, 22)
    args = (clips,) if head in ("stage1", "lfb") else (clips, memory)
    got = art(*args)
    want = _eager(cfg, state, clips, memory)
    jax_got = _jax_artifact(jcfg, jax_vars, tmp_path)(*args)
    if head == "lfb":
        assert got.shape == (BATCH, HID) and got.dtype == torch.float32
        assert float((got - want).abs().max()) <= EXACT
        np.testing.assert_allclose(got.numpy(), np.asarray(jax_got),
                                   rtol=JAX_TOL, atol=JAX_TOL)
        return
    preds, probs = got
    assert probs.shape == (BATCH, CLASSES) and probs.dtype == torch.float32
    assert float((probs - want[1]).abs().max()) <= EXACT
    assert torch.equal(preds, want[1].argmax(-1))
    np.testing.assert_allclose(probs.numpy(), np.asarray(jax_got[1]),
                               rtol=JAX_TOL, atol=JAX_TOL)


def test_fold_bn_and_tiled_artifacts_match_the_unfolded(tmp_path):
    """A folded artifact (fused_bottleneck) and a tiled one
    (fused_bottleneck_tiled) against the unfolded model's artifact, whose
    graph holds no bottleneck op: within 2e-5 (f32 folding rounds)."""
    cfg, _ = _configs("tmr")
    state, _ = _weights("tmr", 23)
    clips, memory = _inputs(cfg, 24)
    plain = _round_trip(tmp_path, *export_inference(cfg, state, BATCH,
                                                    device="cpu"), "p.pt2")
    fcfg = cfg.replace(model=dataclasses.replace(cfg.model, folded=True))
    for kernel in ("block", "tiled"):
        program, meta = export_inference(fcfg, fold_variables(state), BATCH,
                                         device="cpu", fused_kernel=kernel)
        name = "fused_bottleneck" + ("_tiled" if kernel == "tiled" else "")
        assert _kernel_nodes(program)[name] == 1
        got = _round_trip(tmp_path, program, meta, f"{kernel}.pt2")
        np.testing.assert_allclose(got(clips, memory)[1].numpy(),
                                   plain(clips, memory)[1].numpy(),
                                   rtol=2e-5, atol=2e-5)


def test_artifact_holds_prepared_weights_not_their_sources():
    """The kernels' copies of the weights are the program's constants; the
    parameters they were made from are not in it."""
    cfg, _ = _configs("tmr", folded=True)
    program, _ = export_inference(cfg, _weights("tmr", 25, True)[0], BATCH,
                                  device="cpu")
    names = set(program.constants) | set(program.state_dict)
    for gone in ("model.time_conv.conv_k3.weight",
                 "model.backbone.layer1_1.conv2.weight"):
        assert gone not in names
    assert "model.backbone.layer1_0.conv2.weight" in names  # a projection block


def test_wrong_inputs_and_sidecar(tmp_path):
    cfg, _ = _configs("tmr", device_normalize=True)
    program, meta = export_inference(cfg, _weights("tmr", 26)[0], BATCH,
                                     device="cpu")
    art = _round_trip(tmp_path, program, meta)
    clips, memory = _inputs(cfg, 27)
    with pytest.raises(ValueError, match="takes"):
        art(np.zeros((5, SEQ, HW, HW, 3), np.uint8), memory)   # batch
    with pytest.raises(ValueError, match="takes"):
        art(clips.astype(np.float32), memory)                   # wire dtype
    with pytest.raises(ValueError, match="inputs"):
        art(clips)
    side = json.loads((tmp_path / "a.pt2.json").read_text())
    assert side["inputs"] == [
        {"shape": [BATCH, SEQ, HW, HW, 3], "dtype": "uint8"},
        {"shape": [BATCH, WIN, HID], "dtype": "float32"}]
    assert (side["head"], side["batch"], side["num_classes"], side["window"],
            side["hidden_dim"], side["wire"], side["device"]) == (
        "tmr", BATCH, CLASSES, WIN, HID, "uint8+device-normalize", "cpu")
    assert side["torch_version"] == torch.__version__ and "card" not in side
    assert ExperimentConfig.from_json(json.dumps(side["config"])) == cfg
    os.remove(tmp_path / "a.pt2.json")          # the program alone still runs
    bare = load_artifact(str(tmp_path / "a.pt2"))
    assert bare.meta == {} and bare.head == ""
    assert torch.equal(bare(clips, memory)[1], art(clips, memory)[1])


STREAMS, STEPS = 3, 13
INACTIVE = {(1, 5), (1, 6), (1, 7), (2, 11)}
RESET_AT, RESET_SLOT = 8, 0


@pytest.mark.parametrize("head,folded", [("tmr", True), ("nl_only", False)])
def test_stream_artifact_equals_the_engine_and_jax(head, folded, tmp_path):
    cfg, jcfg = _configs(head, device_normalize=True, folded=folded)
    state, jax_vars = _weights(head, 31, folded)
    extractor, jax_ext = _weights("lfb", 32, folded)
    program, meta = export_stream(cfg, state, extractor, STREAMS,
                                  device="cpu")
    nodes = _kernel_nodes(program)
    assert nodes["nl_attention"] == 1
    assert nodes["time_conv"] == (head == "tmr")
    assert nodes["fused_bottleneck"] == (2 if folded else 0)   # both trunks
    art = ArtifactStreamEngine(_round_trip(tmp_path, program, meta))
    assert (art.slots, art.seq, art.window, art.hidden, art.cdt) == (
        STREAMS, SEQ, WIN, HID, torch.float32)
    live = StreamingInference(cfg, state, extractor, device="cpu")
    blob, jmeta = jax_saved.export_stream(jcfg, jax_vars, jax_ext, STREAMS,
                                          platforms=("cpu",))
    jax_saved.save_artifact(str(tmp_path / "js.bin"), blob, jmeta)
    jax_art = jax_saved.ArtifactStreamEngine(
        jax_saved.load_artifact(str(tmp_path / "js.bin")))
    s_live, s_art, s_jax = (e.init_state(STREAMS)
                            for e in (live, art, jax_art))
    frames = np.random.default_rng(33).integers(
        0, 256, (STEPS, STREAMS, HW, HW, 3), dtype=np.uint8)
    valid_seen = 0
    for t in range(STEPS):
        if t == RESET_AT:
            mask = [s == RESET_SLOT for s in range(STREAMS)]
            s_live = live.reset_streams(s_live, mask)
            s_art = art.reset_streams(s_art, mask)
            s_jax = jax_art.reset_streams(s_jax, mask)
        active = np.array([(s, t) not in INACTIVE for s in range(STREAMS)])
        s_live, p1, pr1, v1 = live.step(s_live, frames[t], active)
        s_art, p2, pr2, v2 = art.step(s_art, frames[t], active)
        s_jax, p3, pr3, v3 = jax_art.step(s_jax, frames[t], active)
        assert torch.equal(v1, v2) and torch.equal(p1, p2)
        assert float((pr1 - pr2).abs().max()) <= EXACT
        for a, b in zip((s_live.ext_ring, s_live.tmr_ring, s_live.bank_ring,
                         s_live.count),
                        (s_art.ext_ring, s_art.tmr_ring, s_art.bank_ring,
                         s_art.count)):
            assert float((a.double() - b.double()).abs().max()) <= EXACT
        np.testing.assert_array_equal(v2.numpy(), np.asarray(v3))
        np.testing.assert_allclose(pr2.numpy(), np.asarray(pr3),
                                   rtol=JAX_TOL, atol=JAX_TOL)
        valid_seen += int(v2.sum())
    assert valid_seen >= 10
    with pytest.raises(ValueError, match="slots"):
        art.init_state(STREAMS + 1)


def test_stream_artifact_refusals(tmp_path):
    cfg, _ = _configs("tmr")
    clip = _round_trip(tmp_path, *export_inference(
        cfg, _weights("tmr", 34)[0], BATCH, device="cpu"))
    with pytest.raises(ValueError, match="not a stream artifact"):
        ArtifactStreamEngine(clip)
    with pytest.raises(ValueError, match="memory head"):
        export_stream(_configs("stage1")[0], _weights("stage1", 35)[0],
                      _weights("lfb", 36)[0], 2, device="cpu")
