"""Deployable artifacts: the clip step and the stream step exported with
`torch.export`, the weights held in the program as constants.

Port of `tmrnet_tpu/eval/saved.py` (`export_inference` :34-107,
`export_stream` :110-165, `ArtifactStreamEngine` :168-226, `save_artifact`
:229-237, `Artifact` :240-255, `load_artifact` :258-265). A deployment
host runs an artifact with torch and the port's kernels, and none of the
model's code or checkpoints: `torch.export.load` gives back the traced
program (a `.pt2` archive), and a JSON sidecar beside it (`<path>.json`)
says how to call it. The program calls the kernels as the ops
`torch.ops.tmrnet.*`, so `load_artifact` imports `tmrnet_torch.ops`, which
registers them.

An export builds the model (or the stream engine's two) from the state
dicts on `device`, turns its parameters and buffers into plain tensor
attributes (`_as_constants`), runs the step once on zeros (which makes
every kernel-layout copy of the weights, `kernels/prepared.py`) and traces
it: the program holds as constants the weights its graph reads, the
prepared copies in place of the originals they were made from, and each
kernel as one node.

Where JAX lowers one artifact for several platforms (`cpu,tpu`), a
`torch.export` program keeps its constants on the device it was exported
on: `device` ("cuda" by default, "cpu" for the tests) is part of the
artifact, and a loader runs it there.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from tmrnet_torch.config import ExperimentConfig
from tmrnet_torch.data.device_feed import DevicePrep
from tmrnet_torch.device import resolve_device, torch_dtype
from tmrnet_torch.eval.stream import StreamState, reset_state

_SIDECAR = ".json"


def _wire(cfg: ExperimentConfig) -> torch.dtype:
    return torch.uint8 if cfg.data.device_normalize else torch.float32


def _wire_name(cfg: ExperimentConfig) -> str:
    return ("uint8+device-normalize" if cfg.data.device_normalize
            else "float32 pre-normalized")


def _inputs(args: Sequence[torch.Tensor]):
    return [{"shape": list(a.shape),
             "dtype": str(a.dtype).replace("torch.", "")} for a in args]


def _producer(device: torch.device) -> dict:
    """The sidecar's record of what made the artifact (JAX's jax_version
    and platforms)."""
    meta = {"torch_version": torch.__version__, "device": str(device)}
    if device.type == "cuda":
        meta["card"] = torch.cuda.get_device_name(device)
    return meta


def _as_constants(module: nn.Module) -> None:
    """Every parameter and buffer of `module` and its children as a plain,
    detached tensor attribute: torch.export holds those as constants and
    keeps only the ones its graph reads."""
    for m in module.modules():
        for table in (m._parameters, m._buffers):
            for name in [n for n, t in table.items() if t is not None]:
                t = table.pop(name)
                m._non_persistent_buffers_set.discard(name)
                setattr(m, name, t.detach())


def _export(step: nn.Module, args: Sequence[torch.Tensor]):
    """The step with its weights as constants, run once on `args` (real
    tensors: the prepared copies are made from the weights) and traced,
    both with grad disabled, as inference runs. The program keeps no
    example inputs: `torch.export.save` would write them (a call's worth
    of zeros) into the artifact."""
    _as_constants(step)
    with torch.no_grad():
        step(*args)
        program = torch.export.export(step, tuple(args))
    program.example_inputs = None
    return program


class _ClipStep(nn.Module):
    """The clip engine's step (`eval/infer.py::ClipInference.infer`) as one
    module: the wire's clips through DevicePrep and the model, then for the
    scored heads an f32 softmax and its argmax."""

    def __init__(self, model: nn.Module, prep: DevicePrep, head: str):
        super().__init__()
        self.model = model
        self.prep = prep
        self.head = head

    def forward(self, clips: torch.Tensor,
                memory: Optional[torch.Tensor] = None):
        x = self.prep(clips)
        if self.head == "lfb":
            return self.model(x).float()
        if self.head == "stage1":
            logits = self.model(x)[:, -1]      # the clip's last frame
        else:
            logits = self.model(x, memory)
        probs = torch.softmax(logits.float(), dim=-1)
        return probs.argmax(dim=-1), probs


def export_inference(cfg: ExperimentConfig, state_dict, batch: int,
                     device="cuda", fused_kernel: str = "block"
                     ) -> Tuple[torch.export.ExportedProgram, dict]:
    """Export one batched inference step of head `cfg.model.head` with the
    weights of `state_dict` (folded where `cfg.model.folded`) on `device`;
    returns (program, sidecar).

    The program's inputs have fixed shapes (export one artifact per batch
    size you deploy):
      clips:  (batch, seq, crop, crop, 3), uint8 under data.device_normalize
              (normalization runs inside), float32 pre-normalized otherwise;
      memory: (batch, memory.window, hidden) float32, heads tmr and nl_only
              only (each clip's window of bank rows).
    It returns for tmr, nl_only and stage1 (preds (batch,) int64, probs
    (batch, classes) float32), stage1 scoring the clip's last frame; for
    lfb the (batch, hidden) float32 clip features. fused_kernel: the folded
    identity blocks' kernel, "block" or "tiled" (`models/resnet.py`)."""
    from tmrnet_torch.eval.infer import load_weights

    dev = resolve_device(device)
    head = cfg.model.head
    if head not in ("tmr", "nl_only", "stage1", "lfb"):
        raise ValueError(f"unknown head {head!r}")
    model = load_weights(cfg.model, state_dict, dev, fused_kernel)
    step = _ClipStep(model, DevicePrep(cfg.data, cfg.model.compute_dtype,
                                       dev), head)
    crop = cfg.data.crop_size
    args = [torch.zeros((batch, cfg.data.sequence_length, crop, crop, 3),
                        dtype=_wire(cfg), device=dev)]
    if head in ("tmr", "nl_only"):
        args.append(torch.zeros((batch, cfg.memory.window,
                                 cfg.model.hidden_dim), device=dev))
    program = _export(step, args)
    meta = {
        "head": head,
        "batch": batch,
        "inputs": _inputs(args),
        "num_classes": cfg.model.num_classes,
        "window": cfg.memory.window,
        "hidden_dim": cfg.model.hidden_dim,
        "wire": _wire_name(cfg),
        **_producer(dev),
        "config": json.loads(cfg.to_json()),
    }
    return program, meta


class _StreamStep(nn.Module):
    """`StreamingInference._step_impl` over flat tensors: the state's four
    rings, the frames and the active mask in; the new state's four, preds,
    probs and valid out."""

    def __init__(self, engine):
        super().__init__()
        self.extractor = engine.extractor
        self.model = engine.model
        self.engine = engine

    def forward(self, ext_ring, tmr_ring, bank_ring, count, frames, active):
        new, preds, probs, valid = self.engine._step_impl(
            StreamState(ext_ring, tmr_ring, bank_ring, count), frames, active)
        return (new.ext_ring, new.tmr_ring, new.bank_ring, new.count, preds,
                probs, valid)


def export_stream(cfg: ExperimentConfig, state_dict, extractor_state_dict,
                  num_slots: int, device="cuda"
                  ) -> Tuple[torch.export.ExportedProgram, dict]:
    """Export the serve daemon's step (`eval/stream.py`) for a fixed slot
    count: both trunks, both LSTMs, the memory head and the ring updates
    in one program, the weights held in it, as the engine `serve` builds
    from the same config and weights (folded where `cfg.model.folded`).
    `serve --artifact` runs it with no model code or checkpoint;
    `ArtifactStreamEngine` adapts it to serve_loop's engine. Export one
    artifact per slot count you deploy."""
    from tmrnet_torch.eval.stream import StreamingInference

    eng = StreamingInference(cfg, state_dict, extractor_state_dict,
                             device=device)
    b, dev, crop = int(num_slots), eng.device, cfg.data.crop_size
    ring = lambda n, f: torch.zeros((b, n, f), dtype=eng.cdt, device=dev)
    args = (ring(eng.seq, eng.feature_dim), ring(eng.seq, eng.feature_dim),
            ring(eng.window, eng.hidden),
            torch.zeros((b,), dtype=torch.int32, device=dev),
            torch.zeros((b, crop, crop, 3), dtype=_wire(cfg), device=dev),
            torch.zeros((b,), dtype=torch.bool, device=dev))
    program = _export(_StreamStep(eng), args)
    meta = {
        "kind": "stream",
        "slots": b,
        "seq": eng.seq,
        "window": eng.window,
        "hidden": eng.hidden,
        "feature_dim": eng.feature_dim,
        "compute_dtype": cfg.model.compute_dtype,
        "num_classes": cfg.model.num_classes,
        "inputs": _inputs(args),
        "wire": _wire_name(cfg),
        **_producer(dev),
        "config": json.loads(cfg.to_json()),
    }
    return program, meta


class Artifact:
    """A loaded artifact: `art(clips[, memory])`, or the stream step's six
    inputs, runs it on its device (numpy arrays or tensors in; each input's
    shape and dtype checked against the program's); `meta` is its sidecar
    ({} without one)."""

    def __init__(self, program: torch.export.ExportedProgram,
                 meta: Optional[dict]):
        self.program = program
        self.meta = meta or {}
        tensors = list(program.state_dict.values()) + [
            t for t in program.constants.values()
            if isinstance(t, torch.Tensor)]
        self.device = tensors[0].device if tensors else torch.device("cpu")
        user = set(program.graph_signature.user_inputs)
        self.inputs = [(tuple(n.meta["val"].shape), n.meta["val"].dtype)
                       for n in program.graph.nodes
                       if n.op == "placeholder" and n.name in user]
        self._run = program.module()

    @property
    def head(self) -> str:
        return self.meta.get("head", "")

    def __call__(self, *args):
        if len(args) != len(self.inputs):
            raise ValueError(f"the artifact takes {len(self.inputs)} inputs, "
                             f"got {len(args)}")
        tensors = []
        for i, (a, (shape, dtype)) in enumerate(zip(args, self.inputs)):
            t = (a if isinstance(a, torch.Tensor)
                 else torch.from_numpy(np.ascontiguousarray(a)))
            if tuple(t.shape) != shape or t.dtype != dtype:
                raise ValueError(f"input {i}: the artifact takes {dtype} "
                                 f"{list(shape)}, got {t.dtype} "
                                 f"{list(t.shape)}")
            tensors.append(t.to(self.device))
        with torch.inference_mode():
            return self._run(*tensors)


class ArtifactStreamEngine:
    """serve_loop's engine over an `export_stream` artifact. `step` runs
    the artifact; `init_state` and `reset_streams` are weight-free tensor
    ops, so a daemon needs only torch, the port's kernels and the
    artifact. One device (the artifact's), no mesh; the slot count is the
    artifact's."""

    def __init__(self, artifact: Artifact):
        m = artifact.meta
        if m.get("kind") != "stream":
            raise ValueError(
                "not a stream artifact (export with `export-model "
                f"--stream`); sidecar kind={m.get('kind')!r}")
        self._art = artifact
        self.meta = m
        self.slots = int(m["slots"])
        self.seq = int(m["seq"])
        self.window = int(m["window"])
        self.hidden = int(m["hidden"])
        self.feature_dim = int(m["feature_dim"])
        self.cdt = torch_dtype(m["compute_dtype"])
        self.device = artifact.device
        self._all_active = torch.ones((self.slots,), dtype=torch.bool,
                                      device=self.device)

    def init_state(self, num_streams: int) -> StreamState:
        if int(num_streams) != self.slots:
            raise ValueError(f"artifact was exported with {self.slots} "
                             f"slots (asked for {num_streams}); re-export "
                             "for a different slot count")
        b, dev = self.slots, self.device
        ring = lambda n, f: torch.zeros((b, n, f), dtype=self.cdt, device=dev)
        return StreamState(
            ext_ring=ring(self.seq, self.feature_dim),
            tmr_ring=ring(self.seq, self.feature_dim),
            bank_ring=ring(self.window, self.hidden),
            count=torch.zeros((b,), dtype=torch.int32, device=dev))

    def _mask(self, mask) -> torch.Tensor:
        return torch.as_tensor(np.asarray(mask, bool)).to(self.device)

    @torch.inference_mode()
    def reset_streams(self, state: StreamState, mask) -> StreamState:
        return reset_state(state, self._mask(mask))

    def step(self, state: StreamState, frames, active=None):
        """As `StreamingInference.step`: frames (slots, H, W, 3) of the
        wire's dtype, host or device; active optional (slots,) bool."""
        if not isinstance(frames, torch.Tensor):
            frames = torch.from_numpy(np.ascontiguousarray(frames))
        act = self._all_active if active is None else self._mask(active)
        e, t, bank, count, preds, probs, valid = self._art(
            state.ext_ring, state.tmr_ring, state.bank_ring, state.count,
            frames, act)
        return StreamState(e, t, bank, count), preds, probs, valid


def save_artifact(path: str, program: torch.export.ExportedProgram,
                  meta: dict) -> int:
    """Write the program (`torch.export.save`) and its JSON sidecar, each
    through a temporary file renamed into place; returns the program's
    bytes."""
    for p, write in ((path, lambda f: torch.export.save(program, f)),
                     (path + _SIDECAR,
                      lambda f: f.write(json.dumps(meta, indent=1).encode()))):
        tmp = p + ".tmp"
        with open(tmp, "wb") as f:
            write(f)
        os.replace(tmp, p)
    return os.path.getsize(path)


def load_artifact(path: str) -> Artifact:
    import tmrnet_torch.ops  # noqa: F401  (registers the ops it calls)

    program = torch.export.load(path)
    meta = None
    if os.path.exists(path + _SIDECAR):
        with open(path + _SIDECAR) as f:
            meta = json.load(f)
    return Artifact(program, meta)
