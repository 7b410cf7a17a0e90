"""Driver entry points of the port.

`entry(device="cuda")`, the counterpart of `__graft_entry__.py:17-45`:
`(fn, (state, clips, memory))` for the flagship forward, TMRNet with
ResNet-50, head tmr, 7 classes, hidden 512, bf16, BN not folded; the
example args are a zero-filled state dict of the model's names and
shapes, clips (2, 10, 224, 224, 3) and memory (2, 30, 512), both bf16, on
`device` (a CPU caller passes "cpu"). `fn(state, clips, memory)` runs the
model in eval mode on those weights and returns the logits (B, 7); on
the card the head launches 1 `time_conv` and 1 `nl_attention` a call.

`dryrun_multichip(n)`, the counterpart of `__graft_entry__.py:48-146`: n
gloo ranks on the CPU, one process each, as a (n/2 x 2) grid where n is
even (tensor parallelism over model groups of 2, JAX's `mp = 2`), else
n x 1, run one stage-2 train step of the flagship architecture
(ResNet-50, the TMR head, hidden 512, f32, 64x64 frames, 2 frames a clip,
window 8, the default dropout) over a seeded global batch of 2 clips a
rank, then one `run_corpus_distributed` pass over 3 short videos (every
rank a data rank). Each rank prints the step's loss summed over the data
ranks; every rank must print the same loss, and it must equal the loss of
one process's step over the same global batch, which this process computes
on one thread as the ranks run, within LOSS_RTOL: f32 rounding through
ResNet-50's 53 train-mode BatchNorms moves this loss by 2.5e-6 relative
between one CPU thread and eight alone, and the ranks' convolutions see
other batch sizes (1.2e-5 apart at n = 2, 2.8e-6 at n = 3, on an 8-core
CPU). Then this process runs the sequence-parallel pass on the weights
the step trained (rank 0's, whole): `VideoInference(devices=)` over dp
CPU shards, `run_video` on 3 dp frames, which must give frames - 2 + 1
clip predictions (JAX's :117-141). Nothing here needs a card or JAX.

    python -m tmrnet_torch.entry [n]
"""

from __future__ import annotations

import argparse
import os
import re
import socket
import subprocess
import sys
from typing import List, Optional

import numpy as np
import torch

CLIPS_PER_RANK, FRAMES, IMG, WINDOW, HIDDEN = 2, 2, 64, 8, 512
# entry()'s example batch: clips of 10 224x224 frames, a 30-row window.
FLAGSHIP_CLIPS, FLAGSHIP_FRAMES, FLAGSHIP_IMG, FLAGSHIP_WINDOW = 2, 10, 224, 30
VIDEO_LENGTHS = (5, 4, 3)
LOSS_RTOL = 1e-4
RANK_TIMEOUT = 600


def entry(device="cuda"):
    """(fn, (state, clips, memory)): the flagship forward and its example
    args on `device`; fn(state, clips, memory) -> logits (B, 7) in bf16."""
    from tmrnet_torch.config import ModelConfig
    from tmrnet_torch.models.tmrnet import build_model

    model = build_model(ModelConfig(backbone="resnet50", head="tmr",
                                    num_classes=7, hidden_dim=HIDDEN,
                                    compute_dtype="bfloat16"), device)
    dev = next(model.parameters()).device
    state = {k: torch.zeros_like(v) for k, v in model.state_dict().items()}
    clips = torch.zeros((FLAGSHIP_CLIPS, FLAGSHIP_FRAMES, FLAGSHIP_IMG,
                         FLAGSHIP_IMG, 3), dtype=torch.bfloat16, device=dev)
    memory = torch.zeros((FLAGSHIP_CLIPS, FLAGSHIP_WINDOW, HIDDEN),
                         dtype=torch.bfloat16, device=dev)

    def fn(state, clips, memory):
        with torch.inference_mode():
            return torch.func.functional_call(model, state, (clips, memory))

    return fn, (state, clips, memory)


def flagship_config():
    from tmrnet_torch.config import (DataConfig, EvalConfig,
                                     ExperimentConfig, MemoryConfig,
                                     ModelConfig)

    return ExperimentConfig(
        data=DataConfig(sequence_length=FRAMES, crop_size=IMG,
                        device_normalize=True),
        model=ModelConfig(backbone="resnet50", head="tmr", hidden_dim=HIDDEN,
                          compute_dtype="float32"),
        memory=MemoryConfig(window=WINDOW),
        eval=EvalConfig(corpus_chunk=8))


def global_batch(world: int, seed: int = 0):
    """The step's uint8 clips, memory windows and labels, for `world`
    ranks."""
    rng = np.random.default_rng(seed)
    b = CLIPS_PER_RANK * world
    return (torch.from_numpy(rng.integers(0, 256, (b, FRAMES, IMG, IMG, 3),
                                          dtype=np.uint8)),
            torch.from_numpy(rng.standard_normal((b, WINDOW, HIDDEN),
                                                 dtype=np.float32)),
            torch.from_numpy(rng.integers(0, 7, b)))


def train_step_loss(world: int, mesh=None, save: Optional[str] = None
                    ) -> float:
    """One SGD step of the flagship TMRNet over the global batch for
    `world` ranks (the rows of this rank's data index under `mesh`, the
    model's slices under its model axis): the loss summed over the data
    ranks. save: a path where rank 0 writes the whole trained weights."""
    from tmrnet_torch.config import TrainConfig
    from tmrnet_torch.data.device_feed import DevicePrep
    from tmrnet_torch.models.tmrnet import build_model, init_state_dict
    from tmrnet_torch.parallel.mesh import (all_reduce_host, broadcast_module,
                                            process_local_bounds)
    from tmrnet_torch.parallel.tensor import shard_model_
    from tmrnet_torch.train.loop import step_generator
    from tmrnet_torch.train.optim import make_optimizer, slow_modules_for_head
    from tmrnet_torch.train.state import TrainState
    from tmrnet_torch.train.steps import make_stage2_steps

    cfg = flagship_config()
    model = build_model(cfg.model, device="cpu")
    model.load_state_dict(init_state_dict(cfg.model, 0))
    if mesh is not None:
        broadcast_module(model, mesh)
        shard_model_(model, mesh)
    state = TrainState(model, make_optimizer(TrainConfig(lr=0.01), model,
                                             slow_modules_for_head("tmr")),
                       mesh=mesh)
    step, _ = make_stage2_steps(
        prep=DevicePrep(cfg.data, "float32", "cpu"), mesh=mesh)
    clips, memory, labels = global_batch(world)
    lo, hi = ((0, len(labels)) if mesh is None else
              process_local_bounds(len(labels), mesh.data_index, mesh.dp))
    m = step(state, clips[lo:hi], memory[lo:hi], labels[lo:hi],
             step_generator(0, 0, 0, torch.device("cpu")))
    loss = np.asarray([float(m["loss"])])
    if mesh is not None:
        loss = all_reduce_host(loss, mesh, data_only=True)
    weights = state.whole_state()[0] if save else None
    if save and (mesh is None or mesh.rank == 0):
        torch.save(weights, save)
    return float(loss[0])


def sp_pass(weights_path: str, dp: int) -> int:
    """The sequence-parallel `run_video` over dp CPU shards on the trained
    weights (the TMR model's trunk and LSTM as the extractor's too), over
    3 dp seeded uint8 frames; returns the clip predictions' count."""
    from tmrnet_torch.eval.infer import VideoInference

    cfg = flagship_config()
    state = torch.load(weights_path)
    extractor = {k: v for k, v in state.items()
                 if k.startswith(("backbone.", "encoder."))}
    engine = VideoInference(cfg, state, extractor, devices=["cpu"] * dp)
    frames = np.random.default_rng(4).integers(
        0, 256, (3 * dp, IMG, IMG, 3), dtype=np.uint8)
    preds, probs = engine.run_video(frames)
    if preds.shape[0] != frames.shape[0] - FRAMES + 1 or not np.isfinite(
            probs).all():
        raise RuntimeError(f"sp video pass: {preds.shape[0]} clip preds for "
                           f"{frames.shape[0]} frames")
    return int(preds.shape[0])


def corpus_pass(mesh) -> List:
    """run_corpus_distributed over VIDEO_LENGTHS seeded uint8 videos with
    seeded TMR and extractor weights."""
    import dataclasses

    from tmrnet_torch.eval.distributed import run_corpus_distributed
    from tmrnet_torch.models.tmrnet import init_state_dict

    cfg = flagship_config()
    state = init_state_dict(cfg.model, 1)
    extractor = init_state_dict(dataclasses.replace(cfg.model, head="lfb"), 2)
    rng = np.random.default_rng(3)
    videos = [rng.integers(0, 256, (n, IMG, IMG, 3), dtype=np.uint8)
              for n in VIDEO_LENGTHS]
    return run_corpus_distributed(cfg, state, extractor, VIDEO_LENGTHS,
                                  lambda i: videos[i], mesh=mesh)


def model_parallel_of(n: int) -> int:
    """JAX's dryrun: tensor parallelism over 2 whenever n is even."""
    return 2 if n % 2 == 0 and n >= 2 else 1


def _rank_main(rank: int, world: int, port: int, save: str) -> int:
    from tmrnet_torch.config import MeshConfig
    from tmrnet_torch.parallel.mesh import (initialize_multihost, make_mesh,
                                            shutdown)

    torch.set_num_threads(1)
    dev = initialize_multihost(f"127.0.0.1:{port}", world, rank,
                               device="cpu", timeout=RANK_TIMEOUT)
    mesh = make_mesh(MeshConfig(model_parallel=model_parallel_of(world)),
                     dev)
    loss = train_step_loss(world, mesh, save)
    print(f"rank {rank}/{world}: mesh {mesh.shape}", flush=True)
    print(f"rank {rank}/{world}: loss {loss!r}", flush=True)
    results = corpus_pass(mesh)
    preds = [p.tolist() for p, _ in results]
    print(f"rank {rank}/{world}: corpus preds {preds}", flush=True)
    shutdown()
    return 0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dryrun_multichip(n: int = 2) -> float:
    """Spawn n gloo ranks on the CPU as a grid (one train step, one corpus
    pass), check their losses against each other and against one process's
    step, then run the sequence-parallel pass on the step's weights.
    Returns the loss; raises if a rank fails or a loss differs."""
    import tempfile

    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    tmp = tempfile.TemporaryDirectory(prefix="dryrun-")
    save = os.path.join(tmp.name, "trained.pt")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "tmrnet_torch.entry", "--rank", str(r),
         "--world", str(n), "--port", str(port), "--save", save], cwd=root,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(n)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=RANK_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        sys.stdout.write(out)
        if p.returncode != 0:
            raise RuntimeError(f"rank {r} of {n} exited {p.returncode}")
    losses = [float(re.search(r"loss (\S+)", o).group(1)) for o in outs]
    preds = [re.search(r"corpus preds (.*)", o).group(1) for o in outs]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        want = train_step_loss(n)
    finally:
        torch.set_num_threads(threads)
    print(f"one process: loss {want!r}, the ranks' relative difference "
          f"{abs(losses[0] - want) / abs(want):.3g} (limit {LOSS_RTOL})",
          flush=True)
    if len(set(losses)) != 1 or len(set(preds)) != 1:
        raise RuntimeError(f"the ranks disagree: losses {losses}")
    if abs(losses[0] - want) > LOSS_RTOL * abs(want):
        raise RuntimeError(f"{n} ranks' loss {losses[0]!r} != one "
                           f"process's {want!r}")
    mp = model_parallel_of(n)
    print(f"dryrun_multichip({n}): mesh={{'data': {n // mp}, 'model': {mp}}} "
          f"loss={losses[0]:.4f} step=1", flush=True)
    dp = n // mp
    with tmp:
        clips = sp_pass(save, dp)
    print(f"dryrun_multichip({n}): sp video pass ok ({3 * dp} frames "
          f"sharded over data={dp}, {clips} clip preds)", flush=True)
    return losses[0]


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("n", nargs="?", type=int, default=2)
    parser.add_argument("--rank", type=int)
    parser.add_argument("--world", type=int)
    parser.add_argument("--port", type=int)
    parser.add_argument("--save")
    args = parser.parse_args(argv)
    if args.rank is not None:
        return _rank_main(args.rank, args.world, args.port, args.save)
    dryrun_multichip(args.n)
    return 0


if __name__ == "__main__":
    sys.exit(main())
