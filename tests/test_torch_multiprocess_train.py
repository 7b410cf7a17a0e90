"""Data-parallel training over gloo ranks on the CPU against one process.

Two OS processes join a gloo group over a free localhost port
(`parallel/mesh.py::initialize_multihost`) and each trains on its rows of
the same global batches; everything is held against the port in one
process over the whole global batch, in f32:

- train steps (stage 1 and stage 2, a tiny backbone in train-mode
  BatchNorm, class weights, a padded row): both loss reductions,
  grad_accum=2, grad_clip, and dropout 0.2: every rank's weights, running
  statistics and summed loss within 1e-5 of one process's; and that
  one-process step against JAX's single-device step at dropout 0;
- `train_stage1` with the loaders' local rows: the epoch statistics of one
  process, one checkpoint a step written by rank 0, and a resume;
- a SIGTERM to one rank stops both at the same step, with the replay
  checkpoint saved.
"""

import dataclasses
import json
import os
import pathlib
import signal
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from tmrnet_torch.config import (DataConfig, ExperimentConfig, MemoryConfig,
                                 ModelConfig, TrainConfig)
from tmrnet_torch.data.manifests import Manifest, VideoRecord
from tmrnet_torch.data.pipeline import ClipDataset
from tmrnet_torch.data.transforms import EvalTransform, TrainTransform
from tmrnet_torch.models.tmrnet import build_model, init_state_dict
from tmrnet_torch.train.optim import make_optimizer, slow_modules_for_head
from tmrnet_torch.train.state import TrainState
from tmrnet_torch.train.steps import make_stage1_steps, make_stage2_steps

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
B, T, HW, HID, WIN, NCLS = 4, 3, 32, 16, 4, 5
WORLD = 2
CHILD_TIMEOUT = 120
MODEL = dict(backbone="tiny", stage_sizes=(1, 1), width=8, hidden_dim=HID,
             num_classes=NCLS, compute_dtype="float32", dropout_stage1=0.0,
             dropout_head=0.0, dropout_nl=0.0)
TRAIN = dict(optimizer="sgd", lr=0.05, momentum=0.9, weight_decay=5e-4)
CLASS_WEIGHTS = np.linspace(0.5, 1.5, NCLS).astype(np.float32)
# name -> (head, loss reduction, grad_accum, grad_clip, dropout)
CASES = {
    "stage1-sum": ("stage1", "sum", 1, 0.0, 0.0),
    "stage1-mean": ("stage1", "mean", 1, 0.0, 0.0),
    "tmr-sum": ("tmr", "sum", 1, 0.0, 0.0),
    "tmr-mean": ("tmr", "mean", 1, 0.0, 0.0),
    "tmr-accum2": ("tmr", "sum", 2, 0.0, 0.0),
    "stage1-accum2-mean": ("stage1", "mean", 2, 0.0, 0.0),
    "stage1-clip": ("stage1", "sum", 1, 0.5, 0.0),
    "tmr-clip": ("tmr", "sum", 1, 0.05, 0.0),
    "stage1-dropout": ("stage1", "sum", 1, 0.0, 0.2),
    "tmr-dropout": ("tmr", "sum", 1, 0.0, 0.2),
}
STEPS = 4           # micro-steps a case (two optimizer steps at accum 2)
# train_stage1 over packed videos: 13 steps an epoch (54 clips, batch 4)
TRAIN_LENGTHS, VAL_LENGTHS = (30, 28), (9, 6)
PREEMPT_AT = 3      # rank 1 signals itself after this many steps


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(mode, world, *args, timeout=CHILD_TIMEOUT):
    """`world` child processes running `_child(mode, rank, world, port,
    *args)` of this module; their outputs, each asserted to exit 0."""
    port = free_port()
    code = ("import sys; sys.path[:0] = sys.argv[1:3]; "
            "import test_torch_multiprocess_train as t; "
            "t._child(*sys.argv[3:])")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, str(ROOT), str(ROOT / "tests"), mode,
         str(r), str(world), str(port), *map(str, args)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{out}"
    return outs


def _join(rank, world, port):
    from tmrnet_torch.parallel.mesh import initialize_multihost, make_mesh

    torch.set_num_threads(1)
    dev = initialize_multihost(f"127.0.0.1:{port}", world, rank,
                               device="cpu", timeout=60)
    return make_mesh(device=dev)


def _child(mode, rank, world, port, *args):
    rank, world = int(rank), int(world)
    mesh = _join(rank, world, port)
    if mode == "steps":
        out = {name: run_case(name, mesh) for name in CASES}
        torch.save(out, os.path.join(args[0], f"rank{rank}.pt"))
    elif mode in ("fit", "preempt"):
        fit_child(mode, mesh, *args)
    from tmrnet_torch.parallel.mesh import shutdown

    shutdown()


def global_batch(seed, head):
    rng = np.random.RandomState(seed)
    clips = rng.randint(0, 256, (B, T, HW, HW, 3)).astype(np.uint8)
    memory = rng.randn(B, WIN, HID).astype(np.float32)
    labels = rng.randint(0, NCLS, B)
    if seed % 2:
        labels[-1] = -1                 # a padded row
    args = (torch.from_numpy(clips),)
    if head != "stage1":
        args += (torch.from_numpy(memory),)
    return args, torch.from_numpy(labels)


def run_case(name, mesh=None, dtype=torch.float32):
    """A case's STEPS micro-steps over the global batches (the rows of
    this rank's data index under a mesh, the model's slices under its
    model axis): (the loss of each summed over the data ranks, the final
    whole state dict). dtype float64: the same steps with the model and
    its inputs in f64."""
    from tmrnet_torch.data.device_feed import DevicePrep
    from tmrnet_torch.parallel.mesh import (all_reduce_host,
                                            process_local_bounds)
    from tmrnet_torch.parallel.tensor import shard_model_
    from tmrnet_torch.train.loop import step_generator

    head, reduction, accum, clip, drop = CASES[name]
    cfg = ModelConfig(**dict(MODEL, head=head, dropout_stage1=drop,
                             dropout_head=drop, dropout_nl=drop))
    model = build_model(cfg, device="cpu")
    model.load_state_dict(init_state_dict(cfg, 3))
    if dtype == torch.float64:
        model.double()
        for module in model.modules():
            if hasattr(module, "compute_dtype"):
                module.compute_dtype = dtype
    shard_model_(model, mesh)
    state = TrainState(model, make_optimizer(TrainConfig(**TRAIN), model,
                                             slow_modules_for_head(head)),
                       grad_accum=accum, grad_clip=clip, mesh=mesh)
    make = make_stage1_steps if head == "stage1" else make_stage2_steps
    step, _ = make(CLASS_WEIGHTS, reduction, prep=DevicePrep(
        DataConfig(device_normalize=True), dtype, "cpu"), mesh=mesh)
    lo, hi = (0, B) if mesh is None else process_local_bounds(
        B, mesh.data_index, mesh.dp)
    losses = []
    for i in range(STEPS):
        args, labels = global_batch(40 + i, head)
        m = step(state, *(a[lo:hi] for a in args), labels[lo:hi],
                 step_generator(0, 0, i, torch.device("cpu")))
        loss = m["loss"].detach().numpy().astype(np.float64)
        if mesh is not None:
            loss = all_reduce_host(loss, mesh, data_only=True)
        losses.append(float(loss))
    return losses, {k: v.clone() for k, v in state.whole_state()[0].items()}


@pytest.fixture(scope="module")
def two_rank_steps(tmp_path_factory):
    out = tmp_path_factory.mktemp("steps")
    run_ranks("steps", WORLD, out)
    return [torch.load(out / f"rank{r}.pt") for r in range(WORLD)]


@pytest.mark.parametrize("name", list(CASES))
def test_two_rank_step_equals_one_process(two_rank_steps, name):
    """Each rank's weights, running statistics and the summed loss after
    the case's steps equal one process's over the global batches to 1e-5
    (rtol and atol), but where the one-process f32 step itself lands
    further than that from the same steps in f64: there, a tensor whose
    gradient sums values that cancel (the stem conv's, a sum over the
    image times the input gradient of a train-mode BatchNorm, which sums
    to zero), the ranks' f32 step, which sums in another order, lands
    within twice that distance of it. The weights moved, so the steps did
    something."""
    losses, want = run_case(name)
    before = init_state_dict(ModelConfig(**dict(MODEL,
                                                head=CASES[name][0])), 3)
    assert any(not torch.equal(want[k], before[k]) for k in before)
    exact = {}
    for r, ranks in enumerate(two_rank_steps):
        got_losses, got = ranks[name]
        np.testing.assert_allclose(got_losses, losses, rtol=1e-5, atol=1e-6,
                                   err_msg=f"rank {r}")
        for k, v in want.items():
            g, w = got[k].double().numpy(), v.double().numpy()
            if np.allclose(g, w, rtol=1e-5, atol=1e-5):
                continue
            if not exact:
                exact.update(run_case(name, dtype=torch.float64)[1])
            floor = float(np.abs(w - exact[k].double().numpy()).max())
            assert floor > 1e-5 and np.abs(g - w).max() <= 2 * floor, (
                f"rank {r} {k}: {np.abs(g - w).max()} from one process, "
                f"which is {floor} from f64")
    # every rank holds the same state
    for k in want:
        assert torch.equal(two_rank_steps[0][name][1][k],
                           two_rank_steps[1][name][1][k]), k


@pytest.mark.parametrize("head", ["stage1", "tmr"])
def test_one_process_step_equals_jax_step(head):
    """The one-process step the ranks are held to is JAX's single-device
    step (dropout 0, class weights, a padded row, the uint8 feed): loss
    within 1e-4 relative, each parameter within rtol 2e-3 / atol 2e-5 and
    the running statistics within rtol 2e-3 / atol 1e-5, the tolerances
    of tests/test_torch_train_step.py."""
    import jax
    import jax.numpy as jnp

    from tmrnet_torch.data.device_feed import DevicePrep
    from tmrnet_torch.models.convert import from_jax_variables
    from tmrnet_tpu.config import DataConfig as JaxDataConfig
    from tmrnet_tpu.config import ModelConfig as JaxModelConfig
    from tmrnet_tpu.config import TrainConfig as JaxTrainConfig
    from tmrnet_tpu.data.device_feed import DevicePrep as JaxDevicePrep
    from tmrnet_tpu.models.tmrnet import build_model as jax_build_model
    from tmrnet_tpu.train.optim import make_optimizer as jax_make_optimizer
    from tmrnet_tpu.train.optim import slow_modules_for_head as jax_slow
    from tmrnet_tpu.train.state import create_train_state
    from tmrnet_tpu.train.steps import make_stage1_steps as jax_stage1
    from tmrnet_tpu.train.steps import make_stage2_steps as jax_stage2

    args, labels = global_batch(41, head)
    model = jax_build_model(JaxModelConfig(**dict(MODEL, head=head)))
    jargs = tuple(jnp.asarray(a.numpy(), jnp.float32) for a in args)
    variables = jax.tree_util.tree_map(
        np.asarray, model.init(jax.random.PRNGKey(5), *jargs))
    jstate = create_train_state(model, variables, jax_make_optimizer(
        JaxTrainConfig(**TRAIN), variables["params"], jax_slow(head)))
    make = jax_stage1 if head == "stage1" else jax_stage2
    jstep, _ = make(class_weights=CLASS_WEIGHTS, donate=False,
                    prep=JaxDevicePrep(JaxDataConfig(device_normalize=True),
                                       "float32"))
    jstate, jm = jstep(jstate, *(jnp.asarray(a.numpy()) for a in args),
                       jnp.asarray(labels.numpy()), jax.random.PRNGKey(0))

    cfg = ModelConfig(**dict(MODEL, head=head))
    pmodel = build_model(cfg, device="cpu")
    pmodel.load_state_dict(from_jax_variables(variables))
    state = TrainState(pmodel, make_optimizer(TrainConfig(**TRAIN), pmodel,
                                              slow_modules_for_head(head)))
    pmake = make_stage1_steps if head == "stage1" else make_stage2_steps
    pstep, _ = pmake(CLASS_WEIGHTS, prep=DevicePrep(
        DataConfig(device_normalize=True), "float32", "cpu"))
    pm = pstep(state, *args, labels, torch.Generator().manual_seed(0))
    np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]),
                               rtol=1e-4)
    want = from_jax_variables(jax.tree_util.tree_map(np.asarray,
                                                     jstate.variables))
    for k, v in pmodel.state_dict().items():
        if k.endswith("num_batches_tracked"):
            continue
        tol = (dict(rtol=2e-3, atol=1e-5) if "running" in k
               else dict(rtol=2e-3, atol=2e-5))
        np.testing.assert_allclose(v.numpy(), np.asarray(want[k]),
                                   err_msg=k, **tol)


# -- train_stage1 over local rows --------------------------------------------

def write_videos(root):
    """Packed uint8 videos under root: {split: [(id, paths, labels)]}."""
    rng = np.random.default_rng(70)
    out = {}
    for split, lengths in (("train", TRAIN_LENGTHS), ("val", VAL_LENGTHS)):
        out[split] = []
        for v, n in enumerate(lengths):
            path = os.path.join(root, f"{split}{v}.npy")
            np.save(path, rng.integers(0, 256, (n, 40, 40, 3),
                                       dtype=np.uint8))
            labels = ((np.arange(n) // 4 + v) % NCLS).astype(np.int64)
            out[split].append((f"{split}{v}", [f"{path}#{t}" for t in
                                               range(n)], labels.tolist()))
    return out


def fit_config(ck, epochs, **train):
    return ExperimentConfig(
        data=DataConfig(sequence_length=T, resize=40, crop_size=HW,
                        batch_clips=B, num_workers=2, device_normalize=True),
        model=ModelConfig(**dict(MODEL, head="stage1", dropout_stage1=0.2)),
        memory=MemoryConfig(window=WIN),
        train=TrainConfig(**dict(TRAIN, epochs=epochs, checkpoint_dir=str(ck),
                                 log_every=100, schedule="constant",
                                 val_minibatch_every=3, **train)))


def fit_datasets(videos):
    make = lambda split: Manifest([VideoRecord(i, p, np.asarray(l))
                                   for i, p, l in videos[split]])
    return (ClipDataset(make("train"), T,
                        transform=TrainTransform(HW, 40, False,
                                                 normalize=False)),
            ClipDataset(make("val"), T,
                        transform=EvalTransform(HW, 40, 1, normalize=False)))


def fit(videos, ck, epochs, mesh=None, **train):
    from tmrnet_torch.train.loop import train_stage1

    train_ds, val_ds = fit_datasets(videos)
    return train_stage1(fit_config(ck, epochs, **train), train_ds, val_ds,
                        mesh=mesh, device="cpu")


def fit_child(mode, mesh, root, ck, epochs):
    import tmrnet_torch.train.loop as loop

    with open(os.path.join(root, "videos.json")) as f:
        videos = json.load(f)
    if mode == "preempt" and mesh.rank == 1:
        make = loop.make_stage1_steps

        def counting(*a, **kw):
            train_step, eval_step = make(*a, **kw)
            calls = [0]

            def step(*args):
                m = train_step(*args)
                calls[0] += 1
                if calls[0] == PREEMPT_AT:
                    os.kill(os.getpid(), signal.SIGTERM)
                return m

            return step, eval_step

        loop.make_stage1_steps = counting
    state, hist = fit(videos, ck, int(epochs), mesh)
    print("RESULT " + json.dumps({
        "step": state.step,
        "hist": [dataclasses.astuple(h)[:-1] for h in hist]}), flush=True)


def result_of(out):
    return json.loads([ln for ln in out.splitlines()
                       if ln.startswith("RESULT ")][-1][len("RESULT "):])


def test_two_rank_train_stage1_equals_one_process_and_resumes(tmp_path):
    """train_stage1 (dropout 0.2, a padded val batch, mid-epoch val) over
    two ranks' local rows: both ranks report one process's epoch
    statistics; rank 0 alone writes the checkpoints, one a step; a second
    run with more epochs resumes after the first's last."""
    from tmrnet_torch.utils.checkpoint import CheckpointManager

    videos = write_videos(str(tmp_path))
    (tmp_path / "videos.json").write_text(json.dumps(videos))
    _, want = fit(videos, tmp_path / "one", 2)
    ck = tmp_path / "ranks"
    outs = run_ranks("fit", WORLD, tmp_path, ck, 1)
    res = [result_of(o) for o in outs]
    assert res[0] == res[1]
    assert [h[0] for h in res[0]["hist"]] == [0] and res[0]["step"] == 13
    steps = CheckpointManager(str(ck)).all_steps()
    assert steps == [13] and (ck / "best").is_dir()
    assert not list(ck.glob("*.tmp"))
    outs = run_ranks("fit", WORLD, tmp_path, ck, 2)
    res2 = [result_of(o) for o in outs]
    assert res2[0] == res2[1]
    assert [h[0] for h in res2[0]["hist"]] == [1], "not a resume"
    assert CheckpointManager(str(ck)).all_steps() == [13, 26]
    for got, h in zip(res[0]["hist"] + res2[0]["hist"], want):
        epoch, tr_loss, tr_acc, va_loss, va_acc, lr = got
        assert epoch == h.epoch and lr == h.lr
        assert tr_acc == h.train_acc and va_acc == h.val_acc
        np.testing.assert_allclose([tr_loss, va_loss],
                                   [h.train_loss, h.val_loss], rtol=1e-5)


def test_sigterm_to_one_rank_stops_both_at_one_step(tmp_path):
    """Rank 1 alone takes a SIGTERM after its third step: the collective
    check stops both ranks at step 8 (the check every 8 steps), and the
    replay checkpoint (epoch -1, preempted) is rank 0's."""
    from tmrnet_torch.utils.checkpoint import CheckpointManager

    videos = write_videos(str(tmp_path))
    (tmp_path / "videos.json").write_text(json.dumps(videos))
    ck = tmp_path / "ck"
    outs = run_ranks("preempt", WORLD, tmp_path, ck, 2)
    res = [result_of(o) for o in outs]
    assert res[0] == res[1] == {"step": 8, "hist": []}
    m = CheckpointManager(str(ck))
    assert m.all_steps() == [8]
    assert m.metadata(8)["metrics"]["preempted"] is True
    assert m.metadata(8)["metrics"]["epoch"] == -1
