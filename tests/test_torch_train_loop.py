"""The port's epoch loop against the JAX package's, on the CPU in f32, over
packed frames (`<video>.npy#<t>`).

`train_stage1` and `train_stage2` (head tmr over a seeded bank) run two
epochs in both packages from the same variables (moved across by
`from_jax_variables`), the same manifests, the same TrainTransform
(crop, jitter, flip and rotation drawn per clip and epoch) on the uint8
wire, the same shuffled batches and dropout 0: every epoch's train and val
loss within 1e-3 relative and the accuracies and learning rates equal, and
the final weights and running statistics within rtol 1e-3 / atol 1e-4;
and the memory windows the stage-2 trainer gathers (clamped, or the
reference's cross-video walk) equal JAX's.

Then the port alone: a SIGTERM mid-epoch saves a checkpoint marked for the
epoch's replay and a rerun resumes there with the plateau schedule's state
and the best tracker re-seeded; early stop; two runs with dropout on give
the same weights bit for bit; the checkpoints of a run (pruned to `keep`,
the best a copy apart) and `restore_weights`; mid-epoch validation and
image logging; and the refusals of what the trainer does not port.
"""

import dataclasses
import json
import os
import pathlib
import signal

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tmrnet_tpu.config import DataConfig as JaxDataConfig
from tmrnet_tpu.config import ExperimentConfig as JaxExperimentConfig
from tmrnet_tpu.config import MemoryConfig as JaxMemoryConfig
from tmrnet_tpu.config import ModelConfig as JaxModelConfig
from tmrnet_tpu.config import TrainConfig as JaxTrainConfig
from tmrnet_tpu.data import manifests as jax_manifests
from tmrnet_tpu.data import pipeline as jax_pipeline
from tmrnet_tpu.data import transforms as jax_transforms
from tmrnet_tpu.memory.lfb import FeatureBank as JaxFeatureBank
from tmrnet_tpu.models.tmrnet import build_model as jax_build_model
from tmrnet_tpu.train import loop as jax_loop
from tmrnet_torch.config import (DataConfig, ExperimentConfig, MemoryConfig,
                                 ModelConfig, TrainConfig)
from tmrnet_torch.data import manifests, pipeline, transforms
from tmrnet_torch.memory.lfb import FeatureBank
from tmrnet_torch.models.convert import from_jax_variables
from tmrnet_torch.train import loop
from tmrnet_torch.utils.checkpoint import CheckpointManager
from tmrnet_torch.utils.logging import MetricLogger

torch.set_num_threads(2)

SEQ, HW, CROP, HID, WIN, NCLS = 3, 40, 32, 16, 4, 5
TRAIN_LENGTHS, VAL_LENGTHS = (14, 11), (9, 6)
DATA = dict(sequence_length=SEQ, resize=HW, crop_size=CROP, batch_clips=4,
            num_workers=2, device_normalize=True)
MODEL = dict(backbone="tiny", stage_sizes=(1, 1), width=8, hidden_dim=HID,
             num_classes=NCLS, compute_dtype="float32", dropout_stage1=0.0,
             dropout_head=0.0, dropout_nl=0.0)
TRAIN = dict(epochs=2, optimizer="sgd", lr=0.05, momentum=0.9,
             weight_decay=5e-4, log_every=100, plateau_patience=0,
             plateau_factor=0.5)


@pytest.fixture(scope="module")
def videos(tmp_path_factory):
    """Packed uint8 videos: {split: [(id, paths, labels)]}."""
    d = tmp_path_factory.mktemp("frames")
    rng = np.random.default_rng(60)
    out = {}
    for split, lengths in (("train", TRAIN_LENGTHS), ("val", VAL_LENGTHS)):
        out[split] = []
        for v, n in enumerate(lengths):
            path = d / f"{split}{v}.npy"
            np.save(path, rng.integers(0, 256, (n, HW, HW, 3), dtype=np.uint8))
            labels = ((np.arange(n) // 4 + v) % NCLS).astype(np.int64)
            out[split].append((f"{split}{v}", [f"{path}#{t}" for t in range(n)],
                               labels))
    return out


def _datasets(videos, pkg):
    """(train, val) ClipDatasets of `pkg` (the port's or JAX's modules)."""
    man, pipe, tfs = pkg
    make = lambda split: man.Manifest([man.VideoRecord(i, p, l)
                                       for i, p, l in videos[split]])
    train_tf = tfs.TrainTransform(CROP, HW, True, normalize=False)
    val_tf = tfs.EvalTransform(CROP, HW, 1, normalize=False)
    return (pipe.ClipDataset(make("train"), SEQ, transform=train_tf),
            pipe.ClipDataset(make("val"), SEQ, transform=val_tf))


PORT = (manifests, pipeline, transforms)
JAX = (jax_manifests, jax_pipeline, jax_transforms)


def _bank_features(lengths, seed):
    n = sum(x - SEQ + 1 for x in lengths)
    return np.random.RandomState(seed).randn(n, HID).astype(np.float32)


def _banks(pkg_bank, lengths, seed, **kw):
    bank = pkg_bank.create(SEQ, list(lengths), HID, **kw)
    feats = _bank_features(lengths, seed)
    if pkg_bank is JaxFeatureBank:
        return dataclasses.replace(bank, features=jnp.asarray(feats))
    bank.features.copy_(torch.from_numpy(feats))
    return bank


def _configs(tmp, head, **train_kw):
    tr = dict(TRAIN, checkpoint_dir=str(tmp / "jax_ck"), **train_kw)
    jcfg = JaxExperimentConfig(
        data=JaxDataConfig(**DATA), model=JaxModelConfig(**dict(MODEL,
                                                                head=head)),
        memory=JaxMemoryConfig(window=WIN), train=JaxTrainConfig(**tr))
    pcfg = ExperimentConfig(
        data=DataConfig(**DATA), model=ModelConfig(**dict(MODEL, head=head)),
        memory=MemoryConfig(window=WIN),
        train=TrainConfig(**dict(tr, checkpoint_dir=str(tmp / "port_ck"))))
    return jcfg, pcfg


def _init(head):
    clips = jnp.zeros((1, SEQ, CROP, CROP, 3))
    args = (clips, jnp.zeros((1, WIN, HID))) if head != "stage1" else (clips,)
    v = jax_build_model(JaxModelConfig(**dict(MODEL, head=head))).init(
        jax.random.PRNGKey(4), *args)
    return jax.tree_util.tree_map(np.asarray, v)


@pytest.fixture(scope="module", params=["stage1", "tmr"])
def both(request, videos, tmp_path_factory):
    head = request.param
    tmp = tmp_path_factory.mktemp(f"loop_{head}")
    jcfg, pcfg = _configs(tmp, head)
    variables = _init(head)
    jtr, jva = _datasets(videos, JAX)
    ptr, pva = _datasets(videos, PORT)
    if head == "stage1":
        jstate, jhist = jax_loop.train_stage1(
            jcfg, jtr, jva, init_variables=jax.tree_util.tree_map(
                jnp.asarray, variables))
        pstate, phist = loop.train_stage1(
            pcfg, ptr, pva, init_state_dict=from_jax_variables(variables),
            device="cpu")
    else:
        jstate, jhist = jax_loop.train_stage2(
            jcfg, jtr, _banks(JaxFeatureBank, TRAIN_LENGTHS, 1), jva,
            _banks(JaxFeatureBank, VAL_LENGTHS, 2),
            init_variables=jax.tree_util.tree_map(jnp.asarray, variables))
        pstate, phist = loop.train_stage2(
            pcfg, ptr, _banks(FeatureBank, TRAIN_LENGTHS, 1, device="cpu"),
            pva, _banks(FeatureBank, VAL_LENGTHS, 2, device="cpu"),
            init_state_dict=from_jax_variables(variables), device="cpu")
    return dict(jhist=jhist, phist=phist, jstate=jstate, pstate=pstate,
                tmp=tmp)


def test_two_epochs_history_matches_jax(both):
    assert len(both["phist"]) == len(both["jhist"]) == 2
    for j, p in zip(both["jhist"], both["phist"]):
        assert p.epoch == j.epoch
        for k in ("train_loss", "val_loss"):
            assert getattr(p, k) == pytest.approx(getattr(j, k), rel=1e-3), k
        assert p.train_acc == pytest.approx(j.train_acc)
        assert p.val_acc == pytest.approx(j.val_acc)
        assert p.lr == pytest.approx(j.lr)
    assert both["pstate"].step == int(both["jstate"].step)


def test_two_epochs_weights_match_jax(both):
    want = from_jax_variables(jax.tree_util.tree_map(
        np.asarray, both["jstate"].variables))
    got = both["pstate"].model.state_dict()
    for k, w in want.items():
        if "num_batches" in k:
            continue
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=1e-3,
                                   atol=1e-4, err_msg=k)


def test_checkpoints_match_jax_layout(both):
    """The port's best checkpoint carries the JAX run's tree: the same
    names and shapes under params and batch_stats; the sidecars the same
    metrics keys."""
    from tmrnet_tpu.utils.checkpoint import CheckpointManager as JaxCkpt

    jdir, pdir = both["tmp"] / "jax_ck", both["tmp"] / "port_ck"
    got = CheckpointManager(str(pdir)).restore_weights()
    want = JaxCkpt(str(jdir)).restore_weights(
        jax.tree_util.tree_map(np.asarray, both["jstate"].variables))
    shapes = lambda tree: {jax.tree_util.keystr(p): np.shape(a) for p, a in
                           jax.tree_util.tree_leaves_with_path(tree)}
    assert shapes(got) == shapes({k: want[k] for k in ("params",
                                                       "batch_stats")})
    jm = json.loads((jdir / "best.json").read_text())
    pm = json.loads((pdir / "best.json").read_text())
    assert set(pm["metrics"]) == set(jm["metrics"])
    assert pm["metrics"]["epoch"] == jm["metrics"]["epoch"]


# -- the port alone ------------------------------------------------------------

def _port_run(videos, tmp, patch=None, **train_kw):
    _, pcfg = _configs(tmp, "stage1", **train_kw)
    ptr, pva = _datasets(videos, PORT)
    return loop.train_stage1(pcfg, ptr, pva,
                             init_state_dict=from_jax_variables(
                                 _init("stage1")),
                             device="cpu", **(patch or {}))


def test_preemption_saves_a_replay_checkpoint_and_resumes(videos, tmp_path,
                                                         monkeypatch):
    real = loop.make_stage1_steps
    calls = {"n": 0}

    def steps(*a, **kw):
        train, evaluate = real(*a, **kw)

        def train_step(*args):
            calls["n"] += 1
            out = train(*args)
            if calls["n"] == 7:         # epoch 1, its second step
                os.kill(os.getpid(), signal.SIGTERM)
            return out

        return train_step, evaluate

    monkeypatch.setattr(loop, "make_stage1_steps", steps)
    handler = signal.getsignal(signal.SIGTERM)
    state, hist = _port_run(videos, tmp_path, epochs=3)
    assert [h.epoch for h in hist] == [0] and state.step == 7
    ck = CheckpointManager(str(tmp_path / "port_ck"))
    meta = ck.metadata(ck.latest_step())["metrics"]
    assert meta["preempted"] is True and meta["epoch"] == 0
    assert {"sched_best", "sched_bad_epochs", "sched_scale"} <= set(meta)
    best0 = json.loads((tmp_path / "port_ck" / "best.json").read_text())
    monkeypatch.setattr(loop, "make_stage1_steps", real)
    # the handler in place before the run is back
    assert signal.getsignal(signal.SIGTERM) is handler
    state, hist = _port_run(videos, tmp_path, epochs=3)
    assert [h.epoch for h in hist] == [1, 2]
    assert state.step == 7 + 2 * 5
    # the plateau state carried over: the resumed epochs' rates follow it
    sched = loop.make_schedule(TrainConfig(**dict(TRAIN, epochs=3)))
    sched.best, sched.bad_epochs, sched.scale = (
        meta["sched_best"], meta["sched_bad_epochs"], meta["sched_scale"])
    assert [h.lr for h in hist] == pytest.approx(
        [sched(h.epoch + 1, h.val_loss) for h in hist])
    # the tracker started from the saved best
    best = json.loads((tmp_path / "port_ck" / "best.json").read_text())
    accs = [(best0["metrics"]["val_acc"], best0["metrics"]["train_acc"])] + [
        (h.val_acc, h.train_acc) for h in hist]
    assert (best["metrics"]["val_acc"], best["metrics"]["train_acc"]) == max(
        accs)


def test_early_stop(videos, tmp_path, monkeypatch):
    """With no new best after epoch 0, patience 2 ends the run after epoch
    2, its checkpoint saved."""

    def update(self, epoch, val_acc, train_acc):
        if epoch == 0:
            self.best_val, self.best_train, self.best_epoch = (
                val_acc, train_acc, 0)
        return epoch == 0

    monkeypatch.setattr(loop.BestTracker, "update", update)
    state, hist = _port_run(videos, tmp_path, epochs=6,
                            early_stop_patience=2)
    assert [h.epoch for h in hist] == [0, 1, 2]
    ck = CheckpointManager(str(tmp_path / "port_ck"))
    assert ck.latest_step() == state.step == 15
    assert ck.best_metadata()["metrics"]["epoch"] == 0


def test_training_is_bitwise_reproducible(videos, tmp_path):
    outs = []
    for run in ("a", "b"):
        _, pcfg = _configs(tmp_path / run, "tmr")
        pcfg = pcfg.replace(model=dataclasses.replace(
            pcfg.model, dropout_head=0.5, dropout_nl=0.3))
        ptr, pva = _datasets(videos, PORT)
        state, _ = loop.train_stage2(
            pcfg, ptr, _banks(FeatureBank, TRAIN_LENGTHS, 1, device="cpu"),
            pva, _banks(FeatureBank, VAL_LENGTHS, 2, device="cpu"),
            device="cpu")
        outs.append(state.model.state_dict())
    assert all(torch.equal(outs[0][k], outs[1][k]) for k in outs[0])


def test_checkpoints_of_a_run(videos, tmp_path):
    log = MetricLogger(str(tmp_path / "log"), use_tensorboard=False,
                       quiet=True)
    state, hist = _port_run(videos, tmp_path, patch={"log": log}, epochs=4,
                            keep_checkpoints=2, val_minibatch_every=2,
                            log_images_every=3)
    ck = CheckpointManager(str(tmp_path / "port_ck"), keep=2)
    assert ck.all_steps() == [15, 20]
    assert not (tmp_path / "port_ck" / "best.tmp").exists()
    best = json.loads((tmp_path / "port_ck" / "best.json").read_text())
    winner = max(hist, key=lambda h: (h.val_acc, h.train_acc))
    assert best["metrics"]["epoch"] == winner.epoch
    weights = from_jax_variables(ck.restore_weights())
    if winner.epoch == 3:
        for k, v in state.model.state_dict().items():
            assert torch.equal(weights[k], v), k
    rows = [json.loads(line) for line in
            (tmp_path / "log" / "metrics.jsonl").read_text().splitlines()]
    assert any("val_minibatch/acc" in r for r in rows)
    assert any("val/confusion" in r for r in rows)
    assert sum("epoch/val_acc" in r for r in rows) == 4
    assert len(list((tmp_path / "log" / "images").glob(
        "train_input_sequence_*.png"))) == 8


def test_trainer_refuses_what_it_does_not_port(videos, tmp_path):
    """A mesh other than a data mesh raises; train.remat,
    train.async_checkpoint and a data mesh of one gloo process (its
    collectives over one rank), which the trainer now runs, give the plain
    run's weights bit for bit, and the async and mesh runs' checkpoints
    restore to the sync run's; the native TrainTransform equals JAX's."""
    from tests.test_torch_multiprocess_train import free_port
    from tmrnet_torch.parallel.mesh import (initialize_multihost, make_mesh,
                                            shutdown)

    runs = {}
    initialize_multihost(f"127.0.0.1:{free_port()}", 1, 0, device="cpu")
    try:
        for name, patch, kw in (
                ("plain", None, {}), ("remat", None, dict(remat=True)),
                ("async", None, dict(async_checkpoint=True)),
                ("mesh", {"mesh": make_mesh(device="cpu")},
                 dict(async_checkpoint=True))):
            state, _ = _port_run(videos, tmp_path / name, patch, **kw)
            runs[name] = state.model.state_dict()
    finally:
        shutdown()
    for name in ("remat", "async", "mesh"):
        assert all(torch.equal(runs[name][k], v)
                   for k, v in runs["plain"].items()), name
    sync = CheckpointManager(str(tmp_path / "plain" / "port_ck"))
    for name in ("async", "mesh"):
        done = CheckpointManager(str(tmp_path / name / "port_ck"))
        assert done.all_steps() == sync.all_steps()
        for step in sync.all_steps():
            a = CheckpointManager._load(sync._step_dir(step))
            b = CheckpointManager._load(done._step_dir(step))
            assert jax.tree_util.tree_all(jax.tree_util.tree_map(
                np.array_equal, a["variables"], b["variables"]))
            assert done.metadata(step) == sync.metadata(step)
    with pytest.raises(NotImplementedError, match="mesh"):
        _port_run(videos, tmp_path, patch={"mesh": object()})
    clip = np.random.default_rng(61).integers(0, 256, (SEQ, HW, HW, 3),
                                              dtype=np.uint8)
    from tmrnet_tpu.data import native as jax_native

    assert jax_native.available()       # not JAX's numpy fallback
    np.testing.assert_array_equal(
        transforms.TrainTransform(CROP, HW, False, use_native=True)(clip, 1, 2),
        jax_transforms.TrainTransform(CROP, HW, False, use_native=True)(
            clip, 1, 2))


@pytest.mark.parametrize("compat", [False, True])
def test_memory_windows_match_jax(videos, compat):
    """The trainers' memory gather, clamped at each video's first row or
    (memory.compat_cross_video) the reference's cross-video walk, equals
    JAX's `_make_memory_fn` on the same bank and rows."""
    jcfg, pcfg = _configs(pathlib.Path("unused"), "tmr")
    jcfg = jcfg.replace(memory=JaxMemoryConfig(window=WIN,
                                               compat_cross_video=compat))
    pcfg = pcfg.replace(memory=MemoryConfig(window=WIN,
                                            compat_cross_video=compat))
    jtr, _ = _datasets(videos, JAX)
    ptr, _ = _datasets(videos, PORT)
    rows = np.array([0, 1, 5, 11, 12, 13, 20])
    want = jax_loop._make_memory_fn(jcfg, jtr, _banks(
        JaxFeatureBank, TRAIN_LENGTHS, 1), WIN)(rows)
    got = loop._make_memory_fn(pcfg, ptr, _banks(
        FeatureBank, TRAIN_LENGTHS, 1, device="cpu"), WIN)(rows)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
