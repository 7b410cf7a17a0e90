"""Async checkpoints (`CheckpointManager(use_async=True)`,
`train.async_checkpoint`), on the CPU.

- An async run's checkpoints restore to the same weights, running
  statistics, optimizer state, step and accumulator as a sync run's, bit
  for bit, and the saved files hold the same tensors.
- `save()` returns with the write in flight; a step taken after it returns
  does not reach the file (the snapshot is a copy).
- `_gc` keeps the step in flight and the newest durable step.
- A write that dies leaves no step that `latest_step()` returns; `wait()`
  raises its error, and the next save goes through.
- A preempted trainer under `train.async_checkpoint` leaves its replay
  checkpoint durable when it returns and resumes at its epoch, as a sync
  one does.
"""

import os
import signal
import threading

import numpy as np
import pytest
import torch

from tmrnet_torch.config import ModelConfig, TrainConfig
from tmrnet_torch.models.tmrnet import build_model, init_state_dict
from tmrnet_torch.train import loop
from tmrnet_torch.train.optim import make_optimizer, slow_modules_for_head
from tmrnet_torch.train.state import TrainState
from tmrnet_torch.train.steps import make_stage2_steps
from tmrnet_torch.utils import checkpoint
from tmrnet_torch.utils.checkpoint import CheckpointManager

from tests.test_torch_train_loop import _port_run, videos  # noqa: F401

torch.set_num_threads(2)

MODEL = dict(backbone="tiny", stage_sizes=(1, 1), width=8, hidden_dim=16,
             num_classes=5, compute_dtype="float32", head="tmr",
             dropout_head=0.0, dropout_nl=0.0)


def _state(optimizer="sgd", grad_accum=1):
    cfg = ModelConfig(**MODEL)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(init_state_dict(cfg, 1))
    opt = make_optimizer(TrainConfig(optimizer=optimizer, lr=0.05), model,
                         slow_modules_for_head("tmr"))
    return TrainState(model, opt, grad_accum=grad_accum)


def _step(state, seed):
    g = torch.Generator().manual_seed(seed)
    train, _ = make_stage2_steps()
    train(state, torch.randn(2, 3, 32, 32, 3, generator=g),
          torch.randn(2, 4, 16, generator=g), torch.tensor([1, 3]),
          torch.Generator().manual_seed(seed))


def _equal_trees(a, b):
    if isinstance(a, dict):
        return set(a) == set(b) and all(_equal_trees(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(map(_equal_trees, a, b))
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    if isinstance(a, np.ndarray):
        return np.array_equal(a, b)
    return a == b


@pytest.mark.parametrize("optimizer,grad_accum", [("sgd", 1), ("adam", 2)])
def test_async_checkpoints_restore_as_sync_ones(tmp_path, optimizer,
                                                grad_accum):
    states = {"sync": _state(optimizer, grad_accum),
              "async": _state(optimizer, grad_accum)}
    managers = {"sync": CheckpointManager(str(tmp_path / "sync"), keep=2),
                "async": CheckpointManager(str(tmp_path / "async"), keep=2,
                                           use_async=True)}
    for seed in range(5):
        for name, st in states.items():
            _step(st, seed)
            managers[name].save(st, st.step, metrics={"epoch": seed},
                                is_best=seed == 1)
    managers["async"].wait()
    sync, done = managers["sync"], managers["async"]
    assert done.all_steps() == sync.all_steps() == [4, 5]
    for path in [sync._step_dir(s) for s in sync.all_steps()] + [
            sync.best_dir]:
        twin = path.replace(str(tmp_path / "sync"), str(tmp_path / "async"))
        assert _equal_trees(CheckpointManager._load(path),
                            CheckpointManager._load(twin)), path
    for s in sync.all_steps():
        assert done.metadata(s) == sync.metadata(s)
    assert done.best_metadata() == sync.best_metadata()
    a = done.restore(_state(optimizer, grad_accum))
    b = sync.restore(_state(optimizer, grad_accum))
    assert (a.step, a.mini_step) == (b.step, b.mini_step)
    assert _equal_trees(a.model.state_dict(), b.model.state_dict())
    assert _equal_trees(a.optimizer.state_dict(), b.optimizer.state_dict())
    assert _equal_trees(a.state_dict()["acc_grads"],
                        b.state_dict()["acc_grads"])


def test_a_step_after_save_does_not_reach_the_file(tmp_path, monkeypatch):
    st = _state("sgd")
    _step(st, 0)
    want = {k: v.clone() for k, v in st.model.state_dict().items()
            if "num_batches" not in k}      # which flax's tree lacks
    momentum = [st.optimizer.state[p]["momentum_buffer"].clone()
                for p in st.params if p in st.optimizer.state]
    gate = threading.Event()
    save = torch.save

    def held(*a, **kw):         # the writer waits until the step is taken
        assert gate.wait(30)
        return save(*a, **kw)

    monkeypatch.setattr(checkpoint.torch, "save", held)
    ck = CheckpointManager(str(tmp_path), use_async=True)
    ck.save(st, st.step)
    assert ck.all_steps() == []             # in flight, not yet renamed
    _step(st, 1)                            # in-place updates after save()
    gate.set()
    ck.wait()
    back = ck.restore(_state("sgd"))
    for k, v in want.items():
        assert torch.equal(back.model.state_dict()[k], v), k
    assert not torch.equal(st.model.state_dict()["fc_c.weight"],
                           want["fc_c.weight"])
    got = [back.optimizer.state[p]["momentum_buffer"]
           for p in back.params if p in back.optimizer.state]
    assert len(got) == len(momentum) > 0
    assert all(torch.equal(a, b) for a, b in zip(got, momentum))


def test_gc_keeps_the_pending_and_the_newest_durable_step(tmp_path):
    st = _state("sgd")
    ck = CheckpointManager(str(tmp_path), keep=1)
    for step in (1, 2, 3):
        ck.save(st, step)
    assert ck.all_steps() == [3]
    for step in (4, 5):
        CheckpointManager(str(tmp_path), keep=10).save(st, step)
    ck._gc(pending=9)           # 9 is in flight: keep it and 5
    assert ck.all_steps() == [5]
    assert not os.path.exists(ck._meta_path(4))
    ck._gc()
    assert ck.all_steps() == [5]


def test_a_write_that_dies_leaves_no_step(tmp_path, monkeypatch):
    st = _state("sgd")
    ck = CheckpointManager(str(tmp_path), keep=3, use_async=True)
    ck.save(st, 1)
    ck.wait()
    save = torch.save

    def dies(obj, path, *a, **kw):      # half a file, then the error
        with open(path, "wb") as f:
            f.write(b"partial")
        raise OSError("disk full")

    monkeypatch.setattr(checkpoint.torch, "save", dies)
    ck.save(st, 2)
    with pytest.raises(RuntimeError, match="background checkpoint") as exc:
        ck.wait()
    assert isinstance(exc.value.__cause__, OSError)
    assert ck.latest_step() == ck.all_steps()[-1] == 1
    assert os.path.isdir(ck._step_dir(2) + ".tmp")
    assert not os.path.exists(ck._meta_path(2))
    ck.wait()                           # the error is raised once
    monkeypatch.setattr(checkpoint.torch, "save", save)
    ck.save(st, 2)
    ck.wait()
    assert ck.all_steps() == [1, 2]
    assert not os.path.exists(ck._step_dir(2) + ".tmp")


def test_async_preemption_resumes_at_its_epoch(videos, tmp_path,  # noqa: F811
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
    state, hist = _port_run(videos, tmp_path, epochs=3,
                            async_checkpoint=True)
    assert [h.epoch for h in hist] == [0] and state.step == 7
    ck = CheckpointManager(str(tmp_path / "port_ck"))
    assert ck.latest_step() == 7        # durable when the trainer returned
    meta = ck.metadata(7)["metrics"]
    assert meta["preempted"] is True and meta["epoch"] == 0
    monkeypatch.setattr(loop, "make_stage1_steps", real)
    state, hist = _port_run(videos, tmp_path, epochs=3,
                            async_checkpoint=True)
    assert [h.epoch for h in hist] == [1, 2]
    assert state.step == 7 + 2 * 5
    assert ck.latest_step() == state.step
    assert not ck.metadata(state.step)["metrics"].get("preempted")
