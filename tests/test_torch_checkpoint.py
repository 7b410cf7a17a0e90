"""The port's checkpoints (`utils/checkpoint.py`) and metric logger
(`utils/logging.py`), with JAX's layout and rules.

A save/restore round trip brings back the weights, the running statistics,
the optimizer's state, the step and the gradient accumulator exactly, so
the next step equals an uninterrupted one bit for bit; the weights are a
flax variables tree with the JAX model's names and shapes; `keep` prunes
the oldest steps and never the best; the best is swapped in whole, and a
staged best left by a crash is read; `restore_weights` reads the weights
of a checkpoint written with another optimizer; a lost sidecar reads as
empty metrics; a file holding any object beyond tensors and plain
containers is refused; `BestTracker` takes the same epochs as JAX's; an
async manager's best restores as the sync one's does
(`test_torch_async_checkpoint.py` holds the rest of async). The logger
writes JAX's JSONL rows.
"""

import json
import pickle
import shutil

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tmrnet_tpu.config import ModelConfig as JaxModelConfig
from tmrnet_tpu.models.tmrnet import build_model as jax_build_model
from tmrnet_tpu.utils.checkpoint import BestTracker as JaxBestTracker
from tmrnet_tpu.utils.logging import MetricLogger as JaxMetricLogger
from tmrnet_torch.config import ModelConfig, TrainConfig
from tmrnet_torch.models.convert import from_jax_variables
from tmrnet_torch.models.tmrnet import build_model, init_state_dict
from tmrnet_torch.train.optim import make_optimizer, slow_modules_for_head
from tmrnet_torch.train.state import TrainState
from tmrnet_torch.train.steps import make_stage2_steps
from tmrnet_torch.utils.checkpoint import BestTracker, CheckpointManager
from tmrnet_torch.utils.logging import MetricLogger

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


def _batch(seed):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(2, 3, 32, 32, 3, generator=g),
            torch.randn(2, 4, 16, generator=g), torch.tensor([1, 3]))


def _step(state, seed):
    train, _ = make_stage2_steps()
    return train(state, *_batch(seed), torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("optimizer,grad_accum", [("sgd", 1), ("adam", 2)])
def test_round_trip_resumes_bit_for_bit(tmp_path, optimizer, grad_accum):
    a = _state(optimizer, grad_accum)
    for seed in range(3):
        _step(a, seed)
    ck = CheckpointManager(str(tmp_path))
    ck.save(a, a.step, metrics={"epoch": 0})
    b = ck.restore(_state(optimizer, grad_accum))
    assert (b.step, b.mini_step) == (a.step, a.mini_step) == (3, 3 % grad_accum)
    sa, sb = a.model.state_dict(), b.model.state_dict()
    for k in sa:
        if "num_batches" not in k:
            assert torch.equal(sa[k], sb[k]), k
    _step(a, 7)
    _step(b, 7)
    for k, v in a.model.state_dict().items():
        if "num_batches" not in k:
            assert torch.equal(v, b.model.state_dict()[k]), k


def test_weights_carry_the_flax_tree(tmp_path):
    state = _state()
    ck = CheckpointManager(str(tmp_path))
    ck.save(state, 0)
    got = ck.restore_weights()
    clips = jnp.zeros((1, 3, 32, 32, 3))
    want = jax_build_model(JaxModelConfig(**MODEL)).init(
        jax.random.PRNGKey(0), clips, jnp.zeros((1, 4, 16)))
    shapes = lambda tree: {jax.tree_util.keystr(p): np.shape(a) for p, a in
                           jax.tree_util.tree_leaves_with_path(tree)}
    assert shapes(got) == shapes(want)
    back = from_jax_variables(got)
    for k, v in state.model.state_dict().items():
        if "num_batches" not in k:
            assert torch.equal(back[k], v), k


def test_keep_best_and_swap(tmp_path):
    state = _state()
    ck = CheckpointManager(str(tmp_path), keep=2)
    for step, best in ((1, True), (2, False), (3, False), (4, False)):
        ck.save(state, step, metrics={"epoch": step, "val_acc": 0.1 * step},
                is_best=best)
    assert ck.all_steps() == [3, 4] and ck.latest_step() == 4
    assert (tmp_path / "best" / "state.pt").exists()
    assert ck.best_metadata()["metrics"]["epoch"] == 1
    assert not (tmp_path / "best.tmp").exists()
    assert not list(tmp_path.glob("*.tmp"))
    assert ck.metadata(4)["metrics"]["epoch"] == 4
    (tmp_path / "step_00000004.json").unlink()       # a lost sidecar
    assert ck.metadata(4) == {"step": 4, "metrics": {}}
    # a crash between the staged copy and the swap: the staged best reads
    shutil.move(str(tmp_path / "best"), str(tmp_path / "best.tmp"))
    staged = from_jax_variables(ck.restore_weights())
    best = from_jax_variables(CheckpointManager._load(
        str(tmp_path / "best.tmp"))["variables"])
    assert all(torch.equal(staged[k], best[k]) for k in best)
    shutil.rmtree(tmp_path / "best.tmp")
    assert "backbone" in ck.restore_weights()["params"]   # the newest step
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore_weights()


def test_restore_weights_ignores_the_optimizer(tmp_path):
    adam = _state("adam")
    _step(adam, 0)
    ck = CheckpointManager(str(tmp_path))
    ck.save(adam, adam.step, is_best=True)
    sgd = _state("sgd")
    sgd.model.load_state_dict(from_jax_variables(ck.restore_weights()))
    for k, v in adam.model.state_dict().items():
        if "num_batches" not in k:
            assert torch.equal(sgd.model.state_dict()[k], v), k
    # an async manager's best restores to the same weights
    ak = CheckpointManager(str(tmp_path / "async"), use_async=True)
    ak.save(adam, adam.step, is_best=True)
    ak.wait()
    got = from_jax_variables(ak.restore_weights())
    for k, v in from_jax_variables(ck.restore_weights()).items():
        assert torch.equal(got[k], v), k


class _Payload:
    """Any object beyond tensors and plain containers."""


def test_checkpoint_holding_another_object_is_refused(tmp_path):
    state = _state()
    ck = CheckpointManager(str(tmp_path))
    ck.save(state, 1, is_best=True)
    for path in (tmp_path / "step_00000001", tmp_path / "best"):
        saved = torch.load(path / "state.pt", weights_only=True)
        saved["train"]["extra"] = _Payload()
        torch.save(saved, path / "state.pt")
    with pytest.raises(pickle.UnpicklingError):
        ck.restore_weights()
    with pytest.raises(pickle.UnpicklingError):
        ck.restore(_state())


def test_best_tracker_matches_jax():
    seq = [(0.5, 0.4), (0.5, 0.6), (0.4, 0.9), (0.7, 0.1), (0.7, 0.1),
           (0.7, 0.2), (0.2, 0.2)]
    mine, theirs = BestTracker(), JaxBestTracker()
    for e, (v, t) in enumerate(seq):
        assert mine.update(e, v, t) == theirs.update(e, v, t)
        assert (mine.best_epoch, mine.best_val, mine.best_train) == (
            theirs.best_epoch, theirs.best_val, theirs.best_train)


def test_metric_logger_writes_jax_rows(tmp_path, capsys):
    for name, cls in (("port", MetricLogger), ("jax", JaxMetricLogger)):
        log = cls(str(tmp_path / name), use_tensorboard=False)
        log.log(3, {"loss": 0.25, "acc": 1}, prefix="train/")
        log.log_confusion_matrix(1, np.array([0, 1, 1, -1]),
                                 np.array([0, 1, 0, 2]), 3, tag="val/cm")
        log.log_images(2, "x/y", np.zeros((2, 4, 4, 3), np.float32) - 1)
        log.close()
    rows = {n: (tmp_path / n / "metrics.jsonl").read_text()
            for n in ("port", "jax")}
    assert rows["port"] == rows["jax"]
    assert json.loads(rows["port"].splitlines()[1])["val/cm"][1] == [1, 1, 0]
    assert sorted(p.name for p in (tmp_path / "port" / "images").iterdir()) \
        == sorted(p.name for p in (tmp_path / "jax" / "images").iterdir())
    out = capsys.readouterr().out.splitlines()
    assert out[0] == out[1] == "[step 3] train/loss=0.25 train/acc=1"
