"""Remat: each ResNet bottleneck recomputed in the backward pass
(`model.remat`, which the trainers set from `train.remat`), on the CPU in
f32.

- A train step with remat equals the step without it bit for bit: every
  parameter's delta, the running statistics and `num_batches_tracked`
  (BatchNorm updates its statistics in the first forward only), for the
  tiny backbone and a two-stage ResNet (two blocks a stage, identity
  blocks among them), heads stage1 and tmr; each block's forward runs
  twice in a remat step and once without.
- The port's remat step against JAX's `nn.remat` step from the same
  variables on the same batch: loss within 1e-4 relative, every
  parameter's delta within 1e-4 of the step's largest delta and every
  running statistic within 1e-4 of the largest one, plus one float32
  spacing of the value after the step.
- `model.remat` alone changes nothing in a trainer, in both packages: the
  trainers build the model with `remat=train.remat`.
- ResNeSt ignores remat, as JAX's `build_backbone` does.
"""

import dataclasses
import threading

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tmrnet_tpu.config import ExperimentConfig as JaxExperimentConfig
from tmrnet_tpu.config import ModelConfig as JaxModelConfig
from tmrnet_tpu.config import TrainConfig as JaxTrainConfig
from tmrnet_tpu.models.tmrnet import build_model as jax_build_model
from tmrnet_tpu.train import loop as jax_loop
from tmrnet_tpu.train.optim import make_optimizer as jax_make_optimizer
from tmrnet_tpu.train.optim import slow_modules_for_head as jax_slow
from tmrnet_tpu.train.state import create_train_state
from tmrnet_tpu.train.steps import make_stage1_steps as jax_stage1_steps
from tmrnet_tpu.train.steps import make_stage2_steps as jax_stage2_steps
from tmrnet_torch.config import ExperimentConfig, ModelConfig, TrainConfig
from tmrnet_torch.models import resnet
from tmrnet_torch.models.convert import from_jax_variables
from tmrnet_torch.models.tmrnet import build_model
from tmrnet_torch.train import loop
from tmrnet_torch.train.optim import make_optimizer, slow_modules_for_head
from tmrnet_torch.train.state import TrainState
from tmrnet_torch.train.steps import make_stage1_steps, make_stage2_steps

torch.set_num_threads(2)

B, T, HW, HID, WIN, NCLS = 3, 3, 32, 16, 4, 5
BACKBONES = {"tiny": dict(backbone="tiny", stage_sizes=(1, 1), width=8),
             "resnet": dict(backbone="resnet50", stage_sizes=(2, 2), width=8)}
MODEL = dict(hidden_dim=HID, num_classes=NCLS, compute_dtype="float32",
             dropout_stage1=0.0, dropout_head=0.0, dropout_nl=0.0)
TRAIN = dict(optimizer="sgd", lr=0.05, momentum=0.9, weight_decay=5e-4,
             trunk_lr_scale=0.1)
JAX_TOL = 1e-4


def _model_kw(backbone, head, **kw):
    return dict(MODEL, **BACKBONES[backbone], head=head, **kw)


def _batch(seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, T, HW, HW, 3).astype(np.float32),
            rng.randn(B, WIN, HID).astype(np.float32),
            rng.randint(0, NCLS, B))


def _variables(backbone, head):
    clips, memory, _ = _batch(0)
    args = (jnp.asarray(clips),) + ((jnp.asarray(memory),)
                                    if head != "stage1" else ())
    v = jax_build_model(JaxModelConfig(**_model_kw(backbone, head))).init(
        jax.random.PRNGKey(3), *args)
    return jax.tree_util.tree_map(np.asarray, v)


def _port_step(backbone, head, variables, remat, batch):
    """One SGD step of the port: (loss, state dict after, each block
    forward's recompute flag in call order)."""
    model = build_model(ModelConfig(**_model_kw(backbone, head, remat=remat)),
                        device="cpu")
    model.load_state_dict(from_jax_variables(variables))
    calls = []
    forward = resnet.Bottleneck.forward

    def counted(self, x, train=False):
        calls.append(getattr(resnet._RECOMPUTE, "active", False))
        return forward(self, x, train)

    state = TrainState(model, make_optimizer(TrainConfig(**TRAIN), model,
                                             slow_modules_for_head(head)))
    make = make_stage1_steps if head == "stage1" else make_stage2_steps
    step, _ = make(class_weights=None)
    clips, memory, labels = batch
    args = (torch.from_numpy(clips),) + ((torch.from_numpy(memory),)
                                         if head != "stage1" else ())
    resnet.Bottleneck.forward = counted
    try:
        m = step(state, *args, torch.from_numpy(labels),
                 torch.Generator().manual_seed(0))
    finally:
        resnet.Bottleneck.forward = forward
    return (float(m["loss"]), {k: v.clone() for k, v in
                               model.state_dict().items()}, calls)


@pytest.mark.parametrize("head", ["stage1", "tmr"])
@pytest.mark.parametrize("backbone", sorted(BACKBONES))
def test_remat_step_equals_the_plain_step(backbone, head):
    variables = _variables(backbone, head)
    batch = _batch(10)
    loss, plain, n_plain = _port_step(backbone, head, variables, False, batch)
    loss_r, remat, n_remat = _port_step(backbone, head, variables, True, batch)
    assert loss_r == loss
    assert set(remat) == set(plain)
    for k, v in plain.items():
        assert torch.equal(remat[k], v), k
    tracked = [k for k in plain if k.endswith("num_batches_tracked")]
    assert tracked and all(int(plain[k]) == 1 for k in tracked)
    # each block runs once, and under remat once more as a recompute
    blocks = sum(BACKBONES[backbone]["stage_sizes"])
    assert n_plain == [False] * blocks
    assert n_remat == [False] * blocks + [True] * blocks


@pytest.mark.parametrize("head", ["stage1", "tmr"])
def test_remat_step_matches_jax(head):
    backbone = "resnet"
    variables = _variables(backbone, head)
    batch = _batch(11)
    clips, memory, labels = batch
    jmodel = jax_build_model(JaxModelConfig(**_model_kw(backbone, head,
                                                        remat=True)))
    tx = jax_make_optimizer(JaxTrainConfig(**TRAIN), variables["params"],
                            jax_slow(head))
    jstate = create_train_state(jmodel, jax.tree_util.tree_map(
        jnp.asarray, variables), tx)
    make = jax_stage1_steps if head == "stage1" else jax_stage2_steps
    jtrain, _ = make(class_weights=None, donate=False)
    jin = (jnp.asarray(clips),) + ((jnp.asarray(memory),)
                                   if head != "stage1" else ())
    jstate, jm = jtrain(jstate, *jin, jnp.asarray(labels),
                        jax.random.PRNGKey(0))
    want = from_jax_variables(jax.tree_util.tree_map(np.asarray,
                                                     jstate.variables))
    before = from_jax_variables(variables)
    loss, got, _ = _port_step(backbone, head, variables, True, batch)
    assert loss == pytest.approx(float(jm["loss"]), rel=JAX_TOL)
    keys = [k for k in want if "num_batches" not in k]
    ref = {k: want[k].numpy() - (0 if "running" in k else before[k].numpy())
           for k in keys}
    out = {k: got[k].numpy() - (0 if "running" in k else before[k].numpy())
           for k in keys}
    scale = {stat: max(float(np.abs(ref[k]).max()) for k in keys
                       if ("running" in k) == stat) for stat in (False, True)}
    for k in keys:
        # within 1e-4 of the step's largest delta (or statistic), and one
        # float32 spacing of the value after the step, to which both
        # packages round it
        allow = (JAX_TOL * scale["running" in k]
                 + np.spacing(np.abs(want[k].numpy())))
        assert np.all(np.abs(out[k] - ref[k]) <= allow), k


class _Built(Exception):
    pass


def test_model_remat_alone_changes_nothing_in_a_trainer(monkeypatch):
    """Both packages' trainers build the model with remat=train.remat,
    whatever model.remat says."""
    seen = {"jax": [], "port": []}

    def jax_build(cfg):
        seen["jax"].append(cfg.remat)
        raise _Built

    def port_fit(cfg, model_cfg, *a, **kw):
        seen["port"].append(model_cfg.remat)
        raise _Built

    monkeypatch.setattr(jax_loop, "build_model", jax_build)
    monkeypatch.setattr(loop, "_fit", port_fit)
    for model_remat, train_remat in ((True, False), (False, True),
                                     (True, True), (False, False)):
        jcfg = JaxExperimentConfig(
            model=JaxModelConfig(remat=model_remat),
            train=JaxTrainConfig(remat=train_remat))
        pcfg = ExperimentConfig(model=ModelConfig(remat=model_remat),
                                train=TrainConfig(remat=train_remat))
        for fn in (lambda: jax_loop.train_stage1(jcfg, None),
                   lambda: jax_loop.train_stage2(jcfg, None, None),
                   lambda: loop.train_stage1(pcfg, None, device="cpu"),
                   lambda: loop.train_stage2(pcfg, None, None, device="cpu")):
            with pytest.raises(_Built):
                fn()
        want = [train_remat, train_remat]
        assert seen["jax"][-2:] == want and seen["port"][-2:] == want


def test_resnest_ignores_remat():
    cfg = ModelConfig(**dict(MODEL, backbone="resnest50", stage_sizes=(1, 1),
                             width=8, head="stage1"))
    a = build_model(cfg, device="cpu")
    b = build_model(dataclasses.replace(cfg, remat=True), device="cpu")
    assert not hasattr(a.backbone, "remat") and not hasattr(b.backbone,
                                                            "remat")
    assert {k: v.shape for k, v in a.state_dict().items()} == {
        k: v.shape for k, v in b.state_dict().items()}


def test_recompute_flag_is_per_thread():
    """A recompute in one thread does not stop another thread's BatchNorm
    from updating its statistics."""
    bn = torch.nn.BatchNorm2d(4)
    x = torch.randn(2, 4, 3, 3)
    inside, done = threading.Event(), threading.Event()

    def recompute():
        with resnet._recomputing():
            inside.set()
            done.wait(10)

    th = threading.Thread(target=recompute)
    th.start()
    inside.wait(10)
    resnet.batch_norm(bn, x, train=True)
    done.set()
    th.join()
    assert int(bn.num_batches_tracked) == 1
    with resnet._recomputing():
        resnet.batch_norm(bn, x, train=True)
    assert int(bn.num_batches_tracked) == 1
