"""The port's optimizers, clip, accumulation and schedules against the JAX
package's optax chains, on the CPU in f32.

A model of two top-level modules ("backbone", the slow group, and "fc")
takes the same seeded gradients on both sides for three steps; the
parameters after every step agree within rtol 1e-5 (atol 1e-7): SGD with
and without momentum, dampening, Nesterov and weight decay, Adam with and
without weight decay, the global-norm clip above and below its bound, and
grad_accum = 2 (optax.MultiSteps, also against one step on the mean of
the two micro-batches' gradients). The schedules give JAX's rates epoch
for epoch, the groups are JAX's per head, and Nesterov with dampening
raises as it does in JAX.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from tmrnet_tpu.config import TrainConfig as JaxTrainConfig
from tmrnet_tpu.train import optim as jax_optim
from tmrnet_torch.config import TrainConfig
from tmrnet_torch.train import optim
from tmrnet_torch.train.state import TrainState

torch.set_num_threads(2)

SHAPES = {"backbone": {"w": (4, 3), "b": (3,)}, "fc": {"w": (3, 2)}}
TOL = dict(rtol=1e-5, atol=1e-7)


class Toy(torch.nn.Module):
    def __init__(self, params):
        super().__init__()
        for top, leaves in params.items():
            mod = torch.nn.Module()
            for name, a in leaves.items():
                mod.register_parameter(name, torch.nn.Parameter(
                    torch.from_numpy(np.array(a))))
            self.add_module(top, mod)


def _params(seed=0):
    rng = np.random.RandomState(seed)
    return {top: {n: rng.randn(*s).astype(np.float32) for n, s in d.items()}
            for top, d in SHAPES.items()}


def _grads(step, scale=1.0):
    rng = np.random.RandomState(100 + step)
    return {top: {n: (rng.randn(*s) * scale).astype(np.float32)
                  for n, s in d.items()} for top, d in SHAPES.items()}


def _run(cfg_kw, steps=3, scale=1.0, micro=1):
    """Both sides over `steps` optimizer calls of `micro` gradients each;
    returns the parameters after every call, JAX's and the port's."""
    params = jax.tree_util.tree_map(jnp.asarray, _params())
    tx = jax_optim.make_optimizer(JaxTrainConfig(**cfg_kw), params)
    opt_state = tx.init(params)
    model = Toy(_params())
    state = TrainState(model, optim.make_optimizer(TrainConfig(**cfg_kw),
                                                   model),
                       grad_accum=cfg_kw.get("grad_accum", 1),
                       grad_clip=cfg_kw.get("grad_clip", 0.0))
    out = []
    for step in range(steps * micro):
        g = _grads(step, scale)
        updates, opt_state = tx.update(
            jax.tree_util.tree_map(jnp.asarray, g), opt_state, params)
        params = optax.apply_updates(params, updates)
        for top, leaves in g.items():
            for name, a in leaves.items():
                getattr(getattr(model, top), name).grad = torch.from_numpy(a)
        state.apply_gradients()
        if (step + 1) % micro == 0:
            got = {top: {n: getattr(getattr(model, top), n).detach().numpy()
                         .copy() for n in d} for top, d in SHAPES.items()}
            out.append((jax.tree_util.tree_map(np.asarray, params), got))
    assert state.step == steps * micro
    return out


def _assert_same(out):
    for want, got in out:
        for top, d in SHAPES.items():
            for n in d:
                np.testing.assert_allclose(got[top][n], want[top][n], **TOL,
                                           err_msg=f"{top}.{n}")


SGD = [dict(momentum=0.0, weight_decay=0.0),
       dict(momentum=0.9, weight_decay=5e-4),
       dict(momentum=0.9, weight_decay=5e-4, dampening=0.3),
       dict(momentum=0.9, weight_decay=5e-4, nesterov=True),
       dict(momentum=0.0, weight_decay=1e-2, nesterov=True)]


@pytest.mark.parametrize("kw", SGD, ids=lambda kw: "-".join(
    f"{k}{v}" for k, v in kw.items()))
def test_sgd_matches_optax(kw):
    _assert_same(_run(dict(optimizer="sgd", lr=0.1, trunk_lr_scale=0.1,
                           **kw)))


@pytest.mark.parametrize("wd", [0.0, 5e-4])
def test_adam_matches_optax(wd):
    _assert_same(_run(dict(optimizer="adam", lr=1e-2, weight_decay=wd,
                           trunk_lr_scale=0.1)))


@pytest.mark.parametrize("scale", [0.1, 10.0], ids=["below", "above"])
def test_grad_clip_matches_optax(scale):
    # the gradients' global norm is ~0.4 (below 1) or ~40 (clipped)
    _assert_same(_run(dict(optimizer="sgd", lr=0.1, momentum=0.9,
                           grad_clip=1.0), scale=scale))


@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_grad_accum_matches_multisteps(opt):
    kw = dict(optimizer=opt, lr=0.05, momentum=0.9, weight_decay=5e-4,
              grad_accum=2, grad_clip=1.0)
    _assert_same(_run(kw, micro=2))


def test_grad_accum_is_one_step_on_the_mean():
    """Two micro-steps at grad_accum = 2 move the parameters as one step
    on the mean of their gradients, and not before the second."""
    model = Toy(_params())
    state = TrainState(model, optim.make_optimizer(
        TrainConfig(optimizer="sgd", lr=0.1, momentum=0.9), model),
        grad_accum=2)
    ref = Toy(_params())
    ref_state = TrainState(ref, optim.make_optimizer(
        TrainConfig(optimizer="sgd", lr=0.1, momentum=0.9), ref))
    g0, g1 = _grads(0), _grads(1)
    for g in (g0, g1):
        for top, leaves in g.items():
            for n, a in leaves.items():
                getattr(getattr(model, top), n).grad = torch.from_numpy(a)
        before = model.fc.w.detach().clone()
        state.apply_gradients()
        if g is g0:
            assert torch.equal(model.fc.w, before)
    for top, leaves in g0.items():
        for n, a in leaves.items():
            getattr(getattr(ref, top), n).grad = torch.from_numpy(
                (a + g1[top][n]) / 2)
    ref_state.apply_gradients()
    for (n, p), (_, r) in zip(model.named_parameters(),
                              ref.named_parameters()):
        torch.testing.assert_close(p, r, rtol=1e-6, atol=1e-7, msg=n)


def test_learning_rate_is_set_per_group():
    model = Toy(_params())
    opt = optim.make_optimizer(TrainConfig(lr=0.2, trunk_lr_scale=0.1),
                               model)
    assert [g["lr"] for g in opt.param_groups] == pytest.approx([0.02, 0.2])
    optim.set_learning_rate(opt, 0.5)
    assert [g["lr"] for g in opt.param_groups] == pytest.approx([0.05, 0.5])
    assert optim.current_learning_rate(opt) == pytest.approx(0.5)
    params = jax.tree_util.tree_map(jnp.asarray, _params())
    tx = jax_optim.make_optimizer(JaxTrainConfig(lr=0.2), params)
    state = jax_optim.set_learning_rate(tx.init(params), 0.5)
    assert jax_optim.current_learning_rate(state) == pytest.approx(
        optim.current_learning_rate(opt))


@pytest.mark.parametrize("kind", ["step", "plateau", "constant"])
def test_schedules_match_jax(kind):
    kw = dict(schedule=kind, lr=0.3, step_size=2, gamma=0.5,
              plateau_factor=0.2, plateau_patience=1)
    mine = optim.make_schedule(TrainConfig(**kw))
    theirs = jax_optim.make_schedule(JaxTrainConfig(**kw))
    vals = [1.0, 0.9, 0.95, 0.95, 0.97, 0.5, 0.6, 0.7, 0.8]
    for epoch, v in enumerate(vals):
        assert mine(epoch + 1, v) == pytest.approx(theirs(epoch + 1, v))
    if kind == "plateau":
        assert (mine.best, mine.bad_epochs, mine.scale) == (
            theirs.best, theirs.bad_epochs, pytest.approx(theirs.scale))


def test_groups_and_refusals_match_jax():
    for head in ("stage1", "lfb", "tmr", "nl_only"):
        assert tuple(optim.slow_modules_for_head(head)) == tuple(
            jax_optim.slow_modules_for_head(head))
    model = Toy(_params())
    groups = optim.param_groups(model, ("backbone",))
    assert [len(groups["slow"]), len(groups["fast"])] == [2, 1]
    cfg = dict(optimizer="sgd", dampening=0.1, nesterov=True)
    with pytest.raises(ValueError, match="nesterov"):
        jax_optim.make_optimizer(JaxTrainConfig(**cfg),
                                 jax.tree_util.tree_map(jnp.asarray,
                                                        _params()))
    with pytest.raises(ValueError, match="nesterov"):
        optim.make_optimizer(TrainConfig(**cfg), model)
    with pytest.raises(ValueError, match="unknown optimizer"):
        optim.make_optimizer(TrainConfig(optimizer="lion"), model)
    with pytest.raises(ValueError, match="unknown schedule"):
        optim.make_schedule(TrainConfig(schedule="cosine"))
