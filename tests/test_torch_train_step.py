"""The port's training step against the JAX package's, on the CPU in f32.

- Losses: `balanced_class_weights` and `weighted_cross_entropy` (sum, mean,
  none, label smoothing, negative labels) equal JAX's to 1e-6.
- The head's autograd Functions: `time_conv`'s and `nl_attention`'s
  gradients against `jax.grad` of the flax TimeConv and of the einsum
  attention of the flax NLBlock (1e-5), one case with forced ties between
  x and the causal 2-max branch and one with x, two conv branches and the
  2-max branch tied at 0 (only the flax module's nesting of the max splits
  that gradient as JAX does); `torch.autograd.gradcheck` in f64 on the
  plain path.
- The training pieces the step is made of: BatchNorm in train mode against
  flax's (output, running statistics with the biased variance, gradients),
  the LSTM's gradient against `lax.scan`'s, dropout, the fresh init's
  names, shapes and distributions against flax's, and `TimeConv`'s
  prepared kernel copies remade after `optimizer.step()`.
- One whole train step per head (stage1 with the uint8 feed prepared on the
  device, tmr, nl_only) against JAX's jitted `train_step`, as
  `tests/test_train_grad_parity.py` drives it, with the JAX variables moved
  across by `from_jax_variables`, SGD with momentum, weight decay and two
  groups, dropout 0: loss within 1e-4 relative, every parameter's delta
  within rtol 2e-3 / atol 2e-5, BN running statistics within rtol 2e-3 /
  atol 1e-5 (the tolerances of JAX's own test against torch); then a
  second step on other data (the momentum buffers in play), and the eval
  step's loss, per-sample losses, predictions and probabilities (1e-4).
"""


import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tmrnet_tpu.config import DataConfig as JaxDataConfig
from tmrnet_tpu.config import ModelConfig as JaxModelConfig
from tmrnet_tpu.config import TrainConfig as JaxTrainConfig
from tmrnet_tpu.data.device_feed import DevicePrep as JaxDevicePrep
from tmrnet_tpu.models.blocks import TimeConv as JaxTimeConv
from tmrnet_tpu.models.lstm import LSTM as JaxLSTM
from tmrnet_tpu.models.tmrnet import build_model as jax_build_model
from tmrnet_tpu.train import losses as jax_losses
from tmrnet_tpu.train.optim import make_optimizer as jax_make_optimizer
from tmrnet_tpu.train.optim import slow_modules_for_head as jax_slow
from tmrnet_tpu.train.state import create_train_state
from tmrnet_tpu.train.steps import make_stage1_steps as jax_stage1_steps
from tmrnet_tpu.train.steps import make_stage2_steps as jax_stage2_steps
from tmrnet_torch.config import DataConfig, ModelConfig, TrainConfig
from tmrnet_torch.data.device_feed import DevicePrep
from tmrnet_torch.models.blocks import TimeConv, dropout
from tmrnet_torch.models.convert import from_jax_variables
from tmrnet_torch.models.lstm import LSTM
from tmrnet_torch.models.resnet import batch_norm
from tmrnet_torch.models.tmrnet import build_model, init_state_dict
from tmrnet_torch.ops.nl_attention import nl_attention
from tmrnet_torch.ops.time_conv import time_conv
from tmrnet_torch.train import losses
from tmrnet_torch.train.optim import make_optimizer, slow_modules_for_head
from tmrnet_torch.train.state import TrainState
from tmrnet_torch.train.steps import make_stage1_steps, make_stage2_steps

torch.set_num_threads(2)

B, T, HW, HID, WIN, NCLS = 3, 3, 32, 16, 4, 5
LR = 0.05
MODEL = dict(backbone="tiny", stage_sizes=(1, 1), width=8, hidden_dim=HID,
             num_classes=NCLS, compute_dtype="float32", dropout_stage1=0.0,
             dropout_head=0.0, dropout_nl=0.0)
TRAIN = dict(optimizer="sgd", lr=LR, momentum=0.9, weight_decay=5e-4,
             trunk_lr_scale=0.1)


def t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a)).to(dtype)


# -- losses -----------------------------------------------------------------

@pytest.mark.parametrize("reduction", ["sum", "mean", "none"])
@pytest.mark.parametrize("smoothing", [0.0, 0.1])
@pytest.mark.parametrize("weighted", [False, True])
def test_weighted_cross_entropy_matches_jax(reduction, smoothing, weighted):
    rng = np.random.RandomState(0)
    logits = rng.randn(9, NCLS).astype(np.float32) * 3
    labels = rng.randint(0, NCLS, 9)
    labels[[2, 7]] = -1                     # padding
    w = rng.rand(NCLS).astype(np.float32) + 0.5 if weighted else None
    want = jax_losses.weighted_cross_entropy(
        jnp.asarray(logits), jnp.asarray(labels), w, reduction, smoothing)
    got = losses.weighted_cross_entropy(
        t(logits), torch.from_numpy(labels),
        None if w is None else t(w), reduction, smoothing)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_balanced_class_weights_match_jax():
    labels = np.array([0, 0, 0, 1, 3, 3, 1, 0, 6])
    np.testing.assert_allclose(losses.balanced_class_weights(labels, 7),
                               jax_losses.balanced_class_weights(labels, 7),
                               rtol=1e-6)


# -- the head's Functions ----------------------------------------------------

def _time_conv_case(seed, ties):
    rng = np.random.RandomState(seed)
    x = rng.randn(2, 7, 8).astype(np.float32)
    if ties is True:
        # x[t] >= x[t-1] >= 0 on half the rows: max(x, shifted) == x there,
        # a tie between x and the 2-max branch, the other branches below
        x = np.abs(x)
        x[0] = np.sort(x[0], axis=0)
    elif ties:
        # x <= 0, a third of it exactly 0; conv_k5 and conv_k7 zero and
        # conv_k3 at -5: x, the two zero branches and max(x, shifted) tie
        # at 0, where only the flax module's nesting of the max splits the
        # gradient as JAX does
        x = -np.abs(x)
        x[rng.rand(*x.shape) < 1 / 3] = 0.0
    tc = JaxTimeConv(feature_dim=8)
    variables = tc.init(jax.random.PRNGKey(seed), jnp.asarray(x))
    if ties is True:
        variables = jax.tree_util.tree_map(lambda a: a * 0.01 - 5.0,
                                           variables)
    elif ties:
        p = dict(variables["params"])
        p["conv_k3"] = {"kernel": jnp.zeros_like(p["conv_k3"]["kernel"]),
                        "bias": jnp.full_like(p["conv_k3"]["bias"], -5.0)}
        for name in ("conv_k5", "conv_k7"):
            p[name] = jax.tree_util.tree_map(jnp.zeros_like, p[name])
        variables = {"params": p}
    return x, tc, variables


@pytest.mark.parametrize("ties", [False, True, "three_way"])
def test_time_conv_gradients_match_flax(ties):
    x, tc, variables = _time_conv_case(3, ties)
    g = np.random.RandomState(4).randn(*x.shape).astype(np.float32)

    def f(v, xx):
        return jnp.sum(tc.apply(v, xx) * g)

    dv, dx = jax.grad(f, argnums=(0, 1))(variables, jnp.asarray(x))
    port = TimeConv(8)
    port.load_state_dict(from_jax_variables(
        jax.tree_util.tree_map(np.asarray, variables)))
    xt = t(x).requires_grad_()
    (port(xt) * t(g)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dx), rtol=1e-5,
                               atol=1e-5)
    want = from_jax_variables(jax.tree_util.tree_map(np.asarray, dv))
    for name, p in port.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=name)
    if ties is True:
        tied = (x[0, 1:] == np.maximum(x[0, 1:], x[0, :-1])).sum()
        assert tied > 10
    elif ties:
        assert (x == 0).sum() > 20


def test_time_conv_prepared_copies_follow_an_optimizer_step():
    """The kernel's copies are remade once per step: after `step()` they
    equal copies made afresh, and without a change they are kept."""
    port = TimeConv(8)
    torch.nn.init.normal_(port.conv_k3.weight)
    first = port.kernel_args()
    assert port.kernel_args() is first
    opt = torch.optim.SGD(port.parameters(), lr=0.1, momentum=0.9)
    x = torch.randn(2, 5, 8)
    for _ in range(2):
        port(x).square().sum().backward()
        opt.step()
        opt.zero_grad()
        args = port.kernel_args()
        assert args is not first
        fresh = port.conv_k3.weight.detach().permute(2, 1, 0)
        torch.testing.assert_close(args[0], fresh, rtol=0, atol=0)
        first = args


def test_nl_attention_gradients_match_einsum():
    rng = np.random.RandomState(5)
    q, k, v = (rng.randn(*s).astype(np.float32)
               for s in ((3, 16), (3, 6, 16), (3, 6, 16)))
    g = rng.randn(3, 16).astype(np.float32)

    def f(q, k, v):      # tmrnet_tpu/models/blocks.py:53-55, f32
        logits = jnp.einsum("bqf,bwf->bqw", q[:, None], k) * (1.0 / 16) ** 0.5
        out = jnp.einsum("bqw,bwf->bqf", jax.nn.softmax(logits, -1), v)
        return jnp.sum(out[:, 0] * g)

    want = jax.grad(f, argnums=(0, 1, 2))(q, k, v)
    ts = [t(a).requires_grad_() for a in (q, k, v)]
    (nl_attention(*ts) * t(g)).sum().backward()
    for got, w in zip(ts, want):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(w),
                                   rtol=1e-5, atol=1e-5)


def test_functions_pass_gradcheck_in_f64():
    gen = torch.Generator().manual_seed(0)
    r = lambda *s: torch.randn(*s, dtype=torch.float64, generator=gen
                               ).requires_grad_()
    assert torch.autograd.gradcheck(nl_attention, (r(2, 4), r(2, 3, 4),
                                                   r(2, 3, 4)))
    args = (r(2, 5, 4), r(3, 4, 4), r(4), r(5, 4, 4), r(4), r(7, 4, 4), r(4))
    assert torch.autograd.gradcheck(time_conv, args)


# -- BatchNorm, LSTM, dropout, init -----------------------------------------

def test_batch_norm_train_matches_flax():
    import flax.linen as nn

    rng = np.random.RandomState(6)
    x = rng.randn(4, 5, 5, 6).astype(np.float32) * 2 + 1
    g = rng.randn(*x.shape).astype(np.float32)
    bn = nn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    variables = bn.init(jax.random.PRNGKey(0), jnp.asarray(x))
    variables = {"params": {"scale": jnp.asarray(rng.rand(6) + 0.5),
                            "bias": jnp.asarray(rng.randn(6))},
                 "batch_stats": {"mean": jnp.asarray(rng.randn(6)),
                                 "var": jnp.asarray(rng.rand(6) + 0.5)}}

    def f(params, xx):
        y, upd = bn.apply({"params": params,
                           "batch_stats": variables["batch_stats"]}, xx,
                          mutable=["batch_stats"])
        return jnp.sum(y * g), (y, upd["batch_stats"])

    (_, (y, stats)), (dp, dx) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(variables["params"], jnp.asarray(x))
    layer = torch.nn.BatchNorm2d(6)
    layer.load_state_dict({
        "weight": t(variables["params"]["scale"]),
        "bias": t(variables["params"]["bias"]),
        "running_mean": t(variables["batch_stats"]["mean"]),
        "running_var": t(variables["batch_stats"]["var"]),
        "num_batches_tracked": torch.tensor(0)})
    xt = t(x).permute(0, 3, 1, 2).requires_grad_()
    out = batch_norm(layer, xt, train=True)
    (out * t(g).permute(0, 3, 1, 2)).sum().backward()
    tol = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out.detach().permute(0, 2, 3, 1).numpy(),
                               np.asarray(y), **tol)
    np.testing.assert_allclose(layer.running_mean.numpy(),
                               np.asarray(stats["mean"]), **tol)
    np.testing.assert_allclose(layer.running_var.numpy(),
                               np.asarray(stats["var"]), **tol)
    np.testing.assert_allclose(xt.grad.permute(0, 2, 3, 1).numpy(),
                               np.asarray(dx), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(layer.weight.grad.numpy(),
                               np.asarray(dp["scale"]), rtol=1e-4, atol=1e-5)
    # eval mode leaves the statistics alone
    before = layer.running_var.clone()
    with torch.no_grad():
        batch_norm(layer, xt)
    assert torch.equal(layer.running_var, before)


def test_lstm_gradients_match_scan():
    rng = np.random.RandomState(7)
    x = rng.randn(2, 5, 6).astype(np.float32)
    g = rng.randn(2, 5, 4).astype(np.float32)
    lstm = JaxLSTM(4)
    variables = lstm.init(jax.random.PRNGKey(1), jnp.asarray(x))
    variables = jax.tree_util.tree_map(
        lambda a: a + 0.1 * jnp.asarray(rng.randn(*a.shape), a.dtype),
        variables)

    def f(v, xx):
        return jnp.sum(lstm.apply(v, xx)[0] * g)

    dv, dx = jax.grad(f, argnums=(0, 1))(variables, jnp.asarray(x))
    port = LSTM(6, 4)
    port.load_state_dict({k: t(v) for k, v in variables["params"].items()})
    xt = t(x).requires_grad_()
    (port(xt)[0] * t(g)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dx), rtol=1e-5,
                               atol=1e-6)
    for name, p in port.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(),
                                   np.asarray(dv["params"][name]),
                                   rtol=1e-5, atol=1e-6, err_msg=name)


def test_dropout_in_training_only():
    x = torch.ones(4000)
    assert dropout(x, 0.3, False) is x and dropout(x, 0.0, True) is x
    y1 = dropout(x, 0.3, True, torch.Generator().manual_seed(1))
    y2 = dropout(x, 0.3, True, torch.Generator().manual_seed(1))
    assert torch.equal(y1, y2)
    kept = y1 != 0
    assert abs(kept.float().mean().item() - 0.7) < 0.03
    torch.testing.assert_close(y1[kept], torch.full_like(y1[kept], 1 / 0.7))
    assert not dropout(x, 1.0, True).any()


@pytest.mark.parametrize("head", ["stage1", "lfb", "tmr", "nl_only"])
def test_fresh_init_has_flax_names_shapes_and_distributions(head):
    cfg = JaxModelConfig(**dict(MODEL, head=head))
    clips = jnp.zeros((1, T, HW, HW, 3))
    args = (clips, jnp.zeros((1, WIN, HID))) if head in ("tmr", "nl_only") \
        else (clips,)
    want = from_jax_variables(jax.tree_util.tree_map(
        np.asarray, jax_build_model(cfg).init(jax.random.PRNGKey(0), *args)))
    got = init_state_dict(ModelConfig(**dict(MODEL, head=head)), seed=3)
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}
    for k, v in got.items():
        w = want[k].float()
        if k.endswith(("bias", "running_mean", "running_var",
                       "num_batches_tracked")) or v.dim() == 1:
            # constants: zeros, ones
            assert torch.equal(v.float(), w), k
        elif v.numel() >= 256:
            # one draw each: the spread within 15% of flax's
            assert abs(v.std().item() / w.std().item() - 1) < 0.15, k
            assert v.abs().max() <= 2.5 * max(v.std().item(), 1e-9) * 1.74, k
    bigger = init_state_dict(ModelConfig(**dict(MODEL, head=head)), seed=3)
    assert all(torch.equal(got[k], bigger[k]) for k in got)


# -- one whole train step ---------------------------------------------------

def _batch(seed, uint8):
    rng = np.random.RandomState(seed)
    if uint8:
        clips = rng.randint(0, 256, (B, T, HW, HW, 3)).astype(np.uint8)
    else:
        clips = rng.randn(B, T, HW, HW, 3).astype(np.float32)
    memory = rng.randn(B, WIN, HID).astype(np.float32)
    labels = rng.randint(0, NCLS, B)
    labels[-1] = -1 if seed % 2 else labels[-1]     # one padded row
    return clips, memory, labels


def _perturb_stats(variables, seed):
    rng = np.random.RandomState(seed)

    def leaf(path, x):
        name = jax.tree_util.keystr(path[-1:])
        if "var" in name:
            return jnp.asarray(rng.uniform(0.5, 1.5, x.shape), x.dtype)
        if "mean" in name:
            return jnp.asarray(rng.randn(*x.shape) * 0.1, x.dtype)
        return x

    return {"params": variables["params"],
            "batch_stats": jax.tree_util.tree_map_with_path(
                leaf, variables["batch_stats"])}


@pytest.fixture(scope="module", params=["stage1", "tmr", "nl_only"])
def two_steps(request):
    """Two train steps and an eval step of one head, in JAX and in the
    port, from the same variables on the same batches."""
    head = request.param
    memory_head = head != "stage1"
    uint8 = head == "stage1"
    jcfg = JaxModelConfig(**dict(MODEL, head=head))
    model = jax_build_model(jcfg)
    c0, m0, _ = _batch(10, uint8)
    args = (jnp.asarray(c0, jnp.float32),) + (
        (jnp.asarray(m0),) if memory_head else ())
    variables = _perturb_stats(model.init(jax.random.PRNGKey(2), *args), 11)
    w = np.random.RandomState(12).rand(NCLS).astype(np.float32) + 0.5
    tx = jax_make_optimizer(JaxTrainConfig(**TRAIN), variables["params"],
                            jax_slow(head))
    jstate = create_train_state(model, variables, tx)
    data = dict(device_normalize=True)
    make = jax_stage2_steps if memory_head else jax_stage1_steps
    jtrain, jeval = make(class_weights=w, donate=False,
                         prep=JaxDevicePrep(JaxDataConfig(**data), "float32")
                         if uint8 else None)
    port_cfg = ModelConfig(**dict(MODEL, head=head))
    pmodel = build_model(port_cfg, device="cpu")
    pmodel.load_state_dict(from_jax_variables(
        jax.tree_util.tree_map(np.asarray, variables)))
    pstate = TrainState(pmodel, make_optimizer(TrainConfig(**TRAIN), pmodel,
                                               slow_modules_for_head(head)))
    pmake = make_stage2_steps if memory_head else make_stage1_steps
    ptrain, peval = pmake(class_weights=w, prep=DevicePrep(
        DataConfig(**data), "float32", "cpu") if uint8 else None)
    out = {"head": head, "before": from_jax_variables(
        jax.tree_util.tree_map(np.asarray, variables)), "steps": []}
    for seed in (20, 21):
        clips, memory, labels = _batch(seed, uint8)
        jin = (jnp.asarray(clips),) + ((jnp.asarray(memory),)
                                       if memory_head else ())
        jstate, jm = jtrain(jstate, *jin, jnp.asarray(labels),
                            jax.random.PRNGKey(seed))
        pin = (torch.from_numpy(clips),) + ((t(memory),) if memory_head
                                            else ())
        pm = ptrain(pstate, *pin, torch.from_numpy(labels),
                    torch.Generator().manual_seed(seed))
        out["steps"].append(dict(
            jax_metrics={k: np.asarray(v) for k, v in jm.items()},
            port_metrics={k: v.numpy() for k, v in pm.items()},
            jax_after=from_jax_variables(jax.tree_util.tree_map(
                np.asarray, jstate.variables)),
            port_after={k: v.clone() for k, v in
                        pstate.model.state_dict().items()}))
    clips, memory, labels = _batch(30, uint8)
    jin = (jnp.asarray(clips),) + ((jnp.asarray(memory),) if memory_head
                                   else ())
    pin = (torch.from_numpy(clips),) + ((t(memory),) if memory_head else ())
    out["eval"] = ({k: np.asarray(v) for k, v in
                    jeval(jstate, *jin, jnp.asarray(labels)).items()},
                   {k: v.numpy() for k, v in
                    peval(pstate, *pin, torch.from_numpy(labels)).items()})
    out["port_step"] = pstate.step
    return out


def test_train_step_loss_and_counts_match_jax(two_steps):
    for s in two_steps["steps"]:
        jm, pm = s["jax_metrics"], s["port_metrics"]
        assert float(pm["loss"]) == pytest.approx(float(jm["loss"]),
                                                  rel=1e-4)
        assert int(pm["count"]) == int(jm["count"])
        assert int(pm["correct"]) == int(jm["correct"])
    assert two_steps["port_step"] == 2


@pytest.mark.parametrize("step", [0, 1])
def test_train_step_parameter_deltas_match_jax(two_steps, step):
    before = (two_steps["before"] if step == 0
              else two_steps["steps"][0]["jax_after"])
    s = two_steps["steps"][step]
    moved = 0.0
    for k, w0 in before.items():
        if "running" in k or "num_batches" in k:
            continue
        want = s["jax_after"][k].numpy() - w0.numpy()
        got = s["port_after"][k].numpy() - w0.numpy()
        np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-5,
                                   err_msg=f"{two_steps['head']} {k}")
        moved = max(moved, float(np.abs(want).max()))
    assert moved > 1e-6


def test_train_step_batch_stats_match_jax(two_steps):
    n = 0
    for s in two_steps["steps"]:
        for k, v in s["jax_after"].items():
            if "running" in k:
                np.testing.assert_allclose(s["port_after"][k].numpy(),
                                           v.numpy(), rtol=2e-3, atol=1e-5,
                                           err_msg=k)
                n += 1
    assert n > 0


def test_eval_step_matches_jax(two_steps):
    jm, pm = two_steps["eval"]
    assert set(pm) == set(jm)
    for k in ("loss", "losses", "probs"):
        np.testing.assert_allclose(pm[k], jm[k], rtol=1e-4, atol=1e-4,
                                   err_msg=k)
    for k in ("preds", "correct", "count"):
        np.testing.assert_array_equal(pm[k], jm[k], err_msg=k)


def test_dropout_in_a_train_step_is_seeded():
    """With dropout on, the same generator seed gives the same step and
    another seed another; the eval step is untouched by it."""
    cfg = ModelConfig(**dict(MODEL, head="tmr", dropout_head=0.5,
                             dropout_nl=0.5))
    clips, memory, labels = _batch(40, False)

    def run(seed):
        m = build_model(cfg, device="cpu")
        m.load_state_dict(init_state_dict(cfg, 0))
        st = TrainState(m, make_optimizer(TrainConfig(**TRAIN), m,
                                          slow_modules_for_head("tmr")))
        train, _ = make_stage2_steps()
        loss = train(st, t(clips), t(memory), torch.from_numpy(labels),
                     torch.Generator().manual_seed(seed))["loss"]
        return loss, m.state_dict()["fc_c.weight"]

    (l1, w1), (l2, w2), (l3, w3) = run(1), run(1), run(2)
    assert torch.equal(l1, l2) and torch.equal(w1, w2)
    assert not torch.equal(l1, l3)
