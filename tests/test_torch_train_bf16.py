"""How far a bf16 train step lands from the f32 one, in the port and in
the JAX package, on the CPU.

One SGD step (momentum 0.9, weight decay 5e-4) of ResNet-50 widths with
one block a stage, hidden 64, window 30, 4 uint8 clips of 3 frames of
64x64, dropout 0, from the same seeded variables: each package in bf16
against itself in f32. The port's bf16 step lands no further from its f32
step than twice the distance of JAX's bf16 step from JAX's f32 step, in
the cosine of all backbone deltas and in the relative error of all head
and LSTM deltas, and its loss within 1e-2 of its f32 loss. Per tensor
neither package meets cosine >= 0.95 on every backbone delta nor 5e-2 on
every head delta: a BatchNorm after a 1x1 conv leaves the input gradient
summing to zero over positions, so gradients upstream of it cancel down
to bf16's rounding. `train/step_check.py` judges a bf16 step so (its
verdicts are checked here too), and `chip_smoke.py` phase 4g holds the
card with it.
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
from tmrnet_tpu.models.tmrnet import build_model as jax_build_model
from tmrnet_tpu.train.optim import make_optimizer as jax_make_optimizer
from tmrnet_tpu.train.optim import slow_modules_for_head as jax_slow
from tmrnet_tpu.train.state import create_train_state
from tmrnet_tpu.train.steps import make_stage1_steps as jax_stage1_steps
from tmrnet_tpu.train.steps import make_stage2_steps as jax_stage2_steps
from tmrnet_torch.config import DataConfig, ModelConfig, TrainConfig
from tmrnet_torch.data.device_feed import DevicePrep
from tmrnet_torch.models.convert import from_jax_variables, random_variables
from tmrnet_torch.models.tmrnet import build_model
from tmrnet_torch.train.optim import make_optimizer, slow_modules_for_head
from tmrnet_torch.train.state import TrainState
from tmrnet_torch.train.step_check import (TENSOR_LIMIT, aggregate, distance,
                                           is_trunk, verdicts)
from tmrnet_torch.train.steps import make_stage1_steps, make_stage2_steps

torch.set_num_threads(2)

MODEL = dict(backbone="resnet50", stage_sizes=(1, 1, 1, 1), hidden_dim=64,
             dropout_stage1=0.0, dropout_head=0.0, dropout_nl=0.0)
TRAIN = dict(lr=0.05, momentum=0.9, weight_decay=5e-4)


def _batch():
    rng = np.random.default_rng(1)
    return (rng.integers(0, 256, (4, 3, 64, 64, 3), dtype=np.uint8),
            rng.standard_normal((4, 30, 64), dtype=np.float32),
            rng.integers(0, 7, 4))


def _jax_step(head, variables, cdt):
    model = jax_build_model(JaxModelConfig(**MODEL, head=head,
                                           compute_dtype=cdt))
    v = jax.tree_util.tree_map(jnp.asarray, variables)
    tx = jax_make_optimizer(JaxTrainConfig(**TRAIN), v["params"],
                            jax_slow(head))
    make = jax_stage1_steps if head == "stage1" else jax_stage2_steps
    step, _ = make(donate=False, prep=JaxDevicePrep(
        JaxDataConfig(device_normalize=True), cdt))
    clips, memory, labels = _batch()
    args = (jnp.asarray(clips),) + (() if head == "stage1"
                                    else (jnp.asarray(memory),))
    state, m = step(create_train_state(model, v, tx), *args,
                    jnp.asarray(labels), jax.random.PRNGKey(0))
    after = from_jax_variables(jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32), {"params": state.params}))
    return float(m["loss"]), after


def _port_step(head, weights, cdt):
    model = build_model(ModelConfig(**MODEL, head=head, compute_dtype=cdt),
                        device="cpu")
    model.load_state_dict(weights)
    state = TrainState(model, make_optimizer(TrainConfig(**TRAIN), model,
                                             slow_modules_for_head(head)))
    make = make_stage1_steps if head == "stage1" else make_stage2_steps
    step, _ = make(prep=DevicePrep(DataConfig(device_normalize=True), cdt,
                                   "cpu"))
    clips, memory, labels = (torch.from_numpy(a) for a in _batch())
    args = (clips,) + (() if head == "stage1" else (memory,))
    m = step(state, *args, labels, torch.Generator().manual_seed(0))
    return float(m["loss"]), {k: v.detach().float().clone()
                              for k, v in model.named_parameters()}


def _deltas(before, after):
    return {k: after[k].float() - w0.float() for k, w0 in before.items()}


def _deviation(before, f32, bf16):
    """(1 - cosine of all backbone deltas, |bf16 - f32| / |f32| of all
    head and LSTM deltas, backbone tensors under cosine 0.95, head
    tensors over 5e-2)."""
    want, got = _deltas(before, f32), _deltas(before, bf16)
    agg = aggregate(got, want)
    bad = {True: 0, False: 0}
    for k, w in want.items():
        bad[is_trunk(k)] += distance(k, got[k], w) > TENSOR_LIMIT
    return agg["trunk"], agg["head"], bad[True], bad[False]


@pytest.fixture(scope="module", params=["stage1", "tmr"])
def deviations(request):
    head = request.param
    variables = random_variables(ModelConfig(**MODEL, head=head), 3)
    weights = from_jax_variables(variables)
    before = {k: v for k, v in weights.items()
              if "running" not in k and "num_batches" not in k}
    out = {"head": head}
    for name, run in (("jax", lambda c: _jax_step(head, variables, c)),
                      ("port", lambda c: _port_step(head, weights, c))):
        (l32, f32), (l16, b16) = run("float32"), run("bfloat16")
        out[name] = (abs(l16 - l32) / abs(l32),) + _deviation(before, f32,
                                                               b16)
    print(f"\n{head}: (loss rel, 1 - backbone cosine, head rel, backbone "
          f"tensors under 0.95, head tensors over 5e-2) jax {out['jax']} "
          f"port {out['port']}")
    return out


def test_port_bf16_step_deviates_as_jax_does(deviations):
    jax_dev, port = deviations["jax"], deviations["port"]
    assert port[0] <= 1e-2
    assert port[1] <= 2 * jax_dev[1] + 1e-3
    assert port[2] <= 2 * jax_dev[2] + 1e-3


def test_per_tensor_limits_miss_in_jax_too(deviations):
    """The reference's own bf16 step misses cosine 0.95 on some backbone
    tensor: the per-tensor limits alone cannot hold a bf16 step."""
    assert deviations["jax"][3] > 0


def test_step_check_verdicts():
    """Within the limit, within twice a resolving reference, unresolved,
    and failed (also a delta that is not finite), per group's metric."""
    g = torch.Generator().manual_seed(0)
    w = torch.randn(4096, generator=g)
    noise = lambda s: s * w.norm() / 64 * torch.randn(4096, generator=g)
    want = {"backbone.a": w, "backbone.b": w, "fc.c": w, "fc.d": w,
            "fc.e": w, "backbone.f": w}
    got = {"backbone.a": w + noise(0.1), "backbone.b": w + noise(8.0),
           "fc.c": w + noise(0.01), "fc.d": w + noise(0.3),
           "fc.e": w + noise(0.5), "backbone.f": w * float("nan")}
    ref = {"backbone.a": w, "backbone.b": w + noise(8.0),
           "fc.c": w, "fc.d": w + noise(0.2), "fc.e": w + noise(0.1),
           "backbone.f": w}
    v = {k: x[0] for k, x in verdicts(got, ref, want).items()}
    assert v == {"backbone.a": "limit", "backbone.b": "unresolved",
                 "fc.c": "limit", "fc.d": "bf16", "fc.e": "FAIL",
                 "backbone.f": "FAIL"}
    agg = aggregate(got, want)
    assert set(agg) == {"trunk", "head"} and agg["head"] > 0.1
