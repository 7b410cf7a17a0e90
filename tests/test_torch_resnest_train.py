"""ResNeSt training: the port's `train_stage1` and `train_stage2` on a
small-depth ResNeSt (stem 32, radix 2, one split-attention block in each of
two stages, width 8) against the JAX package's trainers, on the CPU in
f32, as `test_torch_train_loop.py` holds them on the tiny ResNet.

JAX's trainers run with the model computing in f64 (its parameters f32):
flax's BatchNorm takes the batch variance as E[x^2] - E[x]^2, which in
f32 loses digits at the split attention's fc1, where the batch mean is
~30x its spread (`test_torch_resnest.py`), and the f32 run's stage-2
val loss lands 1.1e-2 relative from the port's. Both packages run two
epochs from the same variables (moved across by
`from_jax_variables`) over the same packed videos, manifests, shuffled
batches and TrainTransform draws, dropout 0; stage 2 (head tmr) over the
same seeded banks. Every epoch's train and val loss within 1e-3
relative, accuracies and learning rates equal, and the final weights and
running statistics within rtol 1e-3 / atol 1e-4 (the ResNet trainers'
limits) plus twice the port's own spread: the port trains again with
one CPU thread, and each tensor may differ from JAX's by that much more
than the ResNet limits. At this depth the stage-1 run is that sensitive
to summation order: with 2 threads the stem's and the first block's
weights and statistics land up to 6.8e-4 from JAX's, and the same
distance from the port's own runs with 1 and 4 threads, which land on
JAX's.

A ResNeSt trainer under train.remat trains bit for bit as without it,
and the split attention's fc1 biases, which `train/step_check.py`
leaves to the aggregates, get a gradient of rounding alone.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tmrnet_tpu.config import DataConfig as JaxDataConfig
from tmrnet_tpu.config import ExperimentConfig as JaxExperimentConfig
from tmrnet_tpu.config import MemoryConfig as JaxMemoryConfig
from tmrnet_tpu.config import ModelConfig as JaxModelConfig
from tmrnet_tpu.config import TrainConfig as JaxTrainConfig
from tmrnet_tpu.memory.lfb import FeatureBank as JaxFeatureBank
from tmrnet_tpu.models.tmrnet import build_model as jax_build_model
from tmrnet_tpu.train import loop as jax_loop
from tmrnet_torch.config import (DataConfig, ExperimentConfig, MemoryConfig,
                                 ModelConfig, TrainConfig)
from tmrnet_torch.memory.lfb import FeatureBank
from tmrnet_torch.models.convert import from_jax_variables
from tmrnet_torch.train import loop

from tests.test_torch_train_loop import (CROP, DATA, JAX, PORT, SEQ, TRAIN,
                                         TRAIN_LENGTHS, VAL_LENGTHS, WIN,
                                         _banks, _datasets, videos)  # noqa: F401

MODEL = dict(backbone="resnest50", stage_sizes=(1, 1), width=8,
             hidden_dim=16, num_classes=5, compute_dtype="float32",
             dropout_stage1=0.0, dropout_head=0.0, dropout_nl=0.0)


def _configs(tmp, head):
    tr = dict(TRAIN, checkpoint_dir=str(tmp / "jax_ck"))
    jcfg = JaxExperimentConfig(
        data=JaxDataConfig(**DATA), model=JaxModelConfig(**dict(
            MODEL, head=head, compute_dtype="float64")),
        memory=JaxMemoryConfig(window=WIN), train=JaxTrainConfig(**tr))
    pcfg = ExperimentConfig(
        data=DataConfig(**DATA), model=ModelConfig(**dict(MODEL, head=head)),
        memory=MemoryConfig(window=WIN),
        train=TrainConfig(**dict(tr, checkpoint_dir=str(tmp / "port_ck"))))
    return jcfg, pcfg


def _init(head):
    clips = jnp.zeros((1, SEQ, CROP, CROP, 3))
    args = (clips, jnp.zeros((1, WIN, 16))) if head != "stage1" else (clips,)
    v = jax_build_model(JaxModelConfig(**dict(MODEL, head=head))).init(
        jax.random.PRNGKey(5), *args)
    return jax.tree_util.tree_map(np.asarray, v)


@pytest.fixture(scope="module", params=["stage1", "tmr"])
def both(request, videos, tmp_path_factory):  # noqa: F811
    head = request.param
    tmp = tmp_path_factory.mktemp(f"resnest_{head}")
    jcfg, pcfg = _configs(tmp, head)
    variables = _init(head)
    jtr, jva = _datasets(videos, JAX)
    ptr, pva = _datasets(videos, PORT)
    jinit = jax.tree_util.tree_map(jnp.asarray, variables)
    pinit = from_jax_variables(variables)
    with jax.enable_x64(True):
        if head == "stage1":
            jstate, jhist = jax_loop.train_stage1(jcfg, jtr, jva,
                                                  init_variables=jinit)
        else:
            jstate, jhist = jax_loop.train_stage2(
                jcfg, jtr, _banks(JaxFeatureBank, TRAIN_LENGTHS, 1), jva,
                _banks(JaxFeatureBank, VAL_LENGTHS, 2), init_variables=jinit)
        jvars = jax.tree_util.tree_map(np.asarray, jstate.variables)
        jstep = int(jstate.step)
    runs = []
    threads = torch.get_num_threads()
    for n in (threads, 1):
        torch.set_num_threads(n)
        ptr, pva = _datasets(videos, PORT)
        cfg = pcfg.replace(train=dataclasses.replace(
            pcfg.train, checkpoint_dir=str(tmp / f"port_ck{n}")))
        try:
            if head == "stage1":
                runs.append(loop.train_stage1(cfg, ptr, pva,
                                              init_state_dict=pinit,
                                              device="cpu"))
            else:
                runs.append(loop.train_stage2(
                    cfg, ptr,
                    _banks(FeatureBank, TRAIN_LENGTHS, 1, device="cpu"),
                    pva, _banks(FeatureBank, VAL_LENGTHS, 2, device="cpu"),
                    init_state_dict=pinit, device="cpu"))
        finally:
            torch.set_num_threads(threads)
    (pstate, phist), (other, _) = runs
    return dict(jhist=jhist, phist=phist, jvars=jvars, jstep=jstep,
                pstate=pstate, other=other.model.state_dict())


def test_resnest_history_matches_jax(both):
    assert len(both["phist"]) == len(both["jhist"]) == 2
    for j, p in zip(both["jhist"], both["phist"]):
        assert p.epoch == j.epoch
        for k in ("train_loss", "val_loss"):
            assert getattr(p, k) == pytest.approx(getattr(j, k), rel=1e-3), k
        assert p.train_acc == pytest.approx(j.train_acc)
        assert p.val_acc == pytest.approx(j.val_acc)
        assert p.lr == pytest.approx(j.lr)
    assert both["pstate"].step == both["jstep"]


def test_resnest_weights_match_jax(both):
    want = from_jax_variables(both["jvars"])
    got = both["pstate"].model.state_dict()
    assert set(got) == set(want) | {k for k in got if "num_batches" in k}
    assert any(".splat." in k for k in got)
    for k, w in want.items():
        if "num_batches" in k:
            continue
        a, b, o = got[k].numpy(), w.numpy(), both["other"][k].numpy()
        spread = float(np.abs(a - o).max())
        assert np.all(np.abs(a - b) <= 1e-4 + 1e-3 * np.abs(b)
                      + 2 * spread), k


def test_resnest_trainer_ignores_remat(videos, tmp_path):  # noqa: F811
    """train.remat on ResNeSt trains as without it, bit for bit (JAX's
    build_backbone passes ResNeSt no remat either)."""
    head = "stage1"
    _, pcfg = _configs(tmp_path, head)
    pcfg = pcfg.replace(train=dataclasses.replace(pcfg.train, epochs=1))
    outs = []
    for remat in (False, True):
        cfg = pcfg.replace(train=dataclasses.replace(
            pcfg.train, remat=remat,
            checkpoint_dir=str(tmp_path / f"ck{int(remat)}")))
        ptr, pva = _datasets(videos, PORT)
        state, _ = loop.train_stage1(cfg, ptr, pva,
                                     init_state_dict=from_jax_variables(
                                         _init(head)), device="cpu")
        outs.append(state.model.state_dict())
    assert all(np.array_equal(outs[0][k].numpy(), outs[1][k].numpy())
               for k in outs[0])


def test_split_attention_fc1_bias_has_no_gradient_but_rounding():
    """`step_check.rounding_only` names the split attention's fc1 biases:
    bn1 takes their batch mean out again in train mode, so their gradient
    is rounding alone (below 1e-5 of fc1's weight gradient, f32), which
    is why the card's f32 step check leaves them to the aggregates."""
    from tmrnet_torch.models.tmrnet import build_model, init_state_dict
    from tmrnet_torch.train.step_check import rounding_only

    cfg = ModelConfig(**dict(MODEL, head="stage1"))
    model = build_model(cfg, device="cpu")
    model.load_state_dict(init_state_dict(cfg, 3))
    clips = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (3, SEQ, CROP, CROP, 3), dtype=np.float32))
    model(clips, train=True).float().square().sum().backward()
    named = dict(model.named_parameters())
    biases = [k for k in named if rounding_only(k)]
    assert biases == [k for k in named if k.endswith("splat.fc1.bias")]
    assert len(biases) == 2
    for k in biases:
        weight = named[k.replace(".bias", ".weight")].grad.abs().max()
        assert float(named[k].grad.abs().max()) <= 1e-5 * float(weight), k
