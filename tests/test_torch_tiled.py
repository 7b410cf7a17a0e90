"""The port's tiled fused-bottleneck path against the JAX package's, on the
CPU in f32: the op `fused_bottleneck_tiled` against the Pallas kernel run in
interpret mode; the folded ResNet with kernel="tiled" against
`apply_fused_resnet(kernel="tiled")`; the TMRNet with fused_kernel="tiled"
against `fused_tmr_apply(kernel="tiled")`; and which kernel each identity
block of a full-width ResNet-50 takes.

Tolerances: the op 1e-4 (rtol and atol, as the JAX kernel's own test holds
it to its oracle); the trunk 5e-4 / 1e-3 (atol / rtol, as
tests/test_fused_resnet.py); the whole model 1e-3. The same math, summed in
other orders by XLA and by PyTorch's CPU kernels."""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import tmrnet_tpu.experimental.fused_resnet as jax_fr
from tests.test_fold_bn import _nontrivial_stats
from tmrnet_tpu.config import ModelConfig as JaxModelConfig
from tmrnet_tpu.experimental.fused_bottleneck_tiled import (
    fused_bottleneck_tiled as jax_fused_bottleneck_tiled,
)
from tmrnet_tpu.models.fold_bn import fold_resnet as jax_fold_resnet
from tmrnet_tpu.models.fold_bn import fold_variables as jax_fold_variables
from tmrnet_tpu.models.resnet import ResNet as JaxResNet
from tmrnet_tpu.models.tmrnet import build_model as jax_build_model
from tmrnet_torch.config import ModelConfig
from tmrnet_torch.experimental.fused_bottleneck_tiled import (
    fused_bottleneck_plain,
    fused_bottleneck_tiled,
)
from tmrnet_torch.models import resnet as port_resnet
from tmrnet_torch.models.convert import from_jax_variables
from tmrnet_torch.models.fold_bn import fold_resnet
from tmrnet_torch.models.resnet import ResNet
from tmrnet_torch.models.tmrnet import build_model

torch.set_num_threads(2)


def _weights(c, p, seed):
    """As tests/test_fused_bottleneck.py::_weights: (w1, b1, w2, b2, w3, b3)."""
    rng = np.random.RandomState(seed)
    scale = 1.0 / np.sqrt(c)
    return (rng.randn(c, p).astype(np.float32) * scale,
            rng.randn(p).astype(np.float32) * 0.1,
            rng.randn(3, 3, p, p).astype(np.float32) * scale * 0.3,
            rng.randn(p).astype(np.float32) * 0.1,
            rng.randn(p, c).astype(np.float32) * scale,
            rng.randn(c).astype(np.float32) * 0.1)


def _interpret_tiled():
    return functools.partial(jax_fused_bottleneck_tiled, interpret=True)


# The shapes of tests/test_fused_bottleneck.py:64-85: two H tiles, one tile.
@pytest.mark.parametrize("n,h,c,p,block_h,seed", [(4, 8, 64, 16, 4, 2),
                                                  (2, 6, 32, 8, 6, 3)])
def test_tiled_op_matches_the_pallas_kernel(n, h, c, p, block_h, seed):
    x = np.random.RandomState(seed + 10).randn(n, h, h, c).astype(np.float32)
    ws = _weights(c, p, seed)
    want = np.asarray(jax_fused_bottleneck_tiled(
        jnp.asarray(x), *map(jnp.asarray, ws), block_n=2, block_h=block_h,
        interpret=True))
    got = fused_bottleneck_tiled(torch.from_numpy(x),
                                 *map(torch.from_numpy, ws))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)
    # the tiled op's plain version is the block op's
    plain = fused_bottleneck_plain(torch.from_numpy(x),
                                   *map(torch.from_numpy, ws))
    assert torch.equal(got, plain)


def test_tiled_op_refuses_other_devices():
    x = torch.zeros(1, 2, 2, 64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fused_bottleneck_tiled(x, *(torch.zeros(1, device="meta"),) * 6)


def test_folded_resnet_tiled_matches_apply_fused_resnet(monkeypatch):
    stage_sizes, width = (2, 2), 8
    x = jax.random.normal(jax.random.PRNGKey(3), (3, 64, 64, 3))
    model = JaxResNet(stage_sizes=stage_sizes, width=width)
    variables = _nontrivial_stats(model.init(jax.random.PRNGKey(4), x))
    folded = jax_fold_resnet(variables["params"], variables["batch_stats"])
    monkeypatch.setattr(jax_fr, "fused_bottleneck_tiled", _interpret_tiled())
    want = np.asarray(jax_fr.apply_fused_resnet(folded, x, stage_sizes,
                                                use_fused=True, kernel="tiled"))

    state = from_jax_variables(jax.tree_util.tree_map(np.asarray, variables))
    port = ResNet(stage_sizes, width, folded=True, kernel="tiled")
    port.load_state_dict(fold_resnet(state), strict=True)
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(np.array(x)))
    np.testing.assert_allclose(got.numpy(), want, atol=5e-4, rtol=1e-3)


def test_tmrnet_tiled_matches_fused_tmr_apply(monkeypatch):
    kw = dict(backbone="resnet50", stage_sizes=(2, 2), width=8,
              hidden_dim=16, num_classes=7, head="tmr",
              compute_dtype="float32")
    rng = np.random.RandomState(5)
    clips = rng.randn(2, 3, 64, 64, 3).astype(np.float32)
    memory = rng.randn(2, 6, 16).astype(np.float32)
    model = jax_build_model(JaxModelConfig(**kw))
    variables = _nontrivial_stats(model.init(
        jax.random.PRNGKey(6), jnp.asarray(clips), jnp.asarray(memory)))
    folded = jax_fold_variables(variables)
    monkeypatch.setattr(jax_fr, "fused_bottleneck_tiled", _interpret_tiled())
    want = np.asarray(jax_fr.fused_tmr_apply(
        folded, jnp.asarray(clips), jnp.asarray(memory), hidden_dim=16,
        stage_sizes=(2, 2), kernel="tiled"))

    port = build_model(ModelConfig(**kw, folded=True), device="cpu",
                       fused_kernel="tiled")
    port.load_state_dict(from_jax_variables(
        jax.tree_util.tree_map(np.asarray, folded)), strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(clips), torch.from_numpy(memory))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3, rtol=1e-3)


@pytest.mark.parametrize("kernel,want", [
    ("tiled", {"tiled": 10, "block": 2}), ("block", {"tiled": 0, "block": 12})])
def test_full_width_resnet50_sends_each_identity_block_where_jax_does(
        monkeypatch, kernel, want):
    """As fused_resnet.py:91: under "tiled", identity blocks with C < 2048
    (stages 1-3: 2 + 3 + 5) take the tiled kernel and stage 4's 2 the block
    kernel. Run on the meta device with both ops replaced by recorders."""
    seen = {"tiled": [], "block": []}

    def recorder(key):
        def op(x, *weights):
            seen[key].append(x.shape[-1])
            return x
        return op

    monkeypatch.setattr(port_resnet, "fused_bottleneck_tiled", recorder("tiled"))
    monkeypatch.setattr(port_resnet, "fused_bottleneck", recorder("block"))
    with torch.device("meta"):
        net = ResNet((3, 4, 6, 3), 64, folded=True, kernel=kernel)
        net(torch.zeros(2, 224, 224, 3))
    assert {k: len(v) for k, v in seen.items()} == want
    assert all(c < 2048 for c in seen["tiled"])
    assert set(seen["block"]) == ({2048} if kernel == "tiled"
                                  else {256, 512, 1024, 2048})


def test_unknown_fused_kernel_raises():
    with pytest.raises(ValueError, match="fused kernel"):
        ResNet((1, 1), 8, folded=True, kernel="wide")
    with pytest.raises(ValueError, match="fused kernel"):
        build_model(ModelConfig(backbone="tiny", hidden_dim=16,
                                compute_dtype="float32"),
                    device="cpu", fused_kernel="wide")
