"""Full ResNet-50 depth: the port's TMRNet (unfolded, and folded with its 12
identity blocks through the fused-bottleneck op) against the flax TMRNet at
hidden 512, on 1 clip of 2 frames at 64x64, in f32 on the CPU.

Tolerance 1e-3 (rtol and atol): the same math, but 53 convolutions deep,
with XLA and PyTorch's CPU kernels summing in different orders; at the
tiny depth the same comparison holds to 1e-4 (test_torch_models.py)."""

import numpy as np

import jax
import jax.numpy as jnp
import torch

from tmrnet_tpu.config import ModelConfig as JaxModelConfig
from tmrnet_tpu.models.fold_bn import fold_variables as jax_fold_variables
from tmrnet_tpu.models.tmrnet import build_model as jax_build_model
from tmrnet_torch.config import ModelConfig
from tmrnet_torch.models.convert import from_jax_variables, random_variables
from tmrnet_torch.models.fold_bn import fold_variables
from tmrnet_torch.models.tmrnet import build_model

torch.set_num_threads(2)

TOL = dict(rtol=1e-3, atol=1e-3)


def test_full_depth_tmrnet_matches_flax():
    kw = dict(backbone="resnet50", hidden_dim=512, num_classes=7, head="tmr",
              compute_dtype="float32")
    rng = np.random.RandomState(0)
    clips = rng.randn(1, 2, 64, 64, 3).astype(np.float32)
    memory = rng.randn(1, 8, 512).astype(np.float32)
    # the port's seeded variables are in the flax layout: both sides use them
    variables = random_variables(ModelConfig(**kw), seed=3)
    jvars = jax.tree_util.tree_map(jnp.asarray, variables)
    want = np.asarray(jax_build_model(JaxModelConfig(**kw)).apply(
        jvars, jnp.asarray(clips), jnp.asarray(memory), train=False))
    assert np.ptp(want) > 0.1            # logits that can tell classes apart

    state = from_jax_variables(variables)
    port = build_model(ModelConfig(**kw), device="cpu")
    port.load_state_dict(state, strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(clips), torch.from_numpy(memory)).numpy()
    np.testing.assert_allclose(got, want, **TOL)

    want_folded = np.asarray(jax_build_model(JaxModelConfig(**kw, folded=True))
                             .apply(jax_fold_variables(jvars), jnp.asarray(clips),
                                    jnp.asarray(memory), train=False))
    folded = build_model(ModelConfig(**kw, folded=True), device="cpu")
    folded.load_state_dict(fold_variables(state), strict=True)
    with torch.no_grad():
        got = folded(torch.from_numpy(clips), torch.from_numpy(memory)).numpy()
    np.testing.assert_allclose(got, want_folded, **TOL)
