"""The port's ResNeSt (`tmrnet_torch/models/resnest.py`) against the flax
modules of `tmrnet_tpu/models/resnest.py`, with the flax variables moved
across by `from_jax_variables`: SplitAttention at cardinality 1 and 2,
ResNeStBottleneck strided and unstrided (an odd input size too), in eval
mode and with `train=True` (outputs and the updated running statistics
against flax's `batch_stats`); the whole trunk at stage sizes (1, 1) and
width 8, unfolded and folded; the port's `fold_resnest` against JAX's; the
four heads on that trunk; ResNeSt-50 TMRNet at full depth; the seeded
variables' tree; `init_state_dict`'s draws; the activation size and trunk
chunk at 224^2.

All in f32 on the CPU. Tolerances (rtol and atol): 1e-5 for a module, 1e-4
for the trunk and the heads, 1e-3 at full depth (53 convolutions summed in
another order by XLA and PyTorch's CPU kernels), 1e-6 for the folded
weights."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tmrnet_tpu.config import ModelConfig as JaxModelConfig
from tmrnet_tpu.models.fold_bn import fold_resnest as jax_fold_resnest
from tmrnet_tpu.models.fold_bn import fold_variables as jax_fold_variables
from tmrnet_tpu.models.resnest import ResNeSt as JaxResNeSt
from tmrnet_tpu.models.resnest import ResNeStBottleneck as JaxBottleneck
from tmrnet_tpu.models.resnest import SplitAttention as JaxSplitAttention
from tmrnet_tpu.models.tmrnet import build_model as jax_build_model
from tmrnet_torch.config import ModelConfig
from tmrnet_torch.eval.infer import plan_trunk_chunk
from tmrnet_torch.models.convert import from_jax_variables, random_variables
from tmrnet_torch.models.fold_bn import fold_resnest, fold_variables
from tmrnet_torch.models.resnest import (ResNeSt, ResNeStBottleneck,
                                         SplitAttention)
from tmrnet_torch.models.tmrnet import build_model, init_state_dict

torch.set_num_threads(2)

MODULE_TOL = dict(rtol=1e-5, atol=1e-5)
TOL = dict(rtol=1e-4, atol=1e-4)
DEEP_TOL = dict(rtol=1e-3, atol=1e-3)
HID, WIN, T, HW = 16, 8, 3, 32


def perturb(variables, seed):
    """Nonzero biases, non-unit norm scales and nontrivial BN statistics, so
    that a dropped or misplaced term shows."""
    rng = np.random.RandomState(seed)

    def leaf(path, x):
        name = jax.tree_util.keystr(path[-1:])
        if "var" in name or "scale" in name:
            return jnp.asarray(rng.uniform(0.5, 1.5, x.shape), x.dtype)
        if "mean" in name or "bias" in name:
            return jnp.asarray(rng.randn(*x.shape) * 0.1, x.dtype)
        return x

    return jax.tree_util.tree_map_with_path(leaf, variables)


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def nchw(x):
    return torch.from_numpy(np.array(x, np.float32)).permute(0, 3, 1, 2)


def nhwc(y):
    return y.detach().permute(0, 2, 3, 1).numpy()


def _check_module(make_jax, port, x, train, tol=MODULE_TOL):
    """The flax module `make_jax(compute_dtype)` and the port's (f32) on
    the NHWC input x: outputs, and with train=True the running statistics
    the step leaves. With train=True the reference runs in f64: flax's
    BatchNorm takes the batch variance as E[x^2] - E[x]^2, which in f32
    loses digits where the batch mean dwarfs the batch spread, as at the
    split attention's fc1 over a few clips (mean ~30x the spread here:
    ~1e-4 off in flax's own f32 result)."""
    dtype = jnp.float64 if train else jnp.float32
    with jax.enable_x64(train):
        jax_module = make_jax(dtype)
        variables = perturb(jax_module.init(jax.random.PRNGKey(0), x), 1)
        port.load_state_dict(from_jax_variables(to_np(variables)), strict=True)
        if train:
            want, upd = jax_module.apply(variables, jnp.asarray(x, dtype),
                                         train=True, mutable=["batch_stats"])
            after = from_jax_variables(to_np({"params": variables["params"],
                                              "batch_stats": upd["batch_stats"]}))
        else:
            want = jax_module.apply(variables, x, train=False)
        want = np.asarray(want)
    port.train(train)
    with torch.no_grad():
        # the trunk takes NHWC frames, a block NCHW activations
        got = port(torch.from_numpy(np.array(x, np.float32))
                   if isinstance(port, ResNeSt) else nchw(x), train=train)
    np.testing.assert_allclose(got.numpy() if got.dim() == 2 else nhwc(got),
                               want, **tol)
    if train:
        state = port.state_dict()
        stats = [k for k in after if k.endswith(("running_mean", "running_var"))]
        assert stats
        for k in stats:
            np.testing.assert_allclose(state[k].numpy(), after[k], **tol,
                                       err_msg=k)
    return got


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("groups", [1, 2])
def test_split_attention_matches_flax(groups, train):
    """At groups 2 the rSoftMax's transpose from cardinality-major to
    radix-major moves the weights; a missing transpose shows."""
    rng = np.random.RandomState(2)
    x = jnp.asarray(rng.randn(3, 6, 5, 16), jnp.float32)
    got = _check_module(
        lambda dt: JaxSplitAttention(16, groups=groups, compute_dtype=dt),
        SplitAttention(16, 16, groups=groups), x, train)
    assert got.shape == (3, 16, 6, 5)


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("strides,hw,cin", [(1, 8, 32), (1, 7, 16),
                                            (2, 8, 16), (2, 10, 32)])
def test_bottleneck_matches_flax(strides, hw, cin, train):
    """Unstrided with an identity and with a projected shortcut (an odd
    size among them), strided (avd after the split attention, avg_down on
    the shortcut)."""
    rng = np.random.RandomState(3)
    x = jnp.asarray(rng.randn(4, hw, hw, cin), jnp.float32)
    got = _check_module(
        lambda dt: JaxBottleneck(planes=8, strides=strides, compute_dtype=dt),
        ResNeStBottleneck(cin, 8, strides), x, train)
    assert got.shape == (4, 32, -(-hw // strides), -(-hw // strides))


def test_strided_bottleneck_at_an_odd_size_raises_as_in_jax():
    """avd rounds up (7 -> 4) and avg_down down (7 -> 3), as JAX has them:
    the residual add fails in both packages."""
    x = jnp.zeros((1, 7, 7, 16), jnp.float32)
    with pytest.raises(TypeError, match="incompatible shapes"):
        JaxBottleneck(planes=8, strides=2).init(jax.random.PRNGKey(0), x)
    with pytest.raises(RuntimeError, match="size of tensor"):
        ResNeStBottleneck(16, 8, 2)(nchw(x))


def _tiny(head="tmr", folded=False):
    return dict(backbone="resnest50", stage_sizes=(1, 1), width=8,
                hidden_dim=HID, num_classes=7, head=head,
                compute_dtype="float32", folded=folded)


@pytest.mark.parametrize("train", [False, True])
def test_trunk_matches_flax_unfolded_and_folded(train):
    """The stem is 32 / 32 / 64 wide whatever the width; folded, the BN
    of every conv and of fc1 sits in its weights."""
    rng = np.random.RandomState(4)
    x = jnp.asarray(rng.randn(2, HW, HW, 3), jnp.float32)
    port = ResNeSt((1, 1), 8)
    assert port.stem_conv3.out_channels == 64 and port.num_features == 64
    got = _check_module(
        lambda dt: JaxResNeSt(stage_sizes=(1, 1), width=8, compute_dtype=dt),
        port, x, train, TOL)
    assert got.shape == (2, 64)
    if train:
        return
    variables = perturb(JaxResNeSt(stage_sizes=(1, 1), width=8).init(
        jax.random.PRNGKey(0), x), 1)
    folded = jax_fold_resnest(variables["params"], variables["batch_stats"])
    want = JaxResNeSt(stage_sizes=(1, 1), width=8, folded=True).apply(
        {"params": folded}, x)
    port = ResNeSt((1, 1), 8, folded=True).eval()
    port.load_state_dict(fold_resnest(from_jax_variables(to_np(variables))),
                         strict=True)
    with torch.no_grad():
        np.testing.assert_allclose(port(torch.from_numpy(np.array(x))).numpy(),
                                   np.asarray(want), **TOL)


def test_fold_resnest_matches_jax():
    x = jnp.zeros((1, HW, HW, 3), jnp.float32)
    variables = perturb(JaxResNeSt(stage_sizes=(1, 1), width=8).init(
        jax.random.PRNGKey(1), x), 2)
    want = from_jax_variables(to_np({"params": jax_fold_resnest(
        variables["params"], variables["batch_stats"])}))
    got = fold_resnest(from_jax_variables(to_np(variables)))
    assert sorted(got) == sorted(want)
    assert "layer1_0.splat.fc1.bias" in got and "layer1_0.splat.bn1.weight" not in got
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), want[key].numpy(),
                                   rtol=1e-6, atol=1e-6, err_msg=key)


@pytest.mark.parametrize("head", ["tmr", "nl_only", "stage1", "lfb"])
def test_heads_on_the_resnest_trunk_match_flax(head):
    """Each head unfolded and folded (each package's fold_variables, which
    picks fold_resnest from the deep stem)."""
    rng = np.random.RandomState(6)
    clips = jnp.asarray(rng.randn(2, T, HW, HW, 3), jnp.float32)
    memory = jnp.asarray(rng.randn(2, WIN, HID), jnp.float32)
    args = (clips, memory) if head in ("tmr", "nl_only") else (clips,)
    model = jax_build_model(JaxModelConfig(**_tiny(head)))
    variables = perturb(model.init(jax.random.PRNGKey(6), *args), 7)
    for folded in (False, True):
        tree = jax_fold_variables(variables) if folded else variables
        want = np.asarray(jax_build_model(JaxModelConfig(
            **_tiny(head, folded))).apply(tree, *args, train=False))
        port = build_model(ModelConfig(**_tiny(head, folded)), device="cpu")
        state = from_jax_variables(to_np(variables))
        port.load_state_dict(fold_variables(state) if folded else state,
                             strict=True)
        with torch.no_grad():
            got = port(*[torch.from_numpy(np.array(a)) for a in args])
        np.testing.assert_allclose(got.numpy(), want, **TOL, err_msg=head)


def test_full_depth_resnest50_tmrnet_matches_flax():
    """ResNeSt-50 TMRNet at hidden 512 on 1 clip of 2 frames at 64^2."""
    kw = dict(backbone="resnest50", hidden_dim=512, num_classes=7, head="tmr",
              compute_dtype="float32")
    rng = np.random.RandomState(0)
    clips = rng.randn(1, 2, 64, 64, 3).astype(np.float32)
    memory = rng.randn(1, 8, 512).astype(np.float32)
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
    np.testing.assert_allclose(got, want, **DEEP_TOL)

    want_folded = np.asarray(jax_build_model(JaxModelConfig(**kw, folded=True))
                             .apply(jax_fold_variables(jvars), jnp.asarray(clips),
                                    jnp.asarray(memory), train=False))
    folded = build_model(ModelConfig(**kw, folded=True), device="cpu")
    folded.load_state_dict(fold_variables(state), strict=True)
    with torch.no_grad():
        got = folded(torch.from_numpy(clips), torch.from_numpy(memory)).numpy()
    np.testing.assert_allclose(got, want_folded, **DEEP_TOL)


def test_fresh_init_draws_flax_distributions():
    """fc1 / fc2 of the split attention are flax Dense at its default
    lecun-normal init (std 1/sqrt(fan_in), not the heads' xavier); the 1-D
    BatchNorm of fc1 starts at scale 1, shift 0, mean 0 and variance 1."""
    kw = dict(backbone="resnest50", stage_sizes=(1, 1), width=32,
              hidden_dim=HID, head="lfb", compute_dtype="float32")
    clips = jnp.zeros((1, 2, HW, HW, 3))
    want = from_jax_variables(to_np(jax_build_model(JaxModelConfig(**kw)).init(
        jax.random.PRNGKey(0), clips)))
    got = init_state_dict(ModelConfig(**kw), seed=3)
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}
    fcs = [k for k in got if ".splat.fc" in k and k.endswith("weight")]
    assert len(fcs) == 4
    for k in fcs:
        w = got[k]
        lecun = 1.0 / np.sqrt(w.shape[1])
        assert abs(w.std().item() / lecun - 1) < 0.1, k
        assert abs(w.std().item() / want[k].std().item() - 1) < 0.15, k
    for k in [k for k in got if ".splat.bn1." in k]:
        assert torch.equal(got[k].float(), want[k].float()), k
        if k.endswith(("weight", "running_var")):
            assert torch.equal(got[k], torch.ones_like(got[k])), k


@pytest.mark.parametrize("head", ["tmr", "lfb"])
def test_random_variables_load_into_every_form(head):
    """The seeded variables have flax's tree, and load into the port's
    model unfolded and, through fold_variables, folded."""
    kw = _tiny(head)
    jax_model = jax_build_model(JaxModelConfig(**kw))
    clips = jnp.zeros((1, 2, HW, HW, 3))
    args = (clips, jnp.zeros((1, WIN, HID))) if head == "tmr" else (clips,)
    init = jax.eval_shape(lambda: jax_model.init(jax.random.PRNGKey(0), *args))
    ours = random_variables(ModelConfig(**kw), seed=0)
    assert (jax.tree_util.tree_structure(ours["params"])
            == jax.tree_util.tree_structure(to_np(init["params"])))
    state = from_jax_variables(ours)
    build_model(ModelConfig(**kw), device="cpu").load_state_dict(state,
                                                                 strict=True)
    build_model(ModelConfig(**_tiny(head, True)), device="cpu").load_state_dict(
        fold_variables(state), strict=True)


def test_activation_elements_and_trunk_chunk_at_224():
    """ResNeSt-50's largest activation at 224^2 is 802,816 elements a
    frame: the stem's third conv (112^2 x 64), stage 1's outputs (56^2 x
    256) and stage 2's first split-attention conv (56^2 x 128 x 2, before
    its pool); the index limit gives a 2,048-frame chunk."""
    trunk = build_model(ModelConfig(backbone="resnest50", head="lfb"),
                        device="cpu").backbone
    per_frame = trunk.activation_elements(224, 224)
    assert per_frame == 802_816 == 112 * 112 * 64 == 56 * 56 * 128 * 2
    assert plan_trunk_chunk(per_frame, 2) == 2048
    assert plan_trunk_chunk(per_frame, 2, available_bytes=80 * 2**30) == 2048
    # at width 8 the 64-wide stem is the largest; odd sizes round up
    assert ResNeSt((1, 1), 8).activation_elements(25, 23) == 13 * 12 * 64
    # the largest tensor any op of the forward makes, on a 64^2 frame
    from torch.utils._python_dispatch import TorchDispatchMode

    class Largest(TorchDispatchMode):
        most = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for o in (out if isinstance(out, (tuple, list)) else (out,)):
                if isinstance(o, torch.Tensor) and o.dim() >= 4:  # activations
                    Largest.most = max(Largest.most, o.numel())
            return out

    model = ResNeSt((3, 4, 6, 3), 64).eval()
    with torch.no_grad(), Largest():
        model(torch.zeros(1, 64, 64, 3))
    assert Largest.most == model.activation_elements(64, 64) == 32 * 32 * 64
