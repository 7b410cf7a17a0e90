"""The port's modules against the flax modules of the JAX package, with the
flax variables moved across by `from_jax_variables`: NLBlock, TimeConv,
LSTM, ResNet (unfolded and folded, the folded identity blocks through the
fused-bottleneck op), TMRNet heads tmr and nl_only, the stage-1 head and
the LFB extractor; the port's BN folding against JAX's; and the seeded
random variables against the flax tree.

All in f32 on the CPU. Tolerance 1e-4 (rtol and atol): the same math with
sums taken in another order by XLA and by PyTorch's CPU kernels."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tmrnet_tpu.config import ModelConfig as JaxModelConfig
from tmrnet_tpu.models.blocks import NLBlock as JaxNLBlock
from tmrnet_tpu.models.blocks import TimeConv as JaxTimeConv
from tmrnet_tpu.models.fold_bn import fold_resnet as jax_fold_resnet
from tmrnet_tpu.models.fold_bn import fold_variables as jax_fold_variables
from tmrnet_tpu.models.lstm import LSTM as JaxLSTM
from tmrnet_tpu.models.resnet import ResNet as JaxResNet
from tmrnet_tpu.models.tmrnet import build_model as jax_build_model
from tmrnet_torch.config import ModelConfig
from tmrnet_torch.models.blocks import NLBlock, TimeConv
from tmrnet_torch.models.convert import from_jax_variables, random_variables
from tmrnet_torch.models.fold_bn import fold_resnet, fold_variables
from tmrnet_torch.models.lstm import LSTM
from tmrnet_torch.models.resnet import ResNet
from tmrnet_torch.models.tmrnet import build_model

torch.set_num_threads(2)

TOL = dict(rtol=1e-4, atol=1e-4)
HID, WIN, T, HW = 16, 8, 3, 32


def perturb(variables, seed):
    """Nonzero biases, non-unit norm scales and nontrivial BN statistics, so
    that a dropped or misplaced term shows."""
    rng = np.random.RandomState(seed)

    def leaf(path, x):
        name = jax.tree_util.keystr(path[-1:])
        if "var" in name:
            return jnp.asarray(rng.uniform(0.5, 1.5, x.shape), x.dtype)
        if "scale" in name:
            return jnp.asarray(rng.uniform(0.5, 1.5, x.shape), x.dtype)
        if "mean" in name or "bias" in name:
            return jnp.asarray(rng.randn(*x.shape) * 0.1, x.dtype)
        return x

    return jax.tree_util.tree_map_with_path(leaf, variables)


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def load(module, variables):
    module.load_state_dict(from_jax_variables(to_np(variables)), strict=True)
    return module.eval()


def t(a):
    return torch.from_numpy(np.array(a, np.float32))


def test_nlblock_matches_flax():
    rng = np.random.RandomState(0)
    st, lt = rng.randn(3, HID), rng.randn(3, WIN, HID)
    block = JaxNLBlock(feature_dim=HID)
    variables = perturb(block.init(jax.random.PRNGKey(0), jnp.asarray(st),
                                   jnp.asarray(lt)), 1)
    want = block.apply(variables, jnp.asarray(st, jnp.float32),
                       jnp.asarray(lt, jnp.float32), deterministic=True)
    port = load(NLBlock(HID), variables)
    with torch.no_grad():
        got = port(t(st), t(lt))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("window", [8, 5])
def test_timeconv_matches_flax(window):
    rng = np.random.RandomState(window)
    x = jnp.asarray(rng.randn(2, window, HID), jnp.float32)
    block = JaxTimeConv(feature_dim=HID)
    variables = perturb(block.init(jax.random.PRNGKey(1), x), 2)
    want = block.apply(variables, x)
    port = load(TimeConv(HID), variables)
    with torch.no_grad():
        got = port(t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("initial", [False, True])
def test_lstm_matches_flax(initial):
    """Outputs and the final (h, c), from zeros or from a given state."""
    rng = np.random.RandomState(2)
    x = jnp.asarray(rng.randn(2, T, 24), jnp.float32)
    state = (tuple(jnp.asarray(rng.randn(2, HID), jnp.float32)
                   for _ in range(2)) if initial else None)
    lstm = JaxLSTM(hidden_dim=HID)
    variables = perturb(lstm.init(jax.random.PRNGKey(2), x), 3)
    want, (want_h, want_c) = lstm.apply(variables, x, state)
    port = load(LSTM(24, HID), variables)
    with torch.no_grad():
        got, (h, c) = port(t(x), None if state is None
                           else tuple(t(s) for s in state))
    tol = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)
    np.testing.assert_allclose(h.numpy(), np.asarray(want_h), **tol)
    np.testing.assert_allclose(c.numpy(), np.asarray(want_c), **tol)
    np.testing.assert_array_equal(h.numpy(), got[:, -1].numpy())


# (2, 1) x width 8 has one stride-1 identity block (layer1_1), so the folded
# port runs it through the fused-bottleneck op.
@pytest.mark.parametrize("stage_sizes", [(1, 1), (2, 1)])
def test_resnet_unfolded_and_folded_match_flax(stage_sizes):
    rng = np.random.RandomState(3)
    x = jnp.asarray(rng.randn(2, HW, HW, 3), jnp.float32)
    net = JaxResNet(stage_sizes=stage_sizes, width=8)
    variables = perturb(net.init(jax.random.PRNGKey(3), x), 4)
    want = np.asarray(net.apply(variables, x, train=False))

    port = load(ResNet(stage_sizes, 8), variables)
    with torch.no_grad():
        np.testing.assert_allclose(port(t(x)).numpy(), want, **TOL)

    folded_jax = {"params": jax_fold_resnet(variables["params"],
                                            variables["batch_stats"])}
    want_folded = np.asarray(JaxResNet(stage_sizes=stage_sizes, width=8,
                                       folded=True).apply(folded_jax, x))
    np.testing.assert_allclose(want_folded, want, **TOL)
    state = from_jax_variables(to_np(variables))
    folded = ResNet(stage_sizes, 8, folded=True)
    folded.load_state_dict(fold_resnet(state), strict=True)
    with torch.no_grad():
        np.testing.assert_allclose(folded.eval()(t(x)).numpy(), want_folded,
                                   **TOL)


def _tiny(head, folded=False):
    return dict(backbone="tiny", stage_sizes=(1, 1), width=8, hidden_dim=HID,
                num_classes=7, head=head, compute_dtype="float32",
                folded=folded)


@pytest.mark.parametrize("head", ["tmr", "nl_only"])
def test_tmrnet_matches_flax(head):
    rng = np.random.RandomState(4)
    clips = jnp.asarray(rng.randn(2, T, HW, HW, 3), jnp.float32)
    memory = jnp.asarray(rng.randn(2, WIN, HID), jnp.float32)
    model = jax_build_model(JaxModelConfig(**_tiny(head)))
    variables = perturb(model.init(jax.random.PRNGKey(4), clips, memory), 5)
    want = np.asarray(model.apply(variables, clips, memory, train=False))

    port = build_model(ModelConfig(**_tiny(head)), device="cpu")
    load(port, variables)
    with torch.no_grad():
        got = port(t(clips), t(memory)).numpy()
    np.testing.assert_allclose(got, want, **TOL)

    folded = jax_fold_variables(variables)
    want_folded = np.asarray(jax_build_model(JaxModelConfig(
        **_tiny(head, True))).apply(folded, clips, memory, train=False))
    port_folded = build_model(ModelConfig(**_tiny(head, True)), device="cpu")
    load(port_folded, folded)
    with torch.no_grad():
        got = port_folded(t(clips), t(memory)).numpy()
    np.testing.assert_allclose(got, want_folded, **TOL)


def _init(head, key, clips, memory):
    """The flax variables of head `head` (the memory heads take a memory
    window, stage1 and lfb the clips alone)."""
    model = jax_build_model(JaxModelConfig(**_tiny(head)))
    args = (clips, memory) if head in ("tmr", "nl_only") else (clips,)
    return model.init(jax.random.PRNGKey(key), *args)


@pytest.mark.parametrize("head", ["stage1", "lfb"])
def test_stage1_and_lfb_heads_match_flax(head):
    """stage1: (B, T, classes) logits; lfb: (B, hidden) features; unfolded
    and folded, the weights carried by from_jax_variables and folded by
    each package's fold_variables."""
    rng = np.random.RandomState(6)
    clips = jnp.asarray(rng.randn(2, T, HW, HW, 3), jnp.float32)
    variables = perturb(_init(head, 6, clips, None), 7)
    for folded, tree in ((False, variables), (True, jax_fold_variables(variables))):
        want = np.asarray(jax_build_model(JaxModelConfig(
            **_tiny(head, folded))).apply(tree, clips, train=False))
        assert want.shape == ((2, T, 7) if head == "stage1" else (2, HID))
        port = build_model(ModelConfig(**_tiny(head, folded)), device="cpu")
        load(port, tree)
        with torch.no_grad():
            np.testing.assert_allclose(port(t(clips)).numpy(), want, **TOL)


@pytest.mark.parametrize("head", ["tmr", "stage1", "lfb"])
def test_fold_variables_matches_jax(head):
    rng = np.random.RandomState(5)
    clips = jnp.asarray(rng.randn(1, 2, HW, HW, 3), jnp.float32)
    memory = jnp.asarray(rng.randn(1, WIN, HID), jnp.float32)
    variables = perturb(_init(head, 5, clips, memory), 6)
    want = from_jax_variables(to_np(jax_fold_variables(variables)))
    got = fold_variables(from_jax_variables(to_np(variables)))
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), want[key].numpy(),
                                   rtol=1e-6, atol=1e-6, err_msg=key)


def _shapes(tree, prefix=""):
    out = {}
    for name, node in tree.items():
        if isinstance(node, dict):
            out.update(_shapes(node, f"{prefix}{name}/"))
        else:
            out[prefix + name] = tuple(node.shape)
    return out


@pytest.mark.parametrize("backbone,head", [("resnet50", "tmr"),
                                           ("tiny", "nl_only"),
                                           ("tiny", "stage1"),
                                           ("resnet50", "lfb")])
def test_random_variables_have_the_flax_tree(backbone, head):
    kw = dict(backbone=backbone, hidden_dim=32, head=head,
              compute_dtype="float32")
    model = jax_build_model(JaxModelConfig(**kw))
    clips = jnp.zeros((1, 2, 32, 32, 3), jnp.float32)
    memory = jnp.zeros((1, 4, 32), jnp.float32)
    args = (clips, memory) if head in ("tmr", "nl_only") else (clips,)
    init = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), *args))
    ours = random_variables(ModelConfig(**kw), seed=0)
    for coll in ("params", "batch_stats"):
        assert _shapes(ours[coll]) == _shapes(init[coll]), coll
    # and the port's model takes them through the bridge
    build_model(ModelConfig(**kw), device="cpu").load_state_dict(
        from_jax_variables(ours), strict=True)
