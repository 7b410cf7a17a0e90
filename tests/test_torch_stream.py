"""The port's StreamingInference (CPU) against the JAX package's, step for
step on the same uint8 frames and weights: outputs, `valid` and the whole
state, with an active mask that drops frames and `reset_streams` recycling
a slot, for heads tmr and nl_only; and the port's stream against the port's
video engine.

Tiny backbone, f32, sequence_length 4, window 4. Tolerance 1e-4 (rtol and
atol) on probabilities and state: the same math, summed in another order
by XLA and PyTorch's CPU kernels. Inactive slots must keep their state bit
for bit."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tmrnet_tpu.config import DataConfig as JaxDataConfig
from tmrnet_tpu.config import ExperimentConfig as JaxExperimentConfig
from tmrnet_tpu.config import MemoryConfig as JaxMemoryConfig
from tmrnet_tpu.config import ModelConfig as JaxModelConfig
from tmrnet_tpu.eval.stream import StreamingInference as JaxStreamingInference
from tmrnet_torch.config import DataConfig, ExperimentConfig, MemoryConfig, ModelConfig
from tmrnet_torch.eval.infer import VideoInference
from tmrnet_torch.eval.stream import StreamingInference
from tmrnet_torch.models.convert import from_jax_variables, random_variables

torch.set_num_threads(2)

TOL = dict(rtol=1e-4, atol=1e-4)
SEQ, WIN, HID, HW, CLASSES = 4, 4, 16, 24, 5
STREAMS, STEPS = 3, 14
# Stream 1 drops frames at steps 5-7; stream 2 is recycled before step 9.
INACTIVE = {(1, 5), (1, 6), (1, 7)}
RESET_AT, RESET_SLOT = 9, 2


def _setup(head):
    model = dict(backbone="tiny", stage_sizes=(1, 1), width=8, hidden_dim=HID,
                 num_classes=CLASSES, head=head, compute_dtype="float32")
    jcfg = JaxExperimentConfig(
        data=JaxDataConfig(device_normalize=True, sequence_length=SEQ),
        model=JaxModelConfig(**model), memory=JaxMemoryConfig(window=WIN))
    tcfg = ExperimentConfig(
        data=DataConfig(device_normalize=True, sequence_length=SEQ),
        model=ModelConfig(**model), memory=MemoryConfig(window=WIN))
    variables = random_variables(ModelConfig(**model), 11)
    extractor = random_variables(ModelConfig(**dict(model, head="lfb")), 12)
    tree = lambda v: jax.tree_util.tree_map(jnp.asarray, v)
    jax_stream = JaxStreamingInference(jcfg, tree(variables), tree(extractor))
    port = StreamingInference(tcfg, from_jax_variables(variables),
                              from_jax_variables(extractor), device="cpu")
    video = VideoInference(tcfg, from_jax_variables(variables),
                           from_jax_variables(extractor), device="cpu")
    frames = np.random.default_rng(13).integers(
        0, 256, (STEPS, STREAMS, HW, HW, 3), dtype=np.uint8)
    return jax_stream, port, video, frames


def _state(state):
    return [np.asarray(x) for x in (state.ext_ring, state.tmr_ring,
                                    state.bank_ring, state.count)]


@pytest.mark.parametrize("head", ["tmr", "nl_only"])
def test_stream_matches_jax_step_for_step(head):
    jax_stream, port, video, frames = _setup(head)
    jstate, state = jax_stream.init_state(STREAMS), port.init_state(STREAMS)
    taken = {s: [[]] for s in range(STREAMS)}   # each stream's frames, per life
    got = {s: [[]] for s in range(STREAMS)}     # its valid outputs, per life
    for t in range(STEPS):
        if t == RESET_AT:
            mask = [s == RESET_SLOT for s in range(STREAMS)]
            jstate = jax_stream.reset_streams(jstate, mask)
            state = port.reset_streams(state, mask)
            taken[RESET_SLOT].append([])
            got[RESET_SLOT].append([])
            for a, b in zip(_state(state), _state(jstate)):
                assert not a[RESET_SLOT].any()
                np.testing.assert_allclose(a, b, **TOL)
        active = [(s, t) not in INACTIVE for s in range(STREAMS)]
        before = _state(state)
        jstate, jp, jpr, jv = jax_stream.step(jstate, frames[t], active=active)
        state, p, pr, v = port.step(state, frames[t], active=active)
        np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
        valid = v.numpy()
        np.testing.assert_allclose(pr.numpy()[valid], np.asarray(jpr)[valid], **TOL)
        np.testing.assert_array_equal(p.numpy()[valid], np.asarray(jp)[valid])
        after = _state(state)
        for a, b in zip(after, _state(jstate)):
            np.testing.assert_allclose(a, b, **TOL)
        for s in range(STREAMS):
            if not active[s]:
                assert not valid[s]
                for a, b in zip(after, before):
                    np.testing.assert_array_equal(a[s], b[s])
                continue
            taken[s][-1].append(frames[t, s])
            if valid[s]:
                got[s][-1].append(pr.numpy()[s])
    # each life of each stream against the video engine on the frames it took
    for s in range(STREAMS):
        for life_frames, life_probs in zip(taken[s], got[s]):
            _, want = video.run_video(np.stack(life_frames))
            assert len(life_probs) == len(want) == len(life_frames) - SEQ + 1
            np.testing.assert_allclose(np.stack(life_probs), want, **TOL)


def test_stream_refuses_heads_without_memory():
    cfg = ExperimentConfig(model=ModelConfig(backbone="tiny", hidden_dim=HID,
                                             head="stage1"))
    with pytest.raises(ValueError, match="memory head"):
        StreamingInference(cfg, {}, {}, device="cpu")
