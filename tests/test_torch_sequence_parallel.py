"""The sequence-parallel video pass on the CPU: `VideoInference(devices=
["cpu", "cpu"])` against the one-device engine and against JAX's
`VideoInference(mesh=make_mesh(data_parallel=2))` (conftest's 8 CPU
devices), and `dryrun_multichip(4)`.

Tiny backbone, f32, the weights and videos of `tests/test_torch_video.py`.
The two shards run on one CPU, so the sharded engine is the one-device
engine with the trunk called on smaller batches: 1e-6 (rtol and atol).
JAX's: 1e-4, the tolerance of `test_torch_video.py`."""

import numpy as np
import pytest
import torch

import jax

from tmrnet_tpu.config import MeshConfig as JaxMeshConfig
from tmrnet_tpu.eval.infer import VideoInference as JaxVideoInference
from tmrnet_tpu.parallel.mesh import make_mesh as jax_make_mesh
from tmrnet_torch.eval.infer import VideoInference
from tmrnet_torch.models.convert import from_jax_variables

from tests.test_torch_video import (HW, LENGTHS, TOL, _configs, _jax_tree,
                                    _variables)

torch.set_num_threads(2)

SP_TOL = dict(rtol=1e-6, atol=1e-6)
SHARDS = 2
# run_corpus blocks: 16 frames divide over the shards (the last padded to
# 16); 15 do not, and run whole on the first device.
CHUNKS = (16, 15)


@pytest.fixture(scope="module")
def engines():
    jcfg, tcfg = _configs()
    variables, extractor = _variables("tmr", 1), _variables("lfb", 2)
    rng = np.random.default_rng(3)
    videos = [rng.integers(0, 256, (n, HW, HW, 3), dtype=np.uint8)
              for n in LENGTHS]
    state, ext = from_jax_variables(variables), from_jax_variables(extractor)
    one = VideoInference(tcfg, state, ext, device="cpu")
    sp = VideoInference(tcfg, state, ext, devices=["cpu"] * SHARDS)
    mesh = jax_make_mesh(JaxMeshConfig(data_parallel=SHARDS,
                                       model_parallel=1),
                         devices=jax.devices()[:SHARDS])
    jeng = JaxVideoInference(jcfg, _jax_tree(variables), _jax_tree(extractor),
                             pad_frames=16, bucket_step=8, mesh=mesh)
    return dict(one=one, sp=sp, jax=jeng, videos=videos)


def _trunk_batches(engine):
    """Record the batch of every call of the engine's two trunks."""
    seen = []
    for m in (engine.extractor, engine.model):
        m.backbone.register_forward_hook(
            lambda mod, args, out: seen.append(int(args[0].shape[0])))
    return seen


def _close(got, want, tol):
    assert len(got) == len(want)
    for (gp, gs), (wp, ws) in zip(got, want):
        np.testing.assert_allclose(gs, np.asarray(ws), **tol)
        if gs.size:
            top2 = np.sort(np.asarray(ws), axis=-1)[:, -2:]
            decided = top2[:, 1] - top2[:, 0] > 1e-3
            np.testing.assert_array_equal(np.asarray(gp)[decided],
                                          np.asarray(wp)[decided])


def test_engine_holds_a_shard_a_device(engines):
    sp = engines["sp"]
    assert sp.device == torch.device("cpu") and len(sp.shards) == SHARDS
    # one device repeated: one replica (the engine's own trunks) serves both
    trunks = {id(t) for _, _, ts in sp.shards for t in ts.values()}
    assert trunks == {id(sp.extractor.backbone), id(sp.model.backbone)}
    assert engines["one"].shards is None
    state = sp.model.state_dict()
    ext = sp.extractor.state_dict()
    assert VideoInference(sp.cfg, state, ext, devices=["cpu"]).shards is None
    with pytest.raises(ValueError, match="mesh or devices"):
        VideoInference(sp.cfg, state, ext, devices=["cpu"] * 2, mesh=object())


@pytest.mark.parametrize("mode", ["run_video", "run_videos", "bank_features"]
                         + [f"run_corpus-{c}" for c in CHUNKS])
def test_sequence_parallel_equals_one_device_and_jax(engines, mode):
    """Each entry point over the two shards equals the one-device engine
    within 1e-6 and JAX's meshed engine within 1e-4; a trunk chunk is cut
    into contiguous shards (two trunk calls a chunk, of sizes that sum to
    it), a corpus block that does not divide runs whole."""
    videos, sp, one, jeng = (engines[k] for k in ("videos", "sp", "one",
                                                  "jax"))
    seen = _trunk_batches(sp)
    try:
        if mode == "run_video":
            got = [sp.run_video(v) for v in videos]
            want = [one.run_video(v) for v in videos]
            ref = [jeng.run_video(v) for v in videos]
            # each video's trunk chunk in 2 contiguous shards, odd or not
            assert seen == [s for n in LENGTHS for _ in range(2)
                            for s in (-(-n // 2), n // 2)]
        elif mode == "run_videos":
            got, want = sp.run_videos(videos), one.run_videos(videos)
            ref = jeng.run_videos(videos)
        elif mode == "bank_features":
            got = [sp.bank_features(v).numpy() for v in videos]
            want = [one.bank_features(v).numpy() for v in videos]
            ref = [np.asarray(jeng.bank_features(v)) for v in videos]
            for g, w, r in zip(got, want, ref):
                np.testing.assert_allclose(g, w, **SP_TOL)
                np.testing.assert_allclose(g, r, **TOL)
            return
        else:
            chunk = int(mode.split("-")[1])
            got = sp.run_corpus(videos, chunk=chunk)
            want = one.run_corpus(videos, chunk=chunk)
            ref = jeng.run_corpus(videos, chunk=chunk)
            blocks = -(-sum(LENGTHS) // chunk)
            if chunk % SHARDS == 0:
                assert seen == [chunk // 2] * (4 * blocks)
            else:
                assert seen == [chunk] * (2 * blocks)
    finally:
        for m in (sp.extractor, sp.model):
            m.backbone._forward_hooks.clear()
    _close(got, want, SP_TOL)
    _close(got, ref, TOL)


def test_dryrun_multichip_grid_and_sp_pass(capfd):
    """`dryrun_multichip(4)`: a 2 x 2 grid's stage-2 step (every rank the
    same loss, one process's within LOSS_RTOL) and the sequence-parallel
    pass over 2 CPU shards on the trained weights."""
    from tmrnet_torch.entry import dryrun_multichip

    loss = dryrun_multichip(4)
    out = capfd.readouterr().out
    lines = [ln for ln in out.splitlines() if ln.startswith("rank ")
             and ": loss " in ln]
    assert len(lines) == 4 and len({ln.split("loss ")[1]
                                    for ln in lines}) == 1
    meshes = [ln for ln in out.splitlines() if ": mesh " in ln]
    assert len(meshes) == 4 and all("'data': 2, 'model': 2" in ln
                                    for ln in meshes)
    assert f"loss={loss:.4f}" in out
    assert ("sp video pass ok (6 frames sharded over data=2, 5 clip preds)"
            in out)
