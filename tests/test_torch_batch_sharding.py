"""In-process batch sharding on the CPU: `ClipInference(devices=)`,
`build_lfb(engine="clip", devices=)` and `StreamingInference(devices=)`
over two CPU shards, against the one-device engines and against JAX's
engines over `make_mesh(data_parallel=2)` (conftest's 8 CPU devices); the
commands under `--set mesh.data_parallel=2 --device cpu` against their
one-device runs (`test --engine clip`, `build-lfb --engine clip`,
`parity`, `stream`, `serve`), the batch-divisibility exits; and `entry()`
against `__graft_entry__.entry()`.

Tiny backbone, f32, the weights, packed videos and bank of
`tests/test_torch_dataset_engines.py` for the engines. The two shards run
on one CPU, so a sharded engine is the one-device engine with the trunk
called on smaller batches: 1e-6 (rtol and atol). JAX's: 1e-4, the
tolerance of `test_torch_dataset_engines.py` and `test_torch_stream.py`.
`entry()`'s forward runs in bf16 in both packages, each rounding its own
way through ResNet-50's 53 convolutions: its logits within 2e-2 of max
|JAX logit| (ENTRY_TOL; 7.4e-3 read on this seed, one bf16 step at
|logit| ~1)."""

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tmrnet_tpu.config import MeshConfig as JaxMeshConfig
from tmrnet_tpu.eval.infer import ClipInference as JaxClipInference
from tmrnet_tpu.eval.stream import StreamingInference as JaxStreamingInference
from tmrnet_tpu.memory.lfb import FeatureBank as JaxFeatureBank
from tmrnet_tpu.models.torch_import import export_reference_checkpoint
from tmrnet_tpu.parallel.mesh import make_mesh as jax_make_mesh
from tmrnet_tpu.train.loop import build_lfb as jax_build_lfb
from tmrnet_torch import cli
from tmrnet_torch.config import ModelConfig
from tmrnet_torch.eval.infer import ClipInference
from tmrnet_torch.eval.stream import ShardedStreamState, StreamingInference
from tmrnet_torch.memory.lfb import FeatureBank
from tmrnet_torch.models.convert import from_jax_variables, random_variables
from tmrnet_torch.train.loop import build_lfb

from tests.test_torch_dataset_engines import (ATOL, BATCH, CLASSES, HW, MODEL,
                                              SEQ, _configs, _datasets, world)

torch.set_num_threads(2)

SHARD_TOL = dict(rtol=1e-6, atol=1e-6)
SHARDS = 2
CPUS = ["cpu"] * SHARDS
ENTRY_TOL = 2e-2


def _jax_mesh():
    return jax_make_mesh(JaxMeshConfig(data_parallel=SHARDS,
                                       model_parallel=1),
                         devices=jax.devices()[:SHARDS])


def _tree(variables):
    return jax.tree_util.tree_map(jnp.asarray, variables)


def _batches(model):
    """Record the batch of every forward of `model` (its clips' B)."""
    seen = []
    model.register_forward_hook(
        lambda mod, args, out: seen.append(int(args[0].shape[0])))
    return seen


def _weights(world, head):
    return world["weights"]["stage1" if head == "stage1" else "tmr"]


def _banks(world, head):
    if head == "stage1":
        return None, None
    feats, firsts = world["bank"], np.zeros(len(world["bank"]), np.int32)
    return (FeatureBank(torch.from_numpy(feats), torch.from_numpy(firsts)),
            JaxFeatureBank(jnp.asarray(feats), jnp.asarray(firsts)))


# ---------------------------------------------------------------- clip engine


def test_clip_engine_holds_a_replica_a_device(world):
    _, tcfg = _configs()
    state = from_jax_variables(world["weights"]["tmr"])
    bank, _ = _banks(world, "tmr")
    sharded = ClipInference(tcfg, state, bank, devices=CPUS)
    # one device repeated: the engine's own model, prep and bank serve both
    assert len(sharded.shards) == SHARDS
    assert all(sh[1] is sharded.model and sh[3] is bank.features
               for sh in sharded.shards)
    assert ClipInference(tcfg, state, bank, devices=["cpu"]).shards is None
    with pytest.raises(ValueError, match="mesh or devices"):
        ClipInference(tcfg, state, bank, devices=CPUS, mesh=object())


@pytest.mark.parametrize("head", ["tmr", "stage1"])
def test_clip_engine_run_equals_one_device_and_jax(world, head):
    """run(ds) over two shards: each batch of 8 clips in two forwards of 4;
    within 1e-6 of the one-device engine and 1e-4 of JAX's meshed
    engine, the same predictions."""
    jcfg, tcfg = _configs(head)
    variables = _weights(world, head)
    tbank, jbank = _banks(world, head)
    port_ds, jax_ds = _datasets(world, tcfg)
    state = from_jax_variables(variables)
    one = ClipInference(tcfg, state, tbank, device="cpu").run(port_ds)
    engine = ClipInference(tcfg, state, tbank, devices=CPUS)
    seen = _batches(engine.model)
    got = engine.run(port_ds)
    assert seen == [BATCH // SHARDS] * (2 * -(-35 // BATCH))
    want = JaxClipInference(jcfg, _tree(variables), jbank,
                            mesh=_jax_mesh()).run(jax_ds)
    np.testing.assert_allclose(got.scores, one.scores, **SHARD_TOL)
    np.testing.assert_array_equal(got.preds, one.preds)
    np.testing.assert_allclose(got.scores, np.asarray(want.scores), rtol=0,
                               atol=ATOL)
    np.testing.assert_array_equal(got.preds, want.preds)
    assert got.accuracy == one.accuracy == want.accuracy


@pytest.mark.parametrize("head", ["tmr", "stage1"])
def test_clip_engine_multicrop_and_indivisible_batches(world, head):
    """run_batches: a 2-crop batch of 3 clips (6 rows, two shards of 3), a
    batch of 3 single-crop clips (does not divide: one forward of 3 on the
    first device) and one of 4 with a padded row; each within 1e-6 of the
    one-device engine."""
    _, tcfg = _configs(head)
    state = from_jax_variables(_weights(world, head))
    tbank, _ = _banks(world, head)
    rng = np.random.default_rng(31)
    clip = lambda *lead: rng.integers(0, 256, lead + (SEQ, HW, HW, 3),
                                      dtype=np.uint8)
    rows = lambda n: rng.integers(0, 35, n)
    batches = [(clip(3, 2), np.zeros(3, int), rows(3), 0),
               (clip(3), np.zeros(3, int), rows(3), 0),
               (clip(4), np.zeros(4, int), rows(4), 1)]
    firsts = None if head == "stage1" else np.zeros(35, np.int64)
    engine = ClipInference(tcfg, state, tbank, devices=CPUS)
    seen = _batches(engine.model)
    got = engine.run_batches(batches, firsts)
    assert seen == [3, 3, 3, 2, 2]
    want = ClipInference(tcfg, state, tbank, device="cpu").run_batches(
        batches, firsts)
    assert got.scores.shape == (9, CLASSES)
    np.testing.assert_allclose(got.scores, want.scores, **SHARD_TOL)
    np.testing.assert_array_equal(got.preds, want.preds)


@pytest.mark.parametrize("batch", [BATCH, 7])
def test_clip_bank_build_equals_one_device_and_jax(world, tmp_path, batch):
    """build_lfb(engine="clip", devices=): batches of 8 in two shards, of 7
    (do not divide) whole on the first device; the bank and its cache
    within 1e-6 of the one-device build, 1e-4 of max |feature| of JAX's
    build over the mesh (which places a batch of 7 replicated)."""
    jcfg, tcfg = _configs()
    tcfg = tcfg.replace(data=dataclasses.replace(tcfg.data, batch_clips=batch))
    jcfg = jcfg.replace(data=dataclasses.replace(jcfg.data, batch_clips=batch))
    port_ds, jax_ds = _datasets(world, tcfg)
    ext = world["weights"]["lfb"]
    state = from_jax_variables(ext)
    one = build_lfb(tcfg, state, port_ds, cache_path=str(tmp_path / "one.npz"),
                    device="cpu")
    got = build_lfb(tcfg, state, port_ds, cache_path=str(tmp_path / "sh.npz"),
                    devices=CPUS)
    want = jax_build_lfb(jcfg, _tree(ext), jax_ds,
                         cache_path=str(tmp_path / "jax.npz"),
                         mesh=_jax_mesh())
    np.testing.assert_allclose(got.features.numpy(), one.features.numpy(),
                               **SHARD_TOL)
    np.testing.assert_array_equal(got.first_rows.numpy(),
                                  one.first_rows.numpy())
    with np.load(tmp_path / "one.npz") as a, np.load(tmp_path / "sh.npz") as b:
        assert set(a.files) == set(b.files)
        for k in a.files:
            np.testing.assert_allclose(b[k], a[k], **SHARD_TOL)
    want_f = np.asarray(want.features)
    np.testing.assert_allclose(got.features.numpy(), want_f, rtol=0,
                               atol=ATOL * np.abs(want_f).max())
    with pytest.raises(ValueError, match="mesh or devices"):
        build_lfb(tcfg, state, port_ds, cache_path=str(tmp_path / "x.npz"),
                  devices=CPUS, mesh=object())


# -------------------------------------------------------------- stream engine

STREAMS, STEPS = 8, 14
INACTIVE_SLOT, INACTIVE_STEPS = 3, (5, 6, 7)
RESET_AT, RESET_SLOT = 9, 6


def _whole(state):
    return [np.asarray(x) for x in (state.ext_ring, state.tmr_ring,
                                    state.bank_ring, state.count)]


def test_stream_engine_equals_one_device_and_jax(world):
    """8 slots over two groups of 4, 14 steps, slot 3 inactive at steps
    5-7 (frozen bit for bit), slot 6 reset before step 9: the outputs and
    the whole state within 1e-6 of the one-device engine and 1e-4 of
    JAX's meshed engine at every step; each group's state on its device;
    7 slots do not divide."""
    jcfg, tcfg = _configs()
    variables, ext = world["weights"]["tmr"], world["weights"]["lfb"]
    state, ext_state = from_jax_variables(variables), from_jax_variables(ext)
    one = StreamingInference(tcfg, state, ext_state, device="cpu")
    sharded = StreamingInference(tcfg, state, ext_state, devices=CPUS)
    jeng = JaxStreamingInference(jcfg, _tree(variables), _tree(ext),
                                 mesh=_jax_mesh())
    assert [eng for _, eng in sharded.groups] == [sharded] * SHARDS
    with pytest.raises(ValueError, match="7 streams do not divide"):
        sharded.init_state(7)
    frames = np.random.default_rng(41).integers(
        0, 256, (STEPS, STREAMS, HW, HW, 3), dtype=np.uint8)
    s1, s2, sj = (e.init_state(STREAMS) for e in (one, sharded, jeng))
    assert isinstance(s2, ShardedStreamState)
    assert [g.count.shape[0] for g in s2.groups] == [STREAMS // SHARDS] * 2
    valid_seen = 0
    for t in range(STEPS):
        if t == RESET_AT:
            mask = np.arange(STREAMS) == RESET_SLOT
            s1, s2 = one.reset_streams(s1, mask), sharded.reset_streams(s2,
                                                                        mask)
            sj = jeng.reset_streams(sj, mask)
            assert not _whole(s2)[3][RESET_SLOT]
        active = np.ones(STREAMS, bool)
        if t in INACTIVE_STEPS:
            active[INACTIVE_SLOT] = False
        before = _whole(s2)
        s1, p1, q1, v1 = one.step(s1, frames[t], active)
        s2, p2, q2, v2 = sharded.step(s2, frames[t], active)
        sj, pj, qj, vj = jeng.step(sj, frames[t], active)
        np.testing.assert_array_equal(v2.numpy(), v1.numpy())
        np.testing.assert_array_equal(v2.numpy(), np.asarray(vj))
        np.testing.assert_allclose(q2.numpy(), q1.numpy(), **SHARD_TOL)
        valid = v2.numpy()
        valid_seen += int(valid.sum())
        np.testing.assert_allclose(q2.numpy()[valid], np.asarray(qj)[valid],
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(p2.numpy()[valid], p1.numpy()[valid])
        after = _whole(s2)
        for a, b, c in zip(after, _whole(s1), _whole(sj)):
            np.testing.assert_allclose(a, b, **SHARD_TOL)
            np.testing.assert_allclose(a, c, rtol=1e-4, atol=1e-4)
        if not active[INACTIVE_SLOT]:
            assert not valid[INACTIVE_SLOT]
            for a, b in zip(after, before):
                np.testing.assert_array_equal(a[INACTIVE_SLOT],
                                              b[INACTIVE_SLOT])
    assert valid_seen > 0


def test_stream_engine_takes_a_whole_state(world):
    """A whole StreamState (as `serve` restores one) is cut into the
    groups: its step equals the step of the same state sharded."""
    _, tcfg = _configs()
    state = from_jax_variables(world["weights"]["tmr"])
    ext = from_jax_variables(world["weights"]["lfb"])
    sharded = StreamingInference(tcfg, state, ext, devices=CPUS)
    frames = np.random.default_rng(42).integers(
        0, 256, (2, 4, HW, HW, 3), dtype=np.uint8)
    st, _, _, _ = sharded.step(sharded.init_state(4), frames[0])
    whole = type(st.groups[0])(*(torch.cat([getattr(g, k) for g in st.groups])
                                 for k in ("ext_ring", "tmr_ring",
                                           "bank_ring", "count")))
    a = sharded.step(st, frames[1])
    b = sharded.step(whole, frames[1])
    for x, y in zip(a[1:], b[1:]):
        assert torch.equal(x, y)
    with pytest.raises(ValueError, match="5 frames for 4 streams"):
        sharded.step(st, np.zeros((5, HW, HW, 3), np.uint8))


# ------------------------------------------------------------------ commands

CLI_LENGTHS = (9, 6, 12)
CLI_MODEL = dict(MODEL, hidden_dim=16)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A config JSON (batches of 8), the model's and the extractor's
    `.pth`, 3 packed videos of 40x40 frames with annotations, and their
    manifest from `manifest`."""
    from tmrnet_tpu.config import CHOLEC80_PHASES
    from tmrnet_torch.config import (DataConfig, EvalConfig,
                                     ExperimentConfig, MemoryConfig)

    d = tmp_path_factory.mktemp("sharded_cli")
    cfg = ExperimentConfig(
        data=DataConfig(sequence_length=SEQ, resize=40, crop_size=32,
                        test_crop_type=1, device_normalize=True,
                        batch_clips=8, num_workers=2),
        model=ModelConfig(**CLI_MODEL), memory=MemoryConfig(window=4),
        eval=EvalConfig(batch_clips=8))
    (d / "cfg.json").write_text(cfg.to_json())
    for name, head, seed in (("model", "tmr", 61), ("extractor", "lfb", 62)):
        variables = random_variables(ModelConfig(**dict(CLI_MODEL, head=head)),
                                     seed)
        sd = export_reference_checkpoint(variables, head, (1, 1))
        torch.save({k: torch.from_numpy(v) for k, v in sd.items()},
                   d / f"{name}.pth")
    (d / "frames").mkdir()
    (d / "ann").mkdir()
    rng = np.random.default_rng(63)
    for v, n in enumerate(CLI_LENGTHS):
        np.save(d / "frames" / f"video{v + 1:02d}.npy",
                rng.integers(0, 256, (n, 40, 40, 3), dtype=np.uint8))
        rows = [f"{25 * k}\t{CHOLEC80_PHASES[(k // 3 + v) % CLASSES]}\n"
                for k in range(n)]
        (d / "ann" / f"video{v + 1:02d}-phase.txt").write_text(
            "Frame\tPhase\n" + "".join(rows))
    assert cli.main(["manifest", "--config", str(d / "cfg.json"), "--frames",
                     str(d / "frames"), "--annotations", str(d / "ann"),
                     "--out", str(d / "m.pkl")]) == 0
    return d


SP = ["--set", f"mesh.data_parallel={SHARDS}"]


def _base(files, command):
    return [command, "--config", str(files / "cfg.json"), "--device", "cpu"]


def _weights_args(files):
    return ["--torch-ckpt", str(files / "model.pth"),
            "--extractor-torch-ckpt", str(files / "extractor.pth")]


def _npz_close(a, b):
    with np.load(a) as x, np.load(b) as y:
        assert set(x.files) == set(y.files)
        for k in x.files:
            if np.issubdtype(x[k].dtype, np.floating):
                np.testing.assert_allclose(y[k], x[k], **SHARD_TOL)
            else:
                np.testing.assert_array_equal(y[k], x[k])


@pytest.mark.parametrize("command", ["build-lfb", "test", "parity"])
def test_clip_commands_equal_one_device(files, tmp_path, command, capsys):
    """`build-lfb --engine clip`, `test --engine clip` (its bank built)
    and `parity` with --set mesh.data_parallel=2: the outputs of the
    one-device run within 1e-6, the same predictions and JSON."""
    outs = {}
    for name, extra in (("one", []), ("sp", SP)):
        out = tmp_path / name
        out.mkdir()
        argv = _base(files, command) + ["--manifest", str(files / "m.pkl")]
        if command == "build-lfb":
            argv += ["--torch-ckpt", str(files / "extractor.pth"),
                     "--engine", "clip", "--out", str(out / "bank.npz")]
            outs[name] = out / "bank.npz"
        elif command == "test":
            argv += _weights_args(files) + [
                "--engine", "clip", "--lfb", str(out / "bank.npz"),
                "--out", str(out / "preds.npz")]
            outs[name] = out / "preds.npz"
        else:
            argv += _weights_args(files) + [
                "--workdir", str(out), "--json-out", str(out / "p.json")]
            outs[name] = out / "predictions.npz"
        assert cli.main(argv + extra) == 0
        printed = capsys.readouterr().out.strip().splitlines()
        if command == "test":
            summary = json.loads(printed[-1])
            summary.pop("out")
            outs[name + "_json"] = summary
        elif command == "parity":
            outs[name + "_json"] = json.loads((out / "p.json").read_text())
    _npz_close(outs["one"], outs["sp"])
    if command == "test":
        _npz_close(outs["one"].parent / "bank.npz",
                   outs["sp"].parent / "bank.npz")
    if command != "build-lfb":
        assert outs["one_json"] == outs["sp_json"]


def test_stream_command_equals_one_device(files, tmp_path, capsys):
    """`stream` over 3 videos: one device takes 3 slots, two shards 4 (the
    fourth idle on blank frames); the same JSONL rows."""
    rows, summaries = {}, {}
    for name, extra in (("one", []), ("sp", SP)):
        out = tmp_path / f"{name}.jsonl"
        assert cli.main(_base(files, "stream") + [
            "--manifest", str(files / "m.pkl"), *_weights_args(files),
            "--out", str(out)] + extra) == 0
        summaries[name] = json.loads(
            capsys.readouterr().out.strip().splitlines()[-1])
        rows[name] = out.read_text().splitlines()
    assert rows["one"] == rows["sp"]
    assert sum(json.loads(r)["valid"] for r in rows["sp"]) > 0
    assert summaries["one"]["slots"] == 3 and summaries["sp"]["slots"] == 4
    for k in ("steps", "clip_accuracy", "predictions"):
        assert summaries["one"][k] == summaries["sp"][k]


def _protocol(files, ticks):
    """JSONL events: three streams joining at ticks 0, 1 and 2, one
    ending at tick 4, a step a tick."""
    lines = []
    for t in ticks:
        for s, start in ((0, 0), (1, 1), (2, 2)):
            if t >= start and not (s == 1 and t > 4):
                video = files / "frames" / f"video{s + 1:02d}.npy"
                lines.append({"id": f"or-{s}", "image": f"{video}#{t - start}"})
        if t == 4:
            lines.append({"id": "or-1", "end": True})
        lines.append({"step": True})
    return "".join(json.dumps(o) + "\n" for o in lines)


def test_serve_command_equals_one_device(files, tmp_path, capsys,
                                         monkeypatch):
    """`serve --slots 3 --probs` from JSONL events on stdin in two runs
    over one state directory (a restart between): two shards round the
    slots up to 4; the same rows, probabilities within 1e-6."""
    import io

    rows, slots = {}, {}
    for name, extra in (("one", []), ("sp", SP)):
        got = []
        for ticks in (range(0, 4), range(4, 8)):
            monkeypatch.setattr("sys.stdin",
                                io.StringIO(_protocol(files, ticks)))
            assert cli.main(_base(files, "serve") + [
                "--torch-ckpt", str(files / "model.pth"), "--slots", "3",
                "--probs", "--no-warmup", "--state-dir",
                str(tmp_path / name)] + extra) == 0
            cap = capsys.readouterr()
            got += [json.loads(line) for line in cap.out.splitlines()]
            slots[name] = json.loads(
                cap.err.strip().splitlines()[-1])["summary"]["slots"]
        rows[name] = got
    assert slots == {"one": 3, "sp": 4}
    assert len(rows["one"]) == len(rows["sp"]) > 0
    assert any(r.get("valid") for r in rows["sp"])
    for a, b in zip(rows["one"], rows["sp"]):
        assert {k: v for k, v in a.items() if k != "probs"} == \
            {k: v for k, v in b.items() if k != "probs"}
        if "probs" in a:
            np.testing.assert_allclose(b["probs"], a["probs"], **SHARD_TOL)


@pytest.mark.parametrize("command,key", [
    ("build-lfb", "data.batch_clips"), ("test", "eval.batch_clips"),
    ("test", "data.batch_clips"), ("parity", "data.batch_clips")])
def test_indivisible_batches_exit(files, command, key):
    argv = _base(files, command) + ["--manifest", str(files / "m.pkl"),
                                    *_weights_args(files)[:2]]
    if command == "build-lfb":
        argv += ["--engine", "clip", "--out", "b.npz"]
    elif command == "test":
        argv += ["--engine", "clip", "--out", "p.npz"]
    else:
        argv += ["--workdir", "w"]
    with pytest.raises(SystemExit, match=f"{key}=7 must be divisible by "
                                         f"mesh.data_parallel=2"):
        cli.main(argv + SP + ["--set", f"{key}=7"])


# --------------------------------------------------------------------- entry


def test_entry_matches_graft_entry():
    """entry()'s example args have the shapes and dtypes of
    `__graft_entry__.entry()`'s (its state dict is JAX's variables carried
    across), and fn on seeded flagship weights carried across matches
    JAX's fn on smaller clips (1 clip of 2 frames of 64x64, the flagship
    window) within ENTRY_TOL."""
    import __graft_entry__

    from tmrnet_torch.entry import entry

    fn, (state, clips, memory) = entry("cpu")
    jfn, _ = __graft_entry__.entry()
    jvars, jclips, jmemory = jax.eval_shape(lambda: __graft_entry__.entry()[1])
    for t, j in ((clips, jclips), (memory, jmemory)):
        assert tuple(t.shape) == j.shape and t.dtype == torch.bfloat16
        assert j.dtype == jnp.bfloat16 and t.device.type == "cpu"
    carried = from_jax_variables(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype), jvars))
    assert {k: (tuple(v.shape), v.dtype) for k, v in state.items()} == \
        {k: (tuple(v.shape), v.dtype) for k, v in carried.items()}
    assert all(not v.any() for v in state.values())
    logits = fn(state, clips[:1, :2, :64, :64], memory[:1])
    assert logits.shape == (1, 7) and logits.dtype == torch.bfloat16

    variables = random_variables(ModelConfig(
        backbone="resnet50", head="tmr", num_classes=7, hidden_dim=512,
        compute_dtype="float32"), seed=5)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((1, 2, 64, 64, 3), dtype=np.float32)
    mem = rng.standard_normal((1, 30, 512), dtype=np.float32)
    want = np.asarray(jfn(_tree(variables), jnp.asarray(x, jnp.bfloat16),
                          jnp.asarray(mem, jnp.bfloat16)), np.float32)
    got = fn(from_jax_variables(variables),
             torch.from_numpy(x).to(torch.bfloat16),
             torch.from_numpy(mem).to(torch.bfloat16)).float().numpy()
    assert np.ptp(want) > 0.1
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=ENTRY_TOL * np.abs(want).max())
