"""The port's serve_loop over the port's StreamingInference (CPU) against
the JAX package's serve_loop over JAX's engine: the same protocol lines
and the same in-memory frames give the same rows (`id`, `frame`, `pred`,
`valid`, the error strings, in the same order), probabilities within 1e-4,
and the same summary counts. The scenarios are those of
`tests/test_serve.py`; then `state.npz` across the two packages in both
directions, the deferred stop at a tick boundary and the exit checkpoint,
a stale checkpoint, and the seeded multi-client schedule of
`tests/test_serve_fuzz.py` against its spec simulator.

Tiny backbone, f32, sequence_length 4, window 4, uint8 frames normalized
on the engine (device_normalize). Tolerance 1e-4 (absolute) on
probabilities: the same math, summed in another order by XLA and
PyTorch's CPU kernels. A `pred` must equal JAX's wherever JAX's two best
probabilities lie more than 2e-4 apart."""

import io
import json
import os
import threading
import time

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tests.test_serve import _solo
from tests.test_serve_fuzz import (CLIENTS, IDLE_TICKS, SLOTS, STREAMS,
                                   VIDEO_LEN, _Sim, _Sink)
from tmrnet_tpu.config import DataConfig as JaxDataConfig
from tmrnet_tpu.config import ExperimentConfig as JaxExperimentConfig
from tmrnet_tpu.config import MemoryConfig as JaxMemoryConfig
from tmrnet_tpu.config import ModelConfig as JaxModelConfig
from tmrnet_tpu.eval import serve as jax_serve
from tmrnet_tpu.eval.stream import StreamingInference as JaxStreamingInference
from tmrnet_torch.config import DataConfig, ExperimentConfig, MemoryConfig, ModelConfig
from tmrnet_torch.eval import serve
from tmrnet_torch.eval.serve import Disconnect
from tmrnet_torch.eval.stream import StreamingInference
from tmrnet_torch.models.convert import from_jax_variables, random_variables

torch.set_num_threads(2)

SEQ, WIN, HID, HW, CLASSES = 4, 4, 16, 24, 5
ATOL, PRED_GAP = 1e-4, 2e-4
SUMMARY_KEYS = ("ticks", "rows", "live_streams", "slots", "evicted",
                "resumed_at_tick")


def _configs(seq=SEQ):
    model = dict(backbone="tiny", stage_sizes=(1, 1), width=8, hidden_dim=HID,
                 num_classes=CLASSES, head="tmr", compute_dtype="float32")
    jcfg = JaxExperimentConfig(
        data=JaxDataConfig(device_normalize=True, sequence_length=seq),
        model=JaxModelConfig(**model), memory=JaxMemoryConfig(window=WIN))
    tcfg = ExperimentConfig(
        data=DataConfig(device_normalize=True, sequence_length=seq),
        model=ModelConfig(**model), memory=MemoryConfig(window=WIN))
    return jcfg, tcfg, model


@pytest.fixture(scope="module")
def engines():
    """(JAX engine, port engine, port engine factory) on one weight set;
    both engines already ran every slot count the tests use, so no tick
    pays a first compile."""
    jcfg, tcfg, model = _configs()
    variables = random_variables(ModelConfig(**model), 21)
    extractor = random_variables(ModelConfig(**dict(model, head="lfb")), 22)
    tree = lambda v: jax.tree_util.tree_map(jnp.asarray, v)
    jax_engine = JaxStreamingInference(jcfg, tree(variables), tree(extractor))
    make = lambda cfg=tcfg: StreamingInference(
        cfg, from_jax_variables(variables), from_jax_variables(extractor),
        device="cpu")
    port = make()
    for b in (1, 2, 3, 4):
        for e in (jax_engine, port):
            st = e.init_state(b)
            st, _, _, _ = e.step(st, np.zeros((b, HW, HW, 3), np.uint8),
                                 active=np.zeros((b,), bool))
            e.reset_streams(st, np.zeros((b,), bool))
    return jax_engine, port, make


def _frames(seed, names, n):
    rng = np.random.default_rng(seed)
    return {f"{k}{t}": rng.integers(0, 256, (HW, HW, 3), dtype=np.uint8)
            for k in names for t in range(n)}


def _lines(objs):
    return "".join(json.dumps(o) + "\n" for o in objs)


def _rows(text):
    return [json.loads(line) for line in text.splitlines()]


def _assert_rows_match(got, want):
    """Rows equal but for probabilities within ATOL; a pred may differ
    only where JAX's two best probabilities lie within PRED_GAP."""
    assert len(got) == len(want), (len(got), len(want))
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.keys() == w.keys(), (i, g, w)
        for k, v in w.items():
            if k == "probs":
                np.testing.assert_allclose(g[k], v, rtol=0, atol=ATOL)
            elif k == "pred" and v is not None and g[k] != v and "probs" in w:
                top2 = np.sort(w["probs"])[-2:]
                assert top2[1] - top2[0] <= PRED_GAP, (i, g, w)
            else:
                assert g[k] == v, (i, k, g, w)


def _summaries_match(got, want):
    assert {k: got[k] for k in SUMMARY_KEYS} == \
        {k: want[k] for k in SUMMARY_KEYS}


# -- the scenarios of tests/test_serve.py ---------------------------------
#
# Each returns (slots, protocol objects or a line source factory, frames,
# keyword arguments of both loops, keyword arguments of the port's alone).


def _join_leave_recycle():
    n = 6
    frames = _frames(8, "abc", n)
    lines = []
    for t in range(4):
        lines += [{"id": "a", "image": f"a{t}"}, {"id": "b", "image": f"b{t}"}]
        if t == 0:
            lines.append({"id": "d", "image": "a0"})     # oversubscribes
        lines.append({"step": True})
    lines.append({"id": "a", "end": True})
    for t in range(2):
        lines += [{"id": "c", "image": f"c{t}"},
                  {"id": "b", "image": f"b{4 + t}"}, {"step": True}]
    lines.append({"id": "b", "end": True})
    for t in range(2, n):
        lines.append({"id": "c", "image": f"c{t}"})
        if t < n - 1:
            lines.append({"step": True})                 # last rides EOF
    return 2, lines, frames, dict(emit_probs=True), {}


def _warmup():
    frames = _frames(2, "a", 6)
    lines = []
    for t in range(6):
        lines += [{"id": "a", "image": f"a{t}"}, {"step": True}]
    # the port warms up on uint8 blanks, JAX not at all: equal rows
    return 2, lines, frames, dict(emit_probs=True), dict(
        warmup_shape=(HW, HW, 3), warmup_dtype=np.uint8)


def _dropped_tick_and_errors():
    n = 5
    frames = _frames(12, "ab", n)
    lines, ta = [], 0
    for tick in range(n + 2):
        if tick not in (1, 3):                   # a drops ticks 1 and 3
            lines.append({"id": "a", "image": f"a{ta}"})
            ta += 1
        if tick < n:
            lines.append({"id": "b", "image": f"b{tick}"})
        if tick == 0:
            lines += [{"id": "a", "image": "a0"},        # dup in one tick
                      {"no_id": True},                   # missing id
                      {"id": "x", "end": True},          # unknown stream
                      {"id": "a"},                       # missing image
                      {"id": "z", "image": "nope"}]      # decode failure
        lines.append({"step": True})
    lines.insert(3, "{not json\n")                       # bad json
    return 4, lines, frames, dict(emit_probs=True), {}


def _numeric_ids():
    frames = _frames(7, "a", 5)
    lines = []
    for t in range(5):
        lines += [{"id": 7, "image": f"a{t}"}, {"step": True}]
    return 2, lines, frames, dict(emit_probs=True), {}


def _idle_eviction():
    frames = _frames(13, "ab", 8)
    lines = [{"id": "b", "image": "b0"}]
    for t in range(5):
        lines += [{"id": "a", "image": f"a{t}"}, {"step": True}]
    lines += [{"id": "c", "image": "a0"}, {"id": "a", "image": "a5"},
              {"step": True}, {"id": "c", "end": True},
              {"id": "b", "image": "b1"}, {"id": "a", "image": "a6"},
              {"step": True}]
    return 2, lines, frames, dict(emit_probs=True, decode_workers=0,
                                  idle_ticks=2), {}


def _stats_heartbeat():
    frames = _frames(17, "s", 5)
    lines = []
    for t in range(5):
        lines += [{"id": "s", "image": f"s{t}"}, {"step": True}]
    return 1, lines, frames, dict(emit_probs=True, decode_workers=0,
                                  stats_every=2), {}


def _self_ticking():
    frames = _frames(11, "s", 3)

    def source():
        r_fd, w_fd = os.pipe()

        def feed():
            with os.fdopen(w_fd, "w") as w:
                for t in range(3):
                    w.write(json.dumps({"id": "s", "image": f"s{t}"}) + "\n")
                    w.flush()
                    if t < 2:
                        time.sleep(0.35)   # > tick_interval: frame t flushes

        threading.Thread(target=feed, daemon=True).start()
        return os.fdopen(r_fd, "r")

    return 1, source, frames, dict(emit_probs=True, decode_workers=0,
                                   tick_interval=0.1), {}


SLEEP = 1.0


def _slow_decode():
    frames = _frames(21, "ab", 4)
    frames["slow"] = frames["a0"]

    def load(key):
        if key == "slow":
            time.sleep(SLEEP)
        return frames[key]

    def source():
        for o in [{"id": "a", "image": "slow"}, {"id": "b", "image": "b0"},
                  {"step": True},
                  {"id": "a", "image": "a1"}, {"id": "b", "image": "b1"},
                  {"step": True}]:
            yield json.dumps(o) + "\n"
        time.sleep(SLEEP)      # the stale decode drains inside the loop
        for o in [{"id": "a", "image": "a2"}, {"id": "b", "image": "b2"},
                  {"step": True},
                  {"id": "a", "image": "a3"}, {"id": "b", "image": "b3"},
                  {"step": True}]:
            yield json.dumps(o) + "\n"

    return 2, source, load, dict(emit_probs=True, decode_workers=2,
                                 decode_timeout=0.15), {}


def _stale_saturation_churn():
    blank = np.zeros((HW, HW, 3), np.uint8)

    def load(key):
        if key.startswith("hang"):
            time.sleep(1.0)
        return blank

    lines = [{"id": "x1", "image": "hang1"}, {"step": True},
             {"id": "x1", "end": True},
             {"id": "x2", "image": "hang2"}, {"step": True},
             {"id": "x2", "end": True},
             {"id": "x3", "image": "hang3"}, {"step": True}]
    return 2, lines, load, dict(emit_probs=True, decode_workers=2,
                                decode_timeout=0.1), {}


SCENARIOS = {"join_leave_recycle": _join_leave_recycle, "warmup": _warmup,
             "dropped_tick_and_errors": _dropped_tick_and_errors,
             "numeric_ids": _numeric_ids, "idle_eviction": _idle_eviction,
             "stats_heartbeat": _stats_heartbeat,
             "self_ticking": _self_ticking, "slow_decode": _slow_decode,
             "stale_saturation_churn": _stale_saturation_churn}


def _run(loop, engine, slots, lines, frames, kw):
    if callable(lines):
        src = lines()
    else:
        src = io.StringIO("".join(o if isinstance(o, str)
                                  else json.dumps(o) + "\n" for o in lines))
    load = frames if callable(frames) else frames.__getitem__
    out, stats = io.StringIO(), io.StringIO()
    summary = loop(engine, slots, src, out, load, stats_f=stats, **kw)
    return _rows(out.getvalue()), summary, _rows(stats.getvalue())


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_serve_loop_matches_jax(engines, name):
    jax_engine, port, _ = engines
    slots, lines, frames, kw, port_kw = SCENARIOS[name]()
    want, want_sum, want_stats = _run(jax_serve.serve_loop, jax_engine, slots,
                                      lines, frames, kw)
    got, got_sum, got_stats = _run(serve.serve_loop, port, slots, lines,
                                   frames, dict(kw, **port_kw))
    _assert_rows_match(got, want)
    _summaries_match(got_sum, want_sum)
    assert [{k: v for k, v in s["stats"].items() if "lat" not in k}
            for s in got_stats] == \
        [{k: v for k, v in s["stats"].items() if "lat" not in k}
         for s in want_stats]
    assert all(s["stats"]["lat_ms_p50"] > 0 for s in got_stats)
    # every scenario provokes what it is named for
    errors = [r["error"] for r in want if "error" in r]
    expect = {"join_leave_recycle": ["no free slot"],
              "dropped_tick_and_errors": ["bad json", "multiple frames",
                                          "missing id", "unknown stream",
                                          "missing image", "decode failed"],
              "idle_eviction": ["idle for 2 ticks"],
              "slow_decode": ["decode timeout", "decode busy"],
              "stale_saturation_churn": ["decode timeout", "decode timeout",
                                         "pool saturated"]}.get(name, [])
    for e in expect:
        assert any(e in x for x in errors), (e, errors)
    if name == "stats_heartbeat":
        assert [s["stats"]["tick"] for s in got_stats] == [2, 4]
    if name == "self_ticking":
        assert got_sum["ticks"] == 3 and not errors


# -- checkpoints ----------------------------------------------------------


def _tick_lines(ts):
    lines = []
    for t in ts:
        lines += [{"id": "a", "image": f"a{t}"}, {"id": "b", "image": f"b{t}"},
                  {"step": True}]
    return io.StringIO(_lines(lines))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_state_checkpoint_restores_across_packages(engines, tmp_path, writer):
    """A daemon of one package writes state.npz after 5 ticks; a daemon of
    the other restores it and serves the rest: the two runs' rows equal an
    uninterrupted run."""
    jax_engine, port, _ = engines
    n = 8
    frames = _frames(5, "ab", n)
    loops = {"port": (serve.serve_loop, port),
             "jax": (jax_serve.serve_loop, jax_engine)}
    first = loops[writer]
    second = loops["jax" if writer == "port" else "port"]
    whole = io.StringIO()
    second[0](second[1], 2, _tick_lines(range(n)), whole, frames.__getitem__,
              emit_probs=True)
    sdir = str(tmp_path / "state")
    out1, out2 = io.StringIO(), io.StringIO()
    first[0](first[1], 2, _tick_lines(range(5)), out1, frames.__getitem__,
             emit_probs=True, state_dir=sdir, checkpoint_every=1)
    with np.load(os.path.join(sdir, "state.npz")) as z:
        assert z["count"].dtype == np.int32 and z["meta"].shape == ()
        assert all(z[k].dtype == np.float32
                   for k in ("ext_ring", "tmr_ring", "bank_ring"))
    summary = second[0](second[1], 2, _tick_lines(range(5, n)), out2,
                        frames.__getitem__, emit_probs=True, state_dir=sdir)
    assert summary["resumed_at_tick"] == 5
    _assert_rows_match(_rows(out1.getvalue() + out2.getvalue()),
                       _rows(whole.getvalue()))


def _dying_lines():
    yield json.dumps({"id": "a", "image": "a0"}) + "\n"
    yield json.dumps({"step": True}) + "\n"
    yield json.dumps({"id": "a", "image": "a1"}) + "\n"
    raise SystemExit(0)


@pytest.mark.parametrize("how", ["deferred_stop", "abrupt_exit"])
def test_exit_paths_checkpoint_at_a_tick_boundary(engines, tmp_path, how):
    """A stop requested while a tick is in flight exits after the tick; a
    SystemExit between ticks (the CLI's SIGTERM handler) still writes the
    checkpoint. Both packages write the same checkpoint, and a restart
    resumes the stream's frame clock."""
    jax_engine, port, _ = engines
    frames = _frames(6, "a", 3)
    metas, outs = [], []
    for loop, engine in ((serve.serve_loop, port),
                         (jax_serve.serve_loop, jax_engine)):
        sdir = str(tmp_path / loop.__module__)
        out = io.StringIO()
        if how == "deferred_stop":
            src = io.StringIO(_lines([{"id": "a", "image": "a0"},
                                      {"step": True},
                                      {"id": "a", "image": "a1"},
                                      {"step": True}]))
            kw = dict(term_guard={"busy": False, "stop": True})
        else:
            src, kw = _dying_lines(), dict(checkpoint_every=0)
        with pytest.raises(SystemExit):
            loop(engine, 2, src, out, frames.__getitem__, emit_probs=True,
                 state_dir=sdir, **kw)
        with np.load(os.path.join(sdir, "state.npz")) as z:
            metas.append(json.loads(str(z["meta"])))
        outs.append(_rows(out.getvalue()))
        resumed = io.StringIO()
        summary = loop(engine, 2, io.StringIO(_lines(
            [{"id": "a", "image": "a1"}, {"step": True}])), resumed,
            frames.__getitem__, state_dir=sdir)
        assert summary["resumed_at_tick"] == 1
        assert _rows(resumed.getvalue())[0]["frame"] == 1
    assert metas[0] == metas[1] == {"slot_of": {"a": 0},
                                    "frame_idx": {"a": 1}, "ticks": 1}
    _assert_rows_match(outs[0], outs[1])
    assert [r["frame"] for r in outs[0]] == [0]


def test_stale_checkpoint_starts_fresh(engines, tmp_path):
    """A checkpoint of another ring shape (sequence_length 6) or one that
    lacks an array restores as a fresh start, not a crash."""
    _, port, make = engines
    frames = _frames(7, "a", 3)
    sdir = str(tmp_path / "sd")
    lines = _lines([{"id": "a", "image": f"a{t}"} for t in range(1)]
                   + [{"step": True}])
    serve.serve_loop(port, 2, io.StringIO(lines), io.StringIO(),
                     frames.__getitem__, state_dir=sdir)
    _, tcfg6, _ = _configs(seq=6)
    summary = serve.serve_loop(make(tcfg6), 2, io.StringIO(lines),
                               io.StringIO(), frames.__getitem__,
                               state_dir=sdir)
    assert summary["resumed_at_tick"] == 0
    path = os.path.join(sdir, "state.npz")
    with np.load(path) as z:
        kept = {k: z[k] for k in z.files if k != "count"}
    np.savez(path, **kept)
    summary = serve.serve_loop(make(tcfg6), 2, io.StringIO(lines),
                               io.StringIO(), frames.__getitem__,
                               state_dir=sdir)
    assert summary["resumed_at_tick"] == 0


# -- the multi-client fuzz of tests/test_serve_fuzz.py ---------------------


def test_serve_loop_multiclient_random_schedule_matches_spec(engines):
    """The seeded schedule of joins, frames, ends, cross-client offenses,
    oversubscription, a disconnect and idle evictions through the port's
    serve_loop and through the spec simulator: every row (content, order,
    destination) equal, and every stepped frame's pred/valid that of the
    port's solo run of that stream."""
    _, port, _ = engines
    rng = np.random.RandomState(1234)
    vids = {s: rng.randint(0, 256, (VIDEO_LEN, HW, HW, 3)).astype(np.uint8)
            for s in STREAMS}
    oracle = {s: _solo(port, v) for s, v in vids.items()}
    frames = {f"{s}:{t}": vids[s][t] for s in STREAMS
              for t in range(VIDEO_LEN)}
    home = {s: CLIENTS[i % len(CLIENTS)] for i, s in enumerate(STREAMS)}
    sim = _Sim(SLOTS, oracle, IDLE_TICKS)
    gone, lines = set(), []

    def feed(cid, obj):
        lines.append((cid, json.dumps(obj) + "\n"))
        sim.line(cid, obj)

    for rnd in range(60):
        if rnd == 30:
            lines.append((3, Disconnect()))
            sim.disconnect(3)
            gone.add(3)
        for s in STREAMS:
            cid = home[s]
            if cid in gone:
                continue
            r = rng.rand()
            t = sim.pending.get(s, sim.frame_idx.get(s, 0))
            if r < 0.55 and t < VIDEO_LEN:
                feed(cid, {"id": s, "image": f"{s}:{t}"})
            elif r < 0.62 and t < VIDEO_LEN:
                feed(cid, {"id": s, "image": f"{s}:{t}"})
                feed(cid, {"id": s, "image": f"{s}:{t}"})
            elif r < 0.70:
                feed(cid, {"id": s, "end": True})
            elif r < 0.76:
                other = CLIENTS[(cid + 1) % len(CLIENTS)]
                if other not in gone:
                    feed(other, {"id": s, "image": f"{s}:{t}"})
        if rng.rand() < 0.08:
            feed(0, {"id": "ghost", "end": True})
        if rng.rand() < 0.85:
            feed(0, {"step": True})
    feed(0, {"step": True})
    sim.flush()

    out = _Sink()
    summary = serve.serve_loop(port, SLOTS, iter(lines), out,
                               frames.__getitem__, idle_ticks=IDLE_TICKS)
    assert len(out.rows) == len(sim.expected)
    for i, ((gc, gr), (ec, er)) in enumerate(zip(out.rows, sim.expected)):
        assert gc == ec, f"row {i}: dest {gc} != {ec} ({gr} vs {er})"
        for k, v in er.items():
            assert gr.get(k) == v, f"row {i}: {k}={gr.get(k)!r} != {v!r}"
    assert summary["live_streams"] == len(sim.slot_of)
    assert summary["evicted"] == sum(1 for _, r in sim.expected
                                     if r.get("evicted"))
    texts = [r.get("error", "") for _, r in sim.expected]
    assert any("owned by another" in t for t in texts)
    assert any("multiple frames" in t for t in texts)
    assert any("unknown stream" in t for t in texts)
    assert any(r.get("evicted") for _, r in sim.expected)
    assert sum(1 for _, r in sim.expected if "frame" in r) > 100
