"""The port's JsonlTcpServer in front of the port's serve_loop over the
port's StreamingInference (CPU): the cases of `tests/test_serve_net.py`
(routing and isolation, a restored stream reclaimed by a new connection,
the oversize line, `stop()` on an idle loop and on a full queue, the slow
consumer) and a short churn soak. Every row is held to the port engine's
solo run of its stream.

The soak waits for each disconnect and each last `end` to be processed
before it goes on (a probe line whose error row can only come after it),
so no orphaned frame is stepped after a disconnect and no `end` is lost at
`stop()`."""

import io
import json
import socket
import threading
import time

import numpy as np
import pytest
import torch

from tests.test_serve import _solo
from tmrnet_torch.config import DataConfig, ExperimentConfig, MemoryConfig, ModelConfig
from tmrnet_torch.eval.serve import serve_loop
from tmrnet_torch.eval.serve_net import JsonlTcpServer
from tmrnet_torch.eval.stream import StreamingInference
from tmrnet_torch.models.convert import from_jax_variables, random_variables

torch.set_num_threads(2)

SEQ, WIN, HID, HW = 4, 4, 16, 24


@pytest.fixture(scope="module")
def engine():
    model = dict(backbone="tiny", stage_sizes=(1, 1), width=8, hidden_dim=HID,
                 num_classes=7, head="tmr", compute_dtype="float32")
    cfg = ExperimentConfig(
        data=DataConfig(device_normalize=True, sequence_length=SEQ),
        model=ModelConfig(**model), memory=MemoryConfig(window=WIN))
    return StreamingInference(
        cfg, from_jax_variables(random_variables(ModelConfig(**model), 31)),
        from_jax_variables(random_variables(
            ModelConfig(**dict(model, head="lfb")), 32)), device="cpu")


def _videos(seed, names, n):
    rng = np.random.default_rng(seed)
    vids = {k: rng.integers(0, 256, (n, HW, HW, 3), dtype=np.uint8)
            for k in names}
    frames = {f"{k}{t}": vids[k][t] for k in vids for t in range(n)}
    return vids, frames


class _Client:
    def __init__(self, port):
        self.sock = socket.create_connection(("127.0.0.1", port), timeout=60)
        self.f = self.sock.makefile("r")

    def send(self, obj):
        self.sock.sendall((json.dumps(obj) + "\n").encode())

    def recv(self):
        line = self.f.readline()
        assert line, "connection closed while expecting a row"
        return json.loads(line)

    def close(self):
        self.sock.shutdown(socket.SHUT_RDWR)
        self.f.close()
        self.sock.close()


def _start(engine, server, frames, slots=2, **kw):
    res = {}

    def go():
        res["summary"] = serve_loop(engine, slots, server.lines(), server,
                                    frames.__getitem__,
                                    **dict(dict(decode_workers=0), **kw))

    th = threading.Thread(target=go, name="serve-loop")
    th.start()
    return th, res


def _check(row, sid, t, oracle):
    pred, valid = oracle[t]
    assert (row["id"], row["frame"]) == (sid, t), row
    assert row["valid"] == valid
    assert row["pred"] == (pred if valid else None)


def test_tcp_two_clients_route_isolate_and_recover_slots(engine):
    """Two clients, one stream each, in a 2-slot daemon: rows route to the
    owning connection and match the solo runs; an ownership violation
    errors to the offender; a dropped connection with a frame pending
    frees its slot for a new stream."""
    vids, frames = _videos(21, "abc", 4)
    ref = {k: _solo(engine, v) for k, v in vids.items()}
    server = JsonlTcpServer("127.0.0.1", 0)
    th, res = _start(engine, server, frames)
    c1 = None
    try:
        c1, c2 = _Client(server.port), _Client(server.port)
        for t in range(2):
            c1.send({"id": "a", "image": f"a{t}"})
            c1.send({"step": True})
            _check(c1.recv(), "a", t, ref["a"])
            c2.send({"id": "b", "image": f"b{t}"})
            c2.send({"step": True})
            _check(c2.recv(), "b", t, ref["b"])
        c2.send({"id": "a", "image": "a2"})
        assert "owned by another client" in c2.recv()["error"]
        c1.send({"id": "a", "image": "a2"})
        c1.send({"step": True})
        _check(c1.recv(), "a", 2, ref["a"])
        # b's disconnect with a frame pending; the end probe's reply says
        # the disconnect was processed (before it: owned by another client)
        c2.send({"id": "b", "image": "b2"})
        c2.close()
        deadline = time.monotonic() + 30
        while True:
            c1.send({"id": "b", "end": True})
            err = c1.recv()["error"]
            if err == "unknown stream":
                break
            assert err == "stream owned by another client", err
            assert time.monotonic() < deadline, "disconnect never processed"
            time.sleep(0.02)
        c1.send({"id": "c", "image": "c0"})
        c1.send({"step": True})
        _check(c1.recv(), "c", 0, ref["c"])
    finally:
        server.stop()
        th.join(timeout=30)
        if c1 is not None:
            c1.close()
    assert not th.is_alive()
    assert res["summary"]["rows"] == 6           # b2 dropped with its client
    assert res["summary"]["live_streams"] == 2


def test_tcp_restored_stream_reclaimed_by_new_connection(engine, tmp_path):
    """A checkpointed stream belongs to no connection after a restart; the
    first client to send its next frame resumes it mid-video."""
    vids, frames = _videos(31, "v", 6)
    ref = _solo(engine, vids["v"])
    state_dir = str(tmp_path / "state")
    lines = "".join(json.dumps(o) + "\n" for t in range(3)
                    for o in ({"id": "v", "image": f"v{t}"}, {"step": True}))
    serve_loop(engine, 2, io.StringIO(lines), io.StringIO(),
               frames.__getitem__, state_dir=state_dir, decode_workers=0)
    server = JsonlTcpServer("127.0.0.1", 0)
    th, res = _start(engine, server, frames, state_dir=state_dir)
    try:
        c = _Client(server.port)
        for t in range(3, 6):
            c.send({"id": "v", "image": f"v{t}"})
            c.send({"step": True})
            _check(c.recv(), "v", t, ref)
        c.close()
    finally:
        server.stop()
        th.join(timeout=30)
    assert res["summary"]["resumed_at_tick"] == 3


def test_tcp_oversize_line_disconnects_offender_only(engine):
    """An over-long line disconnects its client and frees its slot; the
    other client is served."""
    _, frames = _videos(41, "v", 2)
    server = JsonlTcpServer("127.0.0.1", 0, max_line=4096)
    th, _ = _start(engine, server, frames, slots=1)
    try:
        bad, good = _Client(server.port), _Client(server.port)
        bad.send({"id": "x", "image": "v0"})
        bad.send({"step": True})
        assert bad.recv()["frame"] == 0
        bad.sock.sendall(b"a" * 10000)
        assert "exceeds" in bad.recv()["error"]
        assert bad.f.readline() == ""
        deadline = time.monotonic() + 30
        while True:
            good.send({"id": "y", "image": "v1"})
            good.send({"step": True})
            row = good.recv()
            if "error" not in row:
                break
            assert "no free slot" in row["error"]
            assert time.monotonic() < deadline, "slot never freed"
            time.sleep(0.05)
        assert (row["id"], row["frame"]) == ("y", 0)
        good.close()
    finally:
        server.stop()
        th.join(timeout=30)
    assert not th.is_alive()


@pytest.mark.parametrize("queue", ["idle_loop", "full_queue"])
def test_tcp_server_stop(engine, queue):
    """stop() ends an idle loop with no client ever connected, and returns
    at once with the pending-line queue full (it may run on the loop's own
    thread, from a signal handler), the queued lines still draining."""
    if queue == "idle_loop":
        server = JsonlTcpServer("127.0.0.1", 0)
        th, res = _start(engine, server, {}, slots=1)
        time.sleep(0.2)
        server.stop()
        th.join(timeout=10)
        assert not th.is_alive() and res["summary"]["rows"] == 0
        return
    server = JsonlTcpServer("127.0.0.1", 0, max_pending=2)
    server._q.put((1, '{"x": 1}\n'))
    server._q.put((1, '{"x": 2}\n'))
    t0 = time.monotonic()
    server.stop()
    assert time.monotonic() - t0 < 1.0
    assert [json.loads(l)["x"] for _, l in server.lines()] == [1, 2]


def test_tcp_slow_consumer_disconnected_not_stalling(engine):
    """A client that never reads fills its socket buffers; the send times
    out, the client is disconnected and its slot serves another."""
    _, frames = _videos(51, "x", 4)
    server = JsonlTcpServer("127.0.0.1", 0, send_timeout=0.5, so_sndbuf=2048)
    th, _ = _start(engine, server, frames, slots=1)
    try:
        slow = socket.socket()
        slow.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 2048)
        slow.connect(("127.0.0.1", server.port))
        payload = b"".join(
            (json.dumps({"id": "a", "image": f"x{t % 4}"}) + "\n"
             + '{"step": true}\n').encode() for t in range(600))
        slow.sendall(payload)
        deadline, ok = time.time() + 60, False
        while time.time() < deadline and not ok:
            c2 = _Client(server.port)
            c2.send({"id": "b", "image": "x0"})
            c2.send({"step": True})
            row = c2.recv()
            ok = row.get("id") == "b" and "error" not in row
            c2.close()
            if not ok:
                time.sleep(0.5)
        assert ok, "slot never freed: slow consumer was not disconnected"
        slow.close()
    finally:
        server.stop()
        th.join(timeout=30)
    assert not th.is_alive()


def test_tcp_churn_soak_stays_correct(engine):
    """Two connections drive 6 stream lives (join, every frame, a clean
    end) through a 2-slot daemon with the decode pool on; the 3rd life
    drops its connection mid-life with a frame pending. Every row matches
    the solo run at its life's frame, every emitted row reached a client,
    and no stream is left at shutdown."""
    n = 6
    vids, frames = _videos(47, "abc", n)
    ref = {k: _solo(engine, v) for k, v in vids.items()}
    server = JsonlTcpServer("127.0.0.1", 0)
    th, res = _start(engine, server, frames, decode_workers=2)
    clients, received = None, 0

    def settled(c, sid):
        """Wait until `sid` is gone: an end probe answers `unknown stream`
        only after the stream's end or disconnect has been processed."""
        deadline = time.monotonic() + 30
        while True:
            c.send({"id": sid, "end": True})
            err = c.recv()["error"]
            if err == "unknown stream":
                return
            assert err == "stream owned by another client", err
            assert time.monotonic() < deadline, "stream never ended"
            time.sleep(0.02)

    try:
        clients = [_Client(server.port) for _ in range(2)]
        for life in range(6):
            c = clients[life % 2]
            sid = "abc"[life % 3]
            churn = life == 2
            for t in range(3 if churn else n):
                c.send({"id": sid, "image": f"{sid}{t}"})
                c.send({"step": True})
                _check(c.recv(), sid, t, ref[sid])
                received += 1
            if churn:
                c.send({"id": sid, "image": f"{sid}3"})   # left pending
                c.close()
                clients[life % 2] = c = _Client(server.port)
            else:
                c.send({"id": sid, "end": True})
            settled(c, sid)
    finally:
        server.stop()
        th.join(timeout=60)
        for c in clients or []:
            c.close()
    assert not th.is_alive()
    assert res["summary"]["rows"] == received
    assert res["summary"]["live_streams"] == 0
