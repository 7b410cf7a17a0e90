"""Line-delimited JSON serving protocol over the streaming engine.

Port of `tmrnet_tpu/eval/serve.py` (`Disconnect` :32, `_save_state` :38,
`_load_state` :55, `serve_loop` :87-517) over
`tmrnet_torch/eval/stream.py::StreamingInference`. A daemon owns B stream
slots and speaks JSONL on stdin/stdout (or TCP, `eval/serve_net.py`):

  in:  {"id": "or-1", "image": "/frames/or1.npy#123"}      frame this tick
       {"id": "or-1", "end": true}                          stream finished
       {"step": true}                                       run the tick
  out: {"id": "or-1", "frame": 123, "pred": 3, "valid": true}
       {"id": "or-9", "error": "no free slot"}

Slots are fixed at startup; streams join on their first frame (slot reset
in place via reset_streams), leave on "end", and a stream that misses a
tick simply isn't stepped (the engine's active mask freezes its state: a
dropped frame never corrupts the clip ring). Frames for one stream must
arrive in order; different streams are independent.

The protocol, its rows and error strings, their order and routing are
JAX's byte for byte; `state.npz` keeps JAX's layout (f32 rings, int32
`count`, `meta` a JSON string), so each package restores the other's
checkpoint. Only the protocol loop touches torch: decode workers run the
frame loader (numpy), and `step`'s outputs come to the host with one
`.cpu()` each per tick, inside `step_ms`.
"""

from __future__ import annotations

import json
import os
import time
from typing import Callable, IO, Optional

import numpy as np
import torch

from tmrnet_torch.eval.stream import StreamState


class Disconnect:
    """Sentinel line value in multi-client mode: the tagged client closed
    its connection. serve_loop ends every stream that client owned (frees
    the slots) — the TCP equivalent of per-stream {"end": true} lines."""


def _save_state(state_dir: str, state, slot_of: dict,
                frame_idx: dict, ticks: int) -> None:
    """Atomic serving-state checkpoint: rings/counts (bf16 -> f32 losslessly)
    AND the slot map in one file replaced with one os.replace, so a crash
    can never leave the arrays and the metadata from different ticks."""
    os.makedirs(state_dir, exist_ok=True)
    tmp = os.path.join(state_dir, "state.tmp.npz")
    meta = {"slot_of": slot_of, "frame_idx": frame_idx, "ticks": ticks}
    f32 = lambda t: t.detach().float().cpu().numpy()
    np.savez(tmp,
             ext_ring=f32(state.ext_ring),
             tmr_ring=f32(state.tmr_ring),
             bank_ring=f32(state.bank_ring),
             count=state.count.cpu().numpy().astype(np.int32),
             meta=np.asarray(json.dumps(meta)))
    os.replace(tmp, os.path.join(state_dir, "state.npz"))


def _load_state(state_dir: str, engine, num_slots: int):
    """Restore a checkpoint written by _save_state, or None (fresh start)
    if absent or shaped for a different slot count / model config — a stale
    checkpoint must never crash-loop the recovery path."""
    spath = os.path.join(state_dir, "state.npz")
    if not os.path.exists(spath):
        return None
    want = {
        "ext_ring": (num_slots, engine.seq, engine.feature_dim),
        "tmr_ring": (num_slots, engine.seq, engine.feature_dim),
        "bank_ring": (num_slots, engine.window, engine.hidden),
        "count": (num_slots,),
    }
    with np.load(spath) as data:
        if any(k not in data or data[k].shape != shape
               for k, shape in list(want.items()) + [("meta", ())]):
            return None
        ring = lambda k: torch.from_numpy(np.asarray(data[k], np.float32)).to(
            device=engine.device, dtype=engine.cdt)
        state = StreamState(
            ext_ring=ring("ext_ring"), tmr_ring=ring("tmr_ring"),
            bank_ring=ring("bank_ring"),
            count=torch.from_numpy(np.asarray(data["count"], np.int32)).to(
                engine.device))
        meta = json.loads(str(data["meta"]))
    return state, meta


def serve_loop(engine, num_slots: int, in_f: IO[str], out_f: IO[str],
               load_frame_fn: Callable[[str], np.ndarray],
               emit_probs: bool = False,
               warmup_shape: Optional[tuple] = None,
               warmup_dtype=np.float32,
               state_dir: Optional[str] = None,
               checkpoint_every: int = 64,
               term_guard: Optional[dict] = None,
               decode_workers: int = 4,
               decode_timeout: float = 5.0,
               tick_interval: float = 0.0,
               idle_ticks: int = 0,
               stats_every: int = 0,
               stats_f: Optional[IO[str]] = None,
               on_ready: Optional[Callable[[], None]] = None) -> dict:
    """Run the protocol until EOF on in_f. Returns a summary dict.

    engine: StreamingInference. load_frame_fn maps the protocol's "image"
    field to one (H, W, 3) frame array (numpy; it runs on decode threads).

    warmup_shape: per-frame (H, W, C) — when given, one ALL-INACTIVE step on
    blank frames runs before reading stdin, so the kernels' first build
    (nvcc, ~10 s on a cold cache) is paid at startup instead of on the
    first client request; the active mask freezes every slot, so warmup
    cannot perturb stream state. warmup_dtype must match the wire dtype
    real frames will use (uint8 under data.device_normalize, float
    otherwise), or the first real tick takes another path.

    state_dir: when given, the serving state (rings, counts, slot map)
    checkpoints atomically every `checkpoint_every` ticks (<=0: only at
    exit) and on every exit path, and a restarted daemon restores it —
    live streams resume mid-video with their clip rings and banks intact
    instead of starting over.

    term_guard: optional {'busy': bool, 'stop': bool} shared with a signal
    handler — 'busy' is True while a tick mutates state (the handler should
    defer instead of raising mid-tick, keeping the exit checkpoint
    tick-consistent), and 'stop' requests a clean exit at the next tick
    boundary.

    decode_workers: frame decodes run on this many pool threads instead of
    inline in the protocol loop, overlapping with protocol
    parsing and each other; 0 decodes inline. decode_timeout: at the tick,
    a frame whose decode hasn't finished within this many seconds is
    dropped (error row; the active mask freezes that stream for the tick —
    the clip ring stays consistent), so one slow/corrupt feed can't stall
    every live stream past the timeout. Reported latency includes decode
    wait (`latency_ms`); `step_ms` isolates the model step.

    tick_interval: > 0 makes the daemon SELF-TICKING — pending frames flush
    every `tick_interval` seconds of wall clock (a reader thread feeds the
    protocol), so live feeds (e.g. 1 fps ORs: 1.0) never need to send
    `{"step": true}` lines; explicit step lines still work and flush
    immediately. A tick that outlasts the interval (first build) delays
    the cadence rather than bursting catch-up ticks. 0 (default): ticks
    happen only on step lines / EOF — the fully client-driven protocol.

    stats_every: > 0 prints one JSON stats line (tick count, rows, live
    streams, rolling latency p50/p95) to stats_f (default stderr) every
    N ticks — a long-running daemon's liveness/latency heartbeat, separate
    from the protocol stream on out_f.

    idle_ticks: > 0 evicts a stream that hasn't contributed a frame to any
    of the last `idle_ticks` ticks — an abandoned feed (client that never
    sends "end" and never disconnects) frees its slot instead of leaking it
    until "no free slot". The evicted stream gets one
    `{"id": ..., "evicted": true}` row; rejoining later starts it fresh.
    0 (default): streams live until "end"/disconnect.

    Multi-client transports (serve_net.JsonlTcpServer): in_f may yield
    `(client, line)` tuples instead of bare lines, and out_f may expose
    `send(text, client)` — rows then route to the client that OWNS the
    stream (ownership = whoever sent its first frame; other clients get
    "stream owned by another client" errors), id-less errors to the sender
    of the offending line. A `(client, Disconnect())` item ends every
    stream that client owned, so a dropped TCP connection frees its slots.
    Bare-line mode (stdin) is the degenerate single-client case.
    """
    restored = _load_state(state_dir, engine, num_slots) if state_dir else None
    if restored is not None:
        state, meta = restored
        slot_of = {k: int(v) for k, v in meta["slot_of"].items()}
        frame_idx = {k: int(v) for k, v in meta["frame_idx"].items()}
        for sid in slot_of:   # tolerate a checkpoint from a torn join
            frame_idx.setdefault(sid, 0)
        ticks = int(meta["ticks"])
    else:
        state = engine.init_state(num_slots)
        slot_of, frame_idx, ticks = {}, {}, 0
    if warmup_shape is not None:  # all-inactive: safe after a restore too
        blank_b = np.zeros((num_slots,) + tuple(warmup_shape), warmup_dtype)
        state, _, _, _ = engine.step(
            state, blank_b, active=np.zeros((num_slots,), bool))
        # also run the slot reset once (all-False mask = no-op), so the
        # first stream join pays no first-call cost
        state = engine.reset_streams(state, np.zeros((num_slots,), bool))
    if on_ready is not None:
        # the real readiness signal: the warmup (kernel builds) is done, the
        # next frame is served at steady-state latency (a TCP "listening"
        # line fires earlier, before warmup — probes should key on this)
        on_ready()
    free = [s for s in range(num_slots - 1, -1, -1)
            if s not in slot_of.values()]
    tick: dict = {}         # slot -> (stream id, frame array or Future)
    blank: Optional[np.ndarray] = None
    emitted = 0
    # Rolling latency windows, bounded so a weeks-long daemon doesn't grow
    # one float per tick forever; the first tick (which carries the kernel
    # builds when warmup is off) is held separately and excluded from the
    # steady percentiles.
    from collections import deque

    lat_ms: deque = deque(maxlen=8192)   # decode-wait+step+fetch per tick
    step_ms: deque = deque(maxlen=8192)  # model step+fetch only
    first_tick_ms: list = []             # [latency, step] of tick 1 only
    pool = None
    inflight: dict = {}     # stream id -> last submitted decode Future
    stale: list = []        # timed-out decodes still occupying workers
    if decode_workers > 0:
        from concurrent.futures import ThreadPoolExecutor

        pool = ThreadPoolExecutor(max_workers=decode_workers,
                                  thread_name_prefix="decode")

    owner: dict = {}        # stream id -> client (None in stdin mode)
    cur = [None]            # client of the line being processed (mutable
    #                         cell: emit is a closure over it)
    send = getattr(out_f, "send", None)
    # stream id -> tick of its last stepped frame (idle eviction); restored
    # streams start their idle clock at the restore tick
    last_seen: dict = {sid: ticks for sid in slot_of}
    evicted = 0

    _AUTO = object()

    def emit(obj, dest=_AUTO):
        text = json.dumps(obj) + "\n"
        if send is not None:
            if dest is _AUTO:
                # route to the stream's owner; id-less errors (bad json,
                # missing id) go back to whoever sent the offending line
                sid = obj.get("id")
                dest = (owner.get(sid, cur[0]) if sid is not None
                        else cur[0])
            send(text, dest)
            return
        out_f.write(text)
        # error rows arrive between ticks: flush per row so a client waiting
        # on a join/frame response never deadlocks on the pipe buffer
        if "error" in obj:
            out_f.flush()

    def end_stream(sid) -> bool:
        """Release a stream's slot and bookkeeping; False if unknown."""
        owner.pop(sid, None)
        last_seen.pop(sid, None)
        slot = slot_of.pop(sid, None)
        if slot is None:
            return False
        frame_idx.pop(sid, None)
        tick.pop(slot, None)
        fut = inflight.pop(sid, None)
        if fut is not None and fut not in stale \
                and not fut.cancel() and not fut.done():
            # an end (or disconnect) with the decode still running orphans
            # a worker thread that can't be cancelled — track it against
            # the stale cap, or end/rejoin churn could occupy every worker
            # with hung decodes the saturation check never sees (a decode
            # that already TIMED OUT at a tick is in stale already)
            stale.append(fut)
        free.append(slot)
        return True

    def flush():
        nonlocal state, blank, ticks, emitted
        if not tick:
            return
        if term_guard is not None:
            term_guard["busy"] = True
        try:
            _flush_tick()
        finally:
            if term_guard is not None:
                term_guard["busy"] = False
        if term_guard is not None and term_guard.get("stop"):
            raise SystemExit(0)  # deferred SIGTERM: exit at tick boundary

    def _flush_tick():
        nonlocal state, blank, ticks, emitted, evicted
        t0 = time.perf_counter()
        if pool is not None:
            # gather this tick's decodes under one shared deadline; a frame
            # that misses it is dropped (stream frozen for the tick)
            from concurrent.futures import TimeoutError as _FutTimeout

            deadline = t0 + decode_timeout
            for slot in sorted(tick):
                sid, fut = tick[slot]
                try:
                    frame = fut.result(
                        timeout=max(deadline - time.perf_counter(), 0.0))
                except _FutTimeout:
                    emit({"id": sid, "error":
                          f"decode timeout (>{decode_timeout}s): frame "
                          f"dropped, stream frozen this tick"})
                    stale.append(fut)
                    del tick[slot]
                    continue
                except Exception as e:
                    emit({"id": sid, "error": f"decode failed: {e}"})
                    del tick[slot]
                    continue
                tick[slot] = (sid, frame)
        if not tick:    # every decode failed/timed out: nothing to step
            out_f.flush()
            return
        if blank is None:
            blank = np.zeros_like(next(iter(tick.values()))[1])
        frames = np.stack([tick[i][1] if i in tick else blank
                           for i in range(num_slots)])
        active = np.array([i in tick for i in range(num_slots)], bool)
        t1 = time.perf_counter()
        state, preds, probs, valid = engine.step(state, frames, active)
        preds, valid = preds.cpu().numpy(), valid.cpu().numpy()
        p = probs.cpu().numpy() if emit_probs else None
        now = time.perf_counter()
        if not first_tick_ms:
            first_tick_ms[:] = [(now - t0) * 1e3, (now - t1) * 1e3]
        else:
            lat_ms.append((now - t0) * 1e3)
            step_ms.append((now - t1) * 1e3)
        ticks += 1
        for slot in sorted(tick, key=lambda s: tick[s][0]):
            sid = tick[slot][0]
            row = {"id": sid, "frame": frame_idx[sid],
                   "pred": int(preds[slot]) if valid[slot] else None,
                   "valid": bool(valid[slot])}
            if p is not None:
                row["probs"] = [round(float(v), 6) for v in p[slot]]
            emit(row)
            emitted += 1
            frame_idx[sid] += 1
            last_seen[sid] = ticks
        tick.clear()
        if idle_ticks > 0:
            for sid in [s for s in slot_of
                        if ticks - last_seen.get(s, ticks) >= idle_ticks]:
                emit({"id": sid, "evicted": True,
                      "error": f"idle for {idle_ticks} ticks: slot "
                               f"reclaimed (rejoin starts fresh)"})
                end_stream(sid)
                evicted += 1
        out_f.flush()
        if stats_every > 0 and ticks % stats_every == 0:
            import sys as _sys

            window = (list(lat_ms)[-stats_every:]
                      or first_tick_ms[:1])  # tick 1 lives outside the deque
            line = {"tick": ticks, "rows": emitted,
                    "live_streams": len(slot_of), "evicted": evicted,
                    "lat_ms_p50": round(float(np.percentile(window, 50)), 2),
                    "lat_ms_p95": round(float(np.percentile(window, 95)), 2)}
            print(json.dumps({"stats": line}),
                  file=stats_f or _sys.stderr, flush=True)
        if state_dir and checkpoint_every > 0 \
                and ticks % checkpoint_every == 0:
            _save_state(state_dir, state, slot_of, frame_idx, ticks)

    if tick_interval and tick_interval > 0:
        import queue as _queue
        import threading

        _eof = object()
        q: _queue.Queue = _queue.Queue(maxsize=4096)

        def _reader():
            try:
                for ln in in_f:
                    q.put(ln)
            finally:
                q.put(_eof)

        threading.Thread(target=_reader, daemon=True,
                         name="serve-reader").start()

        def _lines():
            # None = wall-clock tick marker; resumes AFTER the caller's
            # flush, so a slow tick (first build) pushes the next
            # deadline out instead of firing a burst of catch-up ticks
            deadline = time.monotonic() + tick_interval
            while True:
                now = time.monotonic()
                if now >= deadline:
                    yield None
                    deadline = max(deadline + tick_interval,
                                   time.monotonic())
                    continue
                try:
                    item = q.get(timeout=deadline - now)
                except _queue.Empty:
                    continue
                if item is _eof:
                    return
                yield item

        source = _lines()
    else:
        source = in_f

    try:
        for line in source:
            if line is None:   # wall-clock tick (self-ticking mode)
                flush()
                continue
            if isinstance(line, tuple):   # multi-client: (client, line)
                cur[0], line = line
            else:
                cur[0] = None
            if isinstance(line, Disconnect):
                # the client vanished: end every stream it owned so the
                # slots free up (pending tick frames are dropped with them)
                for sid in [s for s, c in owner.items() if c == cur[0]]:
                    end_stream(sid)
                continue
            line = line.strip()
            if not line:
                continue
            try:
                obj = json.loads(line)
            except json.JSONDecodeError as e:
                emit({"error": f"bad json: {e}"})
                continue
            if obj.get("step"):
                flush()
                continue
            sid = obj.get("id")
            if sid is None:
                emit({"error": "missing id"})
                continue
            # ids are strings everywhere (JSON keys stringify in the state
            # checkpoint — a numeric id would stop matching after a resume)
            sid = str(sid)
            # ownership: the client whose frame joined a stream owns it; a
            # restored (checkpointed) stream is unowned until any client
            # reattaches with its next frame or end line
            if sid in owner and owner[sid] != cur[0]:
                # to the OFFENDER, not the owner (auto-routing would pick
                # the owner — the one client that didn't send this line)
                emit({"id": sid, "error": "stream owned by another client"},
                     dest=cur[0])
                continue
            if obj.get("end"):
                if not end_stream(sid):
                    emit({"id": sid, "error": "unknown stream"})
                continue
            if "image" not in obj:
                emit({"id": sid, "error": "missing image"})
                continue
            if sid not in slot_of:
                if not free:
                    emit({"id": sid, "error": "no free slot"})
                    continue
                slot = free.pop()
                mask = np.zeros((num_slots,), bool)
                mask[slot] = True
                # publish order is signal-safety-critical: reset the ring
                # first (a checkpoint of a reset-but-unmapped slot is
                # harmless — it stays free and reset is idempotent), then
                # frame_idx BEFORE slot_of so a checkpoint can never hold a
                # mapped stream without a frame counter (resume would
                # KeyError on its first row)
                state = engine.reset_streams(state, mask)  # fresh stream
                frame_idx[sid] = 0
                last_seen[sid] = ticks  # idle clock starts at join
                slot_of[sid] = slot
            slot = slot_of[sid]
            owner[sid] = cur[0]   # claim (idempotent for the owner)
            if slot in tick:
                emit({"id": sid, "error": "multiple frames in one tick"})
                continue
            if pool is not None:
                # per-stream backpressure: a timed-out decode keeps running
                # (ThreadPoolExecutor can't cancel started work), so never
                # stack a second decode for the same stream — otherwise one
                # chronically slow feed accumulates stale futures until all
                # workers starve every healthy stream
                prev = inflight.get(sid)
                if prev is not None and not prev.done():
                    emit({"id": sid, "error": "decode busy: previous frame "
                                              "still decoding, dropped"})
                    continue
                # the per-stream check is keyed by protocol id, which an
                # end/rejoin cycle resets — also cap STALE decodes (timed
                # out but still running: started threads can't be
                # cancelled) so id churn can't occupy every worker with
                # hung decodes and starve healthy streams
                stale[:] = [f for f in stale if not f.done()]
                if len(stale) >= decode_workers:
                    emit({"id": sid, "error": "decode busy: pool saturated "
                                              "by stalled decodes, dropped"})
                    continue
                fut = pool.submit(load_frame_fn, obj["image"])
                inflight[sid] = fut
                tick[slot] = (sid, fut)
                continue
            try:
                tick[slot] = (sid, load_frame_fn(obj["image"]))
            except Exception as e:  # decode failure: skip frame, keep stream
                emit({"id": sid, "error": f"decode failed: {e}"})
        flush()  # trailing frames without a final step line
    finally:
        if pool is not None:
            pool.shutdown(wait=False, cancel_futures=True)
        # checkpoint on EVERY exit path — EOF, SIGINT, a crashed tick —
        # so the restarted daemon resumes from the last completed tick
        if state_dir:
            _save_state(state_dir, state, slot_of, frame_idx, ticks)
    summary = {"ticks": ticks, "rows": emitted,
               "live_streams": len(slot_of), "slots": num_slots,
               "evicted": evicted,
               "resumed_at_tick": int(meta["ticks"]) if restored else 0}
    if first_tick_ms:  # first tick excluded: it can carry the builds
        steady = list(lat_ms) or first_tick_ms[:1]
        summary["latency_ms"] = {   # includes decode wait
            "p50": round(float(np.percentile(steady, 50)), 2),
            "p95": round(float(np.percentile(steady, 95)), 2),
            "first": round(first_tick_ms[0], 2)}
        steady_s = list(step_ms) or first_tick_ms[1:]
        summary["step_ms"] = {      # model step+fetch only
            "p50": round(float(np.percentile(steady_s, 50)), 2),
            "p95": round(float(np.percentile(steady_s, 95)), 2)}
    return summary
