"""TCP transport for the serving protocol (eval/serve.py).

Port of `tmrnet_tpu/eval/serve_net.py` (`JsonlTcpServer` :38-205).
`JsonlTcpServer` accepts any number of concurrent client connections,
merges their JSONL lines into one `(client, line)` stream for the protocol
loop, and routes each response row back to the connection that owns its
stream (ownership lives in serve_loop; a dropped connection turns into a
`Disconnect` marker that frees the client's slots):

    python -m tmrnet_torch serve --listen 0.0.0.0:7860 ...
    # any number of gateways connect and speak the same JSONL protocol

Threading model: one acceptor thread, one reader thread per connection,
all feeding a bounded queue the (single-threaded) protocol loop drains.
Writes happen from the protocol loop only, serialized per client with a
lock. None of these threads touches torch.
"""

from __future__ import annotations

import itertools
import json
import queue
import socket
import threading
from typing import Iterator, Optional, Tuple

from tmrnet_torch.eval.serve import Disconnect

_SHUTDOWN = object()


class JsonlTcpServer:
    """Multi-client JSONL-over-TCP front end for serve_loop.

    Usage:
        server = JsonlTcpServer("0.0.0.0", 7860)
        serve_loop(engine, slots, server.lines(), server, load_fn, ...)
        server.stop()   # from a signal handler: unblocks lines()

    `lines()` yields `(client_id, line_str)` tuples plus
    `(client_id, Disconnect())` when a connection drops; `send(text, cid)`
    writes a response row to one client (silently dropped if that client is
    gone — its Disconnect is already queued and will free the streams).
    `write`/`flush` exist so the object can stand in for serve_loop's
    out_f: id-less rows with no resolvable destination are dropped.
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 max_pending: int = 8192, max_line: int = 1 << 20,
                 send_timeout: float = 10.0, so_sndbuf: int = 0):
        self._srv = socket.create_server((host, port))
        self.host, self.port = self._srv.getsockname()[:2]
        self.max_line = max_line
        # A client that stops READING eventually fills its kernel socket
        # buffer and sendall would block the (single) protocol thread —
        # one slow consumer stalling every live stream. The timeout bounds
        # that; on expiry the offender is disconnected like any protocol
        # violation (its reader thread queues the Disconnect that frees
        # its slots). so_sndbuf shrinks the kernel buffer (tests).
        self.send_timeout = send_timeout
        self._so_sndbuf = so_sndbuf
        self._q: queue.Queue = queue.Queue(maxsize=max_pending)
        self._conns: dict = {}           # client id -> socket
        self._locks: dict = {}           # client id -> write lock
        self._stop = threading.Event()
        self._ids = itertools.count(1)
        threading.Thread(target=self._accept, daemon=True,
                         name="serve-accept").start()

    # -- reader side ---------------------------------------------------

    def _accept(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _addr = self._srv.accept()
            except OSError:              # listener closed by stop()
                return
            cid = next(self._ids)
            if self.send_timeout:
                # bounds writes; the reader treats its recv timeouts as
                # keep-waiting, so idle clients are unaffected
                conn.settimeout(self.send_timeout)
            if self._so_sndbuf:
                conn.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF,
                                self._so_sndbuf)
            self._conns[cid] = conn
            self._locks[cid] = threading.Lock()
            threading.Thread(target=self._read, args=(cid, conn),
                             daemon=True,
                             name=f"serve-client-{cid}").start()

    def _read(self, cid: int, conn: socket.socket) -> None:
        try:
            # manual line assembly with a hard cap: makefile().readline has
            # no limit, so one client streaming bytes without a newline
            # would grow the buffer unboundedly. An over-long line
            # disconnects the client (protocol violation), freeing its
            # slots like any other disconnect.
            buf = bytearray()
            while True:
                try:
                    chunk = conn.recv(65536)
                except TimeoutError:
                    # send_timeout gates this socket's recv too; an idle
                    # client is not a protocol violation — keep waiting
                    continue
                if not chunk:
                    break
                buf += chunk
                while True:
                    nl = buf.find(b"\n")
                    if nl < 0:
                        break
                    line = bytes(buf[:nl + 1])
                    del buf[:nl + 1]
                    self._q.put((cid, line.decode("utf-8", "replace")))
                if len(buf) > self.max_line:
                    self.send(json.dumps(
                        {"error": f"line exceeds {self.max_line} bytes: "
                                  "disconnecting"}) + "\n", cid)
                    return
            if buf:                      # trailing line without newline
                self._q.put((cid, buf.decode("utf-8", "replace")))
        except (OSError, ValueError):
            pass                         # dropped connection mid-line
        finally:
            self._close_client(cid)
            # queue the departure AFTER the lines the client did send (the
            # queue is FIFO), so they are processed first, then its streams
            # end
            self._q.put((cid, Disconnect()))

    def lines(self) -> Iterator[Tuple[int, object]]:
        """Merged client lines in arrival order; returns after stop()."""
        while True:
            try:
                item = self._q.get(timeout=0.25)
            except queue.Empty:
                if self._stop.is_set():
                    return
                continue
            if item is _SHUTDOWN:
                return
            yield item

    # -- writer side (out_f protocol) -----------------------------------

    def send(self, text: str, cid: Optional[int]) -> None:
        conn = self._conns.get(cid)
        lock = self._locks.get(cid)
        if conn is None or lock is None:
            return                       # client gone or unroutable: drop
        try:
            with lock:
                conn.sendall(text.encode("utf-8"))
        except OSError:
            # broken pipe, or a SLOW CONSUMER (sendall timed out against a
            # full kernel buffer — TimeoutError is an OSError): disconnect
            # so one client that stopped reading can't stall the protocol
            # thread for everyone; its reader thread surfaces the
            # Disconnect that frees its streams
            self._close_client(cid)

    def write(self, text: str) -> None:
        """out_f fallback for rows with no destination: drop."""

    def flush(self) -> None:
        """sendall is unbuffered; nothing to flush."""

    # -- lifecycle -------------------------------------------------------

    def _close_client(self, cid: int) -> None:
        conn = self._conns.pop(cid, None)
        self._locks.pop(cid, None)
        if conn is not None:
            try:
                conn.close()
            except OSError:
                pass

    def stop(self) -> None:
        """Unblock lines() and close the listener + every connection.
        Safe from a signal handler or another thread; idempotent."""
        self._stop.set()
        try:
            self._srv.close()
        except OSError:
            pass
        for cid in list(self._conns):
            self._close_client(cid)
        # best-effort wakeup only: stop() runs on the protocol-loop thread
        # when invoked from a signal handler, so a BLOCKING put on a full
        # queue would deadlock (the only consumer is suspended under this
        # very call). lines() also exits via its 0.25 s timeout once _stop
        # is set, so losing the sentinel costs at most one timeout tick.
        try:
            self._q.put_nowait(_SHUTDOWN)
        except queue.Full:
            pass
