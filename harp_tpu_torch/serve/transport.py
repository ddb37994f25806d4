"""asyncio TCP front end — the continuous request plane's wire: the port
of ``harp_tpu.serve.transport`` (host code, copied).

The JSONL protocol on a socket, unchanged: ``{"id": ..., "x"/"users":
...}`` in, ``{"id": ..., "result"/"error": ...}`` out, one JSON object a
line.

Threading model — one event loop, one dispatcher thread:

- the **asyncio event loop** owns every socket.  Per connection it reads
  lines, stamps each request's arrival time at the socket (the honest
  latency origin), and pushes ``(conn, seq, req, t_arrival, trace_id)``
  onto a thread-safe queue.  Admission never waits on the device:
  requests keep streaming in while batches are in flight.
- the **dispatcher thread** owns the torch work.  It drains the admission
  queue into the server's :class:`~harp_tpu_torch.serve.server.
  ContinuousRunner`, steps the dispatch pipeline, and posts completed
  responses back to the event loop, which delivers them to the owning
  connection through a per-connection writer task.

Ordering: responses are delivered in admission order per connection.
Control lines: ``{"cmd": "stats"}`` answers at once from the reader (out
of band), ``{"cmd": "quit"}`` (or EOF) closes that connection once its
outstanding responses have flushed, ``{"cmd": "shutdown"}`` drains the
pipeline and stops the whole server.

Failure behavior: a client that disconnects — cleanly or mid-flight —
costs exactly its own work: the dispatcher finishes any batch its rows
already share, the orphaned responses are dropped at delivery
(``_Conn.closed``), and every other connection is untouched.  Engine
failures never reach this layer as exceptions: the runner isolates them
into per-request structured error responses.
"""

from __future__ import annotations

import asyncio
import json
import queue
import sys
import threading
import time
from typing import Any

from harp_tpu_torch.serve.server import Server
from harp_tpu_torch.utils import reqtrace

_STOP = object()   # dispatcher-queue sentinel
_CLOSE = object()  # per-connection writer sentinel


class _Conn:
    """Per-connection bookkeeping, touched only from the event loop
    (except the hashable identity the dispatcher uses as a key)."""

    def __init__(self, writer: asyncio.StreamWriter):
        self.writer = writer
        self.q: asyncio.Queue = asyncio.Queue()
        self.outstanding = 0
        self.draining = False
        self.closed = False  # writer gone: drop orphaned responses
        self.seq = 0


class TCPFrontEnd:
    """One server's TCP front end.  ``port=0`` binds a free port (read
    it back from ``.port`` after startup); ``start_in_thread`` runs the
    whole loop on a daemon thread for tests and drive scripts."""

    def __init__(self, server: Server, host: str = "127.0.0.1",
                 port: int = 0, *, max_queue_delay_s: float = 0.005,
                 rung_policy: str = "adaptive", depth: int = 2,
                 deadline_s: float | None = None,
                 max_queue_rows: int | None = None, max_retries: int = 2):
        self.srv = server
        self.host, self.port = host, port
        self._knobs = dict(max_queue_delay_s=max_queue_delay_s,
                           rung_policy=rung_policy, depth=depth,
                           deadline_s=deadline_s,
                           max_queue_rows=max_queue_rows,
                           max_retries=max_retries)
        self._inq: queue.Queue = queue.Queue()
        self._loop: asyncio.AbstractEventLoop | None = None
        self._started = threading.Event()
        self._thread: threading.Thread | None = None
        self._conns: set[_Conn] = set()
        self._rids: dict[Any, int] = {}  # (conn, seq) -> trace id
        self.runner = None

    # -- event-loop side ---------------------------------------------------
    async def _run(self) -> None:
        self._loop = asyncio.get_running_loop()
        self._closed = asyncio.Event()
        self.runner = self.srv.make_runner(**self._knobs)
        self._aserver = await asyncio.start_server(
            self._handle, self.host, self.port)
        self.port = self._aserver.sockets[0].getsockname()[1]
        self._dispatcher = threading.Thread(
            target=self._dispatch_loop, name="harp-serve-dispatch",
            daemon=True)
        self._dispatcher.start()
        self._started.set()
        await self._closed.wait()
        self._aserver.close()  # stop accepting; live conns drain below
        self._inq.put(_STOP)
        # join on an executor thread — joining inline would block the
        # loop the dispatcher needs for its final response deliveries
        await self._loop.run_in_executor(None, self._dispatcher.join)
        # deliveries the dispatcher scheduled before exiting are already
        # queued ahead of this callback, so every response is in its
        # connection queue by now: release the readers still blocked
        for conn in list(self._conns):
            conn.draining = True
            if conn.outstanding == 0:
                conn.q.put_nowait(_CLOSE)
        await self._aserver.wait_closed()

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        conn = _Conn(writer)
        self._conns.add(conn)
        wtask = asyncio.ensure_future(self._write_loop(conn))
        try:
            while not conn.draining:
                try:
                    line = await reader.readline()
                except (ConnectionError, asyncio.IncompleteReadError,
                        OSError):
                    break  # peer vanished mid-flight: same as EOF
                if not line:
                    break
                line = line.strip()
                if not line:
                    continue
                try:
                    req = json.loads(line)
                except ValueError:
                    self._deliver(conn, {"id": None,
                                         "error": "unparseable JSON"})
                    continue
                cmd = req.get("cmd") if isinstance(req, dict) else None
                if cmd == "stats":
                    stats = self.srv.stats()
                    if self.runner is not None:
                        stats["continuous"] = self.runner.stats()
                        # health sentinel at top level too: the
                        # SLO-burn snapshot an operator polls for —
                        # also nested under continuous.health
                        stats["health"] = self.runner.health.snapshot(
                            time.perf_counter())
                    conn.q.put_nowait(stats)
                    continue
                if cmd == "quit":
                    break
                if cmd == "shutdown":
                    self._closed.set()
                    break
                conn.outstanding += 1
                conn.seq += 1
                # trace id minted AT the socket: the honest span
                # origin is transport arrival, not dispatcher admission
                t = time.perf_counter()
                rid = reqtrace.arrive(t, transport="tcp",
                                      conn=id(conn), seq=conn.seq)
                self._inq.put((conn, conn.seq, req, t, rid))
        finally:
            conn.draining = True
            if conn.outstanding == 0 or conn.closed:
                conn.q.put_nowait(_CLOSE)
            await wtask
            self._conns.discard(conn)

    async def _write_loop(self, conn: _Conn) -> None:
        while True:
            resp = await conn.q.get()
            if resp is _CLOSE:
                break
            conn.writer.write((json.dumps(resp) + "\n").encode())
            try:
                await conn.writer.drain()
            except (ConnectionError, OSError):
                break  # peer gone: remaining responses become orphans
        conn.closed = True
        try:
            conn.writer.close()
        except Exception:  # noqa: BLE001 - already-gone peer is fine
            pass

    def _deliver(self, conn: _Conn, resp: dict,
                 data_response: bool = False) -> None:
        """Runs on the event loop; per-conn order is the queue order.

        A response for a connection whose writer already closed (client
        disconnected mid-flight) is DROPPED — the batch that produced it
        still served every live request in it, and the accounting below
        still releases the reader so the connection tears down."""
        if not conn.closed:
            conn.q.put_nowait(resp)
        if data_response:
            conn.outstanding -= 1
            if conn.draining and conn.outstanding == 0:
                conn.q.put_nowait(_CLOSE)

    # -- dispatcher side ---------------------------------------------------
    def _post(self, key: Any, resp: dict) -> None:
        conn, _seq = key
        # delivery closes the causal chain: the span already terminated
        # (served/shed/failed) when the runner answered; this stamps the
        # moment the response left the dispatcher for the owning socket
        reqtrace.tracer.event(self._rids.pop(key, None), "deliver",
                              time.perf_counter())
        self._loop.call_soon_threadsafe(self._deliver, conn, resp, True)

    def _submit(self, item) -> None:
        conn, seq, req, t, rid = item
        key = (conn, seq)
        if rid is not None:
            self._rids[key] = rid
        for k, resp in self.runner.submit(key, req, now=t, trace_id=rid):
            self._post(k, resp)

    def _dispatch_loop(self) -> None:
        r = self.runner
        stop = False
        while True:
            while True:  # drain every admission already queued
                try:
                    item = self._inq.get_nowait()
                except queue.Empty:
                    break
                if item is _STOP:
                    stop = True
                    break
                self._submit(item)
            if stop:
                for key, resp in r.drain():
                    self._post(key, resp)
                return
            for key, resp in r.step():
                self._post(key, resp)
            if r.pending() == 0 and not r._in_flight:
                item = self._inq.get()  # idle: block for work
                if item is _STOP:
                    for key, resp in r.drain():
                        self._post(key, resp)
                    return
                self._submit(item)

    # -- lifecycle ---------------------------------------------------------
    def start_in_thread(self) -> "TCPFrontEnd":
        self._thread = threading.Thread(
            target=lambda: asyncio.run(self._run()),
            name="harp-serve-tcp", daemon=True)
        self._thread.start()
        if not self._started.wait(timeout=120):
            raise RuntimeError("TCP front end failed to start")
        return self

    def shutdown(self) -> None:
        if self._loop is not None:
            self._loop.call_soon_threadsafe(self._closed.set)

    def join(self, timeout: float | None = 120) -> None:
        if self._thread is not None:
            self._thread.join(timeout)


def serve_forever(server: Server, host: str, port: int, *,
                  max_queue_delay_s: float = 0.005,
                  rung_policy: str = "adaptive",
                  deadline_s: float | None = None,
                  max_queue_rows: int | None = None,
                  max_retries: int = 2) -> None:
    """CLI entry: serve until a ``{"cmd": "shutdown"}`` line arrives
    (prints one ``serve_listening`` JSON line to stderr with the bound
    port so callers of ``--tcp 0`` can find it)."""
    fe = TCPFrontEnd(server, host, port,
                     max_queue_delay_s=max_queue_delay_s,
                     rung_policy=rung_policy, deadline_s=deadline_s,
                     max_queue_rows=max_queue_rows,
                     max_retries=max_retries)

    async def _main():
        task = asyncio.ensure_future(fe._run())
        await asyncio.sleep(0)  # let _run bind before announcing
        while not fe._started.is_set():
            await asyncio.sleep(0.01)
        print(json.dumps({"kind": "serve_listening", "host": host,
                          "port": fe.port}), file=sys.stderr, flush=True)
        await task

    asyncio.run(_main())
