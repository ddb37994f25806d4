"""The serve server: a resident model on the worker group, JSONL over
stdio — the port of ``harp_tpu.serve.server``.

1. **startup**: the newest checkpoint (``CheckpointManager.
   restore_latest``) or a given state, the engine's state placed once on
   the mesh's device, and one :class:`~harp_tpu_torch.serve.cache.
   RungExecutable` a ladder rung through the graph cache: on the card each
   rung's step is captured once as a CUDA graph, and a batch is one
   replay;
2. **steady state**: two request planes share the rungs:

   - *burst* (:meth:`Server.process` / :meth:`Server.serve_stdio`): a
     burst is admitted, drained to completion through the micro-batcher,
     and only then is the next burst admitted;
   - *continuous* (:class:`ContinuousRunner`): requests are admitted into
     the :class:`~harp_tpu_torch.serve.batcher.ContinuousScheduler` while
     device batches are in flight, and batch t+1 is dispatched before
     batch t is read back.

   Either way every scheduler window runs under the flight recorder's
   steady-state guard (``compiles=0, dispatches<=1, readbacks<=1``:
   :class:`harp_tpu_torch.utils.flightrec.SteadyState`; the continuous
   loop also proves exact totals with ``verify_exact``).  While batch t
   runs, batch t+1 is staged through another of the rung's buffer sets.

The request protocol is line-delimited JSON, over stdin/stdout or over
asyncio TCP (:mod:`harp_tpu_torch.serve.transport`, ``--tcp PORT``):

- request: ``{"id": <any>, "x": [[...], ...]}`` (``"users"`` for
  mfsgd); rows beyond the max ladder rung span several batches;
- response: ``{"id": <same>, "result": [<one entry per row>]}`` in
  request order, or ``{"id": ..., "error": "..."}``;
- control: ``{"cmd": "stats"}`` emits a stats line, ``{"cmd": "quit"}``
  (or EOF) shuts down.
"""

from __future__ import annotations

import collections
import json
import sys
import time
from typing import IO, Any, Callable, Sequence

import numpy as np

from harp_tpu_torch import health as health_mod
from harp_tpu_torch.serve.batcher import (DEFAULT_LADDER, ContinuousScheduler,
                                          MicroBatcher, ShapeLadder)
from harp_tpu_torch.serve.cache import (GraphCache, RungExecutable,
                                        code_fingerprint, default_capture)
from harp_tpu_torch.serve.engines import make_engine
from harp_tpu_torch.utils import flightrec, reqtrace, telemetry

_DEFAULT = object()  # capture: the device's own (the card captures)
#: buffer sets a rung holds: the deepest in-flight pipeline it serves (the
#: continuous plane's default depth; the burst plane stages one ahead)
BUFFER_SETS = 2


class Server:
    """One app's inference server on a resident worker group.

    ``state`` (a checkpoint nest) or ``ckpt`` (a CheckpointManager root;
    the newest step restored) must be given.  The server runs on ``mesh``,
    else a mesh on ``device``, else the process's default (this worker's
    card, which raises where there is none).  ``cache_dir=None`` keeps no
    records; with a directory the graph cache counts hits and misses.
    ``budget_action`` is "raise" (tests) or "warn" (production and bench:
    record, do not die).  ``capture`` replaces the device's capture
    (``cache.RungExecutable``; a test's stand-in), None runs eagerly.
    """

    def __init__(self, app: str, state: dict | None = None, *,
                 ckpt: str | None = None, mesh=None, device=None,
                 ladder: Sequence[int] = DEFAULT_LADDER,
                 cache_dir: str | None = None,
                 budget_action: str = "raise",
                 engine_opts: dict | None = None, capture=_DEFAULT):
        from harp_tpu_torch.parallel.mesh import resolve_mesh

        self.mesh = resolve_mesh(mesh, device)
        if state is None:
            if ckpt is None:
                raise ValueError("Server needs state= or ckpt=")
            from harp_tpu_torch.utils.checkpoint import CheckpointManager

            self.ckpt_step, state = CheckpointManager(ckpt).restore_latest()
        else:
            self.ckpt_step = None
        self.app = app
        self.engine = make_engine(app, state, self.mesh,
                                  **(engine_opts or {}))
        self.ladder = (ladder if isinstance(ladder, ShapeLadder)
                       else ShapeLadder(ladder))
        self.batcher = MicroBatcher(self.ladder)
        self.capture = (default_capture(self.mesh.device)
                        if capture is _DEFAULT else capture)
        self.cache = (GraphCache(
            cache_dir, code_fingerprint(self.engine.fingerprint_modules()))
            if cache_dir else None)
        self.steady = flightrec.SteadyState(
            compiles=0, dispatches=1, readbacks=1,
            action=budget_action, tag=f"serve.{app}")
        self._rungs: dict[int, RungExecutable] = {}
        self._exec: dict[int, object] = {}
        self.requests_served = 0
        self.rows_served = 0
        self.last_batch_times: list[tuple[int, int, float]] = []

    # -- startup -----------------------------------------------------------
    def startup(self) -> dict:
        """Place the state and build every rung (capturing its graph on
        the card).  Returns ``{"rungs", "cache_hits", "cache_misses",
        "captures", "compiles"}``: ``captures`` counts the graphs
        captured, ``compiles`` the CompileWatch delta across startup
        (kernel builds and captures; None while telemetry is off)."""
        base = flightrec.snapshot() if telemetry.enabled() else None
        n_state = len(self.engine.state_args())  # resident placement
        tag = self.engine.cache_tag()
        name = f"{self.app}[{tag}]" if tag else self.app
        captures = 0
        for rung in self.ladder.rungs:
            if self.cache is not None:
                exe = self.cache.get_or_build(name, self.engine, rung,
                                              BUFFER_SETS, self.capture)
            else:
                exe = RungExecutable(self.engine, rung, BUFFER_SETS,
                                     self.capture, label=name)
            captures += exe.graphs
            self._rungs[rung] = exe
            # the staged input (arg n_state) is consumed by the dispatch:
            # the next staging overwrites the rung's static input
            self._exec[rung] = flightrec.track(
                exe, f"serve.{self.app}.b{rung}",
                donate_argnums=(n_state,))
        self.steady.reset()
        return {
            "rungs": list(self.ladder.rungs),
            "cache_hits": self.cache.hits if self.cache else 0,
            "cache_misses": self.cache.misses if self.cache else 0,
            "captures": captures,
            "compiles": (flightrec.delta_since(base)["compiles"]
                         if base is not None else None),
        }

    def wrap_executables(self, wrap_fn) -> None:
        """Re-wrap every rung's executable: ``exe -> wrap_fn(rung, exe)``
        (the hook tests use to observe or sabotage the dispatch plane);
        wrappers must delegate attribute access like ``flightrec.track``'s
        do."""
        if not self._exec:
            raise RuntimeError("call startup() before wrap_executables()")
        self._exec = {rung: wrap_fn(rung, exe)
                      for rung, exe in self._exec.items()}

    # -- steady state ------------------------------------------------------
    def _stage(self, batch, rows_by_slot: dict):
        parts = [rows_by_slot[slot][lo:hi]
                 for slot, lo, hi in batch.requests]
        rows = (np.concatenate(parts, axis=0) if len(parts) > 1
                else parts[0])
        return self._rungs[batch.rung].stage(
            self.engine.make_input(rows, batch.rung))

    def _readback(self, rung: int, out_dev) -> np.ndarray:
        """One counted readback of a rung's output; frees its buffer set."""
        out = flightrec.readback(out_dev)
        self._rungs[rung].release(out_dev)
        return out

    def process(self, requests: list[dict]) -> list[dict]:
        """Answer a burst of requests (arrival order preserved)."""
        if not self._exec:
            raise RuntimeError("call startup() before process()")
        t0 = time.perf_counter()
        responses: list[dict | None] = [None] * len(requests)
        rows_by_slot: dict[int, np.ndarray] = {}
        out_segs: dict[int, list[np.ndarray]] = {}
        for slot, req in enumerate(requests):
            if not isinstance(req, dict):
                responses[slot] = {"id": None,
                                   "error": "request must be a JSON object"}
                continue
            try:
                rows = self.engine.rows_from_request(req)
                if rows.shape[0] == 0:
                    responses[slot] = {"id": req.get("id"), "result": []}
                    continue
            except (ValueError, KeyError, TypeError) as e:
                responses[slot] = {"id": req.get("id"), "error": str(e)}
                continue
            rows_by_slot[slot] = rows
            out_segs[slot] = []
            self.batcher.put(slot, rows.shape[0])

        batches = list(self.batcher.batches())
        self.last_batch_times = []
        state_args = self.engine.state_args()
        staged = self._stage(batches[0], rows_by_slot) if batches else None
        for i, batch in enumerate(batches):
            with self.steady.batch():
                out_dev = self._exec[batch.rung](*state_args, staged)
                # double buffer: stage batch i+1 while i is in flight
                staged = (self._stage(batches[i + 1], rows_by_slot)
                          if i + 1 < len(batches) else None)
                out = self._readback(batch.rung, out_dev)
            self.last_batch_times.append(
                (batch.rung, batch.rows, time.perf_counter() - t0))
            cursor = 0
            for slot, lo, hi in batch.requests:
                out_segs[slot].append(out[cursor:cursor + (hi - lo)])
                cursor += hi - lo
            self.rows_served += batch.rows

        for slot, segs in out_segs.items():
            full = (np.concatenate(segs, axis=0) if len(segs) > 1
                    else segs[0])
            n = rows_by_slot[slot].shape[0]
            responses[slot] = {
                "id": requests[slot].get("id"),
                "result": self.engine.output_rows(full, n)}
        self.requests_served += sum(r is not None and "result" in r
                                    for r in responses)
        return responses  # type: ignore[return-value]

    def stats(self) -> dict:
        return {
            "kind": "serve_stats", "app": self.app,
            "requests_served": self.requests_served,
            "rows_served": self.rows_served,
            "padding_frac": round(self.batcher.padding_frac(), 6),
            "steady": self.steady.summary(),
        }

    def make_runner(self, *, max_queue_delay_s: float = 0.005,
                    rung_policy: str = "adaptive", depth: int = 2,
                    clock: Callable[[], float] = time.perf_counter,
                    deadline_s: float | None = None,
                    max_queue_rows: int | None = None,
                    max_retries: int = 2,
                    stats_window_s: float = 60.0) -> "ContinuousRunner":
        """A continuous request plane over this server's executables."""
        if not self._exec:
            raise RuntimeError("call startup() before make_runner()")
        if depth > BUFFER_SETS:
            raise ValueError(f"pipeline depth {depth} exceeds the "
                             f"{BUFFER_SETS} buffer sets a rung holds")
        return ContinuousRunner(self, max_queue_delay_s=max_queue_delay_s,
                                rung_policy=rung_policy, depth=depth,
                                clock=clock, deadline_s=deadline_s,
                                max_queue_rows=max_queue_rows,
                                max_retries=max_retries,
                                stats_window_s=stats_window_s)

    # -- stdio loop --------------------------------------------------------
    def serve_stdio(self, stdin: IO, stdout: IO) -> int:
        """Blocking JSONL loop; returns the number of requests answered.

        Consecutive already-available lines coalesce into one burst (so
        the micro-batcher sees the real queue depth, not one request at
        a time); a line arriving alone is its own burst — the 1-rung.
        """
        reader = _BurstReader(stdin)
        while True:
            lines = reader.read_burst()
            if not lines:
                return self.requests_served
            burst: list[dict] = []
            for line in lines:
                try:
                    req = json.loads(line)
                except ValueError:
                    # flush first: responses must come out in input order
                    self._flush(burst, stdout)
                    burst = []
                    stdout.write(json.dumps(
                        {"id": None, "error": "unparseable JSON"}) + "\n")
                    continue
                cmd = req.get("cmd") if isinstance(req, dict) else None
                if cmd == "quit":
                    self._flush(burst, stdout)
                    stdout.flush()
                    return self.requests_served
                if cmd == "stats":
                    self._flush(burst, stdout)
                    burst = []
                    stdout.write(json.dumps(self.stats()) + "\n")
                    continue
                burst.append(req)
            self._flush(burst, stdout)
            stdout.flush()

    def _flush(self, burst: list[dict], stdout: IO) -> None:
        if burst:
            for resp in self.process(burst):
                stdout.write(json.dumps(resp) + "\n")


class ContinuousRunner:
    """Admit-while-in-flight dispatcher — the continuous request plane.

    Owns one :class:`~harp_tpu_torch.serve.batcher.ContinuousScheduler`
    and a bounded pipeline of in-flight device batches (``depth``,
    default 2, at most the buffer sets a rung holds).  The driving loop
    is three verbs:

    - :meth:`submit` admits a request at its arrival time (legal at any
      moment — between :meth:`step` calls of an active pipeline);
    - :meth:`step` performs ONE scheduler-window action: dispatch the
      next batch when the policy says go and the pipeline has room,
      else read back the oldest in-flight batch, else nothing.  Batch
      t+1 therefore dispatches right after batch t's dispatch returns,
      BEFORE t's readback, so the card need not drain while the host
      admits, stages and formats;
    - completed responses come back from :meth:`step` as ``(key,
      response)`` pairs, in admission order (FIFO rows through FIFO
      batches — per-connection ordering is the transport's for free).

    Every window runs under the server's :class:`~harp_tpu_torch.utils.
    flightrec.SteadyState` budget (``compiles=0, dispatches<=1,
    readbacks<=1``), and :meth:`verify_exact` proves the run's totals
    were exactly one dispatch + one readback per batch.  ``clock`` is
    injected so tests and the sustained-load bench drive the policy on
    a deterministic timeline.

    Graceful degradation — under overload or faults the plane
    degrades instead of dying, and every degradation is a counted,
    structured response (never unbounded latency, never a dead server):

    - **bounded admission** (``max_queue_rows``): a request that would
      push the queue past the bound is SHED at submit with
      ``{"error": ..., "shed": true, "reason": "queue_full"}``;
    - **per-request deadlines** (``deadline_s``): a queued request whose
      deadline passes before any of its rows dispatch is shed with
      ``reason: "deadline"`` (dispatching it would waste a rung on an
      answer the client already gave up on); a request that completes
      late is still answered but counted in ``deadline_misses``;
    - **retry-with-restage** (``max_retries``): a transient dispatch
      failure (an :class:`~harp_tpu_torch.utils.fault.InjectedFault`)
      retries the batch, always through a fresh staging of its input,
      as the reference does (there the failed attempt's buffer was
      donated);
    - **failure isolation**: when retries are exhausted the batch's
      requests get structured error responses and the runner keeps
      serving — one engine crash answers errors for its requests, it
      does not kill the server (``engine_failures`` counts).
    """

    #: exceptions never treated as transient: budget violations are the
    #: guard speaking, not the device failing — retrying would bury them
    _NON_TRANSIENT = (flightrec.BudgetExceeded,)

    def __init__(self, server: Server, *,
                 max_queue_delay_s: float = 0.005,
                 rung_policy: str = "adaptive", depth: int = 2,
                 clock: Callable[[], float] = time.perf_counter,
                 deadline_s: float | None = None,
                 max_queue_rows: int | None = None,
                 max_retries: int = 2,
                 stats_window_s: float = 60.0):
        if depth < 1:
            raise ValueError(f"pipeline depth {depth} must be >= 1")
        if max_retries < 0:
            raise ValueError(f"max_retries {max_retries} must be >= 0")
        self.srv = server
        self.sched = ContinuousScheduler(
            server.ladder, max_queue_delay_s=max_queue_delay_s,
            rung_policy=rung_policy)
        self.depth = int(depth)
        self.clock = clock
        self.deadline_s = deadline_s
        self.max_queue_rows = max_queue_rows
        self.max_retries = int(max_retries)
        self._in_flight: collections.deque = collections.deque()
        # key -> {"req", "rows", "segs", "rid"} admitted-not-answered
        self._asm: dict[Any, dict] = {}
        self.dispatched = 0
        self.completed = 0
        self.shed = 0
        self.deadline_misses = 0
        self.fault_retries = 0
        self.engine_failures = 0
        self.failed = 0  # requests answered with a hard-failure error
        self.latencies_ms: collections.deque = collections.deque(
            maxlen=4096)
        # streaming windowed percentiles: bounded-memory rolling
        # latency/queue-depth histograms on the runner's own clock —
        # live p50/p95/p99 for the TCP stats line and the sustained
        # bench row without retaining samples
        self.win = reqtrace.RollingWindow(window_s=stats_window_s)
        # health sentinel: multi-window SLO burn over this plane's
        # terminal outcomes, on the same clock/window geometry as the
        # rolling percentiles.  No-op while telemetry is off; the budgets
        # are the same with it armed.
        self.health = health_mod.SLOBurn(
            tag=f"serve.{server.app}", window_s=stats_window_s,
            latency_slo_ms=(deadline_s * 1e3 if deadline_s else None))

    # -- admission ---------------------------------------------------------
    def submit(self, key: Any, req: Any, now: float | None = None,
               trace_id: int | None = None) -> list[tuple[Any, dict]]:
        """Admit one request; returns immediately-answerable responses
        (malformed / empty / shed requests), else [] with the rows
        queued.  ``trace_id`` carries a request-tracer span minted at
        transport arrival; without one, a span is minted here
        at admission time — either way every offered request ends in a
        terminated span with outcome served/shed/failed."""
        now = self.clock() if now is None else now
        rid = (trace_id if trace_id is not None
               else reqtrace.tracer.begin(now))
        if not isinstance(req, dict):
            reqtrace.tracer.end(rid, "failed", now, reason="bad_request")
            self.health.observe(now, "failed", rid=rid)
            return [(key, {"id": None,
                           "error": "request must be a JSON object"})]
        try:
            rows = self.srv.engine.rows_from_request(req)
        except (ValueError, KeyError, TypeError) as e:
            reqtrace.tracer.end(rid, "failed", now, reason="bad_request")
            self.health.observe(now, "failed", rid=rid)
            return [(key, {"id": req.get("id"), "error": str(e)})]
        if rows.shape[0] == 0:
            reqtrace.tracer.end(rid, "served", now, rows=0)
            self.health.observe(now, "served", latency_ms=0.0)
            return [(key, {"id": req.get("id"), "result": []})]
        if key in self._asm:
            raise ValueError(f"request key {key!r} already in flight")
        if (self.max_queue_rows is not None
                and self.sched.queued_rows + rows.shape[0]
                > self.max_queue_rows):
            self.shed += 1
            reqtrace.tracer.end(rid, "shed", now, reason="queue_full",
                                queued_rows=self.sched.queued_rows)
            self.health.observe(now, "shed", rid=rid)
            return [(key, {
                "id": req.get("id"), "shed": True, "reason": "queue_full",
                "error": f"shed: admission queue full "
                         f"({self.sched.queued_rows} rows queued, bound "
                         f"{self.max_queue_rows})"})]
        reqtrace.tracer.event(rid, "admit", now, rows=int(rows.shape[0]),
                              queued_rows=self.sched.queued_rows)
        self._asm[key] = {"req": req, "rows": rows, "segs": [],
                          "arrival": now, "rid": rid}
        self.sched.put(key, rows.shape[0], now)
        return []

    # -- the scheduler window ----------------------------------------------
    def pending(self) -> int:
        """Admitted-not-answered requests (queued or in flight)."""
        return len(self._asm)

    def next_deadline(self) -> float | None:
        return self.sched.next_deadline()

    def step(self, now: float | None = None) -> list[tuple[Any, dict]]:
        """One window: dispatch if the policy fires and the pipeline has
        room, else read back the oldest in-flight batch.  Returns the
        responses completed by this window (shed/error responses for a
        degraded window; [] for a clean dispatch window or an idle
        call)."""
        now = self.clock() if now is None else now
        self.win.add_qdepth(now, self.sched.queued_rows)
        out: list[tuple[Any, dict]] = []
        if self.deadline_s is not None:
            out += self._shed_expired(now)
        idle = not self._in_flight
        if (len(self._in_flight) < self.depth
                and self.sched.ready(now, idle)):
            batch = self.sched.next_batch(now)
            if batch is None:  # everything expired out of the queue
                return out
            rows_by_key = {key: self._asm[key]["rows"]
                           for key, _, _ in batch.requests}
            tr = reqtrace.tracer
            tr.batch(batch.seq, now, rung=batch.rung, rows=batch.rows,
                     members=[(self._asm[key]["rid"], lo, hi)
                              for key, lo, hi in batch.requests])
            for key, lo, hi in batch.requests:
                tr.event(self._asm[key]["rid"], "batch", now,
                         seq=batch.seq, lo=lo, hi=hi, rung=batch.rung)
            attempt = 0
            fatal: Exception | None = None
            # ONE steady window for the whole dispatch-with-retries
            # phase ("produce one dispatched batch"), so a retry's
            # second staging is VISIBLE to the per-window budget — in
            # warn mode it lands in the budget-drift health row as
            # restage evidence instead of vanishing with the aborted
            # window
            with self.srv.steady.batch():
                while True:
                    try:
                        # a fresh staging per attempt, as the reference
                        # does (its failed attempt's buffer was donated)
                        staged = self.srv._stage(batch, rows_by_key)
                        out_dev = self.srv._exec[batch.rung](
                            *self.srv.engine.state_args(), staged)
                        break
                    except self._NON_TRANSIENT:
                        raise
                    except Exception as e:  # noqa: BLE001 - isolate
                        attempt += 1
                        if attempt > self.max_retries:
                            fatal = e
                            break
                        self.fault_retries += 1
                        # timestamps stay on the CALLER's clock (`now`):
                        # the sustained replay drives a virtual timeline,
                        # and a wall-clock stamp here would break the
                        # trace's monotone timestamps
                        tr.batch_event(batch.seq, "retry", now,
                                       attempt=attempt,
                                       error=f"{type(e).__name__}: {e}")
            if fatal is not None:
                return out + self._fail_batch(batch, fatal, now)
            self._in_flight.append((batch, out_dev))
            self.dispatched += 1
            self.srv.rows_served += batch.rows
            tr.batch_event(batch.seq, "dispatch", now)
            return out
        if self._in_flight:
            with self.srv.steady.batch():
                batch, out_dev = self._in_flight.popleft()
                res = self.srv._readback(batch.rung, out_dev)
            reqtrace.tracer.batch_event(batch.seq, "readback", now)
            return out + self._complete(batch, res, now)
        return out

    def _shed_expired(self, now: float) -> list[tuple[Any, dict]]:
        """Deadline shedding: queued requests past their deadline get a
        structured error NOW — never a dispatch, never silent latency."""
        out: list[tuple[Any, dict]] = []
        for key in self.sched.expire(now, self.deadline_s):
            a = self._asm.pop(key)
            self.shed += 1
            reqtrace.tracer.end(a["rid"], "shed", now, reason="deadline")
            self.health.observe(now, "shed", rid=a["rid"])
            out.append((key, {
                "id": a["req"].get("id"), "shed": True,
                "reason": "deadline",
                "error": f"shed: deadline ({self.deadline_s * 1e3:.1f} "
                         f"ms) exceeded before dispatch"}))
        return out

    def _fail_batch(self, batch, exc: Exception,
                    now: float) -> list[tuple[Any, dict]]:
        """Retries exhausted: isolate the failure to this batch's
        requests (structured errors) and keep the runner serving."""
        self.engine_failures += 1
        reqtrace.tracer.batch_event(batch.seq, "engine_failure", now,
                                    error=f"{type(exc).__name__}: {exc}")
        keys = {key for key, _, _ in batch.requests}
        self.sched.discard(keys)  # tail segments must not dispatch later
        out: list[tuple[Any, dict]] = []
        for key in dict.fromkeys(k for k, _, _ in batch.requests):
            a = self._asm.pop(key, None)
            if a is None:
                continue
            self.failed += 1
            reqtrace.tracer.end(a["rid"], "failed", now,
                                reason="engine_failure", seq=batch.seq)
            self.health.observe(now, "failed", rid=a["rid"])
            out.append((key, {
                "id": a["req"].get("id"),
                "error": f"engine failure after {self.max_retries} "
                         f"retries: {type(exc).__name__}: {exc}"}))
        return out

    def _complete(self, batch, out: np.ndarray,
                  now: float) -> list[tuple[Any, dict]]:
        responses: list[tuple[Any, dict]] = []
        cursor = 0
        for key, lo, hi in batch.requests:
            a = self._asm.get(key)
            if a is None:  # answered with an error by a failed batch
                cursor += hi - lo
                continue
            a["segs"].append(out[cursor:cursor + (hi - lo)])
            cursor += hi - lo
            if hi == a["rows"].shape[0]:  # final segment (FIFO rows)
                segs = a["segs"]
                full = (np.concatenate(segs, axis=0) if len(segs) > 1
                        else segs[0])
                responses.append((key, {
                    "id": a["req"].get("id"),
                    "result": self.srv.engine.output_rows(
                        full, hi)}))
                lat = now - a["arrival"]
                self.latencies_ms.append(lat * 1e3)
                self.win.add_latency(now, lat * 1e3)
                missed = (self.deadline_s is not None
                          and lat > self.deadline_s)
                if missed:
                    self.deadline_misses += 1  # answered, but late
                reqtrace.tracer.end(a["rid"], "served", now,
                                    latency_ms=round(lat * 1e3, 4))
                self.health.observe(now, "served",
                                    latency_ms=lat * 1e3,
                                    deadline_missed=missed,
                                    rid=a["rid"])
                del self._asm[key]
                self.completed += 1
                self.srv.requests_served += 1
        return responses

    def drain(self, now: float | None = None) -> list[tuple[Any, dict]]:
        """Run windows until nothing is queued or in flight (shutdown /
        end-of-trace flush)."""
        out: list[tuple[Any, dict]] = []
        while self._asm or self._in_flight:
            out.extend(self.step(now))
        return out

    def verify_exact(self, *, compiles: int = 0) -> dict:
        """Prove the run's totals: exactly one dispatch + one readback
        per dispatched batch (see ``SteadyState.verify_exact``)."""
        return self.srv.steady.verify_exact(self.dispatched,
                                            compiles=compiles)

    def stats(self) -> dict:
        lat = sorted(self.latencies_ms)

        def pct(p):
            return round(lat[min(len(lat) - 1,
                                 int(p / 100 * len(lat)))], 3) if lat \
                else None

        return {"mode": "continuous", "dispatched": self.dispatched,
                "completed": self.completed,
                "queued_rows": len(self.sched),
                "in_flight": len(self._in_flight),
                "padding_frac": round(self.sched.padding_frac(), 6),
                "shed": self.shed,
                "deadline_misses": self.deadline_misses,
                "fault_retries": self.fault_retries,
                "engine_failures": self.engine_failures,
                "failed": self.failed,
                "p50_ms": pct(50), "p99_ms": pct(99),
                # live rolling-window percentiles: bounded-memory
                # log-bucket histograms, error documented in the field
                "window": self.win.snapshot(self.clock()),
                # live SLO burn: multi-window error-budget burn
                # over this plane's outcomes — the stats-line surface of
                # the health sentinel (zeros while telemetry is off)
                "health": self.health.snapshot(self.clock())}


class _BurstReader:
    """Burst reads: one blocking line, then every line already available.

    Real files are read with ``os.read`` on the raw fd plus our own line
    splitting, NOT text-layer ``readline`` — a TextIOWrapper buffers
    whole chunks internally, so lines it has already pulled off the pipe
    don't make the fd selectable and a select()-gated readline loop
    would push them into the NEXT burst, under-batching the real queue
    depth.  The byte buffer lives on the reader so a partial trailing
    line carries over to the next burst.  In-memory streams (no fileno)
    fall back to greedy readline, which never blocks.  Empty list = EOF.
    """

    def __init__(self, stdin: IO):
        self.stdin = stdin
        try:
            self.fd = stdin.fileno()
        except (OSError, ValueError, AttributeError):
            self.fd = None
        self._buf = b""

    def read_burst(self) -> list[str]:
        if self.fd is None:
            lines = []
            while True:  # StringIO etc.: reads never block, drain to EOF
                nxt = self.stdin.readline()
                if not nxt:
                    break
                lines.append(nxt)
            return [ln for ln in lines if ln.strip()]
        import os
        import select

        lines: list[str] = []
        while True:
            nl = self._buf.find(b"\n")
            if nl >= 0:
                lines.append(self._buf[:nl + 1].decode("utf-8", "replace"))
                self._buf = self._buf[nl + 1:]
                continue
            if lines:  # burst started: only take bytes already available
                ready, _, _ = select.select([self.fd], [], [], 0)
                if not ready:
                    break
            chunk = os.read(self.fd, 65536)  # blocks only for line one
            if not chunk:
                if self._buf:  # EOF terminates a final unterminated line
                    lines.append(self._buf.decode("utf-8", "replace"))
                    self._buf = b""
                break
            self._buf += chunk
        return [ln for ln in lines if ln.strip()]


def main(argv=None) -> int:
    import argparse

    from harp_tpu_torch.serve.engines import ENGINES

    p = argparse.ArgumentParser(
        prog="python -m harp_tpu_torch serve",
        description="resident-model inference server (JSONL over stdio, "
                    "or TCP with --tcp)")
    p.add_argument("app", choices=sorted(ENGINES))
    p.add_argument("--ckpt", default=None,
                   help="checkpoint root (CheckpointManager layout); "
                        "the newest step is restored")
    p.add_argument("--cache-dir", default=None,
                   help="graph-cache directory (default: "
                        "<ckpt>/.graph_cache; omit both for no records)")
    p.add_argument("--ladder", default=None,
                   help="comma-separated batch rungs (default 1,8,64,512)")
    p.add_argument("--topk", type=int, default=10,
                   help="mfsgd: recommendations per user")
    p.add_argument("--em-iters", type=int, default=16,
                   help="lda: fold-in EM iterations")
    p.add_argument("--bench", action="store_true",
                   help="measure qps and latency percentiles on synthetic "
                        "state and requests; print ONE provenance-stamped "
                        'kind:"serve" JSON row instead of serving stdio')
    p.add_argument("--sustained", action="store_true",
                   help="--bench variant: the sustained-load A/B of the "
                        "burst and continuous planes on one seeded "
                        "arrival trace")
    p.add_argument("--requests", type=int, default=256,
                   help="--bench: number of synthetic requests")
    p.add_argument("--rows-per-request", type=int, default=1)
    p.add_argument("--offered-qps", type=float, default=None,
                   help="--sustained: arrival rate; default calibrates "
                        "burst capacity and offers 2x it")
    p.add_argument("--burst-admit", type=int, default=64,
                   help="--sustained: burst-plane admission quantum")
    p.add_argument("--tcp", type=int, default=None, metavar="PORT",
                   help="serve the JSONL protocol over asyncio TCP on "
                        "this port with the continuous plane (stdio stays "
                        "burst-drained); port 0 picks a free one")
    p.add_argument("--host", default="127.0.0.1",
                   help="--tcp bind address")
    p.add_argument("--max-queue-delay-ms", type=float, default=5.0,
                   help="continuous plane: flush deadline — a queued row "
                        "never waits longer for a fuller rung")
    p.add_argument("--rung-policy", choices=["adaptive", "greedy"],
                   default="adaptive",
                   help="continuous plane: adaptive holds work while in "
                        "flight to fill larger rungs; greedy dispatches "
                        "at once at the minimal rung")
    p.add_argument("--deadline-ms", type=float, default=None,
                   help="continuous plane: per-request deadline — a "
                        "request still queued past it is shed with a "
                        "structured error; a late completion is served "
                        "but counted")
    p.add_argument("--max-queue-rows", type=int, default=None,
                   help="continuous plane: admission bound — a request "
                        "that would push the queue past this many rows "
                        "is shed at submit (reason: queue_full)")
    p.add_argument("--max-retries", type=int, default=2,
                   help="continuous plane: retry-with-restage attempts "
                        "for a transient dispatch failure before the "
                        "batch's requests get error responses")
    p.add_argument("--fault-rate", type=float, default=0.0,
                   help="--sustained: seeded chaos — probability that "
                        "any dispatch fails transiently (the injector "
                        "rides flightrec.observe_dispatches)")
    p.add_argument("--device", default=None,
                   help="run on this device (default: this worker's "
                        "card; 'cpu' asks for the CPU)")
    args = p.parse_args(argv)
    ladder = (tuple(int(r) for r in args.ladder.split(","))
              if args.ladder else DEFAULT_LADDER)

    if args.bench or args.sustained:
        from harp_tpu_torch.parallel.mesh import resolve_mesh
        from harp_tpu_torch.serve.bench import benchmark, benchmark_sustained
        from harp_tpu_torch.utils.metrics import benchmark_json

        mesh = resolve_mesh(None, args.device)
        if args.sustained:
            res = benchmark_sustained(
                app=args.app, n_requests=args.requests,
                rows_per_request=args.rows_per_request, ladder=ladder,
                offered_qps=args.offered_qps,
                burst_admit=args.burst_admit,
                max_queue_delay_ms=args.max_queue_delay_ms,
                rung_policy=args.rung_policy,
                deadline_ms=args.deadline_ms,
                max_queue_rows=args.max_queue_rows,
                max_retries=args.max_retries,
                fault_rate=args.fault_rate, mesh=mesh)
            config = f"serve_{args.app}_sustained"
        else:
            res = benchmark(app=args.app, n_requests=args.requests,
                            rows_per_request=args.rows_per_request,
                            ladder=ladder, mesh=mesh)
            config = f"serve_{args.app}"
        print(benchmark_json(config, res, mesh.device))
        # with telemetry on, the run report (request trace, flight
        # recorder, health findings) on stderr and its JSON line on stdout
        from harp_tpu_torch import report

        report.maybe_emit(config)
        return 0

    if args.ckpt is None:
        p.error("--ckpt is required (or use --bench)")
    engine_opts = {}
    if args.app == "mfsgd":
        engine_opts["topk"] = args.topk
    if args.app == "lda":
        engine_opts["em_iters"] = args.em_iters
    cache_dir = args.cache_dir
    if cache_dir is None:
        import os

        cache_dir = os.path.join(args.ckpt, ".graph_cache")
    srv = Server(args.app, ckpt=args.ckpt, ladder=ladder,
                 cache_dir=cache_dir, budget_action="warn",
                 engine_opts=engine_opts, device=args.device)
    info = srv.startup()
    print(json.dumps({"kind": "serve_ready", "app": args.app,
                      "step": srv.ckpt_step, **info}),
          file=sys.stderr, flush=True)
    if args.tcp is not None:
        from harp_tpu_torch.serve.transport import serve_forever

        serve_forever(srv, args.host, args.tcp,
                      max_queue_delay_s=args.max_queue_delay_ms / 1e3,
                      rung_policy=args.rung_policy,
                      deadline_s=(args.deadline_ms / 1e3
                                  if args.deadline_ms else None),
                      max_queue_rows=args.max_queue_rows,
                      max_retries=args.max_retries)
        return 0
    srv.serve_stdio(sys.stdin, sys.stdout)
    return 0


if __name__ == "__main__":
    sys.exit(main())
