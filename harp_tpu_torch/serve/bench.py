"""Serving benchmark: qps and latency percentiles as ``kind:"serve"`` rows
— the port of ``harp_tpu.serve.bench``.

Self-contained (synthetic state and requests, or a checkpoint's state),
so ``python -m harp_tpu_torch serve <app> --bench`` runs without a
checkpoint on disk.  The row's ``steady_compiles`` is the CompileWatch
delta over the timed region (kernel builds and graph captures: 0 in a
healthy steady state), beside its dispatches and readbacks (one each a
batch).

Latency accounting: requests are issued in bursts (the micro-batcher
sees a real queue, not one request at a time); a request's latency is
the time from its burst's submission to the completion of the batch that
produced its last row — queueing plus service, what a client observes.

:func:`benchmark_sustained` is the continuous-batching A/B: one seeded
arrival trace replayed through both request planes — the burst-drain
plane (admission quantum ``burst_admit``) and the continuous plane
(admit-while-in-flight, :class:`~harp_tpu_torch.serve.server.
ContinuousRunner`).  Latency there is each request's arrival to its
response, throughput is offered against achieved qps (offered from the
trace, so ``achieved <= offered``), and queue depth percentiles are
sampled every scheduler window.  Service times are measured live;
arrivals ride a virtual timeline (``now`` advances by each window's
measured wall time or jumps to the next arrival when idle), so the
replay is deterministic up to service-time noise and never sleeps.
"""

from __future__ import annotations

import itertools
import tempfile
import time

import numpy as np

from harp_tpu_torch import health as health_mod
from harp_tpu_torch.serve.batcher import DEFAULT_LADDER
from harp_tpu_torch.serve.engines import ENGINES
from harp_tpu_torch.serve.server import Server
from harp_tpu_torch.utils import flightrec, memrec, telemetry
from harp_tpu_torch.utils.fault import FaultInjector


def benchmark(app: str = "kmeans", n_requests: int = 256,
              rows_per_request: int = 1,
              burst: int | tuple[int, ...] = 64,
              ladder=DEFAULT_LADDER, mesh=None, seed: int = 0,
              state_shape: dict | None = None, topk: int = 10,
              cache_dir: str | None = None, device=None,
              ckpt: str | None = None, min_seconds: float = 0.0) -> dict:
    """Serve ``n_requests`` synthetic requests; return the bench row.

    ``burst`` is the requests a burst, or a tuple of burst sizes taken
    in turn (so that the bursts land on several rungs).  With
    ``min_seconds`` the timed window goes on through the same requests
    again, in order, until it has lasted that long; the row's
    ``n_requests`` is then the count served in it.  ``state_shape``
    forwards to the engine's ``synthetic_state`` (e.g.
    ``{"n_users": 138_493, "n_items": 26_744, "rank": 64}`` for the
    ML-20M-shaped mfsgd config); ``ckpt`` serves a checkpoint's state
    instead.  ``cache_dir=None`` uses a fresh temp dir, so every startup
    is a cold one.  Runs on ``mesh``, else ``device``, else this
    worker's card.
    """
    from harp_tpu_torch.parallel.mesh import resolve_mesh

    if app not in ENGINES:
        raise ValueError(f"unknown serve app {app!r}")
    mesh = resolve_mesh(mesh, device)
    rng = np.random.default_rng(seed)
    state = (None if ckpt is not None
             else ENGINES[app].synthetic_state(rng, **(state_shape or {})))
    engine_opts = {"topk": topk} if app == "mfsgd" else {}

    tmp = None
    if cache_dir is None:
        tmp = tempfile.TemporaryDirectory(prefix="harp_serve_aot_")
        cache_dir = tmp.name
    try:
        srv = Server(app, state=state, ckpt=ckpt, mesh=mesh, ladder=ladder,
                     cache_dir=cache_dir, budget_action="warn",
                     engine_opts=engine_opts)
        # telemetry on (without resetting ambient collectors, whose
        # deltas must stay monotone) so CompileWatch backs the
        # steady_compiles claim
        with telemetry.scope(True, reset=False):
            t0 = time.perf_counter()
            info = srv.startup()
            startup_s = time.perf_counter() - t0
            # the captured rungs' footprints (memrec); 0 on the CPU,
            # where nothing is captured
            exec_hbm = memrec.ledger.exec_total()

            reqs = [srv.engine.synthetic_request(rng, rows_per_request)
                    for _ in range(n_requests)]
            # first dispatch of every executable off-clock
            for rung in srv.ladder.rungs:
                srv.process([_rows_request(srv, rng, rung)])

            srv.steady.reset()
            base = flightrec.snapshot()
            latencies_ms: list[float] = []
            sizes = itertools.cycle(
                (burst,) if isinstance(burst, int) else burst)
            served, wall = 0, 0.0
            t0 = time.perf_counter()
            while served < n_requests or wall < min_seconds:
                size = next(sizes)
                if served < n_requests:
                    size = min(size, n_requests - served)
                chunk = [reqs[(served + j) % n_requests]
                         for j in range(size)]
                responses = srv.process(chunk)
                bad = [r for r in responses if r and "error" in r]
                if bad:
                    raise RuntimeError(f"serve bench request failed: "
                                       f"{bad[0]['error']}")
                latencies_ms.extend(_request_latencies_ms(srv, chunk))
                served += size
                wall = time.perf_counter() - t0
            steady = flightrec.delta_since(base)
        p50, p95, p99 = np.percentile(latencies_ms, [50, 95, 99])
        return {
            "kind": "serve", "app": app,
            "qps": served / wall,
            "rows_per_sec": served * rows_per_request / wall,
            "p50_ms": round(float(p50), 4),
            "p95_ms": round(float(p95), 4),
            "p99_ms": round(float(p99), 4),
            "steady_compiles": steady["compiles"],
            "steady_dispatches": steady["dispatches"],
            "steady_readbacks": steady["readbacks"],
            "budget_violations": srv.steady.violations,
            "batches": srv.steady.batches,
            "padding_frac": round(srv.batcher.padding_frac(), 6),
            "startup_sec": round(startup_s, 4),
            "startup_compiles": info["compiles"],
            "startup_captures": info["captures"],
            "cache_hits": info["cache_hits"],
            "cache_misses": info["cache_misses"],
            "exec_hbm_bytes": exec_hbm,
            "n_requests": served,
            "window_s": round(wall, 4),
            "rows_per_request": rows_per_request,
            "burst": burst if isinstance(burst, int) else list(burst),
            "ladder": list(srv.ladder.rungs),
            "num_workers": mesh.num_workers,
        }
    finally:
        if tmp is not None:
            tmp.cleanup()


def _pctls(xs, ps=(50, 95, 99)) -> tuple[float, ...]:
    if not len(xs):
        return tuple(0.0 for _ in ps)
    return tuple(round(float(v), 4) for v in np.percentile(list(xs), ps))


def _rank_pctls(xs, ps=(50, 95, 99)) -> tuple[float, ...]:
    """Ceil-rank (inverse-CDF) percentiles — the SAME rank convention
    :class:`~harp_tpu_torch.utils.reqtrace.LogHist` uses, so the win_* vs
    exact comparison is bucketization error alone, no interpolation
    slack."""
    import math

    if not len(xs):
        return tuple(0.0 for _ in ps)
    arr = sorted(float(v) for v in xs)
    return tuple(round(arr[max(1, math.ceil(p / 100 * len(arr))) - 1], 4)
                 for p in ps)


def _burst_replay(srv: Server, reqs: list[dict], arrivals: np.ndarray,
                  burst_admit: int) -> dict:
    """The burst plane on the trace: admit up to ``burst_admit`` arrived
    requests, ``process()`` the burst to completion (no admission while
    its batches are in flight), repeat.  Completion time for every
    request in a burst is the burst's end — exactly when serve_stdio
    writes the responses."""
    n = len(reqs)
    now, i = 0.0, 0
    lat_ms: list[float] = []
    qdepth: list[int] = []
    pad0 = (srv.batcher.real_rows, srv.batcher.padded_rows)
    while i < n:
        if arrivals[i] > now:
            now = float(arrivals[i])
        arrived = int(np.searchsorted(arrivals, now, side="right"))
        take = min(arrived - i, burst_admit)
        qdepth.append(arrived - i - take)  # backlog the window left out
        t0 = time.perf_counter()
        responses = srv.process(reqs[i:i + take])
        now += time.perf_counter() - t0
        bad = [r for r in responses if r and "error" in r]
        if bad:
            raise RuntimeError(f"burst replay request failed: "
                               f"{bad[0]['error']}")
        lat_ms.extend((now - arrivals[j]) * 1e3
                      for j in range(i, i + take))
        i += take
    p50, p95, p99 = _pctls(lat_ms)
    q50, q95, q99 = _pctls(qdepth)
    real = srv.batcher.real_rows - pad0[0]
    padded = srv.batcher.padded_rows - pad0[1]
    return {"qps": n / now, "p50_ms": p50, "p95_ms": p95, "p99_ms": p99,
            "qdepth_p50": q50, "qdepth_p95": q95, "qdepth_p99": q99,
            "padding_frac": round(padded / max(1, real + padded), 6),
            "span_s": now}


def _continuous_replay(srv: Server, runner, reqs: list[dict],
                       arrivals: np.ndarray) -> dict:
    """The continuous plane on the same trace: every request is admitted
    the moment it has arrived — including while batches are in flight —
    and the runner's window pipeline does the rest.

    Degraded-mode accounting: a response is either a *serve*
    (``result``), a structured *shed* (``shed: true`` — queue bound or
    deadline), or — only when the runner exhausted its dispatch retries
    — a hard failure.  Anything else raises: even under chaos, EVERY
    admitted request must come back as exactly one of the three, and
    ``served + shed + failed == offered`` holds on the row.
    """
    n = len(reqs)
    now, i = 0.0, 0
    answered = served = shed = failed = 0
    lat_ms: list[float] = []
    qdepth: list[int] = []

    def account(pairs):
        nonlocal answered, served, shed, failed
        for key, resp in pairs:
            answered += 1
            if "result" in resp:
                served += 1
                lat_ms.append((now - arrivals[key]) * 1e3)
            elif resp.get("shed"):
                shed += 1
            elif "error" in resp and "engine failure" in resp["error"]:
                failed += 1
            else:
                raise RuntimeError(f"continuous replay request failed: "
                                   f"{resp.get('error')}")

    while answered < n:
        while i < n and arrivals[i] <= now:
            account(runner.submit(i, reqs[i], now=float(arrivals[i])))
            i += 1
        if not len(runner.sched) and not runner._in_flight and i < n:
            now = float(arrivals[i])  # idle: jump to the next arrival
            continue
        qdepth.append(i - answered)  # arrived-but-unanswered occupancy
        t0 = time.perf_counter()
        out = runner.step(now)
        now += time.perf_counter() - t0
        account(out)
    p50, p95, p99 = _pctls(lat_ms)
    q50, q95, q99 = _pctls(qdepth)
    return {"qps": served / now if now > 0 else 0.0,
            "p50_ms": p50, "p95_ms": p95, "p99_ms": p99,
            "qdepth_p50": q50, "qdepth_p95": q95, "qdepth_p99": q99,
            "padding_frac": round(runner.sched.padding_frac(), 6),
            "served": served, "shed": shed, "failed": failed,
            # the streaming percentiles at the end of the replay:
            # bounded-memory log-bucket histograms fed at the runner's
            # completion clock.  Their exact-sample accuracy reference
            # is runner.latencies_ms (the SAME events, same clock) —
            # p50/p95/p99 above additionally include the completing
            # window's host wall (the client-observed basis), so only
            # the runner-basis pair is a pure bucket-error comparison
            # (win_rel_err is that documented bound).
            "window": runner.win.snapshot(now),
            "runner_pctls_ms": _rank_pctls(runner.latencies_ms),
            "span_s": now}


def benchmark_sustained(app: str = "kmeans", n_requests: int = 512,
                        rows_per_request: int = 1,
                        offered_qps: float | None = None,
                        offered_factor: float = 2.0,
                        burst_admit: int = 64,
                        max_queue_delay_ms: float = 5.0,
                        rung_policy: str = "adaptive",
                        ladder=DEFAULT_LADDER, mesh=None, seed: int = 0,
                        state_shape: dict | None = None, topk: int = 10,
                        cache_dir: str | None = None,
                        deadline_ms: float | None = None,
                        max_queue_rows: int | None = None,
                        max_retries: int = 3,
                        fault_rate: float = 0.0,
                        fault_ordinals: tuple[int, ...] | None = None,
                        fault_seed: int = 0, device=None) -> dict:
    """Sustained-load burst-vs-continuous A/B on one seeded trace.

    ``offered_qps=None`` calibrates: a short closed-loop burst run
    measures the burst plane's capacity and the trace offers
    ``offered_factor``× it, so both planes run saturated (the regime
    where admission policy, not arrival luck, decides throughput).  The
    returned row is the continuous plane's evidence (``qps`` == its
    achieved qps), with
    the burst plane's numbers alongside as ``burst_*`` and the headline
    ``qps_ratio_vs_burst``.

    Degraded mode: ``deadline_ms`` / ``max_queue_rows`` turn on
    the continuous plane's shedding, and ``fault_rate`` arms a seeded
    :class:`~harp_tpu_torch.utils.fault.FaultInjector` on the dispatch site
    for the continuous replay — so "the server degrades instead of
    dying" is a measured number: the row's ``shed_frac`` /
    ``deadline_miss_frac`` / ``fault_retries`` fields, with the
    ``served + shed + failed == offered`` identity and the usual
    ``steady_compiles == 0``.  Faults are injected on the continuous plane
    only (the burst arm stays the clean incumbent); ``fault_ordinals``
    pins EXACT 1-based dispatch events instead of a probability (the
    deterministic chaos the health acceptance test drives).

    Health sentinel: the continuous replay runs with the SLO
    burn detector live on the runner AND a warn-mode "one staging per
    batch window" budget (``steady.h2d_calls=1`` — a retry-with-restage
    legitimately stages twice, and that drift lands in a budget_drift
    health row instead of a scrolled RuntimeWarning).  The row's
    ``health_*`` fields summarize the run's findings; a fault-free,
    unshed run reports zero.
    """
    from harp_tpu_torch.parallel.mesh import resolve_mesh

    if app not in ENGINES:
        raise ValueError(f"unknown serve app {app!r}")
    mesh = resolve_mesh(mesh, device)
    rng = np.random.default_rng(seed)
    state = ENGINES[app].synthetic_state(rng, **(state_shape or {}))
    engine_opts = {"topk": topk} if app == "mfsgd" else {}

    tmp = None
    if cache_dir is None:
        tmp = tempfile.TemporaryDirectory(prefix="harp_serve_aot_")
        cache_dir = tmp.name
    try:
        srv = Server(app, state=state, mesh=mesh, ladder=ladder,
                     cache_dir=cache_dir, budget_action="warn",
                     engine_opts=engine_opts)
        with telemetry.scope(True, reset=False):
            t0 = time.perf_counter()
            info = srv.startup()
            startup_s = time.perf_counter() - t0
            exec_hbm = memrec.ledger.exec_total()

            # warm EVERY rung off-clock (first dispatch of an executable
            # can transfer constants)
            for rung in srv.ladder.rungs:
                srv.process([_rows_request(srv, rng, rung)])

            reqs = [srv.engine.synthetic_request(rng, rows_per_request)
                    for _ in range(n_requests)]
            nominal = offered_qps
            calibrated = None
            if nominal is None:
                cal = [srv.engine.synthetic_request(rng, rows_per_request)
                       for _ in range(min(4 * burst_admit, n_requests))]
                t0 = time.perf_counter()
                for lo in range(0, len(cal), burst_admit):
                    srv.process(cal[lo:lo + burst_admit])
                calibrated = len(cal) / (time.perf_counter() - t0)
                nominal = offered_factor * calibrated
            gaps = rng.exponential(1.0 / nominal, size=n_requests)
            arrivals = np.cumsum(gaps)
            arrivals -= arrivals[0]

            burst = _burst_replay(srv, reqs, arrivals, burst_admit)

            runner = srv.make_runner(
                max_queue_delay_s=max_queue_delay_ms / 1e3,
                rung_policy=rung_policy,
                deadline_s=(deadline_ms / 1e3 if deadline_ms else None),
                max_queue_rows=max_queue_rows, max_retries=max_retries,
                # window sized past any replay so the win_* fields and
                # the exact percentiles describe the SAME sample set —
                # the bucket-error comparison is apples-to-apples (live
                # servers keep the 60 s rolling default)
                stats_window_s=3600.0)
            fault_spec = (fault_ordinals if fault_ordinals
                          else fault_rate if fault_rate else None)
            injector = FaultInjector(
                seed=fault_seed,
                fail={"dispatch": fault_spec}
                if fault_spec is not None else None)
            srv.steady.reset()
            # the staging discipline as a warn-mode budget: one counted
            # put_input per batch window.  A retry-with-restage breaks
            # it by design (a fresh staging per attempt) — the point
            # is that the drift becomes a budget_drift health row, i.e.
            # evidence that this run restaged under faults.
            srv.steady.limits["h2d_calls"] = 1
            hmark = health_mod.monitor.mark()
            base = flightrec.snapshot()
            with injector.arm():
                cont = _continuous_replay(srv, runner, reqs, arrivals)
            steady = flightrec.delta_since(base)
            runner.verify_exact()  # exact accounting even under faults:
            # injected faults fire BEFORE the dispatch counts, so the
            # totals stay one dispatch + one readback per clean batch
        offered_emp = (n_requests / float(arrivals[-1])
                       if arrivals[-1] > 0 else float(nominal))
        return {
            "kind": "serve", "app": app, "mode": "sustained",
            "rung_policy": rung_policy,
            "offered_qps": round(min(offered_emp, 1e12), 4),
            "offered_qps_nominal": round(float(nominal), 4),
            "calibrated_burst_qps": (round(calibrated, 4)
                                     if calibrated else None),
            "achieved_qps": round(cont["qps"], 4),
            "qps": round(cont["qps"], 4),
            "p50_ms": cont["p50_ms"], "p95_ms": cont["p95_ms"],
            "p99_ms": cont["p99_ms"],
            "qdepth_p50": cont["qdepth_p50"],
            "qdepth_p95": cont["qdepth_p95"],
            "qdepth_p99": cont["qdepth_p99"],
            # rolling-window (streaming-histogram) twins of the exact
            # percentiles above — what a LIVE server reports through the
            # TCP stats line; agreement is bounded by win_rel_err
            # (reqtrace.QUANTILE_REL_ERR, the log-bucket width)
            "win_p50_ms": cont["window"]["p50_ms"],
            "win_p95_ms": cont["window"]["p95_ms"],
            "win_p99_ms": cont["window"]["p99_ms"],
            "win_qdepth_p99": cont["window"]["qdepth_p99"],
            "win_samples": cont["window"]["samples"],
            "win_rel_err": cont["window"]["rel_err"],
            # exact ceil-rank percentiles over the SAME samples/clock
            # the streaming histogram ingested — |win_pXX - runner_pXX|
            # <= win_rel_err * runner_pXX is the agreement contract
            "runner_p50_ms": cont["runner_pctls_ms"][0],
            "runner_p95_ms": cont["runner_pctls_ms"][1],
            "runner_p99_ms": cont["runner_pctls_ms"][2],
            "padding_frac": cont["padding_frac"],
            "burst_qps": round(burst["qps"], 4),
            "burst_p50_ms": burst["p50_ms"],
            "burst_p99_ms": burst["p99_ms"],
            "burst_qdepth_p99": burst["qdepth_p99"],
            "burst_padding_frac": burst["padding_frac"],
            "burst_admit": burst_admit,
            "qps_ratio_vs_burst": round(cont["qps"] / burst["qps"], 4),
            # degraded-mode evidence: every offered request
            # was served, shed, or hard-failed — nothing vanished
            "offered_requests": n_requests,
            "served_requests": cont["served"],
            "shed_requests": cont["shed"],
            "failed_requests": cont["failed"],
            "shed_frac": round(cont["shed"] / n_requests, 6),
            "deadline_miss_frac": round(
                runner.deadline_misses / n_requests, 6),
            "fault_retries": runner.fault_retries,
            "engine_failures": runner.engine_failures,
            "faults_injected": injector.injected["dispatch"],
            # health sentinel evidence: findings new to this replay (the
            # monitor is monotone like the flight counters), the SLO
            # burn peaks, and the staging-discipline violations — all
            # zero on a clean run
            "health_findings": len(health_mod.monitor.since(hmark)),
            "health_worst_severity": health_mod.summarize_rows(
                health_mod.monitor.since(hmark))["worst_severity"],
            "health_fast_burn": round(runner.health.peak_fast, 3),
            "health_slow_burn": round(runner.health.peak_slow, 3),
            "health_breaches": runner.health.breaches,
            "health_budget_drift": srv.steady.violations,
            "deadline_ms": deadline_ms,
            "max_queue_rows": max_queue_rows,
            "fault_rate": fault_rate,
            "steady_compiles": steady["compiles"],
            "steady_dispatches": steady["dispatches"],
            "steady_readbacks": steady["readbacks"],
            "budget_violations": srv.steady.violations,
            "batches": runner.dispatched,
            "max_queue_delay_ms": max_queue_delay_ms,
            "startup_sec": round(startup_s, 4),
            "startup_compiles": info["compiles"],
            "startup_captures": info["captures"],
            "cache_hits": info["cache_hits"],
            "cache_misses": info["cache_misses"],
            "exec_hbm_bytes": exec_hbm,
            "n_requests": n_requests,
            "rows_per_request": rows_per_request,
            "ladder": list(srv.ladder.rungs),
            "num_workers": mesh.num_workers,
        }
    finally:
        if tmp is not None:
            tmp.cleanup()


def _rows_request(srv: Server, rng: np.random.Generator,
                  n_rows: int) -> dict:
    return srv.engine.synthetic_request(rng, n_rows)


def _request_latencies_ms(srv: Server, chunk: list[dict]) -> list[float]:
    """Per-request latency for one processed burst: completion time of
    the LAST batch that carried any of the request's rows."""
    if not srv.last_batch_times:
        return [0.0] * len(chunk)
    # rows are batched in arrival order; walk batches assigning requests
    done_at: list[float] = []
    rows_left = []
    for req in chunk:
        key = srv.engine.REQUEST_KEY
        val = req.get(key, req.get("x", []))
        rows_left.append(max(1, len(val)))
    it = iter(srv.last_batch_times)
    _, avail, t_done = next(it)
    for n in rows_left:
        while n > 0:
            take = min(n, avail)
            n -= take
            avail -= take
            if n > 0 and avail == 0:
                _, avail, t_done = next(it)
        done_at.append(t_done)
        if avail == 0:
            nxt = next(it, None)
            if nxt is None:
                # trailing requests (shouldn't happen) share the last time
                avail = 1 << 30
            else:
                _, avail, t_done = nxt
    return [t * 1e3 for t in done_at]
