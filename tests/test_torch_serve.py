"""The port's serving plane (``harp_tpu_torch/serve/``) against harp_tpu's.

- The batcher, the scheduler and the synthetic states and requests are
  the reference's host logic: the same inputs give the same batches.
- The six engines' raw step outputs on the same state and rows:
  KMeans assignments equal; MF-SGD top-k ids equal and scores within rtol
  1e-5 on 1 and 4 workers (250 items pad to 252 on four); LDA θ within
  rtol 1e-4 / atol 1e-6; MLP logits within rtol 1e-5 and classes equal;
  RF classes equal; SVM scores within rtol 1e-5 and labels equal.
- ``Server.process`` and ``ContinuousRunner`` on one injected-clock
  arrival sequence, with sheds, deadlines and dispatch faults: the same
  batches, responses, shed/deadline/retry/failure counts, request-trace
  batch records and ``SteadyState`` summary as the reference's.
- A rung's buffer sets under a stand-in capture that owns fixed buffers
  (``torch_world.FakeCapture``), the graph cache's warm restart, a server
  answering from a checkpoint the port's trainers wrote, the stdio and
  TCP planes, the bench rows and the CLI.
"""

import io
import json
import socket
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from harp_tpu.parallel.mesh import WorkerMesh as JaxMesh
from harp_tpu.serve import batcher as JB
from harp_tpu.serve import engines as JE
from harp_tpu.serve import server as JS
from harp_tpu.utils import fault as JF
from harp_tpu.utils import reqtrace as JR
from harp_tpu.utils import telemetry as JT
from harp_tpu_torch.parallel.mesh import WorkerMesh
from harp_tpu_torch.serve import batcher as PB
from harp_tpu_torch.serve import engines as PE
from harp_tpu_torch.serve import server as PS
from harp_tpu_torch.serve.bench import benchmark, benchmark_sustained
from harp_tpu_torch.serve.cache import GraphCache, RungExecutable
from harp_tpu_torch.utils import fault as PF
from harp_tpu_torch.utils import flightrec as PFR
from harp_tpu_torch.utils import reqtrace as PR
from harp_tpu_torch.utils import telemetry as PT
from torch_world import (SERVE_MF, SERVE_TOPK, WORLD, FakeCapture,
                         run_serve_cases, run_world, serve_mf_inputs,
                         serve_mf_requests, time_limit)


@pytest.fixture(autouse=True)
def _limit():
    with time_limit(60):
        yield


@pytest.fixture(scope="module")
def jmesh1():
    return JaxMesh(jax.devices()[:1])


@pytest.fixture(scope="module")
def cpu():
    return WorkerMesh("cpu")


# ---------------------------------------------------------------------------
# host logic: the same inputs give the same batches
# ---------------------------------------------------------------------------

def _batches(bs):
    return [(b.rung, b.rows, [tuple(r) for r in b.requests], b.seq)
            for b in bs]


@pytest.mark.parametrize("sizes,ladder", [
    ((9, 9, 9, 9, 9), (1, 8, 32)), ((70,), (1, 8, 32)), ((1,), (1, 8, 64)),
    ((3, 600, 5, 64, 1), (1, 8, 64, 512))])
def test_micro_batcher_matches_the_reference(sizes, ladder):
    got = []
    for mod in (JB, PB):
        mb = mod.MicroBatcher(ladder)
        for i, n in enumerate(sizes):
            mb.put(i, n)
        got.append((_batches(mb.batches()), mb.padding_frac()))
    assert got[0] == got[1]
    lad = (JB.ShapeLadder(ladder), PB.ShapeLadder(ladder))
    for n in range(1, max(ladder) + 1):
        assert lad[0].bucket(n) == lad[1].bucket(n)
        assert lad[0].floor_rung(n) == lad[1].floor_rung(n)
    assert lad[0].split(1234) == lad[1].split(1234)


@pytest.mark.parametrize("policy", ["adaptive", "greedy"])
def test_continuous_scheduler_matches_the_reference(policy):
    rng = np.random.default_rng(7)
    arrivals = rng.exponential(0.002, size=60).cumsum()
    sizes = rng.integers(1, 90, size=60)
    trace = []
    for mod in (JB, PB):
        s = mod.ContinuousScheduler((1, 8, 64, 512), max_queue_delay_s=0.004,
                                    rung_policy=policy)
        log = []
        for i, (t, n) in enumerate(zip(arrivals, sizes)):
            s.put(i, int(n), float(t))
            idle = i % 3 == 0
            log.append((s.ready(float(t), idle), s.next_deadline()))
            if log[-1][0]:
                log.append(_batches([s.next_batch(float(t))]))
            if i % 10 == 9:
                log.append(sorted(s.expire(float(t), 0.003)))
        s.discard({55, 56})
        log.append((len(s), s.padding_frac(), s.oldest_wait(1.0)))
        trace.append(log)
    assert trace[0] == trace[1]


@pytest.mark.parametrize("app", sorted(JE.ENGINES))
def test_synthetic_states_and_requests_match_the_reference(app, jmesh1, cpu):
    sj = JE.ENGINES[app].synthetic_state(np.random.default_rng(1))
    sp = PE.ENGINES[app].synthetic_state(np.random.default_rng(1))
    assert json.dumps(_tree_lists(sj)) == json.dumps(_tree_lists(sp))
    ej, ep = JE.ENGINES[app](sj, jmesh1), PE.ENGINES[app](sp, cpu)
    rj = ej.synthetic_request(np.random.default_rng(2), 5)
    rp = ep.synthetic_request(np.random.default_rng(2), 5)
    assert rj == rp
    np.testing.assert_array_equal(ej.rows_from_request(rj),
                                  ep.rows_from_request(rp))


def _tree_lists(x):
    if isinstance(x, dict):
        return {k: _tree_lists(v) for k, v in sorted(x.items())}
    if isinstance(x, (list, tuple)):
        return [_tree_lists(v) for v in x]
    return np.asarray(x).tolist()


# ---------------------------------------------------------------------------
# engines: raw step outputs on the same state and rows
# ---------------------------------------------------------------------------

ENGINE_SHAPES = {"kmeans": {"k": 24, "d": 32},
                 "mfsgd": {"n_users": 96, "n_items": 250, "rank": 16},
                 "lda": {"vocab_size": 96, "n_topics": 8},
                 "mlp": {"sizes": (32, 48, 24, 6)},
                 "rf": {"n_trees": 6, "max_depth": 4, "n_features": 8,
                        "n_classes": 3},
                 "svm": {"d": 40}}


def _ref_out(eng, x):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        fn = jax.jit(eng._step_fn())
        return np.asarray(fn(*eng.state_args(), jnp.asarray(x)))


def _port_out(eng, x):
    return eng.step()(*eng.state_args(), torch.from_numpy(x)).numpy()


def _pair(app, jm, rung=64, opts=None, seed=11):
    rng = np.random.default_rng(seed)
    state = JE.ENGINES[app].synthetic_state(rng, **ENGINE_SHAPES[app])
    ej = JE.ENGINES[app](state, jm, **(opts or {}))
    ep = PE.ENGINES[app](state, WorkerMesh("cpu"), **(opts or {}))
    req = ej.synthetic_request(rng, rung - 3)
    x = ej.make_input(ej.rows_from_request(req), rung)
    return ej, ep, req, _ref_out(ej, x), _port_out(ep, x)


def test_kmeans_assignments_equal_the_reference(jmesh1):
    ej, ep, req, ref, got = _pair("kmeans", jmesh1)
    np.testing.assert_array_equal(got, ref)
    assert ep.output_rows(got, 61) == ej.output_rows(ref, 61)


def _check_topk(got, ref, kk):
    np.testing.assert_array_equal(got[:, :kk], ref[:, :kk])
    np.testing.assert_allclose(got[:, kk:], ref[:, kk:], rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("topk", [1, 10])
def test_mfsgd_topk_equals_the_reference_on_one_worker(jmesh1, topk):
    ej, ep, req, ref, got = _pair("mfsgd", jmesh1, opts={"topk": topk})
    _check_topk(got, ref, topk)
    assert ep.cache_tag() == ej.cache_tag()


def test_lda_theta_within_tolerance_of_the_reference(jmesh1):
    _, _, _, ref, got = _pair("lda", jmesh1)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-6)


def test_mlp_logits_and_classes_match_the_reference(jmesh1):
    ej, ep, _, ref, got = _pair("mlp", jmesh1)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(got.argmax(1), ref.argmax(1))


def test_rf_classes_equal_the_reference(jmesh1):
    ej, ep, req, ref, got = _pair("rf", jmesh1)
    np.testing.assert_array_equal(got, ref)
    assert ep.output_rows(got, 61) == ej.output_rows(ref, 61)


def test_svm_scores_and_labels_match_the_reference(jmesh1):
    _, _, _, ref, got = _pair("svm", jmesh1)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(got >= 0, ref >= 0)


def test_engine_errors_match_the_reference(jmesh1, cpu):
    state = JE.KMeansAssign.synthetic_state(np.random.default_rng(0))
    for bad in ({}, {"x": [[1.0, 2.0]]}):
        msgs = []
        for mod, m in ((JE, jmesh1), (PE, cpu)):
            with pytest.raises(ValueError) as e:
                mod.KMeansAssign(state, m).rows_from_request(bad)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]
    with pytest.raises(KeyError, match="missing"):
        PE.make_engine("svm", {"w": np.ones(3)}, cpu)
    with pytest.raises(ValueError, match="no serve engine"):
        PE.make_engine("nope", {}, cpu)


# ---------------------------------------------------------------------------
# MF-SGD top-k on four workers (spawned gloo world)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return run_world(run_serve_cases, tmp_path_factory.mktemp("serve"))


def test_mfsgd_topk_equals_the_reference_on_4_workers(world):
    d = serve_mf_inputs()
    jm = JaxMesh(jax.devices()[:WORLD])
    ej = JE.MFSGDTopK({"W": d["W"], "H": d["H"]}, jm, topk=SERVE_TOPK)
    assert ej.H_padded.shape[0] == 252 > SERVE_MF["n_items"]  # ragged
    ref = _ref_out(ej, d["users"])
    for r in world:
        _check_topk(r["step"], ref, SERVE_TOPK)
        assert int(r["step"][:, :SERVE_TOPK].max()) < SERVE_MF["n_items"]
    assert not any(r["_jax_imported"] for r in world)


def test_the_collective_stays_outside_the_capture_on_4_workers(world):
    """Under a capture the 4-worker top-k is two graphs a rung (before
    and after the gather) and answers as the eager server does."""
    for r in world:
        assert r["captures"] == 4
        assert r["labels"] == ["mfsgd[topk=10,n_items=250].b1.local",
                               "mfsgd[topk=10,n_items=250].b1.merge",
                               "mfsgd[topk=10,n_items=250].b8.local",
                               "mfsgd[topk=10,n_items=250].b8.merge"]
        for other in (r["graphed"], r["runner"]):
            _same_topk_responses(other, r["eager"])
        assert r["replays"] > 0
    _same_topk_responses(world[3]["eager"], world[0]["eager"])
    assert [x["id"] for x in world[0]["eager"]] == [
        q["id"] for q in serve_mf_requests()]


def _same_topk_responses(got, want):
    """Ids equal, scores within rtol 1e-5: a product's last bit may follow
    its buffers' alignment on the CPU."""
    assert [g["id"] for g in got] == [w["id"] for w in want]
    for g, w in zip(got, want):
        for gr, wr in zip(g["result"], w["result"]):
            assert gr["items"] == wr["items"]
            np.testing.assert_allclose(gr["scores"], wr["scores"],
                                       rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# Server.process and ContinuousRunner against the reference's
# ---------------------------------------------------------------------------

LADDER = (1, 8, 32)


def _kmeans_state():
    return JE.KMeansAssign.synthetic_state(np.random.default_rng(40), k=8,
                                           d=16)


def _burst_requests():
    rng = np.random.default_rng(41)
    reqs = [{"id": i, "x": rng.normal(size=(n, 16)).astype(
        np.float32).tolist()} for i, n in enumerate((1, 3, 40, 7, 0, 2))]
    reqs.insert(2, "not a request")
    reqs.insert(4, {"id": "bad", "x": [[1.0]]})
    return reqs


def _process_run(mod, mesh, **kw):
    srv = mod.Server("kmeans", _kmeans_state(), mesh=mesh, ladder=LADDER,
                     **kw)
    srv.startup()
    resp = srv.process(_burst_requests())
    return (resp, [(r, n) for r, n, _ in srv.last_batch_times],
            srv.batcher.padding_frac(), srv.requests_served,
            srv.rows_served)


def test_burst_process_matches_the_reference(jmesh1, cpu):
    assert _process_run(JS, jmesh1) == _process_run(PS, cpu)


#: (arrival time, rows) of the continuous sequence; the clock is injected
ARRIVALS = [(0.000, 3), (0.001, 5), (0.002, 30), (0.0021, 2), (0.004, 9),
            (0.020, 1), (0.021, 40), (0.030, 6), (0.100, 4), (0.101, 12),
            (0.1015, 1), (0.300, 7)]


def _continuous_run(tel, mod, fault_mod, mesh, **kw):
    rng = np.random.default_rng(42)
    reqs = [{"id": i, "x": rng.normal(size=(n, 16)).astype(
        np.float32).tolist()} for i, (_, n) in enumerate(ARRIVALS)]
    with tel.scope(True):
        srv = mod.Server("kmeans", _kmeans_state(), mesh=mesh, ladder=LADDER,
                         budget_action="warn", **kw)
        srv.startup()
        now = [0.0]
        runner = srv.make_runner(max_queue_delay_s=0.002, deadline_s=0.015,
                                 max_queue_rows=45, max_retries=1,
                                 clock=lambda: now[0])
        inj = fault_mod.FaultInjector(fail={"dispatch": (2, 3, 6)})
        out = []
        with inj.arm(), warnings.catch_warnings():
            warnings.simplefilter("ignore")
            for i, (t, _) in enumerate(ARRIVALS):
                now[0] = t
                out += runner.submit(i, reqs[i], now=t)
                if i % 3 == 2:  # the queue builds between windows
                    out += runner.step(t)
                    out += runner.step(t + 0.0005)
            now[0] = 0.5
            out += runner.drain(0.5)
        tracer = (JR if mod is JS else PR).tracer
        batches = [(b["seq"], b["rung"], b["rows"], b["members"],
                    [e["name"] for e in b["events"]])
                   for b in tracer._batches.values()]
        return {"responses": sorted(out, key=lambda kv: kv[0]),
                "counts": (runner.dispatched, runner.completed, runner.shed,
                           runner.deadline_misses, runner.fault_retries,
                           runner.engine_failures, runner.failed),
                "steady": srv.steady.summary(),
                "injected": inj.counters(),
                "trace": batches, "outcomes": dict(tracer.counts),
                "health": runner.health.snapshot(0.5)}


def test_continuous_runner_matches_the_reference(jmesh1, cpu):
    ref = _continuous_run(JT, JS, JF, jmesh1)
    got = _continuous_run(PT, PS, PF, cpu)
    assert got["counts"] == ref["counts"]
    assert got["responses"] == ref["responses"]
    assert got["steady"] == ref["steady"]
    assert got["injected"] == ref["injected"]
    assert got["trace"] == ref["trace"]
    assert got["outcomes"] == ref["outcomes"]
    assert got["health"] == ref["health"]
    dispatched, completed, shed, missed, retries, failures, failed = \
        got["counts"]
    assert shed > 0 and retries > 0 and failures == 1 and failed > 0
    assert completed + shed + failed == len(ARRIVALS)


def test_continuous_budget_is_exact_and_sabotage_is_caught(cpu):
    rng = np.random.default_rng(33)
    with PT.scope(True):
        srv = PS.Server("kmeans", _kmeans_state(), mesh=cpu, ladder=(1, 8))
        srv.startup()
        runner = srv.make_runner(clock=lambda: 0.0)
        for i in range(12):
            runner.submit(i, srv.engine.synthetic_request(rng, 3), now=0.0)
            runner.step(0.0)
        runner.drain(0.0)
        spent = runner.verify_exact()
        assert spent["dispatches"] == spent["readbacks"] == runner.dispatched
        assert spent["compiles"] == 0 and srv.steady.violations == 0
        real = srv._exec[1]

        def noisy(*args):
            PFR.transfers.record_dispatch("extra")
            return real(*args)

        srv._exec[1] = noisy
        r2 = srv.make_runner(clock=lambda: 0.0)
        r2.submit(0, srv.engine.synthetic_request(rng, 1), now=0.0)
        with pytest.raises(PFR.BudgetExceeded, match="dispatches"):
            r2.step(0.0)


# ---------------------------------------------------------------------------
# buffer sets under a capture, and the graph cache
# ---------------------------------------------------------------------------

def test_buffer_sets_keep_in_flight_answers_under_a_capture(cpu):
    """With a stand-in capture that owns fixed buffers (as a CUDA graph
    does), the depth-2 pipeline answers as the eager server: batch t's
    output survives batch t+1's replay until it is read back."""
    rng = np.random.default_rng(50)
    state = _kmeans_state()
    reqs = [{"id": i, "x": rng.normal(size=(n, 16)).astype(
        np.float32).tolist()} for i, n in enumerate((1, 5, 8, 3, 20, 1, 7))]
    answers = []
    for capture in (None, FakeCapture()):
        srv = PS.Server("kmeans", state, mesh=cpu, ladder=LADDER,
                        capture=capture)
        info = srv.startup()
        burst = srv.process(reqs)
        runner = srv.make_runner(clock=lambda: 0.0, rung_policy="greedy")
        got = []
        for i, r in enumerate(reqs):
            got += runner.submit(i, r, now=0.0)
            got += runner.step(0.0)   # dispatch; the next one goes first
        got += runner.drain(0.0)
        answers.append((burst, sorted(got, key=lambda kv: kv[0])))
        if capture is not None:
            assert info["captures"] == len(LADDER)
            assert capture.labels == [f"kmeans.b{r}" for r in LADDER]
            assert capture.replays == len(srv.last_batch_times) \
                + runner.dispatched
    assert answers[0] == answers[1]


def test_a_rung_refuses_to_overwrite_a_batch_in_flight(cpu):
    eng = PE.KMeansAssign(_kmeans_state(), cpu)
    exe = RungExecutable(eng, 8, 2, FakeCapture())
    x = np.zeros((8, 16), np.float32)
    st = eng.state_args()
    outs = [exe(*st, exe.stage(x)), exe(*st, exe.stage(x + 1))]
    assert outs[0] is not outs[1] and exe.in_flight() == 2
    with pytest.raises(RuntimeError, match="not yet read back"):
        exe.stage(x)
    exe.release(outs[0])
    tok = exe.stage(x)
    with pytest.raises(RuntimeError, match="in flight"):
        exe(*st, type(tok)(1, tok.nbytes))
    exe(*st, tok)
    with pytest.raises(RuntimeError, match="no buffer set"):
        exe.release(torch.zeros(8))


def test_warm_restart_hits_once_a_rung_and_captures_once_a_rung(cpu,
                                                                 tmp_path):
    state = _kmeans_state()
    infos = []
    for _ in range(2):
        fake = FakeCapture()
        srv = PS.Server("kmeans", state, mesh=cpu, ladder=LADDER,
                        cache_dir=str(tmp_path / "c"), capture=fake)
        with PT.scope(True):
            info = srv.startup()
        infos.append(info)
        assert fake.labels == [f"kmeans.b{r}" for r in LADDER]
    assert (infos[0]["cache_misses"], infos[0]["cache_hits"]) == (3, 0)
    assert (infos[1]["cache_misses"], infos[1]["cache_hits"]) == (0, 3)
    assert infos[1]["captures"] == 3
    # a corrupt record is a miss with a warning, never a crash
    rec = sorted((tmp_path / "c").glob("graph_*.json"))[0]
    rec.write_text("{not json")
    with pytest.warns(RuntimeWarning, match="unreadable"):
        srv = PS.Server("kmeans", state, mesh=cpu, ladder=LADDER,
                        cache_dir=str(tmp_path / "c"))
        info = srv.startup()
    assert (info["cache_hits"], info["cache_misses"]) == (2, 1)
    # an option baked into the step keys separately
    mf = PE.MFSGDTopK.synthetic_state(np.random.default_rng(0))
    hits = []
    for k in (10, 20, 10):
        s = PS.Server("mfsgd", mf, mesh=cpu, ladder=(1,),
                      cache_dir=str(tmp_path / "m"),
                      engine_opts={"topk": k})
        hits.append(s.startup()["cache_hits"])
    assert hits == [0, 0, 1]


def test_graph_cache_key_covers_shape_and_fingerprint(cpu, tmp_path):
    eng = PE.KMeansAssign(_kmeans_state(), cpu)
    a = GraphCache(str(tmp_path), fingerprint="a")
    b = GraphCache(str(tmp_path), fingerprint="b")
    for cache in (a, a, b):
        cache.get_or_build("kmeans", eng, 8, 2, None)
    cache = GraphCache(str(tmp_path), fingerprint="a")
    cache.get_or_build("kmeans", eng, 16, 2, None)
    assert (a.hits, a.misses, b.hits, b.misses) == (1, 1, 0, 1)
    assert (cache.hits, cache.misses) == (0, 1)


# ---------------------------------------------------------------------------
# checkpoint to server
# ---------------------------------------------------------------------------

def test_server_answers_from_a_kmeans_fit_checkpoint(tmp_path, cpu):
    from harp_tpu_torch.models import kmeans as KM
    from harp_tpu_torch.utils.checkpoint import CheckpointManager

    rng = np.random.default_rng(60)
    pts = rng.normal(size=(400, 12)).astype(np.float32)
    c, _ = KM.fit(pts, k=5, iters=4, seed=0, device="cpu",
                  ckpt_dir=str(tmp_path / "km"), ckpt_every=2)
    srv = PS.Server("kmeans", ckpt=str(tmp_path / "km"), mesh=cpu)
    srv.startup()
    step, state = CheckpointManager(str(tmp_path / "km")).restore_latest()
    direct = PS.Server("kmeans", state, mesh=cpu)
    direct.startup()
    reqs = [{"id": 0, "x": pts[:70].tolist()}, {"id": 1, "x": pts[70:71]}]
    got = srv.process(reqs)
    assert srv.ckpt_step == step and got == direct.process(reqs)
    want = np.argmin(((pts[:70, None] - c[None]) ** 2).sum(-1), 1)
    assert got[0]["result"] == want.tolist()


def test_server_answers_from_an_mfsgd_fit_checkpoint(tmp_path, cpu):
    from harp_tpu_torch.models import mfsgd as MF
    from harp_tpu_torch.utils.checkpoint import CheckpointManager

    m = MF.MFSGD(60, 40, MF.MFSGDConfig(rank=4, algo="scatter"),
                 device="cpu", seed=0)
    m.set_ratings(*MF.synthetic_ratings(60, 40, 600, rank=4, seed=1))
    m.fit(3, str(tmp_path / "mf"), ckpt_every=1)
    srv = PS.Server("mfsgd", ckpt=str(tmp_path / "mf"), mesh=cpu,
                    engine_opts={"topk": 5})
    srv.startup()
    _, state = CheckpointManager(str(tmp_path / "mf")).restore_latest()
    direct = PS.Server("mfsgd", state, mesh=cpu, engine_opts={"topk": 5})
    direct.startup()
    reqs = [{"id": "u", "users": list(range(0, 60, 7))}]
    got = srv.process(reqs)
    assert got == direct.process(reqs)
    W, H = m.factors()
    want = np.argsort(-(W[0:60:7] @ H.T), axis=1, kind="stable")[:, :5]
    assert [r["items"] for r in got[0]["result"]] == want.tolist()


# ---------------------------------------------------------------------------
# stdio, TCP, bench rows, CLI
# ---------------------------------------------------------------------------

def test_stdio_loop_matches_the_reference(jmesh1, cpu):
    rng = np.random.default_rng(70)
    lines = [json.dumps({"id": i, "x": rng.normal(size=(i + 1, 16)).tolist()})
             for i in range(3)]
    text = "\n".join(lines + ["{bad json", '{"cmd": "quit"}', lines[0]]) + "\n"
    outs = []
    for mod, m in ((JS, jmesh1), (PS, cpu)):
        srv = mod.Server("kmeans", _kmeans_state(), mesh=m, ladder=LADDER)
        srv.startup()
        out = io.StringIO()
        assert srv.serve_stdio(io.StringIO(text), out) == 3
        outs.append(out.getvalue())
    assert outs[0] == outs[1]


def test_tcp_front_end_round_trips_and_shuts_down(cpu):
    from harp_tpu_torch.serve.transport import TCPFrontEnd

    srv = PS.Server("kmeans", _kmeans_state(), mesh=cpu, ladder=LADDER)
    srv.startup()
    fe = TCPFrontEnd(srv, port=0).start_in_thread()
    rng = np.random.default_rng(71)
    xs = [rng.normal(size=(n, 16)).astype(np.float32) for n in (1, 4, 9)]
    try:
        with socket.create_connection(("127.0.0.1", fe.port),
                                      timeout=20) as sock:
            f = sock.makefile("rw")
            for i, x in enumerate(xs):
                f.write(json.dumps({"id": i, "x": x.tolist()}) + "\n")
            f.write('{"cmd": "quit"}\n')
            f.flush()
            got = [json.loads(f.readline()) for _ in xs]
    finally:
        fe.shutdown()
        fe.join(timeout=20)
    assert not fe._thread.is_alive()
    ref = PS.Server("kmeans", _kmeans_state(), mesh=cpu, ladder=LADDER)
    ref.startup()
    want = ref.process([{"id": i, "x": x.tolist()} for i, x in
                        enumerate(xs)])
    assert got == want


def test_bench_rows_hold_the_budgets(cpu):
    row = benchmark(app="kmeans", n_requests=48, burst=16, ladder=(1, 8, 32),
                    mesh=cpu, state_shape={"k": 8, "d": 16})
    assert row["steady_compiles"] == 0 and row["budget_violations"] == 0
    assert row["steady_dispatches"] == row["steady_readbacks"] \
        == row["batches"] == 3
    assert row["p50_ms"] <= row["p95_ms"] <= row["p99_ms"]
    assert (row["cache_misses"], row["startup_captures"]) == (3, 0)


def test_bench_bursts_land_on_every_rung_over_a_timed_window(cpu):
    row = benchmark(app="kmeans", n_requests=82, burst=(1, 8, 32),
                    ladder=(1, 8, 32), mesh=cpu,
                    state_shape={"k": 8, "d": 16}, min_seconds=0.05)
    # bursts of 1, 8 and 32 requests in turn: one exact-fit batch each
    assert row["burst"] == [1, 8, 32] and row["padding_frac"] == 0.0
    assert row["n_requests"] >= 82 and row["window_s"] >= 0.05
    assert row["n_requests"] % 41 in (0, 1, 9)
    assert row["steady_dispatches"] == row["steady_readbacks"] \
        == row["batches"] >= 6
    assert row["qps"] == pytest.approx(row["n_requests"] / row["window_s"],
                                       rel=1e-2)


def test_sustained_row_retries_faults_with_a_fresh_stage(cpu):
    with pytest.warns(RuntimeWarning, match="h2d_calls used 2 > budget 1"):
        res = benchmark_sustained(app="kmeans", n_requests=96,
                                  burst_admit=8, ladder=(1, 8, 32), mesh=cpu,
                                  state_shape={"k": 8, "d": 16},
                                  fault_ordinals=(2, 5), max_retries=3)
    assert res["served_requests"] + res["shed_requests"] \
        + res["failed_requests"] == res["offered_requests"] == 96
    assert res["faults_injected"] == res["fault_retries"] == 2
    # each retry staged again: the one-staging-a-window budget drifted
    assert res["health_budget_drift"] == 2
    assert res["steady_compiles"] == 0
    assert res["steady_dispatches"] == res["steady_readbacks"] \
        == res["batches"]
    assert res["offered_qps"] >= res["achieved_qps"] > 0


def test_sustained_row_with_a_fault_rate(cpu):
    res = benchmark_sustained(app="kmeans", n_requests=64, burst_admit=8,
                              ladder=(1, 8, 32), mesh=cpu,
                              state_shape={"k": 8, "d": 16},
                              fault_rate=0.2, max_retries=0)
    assert res["served_requests"] + res["shed_requests"] \
        + res["failed_requests"] == 64
    assert res["engine_failures"] == res["faults_injected"] > 0


def test_serve_cli_bench_and_stdio(capsys, tmp_path, monkeypatch):
    assert PS.main(["kmeans", "--bench", "--device", "cpu", "--requests",
                    "16", "--ladder", "1,8"]) == 0
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert row["config"] == "serve_kmeans" and row["backend"] == "cpu"
    from harp_tpu_torch.utils.checkpoint import CheckpointManager

    CheckpointManager(str(tmp_path / "ck")).save(3, _kmeans_state())
    x = np.ones((2, 16), np.float32).tolist()
    monkeypatch.setattr("sys.stdin", io.StringIO(
        json.dumps({"id": 7, "x": x}) + "\n"))
    assert PS.main(["kmeans", "--ckpt", str(tmp_path / "ck"), "--device",
                    "cpu", "--ladder", "1,8"]) == 0
    cap = capsys.readouterr()
    assert json.loads(cap.out)["id"] == 7
    ready = json.loads(cap.err.strip().splitlines()[-1])
    assert ready["kind"] == "serve_ready" and ready["step"] == 3
    assert (tmp_path / "ck" / ".graph_cache").is_dir()
