"""harplint on the port (``harp_tpu_torch/analysis``) against harp_tpu's.

- Each ported rule has a fixture that fires and a clean twin: the AST rules
  (HL000-HL005), HL205 on the kernel registry's shared-memory
  declarations, the wire audit's HL301/HL302 checks on a run's calls and
  ledger, HL303 on the serve and elastic staging protocols (each clean, each
  sabotaged twin caught), and the thread-root rules HL401-HL405.
- Held against the JAX package: the port's rule ids are a subset of the
  reference's; ``Violation.format`` is the same for the same fields; one
  TOML loads, suppresses and reports stale alike through both allowlist
  modules; the reference's HL402, HL403 and HL405 fixtures give the same
  ``(rule, line)`` lists through both ``analyze_sources``, and its HL401
  and HL404 fixtures, in torch words, fire at the same lines; the
  ownership map forbids the reference's thread patterns on every plane but
  schedule (whose workers own the card in the port); the ``lint --json``
  row passes ``scripts/check_jsonl.py``'s ``_check_lint_row``.
- The CLI: ``lint --device cpu --json`` is clean on this tree, ``--layer
  ast`` needs no card, the wire layer raises without one unless given
  ``--device cpu``, a fixture path or a stale entry fails the run.
"""

import importlib.util
import json
import os
import textwrap

import pytest
import torch

from harp_tpu.analysis import Violation as JViolation
from harp_tpu.analysis import allowlist as JA
from harp_tpu.analysis import rule_ids as j_rule_ids
from harp_tpu.analysis import threadgraph as JTG
from harp_tpu_torch.analysis import RULES, Violation, rule_ids
from harp_tpu_torch.analysis import allowlist as A
from harp_tpu_torch.analysis import cli, commgraph, kernel_audit
from harp_tpu_torch.analysis import threadgraph as TG
from harp_tpu_torch.analysis.astlints import lint_paths, lint_source
from torch_world import time_limit

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _limit():
    with time_limit(120):
        yield


def _check_jsonl():
    """scripts/check_jsonl.py, loaded standalone (it imports no
    harp_tpu)."""
    spec = importlib.util.spec_from_file_location(
        "_check_jsonl", os.path.join(ROOT, "scripts", "check_jsonl.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _rules(violations):
    return sorted({v.rule for v in violations})


def _lint(src, path="harp_tpu_torch/models/fake.py"):
    return lint_source(path, textwrap.dedent(src))


# ---------------------------------------------------------------------------
# The registry
# ---------------------------------------------------------------------------

def test_rule_ids_are_a_subset_of_the_references():
    assert set(rule_ids()) <= set(j_rule_ids())
    assert rule_ids() == sorted(RULES)
    layers = {r.layer for r in RULES.values()}
    assert layers == {"ast", "kernels", "wire", "threads"}


def test_rules_not_ported_are_named_with_their_reason():
    from harp_tpu_torch.analysis import rules

    left_out = set(j_rule_ids()) - set(rule_ids())
    assert left_out == {"HL004", "HL101", "HL102", "HL201", "HL202",
                        "HL203", "HL204", "HL304"}
    doc = rules.__doc__
    for rid in ("HL004", "HL101", "HL102", "HL201-HL204", "HL304"):
        assert rid in doc, rid


@pytest.mark.parametrize("fields", [
    ("HL001", "harp_tpu_torch/models/mlp.py", 12, "raw call",
     "    dist.all_reduce(y)\n"),
    ("HL301", "driver:kmeans.fit", 0, "untracked", ""),
    ("HL403", "a.py", 3, "shared state", "x += 1")])
def test_violation_format_matches_the_reference(fields):
    assert Violation(*fields).format() == JViolation(*fields).format()


# ---------------------------------------------------------------------------
# AST rules: one fixture that fires, one clean twin
# ---------------------------------------------------------------------------

def test_hl000_syntax_error_fires_and_valid_source_is_clean():
    assert _rules(_lint("def broken(:\n")) == ["HL000"]
    assert _lint("def fine():\n    return 1\n") == []


def test_hl001_raw_distributed_call_fires():
    vs = _lint("""
        import torch.distributed as dist
        def step(x):
            dist.all_reduce(x)
            dist.all_gather_into_tensor(x, x)
            dist.batch_isend_irecv([])
            return x
    """)
    assert _rules(vs) == ["HL001"] and [v.line for v in vs] == [4, 5, 6]


def test_hl001_verb_layer_and_group_queries_are_clean():
    src = ("import torch.distributed as dist\n"
           "def f(x):\n"
           "    dist.all_reduce(x)\n")
    assert lint_source("harp_tpu_torch/parallel/collective.py", src) == []
    assert lint_source("harp_tpu_torch/parallel/rotate.py", src) == []
    assert _lint("""
        import torch.distributed as dist
        def f():
            g = dist.new_group([0, 1])
            dist.barrier(group=g)
            return dist.get_rank(g) + dist.get_world_size()
    """) == []


def test_hl002_global_rng_fires():
    vs = _lint("""
        import numpy as np
        import torch
        def draw(n):
            torch.manual_seed(0)
            np.random.seed(1)
            a = np.random.normal(size=n)
            return torch.randn(n), torch.randperm(n), a
    """)
    assert _rules(vs) == ["HL002"] and [v.line for v in vs] == [5, 6, 7, 8,
                                                                8]


def test_hl002_explicit_generators_are_clean():
    assert _lint("""
        import numpy as np
        import torch
        def draw(n, seed):
            g = torch.Generator().manual_seed(seed)
            rng = np.random.default_rng(seed)
            return torch.randn(n, generator=g), rng.normal(size=n)
    """) == []


def test_hl003_host_numpy_onto_a_device_fires():
    vs = _lint("""
        import numpy as np
        import torch
        def ingest(x, dev):
            a = torch.tensor(np.asarray(x), device=dev)
            b = torch.as_tensor(np.asarray(x)).to(dev)
            return a, b, torch.as_tensor(np.ones(3)).cuda()
    """)
    assert _rules(vs) == ["HL003"] and [v.line for v in vs] == [5, 6, 7]


def test_hl003_counted_and_host_copies_are_clean():
    assert _lint("""
        import numpy as np
        import torch
        from harp_tpu_torch.utils import flightrec
        def host(x):
            return torch.as_tensor(np.asarray(x), device="cpu")
        def placed(mesh, x):
            return mesh.shard_array(torch.as_tensor(np.asarray(x)), 0)
        def counted(x, dev):
            flightrec.record_h2d(x.nbytes)
            return torch.tensor(np.asarray(x), device=dev)
        class StagingRing:
            def ship(self, x, dev):
                return torch.as_tensor(np.asarray(x)).to(dev)
    """) == []


@pytest.mark.parametrize("claim", [
    "K3 takes 0.05 ms a step", "a 12.5 us launch", "3.2 GB/s from HBM",
    "1.1M ups/s", "2.9× faster than the plain version"])
def test_hl005_perf_number_without_card_fires(claim):
    vs = _lint(f'def k():\n    """{claim}."""\n')
    assert _rules(vs) == ["HL005"]
    assert "H100" in vs[0].message and "power limit" in vs[0].message


def test_hl005_labelled_number_and_p99_are_clean():
    assert _lint('def k():\n    """0.05 ms a step (2026-10-18, NVIDIA '
                 'H100 80GB HBM3, 700 W)."""\n') == []
    assert _lint('"""The serve row: p50, p95, p99 ms and qps."""\n',
                 "chip_smoke.py") == []
    # outside the port's files the rule does not apply
    assert _lint('def k():\n    """0.05 ms."""\n', "scripts/x.py") == []


# ---------------------------------------------------------------------------
# HL205: the registry's shared memory against the wrappers' plans
# ---------------------------------------------------------------------------

def test_hl205_declarations_hold_to_the_plans():
    models = kernel_audit.smem_models()
    assert set(models) == {"mfsgd.sgd_tile_update", "lda.cgs_entry_update",
                           "rf.hist_bins", "flash_attention"}
    assert kernel_audit.check_smem_declarations(models) == []
    # K1 and K2 plan on the card only
    assert kernel_audit.unchecked() == ["kmeans.partials",
                                        "kmeans.partials_int8"]


def test_hl205_stale_and_oversized_declarations_fire():
    from harp_tpu_torch.ops.kernel_registry import KERNEL_WORK

    k4 = KERNEL_WORK["lda.cgs_entry_update"]["smem_bytes"]
    vs = kernel_audit.check_smem_declarations(
        {"lda.cgs_entry_update": 2 * k4,      # declared below the plan
         "flash_attention": 1000,             # declared far above it
         "nope.kernel": 64})                  # planned, not registered
    assert _rules(vs) == ["HL205"]
    assert sorted(v.path for v in vs) == ["kernel:flash_attention",
                                          "kernel:lda.cgs_entry_update",
                                          "kernel:nope.kernel"]
    assert all(v.line == 0 for v in vs)


# ---------------------------------------------------------------------------
# HL301/HL302 on a run's calls and ledger records
# ---------------------------------------------------------------------------

def _call(site, prim, nbytes, calls=1):
    return {(site, prim): commgraph.WireCall(site, prim, "float32", nbytes,
                                             calls)}


def _rec(site, nbytes, verb="allreduce", wire=None):
    return {"site": site, "verb": verb, "combiner": "add",
            "wire_dtype": wire, "payload_bytes": nbytes, "calls": 1}


def test_hl301_unledgered_wire_fires_and_a_ledgered_one_is_clean():
    calls = _call("mlp.py:529", "psum", 64)
    vs = commgraph.check_run("p", calls, {})
    assert _rules(vs) == ["HL301"] and vs[0].path == "driver:p"
    assert "mlp.py:529" in vs[0].message
    assert commgraph.check_run("p", calls, {"mlp.py:529": [
        _rec("mlp.py:529", 64)]}) == []


def test_hl302_lying_ledger_fires_and_quantized_wire_is_exempt():
    calls = _call("k.py:3", "psum", 64, calls=2)
    vs = commgraph.check_run("p", calls, {"k.py:3": [_rec("k.py:3", 32)]})
    assert _rules(vs) == ["HL302"]
    assert "64 B" in vs[0].message and "32 B" in vs[0].message
    assert commgraph.check_run("p", calls, {"k.py:3": [
        _rec("k.py:3", 16, "allreduce_quantized", "int8")]}) == []


def test_sheet_names_the_matched_verb_in_the_references_vocabulary():
    calls = {**_call("k.py:3", "psum", 64), **_call("r.py:9", "ppermute",
                                                     32, calls=4)}
    sheet = commgraph.sheet(calls, {"k.py:3": [_rec("k.py:3", 64)],
                                    "r.py:9": [_rec("r.py:9", 32,
                                                    "rotate")]})
    rows = {(c["site"], c["primitive"]): c for c in sheet["collectives"]}
    assert rows[("k.py:3", "psum")]["verb"] == "allreduce"
    assert rows[("r.py:9", "ppermute")]["calls_per_trace"] == 4
    assert sheet["bytes_per_trace"] == sheet["amplified_bytes"] == 96
    cj = _check_jsonl()
    row = {"kind": "lint", "backend": "cpu", "date": "2026-10-18",
           "commit": "x", "byte_sheets": {"kmeans.fit": sheet}}
    assert cj._check_lint_row("row", 1, row) == []


# ---------------------------------------------------------------------------
# HL303: the staging protocols and their sabotaged twins
# ---------------------------------------------------------------------------

def test_hl303_registered_protocols_are_clean_and_stage():
    from harp_tpu_torch.analysis.drivers import PROTOCOLS

    assert set(PROTOCOLS) == {"serve.kmeans_continuous",
                              "serve.mfsgd_continuous",
                              "serve.retry_restage",
                              "elastic.rebalance_restage"}
    for name, build in sorted(PROTOCOLS.items()):
        audit = commgraph.StagingAudit(f"protocol:{name}")
        with audit:
            build("cpu")(audit)
        assert audit.violations == [], name
        assert audit.staged_dispatches > 0, name


def _kmeans_server(audit):
    import numpy as np

    from harp_tpu_torch.parallel.mesh import WorkerMesh
    from harp_tpu_torch.serve.engines import KMeansAssign
    from harp_tpu_torch.serve.server import Server

    rng = np.random.default_rng(0)
    srv = Server("kmeans", state=KMeansAssign.synthetic_state(rng, k=8,
                                                              d=32),
                 mesh=WorkerMesh("cpu"), ladder=(1, 8))
    srv.startup()
    audit.watch_server(srv)
    return srv, srv.engine.make_input(
        srv.engine.rows_from_request(srv.engine.synthetic_request(rng, 8)),
        8)


def test_hl303_redispatching_a_staged_token_fires():
    """The sabotaged retry: the failed attempt's token dispatched again
    instead of a fresh staging."""
    def drive(audit):
        srv, arr = _kmeans_server(audit)
        tok = srv._rungs[8].stage(arr)
        out = srv._exec[8](*srv.engine.state_args(), tok)
        srv._readback(8, out)
        srv._exec[8](*srv.engine.state_args(), tok)

    vs = commgraph.audit_protocol("sabotaged_retry", drive)
    assert _rules(vs) == ["HL303"]
    assert any("already dispatched" in v.message for v in vs)


def test_hl303_writing_a_buffer_set_in_flight_fires():
    """The sabotaged pipeline: a buffer set freed at dispatch instead of
    at its readback, so the next staging writes it while its launch may
    still read it."""
    def drive(audit):
        srv, arr = _kmeans_server(audit)
        rung = srv._rungs[8]
        tok = rung.stage(arr)
        srv._exec[8](*srv.engine.state_args(), tok)
        rung._busy[tok.slot] = False      # freed before its readback
        rung.stage(arr)

    vs = commgraph.audit_protocol("sabotaged_pipeline", drive)
    assert _rules(vs) == ["HL303"]
    assert any("in flight" in v.message for v in vs)


def test_hl303_dispatching_a_pre_loss_buffer_in_the_new_world_fires():
    """The sabotaged shrink: the batch staged before the loss dispatched
    again on the rebuilt group."""
    from harp_tpu_torch.analysis.drivers import elastic_step
    from harp_tpu_torch.parallel.mesh import WorkerMesh

    def drive(audit):
        mesh = WorkerMesh("cpu")
        audit.set_world(mesh)
        step = elastic_step(audit, "elastic.step_full")
        staged = audit.staged(mesh.shard_array(torch.ones(8, 4), 0))
        carry, _ = step(torch.zeros(()), staged)
        audit.set_world(WorkerMesh("cpu"))
        elastic_step(audit, "elastic.step_surv")(carry, staged)

    vs = commgraph.audit_protocol("sabotaged_shrink", drive)
    assert _rules(vs) == ["HL303"]
    msgs = " ".join(v.message for v in vs)
    assert "already dispatched" in msgs and "has since changed" in msgs


def test_hl303_a_protocol_that_stages_nothing_is_flagged():
    vs = commgraph.audit_protocol("vacuous", lambda audit: None)
    assert _rules(vs) == ["HL303"] and "checked nothing" in vs[0].message


# ---------------------------------------------------------------------------
# HL401-HL405: the thread-root graph, against the reference's fixtures
# ---------------------------------------------------------------------------

def _both(src, owners=("main",), spine_locked=None):
    """(rule, line) lists of one fixture through both packages."""
    src = textwrap.dedent(src)
    out = []
    for tg in (JTG, TG):
        vs = tg.analyze_sources(tg.PlaneSpec("fix", ("fix.py",),
                                             tuple(owners)),
                                {"fix.py": src}, spine_locked=spine_locked)
        out.append(sorted((v.rule, v.line) for v in vs))
    return out


_HL402_SRC = """
    import time

    class FrontEnd:
        async def _run(self):
            while True:
                self._drain()

        def _drain(self):
            time.sleep(0.1)
            self._done.wait()
"""

_HL402_CLEAN = """
    import asyncio

    class FrontEnd:
        async def _run(self):
            await asyncio.sleep(0.1)
            self._done.wait(0.5)
"""

_HL403_SPINE_SRC = """
    import threading

    from harp_tpu_torch.utils import reqtrace

    class Pump:
        def start(self):
            t = threading.Thread(target=self._pump, daemon=True,
                                 name="fix-pump")
            t.start()

        def serve_one(self):
            rid = reqtrace.tracer.begin(0.0)

        def _pump(self):
            reqtrace.tracer.event("r1", "deliver")
"""

_HL403_ATTR_TMPL = """
    import threading

    class Counter:
        def __init__(self):
            self.n = 0
            self._lock = threading.Lock()

        def start(self):
            t = threading.Thread(target=self._bump, daemon=True,
                                 name="fix-bump")
            t.start()

        def bump_from_main(self):
            {main_write}

        def _bump(self):
            {thread_write}
"""

_HL405_SRC = """
    import threading

    def spawn(fn):
        t = threading.Thread(target=fn, name="fix-zombie")
        t.start()
        return t
"""

_HL405_CLEAN = """
    import threading

    def spawn_daemon(fn):
        t = threading.Thread(target=fn, daemon=True)
        t.start()

    def spawn_joined(fn):
        t = threading.Thread(target=fn)
        t.start()
        t.join(5.0)
"""

SHARED_FIXTURES = {
    "hl402": (_HL402_SRC, None, [("HL402", 10), ("HL402", 11)]),
    "hl402-clean": (_HL402_CLEAN, None, []),
    "hl403-spine": (_HL403_SPINE_SRC, {"reqtrace": False}, [("HL403", 13)]),
    "hl403-spine-locked": (_HL403_SPINE_SRC, {"reqtrace": True}, []),
    "hl403-attr": (_HL403_ATTR_TMPL.format(
        main_write="self.n += 1", thread_write="self.n += 1"), None,
        [("HL403", 15)]),
    "hl403-attr-locked": (_HL403_ATTR_TMPL.format(
        main_write="with self._lock:\n                self.n += 1",
        thread_write="with self._lock:\n                self.n += 1"), None,
        []),
    "hl405": (_HL405_SRC, None, [("HL405", 5)]),
    "hl405-clean": (_HL405_CLEAN, None, []),
}


@pytest.mark.parametrize("name", sorted(SHARED_FIXTURES))
def test_shared_thread_fixtures_match_the_reference(name):
    src, locked, want = SHARED_FIXTURES[name]
    ref, got = _both(src, spine_locked=locked)
    assert got == ref == want


_HL401_TMPL = """
    import threading

    import {module}

    class Worker:
        def start(self):
            t = threading.Thread(target=self._work, daemon=True,
                                 name="fix-worker")
            t.start()

        def _work(self):
            return {device_call}
"""


def test_hl401_fires_at_the_references_line_in_torch_words():
    ref = JTG.analyze_sources(
        JTG.PlaneSpec("fix", ("fix.py",), ("main",)),
        {"fix.py": textwrap.dedent(_HL401_TMPL.format(
            module="jax.numpy as jnp", device_call="jnp.zeros((4,))"))})
    for call in ("torch.cuda.synchronize()", "self.x.cpu()",
                 "self.x.detach().item()"):
        src = textwrap.dedent(_HL401_TMPL.format(module="torch",
                                                 device_call=call))
        got = TG.analyze_sources(TG.PlaneSpec("fix", ("fix.py",),
                                              ("main",)), {"fix.py": src})
        assert [(v.rule, v.line) for v in got] == \
            [(v.rule, v.line) for v in ref] == [("HL401", 13)], call
        assert "thread:_work" in got[0].message
        # the designated-owner twin is clean
        assert TG.analyze_sources(
            TG.PlaneSpec("fix", ("fix.py",), ("main", "thread:_work")),
            {"fix.py": src}) == []


_HL404_TMPL = """
    class Runner:
        def flush(self, batch):
            with self._lock:
                out = self._exec[0](batch)
            return out

        def stage(self, a, b):
            import {module}
            with self._lock:
                return {device_call}
"""


def test_hl404_fires_at_the_references_lines_in_torch_words():
    ref = JTG.analyze_sources(
        JTG.PlaneSpec("fix", ("fix.py",), ("main",)),
        {"fix.py": textwrap.dedent(_HL404_TMPL.format(
            module="jax.numpy as jnp", device_call="jnp.dot(a, b)"))})
    got = TG.analyze_sources(
        TG.PlaneSpec("fix", ("fix.py",), ("main",)),
        {"fix.py": textwrap.dedent(_HL404_TMPL.format(
            module="torch", device_call="(a @ b).cpu()"))})
    assert sorted((v.rule, v.line) for v in got) == \
        sorted((v.rule, v.line) for v in ref) == [("HL404", 5),
                                                  ("HL404", 11)]
    clean = TG.analyze_sources(TG.PlaneSpec("fix", ("fix.py",), ("main",)),
                               {"fix.py": textwrap.dedent("""
        class Runner:
            def flush(self):
                with self._lock:
                    batch = self._q.popleft()
                return self._exec[0](batch)
    """)})
    assert clean == []


def test_ownership_map_forbids_the_references_patterns_but_schedules():
    ours = TG.ownership_map()
    ref = JTG.ownership_map(ROOT)
    assert set(ours["planes"]) == set(ref["planes"])
    for plane in ours["planes"]:
        got = ours["planes"][plane]["forbidden_thread_patterns"]
        want = ref["planes"][plane]["forbidden_thread_patterns"]
        if plane == "schedule":
            # the port's scheduler workers launch on streams of their own
            assert want and got == []
            assert "thread:worker" in ours["planes"][plane]["device_owners"]
        else:
            assert got == want, plane
    assert set(ours["spines"]) == set(ref["spines"])
    assert {k: v["locked"] for k, v in ours["spines"].items()} == \
        {k: v["locked"] for k, v in ref["spines"].items()}


def test_threads_layer_at_head_has_only_allowlisted_findings():
    vs = TG.analyze_repo(ROOT)
    assert _rules(vs) == ["HL403"]
    kept, suppressed, stale = A.apply(vs, A.load())
    assert kept == [] and len(suppressed) == len(vs) == 5
    assert not any(e["rule"].startswith("HL4") for e in stale)


def test_planes_for_paths_and_spine_verdicts():
    assert TG.planes_for_paths(["harp_tpu_torch/ingest.py"]) == ["ingest"]
    assert TG.planes_for_paths(["harp_tpu_torch/utils/reqtrace.py"]) == \
        [p.name for p in TG.PLANES]
    assert TG.planes_for_paths(["harp_tpu_torch/models/kmeans.py"]) == []
    spec = next(s for s in TG.SPINES if s.name == "reqtrace")
    locked = textwrap.dedent("""
        class ReqTracer:
            def begin(self, t):
                with self._lock:
                    return 1
            def event(self, rid, name):
                with self._lock:
                    pass
            def end(self, rid, outcome, t):
                with self._lock:
                    pass
            def mark(self, name):
                with self._lock:
                    pass
    """)
    assert TG._spine_locked_from_source(spec, locked) is True
    assert TG._spine_locked_from_source(spec, locked.replace(
        "def mark(self, name):\n        with self._lock:\n            pass",
        "def mark(self, name):\n        self.rows.append(name)")) is False
    assert TG.spine_lock_verdicts(ROOT) == {
        "reqtrace": True, "comm_ledger": False, "span_tracer": False,
        "flightrec": False}


# ---------------------------------------------------------------------------
# The allowlist, against the reference's module
# ---------------------------------------------------------------------------

def test_allowlist_requires_a_reason(tmp_path):
    p = tmp_path / "allow.toml"
    p.write_text('[[allow]]\nrule = "HL001"\npath = "x.py"\n')
    with pytest.raises(A.AllowlistError):
        A.load(str(p))


def test_allowlist_suppresses_and_reports_stale_as_the_reference(tmp_path):
    p = tmp_path / "allow.toml"
    p.write_text(textwrap.dedent("""
        [[allow]]
        rule = "HL001"
        path = "a.py"
        reason = "legit"
        [[allow]]
        rule = "HL003"
        path = "a.py"
        match = "torch.tensor"
        reason = "anchored"
        [[allow]]
        rule = "HL002"
        path = "never.py"
        reason = "stale"
    """))
    fields = [("HL001", "a.py", 1, "m", ""), ("HL001", "b.py", 1, "m", ""),
              ("HL003", "a.py", 2, "m", "x = torch.tensor(y)"),
              ("HL003", "a.py", 3, "m", "x = np.asarray(y)")]
    out = []
    for mod, V in ((JA, JViolation), (A, Violation)):
        entries = mod.load(str(p))
        kept, sup, stale = mod.apply([V(*f) for f in fields], entries)
        out.append(([v.format() for v in kept], [v.format() for v in sup],
                    [(e["rule"], e["path"], e["_hits"]) for e in stale],
                    [{k: v for k, v in e.items() if k != "_hits"}
                     for e in entries]))
    assert out[0] == out[1]
    assert out[1][2] == [("HL002", "never.py", 0)]


def test_committed_allowlist_entries_all_have_reasons_and_anchors():
    entries = A.load()
    assert len(entries) == 12
    for e in entries:
        assert e["reason"].strip() and e["rule"] in RULES
        assert e["path"].startswith("harp_tpu_torch/")


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------

def _row(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_cli_full_run_on_the_cpu_is_clean_and_its_row_validates(capsys):
    rc = cli.main(["--device", "cpu", "--json"])
    row = _row(capsys)
    assert rc == 0, row
    assert row["kind"] == "lint" and row["clean"] is True
    assert row["violations"] == 0 and row["stale_allowlist"] == 0
    assert row["allowlisted"] == 12 and row["files_scanned"] > 100
    assert row["rules"] == rule_ids()
    assert set(row["byte_sheets"]) == set(
        __import__("harp_tpu_torch.analysis.drivers",
                   fromlist=["DRIVERS"]).DRIVERS)
    assert row["kernels_unchecked"] == ["kmeans.partials",
                                        "kmeans.partials_int8"]
    assert _check_jsonl()._check_lint_row("row", 1, row) == []


def test_cli_ast_layer_needs_no_card(capsys):
    from torch.overrides import TorchFunctionMode

    made = []

    class Watch(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if isinstance(out, torch.Tensor):
                made.append(func)
            return out

    with Watch():
        for layer in ("ast", "threads", "kernels"):
            assert cli.main(["--layer", layer, "--json"]) == 0
            assert _row(capsys)["clean"] is True
    assert made == []


def test_cli_wire_layer_raises_without_a_card_unless_given_cpu(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device exists")
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["--layer", "wire", "--json"])
    assert cli.main(["--layer", "wire", "--device", "cpu", "--json"]) == 0
    assert _row(capsys)["clean"] is True


def test_cli_fixture_path_exits_nonzero(tmp_path, capsys):
    bad = tmp_path / "bad_module.py"
    bad.write_text("import torch\n"
                   "def f(n):\n"
                   "    return torch.randn(n)\n")
    rc = cli.main([str(bad), "--json"])
    row = _row(capsys)
    assert rc == 1 and row["violations"] == 1
    assert row["per_rule"] == {"HL002": 1}
    assert all(k in row for k in ("backend", "date", "commit"))


def test_cli_audit_module_runs_the_wire_and_threads_layers(tmp_path,
                                                           capsys):
    fixture = tmp_path / "fixture_mod.py"
    fixture.write_text(textwrap.dedent("""
        import torch
        from harp_tpu_torch.analysis import threadgraph as TG

        def _never_dispatches(device):
            return lambda audit: None

        def _plain(device):
            return (lambda x: x * 2), (torch.ones(4),)

        HARPLINT_DRIVERS = {"plain": _plain}
        HARPLINT_PROTOCOLS = {"vacuous": _never_dispatches}
        HARPLINT_PLANES = {"zombie": (
            TG.PlaneSpec("z", ("z.py",), ("main",)),
            {"z.py": "import threading\\n"
                     "def f(g):\\n"
                     "    t = threading.Thread(target=g)\\n"
                     "    t.start()\\n"})}
        HARPLINT_KERNELS = {"lda.cgs_entry_update": 1}
    """))
    rc = cli.main(["--audit-module", str(fixture), "--device", "cpu",
                   "--json"])
    row = _row(capsys)
    assert rc == 1
    assert row["per_rule"] == {"HL205": 1, "HL303": 1, "HL405": 1}


def test_cli_stale_allowlist_entry_fails(tmp_path, capsys):
    p = tmp_path / "allow.toml"
    p.write_text(open(A.DEFAULT_PATH).read() + textwrap.dedent("""
        [[allow]]
        rule = "HL001"
        path = "harp_tpu_torch/nowhere.py"
        reason = "excuses nothing"
    """))
    rc = cli.main(["--layer", "ast", "--allowlist", str(p)])
    out = capsys.readouterr().out
    assert rc == 1 and "STALE allowlist entry" in out
    assert "harplint: FAILED" in out


def test_cli_changed_mode_scopes_the_ast_layer(monkeypatch, capsys):
    monkeypatch.setattr(cli, "_changed_paths",
                        lambda repo: ["harp_tpu_torch/schedule.py"])
    assert cli.main(["--changed", "--layer", "ast", "--json"]) == 0
    assert _row(capsys)["files_scanned"] == 1


def test_lint_is_a_command_of_the_launcher(capsys):
    from harp_tpu_torch import __main__ as launcher

    assert launcher.main(["lint", "--layer", "ast", "--json"]) == 0
    assert _row(capsys)["kind"] == "lint"


def test_the_ast_layer_is_clean_on_this_tree():
    kept, _, _ = A.apply(lint_paths(ROOT), A.load())
    assert kept == []


# ---------------------------------------------------------------------------
# The repairs this layer needs: site keys, budget, the watchdog, Timer
# ---------------------------------------------------------------------------

def test_site_key_and_user_frames_match_the_reference():
    import harp_tpu.utils.telemetry as JT
    import harp_tpu_torch.utils.telemetry as PT

    for path, line in (("/x/harp_tpu_torch/models/kmeans.py", 290),
                       ("rel/ring_attention.py", 7)):
        assert PT.site_key(path, line) == JT.site_key(path, line)
    assert not PT.is_ledger_user_frame(os.path.abspath(PT.__file__))
    assert not PT.is_ledger_user_frame(
        os.path.join(ROOT, "harp_tpu_torch", "parallel", "collective.py"))
    assert not PT.is_ledger_user_frame(os.path.join(
        os.path.dirname(torch.__file__), "distributed", "x.py"))
    assert not PT.is_ledger_user_frame("/usr/lib/python3/contextlib.py")
    assert PT.is_ledger_user_frame(
        os.path.join(ROOT, "harp_tpu_torch", "models", "kmeans.py"))


def test_ledger_sites_are_the_verbs_callers():
    import harp_tpu_torch.utils.telemetry as PT
    from harp_tpu_torch.parallel import collective as C
    from harp_tpu_torch.parallel.mesh import WorkerMesh, use_mesh

    with PT.scope(True), use_mesh(WorkerMesh("cpu")):
        C.allreduce((torch.ones(4), torch.ones(2)))
        line = __import__("inspect").currentframe().f_lineno - 1
        C.allgather(torch.ones(8, 2))
        sites = PT.ledger.summary()["(untagged)"]["sites"]
    by_verb = {s["verb"]: s for s in sites}
    assert by_verb["allreduce"]["site"] == f"test_torch_lint.py:{line}"
    assert by_verb["allreduce"]["payload_bytes"] == 24
    assert by_verb["allreduce"]["hops"] == 1
    assert by_verb["allgather"]["site"] == f"test_torch_lint.py:{line + 2}"


def test_telemetry_budget_is_the_flight_recorders():
    from harp_tpu_torch.utils import flightrec, telemetry

    with telemetry.scope(True):
        with pytest.raises(flightrec.BudgetExceeded):
            with telemetry.budget(readbacks=0, tag="t"):
                flightrec.readback(torch.ones(2))
        with telemetry.budget(readbacks=1, tag="t") as b:
            flightrec.readback(torch.ones(2))
        assert b.spent()["readbacks"] == 1


def test_timer_keeps_per_phase_times():
    from harp_tpu_torch.utils.timing import Timer

    t = Timer()
    for _ in range(3):
        assert t.time("step", lambda x: x * 2, torch.ones(3)).sum() == 6
    t.time("other", lambda: torch.zeros(1), sync=False)
    s = t.summary()
    assert s["step"]["n"] == 3 and s["other"]["n"] == 1
    assert s["step"]["total_s"] >= s["step"]["mean_s"] > 0


def test_pyproject_ships_the_allowlist():
    import tomllib

    with open(os.path.join(ROOT, "pyproject.toml"), "rb") as fh:
        cfg = tomllib.load(fh)
    data = cfg["tool"]["setuptools"]["package-data"]
    assert data["harp_tpu_torch.analysis"] == ["allowlist.toml"]
