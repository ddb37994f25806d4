"""Spawned gloo worlds for the training plane's tests — telemetry (the run
report, the superstep timeline, the skew ledger), the mapper and elastic
training — and the inputs both packages share.

Like :mod:`torch_world` (whose ``run_world`` spawns them), the children
import this module and through it torch and harp_tpu_torch, never JAX.
"""

from __future__ import annotations

import numpy as np

from torch_world import WORLD, run_world, time_limit  # noqa: F401

# ---- shared inputs ---------------------------------------------------------

#: the tiny MF-SGD and LDA configs of the reference's elastic drills
MF_KW = {"rank": 4, "algo": "dense", "u_tile": 8, "i_tile": 8,
         "entry_cap": 64}
LDA_KW = {"n_topics": 4, "algo": "dense", "d_tile": 8, "w_tile": 8,
          "entry_cap": 64, "sampler": "gumbel", "rng_impl": "threefry"}
SKEW_EPOCHS, LOSS_EPOCHS, LOST = 5, 3, 3


def skewed_ratings(n_users=64, n_items=48):
    """Ratings concentrated on the first workers' users (the reference's
    drill corpus)."""
    rng = np.random.default_rng(0)
    hot = rng.integers(0, 16, 4000)
    cold = rng.integers(16, n_users, 1000)
    users = np.concatenate([hot, cold])
    rng.shuffle(users)
    items = rng.integers(0, n_items, users.shape[0])
    vals = rng.normal(size=users.shape[0]).astype(np.float32)
    return users, items, vals


def uniform_ratings(seed: int):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 64, 2000), rng.integers(0, 48, 2000),
            rng.normal(size=2000).astype(np.float32))


def skewed_corpus():
    """64 docs, the first 16 ten times longer; 64 words."""
    rng = np.random.default_rng(0)
    lens = np.where(np.arange(64) < 16, 200, 20)
    d = np.repeat(np.arange(64), lens).astype(np.int32)
    return d, rng.integers(0, 64, d.shape[0]).astype(np.int32)


def uniform_corpus():
    rng = np.random.default_rng(2)
    d = np.repeat(np.arange(48), 24).astype(np.int32)
    return d, rng.integers(0, 48, d.shape[0]).astype(np.int32)


def stream_points():
    return np.random.default_rng(0).normal(size=(512, 8)).astype(np.float32)


def ledger_fields(rows: list[dict]) -> list[dict]:
    """The elastic rows' deterministic fields (times and stamps out)."""
    keep = ("event", "phase", "n_workers", "moves", "loads_before",
            "loads_after", "total", "wasted_frac_before",
            "wasted_frac_after", "trigger_supersteps", "lost_worker", "site",
            "ordinal", "n_workers_before", "n_workers_after",
            "capacity_frac", "from_step", "loads", "wasted_frac",
            "replayed_plan")
    return [{k: r[k] for k in keep if k in r} for r in rows]


# ---- elastic training ------------------------------------------------------

def run_elastic_cases(rank: int, world: int, root: str,
                      starts: dict) -> dict:
    """Every elastic drill on this world (``starts``: the reference
    adapters' initial canonical states, so both packages train from the
    same factors)."""
    import os

    from harp_tpu_torch import health
    from harp_tpu_torch.elastic import ledger as eledger
    from harp_tpu_torch.elastic.apps import (KMeansStreamElastic, LDAElastic,
                                             MFSGDElastic, elastic_fit)
    from harp_tpu_torch.elastic.move import regather_rows
    from harp_tpu_torch.elastic.rebalance import maybe_rebalance, wasted_frac
    from harp_tpu_torch.models.kmeans_stream import fit_streaming
    from harp_tpu_torch.models.lda import LDAConfig
    from harp_tpu_torch.models.mfsgd import MFSGD, MFSGDConfig
    from harp_tpu_torch.parallel import collective as C
    from harp_tpu_torch.parallel.mesh import WorkerMesh, use_mesh
    from harp_tpu_torch.utils import skew, telemetry
    from harp_tpu_torch.utils.checkpoint import CheckpointManager
    from harp_tpu_torch.utils.fault import (FaultInjector,
                                            PermanentWorkerLoss)

    mesh = WorkerMesh("cpu")
    out: dict = {}
    cfg = MFSGDConfig(**MF_KW)
    lcfg = LDAConfig(**LDA_KW)

    # the reshard-wire row move against the host gather
    host = np.random.default_rng(0).normal(size=(32, 4)).astype(np.float32)
    rows = np.array([5, -1, 0, 31, 7, 7, -1, 2] * 5, np.int64)
    with telemetry.scope(True):
        block = regather_rows(mesh, mesh.shard_array(host, 0), rows)
        out["regather"] = C.allgather(block).numpy()
        out["regather_bytes"] = telemetry.ledger.bytes_per_execution(
            "elastic.regather")
    try:
        regather_rows(mesh, mesh.shard_array(host[:16], 0), np.arange(9))
    except ValueError as e:
        out["regather_refused"] = str(e)

    # the MF-SGD skew drill, from the reference's initial factors
    u, i, v = skewed_ratings()
    with telemetry.scope(True):
        ad = MFSGDElastic(64, 48, cfg, mesh, 0, users=u, items=i, vals=v,
                          packs_per_worker=8)
        ad.install(starts["mf_skew"])
        eledger.reset()
        out["mf_wasted_home"] = wasted_frac(ad.worker_loads())
        elastic_fit(ad, SKEW_EPOCHS)
        out["mf_skew_rows"] = ledger_fields(eledger.ledger.rows)
        out["mf_skew_after"] = skew.ledger.summary()["mfsgd.epochs"]
        st = ad.canonical_state()
        out["mf_skew_state"] = {k: st[k] for k in ("W", "H", "assignment")}
        out["mf_skew_rmse"] = ad.metric()
    ad = MFSGDElastic(64, 48, cfg, mesh, 0, users=u, items=i, vals=v,
                      packs_per_worker=8)
    ad.install(starts["mf_skew"])
    elastic_fit(ad, SKEW_EPOCHS, rebalance=False)
    out["mf_plain_rmse"] = ad.metric()

    # the LDA skew drill
    d, w = skewed_corpus()
    with telemetry.scope(True):
        la = LDAElastic(64, 64, lcfg, mesh, 0, doc_ids=d, word_ids=w,
                        packs_per_worker=8)
        elastic_fit(la, SKEW_EPOCHS)
        out["lda_skew_rows"] = ledger_fields(eledger.ledger.rows)
        out["lda_skew_after"] = skew.ledger.summary()["lda.epochs"]
        out["lda_skew_ll"] = la.metric()
        # the model's docs are the remapped ids
        out["lda_skew_counts"] = la.model.doc_topic_table().sum(1)[
            la.remap.fwd]
        out["lda_skew_words"] = la.model.word_topic_table().sum(1)
    la = LDAElastic(64, 64, lcfg, mesh, 0, doc_ids=d, word_ids=w,
                    packs_per_worker=8)
    elastic_fit(la, SKEW_EPOCHS, rebalance=False)
    out["lda_plain_ll"] = la.metric()

    # a plan that cannot help is consumed and dropped
    rng = np.random.default_rng(0)
    cu = np.concatenate([rng.integers(0, 16, 4000),
                         rng.integers(16, 64, 200)])
    ci = rng.integers(0, 48, cu.shape[0])
    cv = rng.normal(size=cu.shape[0]).astype(np.float32)
    with telemetry.scope(True):
        ad = MFSGDElastic(64, 48, cfg, mesh, 0, users=cu, items=ci,
                          vals=cv, packs_per_worker=1)
        before = ad.assignment.copy()
        for _ in range(health.TRIGGER_SUPERSTEPS):
            ad.train_one()
        with use_mesh(ad.mesh):
            out["coarse_plan"] = maybe_rebalance(ad)
        out["coarse_same"] = bool(np.array_equal(ad.assignment, before))
        out["coarse_rows"] = list(eledger.ledger.rows)
        out["coarse_again"] = health.monitor.consume_skew_trigger(ad.phase)

    # the home layout is the plain loop
    hu, hi, hv = uniform_ratings(5)
    pcfg = MFSGDConfig(**{**MF_KW, "algo": "pallas"})
    ad = MFSGDElastic(64, 48, pcfg, mesh, 0, users=hu, items=hi, vals=hv)
    elastic_fit(ad, 3)
    m = MFSGD(64, 48, pcfg, mesh, 0)
    m.set_ratings(hu, hi, hv)
    for _ in range(3):
        m.train_epoch()
    Wp, Hp = m.factors()
    st = ad.canonical_state()
    out["home_equal"] = bool(np.array_equal(st["W"], Wp)
                             and np.array_equal(st["H"], Hp))

    # the MF-SGD worker-loss drill: 4 -> 3, resumed from the checkpoint
    lu, li, lv = uniform_ratings(1)
    ck = os.path.join(root, "ck-mf")
    with telemetry.scope(True):
        inj = FaultInjector(seed=0, permanent={"dispatch": (2,)},
                            lost_worker=LOST)
        ad = MFSGDElastic(64, 48, cfg, mesh, 0, users=lu, items=li,
                          vals=lv, max_worker_loss=1)
        ad.install(starts["mf_loss"])
        eledger.reset()
        elastic_fit(ad, LOSS_EPOCHS, ck, ckpt_every=1, fault=inj,
                    rebalance=False)
        out["mf_loss_fired"] = inj.permanent_fired
        out["mf_loss_rows"] = ledger_fields(eledger.ledger.rows)
        out["sat_out"] = ad.sat_out
        if not ad.sat_out:
            st_e = ad.canonical_state()
            out["mf_loss_n"] = ad.mesh.num_workers
            path = os.path.join(root, f"loss-{rank}.jsonl")
            telemetry.export(path)
            out["mf_loss_export"] = [r["event"] for r in
                                     telemetry.load_rows(path)["elastic"]]
    if not ad.sat_out:
        surv = mesh.survivors(LOST)
        with use_mesh(surv):
            step, state = CheckpointManager(ck, replicated=True).restore(0)
        ad2 = MFSGDElastic(64, 48, cfg, surv, 0, users=lu, items=li,
                           vals=lv)
        ad2.install(state)
        for _ in range(step + 1, LOSS_EPOCHS):
            ad2.train_one()
        st_c = ad2.canonical_state()
        out["mf_loss_bitequal"] = bool(
            np.array_equal(st_e["W"], st_c["W"])
            and np.array_equal(st_e["H"], st_c["H"]))
        out["mf_loss_state"] = {k: st_e[k] for k in ("W", "H")}

    # the LDA worker-loss drill
    d, w = uniform_corpus()
    ck = os.path.join(root, "ck-lda")
    inj = FaultInjector(seed=0, permanent={"dispatch": (2,)},
                        lost_worker=1)
    la = LDAElastic(48, 48, lcfg, mesh, 0, doc_ids=d, word_ids=w,
                    max_worker_loss=1)
    elastic_fit(la, LOSS_EPOCHS, ck, ckpt_every=1, fault=inj,
                rebalance=False)
    out["lda_loss_sat_out"] = la.sat_out
    if not la.sat_out:
        st_e = la.canonical_state()
        surv = mesh.survivors(1)
        # a model's readers gather over the group in use: the survivors'
        with use_mesh(surv):
            tab_e = la.model.doc_topic_table()
            step, state = CheckpointManager(ck, replicated=True).restore(0)
        la2 = LDAElastic(48, 48, lcfg, surv, 0, doc_ids=d, word_ids=w)
        la2.install(state)
        for _ in range(step + 1, LOSS_EPOCHS):
            la2.train_one()
        st_c = la2.canonical_state()
        with use_mesh(surv):
            tab_c = la2.model.doc_topic_table()
        out["lda_loss_n"] = la.mesh.num_workers
        out["lda_loss_bitequal"] = bool(
            all(np.array_equal(st_e[k], st_c[k]) for k in ("d", "w", "z"))
            and np.array_equal(tab_e, tab_c))
        out["lda_loss_docs"] = np.bincount(st_e["d"], minlength=48)
        out["lda_loss_words"] = np.bincount(st_e["w"], minlength=48)

    # the loss budget: max_worker_loss=0 fails loudly
    ad = MFSGDElastic(64, 48, cfg, mesh, 0, users=lu, items=li, vals=lv,
                      max_worker_loss=0)
    try:
        elastic_fit(ad, 2, os.path.join(root, "ck-budget"),
                    fault=FaultInjector(seed=0, permanent={"dispatch": (1,)},
                                        lost_worker=0), rebalance=False)
    except PermanentWorkerLoss as e:
        out["budget_exhausted"] = str(e)
    try:
        elastic_fit(ad, 1, None, fault=FaultInjector())
    except ValueError as e:
        out["fault_without_ckpt"] = str(e)

    # streaming KMeans: home = fit_streaming, an uneven layout, a loss
    pts = stream_points()
    ka = KMeansStreamElastic(pts, 4, mesh, 0)
    elastic_fit(ka, 3)
    c, inertia = fit_streaming(pts, 4, 3, 512, mesh=mesh, seed=0)
    out["ks_home"] = (ka.metric(), inertia,
                      bool(np.array_equal(ka.centroids, c)))
    kb = KMeansStreamElastic(pts, 4, mesh, 0, packs_per_worker=2)
    asg = kb.packs.home_assignment()
    asg[:3] = world - 1
    kb.apply_assignment(asg)
    for _ in range(3):
        kb.train_one()
    out["ks_uneven"] = kb.metric()
    inj = FaultInjector(seed=0, permanent={"dispatch": (3,)}, lost_worker=2)
    kc = KMeansStreamElastic(pts, 4, mesh, 0, max_worker_loss=1)
    elastic_fit(kc, 3, os.path.join(root, "ck-ks"), fault=inj)
    out["ks_loss"] = (None if kc.sat_out
                      else (kc.metric(), kc.mesh.num_workers))
    return out


# ---- telemetry: report, steptrace, skew -----------------------------------

def toy_fit_epochs(fit_epochs, injector, ckpt_dir):
    """fit_epochs over a host counter with a ckpt_write fault; returns the
    final state."""
    state = {"x": np.zeros(3, np.float32)}

    def train_one():
        state["x"] = state["x"] + 1.0

    def set_state(s):
        state["x"] = np.asarray(s["x"], np.float32).copy()

    fit_epochs(train_one, lambda: dict(state), set_state, 4, ckpt_dir,
               ckpt_every=1, fault=injector, phase="toy.epochs")
    return state["x"]


def steptrace_structure(rows: list[dict]) -> dict:
    """The timeline's structure, times excluded."""
    runs = [r for r in rows if r.get("ev") == "run"]
    return {"runs": [(r["phase"], r["supersteps"], r["outcomes"])
                     for r in runs],
            "steps": [(r["step"], r["outcome"]) for r in rows
                      if r.get("ev") == "superstep"],
            "marks": [(r["source"], r["name"]) for r in rows
                      if r.get("ev") == "mark"
                      and r["source"] in ("ckpt", "fault")],
            "sources": sorted({r["source"] for r in rows
                               if r.get("ev") == "mark"})}


def kmeans_points():
    return np.random.default_rng(3).normal(size=(4096, 8)).astype(np.float32)


def run_report_cases(rank: int, world: int, root: str) -> dict:
    """KMeans under telemetry on this world, both variants: the live
    report's comm, transfer and skew figures, and an export's kinds."""
    import os

    from harp_tpu_torch import report
    from harp_tpu_torch.models import kmeans as KM
    from harp_tpu_torch.parallel.mesh import WorkerMesh
    from harp_tpu_torch.utils import telemetry

    mesh = WorkerMesh("cpu")
    out: dict = {}
    pts = kmeans_points()
    for variant in ("allreduce", "regroupallgather"):
        with telemetry.scope(True):
            KM.fit(pts, k=8, iters=3, mesh=mesh, variant=variant)
            row, spans = report.live_report()
            out[variant] = {"row": row, "text": report.render(row, spans)}
            if variant == "allreduce":
                path = os.path.join(root, f"kmeans-{rank}.jsonl")
                telemetry.export(path)
                out["export"] = path
    return out


def run_steptrace_cases(rank: int, world: int, root: str) -> dict:
    """The superstep timeline on this world: the toy fit_epochs with a
    ckpt_write fault, KMeans's one superstep and its lanes, MF-SGD's
    epochs, and nothing at all while telemetry is off."""
    import json
    import os

    from harp_tpu_torch.models import kmeans as KM
    from harp_tpu_torch.models import mfsgd as MF
    from harp_tpu_torch.parallel.mesh import WorkerMesh
    from harp_tpu_torch.utils import fault, flightrec, steptrace, telemetry

    mesh = WorkerMesh("cpu")
    out: dict = {}
    with telemetry.scope(True):
        inj = fault.FaultInjector(fail={"ckpt_write": (2,)})
        with inj.arm():
            out["toy_x"] = toy_fit_epochs(fault.fit_epochs, inj,
                                          os.path.join(root, "toy"))
        out["toy"] = steptrace_structure(steptrace.tracer.rows())
        out["toy_summary"] = steptrace.summarize_rows(
            steptrace.tracer.rows())
    pts = kmeans_points()
    with telemetry.scope(True):
        KM.fit(pts, k=8, iters=3, mesh=mesh)
        rows = steptrace.tracer.rows()
        out["kmeans"] = {"summary": steptrace.summarize_rows(rows),
                         "structure": steptrace_structure(rows),
                         "lanes": [r["work"] for r in rows
                                   if r.get("ev") == "lane"],
                         "run": [r for r in rows if r["ev"] == "run"][0]}
        path = os.path.join(root, f"timeline-{rank}.jsonl")
        telemetry.export_timeline(path)
        with open(path) as fh:
            out["timeline_kinds"] = sorted({json.loads(line)["kind"]
                                            for line in fh})
    u, i, v = MF.synthetic_ratings(64, 48, 900, rank=3, seed=0)
    with telemetry.scope(True):
        m = MF.MFSGD(64, 48, MF.MFSGDConfig(rank=4, algo="dense", u_tile=8,
                                             i_tile=8, entry_cap=16),
                     mesh, 0)
        m.set_ratings(u, i, v)
        m.fit(2)
        rows = steptrace.tracer.rows()
        out["mfsgd"] = {"summary": steptrace.summarize_rows(rows),
                        "structure": steptrace_structure(rows),
                        "flight": flightrec.snapshot()}
    telemetry.enable(False)
    c_off = KM.fit(pts, k=8, iters=2, mesh=mesh)
    with telemetry.scope(True):
        c_on = KM.fit(pts, k=8, iters=2, mesh=mesh)
    telemetry.enable(False)
    out["off"] = {"observers": len(flightrec._DISPATCH_OBSERVERS)
                  + len(flightrec._READBACK_OBSERVERS)
                  + len(flightrec._H2D_OBSERVERS)
                  + len(flightrec._CKPT_WRITE_OBSERVERS),
                  "open_run": steptrace.tracer._run is not None,
                  "same": bool(np.array_equal(c_off[0], c_on[0])
                               and c_off[1] == c_on[1])}
    return out


def run_skew_cases(rank: int, world: int, root: str) -> dict:
    """The partition and execution records on this world: MF-SGD (dense
    and scatter), LDA, RF, subgraph counting and KMeans."""
    from harp_tpu_torch import health
    from harp_tpu_torch.models import kmeans as KM
    from harp_tpu_torch.models import lda as L
    from harp_tpu_torch.models import mfsgd as MF
    from harp_tpu_torch.models import rf as RF
    from harp_tpu_torch.models import subgraph as SG
    from harp_tpu_torch.parallel.mesh import WorkerMesh
    from harp_tpu_torch.utils import flightrec, skew, telemetry

    mesh = WorkerMesh("cpu")
    out: dict = {}
    u, i, v = skewed_ratings()
    for algo, kw in (("dense", {"u_tile": 8, "i_tile": 8, "entry_cap": 64}),
                     ("scatter", {"chunk": 64})):
        with telemetry.scope(True):
            m = MF.MFSGD(64, 48, MF.MFSGDConfig(rank=4, algo=algo, **kw),
                         mesh, 0)
            m.set_ratings(u, i, v)
            m.train_epoch()
            out[f"mf-{algo}"] = skew.ledger.summary()
    d, w = skewed_corpus()
    with telemetry.scope(True):
        lda = L.LDA(64, 64, L.LDAConfig(**LDA_KW), mesh, 0)
        lda.set_tokens(d, w)
        lda.sample_epoch()
        out["lda"] = skew.ledger.summary()
    x, y = RF.synthetic_classification(400, 8, seed=0)
    with telemetry.scope(True):
        RF.RandomForest(RF.RFConfig(n_trees=4, max_depth=2), mesh).fit(x, y)
        out["rf"] = skew.ledger.summary()
        out["rf_findings"] = [r["detector"] for r in
                              health.monitor.findings()]
    rng = np.random.default_rng(0)
    edges = np.stack([rng.integers(0, 200, 600),
                      rng.integers(0, 200, 600)], 1)
    with telemetry.scope(True):
        SG.count_template(edges, 200, SG.SubgraphConfig(
            template="u3-path", n_trials=2, max_degree=4), mesh)
        out["subgraph"] = skew.ledger.summary()
        out["subgraph_dispatches"] = flightrec.snapshot()["dispatches"]
    with telemetry.scope(True):
        KM.fit(kmeans_points(), k=8, iters=2, mesh=mesh)
        out["kmeans"] = skew.ledger.summary()
    return out


# ---- the mapper ------------------------------------------------------------

def mapper_files(root: str, n_files: int = 6) -> list[str]:
    """Seeded CSV files of uneven sizes (every worker passes the same)."""
    import os

    rng = np.random.default_rng(7)
    paths = []
    for j in range(n_files):
        p = os.path.join(root, f"part-{j}.csv")
        np.savetxt(p, rng.normal(size=(5 + 7 * j, 3)), delimiter=",",
                   fmt="%.6f")
        paths.append(p)
    return paths


def run_mapper_cases(rank: int, world: int, root: str,
                     paths: list[str]) -> dict:
    import functools
    import json
    import os

    import torch

    from harp_tpu_torch.mapper import CollectiveApp, run_app
    from harp_tpu_torch.parallel import collective as C
    from harp_tpu_torch.parallel.mesh import WorkerMesh
    from harp_tpu_torch.utils import skew, telemetry

    class SumApp(CollectiveApp):
        def map_collective(self):
            total = sum(float(arr.sum()) for _, arr in self.reader)
            s = C.allreduce(torch.tensor([total], dtype=torch.float64))
            self.metrics.log(step=0, total=float(s[0]),
                             workers=self.num_workers)
            return float(s[0])

    loader = functools.partial(np.loadtxt, delimiter=",", ndmin=2)
    metrics = os.path.join(root, f"metrics-{rank}.jsonl")
    out: dict = {}
    with telemetry.scope(True):
        app = SumApp(config="sum", mesh=WorkerMesh("cpu"),
                     metrics_path=metrics, input_paths=paths, loader=loader,
                     budget={"readbacks": 0})
        out["paths"] = app.reader.paths
        out["total"] = app.run()
        out["skew"] = skew.ledger.summary()
        out["master"] = app.is_master()
        out["workers"] = (app.num_workers, app.worker_id)
    with open(metrics) as fh:
        out["metrics"] = [json.loads(line) for line in fh]
    out["run_app"] = run_app(SumApp, "again", mesh=WorkerMesh("cpu"),
                             input_paths=paths, loader=loader)
    return out


# ---- the planner (plan/) -----------------------------------------------------

def run_plan_cases(rank: int, world: int) -> dict:
    """Every registered driver program once on this world's CPU workers:
    its ledger sheet (``plan.ledger_sheet``), the raw CommLedger summary
    of the same run, and its plans on ``single_card`` and ``sim_ring_8``
    (the 8-worker ring's prices; the sheet is this world's)."""
    import torch

    from harp_tpu_torch.analysis.drivers import DRIVERS
    from harp_tpu_torch.plan import planner, topology
    from harp_tpu_torch.utils import telemetry

    out: dict = {"sheets": {}, "ledgers": {}, "plans": {}}
    for name in sorted(DRIVERS):
        fn, args = DRIVERS[name](torch.device("cpu"))
        with telemetry.scope(True):
            with telemetry.ledger.run(name):
                fn(*args)
            summary = telemetry.ledger.summary()
        out["ledgers"][name] = {
            tag: [dict(r) for r in t["verbs"]] for tag, t in summary.items()}
        sheet = planner.ledger_sheet(name, "cpu")
        out["sheets"][name] = sheet
        out["plans"][name] = {
            t: planner.plan_sheet(name, sheet, topology.by_name(t)).row()
            for t in ("single_card", "sim_ring_8", "h100_4x8")}
    return out
