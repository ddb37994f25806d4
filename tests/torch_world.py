"""Spawned gloo worlds for the port's CPU tests, and the work they run.

The children import this module (and through it torch and harp_tpu_torch)
but never JAX: the functions here stay free of ``harp_tpu`` and ``jax``.
One world per test module: a module-scoped fixture runs every case of the
module in one spawn and the tests read its results.  The rendezvous is a
``file://`` under the test's tmp directory, so parallel test workers never
share a port, and every wait has a timeout.
"""

from __future__ import annotations

import multiprocessing
import os
import queue
import sys
import time
import traceback

import numpy as np

WORLD = 4


def _child(rank, world, init_file, target, args, out):
    try:
        import torch
        import torch.distributed as dist

        from harp_tpu_torch.parallel.mesh import init_distributed

        torch.set_num_threads(1)
        init_distributed(f"file://{init_file}", world, rank, backend="gloo",
                         timeout_s=60)
        try:
            result = target(rank, world, *args)
            result["_jax_imported"] = "jax" in sys.modules
        finally:
            dist.destroy_process_group()
        out.put((rank, "ok", result))
    except BaseException:  # reported to the parent, which raises
        out.put((rank, "error", traceback.format_exc()))


def run_world(target, tmp_path, *args, world: int = WORLD,
              timeout: float = 120.0) -> list[dict]:
    """Run ``target(rank, world, *args)`` in ``world`` spawned gloo
    processes; return each rank's result dict, in rank order."""
    ctx = multiprocessing.get_context("spawn")
    out = ctx.Queue()
    init_file = os.path.join(str(tmp_path), "rendezvous")
    procs = [ctx.Process(target=_child, daemon=True,
                         args=(r, world, init_file, target, args, out))
             for r in range(world)]
    for p in procs:
        p.start()
    results: dict[int, dict] = {}
    deadline = time.monotonic() + timeout
    try:
        while len(results) < world:
            try:
                rank, status, payload = out.get(
                    timeout=max(deadline - time.monotonic(), 0.1))
            except queue.Empty:
                raise TimeoutError(
                    f"gloo world gave {len(results)} of {world} results "
                    f"within {timeout} s") from None
            if status != "ok":
                raise RuntimeError(f"worker {rank} failed:\n{payload}")
            results[rank] = payload
    finally:
        for p in procs:
            p.join(timeout=10)
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
    return [results[r] for r in range(world)]


# ---- collective verbs ---------------------------------------------------

OPS = ("add", "max", "min", "avg", "multiply")
DTYPES = ("float32", "int32", "bool")


def collective_cases() -> list[tuple[str, str, dict, str | None, tuple]]:
    """(case id, verb, kwargs, input kind, per-worker shape)."""
    cases = []
    for op in OPS:
        for dt in DTYPES:
            cases.append((f"allreduce-{op}-{dt}", "allreduce", {"op": op},
                          dt, (3, 5)))
            cases.append((f"reduce-{op}-{dt}", "reduce",
                          {"op": op, "root": 1}, dt, (2, 3)))
    for dt in DTYPES:
        cases.append((f"allgather-{dt}", "allgather", {}, dt, (2, 3)))
        for root in (0, 2):
            cases.append((f"broadcast-root{root}-{dt}", "broadcast",
                          {"root": root}, dt, (4,)))
    cases.append(("allgather-untiled", "allgather", {"tiled": False},
                  "float32", (2, 3)))
    # root holds subnormals and -0.0; the others hold NaNs, to be discarded
    cases.append(("broadcast-bits", "broadcast", {"root": 1}, "bits", (6,)))
    for op in ("add", "avg", "max", "min"):
        for dt in ("float32", "int32"):
            cases.append((f"push-{op}-{dt}", "push", {"op": op}, dt, (8, 3)))
        cases.append((f"push-{op}-dim1", "push",
                      {"op": op, "scatter_dim": 1}, "float32", (3, 8)))
    cases.append(("pull-dim0", "pull", {}, "float32", (2, 3)))
    cases.append(("pull-dim1-int32", "pull", {"concat_dim": 1}, "int32",
                  (2, 3)))
    cases.append(("barrier", "barrier", {}, None, ()))
    return cases


def case_inputs(idx: int, kind: str | None, shape: tuple,
                world: int = WORLD) -> np.ndarray:
    """Every worker's input for case ``idx``: [world, *shape]."""
    rng = np.random.default_rng(100 + idx)
    full = (world, *shape)
    if kind == "float32":
        return rng.normal(size=full).astype(np.float32)
    if kind == "int32":
        return rng.integers(-5, 6, size=full).astype(np.int32)
    if kind == "bool":
        return rng.random(full) < 0.5
    if kind == "bits":
        x = np.full(full, np.nan, np.float32)
        x[1] = (rng.normal(size=shape) * 1e-39).astype(np.float32)
        x[1, 0] = -0.0
        return x
    return np.zeros((world,), np.int32)  # barrier takes no input


def run_collective_cases(rank: int, world: int) -> dict:
    import torch

    from harp_tpu_torch.parallel import collective as C
    from harp_tpu_torch.utils import telemetry

    out = {}
    for idx, (cid, verb, kw, kind, shape) in enumerate(collective_cases()):
        if verb == "barrier":
            out[cid] = C.barrier().numpy()
            continue
        x = torch.from_numpy(case_inputs(idx, kind, shape, world)[rank].copy())
        before = x.clone()
        out[cid] = getattr(C, verb)(x, **kw).numpy()
        assert torch.equal(x, before) or kind == "bits", "verb mutated input"
    try:
        C.push(torch.zeros(6, 3))
        out["push-indivisible"] = "no error"
    except ValueError as e:
        out["push-indivisible"] = str(e)
    # one call of each verb on a (tuple, dict) tree, with the ledger on
    with telemetry.scope():
        tree = (torch.ones(4, 2), {"n": torch.ones(3, dtype=torch.int32)})
        with telemetry.ledger.run("verbs", steps=1):
            out["tree-allreduce"] = C.allreduce(tree)
            C.push(torch.ones(8, 2))
            C.pull(torch.ones(2, 2))
        out["ledger"] = telemetry.ledger.summary()["verbs"]
    out["tree-allreduce"] = [out["tree-allreduce"][0].numpy(),
                             out["tree-allreduce"][1]["n"].numpy()]
    return out


# ---- KMeans ----------------------------------------------------------------

#: (case id, fit kwargs) run on every worker of the KMeans world
KMEANS_CASES = [
    ("allreduce", {"k": 8}),
    ("regroupallgather", {"k": 8, "variant": "regroupallgather"}),
    ("allreduce-k3", {"k": 3}),
    ("regroupallgather-k3", {"k": 3, "variant": "regroupallgather"}),
    ("int8-allreduce", {"k": 8, "quantize": "int8"}),
    ("int8-regroupallgather", {"k": 8, "quantize": "int8",
                               "variant": "regroupallgather"}),
    ("pallas-regroupallgather", {"k": 8, "use_pallas": True,
                                 "variant": "regroupallgather"}),
]


def run_kmeans_cases(rank: int, world: int, pts: np.ndarray,
                     iters: int) -> dict:
    from harp_tpu_torch.models import kmeans as KM
    from harp_tpu_torch.parallel.mesh import WorkerMesh, is_master
    from harp_tpu_torch.utils import telemetry

    mesh = WorkerMesh("cpu")
    out = {}
    for cid, kw in KMEANS_CASES:
        with telemetry.scope():
            c, inertia = KM.fit(pts, iters=iters, mesh=mesh, seed=None, **kw)
            out[cid] = {"centroids": c, "inertia": inertia,
                        "ledger": telemetry.ledger.summary()["kmeans.fit"]}
    out["rank"] = mesh.rank
    out["num_workers"] = mesh.num_workers
    out["is_master"] = is_master()
    return out


# ---- rotation --------------------------------------------------------------

ROTATE_SHIFTS = (1, -1, 5)
PIPELINE_CASES = [(nc, wire) for nc in (1, 2, 4)
                  for wire in ("exact", "bf16", "int8")]


def rotate_inputs(world: int = WORLD) -> dict:
    """Every worker's inputs for the rotation cases: [world, ...] arrays."""
    rng = np.random.default_rng(7)
    return {
        "float32": rng.normal(size=(world, 4, 3)).astype(np.float32),
        "int32": rng.integers(-9, 10, size=(world, 4, 3)).astype(np.int32),
        "bool": rng.random((world, 4, 3)) < 0.5,
        "big": (1e3 * rng.normal(size=(world, 6))).astype(np.float32),
        "small": (1e-3 * rng.normal(size=(world, 6))).astype(np.float32),
        # small integers: exact on every wire but int8
        "slice": rng.integers(0, 10, size=(world, 8, 3)).astype(np.float32),
    }


def pipeline_step(lib, wire: str = "exact"):
    """An order-sensitive rotation step for ``lib`` (torch or jax.numpy):
    any change of order, of step or of chunk changes the result.  On the
    exact wire it keeps to integer-valued f32 arithmetic, so it is exact;
    on a quantized wire it is smooth, so one rounding per hop stays
    small."""
    def exact(acc, cur, t):
        acc = lib.remainder(acc * 2 + cur.sum() * (t + 1), 1000003.0)
        return acc, cur + lib.remainder(acc, 7.0)

    def smooth(acc, cur, t):
        acc = acc * 0.5 + cur.sum() * (t + 1)
        return acc, cur * 1.01 + 0.25

    return exact if wire == "exact" else smooth


def run_rotate_cases(rank: int, world: int) -> dict:
    import torch

    from harp_tpu_torch.parallel import collective as C
    from harp_tpu_torch.parallel.rotate import (resident_chunk_index,
                                                rotate_pipeline)
    from harp_tpu_torch.utils import telemetry

    inp = {k: torch.from_numpy(a[rank].copy())
           for k, a in rotate_inputs(world).items()}
    out = {}
    for shift in ROTATE_SHIFTS:
        for dt in ("float32", "int32", "bool"):
            out[f"rotate-{shift}-{dt}"] = C.rotate(inp[dt], shift).numpy()
    tree = {"big": inp["big"], "small": inp["small"], "n": inp["int32"]}
    for name, wd in (("bf16", torch.bfloat16), ("int8", torch.int8)):
        got = C.rotate_quantized(tree, wire_dtype=wd)
        out[f"rq-{name}"] = {k: v.numpy() for k, v in got.items()}
    out["rq-int8-shift-1"] = C.rotate_quantized(
        inp["float32"], -1, wire_dtype=torch.int8).numpy()
    for nc, wire in PIPELINE_CASES:
        acc, sl = rotate_pipeline(pipeline_step(torch, wire), torch.zeros(()),
                                  inp["slice"],
                                  n_chunks=nc, wire=wire)
        out[f"pipe-{nc}-{wire}"] = (acc.numpy(), sl.numpy())
    for nc in (1, 2, 4):
        rows = 8 // nc
        ids = torch.arange(rank * nc, (rank + 1) * nc,
                           dtype=torch.float32).repeat_interleave(rows)

        def check(err, cur, t, nc=nc):
            return err + (cur - resident_chunk_index(t, nc)).abs().sum(), cur

        out[f"resident-{nc}"] = float(rotate_pipeline(
            check, torch.zeros(()), ids[:, None], n_chunks=nc)[0])
    with telemetry.scope():
        for wire in ("exact", "bf16", "int8"):
            with telemetry.ledger.run(wire):
                rotate_pipeline(lambda a, c, t: (a, c), None, inp["slice"],
                                n_chunks=2, wire=wire)
        with telemetry.ledger.run("rotate"):
            C.rotate(inp["slice"])
        out["ledger"] = telemetry.ledger.summary()
    return out


# ---- MF-SGD ----------------------------------------------------------------

#: (case id, MFSGDConfig kwargs) run on every worker of the MF-SGD world
MFSGD_CASES = [
    ("pallas", {"algo": "pallas", "u_tile": 8, "i_tile": 8,
                "entry_cap": 16}),
    ("dense", {"algo": "dense", "u_tile": 8, "i_tile": 8, "entry_cap": 16}),
    ("scatter", {"algo": "scatter", "chunk": 64}),
    ("scatter-chunks4-int8", {"algo": "scatter", "chunk": 64,
                              "rotate_chunks": 4, "rotate_wire": "int8"}),
]
MFSGD_SHAPE = {"n_users": 96, "n_items": 64, "nnz": 3000, "rank": 8}


def mfsgd_case_inputs(kw: dict, n_workers: int, seed: int = 1):
    """Ratings and the initial factors (global, in the storage layout) for
    a case: both packages start from these."""
    from harp_tpu_torch.models import mfsgd as MF

    s = MFSGD_SHAPE
    u, i, v = MF.synthetic_ratings(s["n_users"], s["n_items"], s["nnz"],
                                   rank=4, noise=0.05, seed=seed)
    cfg = MF.MFSGDConfig(rank=s["rank"], **kw)
    nc = MF.rotate_chunks_resolved(cfg)
    if cfg.algo == "scatter":
        u_bound = -(-s["n_users"] // n_workers)
        i_bound = nc * -(-s["n_items"] // (nc * n_workers))
    else:
        _, _, u_bound, ibc = MF._dense_bounds(
            s["n_users"], s["n_items"], n_workers, nc * n_workers,
            *MF.tiles(cfg))
        i_bound = nc * ibc
    rng = np.random.default_rng(seed + 100)
    scale = 1.0 / np.sqrt(s["rank"])
    W0 = rng.uniform(0, scale, (u_bound * n_workers, s["rank"]))
    H0 = rng.uniform(0, scale, (i_bound * n_workers, s["rank"]))
    return u, i, v, W0.astype(np.float32), H0.astype(np.float32)


def run_mfsgd_cases(rank: int, world: int) -> dict:
    import torch

    from harp_tpu_torch import convert
    from harp_tpu_torch.models import mfsgd as MF

    s = MFSGD_SHAPE
    out = {}
    for cid, kw in MFSGD_CASES:
        u, i, v, W0, H0 = mfsgd_case_inputs(kw, world)
        cfg = MF.MFSGDConfig(rank=s["rank"], lr=0.02, reg=0.01,
                             compute_dtype=torch.float32, **kw)
        m = MF.MFSGD(s["n_users"], s["n_items"], cfg, device="cpu",
                     state=convert.mfsgd_state_from_numpy(
                         {"W": W0, "H": H0}, "cpu"))
        m.set_ratings(u, i, v)
        r2 = [m.train_epoch() for _ in range(2)]
        W2, H2 = m.W.numpy().copy(), m.H.numpy().copy()
        r5 = m.train_epochs(3)
        Wf, Hf = m.factors()
        out[cid] = {"rmse": r2 + r5, "W2": W2, "H2": H2, "W": m.W.numpy(),
                    "H": m.H.numpy(), "factors": (Wf, Hf),
                    "predict_rmse": m.predict_rmse(u, i, v)}
    return out


# ---- LDA -------------------------------------------------------------------

#: (case id, LDAConfig kwargs) run on every worker of the LDA world
LDA_CASES = [
    ("pallas", {"algo": "pallas", "d_tile": 16, "w_tile": 16,
                "entry_cap": 64}),
    ("dense", {"algo": "dense", "d_tile": 16, "w_tile": 16,
               "entry_cap": 64, "sampler": "exprace"}),
    ("scatter-chunks4", {"algo": "scatter", "chunk": 64,
                         "sampler": "gumbel", "rotate_chunks": 4}),
]
LDA_SHAPE = {"n_docs": 96, "vocab_size": 64, "n_topics": 8,
             "tokens_per_doc": 50, "seed": 3}


def lda_corpus():
    from harp_tpu_torch.models import lda as L

    s = LDA_SHAPE
    return L.synthetic_corpus(s["n_docs"], s["vocab_size"], 4,
                              s["tokens_per_doc"], seed=0)


def run_lda_cases(rank: int, world: int, noises: dict) -> dict:
    """Every LDA case on this worker: one ``sample_epoch`` under the
    injected draws ``noises[case][rank][t]``, then the tables and the
    ledger of a second epoch on the generator."""
    import torch

    from harp_tpu_torch.models import lda as L
    from harp_tpu_torch.utils import telemetry

    s = LDA_SHAPE
    d, w = lda_corpus()
    out = {}
    for cid, kw in LDA_CASES:
        cfg = L.LDAConfig(n_topics=s["n_topics"], **kw)
        m = L.LDA(s["n_docs"], s["vocab_size"], cfg, device="cpu",
                  seed=s["seed"])
        m.set_tokens(d, w)
        nz = noises[cid][rank]
        m.sample_epoch(noise=lambda t, _s: torch.from_numpy(nz[t]))
        res = {"Ndk": m.Ndk.numpy().copy(), "Nwk": m.Nwk.numpy().copy(),
               "Nk": m.Nk.numpy().copy(), "z_grid": m.z_grid.numpy().copy(),
               "doc_topic": m.doc_topic_table(),
               "word_topic": m.word_topic_table(),
               "token_state": m.token_state(),
               "log_likelihood": m.log_likelihood()}
        with telemetry.scope():
            m.sample_epoch()
            res["ledger"] = telemetry.ledger.summary()["lda.epochs"]
        out[cid] = res
    return out


# ---- reshard -----------------------------------------------------------------

RESHARD_WIRES = ("exact", "bf16", "int8")


def reshard_inputs(world: int = WORLD) -> dict:
    """Every worker's leaves for the reshard cases: [world, ...] arrays (f32;
    the "h" leaf travels as bf16)."""
    rng = np.random.default_rng(11)
    return {
        "x": rng.normal(size=(world, 3, 4)).astype(np.float32),
        "lab": np.sign(rng.normal(size=(world, 3))).astype(np.float32),
        "m": (rng.random((world, 3)) < 0.5).astype(np.float32),
        "ids": rng.integers(-9, 10, size=(world, 3)).astype(np.int32),
        "h": (10 * rng.normal(size=(world, 2, 3))).astype(np.float32),
        "col": rng.normal(size=(world, 2, 3)).astype(np.float32),
    }


def reshard_tree(lib, leaves: dict, bf16) -> tuple:
    """The tree every case moves: (x, lab, m, ids, h as bf16)."""
    return (leaves["x"], leaves["lab"], leaves["m"], leaves["ids"],
            lib.asarray(leaves["h"]).astype(bf16) if lib is not None
            else leaves["h"].to(bf16))


def run_reshard_cases(rank: int, world: int) -> dict:
    import torch

    from harp_tpu_torch.parallel import collective as C
    from harp_tpu_torch.utils import telemetry

    inp = {k: torch.from_numpy(a[rank].copy())
           for k, a in reshard_inputs(world).items()}
    tree = reshard_tree(None, inp, torch.bfloat16)
    S = C.ShardSpec
    out = {}

    def plain(t):
        return [x.to(torch.float32).numpy() if x.is_floating_point()
                else x.numpy() for x in t]

    with telemetry.scope():
        for wire in RESHARD_WIRES:
            with telemetry.ledger.run(wire):
                out[wire] = plain(C.reshard(tree, S.blocked(0),
                                            S.replicated(), wire=wire))
        with telemetry.ledger.run("shift"):
            out["shift"] = plain(C.reshard(tree, S.blocked(0, shift=1),
                                           S.replicated()))
        with telemetry.ledger.run("dim1"):
            out["dim1"] = plain(C.reshard(
                (inp["col"], inp["x"]), (S.blocked(1), S.blocked(0)),
                S.replicated(), wire="int8"))
        with telemetry.ledger.run("identity"):
            same = C.reshard(tree, S.replicated(), S.replicated(),
                             wire="int8")
            out["identity"] = all(a is b for a, b in zip(same, tree))
        out["ledger"] = telemetry.ledger.summary()
    return out


# ---- SVM ---------------------------------------------------------------------

#: (case id, SVMConfig kwargs) run on every worker of the SVM world
SVM_CASES = [(f"{algo}-{wire}", {"algo": algo, "sv_wire": wire})
             for algo in ("xla", "pallas") for wire in RESHARD_WIRES] + [
    ("pallas-xbf16", {"algo": "pallas", "x_dtype": "bf16"})]
SVM_SHAPE = {"n": 203, "d": 12, "inner_steps": 40, "outer_rounds": 3,
             "sv_per_worker": 16}


def svm_data(seed: int = 4):
    """A separable-ish task of SVM_SHAPE (203 rows: ragged over 4)."""
    rng = np.random.default_rng(seed)
    s = SVM_SHAPE
    true_w = rng.normal(size=s["d"]).astype(np.float32)
    x = rng.normal(size=(s["n"], s["d"])).astype(np.float32)
    y = np.sign(x @ true_w + 0.3 * rng.normal(size=s["n"])).astype(
        np.float32)
    y[y == 0] = 1.0
    return x, y


def svm_config_kwargs(kw: dict) -> dict:
    s = SVM_SHAPE
    return {"inner_steps": s["inner_steps"], "outer_rounds": s["outer_rounds"],
            "sv_per_worker": s["sv_per_worker"], **kw}


def run_svm_cases(rank: int, world: int) -> dict:
    from harp_tpu_torch.models import svm as SV
    from harp_tpu_torch.ops import svm_kernel
    from harp_tpu_torch.utils import telemetry

    x, y = svm_data()
    out = {}
    for cid, kw in SVM_CASES:
        with telemetry.scope():
            m = SV.SVM(SV.SVMConfig(**svm_config_kwargs(kw)), device="cpu")
            m.fit(x, y)
            out[cid] = {"w": m.w, "b": m.b, "acc": m.accuracy(x, y),
                        "ledger": telemetry.ledger.summary()["svm.fit"]}
    out["launches"] = dict(svm_kernel.LAUNCHES)  # the CPU never launches
    return out


# ---- WDA-MDS -----------------------------------------------------------------

MDS_CASES = [(f"{algo}-{wire}", {"algo": algo, "coord_wire": wire})
             for algo in ("xla", "pallas") for wire in RESHARD_WIRES] + [
    ("pallas-deltabf16", {"algo": "pallas", "delta_dtype": "bf16"})]
MDS_SHAPE = {"n": 50, "dim": 2, "iters": 20}


def mds_delta(seed: int = 3) -> np.ndarray:
    """Distances of 3-D points, embedded in 2-D (50 rows: ragged over 4)."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(MDS_SHAPE["n"], 3)).astype(np.float32)
    return np.sqrt(((pts[:, None] - pts[None]) ** 2).sum(-1))


def run_mds_cases(rank: int, world: int) -> dict:
    from harp_tpu_torch.models import wdamds as W
    from harp_tpu_torch.utils import telemetry

    delta = mds_delta()
    s = MDS_SHAPE
    out = {}
    for cid, kw in MDS_CASES:
        with telemetry.scope():
            X, stress = W.mds(delta, W.MDSConfig(dim=s["dim"],
                                                 iters=s["iters"], **kw),
                              device="cpu", seed=0)
            out[cid] = {"X": X, "stress": stress,
                        "ledger": telemetry.ledger.summary()["wdamds.mds"]}
    return out


# ---- Random Forest -----------------------------------------------------------

RF_ALGOS = ("dense", "scatter", "pallas")
RF_SHAPE = {"n": 403, "f": 6, "n_bins": 8, "n_trees": 8, "max_depth": 3,
            "feature_fraction": 0.7, "seed": 5}


def rf_data():
    from harp_tpu_torch.models import rf as RF

    s = RF_SHAPE
    return RF.synthetic_classification(s["n"], s["f"], seed=1)


def rf_config_kwargs() -> dict:
    s = RF_SHAPE
    return {k: s[k] for k in ("n_bins", "n_trees", "max_depth",
                              "feature_fraction", "seed")}


def run_rf_cases(rank: int, world: int, draws: list) -> dict:
    """Every arm's forest on this worker under ``draws[rank]`` (the
    reference's), and one fit on the port's own generator."""
    from harp_tpu_torch.models import rf as RF

    x, y = rf_data()
    out = {}
    for algo in RF_ALGOS:
        m = RF.RandomForest(RF.RFConfig(hist_algo=algo, **rf_config_kwargs()),
                            device="cpu")
        m._fit(x, y, draws[rank])
        out[algo] = {"forest": m.forest, "edges": m.edges,
                     "pred": m.predict(x[:100])}
    m = RF.RandomForest(RF.RFConfig(hist_algo="pallas", **rf_config_kwargs()),
                        device="cpu")
    out["own"] = {"acc": m.fit(x, y).accuracy(x, y), "forest": m.forest}
    return out


# ---- long-context attention ----------------------------------------------------

#: (case id, scheme, kwargs, (b, n, h, g, d), seed), run on every worker of
#: the attention world: n = 64 is 16 positions a worker
ATTN_CASES = (
    [(f"ring-c{int(c)}", "ring", {"causal": c}, (2, 64, 4, 4, 16), 0)
     for c in (False, True)]
    + [(f"ring-gqa{g}-c{int(c)}", "ring", {"causal": c}, (2, 64, 4, g, 16), 4)
       for g in (1, 2) for c in (False, True)]
    + [(f"a2a-c{int(c)}-bk{bk}", "a2a", {"causal": c, "block_k": bk},
        (2, 64, 8, 8, 16), 2) for c in (False, True) for bk in (None, 16)]
    + [(f"a2a-gqa-c{int(c)}", "a2a", {"causal": c}, (2, 64, 16, 4, 8), 5)
       for c in (False, True)]
    # window 12 crosses the 16-position shards
    + [(f"window-{s}-c{int(c)}", s, {"causal": c, "window": 12},
        (1, 64, 8, 8, 8), 8) for s in ("ring", "a2a") for c in (False, True)]
    + [(f"window-a2a-bk-c{int(c)}", "a2a",
        {"causal": c, "window": 10, "block_k": 16}, (1, 64, 8, 8, 8), 9)
       for c in (False, True)]
    # windowed MQA with RoPE on the ring
    + [("rope-mqa-window", "ring-rope", {"causal": True, "window": 24},
        (1, 64, 4, 1, 8), 7)])
#: (scheme, window) of the gradient cases: loss = sum(attn(q, k, v)^2)
GRAD_CASES = [(s, w) for s in ("ring", "a2a") for w in (None, 12)]
GRAD_SHAPE = (1, 64, 8, 8, 8)
ROPE_SHAPE = (2, 64, 4, 16)


def attention_inputs(shape: tuple, seed: int) -> tuple:
    """Whole q [b, n, h, d], k and v [b, n, g, d] as f32 numpy."""
    b, n, h, g, d = shape
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, n, h, d)).astype(np.float32)
    k = rng.normal(size=(b, n, g, d)).astype(np.float32)
    v = rng.normal(size=(b, n, g, d)).astype(np.float32)
    return q, k, v


def rope_input(seed: int = 11) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=ROPE_SHAPE).astype(
        np.float32)


def _error_of(fn) -> str:
    try:
        fn()
    except ValueError as e:
        return str(e)
    return "no error"


def run_attention_cases(rank: int, world: int) -> dict:
    import torch

    from harp_tpu_torch.ops import rope as RO
    from harp_tpu_torch.ops.a2a_attention import a2a_attention, \
        make_a2a_attention_fn
    from harp_tpu_torch.ops.ring_attention import make_ring_attention_fn, \
        ring_attention
    from harp_tpu_torch.parallel.mesh import WorkerMesh
    from harp_tpu_torch.utils import telemetry

    def shard(a):
        nl = a.shape[1] // world
        return torch.from_numpy(a[:, rank * nl:(rank + 1) * nl].copy())

    schemes = {"ring": ring_attention, "a2a": a2a_attention}
    out = {}
    for cid, scheme, kw, shape, seed in ATTN_CASES:
        q, k, v = (shard(a) for a in attention_inputs(shape, seed))
        if scheme == "ring-rope":
            o = ring_attention(RO.apply_rope(q), RO.apply_rope(k), v, **kw)
        else:
            o = schemes[scheme](q, k, v, **kw)
        out[cid] = o.numpy()
    for scheme, window in GRAD_CASES:
        q, k, v = (shard(a).requires_grad_()
                   for a in attention_inputs(GRAD_SHAPE, 7))
        (schemes[scheme](q, k, v, causal=True, window=window) ** 2
         ).sum().backward()
        out[f"grad-{scheme}-{window}"] = [t.grad.numpy() for t in (q, k, v)]
    out["rope"] = RO.apply_rope(shard(rope_input())).numpy()
    mesh = WorkerMesh("cpu")
    whole = attention_inputs((2, 64, 8, 8, 16), 2)
    out["host-ring"] = make_ring_attention_fn(mesh, causal=True)(
        *whole).numpy()
    out["host-a2a"] = make_a2a_attention_fn(mesh, causal=True, block_k=16)(
        *whole).numpy()
    out["host-rope"] = RO.make_rope_fn(mesh)(rope_input()).numpy()
    q6 = torch.zeros((1, 16, 6, 8))
    q4, k3 = torch.zeros((1, 16, 4, 8)), torch.zeros((1, 16, 3, 8))
    q16, k2 = torch.zeros((1, 16, 16, 8)), torch.zeros((1, 16, 2, 8))
    out["reject-a2a-heads"] = _error_of(lambda: a2a_attention(q6, q6, q6))
    out["reject-ring-group"] = _error_of(lambda: ring_attention(q4, k3, k3))
    out["reject-a2a-gqa"] = _error_of(lambda: a2a_attention(q16, k2, k2))
    out["reject-ring-window0"] = _error_of(
        lambda: ring_attention(q4, q4, q4, window=0))
    out["reject-a2a-window0"] = _error_of(
        lambda: a2a_attention(q4, q4, q4, window=0))
    q, k, v = (shard(a) for a in attention_inputs((1, 64, 8, 4, 8), 3))
    with telemetry.scope():
        with telemetry.ledger.run("ring"):
            ring_attention(q, k, v, causal=True)
        with telemetry.ledger.run("ring-window"):
            ring_attention(q, k, v, causal=True, window=12)
        with telemetry.ledger.run("a2a"):
            a2a_attention(q, k, v, causal=True)
        out["ledger"] = telemetry.ledger.summary()
    return out


# ---- regroup, dispatch and MoE -------------------------------------------------

MOE_D, MOE_H, MOE_TOKENS = 8, 16, 16  # tokens a worker


def moe_weights(seed: int, n_experts: int = WORLD) -> dict:
    """The reference test's weights for ``n_experts`` experts."""
    rng = np.random.default_rng(seed)
    d, h, e = MOE_D, MOE_H, n_experts
    return {
        "gate": rng.normal(size=(d, e)).astype(np.float32),
        "w1": rng.normal(size=(e, d, h)).astype(np.float32) * 0.5,
        "b1": rng.normal(size=(e, h)).astype(np.float32) * 0.1,
        "w2": rng.normal(size=(e, h, d)).astype(np.float32) * 0.5,
        "b2": rng.normal(size=(e, d)).astype(np.float32) * 0.1,
        "x": rng.normal(size=(e * MOE_TOKENS, d)).astype(np.float32),
    }


def forced_moe_weights(seed: int = 1) -> dict:
    """Every token routed to expert 0 (a positive dot with gate column 0)."""
    w = moe_weights(seed)
    w["gate"] = np.zeros_like(w["gate"])
    w["gate"][:, 0] = 1.0
    w["x"] = np.abs(w["x"])
    return w


#: (case id, weights maker, capacity)
MOE_CASES = [("cap16", lambda: moe_weights(0), 16),
             ("cap4", lambda: moe_weights(0), 4),
             ("forced-cap4", forced_moe_weights, 4)]
#: (case id, split_dim, concat_dim, dtype) of the regroup cases, on per-
#: worker [4, 8, 3]-shaped inputs
REGROUP_CASES = [(f"regroup-{s}-{c}-{dt}", s, c, dt)
                 for s, c in ((0, 0), (0, 1), (1, 0), (1, 2))
                 for dt in ("float32", "int32", "bool")]


def regroup_inputs(world: int = WORLD) -> dict:
    rng = np.random.default_rng(21)
    shape = (world, 4, 8, 3)
    return {"float32": rng.normal(size=shape).astype(np.float32),
            "int32": rng.integers(-9, 10, size=shape).astype(np.int32),
            "bool": rng.random(shape) < 0.5,
            "cot": rng.normal(size=(world, 1, 32, 3)).astype(np.float32)}


def run_moe_cases(rank: int, world: int) -> dict:
    import torch

    from harp_tpu_torch.convert import moe_params_from_numpy
    from harp_tpu_torch.ops.moe import moe_ffn
    from harp_tpu_torch.parallel import collective as C
    from harp_tpu_torch.utils import telemetry

    inp = {k: torch.from_numpy(a[rank].copy())
           for k, a in regroup_inputs(world).items()}
    out = {}
    for cid, s, c, dt in REGROUP_CASES:
        out[cid] = C.regroup(inp[dt], split_dim=s, concat_dim=c).numpy()
    # gradients: regroup [4, 8, 3] -> [1, 32, 3] (split 0, concat 1), and a
    # rotate by 1, each under a weighted sum
    x = inp["float32"].clone().requires_grad_()
    (C.regroup(x, split_dim=0, concat_dim=1) * inp["cot"]).sum().backward()
    out["grad-regroup"] = x.grad.numpy()
    x = inp["float32"].clone().requires_grad_()
    (C.rotate(x, 1) * inp["float32"]).sum().backward()
    out["grad-rotate"] = x.grad.numpy()
    with telemetry.scope():
        with telemetry.ledger.run("regroup"):
            C.regroup((inp["float32"], inp["int32"][0]), split_dim=0)
            C.regroup(inp["float32"], split_dim=1, concat_dim=2)
        out["ledger"] = telemetry.ledger.summary()["regroup"]
    for cid, make, cap in MOE_CASES:
        w = make()
        p = moe_params_from_numpy(w, "cpu", expert=rank)
        xs = torch.from_numpy(
            w["x"][rank * MOE_TOKENS:(rank + 1) * MOE_TOKENS].copy())
        y, dropped = moe_ffn(xs, p["gate"], p["w1"], p["b1"], p["w2"],
                             p["b2"], capacity=cap)
        out[cid] = {"y": y.numpy(), "dropped": int(dropped)}
    return out


# ---- long-context layer --------------------------------------------------------

LONGCTX_SHAPE = {"seq": 64, "heads": 4, "kv_heads": 2, "dim": 8,
                 "window": 12, "steps": 3}


def run_longctx_cases(rank: int, world: int) -> dict:
    from harp_tpu_torch.examples import longctx_layer as L
    from harp_tpu_torch.parallel.mesh import WorkerMesh

    s = LONGCTX_SHAPE
    losses, params = L.run(s["seq"], s["heads"], s["kv_heads"], s["dim"],
                           s["window"], s["steps"], mesh=WorkerMesh("cpu"))
    return {"losses": losses, "params": {k: v.numpy()
                                         for k, v in params.items()}}


# ---- streaming KMeans ------------------------------------------------------------

STREAM_SHAPE = {"n": 1300, "d": 6, "k": 5, "iters": 3, "chunk": 256,
                "files": 3}


def stream_points(seed: int = 11) -> np.ndarray:
    """Separated blobs: both packages stream these rows."""
    s = STREAM_SHAPE
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(s["n"], s["d"]))
            + rng.integers(0, 4, size=(s["n"], 1)) * 6).astype(np.float32)


def stream_split(pts: np.ndarray, rank: int, world: int) -> np.ndarray:
    """Worker ``rank``'s rows for the local-split fit: uneven, rank-major,
    so the concatenation is ``pts``."""
    bounds = np.round(np.linspace(0, len(pts), world + 1) ** 1.1
                      / len(pts) ** 0.1).astype(int)
    return pts[bounds[rank]:bounds[rank + 1]]


def run_stream_cases(rank: int, world: int, pts: np.ndarray,
                     paths: list) -> dict:
    """Every streaming variant on this worker of a gloo world: the local
    split, the single source (each worker its block of every chunk) and
    the file splits (fewer files than workers), f32 and int8, from one
    explicit init; plus the string seedings of the local split."""
    from harp_tpu_torch.models import kmeans_stream as KS
    from harp_tpu_torch.parallel.mesh import WorkerMesh

    s = STREAM_SHAPE
    mesh = WorkerMesh("cpu")
    kw = {"k": s["k"], "iters": s["iters"], "chunk_points": s["chunk"],
          "mesh": mesh, "init": pts[:s["k"]].copy(), "return_history": True}
    mine = stream_split(pts, rank, world)
    out = {}
    for q in (None, "int8"):
        out[f"local-{q}"] = KS.fit_streaming_local(mine, quantize=q, **kw)
        out[f"single-{q}"] = KS.fit_streaming(pts, quantize=q, **kw)
        out[f"files-{q}"] = KS.fit_streaming_files(paths, quantize=q, **kw)
    out["local-f16"] = KS.fit_streaming_local(mine.astype(np.float16), **kw)
    for init in ("random", "kmeans++"):
        out[f"init-{init}"] = KS.fit_streaming_local(
            mine, k=s["k"], iters=0, mesh=mesh, seed=1, init=init)[0]
    return out
