"""Spawned gloo worlds for the port's CPU tests, and the work they run.

The children import this module (and through it torch and harp_tpu_torch)
but never JAX: the functions here stay free of ``harp_tpu`` and ``jax``.
One world per test module: a module-scoped fixture runs every case of the
module in one spawn and the tests read its results.  The rendezvous is a
``file://`` under the test's tmp directory, so parallel test workers never
share a port, and every wait has a timeout.
"""

from __future__ import annotations

import contextlib
import multiprocessing
import os
import queue
import signal
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


@contextlib.contextmanager
def time_limit(seconds: float):
    """Fail the block with TimeoutError after ``seconds`` (SIGALRM, main
    thread): a hang fails one test instead of cutting the whole run."""
    def expire(signum, frame):
        raise TimeoutError(f"test exceeded its {seconds} s limit")

    prev = signal.signal(signal.SIGALRM, expire)
    signal.setitimer(signal.ITIMER_REAL, seconds)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, prev)


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
    ("hier", {"k": 8, "psum_schedule": "hier"}),
    ("int8-hier", {"k": 8, "quantize": "int8", "psum_schedule": "hier"}),
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


def lda_corpus(ragged: bool = False):
    """The LDA test corpus; ``ragged`` keeps 50 - 5·(d mod 5) tokens of doc
    ``d`` and only 10 of each doc in the last quarter, so the workers own
    uneven token counts and the last one whole chunks of padding."""
    from harp_tpu_torch.models import lda as L

    s = LDA_SHAPE
    d, w = L.synthetic_corpus(s["n_docs"], s["vocab_size"], 4,
                              s["tokens_per_doc"], seed=0)
    if not ragged:
        return d, w
    keep_len = np.where(np.arange(s["n_docs"]) >= 3 * s["n_docs"] // 4, 10,
                        50 - 5 * (np.arange(s["n_docs"]) % 5))
    pos = np.arange(d.shape[0]) % s["tokens_per_doc"]
    keep = pos < keep_len[d]
    return d[keep], w[keep]


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
    run_reshard_pairs(rank, world, C, out)
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


# ---- quantized verbs -------------------------------------------------------------

QUANT_WIRES = ("bf16", "int8")


def quantized_inputs(world: int = WORLD) -> dict:
    """Every worker's leaves for the quantized verbs: [world, ...] arrays
    ("h" travels as a bf16 leaf)."""
    rng = np.random.default_rng(31)
    return {
        "x": (3 * rng.normal(size=(world, 4 * world, 6))).astype(np.float32),
        "i": rng.integers(-50, 51, size=(world, 4 * world, 2)).astype(
            np.int32),
        "b": rng.random((world, 4 * world)) < 0.3,
        "h": rng.normal(size=(world, world, 5)).astype(np.float32),
        "c": rng.normal(size=(world, 3, 4 * world)).astype(np.float32),
        "six": (rng.normal(size=(world, 6, 4))
                * np.arange(1, 7)[None, :, None]).astype(np.float32),
    }


def quantized_cases() -> list[tuple[str, str, dict, tuple]]:
    """(case id, verb, kwargs, the leaves of its tree)."""
    cases = []
    for wire in QUANT_WIRES:
        cases += [
            (f"allreduce-{wire}", "allreduce_quantized", {},
             ("x", "i", "b", "h")),
            (f"push-{wire}", "push_quantized", {}, ("x", "i", "b")),
            (f"push-dim1-{wire}", "push_quantized", {"scatter_dim": 1},
             ("c",)),
            (f"regroup-{wire}", "regroup_quantized", {},
             ("x", "i", "b", "h")),
            (f"regroup-1to0-{wire}", "regroup_quantized",
             {"split_dim": 1, "concat_dim": 0}, ("c",)),
            (f"rotate-{wire}", "rotate_quantized", {"shift": 1},
             ("x", "h", "i")),
        ]
    return cases


def quantized_tree(lib, leaves: dict, names: tuple, bf16) -> tuple:
    """The case's tree of ``leaves`` (numpy for the reference, tensors for
    the port), "h" cast to bf16."""
    def one(k):
        if k != "h":
            return leaves[k]
        return (lib.asarray(leaves[k]).astype(bf16) if lib is not None
                else leaves[k].to(bf16))
    return tuple(one(k) for k in names)


def as_numpy(x) -> np.ndarray:
    """A port leaf as numpy (bf16 widened to f32)."""
    import torch

    return (x.to(torch.float32) if x.dtype == torch.bfloat16 else x).numpy()


def run_quantized_cases(rank: int, world: int) -> dict:
    import torch

    from harp_tpu_torch.parallel import collective as C
    from harp_tpu_torch.utils import telemetry

    inp = {k: torch.from_numpy(a[rank].copy())
           for k, a in quantized_inputs(world).items()}
    out = {}
    with telemetry.scope():
        for cid, verb, kw, names in quantized_cases():
            wd = torch.bfloat16 if cid.endswith("bf16") else torch.int8
            tree = quantized_tree(None, inp, names, torch.bfloat16)
            with telemetry.ledger.run(cid):
                got = getattr(C, verb)(tree, wire_dtype=wd, **kw)
            out[cid] = [as_numpy(g) for g in got]
            out[cid + "/dtypes"] = [str(g.dtype) for g in got]
        out["ledger"] = telemetry.ledger.summary()
    # the int8 scales of a six-leaf tree ride ONE stacked MAX allreduce
    maxes = []
    inner = C._all_reduce

    def counting(x, op):
        if op == torch.distributed.ReduceOp.MAX:
            maxes.append(tuple(x.shape))
        return inner(x, op)

    C._all_reduce = counting
    try:
        six = {chr(97 + j): inp["six"][j] for j in range(6)}
        got = C.allreduce_quantized(six, wire_dtype=torch.int8)
        out["six"] = {k: v.numpy() for k, v in got.items()}
    finally:
        C._all_reduce = inner
    out["six-maxes"] = maxes
    return out


# ---- reshard: every pair, chunked rotations, allreduce_hier --------------------

#: every layout of the [8·world, world] pair array: (dim, shift)
PAIR_SPECS = {"R": (None, 0), "S0": (0, 0), "S0s1": (0, 1), "S0s3": (0, 3),
              "S1": (1, 0), "S1s2": (1, 2)}
WIRE_PAIRS = [("S0", "S0s1"), ("S0", "S1"), ("S0s1", "S1s2"),
              ("R", "S0s1"), ("S1", "R"), ("S1s2", "S0")]
HIER_SIZES = (None, 1, 2, 4)


def pair_global(world: int = WORLD, kind: str = "arange") -> np.ndarray:
    if kind == "arange":
        return np.arange(world * 8 * world, dtype=np.float32).reshape(
            world * 8, world)
    rng = np.random.default_rng(13)
    return (3 * rng.normal(size=(world * 8, world))).astype(np.float32)


def pair_block(x: np.ndarray, spec: tuple, rank: int, world: int
               ) -> np.ndarray:
    """Worker ``rank``'s view of the global ``x`` under ``spec``: global
    block ``(rank - shift) % world`` along ``dim``, or all of it."""
    dim, shift = spec
    if dim is None:
        return x.copy()
    bs = x.shape[dim] // world
    blk = (rank - shift) % world
    return np.ascontiguousarray(
        np.take(x, range(blk * bs, (blk + 1) * bs), axis=dim))


def hier_inputs(world: int = WORLD) -> dict:
    rng = np.random.default_rng(17)
    return {"i": rng.integers(-1000, 1000, size=(world, 5)).astype(np.int32),
            "f": rng.normal(size=(world, 7)).astype(np.float32),
            "b": rng.random((world, 6)) < 0.2}


def _error_text(fn) -> str:
    try:
        fn()
    except (ValueError, RuntimeError) as e:
        return f"{type(e).__name__}: {e}"
    return "no error"


def run_reshard_pairs(rank: int, world: int, C, out: dict) -> None:
    """The pair matrix, the narrow wires, chunked rotations and
    allreduce_hier, into ``out`` (called from :func:`run_reshard_cases`)."""
    import torch

    from harp_tpu_torch.utils import telemetry

    S = C.ShardSpec

    def spec(name):
        d, s = PAIR_SPECS[name]
        return S.replicated() if d is None else S.blocked(d, s)

    def view(x, name):
        return torch.from_numpy(pair_block(x, PAIR_SPECS[name], rank, world))

    g = pair_global(world)
    for a in PAIR_SPECS:
        for b in PAIR_SPECS:
            x = view(g, a)
            out[f"pair-{a}-{b}"] = (
                C.reshard(x, spec(a), spec(b)).numpy(),
                C.reshard_reference(x, spec(a), spec(b)).numpy())
    gr = pair_global(world, "normal")
    for wire in ("bf16", "int8"):
        for a, b in WIRE_PAIRS:
            x = view(gr, a)
            out[f"wire-{wire}-{a}-{b}"] = [y.numpy() for y in C.reshard(
                (x, x.to(torch.int32)), spec(a), spec(b), wire=wire)]
    xr = view(gr, "S0")
    for wire in ("exact", "int8"):
        for n_chunks in (1, 2, 4):
            out[f"chunks-{wire}-{n_chunks}"] = C.reshard(
                xr, S.blocked(0), S.blocked(0, 1), wire=wire,
                n_chunks=n_chunks).numpy()
    out["errors"] = {
        "n_chunks-3": _error_text(lambda: C.reshard(
            xr, S.blocked(0), S.blocked(0, 1), n_chunks=3)),
        "n_chunks-gather": _error_text(lambda: C.reshard(
            xr, S.blocked(0), S.replicated(), n_chunks=2)),
        "out-of-range": _error_text(lambda: C.reshard(
            xr, S.blocked(0), S.blocked(5))),
        "indivisible": _error_text(lambda: C.reshard(
            torch.zeros(2, 3), S.blocked(0), S.blocked(1))),
        "hier-3": _error_text(lambda: C.allreduce_hier(
            torch.zeros(2), group_size=3)),
    }
    with telemetry.scope():
        for kw in ({}, {"n_chunks": 4}, {"wire": "int8"}, {"wire": "bf16"}):
            tag = "probe-" + "-".join(f"{k}{v}" for k, v in kw.items())
            with telemetry.ledger.run(tag):
                C.reshard(xr, S.blocked(0), S.blocked(0, 1), **kw)
        h = {k: torch.from_numpy(a[rank].copy())
             for k, a in hier_inputs(world).items()}
        for gs in HIER_SIZES:
            with telemetry.ledger.run(f"hier-{gs}"):
                got = C.allreduce_hier(h, group_size=gs)
            out[f"hier-{gs}"] = {k: v.numpy() for k, v in got.items()}
        out["hier-oneshot"] = {k: v.numpy() for k, v in
                               C.allreduce(h).items()}
        out["ledger-pairs"] = telemetry.ledger.summary()


# ---- tables ------------------------------------------------------------------------

TABLE_SHAPE = {"rows_local": 16, "k": 3, "m": 40, "keys": 20, "pairs": 24}
#: request slots per owner: 3 drops under the Zipf stream, 40 never does
TABLE_CAPS = (3, 10, 40)
KV_COMBINERS = ("add", "max", "min", "avg", "multiply")


def table_inputs(world: int = WORLD) -> dict:
    """Every worker's inputs for the table verbs: a row-sharded f32 table, a
    Zipf-skewed id stream with two out-of-range ids and two padding slots,
    float and integer-valued deltas, and (key, value) pairs."""
    s = TABLE_SHAPE
    rng = np.random.default_rng(41)
    n_rows = world * s["rows_local"]
    ids = ((rng.zipf(1.3, size=(world, s["m"])) - 1) % n_rows).astype(
        np.int32)
    ids[:, 0], ids[:, 1] = -1, n_rows + 5
    valid = np.ones((world, s["m"]), bool)
    valid[:, 2:4] = False
    return {
        "table": rng.normal(size=(n_rows, s["k"])).astype(np.float32),
        "ids": ids, "valid": valid,
        "deltas": rng.normal(size=(world, s["m"], s["k"])).astype(np.float32),
        "ideltas": rng.integers(-3, 4, size=(world, s["m"], s["k"])).astype(
            np.float32),
        "keys": rng.integers(0, s["keys"], size=(world, s["pairs"])).astype(
            np.int32),
        "values": rng.integers(1, 5, size=(world, s["pairs"], 2)).astype(
            np.float32),
        "dense_ids": rng.integers(0, n_rows, size=(world, 12)).astype(
            np.int32),
    }


def kv_tables(lib_table, world: int, combiner: str) -> list:
    """Each worker's KVTable of the (key, value) pairs (an Int2Float table
    for the typed family)."""
    inp = table_inputs(world)
    out = []
    for r in range(world):
        t = lib_table.Int2FloatKVTable(combiner, num_partitions=world)
        for k, v in zip(inp["keys"][r].tolist(), inp["values"][r, :, 0]):
            t.add(k, v)
        out.append(t)
    return out


def run_table_cases(rank: int, world: int) -> dict:
    import torch

    from harp_tpu_torch import benchmark as B
    from harp_tpu_torch import table as T
    from harp_tpu_torch.parallel.mesh import WorkerMesh

    s = TABLE_SHAPE
    inp = table_inputs(world)
    lo = rank * s["rows_local"]
    shard = torch.from_numpy(inp["table"][lo:lo + s["rows_local"]].copy())
    mine = {k: torch.from_numpy(inp[k][rank].copy())
            for k in ("ids", "valid", "deltas", "ideltas", "keys", "values",
                      "dense_ids")}
    ids, valid = mine["ids"], mine["valid"]
    out = {}

    def np_all(t):
        return [x.numpy() if isinstance(x, torch.Tensor) else x for x in t]

    for cap in TABLE_CAPS:
        for v in (None, valid):
            tag = f"{cap}-{'valid' if v is not None else 'all'}"
            out[f"pull-{tag}"] = np_all(T.pull_rows_sparse(
                shard, ids, capacity=cap, valid=v))
            out[f"pull-dedup-{tag}"] = np_all(T.pull_rows_sparse_dedup(
                shard, ids, capacity=cap, valid=v))
            out[f"push-{tag}"] = np_all(T.push_rows_sparse(
                shard, ids, mine["deltas"], capacity=cap, valid=v))
            out[f"push-dedup-{tag}"] = np_all(T.push_rows_sparse_dedup(
                shard, ids, mine["ideltas"], capacity=cap, valid=v))
            out[f"push-raw-int-{tag}"] = np_all(T.push_rows_sparse(
                shard, ids, mine["ideltas"], capacity=cap, valid=v))
    for cap in (2, s["pairs"]):
        got = T.regroup_by_key(mine["keys"], mine["values"], capacity=cap)
        out[f"regroup-{cap}"] = np_all(got)
        out[f"combine-{cap}"] = {
            op: T.combine_by_key(got[0], got[1], s["keys"], op).numpy()
            for op in KV_COMBINERS}
    out["pull_rows"] = T.pull_rows(shard, mine["dense_ids"]).numpy()
    out["push_rows"] = T.push_rows(shard, mine["dense_ids"],
                                   mine["ideltas"][:12]).numpy()
    for op in KV_COMBINERS:
        t = kv_tables(T, world, op)[rank]
        merged = T.kv_allreduce(t)
        out[f"kv-{op}"] = [type(merged).__name__, *merged.to_arrays()]
    out["sweep"] = [(r["dist"], r["capacity"], r["requests_per_worker"],
                     r["dropped"], r["drop_rate"])
                    for r in B.sweep_sparse_capacity(
                        WorkerMesh("cpu"), m=64, d=8, reps=1, label="cpu")]
    return out


# ---- LDA push/pull -----------------------------------------------------------------

#: (case id, LDAConfig kwargs) of the push/pull world: dedup on and off, at
#: the default cap and at caps that drop, both samplers
LDA_PP_CASES = [
    ("dedup", {"algo": "pushpull", "chunk": 64}),
    ("raw-gumbel", {"algo": "pushpull", "chunk": 64, "dedup_pulls": False,
                    "sampler": "gumbel", "rng_impl": "threefry"}),
    ("dedup-cap2", {"algo": "pushpull", "chunk": 64, "pull_cap": 2}),
    ("raw-cap8", {"algo": "pushpull", "chunk": 64, "dedup_pulls": False,
                  "pull_cap": 8}),
    ("dedup-ragged", {"algo": "pushpull", "chunk": 64}),
    ("raw-ragged", {"algo": "pushpull", "chunk": 64, "dedup_pulls": False}),
]


def run_lda_pushpull_cases(rank: int, world: int, noises: dict) -> dict:
    """Every push/pull case on this worker: two ``sample_epoch`` under the
    injected draws ``noises[case][epoch][rank]``, then the ledger of a
    third sweep on the generator; and a sweep at ``suggest_pull_cap``."""
    import torch

    from harp_tpu_torch.models import lda as L
    from harp_tpu_torch.utils import telemetry

    s = LDA_SHAPE
    d, w = lda_corpus()
    out = {}
    for cid, kw in LDA_PP_CASES:
        cfg = L.LDAConfig(n_topics=s["n_topics"], **kw)
        m = L.LDA(s["n_docs"], s["vocab_size"], cfg, device="cpu",
                  seed=s["seed"])
        m.set_tokens(*lda_corpus(ragged="ragged" in cid))
        dropped = []
        for nz in noises[cid]:
            m.sample_epoch(noise=lambda t, _s, a=nz[rank]: torch.from_numpy(a))
            dropped.append(m.last_dropped)
        res = {"Ndk": m.Ndk.numpy().copy(), "Nwk": m.Nwk.numpy().copy(),
               "Nk": m.Nk.numpy().copy(), "z_grid": m.z_grid.numpy().copy(),
               "dropped": dropped, "work": m.last_work.tolist(),
               "doc_topic": m.doc_topic_table(),
               "word_topic": m.word_topic_table(),
               "token_state": m.token_state(),
               "log_likelihood": m.log_likelihood()}
        with telemetry.scope():
            m.sample_epoch()
            res["ledger"] = telemetry.ledger.summary()["lda.epochs"]
        out[cid] = res
    for dedup in (True, False):
        m = L.LDA(s["n_docs"], s["vocab_size"], L.LDAConfig(
            n_topics=s["n_topics"], algo="pushpull", chunk=64,
            dedup_pulls=dedup), device="cpu", seed=s["seed"])
        m.set_tokens(d, w)
        cap = m.suggest_pull_cap(apply=True)
        m.sample_epochs(2)
        out[f"suggest-{dedup}"] = (cap, m.cfg.pull_cap, m.last_dropped)
    return out


# ---- subgraph counting --------------------------------------------------------

#: templates up to u7, plus two with more colors than vertices
SUBGRAPH_TEMPLATES = [("u3-path", 0), ("u3-star", 0), ("u5-path", 0),
                      ("u5-star", 0), ("u5-tree", 0), ("u7-tree", 0),
                      ("u3-path", 5), ("u5-tree", 7)]
SUBGRAPH_CASES = [(f"{t}-k{k}-{algo}", {"template": t, "n_colors": k,
                                        "overflow_algo": algo})
                  for t, k in SUBGRAPH_TEMPLATES
                  for algo in ("segment", "onehot")]
#: a hub-heavy graph: max_degree 4 puts most adjacency on the overflow tail
SUBGRAPH_SHAPE = {"n": 50, "max_degree": 4, "n_trials": 3,
                  "trial_chunk": 2, "seed": 5, "overflow_row_tile": 4,
                  "overflow_entry_tile": 8}


def subgraph_graph(seed: int = 9):
    """Two hubs and random edges on SUBGRAPH_SHAPE["n"] vertices (ragged
    over four workers: 50 pads to 52)."""
    rng = np.random.default_rng(seed)
    n = SUBGRAPH_SHAPE["n"]
    edges = ([(0, i) for i in range(1, n)] + [(1, i) for i in range(2, 30)]
             + [(int(a), int(b)) for a, b in zip(rng.integers(0, n, 90),
                                                 rng.integers(0, n, 90))])
    return np.asarray(edges, np.int64), n


def subgraph_config_kwargs(kw: dict) -> dict:
    s = SUBGRAPH_SHAPE
    return {k: s[k] for k in ("max_degree", "n_trials", "trial_chunk",
                              "seed", "overflow_row_tile",
                              "overflow_entry_tile")} | kw


def run_subgraph_cases(rank: int, world: int) -> dict:
    from harp_tpu_torch.models import subgraph as SG
    from harp_tpu_torch.utils import telemetry

    edges, n = subgraph_graph()
    out = {}
    for cid, kw in SUBGRAPH_CASES:
        cfg = SG.SubgraphConfig(**subgraph_config_kwargs(kw))
        with telemetry.scope():
            est, trials, ovf = SG.count_template(edges, n, cfg, device="cpu")
            led = telemetry.ledger.summary()["subgraph.count"]
        out[cid] = {"estimate": est, "trials": trials, "overflow": ovf,
                    "ledger": led}
    return out


# ---- MLP ----------------------------------------------------------------------

MLP_SIZES = (16, 32, 24, 4)
MLP_CASES = ([(f"{opt}-{wire}-{'zero1' if z else 'dp'}",
               {"optimizer": opt, "grad_wire": wire, "zero1": z})
              for opt in ("sgd", "momentum", "adam")
              for wire in ("f32", "bf16", "int8") for z in (False, True)]
             + [(f"{opt}-half", {"optimizer": opt, "half_precision": True})
                for opt in ("sgd", "momentum", "adam")])
MLP_STEPS = 5


def mlp_data(n: int = 64, seed: int = 1):
    """MNIST-shaped synthetic rows at MLP_SIZES (the reference's
    generator)."""
    rng = np.random.default_rng(seed)
    d, classes = MLP_SIZES[0], MLP_SIZES[-1]
    protos = rng.normal(size=(classes, d)).astype(np.float32)
    y = rng.integers(0, classes, n).astype(np.int32)
    x = 0.5 * protos[y] + rng.normal(size=(n, d)).astype(np.float32) * 0.8
    return x, y


def mlp_config_kwargs(kw: dict) -> dict:
    lr = 0.01 if kw.get("optimizer") == "adam" else 0.05
    return {"sizes": MLP_SIZES, "lr": lr, **kw}


def _tree_np(params) -> list:
    return [{k: v.detach().cpu().numpy().copy() for k, v in p.items()}
            for p in params]


def _state_np(state: dict) -> dict:
    return {k: (v.cpu().numpy().copy() if k == "count"
                else [t.cpu().numpy().copy() for t in v])
            for k, v in state.items()}


def run_mlp_cases(rank: int, world: int, states: dict, fit_params) -> dict:
    """Every DP/ZeRO-1 case from the reference's state (``states[cid]``,
    numpy), MLP_STEPS train_batch steps; fit_resident with one batch an
    epoch and fit through the ingest pipeline; the TP trainer on 2 x 2
    against the DP trainer; the TP validations."""
    from harp_tpu_torch import convert
    from harp_tpu_torch.models import mlp as M
    from harp_tpu_torch.parallel.mesh import mesh_2d
    from harp_tpu_torch.utils import telemetry

    x, y = mlp_data()
    out = {}
    for cid, kw in MLP_CASES:
        cfg = M.MLPConfig(**mlp_config_kwargs(kw))
        tr = M.MLPTrainer(cfg, device="cpu",
                          state=convert.mlp_params_from_numpy(states[cid],
                                                              "cpu"))
        with telemetry.scope():
            with telemetry.ledger.run("mlp.step", steps=MLP_STEPS):
                hist = [tr.train_batch(x, y) for _ in range(MLP_STEPS)]
            led = telemetry.ledger.summary()["mlp.step"]
        out[cid] = {"hist": hist, "params": _tree_np(tr.params),
                    "opt_state": _state_np(tr.opt_state), "ledger": led}
    # from the warm params alone (a fresh optimizer state): the test holds
    # four workers to one on the full batch
    for cid in ("sgd-f32-dp", "adam-f32-zero1"):
        cfg = M.MLPConfig(**mlp_config_kwargs(dict(MLP_CASES)[cid]))
        state = {"params": states[cid]["params"]}
        tr = M.MLPTrainer(cfg, device="cpu",
                          state=convert.mlp_params_from_numpy(state, "cpu"))
        out[f"full-{cid}"] = {
            "hist": [tr.train_batch(x, y) for _ in range(MLP_STEPS)],
            "params": _tree_np(tr.params)}
    # fit_resident, one batch an epoch (the order is then trivial), and
    # fit through the ingest pipeline (numpy's batch order, as the
    # reference's)
    for opt in ("momentum", "adam"):
        cfg = M.MLPConfig(**mlp_config_kwargs({"optimizer": opt}))
        state = {"params": fit_params}
        tr = M.MLPTrainer(cfg, device="cpu",
                          state=convert.mlp_params_from_numpy(state, "cpu"))
        tr.load_resident(x, y, batch_size=len(x))
        out[f"resident-{opt}"] = {"hist": tr.fit_resident(epochs=4),
                                  "params": _tree_np(tr.params)}
        tr = M.MLPTrainer(cfg, device="cpu",
                          state=convert.mlp_params_from_numpy(state, "cpu"))
        out[f"fit-{opt}"] = {"hist": tr.fit(x, y, batch_size=16, epochs=2),
                             "params": _tree_np(tr.params)}
    # TP on 2 x 2 against the DP trainer, the same params and batches
    cfg = M.MLPConfig(**mlp_config_kwargs({"optimizer": "momentum"}))
    state = convert.mlp_params_from_numpy({"params": fit_params}, "cpu")
    tp = M.TPMLPTrainer(cfg, mesh_2d(2, 2, "cpu"), state=state)
    dp = M.MLPTrainer(cfg, device="cpu", state=state)
    tp_hist = [tp.train_batch(x, y) for _ in range(3)]
    dp_hist = [dp.train_batch(x, y) for _ in range(3)]
    out["tp"] = {"hist": tp_hist, "params": tp.full_params(),
                 "local_w0": tuple(tp.params[0]["w"].shape),
                 "local_w1": tuple(tp.params[1]["w"].shape),
                 "dp_hist": dp_hist, "dp_params": _tree_np(dp.params)}
    # the default mesh: the largest model axis dividing the sharded dims
    tpd = M.TPMLPTrainer(M.MLPConfig(sizes=(16, 32, 8)), device="cpu")
    out["tp_default"] = {"shape": (tpd.mesh.n_data, tpd.mesh.n_model),
                         "loss": tpd.train_batch(*mlp_data(64, 2))[0]}
    errors = {}
    for name, fn in (
            ("divisible", lambda: M.TPMLPTrainer(
                M.MLPConfig(sizes=(16, 10, 8)), mesh_2d(1, 4, "cpu"))),
            ("batch", lambda: M.TPMLPTrainer(
                M.MLPConfig(sizes=(16, 32, 8)), mesh_2d(2, 2, "cpu")
            ).train_batch(*mlp_data(63))),
            ("mesh", lambda: mesh_2d(4, 4, "cpu"))):
        try:
            fn()
            errors[name] = None
        except ValueError as e:
            errors[name] = str(e)
    out["errors"] = errors
    out["zero1_len"] = M.zero1_shard_len(M.MLPConfig(sizes=MLP_SIZES), world)
    return out


# ---- CCD++ --------------------------------------------------------------------

#: 130 users split ragged over four workers (u_bound 33, the last short)
CCD_SHAPE = {"n_users": 130, "n_items": 96, "nnz": 8000, "rank": 8,
             "reg": 0.05, "epochs": 3}


def ccd_ratings():
    """Low-rank ratings (the reference's synthetic_ratings) at CCD_SHAPE."""
    s = CCD_SHAPE
    rng = np.random.default_rng(0)
    Wt = rng.normal(size=(s["n_users"], 4)) / np.sqrt(4)
    Ht = rng.normal(size=(s["n_items"], 4)) / np.sqrt(4)
    u = rng.integers(0, s["n_users"], s["nnz"])
    i = rng.integers(0, s["n_items"], s["nnz"])
    v = (Wt[u] * Ht[i]).sum(-1) + 0.05 * rng.normal(size=s["nnz"])
    return u.astype(np.int32), i.astype(np.int32), v.astype(np.float32)


def run_ccd_cases(rank: int, world: int, W0: np.ndarray,
                  H0: np.ndarray) -> dict:
    from harp_tpu_torch import convert
    from harp_tpu_torch.models import ccd as CC
    from harp_tpu_torch.utils import telemetry

    s = CCD_SHAPE
    m = CC.CCD(s["n_users"], s["n_items"],
               CC.CCDConfig(rank=s["rank"], reg=s["reg"]), device="cpu",
               state=convert.ccd_state_from_numpy({"W": W0, "H": H0}, "cpu"))
    m.set_ratings(*ccd_ratings())
    with telemetry.scope():
        rmses = m.train_epochs(s["epochs"])
        led = telemetry.ledger.summary()["ccd.epochs"]
    return {"rmses": rmses, "W": m.W.numpy().copy(),
            "H": m.H.numpy().copy(), "ledger": led}


# ---- real-data readers -------------------------------------------------------

def run_datasource_cases(rank: int, world: int, paths: list) -> dict:
    """Each worker streams its own files of a mixed split directory."""
    from harp_tpu_torch.native.datasource import FileSplits

    out = {}
    with FileSplits(paths, world, [rank], chunk_rows=64) as fs:
        blocks = []
        while True:
            blk = fs.next_block(rank, 50)
            if blk.shape[0] == 0:
                break
            blocks.append(blk)
        out["rows"] = fs.rows(rank)
        out["block"] = (np.concatenate(blocks) if blocks
                        else np.zeros((0, fs.cols), np.float32))
        out["amax"] = fs.amax()
    return out


# ---- the stats suite ---------------------------------------------------------

def stats_inputs(seed: int = 0) -> dict:
    """Seeded inputs of every stats app: 203 rows (ragged over 4 workers),
    features with a mean offset and distinct scales (separated
    eigenvalues), a target with an intercept, class labels, and ratings."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(203, 6)) * np.array([3.0, 2.0, 1.5, 1.0, 0.7, 0.4])
         + 2.0).astype(np.float32)
    # regression rows without the offset: the normal equations square the
    # condition number, and with it f32 solves in either package scatter
    # the intercept at ~3e-5 relative
    xr = (x - 2.0).astype(np.float32)
    w = rng.normal(size=6)
    y = (xr @ w + 1.5 + 0.1 * rng.normal(size=203)).astype(np.float32)
    return {"x": x, "xr": xr, "y": y, "y2": np.stack([y, 2.0 * y - 1.0], 1),
            "cls": rng.integers(0, 3, 203).astype(np.int32),
            "users": rng.integers(0, 37, 1500).astype(np.int32),
            "items": rng.integers(0, 23, 1500).astype(np.int32),
            "vals": rng.normal(size=1500).astype(np.float32)}


def stats_results(S, inp: dict, device) -> dict:
    """Every app of the port's stats module on ``inp``."""
    x = inp["x"]
    out = {"moments": S.moments(x, device=device),
           "cov": S.covariance(x, device=device),
           "pca": S.pca(x, device=device),
           "nb": S.naive_bayes_fit(np.abs(x), inp["cls"], 3, device=device),
           "lin": S.linear_regression(inp["xr"], inp["y"], device=device),
           "lin2": S.linear_regression(inp["xr"], inp["y2"], device=device),
           "ridge": S.ridge_regression(inp["xr"], inp["y"], l2=2.0,
                                       device=device),
           "ridge0": S.ridge_regression(inp["xr"], inp["y2"], l2=2.0,
                                        fit_intercept=False, device=device),
           "qr": S.tsqr(x, device=device),
           "svd": S.svd(x, device=device),
           "als": S.als(inp["users"], inp["items"], inp["vals"], 37, 23,
                        rank=4, iters=3, device=device)}
    out["nb_pred"] = S.naive_bayes_predict(out["nb"], np.abs(x))
    return out


def run_stats_cases(rank: int, world: int) -> dict:
    from harp_tpu_torch.models import stats as S

    out = stats_results(S, stats_inputs(), "cpu")
    try:
        S.tsqr(np.ones((12, 6), np.float32), device="cpu")
    except ValueError as e:
        out["tsqr_error"] = str(e)
    return out


# ---- weighted WDA-MDS --------------------------------------------------------

WMDS_SHAPE = {"n": 50, "dim": 2, "iters": 15, "cg_iters": 10}


def wmds_inputs(seed: int = 5) -> tuple:
    """(Δ, W): distances of 3-D points (50 rows, ragged over 4 workers),
    with a seeded symmetric 10 % of the pairs weighted 0 and their δ
    corrupted ×5; the other weights in [0.5, 1.5].  The weight graph stays
    connected, and 15 SMACOF iterations of 10 CG steps stop far from
    convergence, so no CG guard sits near its threshold."""
    rng = np.random.default_rng(seed)
    n = WMDS_SHAPE["n"]
    pts = rng.normal(size=(n, 3)).astype(np.float32)
    delta = np.sqrt(((pts[:, None] - pts[None]) ** 2).sum(-1))
    w = rng.uniform(0.5, 1.5, size=(n, n)).astype(np.float32)
    w = (w + w.T) / 2
    ii, jj = np.triu_indices(n, 1)
    sel = rng.choice(len(ii), size=len(ii) // 10, replace=False)
    w[ii[sel], jj[sel]] = w[jj[sel], ii[sel]] = 0.0
    delta[ii[sel], jj[sel]] *= 5.0
    delta[jj[sel], ii[sel]] *= 5.0
    return delta.astype(np.float32), w


def run_mds_weighted_cases(rank: int, world: int) -> dict:
    from harp_tpu_torch.models import wdamds as W
    from harp_tpu_torch.utils import telemetry

    delta, w = wmds_inputs()
    s = WMDS_SHAPE
    cfg = W.MDSConfig(dim=s["dim"], iters=s["iters"], cg_iters=s["cg_iters"])
    with telemetry.scope():
        X, stress = W.mds(delta, cfg, device="cpu", seed=0, weights=w)
        led = telemetry.ledger.summary()["wdamds.mds"]
    return {"X": X, "stress": stress, "ledger": led}


# ---- SVM's sparse path -------------------------------------------------------

SVM_SPARSE_WIRES = ("exact", "bf16")


def svm_sparse_data(seed: int = 6, n: int = 203, d: int = 40,
                    density: float = 0.15):
    """Sparse rows of a seeded hyperplane task (203 rows, ragged over 4),
    as ELL (ids, vals, mask), plus the dense rows and labels."""
    from harp_tpu_torch.native.datasource import csr_to_ell

    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(n, d)) * (rng.random((n, d)) < density)).astype(
        np.float32)
    y = np.sign(x @ rng.normal(size=d) + 0.05).astype(np.float32)
    y[y == 0] = 1.0
    r, c = np.nonzero(x)
    indptr = np.concatenate([[0], np.cumsum((x != 0).sum(1))])
    return csr_to_ell(indptr, c, x[r, c]), x, y


def run_svm_sparse_cases(rank: int, world: int) -> dict:
    from harp_tpu_torch.models import svm as SV

    (ids, vals, mask), x, y = svm_sparse_data()
    s = SVM_SHAPE
    out = {}
    for wire in SVM_SPARSE_WIRES:
        cfg = SV.SVMConfig(inner_steps=s["inner_steps"],
                           outer_rounds=s["outer_rounds"],
                           sv_per_worker=s["sv_per_worker"], sv_wire=wire)
        m = SV.SVM(cfg, device="cpu").fit_sparse(ids, vals, mask, y,
                                                 x.shape[1])
        out[wire] = {"w": m.w, "b": m.b}
    return out


# ---- checkpoint / fault recovery ---------------------------------------------

#: trainer -> fail_at iterations: one after the first checkpoint, one
#: before it (every trainer checkpoints after iteration 1 or chunk 0)
RECOVERY_FAILS = {"after": (3,), "before": (0,)}
RECOVERY_TRAINERS = ("kmeans-f32", "kmeans-int8", "mfsgd", "lda", "ccd",
                     "mlp", "stream-f32", "stream-int8")
REC_MF = {"algo": "dense", "u_tile": 8, "i_tile": 8, "entry_cap": 64}


def recovery_points(seed: int = 3) -> np.ndarray:
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(4, 6)) * 6
    return (centers[rng.integers(0, 4, 256)]
            + rng.normal(size=(256, 6))).astype(np.float32)


def recovery_mlp_data():
    rng = np.random.default_rng(2)
    return (rng.normal(size=(64, 16)).astype(np.float32),
            rng.integers(0, 4, 64).astype(np.int32))


def recovery_run(name: str, ckpt_dir, fail_at, starts: dict):
    """One port trainer run → its result arrays.  ``ckpt_dir`` None is the
    uninterrupted run; else ``fail_at`` (iterations, or None) injects
    worker failures that the recovery loop absorbs."""
    import torch

    from harp_tpu_torch import convert
    from harp_tpu_torch.models import ccd as CC
    from harp_tpu_torch.models import kmeans as KM
    from harp_tpu_torch.models import kmeans_stream as KS
    from harp_tpu_torch.models import lda as L
    from harp_tpu_torch.models import mfsgd as MF
    from harp_tpu_torch.models import mlp as M
    from harp_tpu_torch.utils.fault import FaultInjector

    kw = {} if ckpt_dir is None else {"ckpt_dir": ckpt_dir}
    if fail_at is not None:
        kw["fault"] = FaultInjector(fail_at=fail_at)
    if name.startswith("kmeans"):
        q = "int8" if name.endswith("int8") else None
        c, inertia = KM.fit(recovery_points(), k=4, iters=8, seed=0,
                            device="cpu", quantize=q, ckpt_every=2, **kw)
        return {"c": c, "inertia": np.float64(inertia)}
    if name.startswith("stream"):
        q = "int8" if name.endswith("int8") else None
        c, inertia, hist = KS.fit_streaming(
            recovery_points(), k=4, iters=5, chunk_points=96, seed=0,
            device="cpu", quantize=q, return_history=True, ckpt_every=1,
            **kw)
        return {"c": c, "hist": hist}
    if name == "mfsgd":
        u, i, v, W0, H0 = starts["mfsgd"]
        m = MF.MFSGD(96, 64, MF.MFSGDConfig(rank=8, **REC_MF), device="cpu",
                     state=convert.mfsgd_state_from_numpy(
                         {"W": W0, "H": H0}, "cpu"))
        m.set_ratings(u, i, v)
        m.fit(5, ckpt_every=2, **kw)
        return {"W": m.W.numpy().copy(), "H": m.H.numpy().copy()}
    if name == "lda":
        m = L.LDA(32, 40, L.LDAConfig(n_topics=4, algo="dense", d_tile=8,
                                     w_tile=8, entry_cap=32),
                  device="cpu", seed=1)
        m.set_tokens(*L.synthetic_corpus(32, 40, 2, tokens_per_doc=12,
                                         seed=1))
        m.fit(5, ckpt_every=2, **kw)
        return {"Ndk": m.doc_topic_table(), "Nwk": m.word_topic_table(),
                "z": m.z_grid.numpy().copy()}
    if name == "ccd":
        u, i, v, W0, H0 = starts["ccd"]
        m = CC.CCD(64, 48, CC.CCDConfig(rank=4), device="cpu",
                   state=convert.ccd_state_from_numpy({"W": W0, "H": H0},
                                                      "cpu"))
        m.set_ratings(u, i, v)
        m.fit(5, ckpt_every=2, **kw)
        return {"W": m.W.numpy().copy(), "H": m.H.numpy().copy()}
    if name == "mlp":
        x, y = recovery_mlp_data()
        tr = M.MLPTrainer(M.MLPConfig(sizes=(16, 32, 4), lr=0.05,
                                      optimizer="momentum"), device="cpu",
                          state=convert.mlp_params_from_numpy(
                              starts["mlp"], "cpu"))
        # one batch an epoch: the batch order is then trivial, as the
        # reference comparison needs
        hist = tr.fit_ckpt(x, y, 5, kw.pop("ckpt_dir", None), batch_size=64,
                           ckpt_every=2, **kw)
        out = {f"{i}{k}": p[k].numpy().copy()
               for i, p in enumerate(tr.params) for k in p}
        out["hist"] = np.asarray(hist)
        return out
    raise ValueError(name)


def run_fault_cases(rank: int, world: int, root: str, starts: dict) -> dict:
    out = {}
    for name in RECOVERY_TRAINERS:
        out[name] = {"clean": recovery_run(name, None, None, starts)}
        for when, fail_at in RECOVERY_FAILS.items():
            out[name][when] = recovery_run(
                name, os.path.join(root, f"{name}-{when}"), fail_at, starts)
    return out


# ---- pipeline and broadcast's gradient -----------------------------------

PIPE_WIDTH, PIPE_MB = 16, 4
PIPE_MS = (1, 3, 8)
PIPE_GRAD_M = 4
BCAST_ROOTS = (0, WORLD - 1)


def pipeline_inputs(m: int, world: int = WORLD, seed: int = 0) -> dict:
    """Stacked stage params for ``world`` stages, microbatches and
    targets, made from ``seed``."""
    rng = np.random.default_rng(seed + m)
    return {"w": rng.normal(size=(world, PIPE_WIDTH, PIPE_WIDTH)
                            ).astype(np.float32) * 0.5,
            "b": rng.normal(size=(world, PIPE_WIDTH)).astype(np.float32)
            * 0.1,
            "x": rng.normal(size=(m, PIPE_MB, PIPE_WIDTH)).astype(
                np.float32),
            "t": rng.normal(size=(m, PIPE_MB, PIPE_WIDTH)).astype(
                np.float32)}


def bcast_inputs(world: int = WORLD, seed: int = 5) -> dict:
    """Each worker's broadcast input and its cotangent weights."""
    rng = np.random.default_rng(seed)
    return {"x": rng.normal(size=(world, 6)).astype(np.float32),
            "w": rng.normal(size=(world, 6)).astype(np.float32)}


def pipe_stage(params, h):
    import torch

    return torch.tanh(h @ params["w"] + params["b"])


def pipe_loss(outs, targets):
    return ((outs - targets) ** 2).mean()


def run_pipeline_cases(rank: int, world: int) -> dict:
    import torch

    from harp_tpu_torch.parallel import collective as C
    from harp_tpu_torch.parallel.pipeline import (pipeline_forward,
                                                  pipeline_loss_and_grads)

    out = {}
    for m in PIPE_MS:
        d = pipeline_inputs(m, world)
        p = {"w": torch.tensor(d["w"][rank]), "b": torch.tensor(d["b"][rank])}
        out[f"fwd-{m}"] = pipeline_forward(pipe_stage, p, d["x"],
                                           device="cpu").numpy()
    d = pipeline_inputs(PIPE_GRAD_M, world)
    p = {"w": torch.tensor(d["w"][rank]), "b": torch.tensor(d["b"][rank])}
    loss, g = pipeline_loss_and_grads(pipe_stage, pipe_loss, p, d["x"],
                                      d["t"], device="cpu")
    out["loss"] = float(loss)
    out["gw"], out["gb"] = g["w"].numpy(), g["b"].numpy()
    bi = bcast_inputs(world)
    for root in BCAST_ROOTS:
        x = torch.tensor(bi["x"][rank]).requires_grad_()
        y = C.broadcast(x, root=root)
        (torch.tensor(bi["w"][rank]) * y).sum().backward()
        out[f"bcast-{root}"] = y.detach().numpy()
        out[f"bcast-grad-{root}"] = x.grad.numpy()
    return out


# ---- serving -------------------------------------------------------------

#: MF-SGD top-k on a ragged item count: 250 items pad to 252 on 4 workers
SERVE_MF = {"n_users": 64, "n_items": 250, "rank": 8}
SERVE_TOPK = 10
SERVE_RUNG = 8


def serve_mf_inputs(seed: int = 3) -> dict:
    """Factors with distinct scores, and one rung of users."""
    rng = np.random.default_rng(seed)
    s = SERVE_MF
    return {"W": rng.normal(size=(s["n_users"], s["rank"])).astype(
                np.float32),
            "H": rng.normal(size=(s["n_items"], s["rank"])).astype(
                np.float32),
            "users": rng.integers(0, s["n_users"], SERVE_RUNG).astype(
                np.int32)}


class FakeCapture:
    """The card's graph capture, stood in for on the CPU: ``fn`` runs once
    at capture for its static output, and every replay recomputes into
    that same buffer from the static input ``fn`` reads — as a CUDA graph
    writes its fixed output.  It records the labels it captured, the
    replays, and the output buffers' addresses (which must never
    change)."""

    def __init__(self):
        self.labels: list[str] = []
        self.replays = 0
        self.ptrs: dict[str, int] = {}

    def __call__(self, fn, label):
        out = fn()
        self.labels.append(label)
        leaves = list(out) if isinstance(out, (tuple, list)) else [out]
        self.ptrs[label] = [t.data_ptr() for t in leaves]

        def replay():
            self.replays += 1
            new = fn()
            news = list(new) if isinstance(new, (tuple, list)) else [new]
            for dst, src in zip(leaves, news):
                dst.copy_(src)
            assert [t.data_ptr() for t in leaves] == self.ptrs[label]

        return replay, out


def serve_mf_requests() -> list[dict]:
    """Requests spanning the rungs (one oversized, spanning batches)."""
    d = serve_mf_inputs()
    u = d["users"].tolist()
    return [{"id": i, "users": u[:n]} for i, n in enumerate((1, 3, 8, 2))] \
        + [{"id": "big", "users": (u * 3)[:19]}]


def run_serve_cases(rank: int, world: int) -> dict:
    import torch

    from harp_tpu_torch.parallel.mesh import WorkerMesh
    from harp_tpu_torch.serve.engines import MFSGDTopK
    from harp_tpu_torch.serve.server import Server

    d = serve_mf_inputs()
    state = {"W": d["W"], "H": d["H"]}
    eng = MFSGDTopK(state, WorkerMesh("cpu"), topk=SERVE_TOPK)
    out = {"step": eng.step()(*eng.state_args(),
                              torch.from_numpy(d["users"])).numpy()}
    reqs = serve_mf_requests()
    eager = Server("mfsgd", state, device="cpu", ladder=(1, 8),
                   engine_opts={"topk": SERVE_TOPK})
    eager.startup()
    fake = FakeCapture()
    graphed = Server("mfsgd", state, device="cpu", ladder=(1, 8),
                     engine_opts={"topk": SERVE_TOPK}, capture=fake)
    info = graphed.startup()
    out["eager"] = eager.process(reqs)
    out["graphed"] = graphed.process(reqs)
    runner = graphed.make_runner(clock=lambda: 0.0)
    got = []
    for i, r in enumerate(reqs):
        got += runner.submit(i, r, now=0.0)
        got += runner.step(0.0)
    got += runner.drain(0.0)
    out["runner"] = [resp for _, resp in sorted(got, key=lambda kv: kv[0])]
    out["captures"] = info["captures"]
    out["labels"] = fake.labels
    out["replays"] = fake.replays
    return out
