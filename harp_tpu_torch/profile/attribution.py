"""Wall attribution, op → mechanism bucket: the port of
``harp_tpu.profile.attribution``.

Every device op from one captured run of a registered driver program
(:mod:`harp_tpu_torch.analysis.drivers`) is classified into the frozen
six-term mechanism vocabulary (:data:`BUCKETS`):

- ``mxu``          — matrix products: tensor-core and cuBLAS/CUTLASS GEMMs
- ``elementwise``  — memory-bound passes: elementwise, reductions, copies
- ``gather_dus``   — gathers, index selects, slices
- ``scatter``      — scatters, index adds, atomics, histograms
- ``wire``         — collective traffic (NCCL, gloo)
- ``overhead``     — runtime, launch and copy spans + unattributed wall

The reference's classifier reads XLA op names, and its ``"::"`` rule sends
every ``aten::`` op to ``overhead``.  This one reads CUDA kernel and ATen
names (:func:`classify`).  The port's own kernels are matched by their
symbols in ``harp_tpu_torch/csrc/*.cu`` and land in the bucket of their
mechanism:

=====  =================================================  =============
K      symbol (demangled trace name)                      bucket
=====  =================================================  =============
K1     ``km::main_kernel<km::Int8Traits, …>``             ``mxu``
K1     ``km::range_kernel<km::Int8Traits>``               ``scatter``
K1     ``pack_kernel(signed char const*, …)``             ``elementwise``
K2     ``km::main_kernel<km::Bf16Traits<…>, …>``          ``mxu``
K2     ``km::range_kernel<km::Bf16Traits<…>>``            ``scatter``
K2     ``pack_kernel(float const*, …)``, ``reduce_kernel``  ``elementwise``
K3     ``sgd_step_kernel``                                ``gather_dus``
K4     ``step_kernel<…>``                                 ``scatter``
K5     ``rows_kernel<…>``, ``tile_kernel<…>``             ``elementwise``
K6     ``bx_kernel<…>``                                   ``elementwise``
K7     ``hist_kernel<…>``                                 ``scatter``
K8     ``simt_kernel<…>``, ``wgmma_kernel<…>``            ``mxu``
=====  =================================================  =============

(K1/K2's main kernel scores on the tensor cores; their range pass and
K4's and K7's updates are scatter-adds by index; K3 gathers rows and
writes them back; K5 and K6 stream their matrix once on the CUDA cores,
bound by bytes.)

The pass is fail-closed and reconciled against the port's other spines:

- bucket seconds sum to the measured wall exactly by construction
  (unattributed wall lands in ``overhead``; over-attribution beyond
  :data:`SUM_REL_TOL` fails the row, the residual is ``sum_rel_err``);
- dispatch counts match the flight recorder (``dispatches == reps *
  dispatches_per_rep``, no kernel build or graph capture in the timed
  window);
- ``wire_bytes`` and ``wire_sites`` are the CommLedger's runtime records
  of the timed reps (the port has no jaxpr, so no static byte sheet:
  ``wire_unmatched`` is 0);
- where the program launches K1-K8, the trace holds one record of the
  kernel's main symbol per launch its wrapper's ``LAUNCHES`` counted;
- on the card, whatever the program, the trace holds device records and
  at least one kernel record per launch the host's runtime recorded.
  torch.profiler can drop device records on the card (``PERF.md`` §7);
  then the row says ``reconciled: false`` with the reason, and never
  fills the gap with a guess.
"""

from __future__ import annotations

import re
import tempfile
import time

# FROZEN vocabulary, the reference's; a row's ``terms`` carry exactly these
# keys with an ``_s`` suffix.  Order is the classifier's priority.
BUCKETS = ("mxu", "elementwise", "gather_dus", "scatter", "wire",
           "overhead")

# Max tolerated over-attribution (the sum of op self-times exceeding the
# measured wall) before the row fails closed: the reference's value.
SUM_REL_TOL = 0.75

# app name (CLI surface) → registered driver program, the reference's
PROFILE_APPS = {
    "kmeans": "kmeans.fit",
    "mfsgd": "mfsgd.epoch",
    "lda": "lda.epoch",
    "rf": "rf.grow",
    "svm": "svm.train",
    "wdamds": "wdamds.smacof",
    "subgraph": "subgraph.count",
    "serve": "serve.kmeans_assign",
    "rf_pallas": "rf.grow_pallas",
    "svm_pallas": "svm.train_pallas",
    "wdamds_pallas": "wdamds.smacof_pallas",
}

# -- the classifier ---------------------------------------------------------
# The port's kernels first (the docstring's table), then the generic rules
# in BUCKETS priority order (wire before mxu, so that an all-gather never
# reads as a gather).
_KERNELS = (
    (re.compile(r"\bsgd_step_kernel\b"), "gather_dus"),          # K3
    (re.compile(r"km::main_kernel<"), "mxu"),                    # K1, K2
    (re.compile(r"km::range_kernel<"), "scatter"),               # K1, K2
    (re.compile(r"\bpack_kernel\(|\breduce_kernel\("), "elementwise"),
    (re.compile(r"\bstep_kernel\b"), "scatter"),                # K4
    (re.compile(r"\b(rows|tile)_kernel\b"), "elementwise"),      # K5
    (re.compile(r"\bbx_kernel\b"), "elementwise"),               # K6
    (re.compile(r"\bhist_kernel\b"), "scatter"),                 # K7
    (re.compile(r"\b(simt|wgmma)_kernel\b"), "mxu"),             # K8
)
_WIRE = re.compile(r"nccl|gloo|c10d::|record_param_comms|all[-_]?reduce"
                   r"|all[-_]?gather|reduce[-_]?scatter|all[-_]?to[-_]?all"
                   r"|collective-permute|\bsend\b|\brecv\b", re.IGNORECASE)
_MXU = re.compile(r"gemm|gemv|nvjet|cutlass|cublas|xmma|wgmma|hmma|imma"
                  r"|matmul|einsum|aten::(mm|addmm|bmm|baddbmm|linear"
                  r"|addmv|mv|dot|vdot|_scaled_mm|conv\w*)\b"
                  r"|conv(?!ert)", re.IGNORECASE)
_SCATTER = re.compile(r"scatter|index_add|index_put|indexFunc|atomic"
                      r"|bincount|histc|histogram|segment|put_"
                      r"|embedding_(dense_)?backward", re.IGNORECASE)
_GATHER = re.compile(r"gather|index_select|indexSelect|aten::index\b"
                     r"|dynamic[-_](update[-_])?slice"
                     r"|index_elementwise|aten::take|aten::embedding\b"
                     r"|aten::slice|aten::narrow|aten::select\b",
                     re.IGNORECASE)
# runtime, launch and copy spans, and the host ops that only allocate or
# reinterpret (their copies, when they copy, are their children's time)
_INFRA = re.compile(r"^Memcpy|^Memset|^cuda[A-Z]|^cu[A-Z]|^ProfilerStep"
                    r"|^Runtime|Launch|Synchroniz|^aten::(empty|empty_like"
                    r"|empty_strided|resize_|_local_scalar_dense|item|view"
                    r"|as_strided|reshape|t|transpose|expand|contiguous"
                    r"|detach|set_|lift_fresh|alias|unsqueeze|squeeze"
                    r"|permute|flatten|unbind|split|chunk|resolve_conj"
                    r"|resolve_neg|_unsafe_view|record_stream|to)\b")


def _torch_own(name: str) -> bool:
    """A kernel of PyTorch's own (its names may reuse a generic symbol)."""
    return "at::native" in name or "at6native" in name


def classify(op_name: str) -> str:
    """Map one trace span name to its mechanism bucket."""
    if not _torch_own(op_name):
        for pattern, bucket in _KERNELS:
            if pattern.search(op_name):
                return bucket
    if _WIRE.search(op_name):
        return "wire"
    if _MXU.search(op_name):
        return "mxu"
    if _SCATTER.search(op_name):
        return "scatter"
    if _GATHER.search(op_name):
        return "gather_dus"
    if _INFRA.search(op_name):
        return "overhead"
    return "elementwise"


#: the kernels' main symbols, one trace record a wrapper call, keyed by
#: (the wrapper's module, its LAUNCHES key)
MAIN_SYMBOLS = {
    ("harp_tpu_torch.ops.kmeans_kernel", "kmeans_partials_int8"):
        re.compile(r"km::main_kernel<km::Int8Traits"),
    ("harp_tpu_torch.ops.kmeans_kernel", "kmeans_partials"):
        re.compile(r"km::main_kernel<km::Bf16Traits"),
    ("harp_tpu_torch.ops.mfsgd_kernel", "sgd_tile_update"):
        re.compile(r"\bsgd_step_kernel\b"),
    ("harp_tpu_torch.ops.lda_kernel", "cgs_entry_update"):
        re.compile(r"\bstep_kernel\b"),
    ("harp_tpu_torch.ops.svm_kernel", "pegasos_grad"):
        re.compile(r"\b(rows|tile)_kernel\b"),
    ("harp_tpu_torch.ops.wdamds_kernel", "smacof_bx"):
        re.compile(r"\bbx_kernel\b"),
    ("harp_tpu_torch.ops.rf_kernel", "hist_bins"):
        re.compile(r"\bhist_kernel\b"),
    ("harp_tpu_torch.ops.flash_attention", "flash_attention"):
        re.compile(r"\b(simt|wgmma)_kernel\b"),
}


def attribute(breakdown, wall_s: float, n_devices: int) -> dict:
    """Bucket an ``op_breakdown(per_device=True)`` list against a wall.

    Pure attribution (no capture), the reference's: sums the self-times
    into :data:`BUCKETS`, divides by ``n_devices`` (the cards' tracks run
    side by side: their mean busy time), then reconciles to ``wall_s`` —
    a shortfall fills ``overhead``, an excess rescales and is reported as
    ``sum_rel_err``.
    """
    bucket_s = {b: 0.0 for b in BUCKETS}
    for name, _dev, sec in breakdown:
        bucket_s[classify(name)] += float(sec)
    n = max(int(n_devices), 1)
    for b in bucket_s:
        bucket_s[b] /= n
    attributed = sum(bucket_s.values())
    if attributed > wall_s > 0:
        sum_rel_err = attributed / wall_s - 1.0
        scale = wall_s / attributed
        bucket_s = {b: s * scale for b, s in bucket_s.items()}
    else:
        sum_rel_err = 0.0
        bucket_s["overhead"] += max(wall_s - attributed, 0.0)
    bound = max(BUCKETS, key=lambda b: bucket_s[b])
    return {"terms": {f"{b}_s": round(bucket_s[b], 6) for b in BUCKETS},
            "bound": bound, "sum_rel_err": round(sum_rel_err, 4)}


def _launch_counts() -> dict:
    """Every kernel wrapper's LAUNCHES count, by (module, key)."""
    import importlib

    return {(m, k): importlib.import_module(m).LAUNCHES[k]
            for m, k in MAIN_SYMBOLS}


def kernel_records(events: list[dict], launched: dict) -> tuple[dict, list]:
    """For every kernel that ``launched`` says ran (``{(module, key):
    launches}``), the trace's records of its main symbol; and the reasons
    the trace is short of them (the profiler dropped device records)."""
    from harp_tpu_torch.utils.profiling import device_events

    names = [e.get("name", "") for e in device_events(events)
             if e.get("cat") == "kernel"]
    seen, short = {}, []
    for key, n in launched.items():
        if not n:
            continue
        got = sum(bool(MAIN_SYMBOLS[key].search(nm)) and not _torch_own(nm)
                  for nm in names)
        seen[key[1]] = {"launches": n, "traced": got}
        if got != n:
            short.append(f"the trace holds {got} of the {n} {key[1]} "
                         "launches: torch.profiler dropped device records")
    return seen, short


def device_records_short(events: list[dict]) -> list[str]:
    """The reasons a card's capture is short of device records, whatever
    kernels ran: fewer kernel records than the host's launch records, or
    no device record at all."""
    from harp_tpu_torch.utils.profiling import device_events, launch_records

    on_card = device_events(events)
    kernels = sum(e.get("cat") == "kernel" for e in on_card)
    launches = launch_records(events)
    if kernels < launches:
        return [f"the trace holds {kernels} kernel records of {launches} "
                "launches: torch.profiler dropped device records"]
    if not on_card:
        return ["the trace holds no device record of a cuda capture: "
                "torch.profiler dropped device records"]
    return []


def _device(device):
    import torch

    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("profile: no CUDA device; pass device='cpu' "
                           "(--device cpu) to profile on the CPU")
    return dev


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def capture(app: str, *, reps: int = 4, logdir: str | None = None,
            device=None) -> dict:
    """Run one app's registered driver under the trace hook and return its
    reconciled ``kind: "profile"`` row.

    Runs on the card unless ``device`` says otherwise; raises without
    one.  Raises ``KeyError`` for an unknown app.  The trace is written
    under ``logdir`` (kept), or a temporary directory (removed).  The row carries
    ``reconciled: False`` (never an exception) when a cross-check fails,
    with the reasons in ``why``; the CLI turns that into exit 1.
    """
    from harp_tpu_torch.analysis.drivers import DRIVERS
    from harp_tpu_torch.utils import flightrec, profiling, skew, telemetry

    program = PROFILE_APPS[app]
    dev = _device(device)
    if logdir is None:
        with tempfile.TemporaryDirectory(prefix=f"harp_profile_{app}_") as d:
            return capture(app, reps=reps, logdir=d, device=dev)
    fn, args = DRIVERS[program](dev)
    with telemetry.scope(True, reset=False):
        fn(*args)                                 # warm-up: builds, plans
        _sync(dev)
        base = flightrec.snapshot()
        fn(*args)
        _sync(dev)
        per_rep = int(flightrec.delta_since(base)["dispatches"])
        if per_rep == 0:
            # the driver is not tracked: wrap it so that the dispatch
            # reconciliation has a spine to agree with
            fn = flightrec.track(fn, f"profile.{app}")
            fn(*args)
            _sync(dev)
            per_rep = 1

        ledger_before = {k: dict(v) for k, v in
                         telemetry.ledger.summary().items()}
        launches_before = _launch_counts()
        base = flightrec.snapshot()
        with profiling.trace(logdir):
            # the wall is timed inside the trace: starting the profiler
            # costs time that is not the program's
            t0 = time.perf_counter()
            for _ in range(reps):
                fn(*args)
            _sync(dev)
            wall = time.perf_counter() - t0
        delta = flightrec.delta_since(base)
        launched = {k: v - launches_before[k]
                    for k, v in _launch_counts().items()}
        wire_bytes, wire_sites = _wire_delta(ledger_before,
                                             telemetry.ledger.summary())

        events = profiling.load_events(logdir)
        breakdown = profiling.op_breakdown(logdir, top=10 ** 6,
                                           per_device=True, device=dev)
        dev_ids = sorted({d for _, d, _ in breakdown if d is not None})
        n_devices = max(len(dev_ids), 1)
        attrib = attribute(breakdown, wall, n_devices)
        kernels, short = kernel_records(events, launched)
        if dev.type == "cuda":
            short += device_records_short(events)
        if dev_ids:
            vec = [sum(s for _, d, s in breakdown if d == i) for i in dev_ids]
        else:
            vec = [sum(s for _, _, s in breakdown)]
        skew.record_execution(f"profile.{app}", vec, unit="seconds",
                              wall_s=wall)

    dispatches = int(delta["dispatches"])
    compiles = int(delta["compiles"])
    dispatch_ok = dispatches == reps * per_rep
    why = list(short)
    if not dispatch_ok:
        why.append(f"{dispatches} dispatches, expected {reps} x {per_rep}")
    if compiles:
        why.append(f"{compiles} builds or captures in the timed window")
    if attrib["sum_rel_err"] > SUM_REL_TOL:
        why.append(f"over-attributed: sum_rel_err {attrib['sum_rel_err']}")
    return {
        "kind": "profile", "app": app, "program": program,
        "wall_s": round(wall, 6), "reps": reps,
        "n_devices": n_devices,
        "terms": attrib["terms"], "bound": attrib["bound"],
        "sum_rel_err": attrib["sum_rel_err"],
        "wire_bytes": wire_bytes, "wire_sites": wire_sites,
        "wire_unmatched": 0,
        "dispatches": dispatches, "dispatches_per_rep": per_rep,
        "dispatch_reconciled": dispatch_ok,
        "compiles_in_window": compiles,
        "kernels": kernels,
        "reconciled": not why, "why": why,
        "device": str(dev),
        **flightrec.provenance_stamp(),
    }


def _wire_delta(before: dict, after: dict) -> tuple[int, int]:
    """(bytes, verb sites) the CommLedger recorded between two summaries."""
    total, sites = 0, 0
    for tag, t in after.items():
        old = {(r["verb"], r["combiner"], r["wire_dtype"]): r
               for r in before.get(tag, {}).get("verbs", [])}
        for r in t["verbs"]:
            o = old.get((r["verb"], r["combiner"], r["wire_dtype"]))
            grew = r["payload_bytes"] - (o["payload_bytes"] if o else 0)
            calls = r["calls"] - (o["calls"] if o else 0)
            if calls:
                total += grew
                sites += 1
    return total, sites


def capture_all(*, reps: int = 4, device=None) -> list:
    """One :func:`capture` row per app, in :data:`PROFILE_APPS` order."""
    return [capture(app, reps=reps, device=device) for app in PROFILE_APPS]
