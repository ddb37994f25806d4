"""harplint's rule registry on the port: every rule an id, a layer and the
fault it prevents.

The ids are the reference's (``harp_tpu.analysis.rules``), so a lint row of
either package names the same rule by the same id; each title and ``trap``
text says what the rule means for PyTorch and CUDA on an H100.  Four layers:

- ``ast`` (HL000-HL005, :mod:`harp_tpu_torch.analysis.astlints`): pure
  ``ast`` over ``harp_tpu_torch/`` and ``chip_smoke.py``;
- ``kernels`` (HL205, :mod:`harp_tpu_torch.analysis.kernel_audit`): the
  kernel registry's ``smem_bytes`` against the wrappers' own plans;
- ``wire`` (HL301-HL303, :mod:`harp_tpu_torch.analysis.commgraph`): the
  registered drivers run under an interceptor of ``torch.distributed``,
  held against the CommLedger of the same run, and the staging protocols
  under an in-flight audit;
- ``threads`` (HL401-HL405, :mod:`harp_tpu_torch.analysis.threadgraph`):
  the thread-root graph of the host planes.

Rules of the reference that are not ported, and why:

- HL004 (a jitted driver callable not flight-tracked): PyTorch runs
  eagerly, so a whole-step callable is a plain ``def`` or bound method,
  the same AST shape as any helper; no shape marks the sites where the
  reference jit-compiles.  The port tracks them by hand
  (``models/kmeans.py``, ``models/mfsgd.py``, ``models/lda.py``) and its
  budget tests pin the dispatch counts.
- HL101 and HL102 (a jaxpr scan's gather-and-update copy, a large
  closed-over constant): PyTorch eager traces no program, so it has
  neither a scan carry to copy nor constants to bake into one.
- HL201-HL204 (Mosaic lowering, the prng seed-word limit, the uint32 to
  float cast, sublane-aligned blocks): limits of the TPU toolchain.  The
  port's kernels are CUDA C++ for ``sm_90a``, built and checked against
  their plain versions on the card (``chip_smoke.py``).
- HL304 (a loop-invariant collective): stated over a traced loop's carry.
  Eager PyTorch traces no loop, and a runtime check of equal bytes would
  flag a legitimate repeat (the same shape reduced again with new values).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Rule:
    id: str
    layer: str          # "ast" | "kernels" | "wire" | "threads"
    title: str
    trap: str           # the fault this rule machine-checks


RULES: dict[str, Rule] = {r.id: r for r in [
    Rule("HL000", "ast", "unparseable Python source",
         "a file the AST lints cannot parse is a file no rule protects; "
         "fix the syntax error first"),
    Rule("HL001", "ast", "raw torch.distributed data call outside the verbs",
         "collectives go through harp_tpu_torch.parallel.collective's "
         "verbs: a raw all_reduce, all_gather, all_to_all, broadcast, "
         "reduce_scatter, send/recv or gather/scatter call is invisible "
         "to the CommLedger, so the report's bytes on the wire and the "
         "planner's sheets under-count it"),
    Rule("HL002", "ast", "global RNG in library code",
         "library code draws from an explicit generator "
         "(torch.Generator, np.random.default_rng): torch.manual_seed, "
         "np.random.seed, np.random's global draws and a torch.rand*, "
         "normal, bernoulli or multinomial without generator= share one "
         "hidden stream, so a second caller or thread changes every "
         "draw and a seeded run stops being reproducible"),
    Rule("HL003", "ast", "uncounted H2D copy of host numpy",
         "torch.tensor / torch.as_tensor of host numpy onto a device is a "
         "synchronous copy from pageable memory that the flight "
         "recorder never sees; place data through mesh.shard_array, the "
         "ingest StagingRing, or a path that calls "
         "flightrec.record_h2d"),
    Rule("HL005", "ast", "perf number without date, card and power limit",
         "a docstring's measured time or rate (ms, us, GB/s, a rate per "
         "second, a speedup) carries its date, the card (H100) and the "
         "card's power limit in watts: a card set below its 700 W runs "
         "slower under load, and an unlabelled number cannot be "
         "re-audited"),
    Rule("HL205", "kernels", "stale kernel shared-memory declaration",
         "a kernel-registry smem_bytes that no longer matches the "
         "dynamic shared memory the kernel's own wrapper plans at the "
         "registered shape mis-prices the cost model and the memrec "
         "fit gate built on it: declarations sit within "
         "memrec.PRESIZE_BAND of the plan and under the H100's 227 KiB "
         "opt-in"),
    Rule("HL301", "wire", "torch.distributed call with no ledger record",
         "a torch.distributed data call made at a call site where the "
         "CommLedger recorded nothing is an untracked wire: every "
         "bytes-on-wire figure of the report and the planner "
         "under-counts it; route the call through a verb"),
    Rule("HL302", "wire", "ledger bytes disagree with the wire",
         "the bytes the CommLedger recorded at a call site differ from "
         "the bytes the same run handed to torch.distributed there: one "
         "of the two sheets is lying, and the plans built on it are "
         "wrong (quantized wires are exempt: the ledger counts their "
         "logical width)"),
    Rule("HL303", "wire", "staged buffer reused while a launch reads it",
         "a staged input buffer written or re-dispatched while a launch "
         "that reads it is still in flight, or after its worker group "
         "changed: CUDA runs the launch later than Python returns, so "
         "the launch reads the new bytes or a group that no longer "
         "exists; stage a fresh buffer set per batch and restage after "
         "a shrink"),
    Rule("HL401", "threads", "device work from a non-owner thread root",
         "a device-touching call (a tracked dispatch, torch.cuda, a "
         "readback, a placement) reachable from a thread root other "
         "than the plane's designated device owners; route the work "
         "through an owner (the serve dispatcher thread is the pinned "
         "clean fixture)"),
    Rule("HL402", "threads", "blocking call inside the event loop",
         "a blocking call (a device sync or readback, socket recv, an "
         "unbounded Queue.get/join/wait, time.sleep) reachable from an "
         "event-loop coroutine and not awaited freezes every socket the "
         "loop owns; await it, bound it, or move it to the dispatcher"),
    Rule("HL403", "threads", "multi-root write with no common lock",
         "shared mutable state (a telemetry spine, scheduler results, "
         "pipeline stats) written from two or more thread roots with no "
         "common lock on the write path: the spines' single-writer "
         "contract becomes a checked invariant instead of a comment"),
    Rule("HL404", "threads", "lock held across a dispatch or readback",
         "a lock held across a launch or a blocking readback makes every "
         "other thread wanting it wait for the card; release the lock "
         "before touching the device"),
    Rule("HL405", "threads", "thread with neither daemon nor bounded join",
         "a thread started with neither daemon=True nor a bounded "
         "join(timeout) on a shutdown path hangs process exit when it "
         "blocks (in a collective whose peer died, say)"),
]}


def rule_ids() -> list[str]:
    return sorted(RULES)
