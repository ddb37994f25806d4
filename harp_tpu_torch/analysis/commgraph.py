"""Layer ``wire``: the CommGraph audit at run time (HL301-HL303), the
counterpart of ``harp_tpu.analysis.commgraph``.

The reference reads each driver program's collectives out of its jaxpr and
holds them against the CommLedger's trace-time records.  PyTorch traces no
program, so the port *runs* each registered driver
(:mod:`harp_tpu_torch.analysis.drivers`) under :class:`WireTap`, an
interceptor of the ``torch.distributed`` data calls, and holds what the tap
saw against the CommLedger's records of the same run.  Both sides key a call
by :func:`harp_tpu_torch.utils.telemetry.site_key` of the nearest frame that
:func:`~harp_tpu_torch.utils.telemetry.is_ledger_user_frame` accepts: the
verb's caller, since the verb layer and torch are skipped.

- **HL301**: a ``torch.distributed`` data call at a site where the ledger
  recorded nothing: an untracked wire.
- **HL302**: the ledger's payload bytes at a site differ from the bytes the
  run handed to ``torch.distributed`` there (each call's input tensors).
  A site whose ledger records carry a ``wire_dtype`` (the quantized wires)
  is exempt: the ledger counts their logical width.

Each program's calls make its **byte sheet**, the lint row's
``byte_sheets`` entry, in the reference's vocabulary: ``all_reduce`` is
``psum``, ``pmax`` or ``pmin`` by its op (``broadcast`` and ``reduce`` are
``psum``, as the reference lowers them), a ring's sends and receives are
``ppermute``, ``all_gather*``/``gather`` ``all_gather``,
``all_to_all*``/``scatter`` ``all_to_all`` and ``reduce_scatter*``
``reduce_scatter``.  A run counts every execution, so ``amplification`` is
1 and ``calls_per_trace`` the calls of the run, except at a chunked ring
move, whose ledger record counts one chunk of its ``hops``: there the
sheet keeps one hop's bytes amplified by the hop count, as the
reference's scan does, and HL302 holds the wire to payload × hops.  On
one worker the verbs move nothing, and the sheets are empty.

**HL303** is the staging counterpart of the reference's use-after-donate:
a staged input buffer written, or dispatched again, while a launch that
reads it is in flight, or dispatched after its worker group changed.
:class:`StagingAudit` wraps the staging executables of a real driven loop
(the registered ``PROTOCOLS``): the serve ``ContinuousRunner``'s buffer
sets, its retry path, and an elastic restage after a worker loss.
"""

from __future__ import annotations

import dataclasses
import pickle
import sys
import threading
from typing import Any, Callable

from harp_tpu_torch.analysis import Violation

#: the ledger verbs each primitive may stand for (the reference's
#: ``collective.PRIMITIVE_VERBS``)
PRIMITIVE_VERBS: dict[str, tuple[str, ...]] = {
    "psum": ("allreduce", "allreduce_quantized", "reduce", "broadcast",
             "barrier", "push", "push_quantized", "allreduce_hier"),
    "pmax": ("allreduce", "reduce", "push", "allreduce_quantized",
             "push_quantized", "rotate_quantized", "regroup_quantized",
             "reshard"),
    "pmin": ("allreduce", "reduce", "push"),
    "ppermute": ("rotate", "rotate_quantized", "reshard"),
    "all_gather": ("allgather", "pull", "reshard", "allreduce"),
    "all_to_all": ("regroup", "regroup_quantized", "reshard"),
    "reduce_scatter": ("push", "push_quantized"),
}

#: intercepted torch.distributed call -> (primitive, the inputs' place:
#: an argument index, or a name)
_CALLS: dict[str, tuple[str, str]] = {
    "all_reduce": ("psum", "tensor"),
    "reduce": ("psum", "tensor"),
    "broadcast": ("psum", "tensor"),
    "all_gather": ("all_gather", "tensor1"),
    "all_gather_into_tensor": ("all_gather", "tensor1"),
    "all_gather_single": ("all_gather", "tensor1"),
    "gather": ("all_gather", "tensor"),
    "all_to_all": ("all_to_all", "list1"),
    "all_to_all_single": ("all_to_all", "tensor1"),
    "scatter": ("all_to_all", "scatter"),
    "reduce_scatter": ("reduce_scatter", "list1"),
    "reduce_scatter_tensor": ("reduce_scatter", "tensor1"),
    "reduce_scatter_single": ("reduce_scatter", "tensor1"),
    "send": ("ppermute", "tensor"),
    "isend": ("ppermute", "tensor"),
    "recv": ("ppermute", "none"),
    "irecv": ("ppermute", "none"),
    "batch_isend_irecv": ("ppermute", "p2p"),
    "all_gather_object": ("all_gather", "object1"),
    "broadcast_object_list": ("psum", "object0"),
}


@dataclasses.dataclass
class WireCall:
    """The calls of one (site, primitive) in one run."""

    site: str
    primitive: str
    wire_dtype: str
    nbytes: int = 0
    calls: int = 0


def _nbytes(x) -> int:
    return int(x.numel()) * x.element_size() if hasattr(x, "numel") else 0


def _dtype(x) -> str:
    return str(getattr(x, "dtype", "object")).removeprefix("torch.")


def _op_primitive(name: str, args, kwargs) -> str:
    """``psum``, ``pmax`` or ``pmin``: an all_reduce's or reduce's op."""
    import torch.distributed as dist

    at = 1 if name == "all_reduce" else 2     # reduce(tensor, dst, op)
    op = kwargs.get("op", args[at] if len(args) > at else None)
    if op == dist.ReduceOp.MAX:
        return "pmax"
    if op == dist.ReduceOp.MIN:
        return "pmin"
    return "psum"


def _inputs(name: str, where: str, args, kwargs) -> tuple[int, str]:
    """(bytes handed to the call, the first input's dtype)."""
    if where == "tensor":
        x = args[0] if args else kwargs.get("tensor")
        return _nbytes(x), _dtype(x)
    if where == "tensor1":
        x = args[1] if len(args) > 1 else kwargs.get(
            "input_tensor", kwargs.get("tensor", kwargs.get("input")))
        return _nbytes(x), _dtype(x)
    if where == "list1":
        xs = args[1] if len(args) > 1 else kwargs.get(
            "input_tensor_list", kwargs.get("input_list", []))
        return sum(_nbytes(x) for x in xs), _dtype(xs[0]) if xs else "?"
    if where == "scatter":
        xs = (args[1] if len(args) > 1 else kwargs.get("scatter_list")) or []
        return sum(_nbytes(x) for x in xs), _dtype(args[0] if args else None)
    if where == "p2p":
        ops = args[0] if args else kwargs.get("p2p_op_list", [])
        sends = [p.tensor for p in ops
                 if "send" in getattr(p.op, "__name__", "")]
        return (sum(_nbytes(x) for x in sends),
                _dtype(sends[0]) if sends else "?")
    if where in ("object0", "object1"):
        obj = args[int(where[-1])] if len(args) > int(where[-1]) else None
        return len(pickle.dumps(obj)), "object"
    return 0, "?"


class WireTap:
    """Intercept the ``torch.distributed`` data calls within the block.

    Each call is keyed by its site (``telemetry.call_site`` from the
    caller's frame) and primitive, and adds the bytes of its input tensors.
    The tap patches ``torch.distributed``, ``distributed_c10d`` (whose
    ``P2POp`` checks its op against its own globals) and every alias of an
    intercepted function held by a ``harp_tpu_torch`` module; only the
    outermost intercepted call of a thread counts, so a call torch makes
    inside another is not counted twice.  Everything is restored on
    exit."""

    def __init__(self):
        self.calls: dict[tuple[str, str], WireCall] = {}
        self._patched: list[tuple[Any, str, Any]] = []
        self._tls = threading.local()
        self._lock = threading.Lock()

    def _wrap(self, name: str, orig: Callable) -> Callable:
        from harp_tpu_torch.utils.telemetry import call_site

        primitive, where = _CALLS[name]

        def tapped(*args, **kwargs):
            depth = getattr(self._tls, "depth", 0)
            if depth == 0:
                nbytes, dtype = _inputs(name, where, args, kwargs)
                prim = (_op_primitive(name, args, kwargs)
                        if name in ("all_reduce", "reduce") else primitive)
                site = call_site(sys._getframe(1))
                with self._lock:
                    rec = self.calls.setdefault(
                        (site, prim), WireCall(site, prim, dtype))
                    rec.nbytes += nbytes
                    rec.calls += 1
            self._tls.depth = depth + 1
            try:
                return orig(*args, **kwargs)
            finally:
                self._tls.depth = depth

        tapped.__wrapped__ = orig
        tapped.__name__ = getattr(orig, "__name__", name)
        return tapped

    def __enter__(self) -> "WireTap":
        import torch.distributed as dist
        import torch.distributed.distributed_c10d as c10d

        wrappers: dict[int, Callable] = {}
        for name in _CALLS:
            orig = getattr(dist, name, None)
            if orig is None:
                continue
            wrappers[id(orig)] = self._wrap(name, orig)
            for ns in (dist, c10d):
                if getattr(ns, name, None) is orig:
                    self._patch(ns, name, wrappers[id(orig)])
        for mod_name, mod in list(sys.modules.items()):
            if not mod_name.startswith("harp_tpu_torch") or mod is None:
                continue
            for attr, val in list(vars(mod).items()):
                w = wrappers.get(id(val))
                if w is not None and getattr(w, "__wrapped__", None) is val:
                    self._patch(mod, attr, w)
        return self

    def _patch(self, obj, attr: str, new) -> None:
        self._patched.append((obj, attr, getattr(obj, attr)))
        setattr(obj, attr, new)

    def __exit__(self, *exc) -> bool:
        for obj, attr, orig in reversed(self._patched):
            setattr(obj, attr, orig)
        self._patched.clear()
        return False


def ledger_sites() -> dict[str, list[dict]]:
    """The CommLedger's records of this run by site, over every tag."""
    from harp_tpu_torch.utils import telemetry

    out: dict[str, list[dict]] = {}
    for tag in telemetry.ledger.summary().values():
        for rec in tag["sites"]:
            out.setdefault(rec["site"], []).append(rec)
    return out


def sheet(calls: dict[tuple[str, str], WireCall],
          ledger: dict[str, list[dict]]) -> dict:
    """The program's byte sheet, in the reference's row shape."""
    rows = []
    for (site, prim), c in calls.items():
        recs = ledger.get(site, [])
        allowed = PRIMITIVE_VERBS.get(prim, ())
        rec = next((r for r in recs if r["verb"] in allowed),
                   recs[0] if recs else None)
        # a chunked ring move: its hops are the sheet's amplification of
        # one hop's payload, as the reference's scan trip count is
        hops = max(rec.get("hops", 1), 1) if rec else 1
        rows.append({"site": site, "primitive": prim,
                     "verb": rec["verb"] if rec else None,
                     "axis": "workers", "wire_dtype": c.wire_dtype,
                     "per_shard_bytes": c.nbytes // hops,
                     "calls_per_trace": max(c.calls // hops, 1),
                     "amplification": hops, "dynamic": False, "path": ""})
    return {"collectives": rows,
            "bytes_per_trace": sum(r["per_shard_bytes"] for r in rows),
            "amplified_bytes": sum(r["per_shard_bytes"] * r["amplification"]
                                   for r in rows),
            "donated_args": [], "donated_avals": []}


def check_run(program: str, calls: dict[tuple[str, str], WireCall],
              ledger: dict[str, list[dict]]) -> list[Violation]:
    """HL301 and HL302 over one run's wire calls and ledger records."""
    out: list[Violation] = []
    target = f"driver:{program}"
    by_site: dict[str, list[WireCall]] = {}
    for c in calls.values():
        by_site.setdefault(c.site, []).append(c)
    for site, cs in sorted(by_site.items()):
        recs = ledger.get(site)
        nbytes = sum(c.nbytes for c in cs)
        if not recs:
            prims = sorted({c.primitive for c in cs})
            out.append(Violation(
                "HL301", target, 0,
                f"torch.distributed call(s) {prims} at {site} ({nbytes} B "
                "a worker this run) have no CommLedger record: an "
                "untracked wire the report's bytes never see; route the "
                "call through a harp_tpu_torch.parallel.collective verb"))
            continue
        if all(r["wire_dtype"] is None for r in recs):
            # a chunked ring move records one chunk and makes `hops` hops
            ledger_bytes = sum(r["payload_bytes"] * r.get("hops", 1)
                               for r in recs)
            if nbytes != ledger_bytes:
                verbs = sorted({r["verb"] for r in recs})
                out.append(Violation(
                    "HL302", target, 0,
                    f"the ledger disagrees with the wire at {site}: the run "
                    f"handed {nbytes} B a worker to torch.distributed but "
                    f"the CommLedger recorded {ledger_bytes} B for {verbs} "
                    "(quantized wires are exempt; exact verbs must agree "
                    "to the byte)"))
    return out


def analyze_program(name: str, fn: Callable, args: tuple
                    ) -> tuple[list[Violation], dict]:
    """Run one driver program under the tap with the ledger on: its
    HL301/HL302 findings and its byte sheet."""
    from harp_tpu_torch.utils import telemetry

    with telemetry.scope(True):
        with WireTap() as tap, telemetry.ledger.run(name, steps=0):
            fn(*args)
        led = ledger_sites()
    return check_run(name, tap.calls, led), sheet(tap.calls, led)


# ---------------------------------------------------------------------------
# HL303: the staging audit
# ---------------------------------------------------------------------------

class StagingAudit:
    """Staging protocol recorder (HL303).

    Wrap each staging executable with :meth:`wrap` (or a whole server with
    :meth:`watch_server`) and run the host loop inside the audit's context,
    which also watches :func:`harp_tpu_torch.utils.flightrec.readback`.
    A staged buffer (a tensor, or a serve rung's ``Staged`` token) is
    consumed by the dispatch it rides: a second dispatch of it, a host
    read of it, or a dispatch after the worker group it was staged in
    changed (:meth:`set_world`) is a violation; so is a write into a serve
    buffer set whose launch is still in flight (dispatched and not yet
    released by its readback).  Object identity keys a buffer; the audit
    keeps a reference to each, so no id is reused within a run.
    ``staged_dispatches`` counts the dispatches that carried a staged
    buffer: a protocol that stages nothing audits nothing.
    """

    def __init__(self, target: str):
        self.target = target
        self.violations: list[Violation] = []
        self.staged_dispatches = 0
        self._dispatched: dict[int, str] = {}    # id(buffer) -> label
        self._worlds: dict[int, int] = {}        # id(buffer) -> id(world)
        self._inflight: dict[tuple, str] = {}    # (id(rung), slot) -> label
        self._keep: list[Any] = []
        self._world: Any = None

    # -- wiring ------------------------------------------------------------
    def set_world(self, world) -> None:
        """The worker group buffers staged from now on belong to."""
        self._world = world
        self._keep.append(world)

    def staged(self, buf):
        """Note a freshly staged buffer (in the current world); returns
        it."""
        self._worlds[id(buf)] = id(self._world)
        self._keep.append(buf)
        return buf

    def wrap(self, exe: Callable, staged_argnums: tuple[int, ...],
             label: str, rung=None) -> Callable:
        """Wrap a staging executable: every other attribute is the
        wrapped one's, like ``flightrec.track``'s wrapper."""
        return _StagingWrapped(self, exe, tuple(staged_argnums), label, rung)

    def watch_server(self, srv) -> None:
        """Wrap a started serve ``Server``: each rung's dispatch (its
        staged token, the argument after the state), its ``stage`` and its
        ``release``."""
        n_state = len(srv.engine.state_args())
        for rung_n, rung in srv._rungs.items():
            self._watch_rung(rung, f"serve.{srv.app}.b{rung_n}")
        srv.wrap_executables(lambda rung_n, exe: self.wrap(
            exe, (n_state,), f"serve.{srv.app}.b{rung_n}",
            srv._rungs[rung_n]))

    def _watch_rung(self, rung, label: str) -> None:
        stage, release = rung.stage, rung.release

        def audited_stage(arr):
            tok = stage(arr)
            holder = self._inflight.get((id(rung), tok.slot))
            if holder is not None:
                self._flag(f"buffer set {tok.slot} of {label} written while "
                           f"the launch of {holder} that reads it is in "
                           "flight (dispatched, not yet read back): stage "
                           "into a free buffer set")
            return self.staged(tok)

        def audited_release(out):
            for i, s in enumerate(rung._slots):
                if s is out:
                    self._inflight.pop((id(rung), i), None)
            return release(out)

        rung.stage, rung.release = audited_stage, audited_release

    def __enter__(self):
        from harp_tpu_torch.utils import flightrec

        self._obs = flightrec.observe_readbacks(self._note_readback)
        self._obs.__enter__()
        return self

    def __exit__(self, *exc):
        self._obs.__exit__(*exc)
        return False

    # -- events ------------------------------------------------------------
    def _note_readback(self, x: Any) -> None:
        label = self._dispatched.get(id(x))
        if label is not None:
            self._flag(f"host read (flightrec.readback) of a staged buffer "
                       f"consumed by {label}: read the dispatch's output, "
                       "stage a fresh input per batch")

    def _note_dispatch(self, label: str, args: tuple,
                       staged_argnums: tuple[int, ...]) -> None:
        for pos in staged_argnums:
            if pos >= len(args):
                continue
            a = args[pos]
            prior = self._dispatched.get(id(a))
            if prior is not None:
                self._flag(f"arg {pos} of {label} was already dispatched to "
                           f"{prior}: a staged buffer is consumed by its "
                           "dispatch; stage a fresh one per batch")
            world = self._worlds.get(id(a))
            if world is not None and world != id(self._world):
                self._flag(f"arg {pos} of {label} was staged in a worker "
                           "group that has since changed: restage it from "
                           "host data in the surviving group")
            self._dispatched[id(a)] = label
            self._keep.append(a)
            self.staged_dispatches += 1

    def _flag(self, msg: str) -> None:
        self.violations.append(Violation("HL303", self.target, 0, msg))


class _StagingWrapped:
    __slots__ = ("_audit", "__wrapped__", "_staged", "_label", "_rung")

    def __init__(self, audit: StagingAudit, exe: Callable,
                 staged_argnums: tuple[int, ...], label: str, rung):
        self._audit = audit
        self.__wrapped__ = exe
        self._staged = staged_argnums
        self._label = label
        self._rung = rung

    def __call__(self, *args, **kw):
        self._audit._note_dispatch(self._label, args, self._staged)
        out = self.__wrapped__(*args, **kw)
        if self._rung is not None:   # launched: its buffer set is busy
            tok = args[self._staged[0]]
            self._audit._inflight[(id(self._rung), tok.slot)] = self._label
        return out

    def __getattr__(self, name):
        return getattr(self.__wrapped__, name)


def audit_protocol(name: str, drive: Callable[[StagingAudit], None]
                   ) -> list[Violation]:
    """Run one registered protocol under a :class:`StagingAudit`; a run
    that staged nothing is itself a finding (the audit would be
    vacuous)."""
    audit = StagingAudit(f"protocol:{name}")
    try:
        with audit:
            drive(audit)
    except Exception as e:  # noqa: BLE001 - a broken protocol is loud
        audit._flag(f"protocol run failed: {type(e).__name__}: {e}")
    else:
        if audit.staged_dispatches == 0:
            audit._flag("the protocol dispatched no staged buffer: the "
                        "audit checked nothing")
    return audit.violations

