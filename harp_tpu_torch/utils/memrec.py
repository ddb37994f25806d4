"""memrec — the device-memory ledger: the port of ``harp_tpu.utils.memrec``.

Every device buffer's lifecycle (staged, dispatch input consumed, output,
freed) is an evidence row, and the live watermark re-derives from the
event stream exactly (:func:`summarize_rows` replays it).

How the ledger is fed (every hook returns before it touches state while
telemetry is off, and none adds a device op):

- H2D staging: ``flightrec.record_h2d`` (``WorkerMesh.shard_array``, a
  serve engine's ``put_input``) calls :func:`on_staged` with the bytes
  it already counts.
- Dispatch: ``flightrec.track(fn, label, donate_argnums=...)`` registers
  which arguments a call consumes (configuration: it survives
  :func:`reset`); at call time :func:`on_dispatch` claims the newest live
  buffers of those byte sizes and records them leaving the live set, and
  :func:`on_output` adds the call's result.  A serve rung's staged input
  lands in a fixed buffer that the next staging overwrites, so the
  dispatch consumes it.
- Executables: the serve cache records each rung's footprint through
  :func:`note_executable`: what ``torch.cuda.memory_allocated`` and the
  capture's graph pool say about the rung's capture
  (:func:`footprint_from_capture`).
- Checkpoint restore: :func:`on_restored`, a zero-delta event (the
  restore lands in host memory; the H2D that follows is its own event).

The HBM capacity is the card's ``total_memory``
(``torch.cuda.get_device_properties``), read once this process uses the
card; it stays 0 (no pressure check) on the CPU.

Supersteps: ``steptrace.superstep`` opens a window per span
(:meth:`MemLedger.begin_window`) and threads the window's peak onto the
timeline as a ``memory`` mark (:func:`note_superstep`).

Fit gates: the reference's VMEM gate becomes two gates at the card's
limits, :func:`require_smem_fit` (a block's opt-in shared memory) and
:func:`require_hbm_fit` (the free device memory).  Each refuses a config
with ``MemoryError`` before it launches, whatever the telemetry state,
and records the reference's ``vmem_check`` row (with ``space``) when
telemetry is on.  K1's and K2's plans, K3's and K7's call them.

CLI: ``python -m harp_tpu_torch memory run.jsonl [--json]``: exit 0
clean, 1 irreconciled, 2 unreadable.
"""

from __future__ import annotations

import argparse
import json
import sys

from harp_tpu_torch.utils import telemetry

# a kernel-registry smem_bytes declaration must lie within this band of
# the wrapper's own plan at the registered shape (declared in [plan, plan
# × BAND]): the HL205 lint rule (analysis/kernel_audit.py)
PRESIZE_BAND = 1.25

# Buffer lifecycle vocabulary.
BUFFER_EVENTS = ("staged", "restored", "output", "freed", "donated")
# Row sub-kinds under kind:"memory".
EVS = ("buffer", "dispatch", "executable", "vmem_check", "summary")

# label -> donate_argnums; configuration, not run state: reset() keeps it.
_DISPATCH_SIGS: dict[str, tuple[int, ...]] = {}


def _leaf_nbytes(a) -> int:
    """Byte size of one tensor or array from its shape and dtype only."""
    import torch

    if isinstance(a, torch.Tensor):
        return a.numel() * a.element_size()
    return int(getattr(a, "nbytes", 0) or 0)


def _tree_nbytes(x) -> int:
    return sum(_leaf_nbytes(leaf) for leaf in telemetry.tree_leaves(x))


def _hbm_capacity() -> int:
    """The card's memory once this process uses it, else 0."""
    import torch

    if not torch.cuda.is_initialized():
        return 0
    return int(torch.cuda.get_device_properties(
        torch.cuda.current_device()).total_memory)


class MemLedger:
    """Live-set + watermark ledger over device-buffer lifecycle events."""

    def __init__(self):
        self._rows: list[dict] = []
        self._live: dict[int, dict] = {}   # buf id -> {bytes, label}
        self._seq = 0
        self._buf = 0
        self.live_bytes = 0
        self.peak_bytes = 0
        self._win_peak = 0
        self.staged_bytes = 0
        self.freed_bytes = 0
        self.donated_bytes = 0
        self.vmem_checks = 0
        self.vmem_refusals = 0
        self._execs: dict[str, dict] = {}
        self._pressure_fired = False
        self._hbm: int | None = None

    @property
    def hbm_bytes(self) -> int:
        if self._hbm is None:
            cap = _hbm_capacity()
            if cap:
                self._hbm = cap
            return cap
        return self._hbm

    @hbm_bytes.setter
    def hbm_bytes(self, nbytes: int) -> None:
        self._hbm = int(nbytes)
    # -- internals ----------------------------------------------------
    def _next_seq(self) -> int:
        self._seq += 1
        return self._seq

    def _buffer_row(self, event: str, buf: int, nbytes: int,
                    label: str | None) -> None:
        self._rows.append({
            "kind": "memory", "ev": "buffer", "event": event,
            "buf": buf, "bytes": int(nbytes), "label": label or "?",
            "seq": self._next_seq(), "live_bytes": self.live_bytes,
            "peak_bytes": self.peak_bytes,
        })

    def _note_peak(self) -> None:
        if self.live_bytes > self.peak_bytes:
            self.peak_bytes = self.live_bytes
        if self.live_bytes > self._win_peak:
            self._win_peak = self.live_bytes
        if not self._pressure_fired and self.hbm_bytes > 0:
            from harp_tpu_torch.health import sentinel
            if self.peak_bytes >= ((1.0 - sentinel.HEADROOM_WARN_FRAC)
                                   * self.hbm_bytes):
                self._pressure_fired = True
                sentinel.monitor.observe_memory(
                    "run", self.peak_bytes, self.hbm_bytes)

    def _add(self, event: str, nbytes: int, label: str | None) -> int:
        self._buf += 1
        self._live[self._buf] = {"bytes": int(nbytes), "label": label}
        self.live_bytes += int(nbytes)
        self._note_peak()
        self._buffer_row(event, self._buf, nbytes, label)
        return self._buf

    def _remove(self, event: str, buf: int) -> None:
        info = self._live.pop(buf)
        self.live_bytes -= info["bytes"]
        self._buffer_row(event, buf, info["bytes"], info["label"])

    # -- event surface ------------------------------------------------
    def staged(self, nbytes: int, label: str | None = None) -> int:
        self.staged_bytes += int(nbytes)
        return self._add("staged", nbytes, label)

    def restored(self, nbytes: int, label: str | None = None) -> None:
        # Zero-delta: restore lands in host RAM; the H2D that follows
        # enters the live set as its own staged event.
        self._rows.append({
            "kind": "memory", "ev": "buffer", "event": "restored",
            "buf": 0, "bytes": int(nbytes), "label": label or "?",
            "seq": self._next_seq(), "live_bytes": self.live_bytes,
            "peak_bytes": self.peak_bytes,
        })

    def output(self, nbytes: int, label: str | None = None) -> int:
        return self._add("output", nbytes, label)

    def freed(self, buf: int | None = None, nbytes: int | None = None,
              label: str | None = None) -> bool:
        """Free an explicit buf id, or the newest live match."""
        if buf is None:
            buf = self._match(nbytes, label)
            if buf is None:
                return False
        self.freed_bytes += self._live[buf]["bytes"]
        self._remove("freed", buf)
        return True

    def _match(self, nbytes: int | None, label: str | None) -> int | None:
        for b in reversed(self._live):
            info = self._live[b]
            if nbytes is not None and info["bytes"] != int(nbytes):
                continue
            if label is not None and info["label"] != label:
                continue
            return b
        return None

    def dispatch(self, label: str, donated_nbytes: list[int]) -> None:
        """Record a dispatch; claim newest live buffers for donations."""
        claimed: list[int] = []
        claimed_bytes = 0
        for nb in donated_nbytes:
            b = self._match(nb, None)
            if b is None:
                continue  # telemetry may have enabled mid-run
            claimed_bytes += self._live[b]["bytes"]
            self.donated_bytes += self._live[b]["bytes"]
            self._remove("donated", b)
            claimed.append(b)
        self._rows.append({
            "kind": "memory", "ev": "dispatch", "label": label,
            "seq": self._next_seq(), "donated": claimed,
            "donated_bytes": claimed_bytes,
            "live_bytes": self.live_bytes, "peak_bytes": self.peak_bytes,
        })

    def executable(self, name: str, footprint: dict, source: str) -> None:
        total = sum(int(footprint.get(k, 0)) for k in (
            "argument_bytes", "output_bytes", "temp_bytes",
            "generated_code_bytes"))
        row = {
            "kind": "memory", "ev": "executable", "name": name,
            "seq": self._next_seq(), "source": source,
            "argument_bytes": int(footprint.get("argument_bytes", 0)),
            "output_bytes": int(footprint.get("output_bytes", 0)),
            "temp_bytes": int(footprint.get("temp_bytes", 0)),
            "generated_code_bytes":
                int(footprint.get("generated_code_bytes", 0)),
            "exec_hbm_bytes": total,
        }
        self._execs[name] = row
        self._rows.append(row)

    def vmem_check(self, kernel: str, predicted: int, budget: int,
                   fits: bool, space: str) -> None:
        """One fit gate's evidence row: the reference's ``vmem_check``
        row, and the memory it was held to (``space``: "smem" or "hbm")."""
        self.vmem_checks += 1
        if not fits:
            self.vmem_refusals += 1
        self._rows.append({
            "kind": "memory", "ev": "vmem_check", "kernel": kernel,
            "space": space, "seq": self._next_seq(),
            "predicted_bytes": int(predicted), "budget_bytes": int(budget),
            "fits": bool(fits), "refused": not fits,
        })

    # -- superstep window ---------------------------------------------
    def begin_window(self) -> None:
        self._win_peak = self.live_bytes

    def window_peak(self) -> int:
        return self._win_peak

    # -- summaries ----------------------------------------------------
    def headroom_frac(self) -> float:
        if self.hbm_bytes <= 0:
            return 1.0
        return max(0.0, 1.0 - self.peak_bytes / self.hbm_bytes)

    def exec_total(self) -> int:
        return sum(r["exec_hbm_bytes"] for r in self._execs.values())

    def summary_row(self) -> dict:
        return {
            "kind": "memory", "ev": "summary",
            "seq": self._next_seq(), "events": len(self._rows),
            "staged_bytes": self.staged_bytes,
            "freed_bytes": self.freed_bytes,
            "donated_bytes": self.donated_bytes,
            "peak_hbm_bytes": self.peak_bytes,
            "live_hbm_bytes": self.live_bytes,
            "hbm_bytes": self.hbm_bytes,
            "headroom_frac": round(self.headroom_frac(), 6),
            "executables": len(self._execs),
            "exec_hbm_bytes": self.exec_total(),
            "vmem_checks": self.vmem_checks,
            "vmem_refusals": self.vmem_refusals,
        }


ledger = MemLedger()


def reset() -> None:
    """Fresh ledger (telemetry.scope).  _DISPATCH_SIGS survives."""
    global ledger
    ledger = MemLedger()


# ---------------------------------------------------------------------
# Hook surface (every entry point returns before touching state when
# telemetry is off).
# ---------------------------------------------------------------------

def on_staged(nbytes: int, label: str | None = None) -> None:
    if not telemetry.enabled():
        return
    ledger.staged(nbytes, label)


def on_restored(nbytes: int, label: str | None = None) -> None:
    if not telemetry.enabled():
        return
    ledger.restored(nbytes, label)


def register_dispatch(label: str,
                      donate_argnums: tuple[int, ...] | None) -> None:
    """Declare which arguments a tracked callable consumes (config, not
    run state: survives reset()).  Called by flightrec.track."""
    if donate_argnums:
        _DISPATCH_SIGS[label] = tuple(int(i) for i in donate_argnums)


def on_dispatch(label: str, args: tuple) -> None:
    if not telemetry.enabled():
        return
    sig = _DISPATCH_SIGS.get(label)
    if sig is None:
        return
    donated = [_tree_nbytes(args[i]) for i in sig if i < len(args)]
    ledger.dispatch(label, donated)


def on_output(label: str, result) -> None:
    if not telemetry.enabled():
        return
    if label not in _DISPATCH_SIGS:
        return
    nb = _tree_nbytes(result)
    if nb > 0:
        ledger.output(nb, label)


def note_freed(nbytes: int | None = None, label: str | None = None) -> None:
    if not telemetry.enabled():
        return
    ledger.freed(nbytes=nbytes, label=label)


def footprint_from_capture(argument_bytes: int, output_bytes: int,
                           pool_bytes: int) -> dict:
    """A rung's footprint in the reference's four fields: the state and
    input it reads, the outputs it writes (every buffer set), and the
    capture's graph pool (``torch.cuda.memory_allocated`` across the
    capture, less the static outputs) as its temporaries.  No code lives
    in device memory."""
    return {"argument_bytes": int(argument_bytes),
            "output_bytes": int(output_bytes),
            "temp_bytes": max(int(pool_bytes), 0),
            "generated_code_bytes": 0}


def note_executable(name: str, footprint: dict | None,
                    source: str = "compile") -> None:
    if not telemetry.enabled() or not footprint:
        return
    ledger.executable(name, footprint, source)


def note_superstep(tracer) -> None:
    """Thread the window peak onto an open steptrace span as a mark (a
    no-op while the ledger has recorded nothing)."""
    if not telemetry.enabled() or not ledger._rows:
        return
    tracer.mark("memory", "superstep_peak",
                peak_hbm_bytes=ledger.window_peak(),
                live_hbm_bytes=ledger.live_bytes)


def _require_fit(kernel: str, predicted_bytes: int, budget: int,
                 space: str, what: str) -> None:
    fits = int(predicted_bytes) <= int(budget)
    if telemetry.enabled():
        ledger.vmem_check(kernel, predicted_bytes, budget, fits, space)
    if not fits:
        raise MemoryError(
            f"memrec: {kernel} needs {int(predicted_bytes)} B "
            f"({predicted_bytes / (1 << 20):.2f} MiB) of {what}, above the "
            f"{int(budget)} B ({int(budget) / (1 << 20):.2f} MiB) it may "
            "have — refused before dispatch")


def smem_optin(device=None) -> int:
    """A block's opt-in shared memory on ``device``'s card
    (``shared_memory_per_block_optin``), or the H100's
    (``kernel_registry.H100_SMEM_OPTIN``) when no device is given."""
    if device is None:
        from harp_tpu_torch.ops.kernel_registry import H100_SMEM_OPTIN

        return H100_SMEM_OPTIN
    import torch

    return int(torch.cuda.get_device_properties(
        device).shared_memory_per_block_optin)


def hbm_free(device=None) -> int:
    """The device memory a launch may still take: the card's free bytes
    (``torch.cuda.mem_get_info``) on a CUDA device, else the ledger's
    capacity (``hbm_bytes``)."""
    import torch

    if device is not None and torch.device(device).type == "cuda":
        return int(torch.cuda.mem_get_info(device)[0])
    return int(ledger.hbm_bytes)


def require_smem_fit(kernel: str, predicted_bytes: int, *,
                     budget: int | None = None, device=None) -> None:
    """Refuse a kernel config whose block needs more shared memory than
    the card gives one, BEFORE it launches.

    ``budget`` defaults to ``device``'s opt-in shared memory a block
    (:func:`smem_optin`; the H100's when no device is given).  Raises
    ``MemoryError`` whatever the telemetry state (a safety gate, not a
    collector); records a ``vmem_check`` row (``space: "smem"``) when
    telemetry is on."""
    if budget is None:
        budget = smem_optin(device)
    _require_fit(kernel, predicted_bytes, budget, "smem",
                 "shared memory a block")


def require_hbm_fit(kernel: str, predicted_bytes: int, *,
                    budget: int | None = None, device=None) -> None:
    """Refuse a kernel config whose buffers need more device memory than
    is free, BEFORE any of them is allocated.

    ``budget`` defaults to :func:`hbm_free` (the card's free bytes on a
    CUDA device, the ledger's ``hbm_bytes`` on the CPU).  Raises
    ``MemoryError`` whatever the telemetry state; records a
    ``vmem_check`` row (``space: "hbm"``) when telemetry is on."""
    if budget is None:
        budget = hbm_free(device)
    _require_fit(kernel, predicted_bytes, budget, "hbm", "device memory")


def set_hbm_capacity(nbytes: int) -> None:
    ledger.hbm_bytes = int(nbytes)


def snapshot() -> dict:
    """Cheap counters for bench submetric deltas."""
    return {"peak_hbm_bytes": ledger.peak_bytes,
            "staged_bytes": ledger.staged_bytes,
            "donated_bytes": ledger.donated_bytes,
            "events": len(ledger._rows)}


def delta_since(base: dict | None) -> dict:
    base = base or {"peak_hbm_bytes": 0, "staged_bytes": 0,
                    "donated_bytes": 0, "events": 0}
    return {
        "peak_hbm_bytes": ledger.peak_bytes,
        "headroom_frac": round(ledger.headroom_frac(), 6),
        "staged_bytes": ledger.staged_bytes - base["staged_bytes"],
        "donated_bytes": ledger.donated_bytes - base["donated_bytes"],
        "events": len(ledger._rows) - base["events"],
    }


def live_summary() -> dict | None:
    """Report-section view of the in-process ledger.

    Unlike :meth:`MemLedger.summary_row` this does NOT bump the event
    seq — the report may render the same run any number of times
    without perturbing a later export."""
    if not ledger._rows:
        return None
    return {
        "events": len(ledger._rows),
        "staged_bytes": ledger.staged_bytes,
        "freed_bytes": ledger.freed_bytes,
        "donated_bytes": ledger.donated_bytes,
        "peak_hbm_bytes": ledger.peak_bytes,
        "live_hbm_bytes": ledger.live_bytes,
        "hbm_bytes": ledger.hbm_bytes,
        "headroom_frac": round(ledger.headroom_frac(), 6),
        "executables": len(ledger._execs),
        "exec_hbm_bytes": ledger.exec_total(),
        "vmem_checks": ledger.vmem_checks,
        "vmem_refusals": ledger.vmem_refusals,
    }


def export_jsonl(fh) -> None:
    """Provenance-stamped kind:'memory' rows + ONE closing summary."""
    if not ledger._rows:
        return
    from harp_tpu_torch.utils import flightrec
    stamp = flightrec.provenance_stamp()
    for row in ledger._rows:
        fh.write(json.dumps({**row, **stamp}) + "\n")
    fh.write(json.dumps({**ledger.summary_row(), **stamp}) + "\n")


# ---------------------------------------------------------------------
# Offline summarize / CLI (exit 0 clean, 1 irreconciled, 2 unreadable)
# ---------------------------------------------------------------------

def summarize_rows(rows: list[dict]) -> dict:
    """Re-derive the watermark from the event stream; collect errors.

    The reference's replay: live/peak on every
    row must equal the derived value EXACTLY, donated buffers must have
    left the live set, and the one summary row must match the final
    derived state."""
    errors: list[str] = []
    live: dict[int, int] = {}
    live_b = peak = 0
    staged = freed = donated = 0
    execs = exec_b = checks = refusals = 0
    last_seq = 0
    summary = None
    buffers = dispatches = 0
    for i, row in enumerate(rows, 1):
        ev = row.get("ev")
        seq = row.get("seq", 0)
        if isinstance(seq, int) and seq <= last_seq:
            errors.append(f"row {i}: seq {seq} not increasing")
        last_seq = seq if isinstance(seq, int) else last_seq
        if summary is not None and ev != "summary":
            errors.append(f"row {i}: {ev} row after the summary row")
        if ev == "buffer":
            buffers += 1
            e, b = row.get("event"), row.get("buf")
            nb = int(row.get("bytes", 0))
            if e in ("staged", "output"):
                live[b] = nb
                live_b += nb
                peak = max(peak, live_b)
                if e == "staged":
                    staged += nb
            elif e in ("freed", "donated"):
                if b not in live:
                    errors.append(
                        f"row {i}: {e} buf {b} is not in the live set")
                else:
                    live_b -= live.pop(b)
                if e == "freed":
                    freed += nb
                else:
                    donated += nb
            elif e == "restored":
                pass  # zero-delta by design
            else:
                errors.append(f"row {i}: unknown buffer event {e!r}")
            if row.get("live_bytes") != live_b:
                errors.append(
                    f"row {i}: live_bytes {row.get('live_bytes')} != "
                    f"derived {live_b}")
            if row.get("peak_bytes") != peak:
                errors.append(
                    f"row {i}: peak_bytes {row.get('peak_bytes')} != "
                    f"derived {peak}")
        elif ev == "dispatch":
            dispatches += 1
            for b in row.get("donated", []):
                if b in live:
                    errors.append(
                        f"row {i}: donated buf {b} still in the live "
                        "set after dispatch")
            if row.get("live_bytes") != live_b:
                errors.append(
                    f"row {i}: dispatch live_bytes "
                    f"{row.get('live_bytes')} != derived {live_b}")
        elif ev == "executable":
            execs += 1
            parts = sum(int(row.get(k, 0)) for k in (
                "argument_bytes", "output_bytes", "temp_bytes",
                "generated_code_bytes"))
            if parts != row.get("exec_hbm_bytes"):
                errors.append(
                    f"row {i}: exec_hbm_bytes != component sum")
            exec_b += int(row.get("exec_hbm_bytes", 0))
        elif ev == "vmem_check":
            checks += 1
            if row.get("refused"):
                refusals += 1
            fits = (int(row.get("predicted_bytes", 0))
                    <= int(row.get("budget_bytes", 0)))
            if bool(row.get("fits")) != fits:
                errors.append(f"row {i}: fits flag contradicts bytes")
        elif ev == "summary":
            if summary is not None:
                errors.append(f"row {i}: second summary row")
            summary = row
            for k, v in (("peak_hbm_bytes", peak),
                         ("live_hbm_bytes", live_b),
                         ("staged_bytes", staged),
                         ("freed_bytes", freed),
                         ("donated_bytes", donated),
                         ("vmem_checks", checks),
                         ("vmem_refusals", refusals)):
                if row.get(k) != v:
                    errors.append(
                        f"row {i}: summary {k}={row.get(k)} != "
                        f"derived {v}")
    if rows and summary is None:
        errors.append("no summary row — the export is unterminated")
    return {
        "rows": len(rows), "buffers": buffers, "dispatches": dispatches,
        "executables": execs, "exec_hbm_bytes": exec_b,
        "vmem_checks": checks, "vmem_refusals": refusals,
        "staged_bytes": staged, "freed_bytes": freed,
        "donated_bytes": donated, "peak_hbm_bytes": peak,
        "live_hbm_bytes": live_b,
        "hbm_bytes": (summary or {}).get("hbm_bytes"),
        "headroom_frac": (summary or {}).get("headroom_frac"),
        "errors": errors,
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m harp_tpu_torch memory",
        description="device-memory ledger: validate/summarize "
                    "kind:'memory' rows from a run export")
    p.add_argument("jsonl", help="telemetry export (HARP_TELEMETRY_OUT)")
    p.add_argument("--json", action="store_true",
                   help="print the summary as one JSON line")
    args = p.parse_args(argv)
    try:
        rows = telemetry.load_rows(args.jsonl)["memory"]
    except OSError as e:
        print(f"memory: unreadable: {e}", file=sys.stderr)
        return 2
    s = summarize_rows(rows)
    if args.json:
        from harp_tpu_torch.utils import flightrec
        print(json.dumps({**s, **flightrec.provenance_stamp()}))
    else:
        print(f"memory: {s['rows']} row(s), {s['buffers']} buffer "
              f"event(s), {s['dispatches']} dispatch(es), "
              f"{s['executables']} executable(s)")
        print(f"  peak HBM      {s['peak_hbm_bytes']} B"
              + (f"  (headroom {s['headroom_frac']:.1%} of "
                 f"{s['hbm_bytes']} B)"
                 if s.get("headroom_frac") is not None else ""))
        print(f"  staged {s['staged_bytes']} B / donated "
              f"{s['donated_bytes']} B / freed {s['freed_bytes']} B / "
              f"live {s['live_hbm_bytes']} B")
        print(f"  exec footprints {s['exec_hbm_bytes']} B; vmem checks "
              f"{s['vmem_checks']} ({s['vmem_refusals']} refused)")
        for e in s["errors"]:
            print(f"  IRRECONCILED: {e}", file=sys.stderr)
    if not rows:
        print("memory: no kind:'memory' rows in the export",
              file=sys.stderr)
        return 1
    return 1 if s["errors"] else 0


if __name__ == "__main__":
    sys.exit(main())
