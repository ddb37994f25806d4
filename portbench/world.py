"""The process world of a cell of more than one card (``chips`` > 1); its
contract is ``harness.py``'s module docstring.

:func:`run` spawns ranks 1 to n − 1 (the ``spawn`` start method) and
joins rank 0, the measuring process, to them; each worker runs
``harness.drive`` and sends rank 0 a report, or its traceback.  A watcher
thread in rank 0 reads them and sees a worker end.  On a failure it
prints every failed rank's traceback on standard error and ends every
worker; gloo then fails rank 0's collective and the run raises
:class:`WorldError`.  NCCL does not notice a lost peer: where rank 0 is
still held in a collective :data:`_HARD_EXIT_S` seconds after the failure
was seen, its process exits with code 3, printing no result.  A worker
ends itself when rank 0's process ends.
"""

from __future__ import annotations

import datetime
import multiprocessing
import os
import queue
import shutil
import sys
import tempfile
import threading
import time
import traceback
from pathlib import Path

import torch

#: seconds the join, and any one collective, may wait
TIMEOUT_S = 300
#: seconds from a rank's failure to the end of the run: its detection, the
#: wait before a hard exit, and the workers' end
FAIL_S = 30
_POLL_S = 0.2
#: seconds after a failure is seen before rank 0's process is ended, where
#: it is still held in a collective
_HARD_EXIT_S = 15
#: seconds rank 0, its own run failed, waits for a worker's failure to show
_GRACE_S = 3
_JOIN_S = 5


class WorldError(RuntimeError):
    """A rank of the world raised or died."""


def _join(rank: int, n: int, rendezvous: str,
          device: torch.device) -> None:
    import torch.distributed as dist

    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        "nccl" if device.type == "cuda" else "gloo",
        init_method=f"file://{rendezvous}", world_size=n, rank=rank,
        timeout=datetime.timedelta(seconds=TIMEOUT_S))


def _end_with_parent() -> None:
    """End this worker when rank 0's process ends, however it ends."""
    parent = multiprocessing.parent_process()

    def watch():
        parent.join()
        os._exit(1)

    threading.Thread(target=watch, daemon=True).start()


def _worker(rank: int, n: int, rendezvous: str, job: dict, out) -> None:
    """Rank ``rank`` of the world: the cell's sequence, then a report."""
    _end_with_parent()
    try:
        import torch.distributed as dist

        from portbench import harness

        root = Path(job["root"])
        m = harness.load_manifest(root)
        cell, config, traffic = harness.cell_files(
            m, root, job["workload"], job["overrides"])
        device = torch.device(job["device"], rank) \
            if job["device"] == "cuda" else torch.device(job["device"])
        _join(rank, n, rendezvous, device)
        ctx = harness.Context(cell, config, traffic, job["seed"], device,
                              time.perf_counter(), rank=rank, world=n)
        got, _ = harness.drive(ctx, job["seconds"], job["trace"])
        report = {"memory_peak_bytes": got["memory_peak_bytes"],
                  "forbidden": harness.forbidden_modules()}
        if job["trace"]:
            tr = got["record"]["trace"]
            report["slice"] = {"busy_s": tr["busy_s"],
                               "window_s": tr["window_s"]}
        out.put((rank, "ok", report))
        dist.destroy_process_group()
    except BaseException:  # sent to rank 0, which fails the run
        out.put((rank, "error", traceback.format_exc()))
        out.close()
        out.join_thread()
        os._exit(1)


class _World:
    """Rank 0's side: the workers, their reports and failures."""

    def __init__(self, n: int, job: dict):
        self.n = n
        self.dir = tempfile.mkdtemp(prefix="portbench-world-")
        self.rendezvous = os.path.join(self.dir, "rendezvous")
        mp = multiprocessing.get_context("spawn")
        self.out = mp.Queue()
        self.procs = {r: mp.Process(target=_worker, daemon=True,
                                    args=(r, n, self.rendezvous, job,
                                          self.out))
                      for r in range(1, n)}
        self.reports: dict[int, dict] = {}
        self.failed: dict[int, str] = {}  # in the order seen
        self.died: list[int] = []  # ended with no report: the first cause
        self.seen = threading.Event()  # a failure, or every report
        self.stop = threading.Event()
        self.lock = threading.Lock()
        self.kill_lock = threading.Lock()
        self.timer = None
        self.watcher = None

    def start(self) -> None:
        for p in self.procs.values():
            p.start()
        self.watcher = threading.Thread(target=self._watch, daemon=True)
        self.watcher.start()

    def _take(self, item) -> None:
        rank, status, payload = item
        if status == "ok":
            self.reports[rank] = payload
        else:
            self.failed[rank] = payload

    def _drain(self) -> None:
        while True:
            try:
                self._take(self.out.get_nowait())
            except queue.Empty:
                return

    def _watch(self) -> None:
        while not self.stop.is_set():
            try:
                self._take(self.out.get(timeout=_POLL_S))
            except queue.Empty:
                pass
            ended = [r for r, p in self.procs.items()
                     if p.exitcode is not None]
            if ended:
                # what an ended worker sent is in the pipe before it ends
                self._drain()
            for r in ended:
                if r not in self.reports and r not in self.failed:
                    self.died.append(r)
                    self.failed[r] = (f"rank {r} ended with exit code "
                                      f"{self.procs[r].exitcode} before "
                                      f"its report\n")
            if self.failed:
                time.sleep(_POLL_S)  # the ranks it takes down report too
                self._drain()
                self._fail()
                return
            if len(self.reports) == self.n - 1:
                self.seen.set()
                return

    def _fail(self) -> None:
        self.arm()
        for r in sorted(self.failed):
            print(f"portbench: rank {r} of the world failed:\n"
                  f"{self.failed[r]}", file=sys.stderr, flush=True)
        self.seen.set()
        self.kill()

    def arm(self) -> None:
        """End this process in :data:`_HARD_EXIT_S` seconds unless the run
        is torn down before then."""
        with self.lock:
            if self.timer is None:
                self.timer = threading.Timer(_HARD_EXIT_S, self._hard_exit)
                self.timer.daemon = True
                self.timer.start()

    def _hard_exit(self) -> None:
        print("portbench: rank 0 is held in a collective after a rank "
              "failed; ending the run", file=sys.stderr, flush=True)
        self.kill()
        shutil.rmtree(self.dir, ignore_errors=True)
        os._exit(3)

    def kill(self) -> None:
        with self.kill_lock:
            for p in self.procs.values():
                if p.is_alive():
                    p.terminate()
            for p in self.procs.values():
                p.join(_JOIN_S)
                if p.is_alive():
                    p.kill()
                    p.join(_JOIN_S)

    def error(self) -> WorldError | None:
        """The first cause: a rank that died, else the first to raise (the
        ranks it takes down raise after it)."""
        if not self.failed:
            return None
        first = (self.died or list(self.failed))[0]
        return WorldError(f"rank {first} of {self.n} failed "
                          f"(failed ranks {sorted(self.failed)}):\n"
                          f"{self.failed[first]}")

    def close(self, failing: bool) -> None:
        import torch.distributed as dist

        if failing:
            self.arm()
        self.stop.set()
        if dist.is_initialized():
            dist.destroy_process_group()
        for p in self.procs.values():
            p.join(_JOIN_S)
        self.kill()
        if self.watcher is not None:
            self.watcher.join(_JOIN_S)
        self.out.close()
        shutil.rmtree(self.dir, ignore_errors=True)
        with self.lock:
            if self.timer is not None:
                self.timer.cancel()


def run(ctx, seconds: float, trace: bool, *, root: Path,
        overrides: dict | None) -> tuple[dict, dict]:
    """``harness.drive`` on rank 0 of a world of ``ctx.world`` ranks, the
    same on every worker → rank 0's window output, with the fullest card's
    ``memory_peak_bytes`` and, traced, ``world_slice`` (the means of the
    ranks' busy and window seconds), and rank 0's numbers."""
    from portbench import harness

    n = ctx.world
    job = {"workload": ctx.cell["name"], "seed": ctx.seed,
           "seconds": seconds, "trace": trace, "root": str(root),
           "overrides": overrides or {}, "device": ctx.device.type}
    w = _World(n, job)
    failing = True
    try:
        w.start()
        try:
            _join(0, n, w.rendezvous, ctx.device)
            out, values = harness.drive(ctx, seconds, trace)
        except Exception as e:
            # a rank's failure shows here as a collective that failed
            w.seen.wait(_GRACE_S)
            err = w.error()
            if err is not None:
                raise err from e
            raise
        if not w.seen.wait(TIMEOUT_S) or w.failed:
            raise w.error() or WorldError(
                f"{n - 1 - len(w.reports)} workers sent no report within "
                f"{TIMEOUT_S} s")
        failing = False
    finally:
        w.close(failing)
    reports = [w.reports[r] for r in sorted(w.reports)]
    bad = sorted({x for r in reports for x in r["forbidden"]})
    if bad:
        raise SystemExit(f"portbench: a worker of the world holds {bad}")
    out["memory_peak_bytes"] = max(
        [out["memory_peak_bytes"]] + [r["memory_peak_bytes"]
                                      for r in reports])
    if trace:
        slices = [out["record"]["trace"]] + [r["slice"] for r in reports]
        out["world_slice"] = {
            k: sum(s[k] for s in slices) / len(slices)
            for k in ("busy_s", "window_s")}
    return out, values
