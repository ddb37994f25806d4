"""MF-SGD with model rotation: ``harp_tpu_torch.models.mfsgd.MFSGD``
trained epoch by epoch on the benchmark's own ratings.

Set-up makes the ratings and the initial global factors on the card from
the seed (``gen.ratings``, ``gen.factors``), hands the factors to the
program in its storage layout (``MFSGD(state=...)``), and runs
``set_ratings`` (the partition and K3's level schedules, timed as
``prep_s``) and ``checked_steps`` epochs of ``train_epoch``: the steps the
reference follows, and the warm-up.  The window calls ``train_epoch``
``ceil(seconds / median set-up epoch)`` times (what ``MFSGD.fit`` does
without checkpoints), each timed on the host clock to the end of its own
readback.  With ``--trace 1`` a slice of ``trace_epochs`` epochs from the
window's middle is profiled.
"""

from __future__ import annotations

import math
import statistics
import time

import numpy as np
import torch

from portbench import gen, trace
from portbench.reference import mfsgd as ref
from portbench.work import counts

#: the numbers that decide ``correct`` (``compare.numbers``), and the kind
#: of entry whose metrics this driver's cells report
LIMITS = ("loss_gap", "first_change_gap", "change_gap")
FAMILY = "mfsgd"

#: K3's kernel, one launch a rotation step
K3_NAMES = r"sgd_step_kernel"

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx

    def _model_config(self):
        from harp_tpu_torch.models import mfsgd as MF

        c = self.ctx.config
        return MF.MFSGDConfig(rank=c["rank"], lr=c["lr"], reg=c["reg"],
                              algo=c["algo"], u_tile=c["u_tile"],
                              i_tile=c["i_tile"], entry_cap=c["entry_cap"],
                              compute_dtype=_DTYPES[c["compute_dtype"]],
                              rotate_chunks=c["rotate_chunks"])

    def _storage(self, W, H) -> dict:
        """The global factors in the program's storage layout on one
        worker: W's rows padded to whole user tiles, H in ``rotate_chunks``
        slices each padded to whole item tiles (``MFSGD``'s docstring)."""
        from harp_tpu_torch.models import mfsgd as MF

        c = self.ctx.config
        nc = c["rotate_chunks"]
        u_own, i_own, u_bound, ibc = MF._dense_bounds(
            c["n_users"], c["n_items"], 1, nc, c["u_tile"], c["i_tile"])
        Ws = W.new_zeros((u_bound, W.shape[1]))
        Ws[:u_own] = W
        Hs = H.new_zeros((nc * ibc, H.shape[1]))
        for s in range(nc):
            part = H[s * i_own:(s + 1) * i_own]
            Hs[s * ibc:s * ibc + part.shape[0]] = part
        return {"W": Ws, "H": Hs}

    def setup(self) -> None:
        from harp_tpu_torch.models import mfsgd as MF
        from harp_tpu_torch.parallel.mesh import WorkerMesh

        ctx, c = self.ctx, self.ctx.config
        dev = ctx.device
        self.users, self.items, self.vals = gen.ratings(c, ctx.traffic,
                                                        ctx.seed, dev)
        self.W0, self.H0 = gen.factors(c, ctx.seed, dev)
        self.touched = (int(torch.unique(self.users).numel()),
                        int(torch.unique(self.items).numel()))
        mesh = WorkerMesh(dev)
        if mesh.num_workers != 1:
            raise RuntimeError("this driver runs one worker")
        self.model = MF.MFSGD(c["n_users"], c["n_items"],
                              self._model_config(), mesh,
                              state=self._storage(self.W0, self.H0))
        host = (self.users.to(torch.int32).cpu().numpy(),
                self.items.to(torch.int32).cpu().numpy(),
                self.vals.cpu().numpy())
        t0 = time.perf_counter()
        with torch.profiler.record_function("portbench.set_ratings"):
            self.model.set_ratings(*host)
        self.prep_s = time.perf_counter() - t0
        self.epoch_s: list[float] = []

    def initial(self):
        return [self.W0.cpu(), self.H0.cpu()]

    def _factors(self) -> list:
        W, H = self.model.factors()
        return [torch.from_numpy(np.ascontiguousarray(W)),
                torch.from_numpy(np.ascontiguousarray(H))]

    def _epoch(self) -> float:
        t0 = time.perf_counter()
        with torch.profiler.record_function("portbench.epoch"):
            rmse = self.model.train_epoch()
        self.epoch_s.append(time.perf_counter() - t0)
        return rmse

    def steps(self, n: int) -> list:
        out = []
        for _ in range(n):
            rmse = self._epoch()
            out.append((self._factors(), rmse))
        return out

    @staticmethod
    def _k3_launches() -> int:
        from harp_tpu_torch.ops import mfsgd_kernel

        return mfsgd_kernel.LAUNCHES["sgd_tile_update"]

    def window(self, seconds: float, traced: bool) -> dict:
        dev = self.ctx.device
        est = statistics.median(self.epoch_s[1:] or self.epoch_s)
        n_epochs = self.ctx.agree(max(1, math.ceil(seconds / est)))
        span = min(self.ctx.traffic["trace_epochs"], n_epochs) if traced \
            else 0
        first = (n_epochs - span) // 2
        start = len(self.epoch_s)
        sl, launches = None, 0
        t0 = time.perf_counter()
        for e in range(n_epochs):
            if traced and e == first:
                sl = trace.Slice(dev)
                sl.start()
                launches = self._k3_launches()
            self._epoch()
            if sl is not None and sl.open and e == first + span - 1:
                sl.stop()
                launches = self._k3_launches() - launches
        wall = time.perf_counter() - t0
        times = self.epoch_s[start:]
        nnz = self.ctx.config["nnz"]
        out = {"e2e": {"mfsgd_updates_per_s": n_epochs * nnz / wall,
                       "mfsgd_epoch_p95_ms":
                           float(np.percentile(times, 95)) * 1e3},
               "attempted": n_epochs, "failed": 0,
               "memory_peak_bytes": (torch.cuda.max_memory_allocated(dev)
                                     if dev.type == "cuda" else 0)}
        if traced:
            out.update(self._record(sl, launches, span, times, first))
        return out

    def _record(self, sl, launches, span, times, first) -> dict:
        red = trace.reduce(sl.collect(), sl.window_s, {"K3": K3_NAMES})
        seen = trace.count_tag(red, "K3")
        if seen != launches:
            raise trace.TraceShort(f"K3: the trace holds {seen} of the "
                                   f"{launches} launches of its slice")
        c = self.ctx.config
        clean = times[:first] + times[first + span:] or times
        record = {
            "trace": red,
            "slice": {"epochs": span},
            "work": {"epoch_bound_s": counts.mfsgd_epoch(
                c["nnz"], *self.touched, c["rank"])["bound_s"]},
            "host": {"epoch_s": sum(clean) / len(clean),
                     "prep_s": self.prep_s},
        }
        return {"record": record, "breakdown": trace.breakdown(red)}

    def release(self) -> None:
        self.model = None
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, n: int, precision: str) -> list:
        c = self.ctx.config
        plan = ref.Plan(self.users, self.items, self.vals, c)
        runs = ref.sgd_epochs(plan, self.W0, self.H0, n, lr=c["lr"],
                              reg=c["reg"], precision=precision)
        return [([W.cpu(), H.cpu()], rmse) for W, H, rmse in runs]
