"""Streaming KMeans: the blocked-epoch Lloyd loop of
``harp_tpu_torch.models.kmeans_stream`` over the benchmark's own chunks.

The window drives ``kmeans_stream._synthetic_run`` one epoch a call, the
loop the program's ``benchmark_streaming`` times, with the benchmark's
chunk source (``gen.MixtureChunks``) as its ``gen`` and the centroids
handed back in each call.  The initial centroids and the int8 feature
scales are made here from the seed and given alike to the program and to
the reference.

Set-up runs ``checked_steps`` epochs through the same call; they are the
steps the reference follows, and the warm-up.  The window then runs
``ceil(seconds / last set-up epoch)`` epochs (at least one), each ended
by a synchronize on its inertia.  With ``--trace 1`` the last window epoch
holds a profiled slice of ``trace_chunks`` chunks from its middle.
"""

from __future__ import annotations

import math
import time

import torch

from portbench import gen, trace
from portbench.reference import kmeans_stream as ref
from portbench.work import counts

#: K1's kernels (the int8 partials' library) and its main kernel, one a
#: launch of the wrapper
K1_NAMES = r"km::main_kernel|km::range_kernel|\bpack_kernel\("
K1_MAIN = r"km::main_kernel"


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
        self.int8 = ctx.traffic["precision"] == "int8"

    def setup(self) -> None:
        from harp_tpu_torch.models import kmeans_stream as KS

        ctx, cfg = self.ctx, self.ctx.config
        # the configuration's f32: full f32 products (TF32 off)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.data = gen.MixtureChunks(cfg, ctx.seed, ctx.device)
        self.c0 = self.data.initial_centroids(cfg["k"])
        self.col_scale = self.data.col_scale() if self.int8 else None
        self.n_chunks = ctx.traffic["chunks"]
        self.scfg = KS.StreamConfig(k=cfg["k"],
                                    chunk_points=cfg["chunk_points"],
                                    quantize="int8" if self.int8 else None)
        self.c = self.c0
        self.epoch_s: list[float] = []
        self._slice = None

    def initial(self):
        return self.c0

    def _gen(self, j: int) -> torch.Tensor:
        s = self._slice
        if s is not None:
            if j == s["first"] and not s["slice"].open:
                s["slice"].start()
                s["launches"] = self._k1_launches()
            elif j == s["first"] + s["chunks"] and s["slice"].open:
                s["slice"].stop()
                s["launches"] = self._k1_launches() - s["launches"]
        with torch.profiler.record_function("portbench.gen"):
            return self.data.chunk(j)

    @staticmethod
    def _k1_launches() -> int:
        from harp_tpu_torch.ops import kmeans_kernel

        return kmeans_kernel.LAUNCHES["kmeans_partials_int8"]

    def _epoch(self) -> float:
        """One epoch through the program; returns its inertia (a sync)."""
        from harp_tpu_torch.models import kmeans_stream as KS

        t0 = time.perf_counter()
        with torch.profiler.record_function("portbench.epoch"):
            self.c, inertia = KS._synthetic_run(
                self.c, 1, self._gen, self.n_chunks, self.scfg,
                self.col_scale)
            val = float(inertia)
        self.epoch_s.append(time.perf_counter() - t0)
        return val

    def steps(self, n: int) -> list:
        out = []
        for _ in range(n):
            loss = self._epoch()
            out.append((self.c.clone(), loss))
        return out

    def window(self, seconds: float, traced: bool) -> dict:
        cfg, dev = self.ctx.config, self.ctx.device
        n_epochs = max(1, math.ceil(seconds / self.epoch_s[-1]))
        start = len(self.epoch_s)
        t0 = time.perf_counter()
        for e in range(n_epochs):
            if traced and e == n_epochs - 1:
                chunks = max(1, min(self.ctx.traffic["trace_chunks"],
                                    self.n_chunks - 1))
                self._slice = {"slice": trace.Slice(dev), "chunks": chunks,
                               "first": (self.n_chunks - chunks) // 2}
            self._epoch()
        wall = time.perf_counter() - t0
        points = self.n_chunks * cfg["chunk_points"]
        out = {"e2e": {"kmeans_points_per_s": n_epochs * points / wall},
               "attempted": n_epochs, "failed": 0,
               "memory_peak_bytes": (torch.cuda.max_memory_allocated(dev)
                                     if dev.type == "cuda" else 0)}
        if traced:
            out.update(self._record(self.epoch_s[start:], points))
        return out

    def _record(self, window_epochs: list, points: int) -> dict:
        s, self._slice = self._slice, None
        red = trace.reduce(s["slice"].collect(), s["slice"].window_s,
                           {"K1": K1_NAMES})
        seen = trace.count_tag(red, "K1", K1_MAIN)
        if seen != s["launches"]:
            raise trace.TraceShort(f"K1: the trace holds {seen} of the "
                                   f"{s['launches']} launches of its slice")
        cfg = self.ctx.config
        clean = window_epochs[:-1] or window_epochs
        prec = "int8" if self.int8 else "f32"
        record = {
            "trace": red,
            "slice": {"chunks": s["chunks"]},
            "work": {"k1_chunk_bound_s": counts.k1_chunk(
                         cfg["chunk_points"], cfg["d"], cfg["k"])["bound_s"],
                     "epoch_bound_s": counts.lloyd_epoch(
                         points, cfg["d"], cfg["k"], prec)["bound_s"]},
            "host": {"epoch_s": sum(clean) / len(clean)},
        }
        return {"record": record, "breakdown": trace.breakdown(red)}

    def release(self) -> None:
        self.c = None
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, n: int, precision: str) -> list:
        return ref.lloyd(self.c0, self.data.chunk, self.n_chunks, n,
                         precision, self.col_scale)
