"""The world smoke: the program's own verbs across a process world,
checked exactly, and a ring hop timed.  Listed in no cell of the
benchmark; the tests add one, on gloo workers, to prove the world path,
and a scratch manifest runs it on four cards.

Each rank calls ``harp_tpu_torch.parallel.collective.allreduce`` (ADD) on a
vector of small whole numbers and ``collective.rotate`` (the ring move,
shift 1) on a vector of normal draws, both made on its device from the
seed and its rank, once a checked step, and then moves a buffer of
``size_gb`` (10⁹ bytes, f32) around the ring ``step_hops`` times back to
back by ``collective.rotate``.  The window makes ``ctx.agree(⌈seconds /
the last step's hop⌉)`` more hops and reports a hop's time and rate on
the host clock over all of them.

``correct`` (:meth:`Driver.numbers`), summed over the ranks:

- ``allreduce_mismatch``: the elements of an allreduce that differ from
  the plain sum of every rank's vector (whole numbers: the sum is exact in
  any order);
- ``rotate_mismatch``: the elements of a rotated vector that differ from
  the vector of rank ``r − 1``;
- ``hop_mismatch``: the elements of the buffer after every hop of set-up
  and the window that differ from the buffer of rank ``r − hops``.

``fail_rank`` (config, tests only) plants a fault on that rank in set-up:
``fail_how`` ``raise`` (an exception) or ``die`` (the process ends).
"""

from __future__ import annotations

import math
import os
import time

import torch

from portbench import gen, trace

LIMITS = ("allreduce_mismatch", "rotate_mismatch", "hop_mismatch")
FAMILY = "world"

#: the NCCL and gloo kernels of a ring hop
HOP_NAMES = r"nccl|Sendrecv|SendRecv|gloo"


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx

    def _vectors(self, rank: int, step: int) -> tuple:
        """Rank ``rank``'s allreduce and rotate inputs at ``step``."""
        n, dev = self.ctx.config["elements"], self.ctx.device
        g = torch.Generator(device=dev)
        g.manual_seed(gen.seed64(self.ctx.seed, 1, rank, step))
        whole = torch.randint(-64, 65, (n,), generator=g, device=dev)
        return whole.float(), torch.randn(n, generator=g, device=dev)

    def _buffer(self, rank: int) -> torch.Tensor:
        g = torch.Generator(device=self.ctx.device)
        g.manual_seed(gen.seed64(self.ctx.seed, 2, rank))
        return torch.randn(self.hop_elements, generator=g,
                           device=self.ctx.device)

    def _sync(self) -> None:
        if self.ctx.device.type == "cuda":
            torch.cuda.synchronize(self.ctx.device)

    def setup(self) -> None:
        ctx, c = self.ctx, self.ctx.config
        if ctx.rank == c.get("fail_rank"):
            if c.get("fail_how") == "die":
                os._exit(7)
            raise RuntimeError(f"a fault planted on rank {ctx.rank}")
        self.hop_elements = int(c["size_gb"] * 1e9) // 4
        self.buf = self._buffer(ctx.rank)
        self.hops = 0
        self.hop_s = 0.0

    def initial(self):
        return None

    def _hop(self) -> None:
        from harp_tpu_torch.parallel import collective

        self.buf = collective.rotate(self.buf, 1)
        self.hops += 1

    def steps(self, n: int) -> list:
        """``n`` checked steps: an allreduce, a rotate and timed hops."""
        from harp_tpu_torch.parallel import collective

        hops = self.ctx.traffic["step_hops"]
        out = []
        for i in range(n):
            whole, draws = self._vectors(self.ctx.rank, i)
            summed = collective.allreduce(whole)
            moved = collective.rotate(draws, 1)
            self._sync()
            t0 = time.perf_counter()
            for _ in range(hops):
                self._hop()
            self._sync()
            self.hop_s = (time.perf_counter() - t0) / hops
            out.append((summed.cpu(), moved.cpu()))
        return out

    def window(self, seconds: float, traced: bool) -> dict:
        ctx = self.ctx
        n = ctx.agree(max(1, math.ceil(seconds / self.hop_s)))
        span = min(ctx.traffic["trace_hops"], n) if traced else 0
        first = (n - span) // 2
        sl = None
        self._sync()
        t0 = time.perf_counter()
        for i in range(n):
            if traced and i == first:
                sl = trace.Slice(ctx.device)
                sl.start()
            self._hop()
            if sl is not None and sl.open and i == first + span - 1:
                sl.stop()
        self._sync()
        wall = time.perf_counter() - t0
        nbytes = self.hop_elements * 4
        ctx.log(f"{n} hops of {nbytes} bytes in {wall:.4f} s; set-up's last "
                f"{ctx.traffic['step_hops']} {1e3 * self.hop_s:.4f} ms each")
        out = {"e2e": {"ring_hop_ms": 1e3 * wall / n,
                       "ring_hop_gb_per_s": n * nbytes / wall / 1e9},
               "attempted": n, "failed": 0,
               "memory_peak_bytes": (torch.cuda.max_memory_allocated(
                   ctx.device) if ctx.device.type == "cuda" else 0)}
        if traced:
            red = trace.reduce(sl.collect(), sl.window_s, {"hop": HOP_NAMES})
            out["record"] = {"trace": red, "slice": {"hops": span}}
            out["breakdown"] = trace.breakdown(red)
        return out

    def release(self) -> None:
        """Keep the buffer the checks judge."""

    def reference(self, n: int, precision: str) -> dict:
        """The plain sums and the vectors each rank should hold."""
        if precision != "exact":
            raise ValueError(f"the world smoke is exact, not {precision!r}")
        r, w = self.ctx.rank, self.ctx.world
        sums, moved = [], []
        for i in range(n):
            sums.append(sum(self._vectors(q, i)[0] for q in range(w)).cpu())
            moved.append(self._vectors((r - 1) % w, i)[1].cpu())
        return {"sums": sums, "moved": moved,
                "buffer": self._buffer((r - self.hops) % w)}

    def numbers(self, initial, prog: list, ref: dict) -> dict:
        """Mismatched elements, summed over the ranks."""
        counts = torch.tensor([
            sum(int((s != e).sum()) for (s, _), e in zip(prog, ref["sums"])),
            sum(int((m != e).sum()) for (_, m), e in zip(prog, ref["moved"])),
            int((self.buf != ref["buffer"]).sum())],
            dtype=torch.int64, device=self.ctx.device)
        if self.ctx.world > 1:
            import torch.distributed as dist

            dist.all_reduce(counts)
        return {k: float(v) for k, v in zip(LIMITS, counts.tolist())}
