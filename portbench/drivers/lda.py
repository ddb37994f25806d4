"""LDA by collapsed Gibbs sampling with model rotation:
``harp_tpu_torch.models.lda.LDA`` (``algo="pallas"``: K4, one cooperative
launch a rotation step) swept on the benchmark's own corpus.

Set-up makes the corpus on the card from the seed (``gen_corpus``), hands
it to the program (``LDA.set_tokens``: the pack, the install and K4's
entry plans, timed as ``prep_s``) and runs ``checked_steps`` sweeps of
``sample_epoch``, the window's own call: the sweeps the checks read, and
the warm-up.  The window calls ``sample_epoch`` ``ceil(seconds /
window_sweep_s)`` times (``window_sweep_s`` is the mix's: the count does
not follow the run's own speed), each timed on the host clock to the end of
its own readback.  With ``--trace 1`` a slice of ``trace_epochs`` sweeps
from the window's middle is profiled.

``correct`` (:meth:`Driver.numbers`, against ``reference/lda.py``).  The
program's tokens are read through its public ``LDA.token_state()`` (the
``(doc, word, topic)`` of every token it holds), its tables through
``doc_topic_table()``, ``word_topic_table()`` and ``Nk``:

- ``count_gap``: the tokens whose ``(doc, word)`` pairs, as a multiset,
  differ from the corpus's, plus the table entries, after the last checked
  sweep and after the window, that differ from the tables recounted in
  int64 from the program's tokens;
- ``prefix_mismatch``: the tokens of the first entries of the first
  rotation step (slice 0), spanning ``prefix_chunks`` chunks or more, whose
  topic after the first checked sweep differs from the reference chain's
  replay of that step from the seed's initial topics and draws;
- ``rotate_mismatch``: the same for the first entries of the second
  rotation step (slice 1), which the reference replays from the program's
  slice-0 topics after the first step (its output, judged by
  ``prefix_mismatch`` and ``count_gap``) and the initial topics of slice 1;
- ``ll_gap``: the largest relative gap, over the checked sweeps, between
  the per-token joint log-likelihood of the program's topics (float64, the
  reference's recount) and ``ll_center``: the reference chain's own
  likelihood after those sweeps, replayed whole on the calibration's seeds
  (``calibrate.py --chain-seeds``).

The two replays need the program's token order to be the layout the
configuration states (``reference.lda.Layout``): a program that packs its
tokens otherwise reads ``inf`` there, and nowhere else.  The initial topics
and the seed words are not read from the program: the reference draws them
again in the program's documented generator order
(``reference.lda.initial_topics``: ``LDA.pack_tokens``'
``numpy.random.default_rng(seed).integers(0, K, n)`` in corpus order;
``reference.lda.step_seeds``: ``LDA._sample_block``'s one ``torch.randint``
of ``[entries, 2]`` int32 a rotation step from the ``torch.Generator`` that
``LDA`` seeds ``seed · 65,537 + rank``).  The program's seed is
``gen.seed64(run seed, 32) mod 2³¹``.
"""

from __future__ import annotations

import gc
import math
import time

import numpy as np
import torch

from portbench import gen, gen_corpus, trace
from portbench.reference import lda as ref
from portbench.work import lda as work

#: the numbers that decide ``correct`` (:meth:`Driver.numbers`), and the
#: kind of entry whose metrics this driver's cells report
LIMITS = ("count_gap", "prefix_mismatch", "rotate_mismatch", "ll_gap")
FAMILY = "lda"

#: K4's kernel, one cooperative launch a rotation step (not K3's
#: ``sgd_step_kernel``)
K4_NAMES = r"::step_kernel<"


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx

    def _model_config(self):
        from harp_tpu_torch.models import lda as L

        c = self.ctx.config
        return L.LDAConfig(n_topics=c["n_topics"], alpha=c["alpha"],
                           beta=c["beta"], algo=c["algo"],
                           d_tile=c["d_tile"], w_tile=c["w_tile"],
                           entry_cap=c["entry_cap"],
                           ndk_dtype=c["ndk_dtype"],
                           pallas_exact_gathers=c["pallas_exact_gathers"],
                           rotate_chunks=c["rotate_chunks"])

    def setup(self) -> None:
        from harp_tpu_torch.models import lda as L
        from harp_tpu_torch.parallel.mesh import WorkerMesh

        ctx, c = self.ctx, self.ctx.config
        dev = ctx.device
        docs, words = gen_corpus.corpus(c, ctx.traffic, ctx.seed, dev)
        self.corpus = (docs.to(torch.int32).cpu().numpy(),
                       words.to(torch.int32).cpu().numpy())
        del docs, words
        self.n_tokens = int(self.corpus[0].size)
        self.lda_seed = gen.seed64(ctx.seed, 32) % 2 ** 31
        mesh = WorkerMesh(dev)
        if mesh.num_workers != 1:
            raise RuntimeError("this driver runs one worker")
        self.model = L.LDA(c["n_docs"], c["vocab_size"], self._model_config(),
                           mesh, seed=self.lda_seed)
        t0 = time.perf_counter()
        with torch.profiler.record_function("portbench.set_tokens"):
            self.model.set_tokens(*self.corpus)
        self.prep_s = time.perf_counter() - t0
        ctx.log(f"{self.n_tokens} tokens; set_tokens {self.prep_s:.1f} s")
        self.sweep_s: list[float] = []

    def initial(self):
        return None

    def _sweep(self) -> None:
        t0 = time.perf_counter()
        with torch.profiler.record_function("portbench.sweep"):
            self.model.sample_epoch()
        self.sweep_s.append(time.perf_counter() - t0)

    def _tables(self) -> tuple:
        m = self.model
        return (m.doc_topic_table(), m.word_topic_table(),
                m.Nk.to("cpu", copy=True))

    def steps(self, n: int) -> list:
        """``n`` sweeps; after each, the program's ``z_grid`` (and after the
        last its tables), copied to the host."""
        out = []
        for i in range(n):
            self._sweep()
            snap = {"z": self.model.z_grid.to("cpu", copy=True)}
            if i == n - 1:
                snap["tables"] = self._tables()
            out.append(snap)
        self.prog = out
        return out

    @staticmethod
    def _k4_launches() -> int:
        from harp_tpu_torch.ops import lda_kernel

        return lda_kernel.LAUNCHES["cgs_entry_update"]

    def window(self, seconds: float, traced: bool) -> dict:
        dev = self.ctx.device
        n_sweeps = max(1, math.ceil(seconds
                                    / self.ctx.traffic["window_sweep_s"]))
        span = min(self.ctx.traffic["trace_epochs"], n_sweeps) if traced \
            else 0
        first = (n_sweeps - span) // 2
        start = len(self.sweep_s)
        sl, launches = None, 0
        t0 = time.perf_counter()
        for e in range(n_sweeps):
            if traced and e == first:
                sl = trace.Slice(dev)
                sl.start()
                launches = self._k4_launches()
            self._sweep()
            if sl is not None and sl.open and e == first + span - 1:
                sl.stop()
                launches = self._k4_launches() - launches
        wall = time.perf_counter() - t0
        times = self.sweep_s[start:]
        self.ctx.log(f"window: {n_sweeps} sweeps in {wall:.3f} s, each "
                     f"{[round(x, 4) for x in times]}; set-up's "
                     f"{[round(x, 4) for x in self.sweep_s[:start]]}")
        out = {"e2e": {"lda_tokens_per_s": n_sweeps * self.n_tokens / wall},
               "attempted": n_sweeps, "failed": 0,
               "memory_peak_bytes": (torch.cuda.max_memory_allocated(dev)
                                     if dev.type == "cuda" else 0)}
        if traced:
            out.update(self._record(sl, launches, span, times, first))
        return out

    def _record(self, sl, launches, span, times, first) -> dict:
        red = trace.reduce(sl.collect(), sl.window_s, {"K4": K4_NAMES})
        seen = trace.count_tag(red, "K4")
        if seen != launches:
            raise trace.TraceShort(f"K4: the trace holds {seen} of the "
                                   f"{launches} launches of its slice")
        c = self.ctx.config
        clean = times[:first] + times[first + span:] or times
        ndk_bytes = 2 if c["ndk_dtype"] == "int16" else 4
        record = {
            "trace": red,
            "slice": {"sweeps": span},
            "work": {"sweep_bound_s": work.cgs_sweep(
                self.n_tokens, c["n_topics"], c["n_docs"], c["vocab_size"],
                ndk_bytes)["bound_s"]},
            "host": {"sweep_s": sum(clean) / len(clean),
                     "prep_s": self.prep_s},
        }
        return {"record": record, "breakdown": trace.breakdown(red)}

    def release(self) -> None:
        """Keep what the checks judge (the program's tokens, its topics and
        tables after the window) and drop the rest of the program."""
        m, t0 = self.model, time.perf_counter()
        self.final = {"z": m.z_grid, "tables": self._tables()}
        self.held = self._token_map()
        self.ctx.log(f"read the program's tokens and tables in "
                     f"{time.perf_counter() - t0:.1f} s")
        self.model = None
        gc.collect()  # the program's own reference cycles hold its tensors
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()

    def _token_map(self) -> tuple:
        """``(docs, words, slot)`` on the device: every token the program
        holds, in its ``token_state()`` order, and the element of
        ``z_grid`` that holds its topic (read by ``token_state()`` with
        ``z_grid`` holding each element's own index)."""
        m, dev = self.model, self.ctx.device
        z = m.z_grid
        m.z_grid = torch.arange(z.numel(), dtype=torch.int32,
                                device=z.device).reshape(z.shape)
        try:
            held = m.token_state()
        finally:
            m.z_grid = z
        return tuple(torch.from_numpy(np.asarray(a)).to(dev).long()
                     for a in held)

    def _program_topics(self, z: torch.Tensor) -> torch.Tensor:
        """The program's topic of each token it holds, from a ``z_grid``."""
        slot = self.held[2]
        return z.reshape(-1)[slot.to(z.device)].to(self.ctx.device).long()

    def _aligned(self, lay) -> bool:
        """Whether the program holds its tokens in the layout's order."""
        d, w, _ = self.held
        return d.numel() == lay.n_tokens and torch.equal(d, lay.doc) \
            and torch.equal(w, lay.word)

    def reference(self, n: int, precision: str) -> dict:
        """The layout the configuration states, and the reference chain's
        replays of the first entries of the first sweep's two rotation
        steps."""
        if precision != "exact":
            raise ValueError(f"the LDA reference is exact, not {precision!r}")
        c, dev = self.ctx.config, self.ctx.device
        least = self.ctx.traffic["prefix_chunks"]
        docs, words = (torch.from_numpy(a).to(dev) for a in self.corpus)
        lay = ref.Layout(docs, words, c)
        del docs, words
        z0 = ref.initial_topics(self.lda_seed, self.n_tokens,
                                c["n_topics"], dev)[lay.order]
        seeds = ref.step_seeds(self.lda_seed, lay.NE, dev,
                               steps=lay.n_slices)
        out = {"layout": lay, "aligned": self._aligned(lay)}
        chain = ref.Chain(lay, z0, c)
        lo, hi, chunks = chain.step(0, seeds[0], least)
        out["prefix"] = (lo, hi, chain.topics_now()[lo:hi].clone())
        log = f"replayed step 1: {chunks} chunks, {hi - lo} tokens"
        del chain
        if lay.n_slices > 1 and out["aligned"]:
            z1 = self._program_topics(self.prog[0]["z"])
            chain = ref.Chain(lay, torch.where(lay.slice == 0, z1, z0), c)
            lo, hi, chunks = chain.step(1, seeds[1], least)
            out["rotate"] = (lo, hi, chain.topics_now()[lo:hi].clone())
            log += f"; step 2: {chunks} chunks, {hi - lo} tokens"
            del chain
        run = int(((torch.bincount(lay.slice * lay.NE + lay.entry)
                    + lay.cc - 1) // lay.cc).sum())
        self.ctx.log(
            f"layout: C {lay.C}, cc {lay.cc}, entries {lay.NE} a slice "
            f"({lay.entries.tolist()} with tokens), {run} chunks a sweep: "
            f"{self.n_tokens} tokens in {run * lay.cc} slots run "
            f"({100 * (1 - self.n_tokens / (run * lay.cc)):.2f} % padding) "
            f"and {lay.n_slices * lay.NE * lay.C} stored; {log}")
        return out

    def chain(self, n: int, ref_out: dict) -> list[dict]:
        """The reference chain over the first ``n`` sweeps whole, from the
        seed's initial topics and draws (``calibrate.py --chain-seeds``):
        after each sweep its log-likelihood a token, which sets
        ``ll_center``, and the tokens whose topic differs from the
        program's."""
        c, dev = self.ctx.config, self.ctx.device
        lay = ref_out["layout"]
        z0 = ref.initial_topics(self.lda_seed, self.n_tokens,
                                c["n_topics"], dev)[lay.order]
        seeds = ref.step_seeds(self.lda_seed, lay.NE, dev,
                               steps=n * lay.n_slices)
        chain = ref.Chain(lay, z0, c)
        rows = []
        for i in range(n):
            t0 = time.perf_counter()
            for s in range(lay.n_slices):
                chain.step(s, seeds[i * lay.n_slices + s])
            z = chain.topics_now()
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            swept = time.perf_counter() - t0
            _, ll = ref.recount(lay.doc, lay.word, z, c["n_docs"],
                                c["vocab_size"], c["n_topics"], c["alpha"],
                                c["beta"])
            prog = self._program_topics(self.prog[i]["z"]) \
                if ref_out["aligned"] else None
            rows.append({"sweep": i + 1, "ll_per_token": ll,
                         "mismatch": math.inf if prog is None
                         else int((prog != z).sum()),
                         "sweep_s": swept})
        return rows

    # -- the numbers that decide ``correct`` ---------------------------------

    def _ids_gap(self) -> float:
        """Tokens whose ``(doc, word)`` pair the program holds where the
        corpus has another, compared as sorted multisets."""
        V = self.ctx.config["vocab_size"]
        d, w, _ = self.held
        dev = self.ctx.device
        want = torch.from_numpy(self.corpus[0]).to(dev).long() * V \
            + torch.from_numpy(self.corpus[1]).to(dev).long()
        got = torch.sort(d * V + w).values
        n = min(got.numel(), want.numel())
        return float(int((got[:n] != want[:n]).sum())
                     + abs(got.numel() - want.numel()))

    def numbers(self, initial, prog: list, ref_out: dict) -> dict:
        t0 = time.perf_counter()
        out = self._numbers(prog, ref_out)
        self.ctx.log(f"recounts and likelihoods took "
                     f"{time.perf_counter() - t0:.1f} s; log-likelihood a "
                     f"token {out.get('ll_per_token')}")
        return out

    def _numbers(self, prog: list, ref_out: dict) -> dict:
        c, tr = self.ctx.config, self.ctx.traffic
        kw = dict(n_docs=c["n_docs"], V=c["vocab_size"], K=c["n_topics"],
                  alpha=c["alpha"], beta=c["beta"])
        d, w, _ = self.held
        count_gap = self._ids_gap()
        lls, topics = [], []
        for snap in prog:
            z = self._program_topics(snap["z"])
            bad, ll = ref.recount(d, w, z, tables=snap.get("tables"), **kw)
            count_gap += bad
            lls.append(ll)
            topics.append(z)
        count_gap += ref.recount(d, w, self._program_topics(self.final["z"]),
                                 tables=self.final["tables"], **kw)[0]

        def mismatch(key):
            if key not in ref_out or not ref_out["aligned"]:
                return math.inf
            lo, hi, z_ref = ref_out[key]
            return float(int((topics[0][lo:hi] != z_ref).sum()))

        centre = tr["ll_center"]
        ll_gap = max(abs(x - m) / abs(m) if m else math.inf
                     for x, m in zip(lls, centre))
        return {"count_gap": float(count_gap),
                "prefix_mismatch": mismatch("prefix"),
                "rotate_mismatch": mismatch("rotate"),
                "ll_gap": ll_gap, "ll_per_token": lls}
