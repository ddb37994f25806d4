"""The frozen work of one LDA-CGS sweep: what the dense collapsed Gibbs
conditional of every real token asks for, whatever kernel samples it and
however many padded slots it carries.

Per real token and topic, the arithmetic of the conditional as K4 states
it (``ratio = (−log u)·(n_k + Vβ) / ((n_dk + α)·(n_wk + β))``, argmin):
the two prior adds (α to n_dk, β to n_wk), the two multiplies, the divide,
the log of the uniform and the argmin's compare: 7 operations on the CUDA
cores (f32).  Not counted there:

- the three gathers of n_dk, n_wk and n_k: loads, which the bytes term
  counts;
- the subtraction of the token's own count (``old``): nonzero at one topic
  of the token's, so a token's work, not a topic's;
- n_k + Vβ: one add a topic for a chunk's tokens together, not one a token;
- the clamps at 1e-10: the prior keeps every factor positive, so they never
  bind;
- the draws of the uniforms (Philox): a sampler's choice, which another
  sampler makes otherwise.

Bytes: the doc-topic table (at its stored width) and the word-topic table
(f32) read and written once, and each real token read once (doc id, word
id, topic: 4 bytes each) and its topic written once.  The bound is the
larger of the two at the H100's peaks.
"""

from __future__ import annotations

from portbench.work.counts import bound_s

#: operations a real token and topic (module docstring)
OPS_PER_TOKEN_TOPIC = 7
#: bytes a real token: three ids read, one topic written
BYTES_PER_TOKEN = 16


def cgs_sweep(tokens: int, n_topics: int, n_docs: int, vocab_size: int,
              ndk_bytes: int) -> dict:
    """One sweep over ``tokens`` real tokens: ``{"ops", "bytes",
    "bound_s"}``."""
    ops = OPS_PER_TOKEN_TOPIC * tokens * n_topics
    nbytes = 2 * n_topics * (n_docs * ndk_bytes + vocab_size * 4) \
        + BYTES_PER_TOKEN * tokens
    return {"ops": ops, "bytes": nbytes, "bound_s": bound_s(ops, nbytes,
                                                            "f32")}
