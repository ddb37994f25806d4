"""The plain reference of a streaming KMeans epoch: Lloyd's step over the
chunks of a generated data set, in plain PyTorch.

It imports nothing of the program: it takes the initial centroids, the
feature scales and the chunk source (the benchmark's generator) and works
out everything else itself.

Precisions:

- ``"int8"`` (and the control ``"int4"``): the stated algorithm of the
  quantized stream.  A point is ``q = clip(round(x / s), ±qmax)`` with the
  feature step ``s`` (the configured int8 scale, widened by 127 / qmax);
  each epoch the centroids enter the quantized coordinates (``c · s``)
  and get one symmetric step a row (``|max| / qmax``); a score is
  ``|c|² − 2·step·(q · c_q)`` with the integer dot exact; the sums are
  exact integer sums of q, times s; the inertia adds ``Σ |q·s|²``.
- ``"f32"`` (and the control ``"tf32"``): scores ``|c|² − 2 x·c`` from an
  f32 matmul with TF32 off (on for the control).

Assignments take the lowest index on ties; the sums, counts and inertia
accumulate in f64 or exact integers; an empty cluster keeps its centroid.
"""

from __future__ import annotations

import contextlib

import torch

_QMAX = {"int8": 127, "int4": 7}


@contextlib.contextmanager
def _matmul_mode(tf32: bool):
    m = torch.backends.cuda.matmul
    saved = (m.allow_tf32, torch.backends.cudnn.allow_tf32)
    m.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        m.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


class _IntOps:
    """Exact integer products of integer-valued matrices (|values| <=
    127): int8 GEMMs on the card (inner sizes padded to a multiple of 8;
    the second operand column-major, as the int8 GEMM takes it), f64
    matmuls and integer index adds on the CPU."""

    def __init__(self, device: torch.device, d: int):
        self.cuda = device.type == "cuda"
        self.d, self.dp = d, d + (-d % 8)

    def pack(self, q: torch.Tensor) -> torch.Tensor:
        """Integer-valued f32 [n, d] → the operand of :meth:`dot`."""
        if not self.cuda:
            return q.double()
        buf = torch.zeros((q.shape[0], self.dp), dtype=torch.int8,
                          device=q.device)
        buf[:, :self.d] = q
        return buf

    def dot(self, qp: torch.Tensor, cp: torch.Tensor) -> torch.Tensor:
        """``q @ cᵀ`` → int32 [n, k] for packed q [n, ·] and c [k, ·]."""
        if not self.cuda:
            return (qp @ cp.T).to(torch.int32)
        return torch._int_mm(qp, cp.T)

    def sums(self, qp: torch.Tensor, assign: torch.Tensor,
             k: int) -> torch.Tensor:
        """Σ of q's rows by cluster → int64 [k, d], exact."""
        if not self.cuda:
            out = torch.zeros((k, self.d), dtype=torch.int64,
                              device=qp.device)
            return out.index_add_(0, assign, qp.to(torch.int64))
        n = qp.shape[0]
        onehot = torch.zeros((k, n), dtype=torch.int8, device=qp.device)
        onehot[assign, torch.arange(n, device=qp.device)] = 1
        col_major = qp.T.contiguous().T
        return torch._int_mm(onehot, col_major)[:, :self.d].to(torch.int64)


def _epoch_int(c, gen, n_chunks, col_scale, qmax):
    k, d = c.shape
    dev = c.device
    ops = _IntOps(dev, d)
    step = col_scale * (127.0 / qmax)
    cs = c * step
    row_step = cs.abs().amax(1).clamp_min(1e-30) / qmax
    c_q = ops.pack(torch.round(cs / row_step[:, None]).clamp_(-qmax, qmax))
    c2 = (c ** 2).sum(1)
    sums = torch.zeros((k, d), dtype=torch.int64, device=dev)
    counts = torch.zeros((k,), dtype=torch.int64, device=dev)
    q2 = torch.zeros((d,), dtype=torch.float64, device=dev)
    best_sum = torch.zeros((), dtype=torch.float64, device=dev)
    for j in range(n_chunks):
        q = torch.round(gen(j) / step).clamp_(-qmax, qmax)
        q2 += (q * q).sum(0, dtype=torch.float64)
        qp = ops.pack(q)
        del q
        scores = torch.addcmul(c2[None, :], ops.dot(qp, c_q),
                               (-2.0 * row_step)[None, :])
        assign = torch.argmin(scores, dim=1)
        best_sum += scores.gather(1, assign[:, None]).sum(
            dtype=torch.float64)
        del scores
        sums += ops.sums(qp, assign, k)
        counts += torch.bincount(assign, minlength=k)
    inertia = best_sum + (q2 * step.double() ** 2).sum()
    return sums.double() * step.double(), counts, inertia


def _epoch_float(c, gen, n_chunks):
    k, d = c.shape
    dev = c.device
    c2 = (c ** 2).sum(1)
    sums = torch.zeros((k, d), dtype=torch.float64, device=dev)
    counts = torch.zeros((k,), dtype=torch.int64, device=dev)
    inertia = torch.zeros((), dtype=torch.float64, device=dev)
    for j in range(n_chunks):
        x = gen(j)
        scores = torch.addmm(c2[None, :], x, c.T, alpha=-2.0)
        assign = torch.argmin(scores, dim=1)
        best = scores.gather(1, assign[:, None])
        xd = x.double()
        sums.index_add_(0, assign, xd)
        counts += torch.bincount(assign, minlength=k)
        inertia += best.double().sum() + (xd ** 2).sum()
    return sums, counts, inertia


def lloyd(c0: torch.Tensor, gen, n_chunks: int, steps: int, precision: str,
          col_scale: torch.Tensor | None = None) -> list:
    """``steps`` Lloyd epochs from ``c0`` [k, d] f32 over chunks
    ``gen(0..n_chunks-1)`` → ``[(centroids f32 [k, d], inertia float)]``
    after each epoch."""
    if precision not in ("int8", "int4", "f32", "tf32"):
        raise ValueError(f"unknown precision {precision!r}")
    out = []
    c = c0.to(torch.float32)
    with _matmul_mode(precision == "tf32"):
        for _ in range(steps):
            if precision in _QMAX:
                sums, counts, inertia = _epoch_int(c, gen, n_chunks,
                                                   col_scale,
                                                   _QMAX[precision])
            else:
                sums, counts, inertia = _epoch_float(c, gen, n_chunks)
            new = (sums / counts.clamp_min(1)[:, None]).to(torch.float32)
            c = torch.where(counts[:, None] > 0, new, c)
            out.append((c, float(inertia)))
    return out
