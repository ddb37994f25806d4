"""Fused SMACOF row block: the port of ``harp_tpu.ops.wdamds_kernel``.

One Guttman update of this worker's coordinate rows: the distances of its
rows ``Xl`` against all coordinates ``X``, the guarded ratio ``δ/D`` masked
by the row mask and by ``column < n_real``, and ``(−ratio·X + rowsum(ratio)
·Xl) / max(n_real, 1)``.  Kernel K6 (:func:`smacof_bx`) is the CUDA C++
source ``csrc/wdamds_smacof_bx.cu`` for ``sm_90a``; it replaces the TPU
kernel ``smacof_bx`` (``harp_tpu/ops/wdamds_kernel.py``), and the source's
head note gives its bound and design.  :func:`smacof_bx_plain` is its plain
PyTorch version.

The wrapper runs the plain version only for tensors on the CPU; for CUDA
tensors it launches K6 on the current stream or raises.  :data:`LAUNCHES`
counts the launches.  ``X`` stays row-major [N, dim]; any ``N`` is taken
(the TPU kernel's 128-lane rule is Mosaic's), ``dim`` up to 8.  A bf16
``delta_rows`` is promoted to f32, as in the reference.
"""

from __future__ import annotations

import ctypes

import torch

from harp_tpu_torch.ops import build

#: kernel launches since the last :func:`reset_launches`
LAUNCHES = {"smacof_bx": 0}
#: the largest ``dim`` K6 takes (its register arrays)
MAX_DIM = 8

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "wdamds_smacof_bx_plan": [_I, _I, _I, ctypes.POINTER(_I),
                              ctypes.POINTER(_I)],
    "wdamds_smacof_bx": [_P, _I, _P, _P, _P, _I, _I, _I, _F, _F, _I, _I, _P,
                         _P],
}
_BOUND: dict[str, ctypes.CDLL] = {}
#: per (n_loc, N, dim, card index): K6's (grid, columns a chunk of X holds)
_PLANS: dict[tuple, tuple[int, int]] = {}


def reset_launches() -> None:
    LAUNCHES["smacof_bx"] = 0


def _lib() -> ctypes.CDLL:
    if "lib" not in _BOUND:
        _BOUND["lib"] = build.bind("wdamds_smacof_bx", _SIGNATURES)
    return _BOUND["lib"]


def _plan(lib: ctypes.CDLL, n_loc: int, N: int, dim: int,
          dev: torch.device) -> tuple[int, int]:
    """K6's launch plan for the shape on this card, asked once (an ``mds``
    launches once an iteration at one shape); the ask also sets its
    shared-memory limit."""
    key = (n_loc, N, dim, dev.index if dev.index is not None
           else torch.cuda.current_device())
    if key not in _PLANS:
        grid, ch = _I(), _I()
        build.check(lib.wdamds_smacof_bx_plan(
            n_loc, N, dim, ctypes.byref(grid), ctypes.byref(ch)),
                    "wdamds_smacof_bx_plan")
        _PLANS[key] = (grid.value, ch.value)
    return _PLANS[key]


def smacof_bx_plain(delta_rows, row_mask, Xl, X, n_real: float, *,
                    eps: float):
    """Plain PyTorch version of K6 (same arguments and result)."""
    N = X.shape[0]
    x2 = (Xl * Xl).sum(1, keepdim=True)
    y2 = (X * X).sum(1)[None, :]
    D = torch.sqrt(torch.clamp_min(x2 - 2.0 * (Xl @ X.T) + y2, 0.0))
    colm = (torch.arange(N, device=X.device, dtype=torch.float32)
            < n_real).to(torch.float32)
    ratio = torch.where(D > eps,
                        delta_rows.to(torch.float32) / torch.clamp_min(D, eps),
                        torch.zeros_like(D))
    ratio = ratio * row_mask[:, None] * colm[None, :]
    bx = -(ratio @ X) + ratio.sum(1, keepdim=True) * Xl
    return bx / max(float(n_real), 1.0)


def smacof_bx(delta_rows, row_mask, Xl, X, n_real: float, *, eps: float):
    """One fused Guttman row-block update → ``Xl_new`` [n_loc, dim] f32.

    ``delta_rows`` [n_loc, N] f32 or bf16, ``row_mask`` [n_loc] f32 (0 for
    padded rows), ``Xl`` [n_loc, dim] this worker's rows of ``X`` [N, dim]
    f32, ``n_real`` the live point count (a host number)."""
    n_loc, N = delta_rows.shape
    dim = X.shape[1]
    dev = delta_rows.device
    build.require(delta_rows, "delta_rows", (torch.float32, torch.bfloat16),
                  (n_loc, N), dev)
    build.require(row_mask, "row_mask", (torch.float32,), (n_loc,), dev)
    build.require(Xl, "Xl", (torch.float32,), (n_loc, dim), dev)
    build.require(X, "X", (torch.float32,), (N, dim), dev)
    if dev.type == "cpu":
        return smacof_bx_plain(delta_rows, row_mask, Xl, X, n_real, eps=eps)
    if dev.type != "cuda":
        raise ValueError(f"smacof_bx runs on cuda or cpu, not {dev}")
    if not 1 <= dim <= MAX_DIM:
        raise ValueError(f"smacof_bx: dim={dim} is outside the kernel's "
                         f"1..{MAX_DIM}")
    lib = _lib()
    with torch.cuda.device(dev):
        grid, ch = _plan(lib, n_loc, N, dim, dev)
        return launch(lib, grid, ch, delta_rows, row_mask, Xl, X, n_real,
                      eps)


def launch(lib: ctypes.CDLL, grid: int, ch: int, delta_rows, row_mask, Xl,
           X, n_real: float, eps: float):
    """One launch of K6 from ``lib`` (the built
    ``csrc/wdamds_smacof_bx.cu``) with its plan (``grid``, ``ch``) on the
    current stream; the arguments as :func:`smacof_bx` checked them."""
    (n_loc, N), dim = delta_rows.shape, X.shape[1]
    dev = delta_rows.device
    out = torch.empty((n_loc, dim), dtype=torch.float32, device=dev)
    build.check(lib.wdamds_smacof_bx(
        delta_rows.data_ptr(), int(delta_rows.dtype == torch.bfloat16),
        row_mask.data_ptr(), Xl.data_ptr(), X.data_ptr(), n_loc, N, dim,
        float(n_real), float(eps), grid, ch, out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream),
        "wdamds_smacof_bx launch")
    LAUNCHES["smacof_bx"] += 1
    return out
