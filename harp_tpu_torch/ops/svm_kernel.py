"""Fused Pegasos hinge gradient: the port of ``harp_tpu.ops.svm_kernel``.

One pass over the samples per Pegasos step: margins ``y·(x·w + b)``, the
violators' ``coef = 1[margin < 1]·sw·y``, and the two sums ``gw = Σ coef·x``
and ``gs = Σ coef``.  Kernel K5 (:func:`pegasos_grad`) is the CUDA C++
source ``csrc/svm_pegasos_grad.cu`` for ``sm_90a``; it replaces the TPU
kernel ``pegasos_grad`` (``harp_tpu/ops/svm_kernel.py``), and the source's
head note gives its bound and design.  :func:`pegasos_grad_plain` is its
plain PyTorch version.

The wrapper runs the plain version only for tensors on the CPU; for CUDA
tensors it launches K5 on the current stream (one CUDA launch a call) or
raises.  :data:`LAUNCHES` counts the launches.  ``x`` stays row-major [n,
d] and unpadded: the transposed, 128-lane-padded layout of the TPU kernel
is Mosaic's need, not the card's.  Two arms, as in the reference: f32
``x``, and bf16 ``x``, for which ``w`` is rounded to bf16 before the
margin dot and ``coef`` before the gradient dot, with f32 accumulation.
"""

from __future__ import annotations

import ctypes

import torch

from harp_tpu_torch.ops import build

#: kernel launches since the last :func:`reset_launches`
LAUNCHES = {"pegasos_grad": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int
_PI = ctypes.POINTER(_I)
_SIGNATURES = {
    "svm_pegasos_grad_plan": [_I, _I, _I, _I, _PI, _PI, _PI],
    "svm_pegasos_grad": [_P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P,
                         _P, _P, _P, _P, _P],
}
_BOUND: dict[str, ctypes.CDLL] = {}
#: per (n, d, card index), per (bf16, vec): K5's (grid, arm, lanes a row)
_PLANS: dict[tuple, dict[tuple[int, int], tuple[int, int, int]]] = {}
#: per (card index, stream): the blocks' ticket counter, which every call
#: leaves at zero
_COUNTERS: dict[tuple[int, int], torch.Tensor] = {}


def reset_launches() -> None:
    LAUNCHES["pegasos_grad"] = 0


def _lib() -> ctypes.CDLL:
    if "lib" not in _BOUND:
        _BOUND["lib"] = build.bind("svm_pegasos_grad", _SIGNATURES)
    return _BOUND["lib"]


def _plan(lib: ctypes.CDLL, n: int, d: int, bf16: int, vec: int,
          idx: int) -> tuple[int, int, int]:
    """K5's launch plan for this shape and layout on card ``idx``, asked
    once (a fit launches 1000 times at one shape); the ask also sets the
    arm's shared-memory limit."""
    plans = _PLANS.setdefault((n, d, idx), {})
    if (bf16, vec) not in plans:
        grid, arm, lanes = _I(), _I(), _I()
        build.check(lib.svm_pegasos_grad_plan(
            n, d, bf16, vec, ctypes.byref(grid), ctypes.byref(arm),
            ctypes.byref(lanes)), "svm_pegasos_grad_plan")
        plans[bf16, vec] = (grid.value, arm.value, lanes.value)
    return plans[bf16, vec]


def pegasos_grad_plain(w, b, x, y, sw):
    """Plain PyTorch version of K5 (same arguments and results)."""
    bf16 = x.dtype == torch.bfloat16
    xf = x.to(torch.float32)
    wc = w.to(torch.bfloat16).to(torch.float32) if bf16 else w
    margin = y * (xf @ wc + b)
    coef = torch.where(margin < 1.0, sw, torch.zeros_like(sw)) * y
    cg = coef.to(torch.bfloat16).to(torch.float32) if bf16 else coef
    return cg @ xf, coef.sum()


def pegasos_grad(w, b, x, y, sw):
    """One fused hinge-gradient pass → ``(gw [d] f32, gs 0-d f32)``.

    ``w`` [d] f32, ``b`` 0-d f32 (read on the device: no host sync), ``x``
    [n, d] f32 or bf16, ``y`` and ``sw`` [n] f32.  ``gw = Σ coef·x`` and
    ``gs = Σ coef`` for ``coef = 1[y·(x·w + b) < 1]·sw·y``: the sums of one
    step of ``models.svm._pegasos``."""
    n, d = x.shape
    dev = x.device
    build.require(x, "x", (torch.float32, torch.bfloat16), (n, d), dev)
    build.require(w, "w", (torch.float32,), (d,), dev)
    build.require(b, "b", (torch.float32,), (), dev)
    build.require(y, "y", (torch.float32,), (n,), dev)
    build.require(sw, "sw", (torch.float32,), (n,), dev)
    if dev.type == "cpu":
        return pegasos_grad_plain(w, b, x, y, sw)
    if dev.type != "cuda":
        raise ValueError(f"pegasos_grad runs on cuda or cpu, not {dev}")
    lib = _lib()
    bf16 = int(x.dtype == torch.bfloat16)
    vec = int(x.data_ptr() % 16 == 0 and (d * x.element_size()) % 16 == 0)
    with torch.cuda.device(dev):
        idx = torch.cuda.current_device()
        stream = torch.cuda.current_stream(dev)
        grid, arm, lanes = _plan(lib, n, d, bf16, vec, idx)
        key = (idx, stream.cuda_stream)
        if key not in _COUNTERS:
            _COUNTERS[key] = torch.zeros((1,), dtype=torch.int32, device=dev)
        gw_part = torch.empty((grid, d), dtype=torch.float32, device=dev)
        gs_part = torch.empty((grid,), dtype=torch.float32, device=dev)
        gw = torch.empty((d,), dtype=torch.float32, device=dev)
        gs = torch.empty((), dtype=torch.float32, device=dev)
        build.check(lib.svm_pegasos_grad(
            x.data_ptr(), bf16, w.data_ptr(), b.data_ptr(), y.data_ptr(),
            sw.data_ptr(), n, d, vec, grid, arm, lanes, gw_part.data_ptr(),
            gs_part.data_ptr(), _COUNTERS[key].data_ptr(), gw.data_ptr(),
            gs.data_ptr(), stream.cuda_stream), "svm_pegasos_grad launch")
    LAUNCHES["pegasos_grad"] += 1
    return gw, gs
