"""Flash attention on one card — the port of
``harp_tpu.ops.flash_attention``.

Blockwise attention over folded rows ``[BH, N, D]`` (fold batch × heads
upstream; for GQA repeat the K/V heads before folding: the kernel sees
folded rows).  Kernel K8 (:func:`flash_attention`) is the CUDA C++ source
``csrc/flash_attention.cu`` for ``sm_90a``; it replaces the TPU kernel
``flash_attention`` (``harp_tpu/ops/flash_attention.py``), and the source's
head note gives its bound and design.  :func:`flash_attention_plain` is its
plain PyTorch version: the same online-softmax recurrence over ``block_k``
key tiles with the same guards, the query rows vectorised.
:func:`reference_attention` is the dense reference.

The wrapper runs the plain version only for tensors on the CPU; for CUDA
tensors it launches K8 on the current stream or raises.  :data:`LAUNCHES`
counts the launches.  ``window`` follows the ring/a2a mask contract: the
last ``window`` keys when causal, ``window - 1`` either side when not.
``block_q`` and ``block_k`` set the divisibility contract (and the plain
version's blocking); the kernel tiles by its own query and key tiles.

On the card K8 takes one of two paths by dtype and head dim
(:func:`kernel_path`, which asks the library's own dispatch): bf16 at
D 64 and 128 ``"wgmma"`` (warpgroup MMA fed by TMA), and f32 or bf16 at
any other D ``"simt"`` (f32 FMAs on the CUDA cores).  :data:`PATH_LAUNCHES`
counts the launches of each.
"""

from __future__ import annotations

import ctypes

import torch

from harp_tpu_torch.ops import build
from harp_tpu_torch.ops.a2a_attention import _local_attention

#: kernel launches since the last :func:`reset_launches`
LAUNCHES = {"flash_attention": 0}
#: the same launches by the path they took (:func:`kernel_path`)
PATH_LAUNCHES = {"wgmma": 0, "simt": 0}
_PATHS = ("simt", "wgmma")
#: the head dims K8 takes: multiples of 8 up to MAX_D
MAX_D = 256
#: the bound on :func:`row_scaled_error` that a bf16 output is held to
#: against its plain version: two bf16 steps (a step is 2^-8 to 2^-7 of
#: the value)
BF16_ROW_TOL = 2.0 ** -6

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "flash_attention_plan": [],
    "flash_attention_path": [_I, _I],
    "flash_attention_fwd": [_P, _P, _P, _P, _I, _I, _I, _F, _I, _I, _I, _P],
}
_BOUND: dict[str, ctypes.CDLL] = {}
#: card indices whose shared-memory limit K8 has set
_PLANNED: set[int] = set()


def reset_launches() -> None:
    LAUNCHES["flash_attention"] = 0
    for name in PATH_LAUNCHES:
        PATH_LAUNCHES[name] = 0


def _lib() -> ctypes.CDLL:
    if "lib" not in _BOUND:
        _BOUND["lib"] = build.bind("flash_attention", _SIGNATURES)
    return _BOUND["lib"]


#: keys a simt block stages a tile (csrc/flash_attention.cu's kBK)
SIMT_BK = 64


def simt_smem_bytes(d: int, rq: int = 8, dc: int = 2) -> int:
    """The dynamic shared memory of one block of the simt arm at head dim
    ``d``, as the launch asks it (``simt_smem_bytes<RQ, DC>(d)`` in the
    source): q and k rows at ``d + 4`` floats, v rows at ``64·DC + 4`` and
    the [16·RQ, kBK + 16] probabilities, f32."""
    ld, ldv = d + 4, 64 * dc + 4
    return 4 * ((16 * rq + SIMT_BK) * ld + SIMT_BK * ldv
                + 16 * rq * (SIMT_BK + 16))


def kernel_path(dtype, d: int) -> str:
    """The path K8 takes on the card for this dtype and head dim:
    ``"wgmma"`` or ``"simt"``, from the library's own dispatch (so it
    builds the library)."""
    return _PATHS[_lib().flash_attention_path(int(d),
                                              int(dtype == torch.bfloat16))]


def _check_args(q, window, block_q, block_k):
    """The reference's argument checks; returns the clamped blocks."""
    n = q.shape[1]
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    block_q, block_k = min(block_q, n), min(block_k, n)
    if n % block_q or n % block_k:
        raise AssertionError((n, block_q, block_k))
    return block_q, block_k


def flash_attention_plain(q, k, v, *, causal: bool = False,
                          scale: float | None = None,
                          window: int | None = None, block_q: int = 256,
                          block_k: int = 256):
    """Plain PyTorch version of K8 (same arguments and result): the online
    softmax over ``block_k`` key tiles, f32 scores scaled after the dot,
    ``p`` cast to V's dtype before the ``p·v`` product, f32 accumulation —
    a2a attention's local recurrence with each folded row as one head."""
    _, block_k = _check_args(q, window, block_q, block_k)
    scale = scale if scale is not None else 1.0 / (q.shape[2] ** 0.5)
    return _local_attention(q[:, :, None], k[:, :, None], v[:, :, None],
                            scale, causal, block_k, window)[:, :, 0]


def row_scaled_error(o, ref) -> float:
    """max |o - ref| / (|ref| + the RMS of ref's row): an attention output's
    error in units of its own size.  A row that averages many keys has
    entries of about 1/sqrt(keys), so an absolute tolerance fit for the
    early rows would pass any fault in the late ones; measured against the
    row's size, an entry near zero is held as tightly as its neighbours."""
    o, ref = o.float(), ref.float()
    rms = ref.pow(2).mean(-1, keepdim=True).sqrt()
    return float(((o - ref).abs() / (ref.abs() + rms).clamp_min(1e-30))
                 .max())


def flash_attention(q, k, v, *, causal: bool = False,
                    scale: float | None = None, window: int | None = None,
                    block_q: int = 256, block_k: int = 256):
    """Blockwise attention → ``o`` [BH, N, D] in q's dtype.

    q, k, v: [BH, N, D], one dtype (f32 or bf16), contiguous; on the card D
    is a multiple of 8 up to :data:`MAX_D`.  ``causal`` masks keys after
    the query; ``window`` keeps the last ``window`` keys when causal and
    those within ``window - 1`` either side when not.  ``block_q`` and
    ``block_k`` (clamped to N) must divide N: AssertionError otherwise, as
    the reference; ``window < 1`` is a ValueError."""
    bh, n, d = q.shape
    dev = q.device
    for name, t in (("q", q), ("k", k), ("v", v)):
        build.require(t, name, (torch.float32, torch.bfloat16), (bh, n, d),
                      dev)
    if not q.dtype == k.dtype == v.dtype:
        raise TypeError(f"q, k and v must share a dtype, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    block_q, block_k = _check_args(q, window, block_q, block_k)
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    if dev.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, scale=scale,
                                     window=window, block_q=block_q,
                                     block_k=block_k)
    if dev.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not {dev}")
    if d % 8 or not 8 <= d <= MAX_D:
        raise ValueError(f"flash_attention: head dim {d} is not a multiple "
                         f"of 8 in [8, {MAX_D}]")
    if bh > 65535:
        raise ValueError(f"flash_attention: {bh} folded rows exceed the "
                         "grid's 65535")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} is not 16-byte "
                             "aligned")
    lib = _lib()
    with torch.cuda.device(dev):
        idx = torch.cuda.current_device()
        if idx not in _PLANNED:
            build.check(lib.flash_attention_plan(), "flash_attention_plan")
            _PLANNED.add(idx)
        o = torch.empty_like(q)
        build.check(lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), bh, n, d,
            float(scale), int(causal), 0 if window is None else int(window),
            int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream(dev).cuda_stream),
            "flash_attention_fwd launch")
    LAUNCHES["flash_attention"] += 1
    PATH_LAUNCHES[kernel_path(q.dtype, d)] += 1
    return o


def reference_attention(q, k, v, *, causal=False, scale=None, window=None):
    """Straight-line dense reference, for tests."""
    bh, n, d = q.shape
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    s = torch.einsum("bqd,bkd->bqk", q, k) * scale
    delta = (torch.arange(n, device=q.device)[:, None]
             - torch.arange(n, device=q.device)[None, :])
    mask = torch.ones((n, n), dtype=torch.bool, device=q.device)
    if causal:
        mask = delta >= 0
    if window is not None:
        mask = mask & ((delta < window) if causal else (delta.abs() < window))
    s = torch.where(mask[None], s, float("-inf"))
    return torch.einsum("bqk,bkd->bqd", torch.softmax(s, dim=-1), v)
