"""Layer ``kernels``: HL205, the kernel registry's shared-memory
declarations against the wrappers' own plans; the counterpart of
``harp_tpu.analysis.mosaic_audit``'s HL205.

Each ``smem_bytes`` of :mod:`harp_tpu_torch.ops.kernel_registry` is what a
block of the kernel takes at the registered shape on an H100.  The cost
model and memrec's fit gate price launches from it, so it must lie within
:data:`harp_tpu_torch.utils.memrec.PRESIZE_BAND` of what the kernel's own
wrapper plans at that shape, and under the card's opt-in limit:

- K3 (``mfsgd.sgd_tile_update``): ``mfsgd_kernel.block_bytes``, the bytes
  the wrapper passes to the launch;
- K4 (``lda.cgs_entry_update``): ``lda_kernel.block_smem``, the -log(u)
  row of K floats;
- K7 (``rf.hist_bins``): ``rf_kernel.plan``'s layout, on the H100's opt-in
  limit and SM count (the card's own, given a card);
- K8 (``flash_attention``): ``flash_attention.simt_smem_bytes``, the simt
  arm's tiles at the registered head dim;
- K1 and K2 (``kmeans.partials_int8``, ``kmeans.partials``): the plan the
  kernels' library makes on the card (``kmeans_kernel.plan``).  Only a card
  has it: without one they are listed as unchecked, and ``chip_smoke.py``
  holds them to the plan.

K5 and K6 pick their shared memory inside their libraries' plan calls
(an arm by the shape, in the source), so HL205 does not hold them: their
declarations are held to the card's opt-in limit only (``chip_smoke.py``
phase 44).

Nothing here makes a tensor: the plans are Python arithmetic, or the
library's plan entry point on the card.
"""

from __future__ import annotations

from harp_tpu_torch.analysis import Violation

#: the registered shapes of kernel_registry.py, restated where the plans
#: take them (a change of either makes the audit fire, which is the point)
_KMEANS_SHAPES = {"kmeans.partials": "kmeans_partials",
                  "kmeans.partials_int8": "kmeans_partials_int8"}


def smem_models(device=None) -> dict[str, int]:
    """Kernel name -> the shared memory a block of it takes at the
    registered shape, from the kernel's own wrapper.  K1 and K2 are
    included only when ``device`` is a CUDA device."""
    from harp_tpu_torch.ops import flash_attention as K8
    from harp_tpu_torch.ops import kernel_registry as KR
    from harp_tpu_torch.ops import lda_kernel as K4
    from harp_tpu_torch.ops import mfsgd_kernel as K3
    from harp_tpu_torch.ops import rf_kernel as K7

    optin, sms = KR.H100_SMEM_OPTIN, KR.H100_SMS
    on_card = device is not None and str(device).startswith("cuda")
    if on_card:
        import torch

        props = torch.cuda.get_device_properties(device)
        optin = props.shared_memory_per_block_optin
        sms = props.multi_processor_count
    out = {
        "mfsgd.sgd_tile_update": K3.block_bytes(
            KR._MF_TILE, KR._MF_TILE, KR._MF_R, KR._MF_C, K3.CLUSTER),
        "lda.cgs_entry_update": K4.block_smem(KR._LDA_K),
        "rf.hist_bins": K7.plan(KR._RF_T, KR._RF_N, KR._RF_F, KR._RF_B,
                                KR._RF_R, 1, optin, sms).smem,
        "flash_attention": K8.simt_smem_bytes(KR._FA_D),
    }
    if on_card:
        import torch

        from harp_tpu_torch.ops import kmeans_kernel as KK

        for name, lib in _KMEANS_SHAPES.items():
            out[name] = KK.plan(lib, torch.device(device), KR._KM_N,
                                KR._KM_D, KR._KM_K).smem
    return out


def unchecked(device=None) -> list[str]:
    """The kernels :func:`smem_models` holds on a card only: K1 and K2,
    unless ``device`` is a CUDA device."""
    on_card = device is not None and str(device).startswith("cuda")
    return [] if on_card else sorted(_KMEANS_SHAPES)


def check_smem_declarations(models: dict[str, int] | None = None,
                            device=None) -> list[Violation]:
    """HL205: each registry ``smem_bytes`` within ``PRESIZE_BAND`` of its
    wrapper's plan (``models``, default :func:`smem_models`) and under the
    H100's opt-in limit."""
    from harp_tpu_torch.ops.kernel_registry import (H100_SMEM_OPTIN,
                                                    KERNEL_WORK)
    from harp_tpu_torch.utils.memrec import PRESIZE_BAND

    models = smem_models(device) if models is None else models
    out: list[Violation] = []
    for name, model in sorted(models.items()):
        work = KERNEL_WORK.get(name)
        if work is None:
            out.append(Violation(
                "HL205", f"kernel:{name}", 0,
                "kernel has a shared-memory plan but no registry entry: "
                "register it (ops/kernel_registry.py) so the audit and the "
                "cost model see one source of truth"))
            continue
        declared = work["smem_bytes"]
        if not model <= declared <= model * PRESIZE_BAND:
            out.append(Violation(
                "HL205", f"kernel:{name}", 0,
                f"registry smem_bytes={declared} is stale against the "
                f"wrapper's plan ({model} B at the registered shape; "
                f"allowed band [{model}, {int(model * PRESIZE_BAND)}]): "
                "re-derive the declaration when the kernel changes"))
        if declared > H100_SMEM_OPTIN:
            out.append(Violation(
                "HL205", f"kernel:{name}", 0,
                f"registry smem_bytes={declared} exceeds the H100's "
                f"{H100_SMEM_OPTIN} B opt-in: the registered shape cannot "
                "launch"))
    return out
