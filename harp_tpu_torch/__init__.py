"""harp-tpu on PyTorch and CUDA — the port of ``harp_tpu`` to NVIDIA Hopper.

The same Harp collective-ML system as ``harp_tpu``, written with PyTorch's
idiom: plain functions on tensors, an explicit ``device`` and explicit
``torch.Generator``\\ s.  Workers are processes joined by
``torch.distributed`` (NCCL on cards, gloo in CPU tests); the TPU's Pallas
kernels become CUDA C++ kernels for ``sm_90a`` under ``csrc/``, built at
first use by :mod:`harp_tpu_torch.ops.build`.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a device and without a GPU they raise.  This package never imports
JAX or ``harp_tpu``.
"""
