"""Carry state from the JAX package's layout into the port's tensors.

State crosses as numpy arrays, so this module needs neither JAX nor
``harp_tpu``: a caller reads the reference's state (``np.asarray`` of its
arrays, or a saved file) and hands the dict over.
"""

from __future__ import annotations

import numpy as np
import torch


def kmeans_state_from_numpy(state: dict, device) -> dict:
    """The reference's KMeans state → the port's tensors on ``device``.

    ``state`` holds ``"centroids"`` [k, d] (f32, the layout the reference's
    serve engine loads) and, for int8 runs, ``"col_scale"`` [d], the
    per-feature point scale.  Returns the same keys as f32 tensors."""
    c = np.asarray(state["centroids"], dtype=np.float32)
    if c.ndim != 2:
        raise ValueError(f"centroids must be [k, d], got shape {c.shape}")
    out = {"centroids": torch.from_numpy(c.copy()).to(device)}
    if state.get("col_scale") is not None:
        s = np.asarray(state["col_scale"], dtype=np.float32)
        if s.shape != (c.shape[1],):
            raise ValueError(f"col_scale must be [{c.shape[1]}], got "
                             f"shape {s.shape}")
        out["col_scale"] = torch.from_numpy(s.copy()).to(device)
    return out
