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


def mfsgd_state_from_numpy(state: dict, device) -> dict:
    """The reference's MF-SGD factors → the port's tensors on ``device``.

    ``state`` holds the global ``"W"`` [u_bound * n, rank] and ``"H"``
    [i_bound * n, rank] in the reference's storage layout (worker-major,
    rows padded per worker range and per H chunk), which is the port's
    too; ``models.mfsgd.MFSGD(state=...)`` checks the shapes and shards
    them.  Returns the same keys as f32 tensors."""
    out = {}
    for key in ("W", "H"):
        a = np.asarray(state[key], dtype=np.float32)
        if a.ndim != 2:
            raise ValueError(f"{key} must be [rows, rank], got shape "
                             f"{a.shape}")
        out[key] = torch.from_numpy(a.copy()).to(device)
    if out["W"].shape[1] != out["H"].shape[1]:
        raise ValueError(f"W and H ranks differ: {out['W'].shape[1]} vs "
                         f"{out['H'].shape[1]}")
    return out


def lda_state_from_numpy(pack: dict, device) -> dict:
    """The reference's LDA pack (``harp_tpu.models.lda.LDA.pack_tokens``) →
    the port's tensors on ``device``, so both packages start from the same
    chain.

    ``pack`` holds ``"Ndk"`` [docs, K] (f32 or int16), ``"Nwk"`` [words, K]
    f32, ``"Nk"`` [K] f32, ``"z_grid"`` (int32, shaped like the first token
    array) and ``"tokens"``: ``(ed, ew, od, ow)`` for the tiled algos or
    ``(bd, bw, bm)`` for scatter (``(pd, pw, pm)`` for pushpull), in the
    global storage layout, which is the port's too.  Returns the same keys (``tokens`` a tuple) with the shapes
    checked; ``models.lda.LDA`` shards them."""
    Ndk, Nwk = np.asarray(pack["Ndk"]), np.asarray(pack["Nwk"], np.float32)
    if Ndk.dtype not in (np.float32, np.int16):
        raise ValueError(f"Ndk must be float32 or int16, got {Ndk.dtype}")
    if Ndk.ndim != 2 or Nwk.ndim != 2 or Ndk.shape[1] != Nwk.shape[1]:
        raise ValueError(f"Ndk {Ndk.shape} and Nwk {Nwk.shape} must be "
                         f"[rows, K] with one K")
    K = Ndk.shape[1]
    Nk = np.asarray(pack["Nk"], np.float32)
    if Nk.shape != (K,):
        raise ValueError(f"Nk must be [{K}], got shape {Nk.shape}")
    tokens = tuple(np.asarray(a) for a in pack["tokens"])
    if len(tokens) not in (3, 4):
        raise ValueError(f"tokens must be (ed, ew, od, ow) or (bd, bw, bm), "
                         f"got {len(tokens)} arrays")
    z = np.asarray(pack["z_grid"], np.int32)
    if z.shape != tokens[0].shape or tokens[1].shape != z.shape:
        raise ValueError(f"z_grid {z.shape} must have the token ids' shape "
                         f"{tokens[0].shape}")

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a).copy()).to(device)

    return {"Ndk": t(Ndk), "Nwk": t(Nwk), "Nk": t(Nk), "z_grid": t(z),
            "tokens": tuple(t(a) for a in tokens),
            "n_tokens": int(pack["n_tokens"])}


def svm_state_from_numpy(state: dict, device) -> dict:
    """The reference's SVM model (``harp_tpu.models.svm.SVM``'s ``w`` [d]
    and ``b``) → the port's tensors on ``device``, for
    ``models.svm.SVM(state=...)``."""
    w = np.asarray(state["w"], dtype=np.float32)
    if w.ndim != 1:
        raise ValueError(f"w must be [d], got shape {w.shape}")
    b = np.asarray(state["b"], dtype=np.float32)
    if b.size != 1:
        raise ValueError(f"b must be a scalar, got shape {b.shape}")
    return {"w": torch.from_numpy(w.copy()).to(device),
            "b": torch.tensor(float(b.reshape(())), dtype=torch.float32,
                              device=device)}


def mds_state_from_numpy(state: dict, device) -> dict:
    """The reference's MDS embedding ``"X"`` [n, dim] → the port's tensor on
    ``device``, for ``models.wdamds.mds(X0=...)``."""
    X = np.asarray(state["X"], dtype=np.float32)
    if X.ndim != 2:
        raise ValueError(f"X must be [n, dim], got shape {X.shape}")
    return {"X": torch.from_numpy(X.copy()).to(device)}


def rf_forest_from_numpy(state: dict, device) -> dict:
    """The reference's forest (``RandomForest.forest`` = (feats, thresh,
    leaves) and its bin ``edges``) → the port's tensors on ``device``, for
    ``models.rf.RandomForest(state=...)``.  ``feats`` and ``thresh`` are
    [T, 2^depth − 1] in heap order, ``leaves`` [T, 2^depth], ``edges``
    [f, n_bins − 1]."""
    out = {k: np.asarray(state[k], dtype=np.int32)
           for k in ("feats", "thresh", "leaves")}
    T, nodes = out["feats"].shape
    if out["thresh"].shape != (T, nodes) or out["leaves"].shape != (
            T, nodes + 1):
        raise ValueError(f"feats {out['feats'].shape}, thresh "
                         f"{out['thresh'].shape} and leaves "
                         f"{out['leaves'].shape} do not form a forest")
    out["edges"] = np.asarray(state["edges"], dtype=np.float32)
    if out["edges"].ndim != 2:
        raise ValueError(f"edges must be [f, n_bins - 1], got shape "
                         f"{out['edges'].shape}")
    return {k: torch.from_numpy(a.copy()).to(device) for k, a in out.items()}


def longctx_params_from_numpy(state: dict, device) -> dict:
    """The reference long-context layer's weights (``wq`` [model_d, h·d],
    ``wk`` and ``wv`` [model_d, g·d], ``wo`` [h·d, model_d]) → f32 tensors
    on ``device``, for ``examples.longctx_layer``."""
    out = {}
    for key in ("wq", "wk", "wv", "wo"):
        a = np.asarray(state[key], dtype=np.float32)
        if a.ndim != 2:
            raise ValueError(f"{key} must be 2-D, got shape {a.shape}")
        out[key] = torch.from_numpy(a.copy()).to(device)
    model_d, hd = out["wq"].shape
    if out["wo"].shape != (hd, model_d) or out["wk"].shape != out[
            "wv"].shape or out["wk"].shape[0] != model_d:
        raise ValueError(f"wq {tuple(out['wq'].shape)}, wk "
                         f"{tuple(out['wk'].shape)}, wv "
                         f"{tuple(out['wv'].shape)} and wo "
                         f"{tuple(out['wo'].shape)} do not form a layer")
    return out


def moe_params_from_numpy(state: dict, device, expert: int | None = None
                          ) -> dict:
    """The reference MoE's weights → f32 tensors on ``device``: ``gate``
    [d, E], and ``w1`` [E, d, h], ``b1`` [E, h], ``w2`` [E, h, d], ``b2``
    [E, d] stacked over the experts.  With ``expert=e`` the four expert
    tensors are expert ``e``'s alone (``ops.moe.moe_ffn``'s per-worker
    arguments)."""
    a = {k: np.asarray(state[k], dtype=np.float32)
         for k in ("gate", "w1", "b1", "w2", "b2")}
    d, E = a["gate"].shape
    h = a["w1"].shape[-1]
    want = {"w1": (E, d, h), "b1": (E, h), "w2": (E, h, d), "b2": (E, d)}
    for k, shape in want.items():
        if a[k].shape != shape:
            raise ValueError(f"{k} must be {shape} for gate {(d, E)}, got "
                             f"{a[k].shape}")
    if expert is not None:
        for k in want:
            a[k] = a[k][expert]
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in a.items()}


def _layers_of(tree) -> list:
    """The leaves of a list of ``{"w", "b"}`` layer dicts in the reference's
    flattening order (sorted keys: ``b`` before ``w``)."""
    return [np.asarray(layer[k], np.float32) for layer in tree
            for k in sorted(layer)]


def mlp_params_from_numpy(state: dict, device) -> dict:
    """The reference MLP's parameters and optimizer state → the port's
    tensors on ``device``, for ``models.mlp.MLPTrainer(state=...)`` (and
    ``TPMLPTrainer``, which takes the params alone).

    ``state["params"]`` is the reference's list of ``{"w": [fan_in,
    fan_out], "b": [fan_out]}`` layers.  ``state["opt_state"]``, when
    given, is ``{}`` (sgd), ``{"trace": ...}`` (momentum) or ``{"count",
    "mu", "nu"}`` (adam), where each of ``trace``, ``mu``, ``nu`` is either
    a list of layer dicts shaped like the params (the replicated layout) or
    one [nw · L] vector (the ZeRO-1 layout, which the trainer cuts to each
    worker's slice).  Returns ``{"params": [...], "opt_state": {...}}``
    with the state's vectors as lists in the params' leaf order."""
    params = []
    for layer in state["params"]:
        w = np.asarray(layer["w"], np.float32)
        b = np.asarray(layer["b"], np.float32)
        if w.ndim != 2 or b.shape != (w.shape[1],):
            raise ValueError(f"a layer needs w [fan_in, fan_out] and b "
                             f"[fan_out], got {w.shape} and {b.shape}")
        params.append({"w": torch.from_numpy(w.copy()).to(device),
                       "b": torch.from_numpy(b.copy()).to(device)})
    out = {"params": params, "opt_state": None}
    opt = state.get("opt_state")
    if opt is not None:
        conv = {}
        for key, val in opt.items():
            if key == "count":
                conv[key] = torch.tensor(int(np.asarray(val)),
                                         dtype=torch.int32, device=device)
                continue
            arrays = ([np.asarray(val, np.float32)]
                      if isinstance(val, np.ndarray) and val.ndim == 1
                      else _layers_of(val))
            conv[key] = [torch.from_numpy(a.copy()).to(device)
                         for a in arrays]
        out["opt_state"] = conv
    return out


def ccd_state_from_numpy(state: dict, device) -> dict:
    """The reference CCD++'s factors (the global ``"W"`` [u_bound · n,
    rank], rows padded per worker range, and the replicated ``"H"``
    [n_items, rank]) → f32 tensors on ``device``, for
    ``models.ccd.CCD(state=...)``, which checks the shapes and shards W."""
    out = {}
    for key in ("W", "H"):
        a = np.asarray(state[key], dtype=np.float32)
        if a.ndim != 2:
            raise ValueError(f"{key} must be [rows, rank], got shape "
                             f"{a.shape}")
        out[key] = torch.from_numpy(a.copy()).to(device)
    if out["W"].shape[1] != out["H"].shape[1]:
        raise ValueError(f"W and H ranks differ: {out['W'].shape[1]} vs "
                         f"{out['H'].shape[1]}")
    return out
