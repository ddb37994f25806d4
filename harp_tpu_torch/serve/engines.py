"""Per-app inference engines: the batched predict steps — the port of
``harp_tpu.serve.engines``.

Each engine owns three things for one trained app:

- **state**: which arrays a checkpoint must provide (checked on the host
  with numpy), and where each lives on the worker group (replicated, or
  sharded for MF-SGD's item factors);
- **step**: the batched inference at one ladder rung, plain torch on the
  mesh's device.  Every step folds its outputs into ONE tensor, so a
  batch is one readback, and takes the batch input as its last argument.
  The serve cache captures it as a CUDA graph once per rung
  (:mod:`harp_tpu_torch.serve.cache`); on the CPU it runs eagerly;
- **protocol**: how request JSON rows become the padded input array and
  how the stacked output becomes per-row results.

State layout (what a checkpoint of :mod:`harp_tpu_torch.utils.checkpoint`
holds for each app):

==========  ==========================================================
app         required checkpoint keys
==========  ==========================================================
``kmeans``  ``centroids`` [k, d]
``mfsgd``   ``W`` [n_users, r], ``H`` [n_items, r] (stripped factors,
            ``MFSGD.factors()``, not the padded training layout)
``lda``     ``Nwk`` [vocab, K] word-topic counts (``Nk`` optional,
            recomputed when absent)
``mlp``     ``params`` (the trainer's layer list of ``{"w", "b"}``)
``rf``      ``feats``/``thresh``/``leaves`` (the forest) + ``edges``
            (the quantile bin edges)
``svm``     ``w`` [d], ``b`` scalar
==========  ==========================================================

Extra keys are ignored, so a trainer's checkpoint that holds these keys
(KMeans' ``fit(ckpt_dir=...)``) loads directly.  The products are
``torch.matmul``: the reference computes them outside any kernel too.
"""

from __future__ import annotations

import numpy as np
import torch

from harp_tpu_torch.parallel import collective as C
from harp_tpu_torch.parallel.mesh import WorkerMesh

_F32 = np.float32


def _require(state: dict, keys: tuple, app: str) -> None:
    missing = [k for k in keys if k not in state]
    if missing:
        raise KeyError(
            f"serve[{app}]: checkpoint state is missing {missing} "
            f"(has {sorted(state)}) — see harp_tpu_torch/serve/engines.py "
            "for the per-app state layout")


def _np(x, dtype=None):
    a = x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x)
    return a.astype(dtype) if dtype is not None and a.dtype != dtype else a


class Engine:
    """Base: replicated state, ``x`` rows as f32 feature vectors."""

    app = "?"
    #: request key carrying the rows (list-of-lists unless overridden)
    REQUEST_KEY = "x"

    def fingerprint_modules(self) -> tuple:
        """Model modules whose source joins the cache's code fingerprint."""
        return ()

    def cache_tag(self) -> str:
        """Engine options baked into the step as constants (not visible in
        any input shape); they join the cache key, so ``--topk 20`` never
        hits a ``--topk 10`` record."""
        return ""

    def __init__(self, state: dict, mesh: WorkerMesh):
        self.mesh = mesh
        self._dev_state: tuple | None = None
        self._load(dict(state))

    # -- subclass surface --------------------------------------------------
    def _load(self, state: dict) -> None:
        raise NotImplementedError

    def step(self):
        """The batched step: ``fn(*state_args, x) -> stacked out``."""
        raise NotImplementedError

    def split_step(self):
        """``(local, gather, merge)`` for a step with a collective inside
        (``merge(gather(local(*state_args, x)))`` is the step), so that a
        capture on more than one worker can leave the collective out; None
        for a step without one."""
        return None

    def _input_cols(self) -> tuple[int, ...]:
        """Trailing input dims (input is [batch, *cols])."""
        raise NotImplementedError

    def _input_dtype(self):
        return _F32

    def output_rows(self, out: np.ndarray, n_rows: int) -> list:
        raise NotImplementedError

    # -- shared machinery --------------------------------------------------
    def state_args(self) -> tuple:
        """Resident device tensors, placed once (replicated by default)."""
        if self._dev_state is None:
            self._dev_state = tuple(
                self.mesh.replicated(np.ascontiguousarray(a))
                for a in self._host_state())
        return self._dev_state

    def _host_state(self) -> tuple:
        raise NotImplementedError

    def input_shape(self, rung: int) -> tuple[int, ...]:
        return (rung,) + tuple(self._input_cols())

    def input_torch_dtype(self) -> torch.dtype:
        return torch.from_numpy(np.zeros(0, self._input_dtype())).dtype

    def rows_from_request(self, req: dict) -> np.ndarray:
        if self.REQUEST_KEY not in req:
            raise ValueError(
                f"serve[{self.app}]: request needs {self.REQUEST_KEY!r}")
        rows = _np(req[self.REQUEST_KEY], self._input_dtype())
        want = (None,) + self._input_cols()
        if rows.ndim != len(want) or rows.shape[1:] != want[1:]:
            raise ValueError(
                f"serve[{self.app}]: rows shaped {rows.shape}, expected "
                f"[n, {', '.join(str(c) for c in want[1:])}]")
        return rows

    def make_input(self, rows: np.ndarray, rung: int) -> np.ndarray:
        """Pad the real rows up to the rung with zeros (row 0 semantics
        are harmless in every engine; padded outputs are sliced off)."""
        if rows.shape[0] == rung:
            return np.ascontiguousarray(rows)
        pad = np.zeros((rung - rows.shape[0],) + rows.shape[1:],
                       rows.dtype)
        return np.concatenate([rows, pad], axis=0)

    def put_input(self, arr: np.ndarray, dst: torch.Tensor,
                  host: torch.Tensor | None = None) -> torch.Tensor:
        """Stage one padded batch on the device: the serve plane's bulk
        H2D, one counted placement a batch window, into ``dst``, a rung's
        static input (the buffer its captured graph reads).  ``host`` is a
        pinned staging buffer of the same shape on the card, from which
        the copy runs without blocking the host."""
        from harp_tpu_torch.utils import flightrec

        flightrec.record_h2d(arr.nbytes)
        src = torch.from_numpy(np.ascontiguousarray(arr))
        if host is not None:
            host.copy_(src)
            dst.copy_(host, non_blocking=True)
        else:
            dst.copy_(src)
        return dst

    # -- bench/test helpers ------------------------------------------------
    @classmethod
    def synthetic_state(cls, rng: np.random.Generator, **shape) -> dict:
        raise NotImplementedError

    def synthetic_request(self, rng: np.random.Generator,
                          n_rows: int) -> dict:
        raise NotImplementedError


class KMeansAssign(Engine):
    """Nearest-centroid assignment — the serving half of edu.iu.kmeans:
    ``argmin(|c|² − 2·x·cᵀ)`` (the row norms drop out of the argmin), ties
    to the lowest index."""

    app = "kmeans"

    def _load(self, state: dict) -> None:
        _require(state, ("centroids",), self.app)
        self.centroids = _np(state["centroids"], _F32)
        if self.centroids.ndim != 2:
            raise ValueError("centroids must be [k, d]")
        self.k, self.d = self.centroids.shape

    def _host_state(self):
        return (self.centroids,)

    def _input_cols(self):
        return (self.d,)

    def step(self):
        def step(centroids, x):
            dots = x @ centroids.T
            c2 = (centroids * centroids).sum(-1)
            return torch.argmin(c2[None, :] - 2.0 * dots,
                                dim=1).to(torch.int32)

        return step

    def output_rows(self, out, n_rows):
        return [int(c) for c in out[:n_rows]]

    @classmethod
    def synthetic_state(cls, rng, k=16, d=32, **_):
        return {"centroids": rng.normal(size=(k, d)).astype(_F32)}

    def synthetic_request(self, rng, n_rows):
        return {"x": rng.normal(size=(n_rows, self.d)).astype(
            _F32).tolist()}


class MFSGDTopK(Engine):
    """Dot-product top-k recommendation over MF factors.

    Model-parallel on the worker group: ``H`` (padded to a multiple of the
    workers) is sharded over the item axis, each worker scores its slice
    and keeps a local top-k with the padded tail masked, and one
    ``allgather`` merges the per-worker candidates into the exact global
    top-k.  Ids travel as f32, as in the reference."""

    app = "mfsgd"
    REQUEST_KEY = "users"

    def __init__(self, state: dict, mesh: WorkerMesh, topk: int = 10):
        self.topk = int(topk)
        super().__init__(state, mesh)

    def cache_tag(self) -> str:
        # n_items too: it masks the padded tail as a constant of the step
        return f"topk={self.topk},n_items={self.n_items}"

    def _load(self, state: dict) -> None:
        _require(state, ("W", "H"), self.app)
        self.W = _np(state["W"], _F32)
        H = _np(state["H"], _F32)
        if self.W.ndim != 2 or H.ndim != 2 or self.W.shape[1] != H.shape[1]:
            raise ValueError("W/H must be [n, r] with matching rank")
        self.n_users, self.rank = self.W.shape
        self.n_items = H.shape[0]
        self.topk = min(self.topk, self.n_items)
        nw = self.mesh.num_workers
        ipw = -(-self.n_items // nw)
        pad = nw * ipw - self.n_items
        self.H_padded = (np.concatenate(
            [H, np.zeros((pad, self.rank), _F32)]) if pad else H)
        self.items_per_worker = ipw

    def _host_state(self):
        return (self.W, self.H_padded)

    def state_args(self):
        if self._dev_state is None:
            self._dev_state = (self.mesh.replicated(self.W),
                               self.mesh.shard_array(self.H_padded))
        return self._dev_state

    def _input_cols(self):
        return ()

    def _input_dtype(self):
        return np.int32

    def split_step(self):
        kk, ipw, n_items = self.topk, self.items_per_worker, self.n_items
        k_local = min(kk, ipw)
        base = self.mesh.rank * ipw

        def local(W, H_loc, users):
            w = W.index_select(0, users.to(torch.int64))          # [b, r]
            scores = w @ H_loc.T                                  # [b, ipw]
            gid = base + torch.arange(ipw, device=scores.device,
                                      dtype=torch.int32)
            scores = torch.where(gid[None, :] < n_items, scores,
                                 torch.full_like(scores, -torch.inf))
            s_loc, i_loc = torch.topk(scores, k_local, dim=1)     # [b, kl]
            id_loc = (base + i_loc).to(torch.float32)
            return s_loc, id_loc

        def gather(part):
            return C.allgather(part, tiled=False)                 # [nw, b, kl]

        def merge(gathered):
            s_all, id_all = gathered
            b = s_all.shape[1]
            s_all = s_all.transpose(0, 1).reshape(b, -1)
            id_all = id_all.transpose(0, 1).reshape(b, -1)
            s_top, pick = torch.topk(s_all, kk, dim=1)            # [b, kk]
            id_top = id_all.gather(1, pick)
            return torch.cat([id_top, s_top], dim=1)              # [b, 2kk]

        return local, gather, merge

    def step(self):
        local, gather, merge = self.split_step()

        def step(W, H_loc, users):
            return merge(gather(local(W, H_loc, users)))

        return step

    def rows_from_request(self, req: dict) -> np.ndarray:
        if "users" not in req:
            raise ValueError("serve[mfsgd]: request needs 'users'")
        users = _np(req["users"], np.int32)
        if users.ndim != 1:
            raise ValueError("serve[mfsgd]: 'users' must be a flat list")
        if users.size and (users.min() < 0 or users.max() >= self.n_users):
            raise ValueError(
                f"serve[mfsgd]: user ids must lie in [0, {self.n_users})")
        return users

    def output_rows(self, out, n_rows):
        kk = self.topk
        ids = out[:n_rows, :kk].astype(np.int64)
        scores = out[:n_rows, kk:]
        return [{"items": r_ids.tolist(),
                 "scores": [round(float(s), 6) for s in r_s]}
                for r_ids, r_s in zip(ids, scores)]

    @classmethod
    def synthetic_state(cls, rng, n_users=512, n_items=256, rank=16, **_):
        return {"W": rng.normal(size=(n_users, rank)).astype(_F32),
                "H": rng.normal(size=(n_items, rank)).astype(_F32)}

    def synthetic_request(self, rng, n_rows):
        return {"users": rng.integers(0, self.n_users,
                                      n_rows).astype(int).tolist()}


class LDAInfer(Engine):
    """Fold-in topic inference from trained word-topic counts: requests
    carry bag-of-words count vectors over the training vocabulary, and the
    step runs ``em_iters`` EM iterations of the standard fold-in (φ held
    fixed, each document's θ re-estimated) — two products an iteration."""

    app = "lda"

    def __init__(self, state: dict, mesh: WorkerMesh, em_iters: int = 16,
                 beta: float = 0.01, alpha: float = 0.0):
        self.em_iters = int(em_iters)
        self.beta = float(beta)
        self.alpha = float(alpha)
        super().__init__(state, mesh)

    def cache_tag(self) -> str:
        # beta only smooths phi on the host, and phi is an input
        return f"em={self.em_iters},a={self.alpha}"

    def _load(self, state: dict) -> None:
        _require(state, ("Nwk",), self.app)
        Nwk = _np(state["Nwk"], _F32)
        if Nwk.ndim != 2:
            raise ValueError("Nwk must be [vocab, K]")
        self.vocab_size, self.n_topics = Nwk.shape
        Nk = (_np(state["Nk"], _F32) if "Nk" in state else Nwk.sum(0))
        # phi[w, k] = p(w | k), smoothed exactly as training's sampler
        self.phi = ((Nwk + self.beta)
                    / (Nk[None, :] + self.vocab_size * self.beta)
                    ).astype(_F32)

    def _host_state(self):
        return (self.phi,)

    def _input_cols(self):
        return (self.vocab_size,)

    def step(self):
        K, iters, alpha = self.n_topics, self.em_iters, self.alpha

        def step(phi, x):
            theta = torch.full((x.shape[0], K), 1.0 / K,
                               dtype=torch.float32, device=x.device)
            for _ in range(iters):
                denom = theta @ phi.T                               # [b, V]
                r = x / torch.clamp_min(denom, 1e-30)
                theta = theta * (r @ phi) + alpha
                theta = theta / torch.clamp_min(
                    theta.sum(-1, keepdim=True), 1e-30)
            return theta

        return step

    def output_rows(self, out, n_rows):
        return [{"theta": [round(float(t), 6) for t in row]}
                for row in out[:n_rows]]

    @classmethod
    def synthetic_state(cls, rng, vocab_size=128, n_topics=8, **_):
        return {"Nwk": rng.integers(
            0, 50, (vocab_size, n_topics)).astype(_F32)}

    def synthetic_request(self, rng, n_rows):
        return {"x": rng.integers(
            0, 4, (n_rows, self.vocab_size)).astype(_F32).tolist()}


def _int_if_digit(k):
    return (0, int(k)) if str(k).isdigit() else (1, str(k))


class MLPPredict(Engine):
    """Forward pass through the trained MLP (logits; the class is the
    host-side argmax), through the port's ``models.mlp.forward``."""

    app = "mlp"

    def fingerprint_modules(self):
        from harp_tpu_torch.models import mlp

        return (mlp,)

    def _load(self, state: dict) -> None:
        _require(state, ("params",), self.app)
        params = state["params"]
        if isinstance(params, dict):  # a list saved as a dict of indices
            params = [params[k] for k in sorted(params, key=_int_if_digit)]
        self.params = [{"w": _np(l["w"], _F32), "b": _np(l["b"], _F32)}
                       for l in params]
        self.d_in = self.params[0]["w"].shape[0]
        self.n_classes = self.params[-1]["w"].shape[1]

    def _host_state(self):
        out = []
        for layer in self.params:
            out += [layer["w"], layer["b"]]
        return tuple(out)

    def _input_cols(self):
        return (self.d_in,)

    def step(self):
        from harp_tpu_torch.models.mlp import MLPConfig, forward

        sizes = [self.d_in] + [l["w"].shape[1] for l in self.params]
        cfg = MLPConfig(sizes=tuple(sizes))
        n_layers = len(self.params)

        def step(*args):
            flat, x = args[:-1], args[-1]
            params = [{"w": flat[2 * i], "b": flat[2 * i + 1]}
                      for i in range(n_layers)]
            return forward(params, x, cfg)                 # [b, classes]

        return step

    def output_rows(self, out, n_rows):
        out = out[:n_rows]
        return [{"class": int(np.argmax(row)),
                 "logits": [round(float(v), 6) for v in row]}
                for row in out]

    @classmethod
    def synthetic_state(cls, rng, sizes=(32, 16, 4), **_):
        params = []
        for fan_in, fan_out in zip(sizes[:-1], sizes[1:]):
            params.append({
                "w": (rng.normal(size=(fan_in, fan_out))
                      * np.sqrt(2.0 / fan_in)).astype(_F32),
                "b": np.zeros((fan_out,), _F32)})
        return {"params": params}

    def synthetic_request(self, rng, n_rows):
        return {"x": rng.normal(size=(n_rows, self.d_in)).astype(
            _F32).tolist()}


class RFPredict(Engine):
    """Majority-vote forest prediction: host ``binize``, then the port's
    ``predict_forest`` on the device."""

    app = "rf"

    def fingerprint_modules(self):
        from harp_tpu_torch.models import rf

        return (rf,)

    def _load(self, state: dict) -> None:
        _require(state, ("feats", "thresh", "leaves", "edges"), self.app)
        self.feats = _np(state["feats"], np.int32)
        self.thresh = _np(state["thresh"], np.int32)
        self.leaves = _np(state["leaves"], np.int32)
        self.edges = _np(state["edges"], _F32)
        inner = self.feats.shape[1]
        self.max_depth = int(np.log2(inner + 1))
        if 2 ** self.max_depth - 1 != inner:
            raise ValueError(f"feats width {inner} is not 2^d - 1")
        self.n_classes = int(state.get("n_classes",
                                       int(self.leaves.max()) + 1))
        self.n_features = self.edges.shape[0]

    def _host_state(self):
        return (self.feats, self.thresh, self.leaves)

    def _input_cols(self):
        return (self.n_features,)

    def _input_dtype(self):
        return np.int32

    def step(self):
        from harp_tpu_torch.models.rf import predict_forest

        max_depth, n_classes = self.max_depth, self.n_classes

        def step(feats, thresh, leaves, bins):
            return predict_forest((feats, thresh, leaves), bins, max_depth,
                                  n_classes).to(torch.int32)

        return step

    def rows_from_request(self, req: dict) -> np.ndarray:
        from harp_tpu_torch.models.rf import binize

        if "x" not in req:
            raise ValueError("serve[rf]: request needs 'x'")
        x = _np(req["x"], _F32)
        if x.ndim != 2 or x.shape[1] != self.n_features:
            raise ValueError(
                f"serve[rf]: rows shaped {x.shape}, expected "
                f"[n, {self.n_features}]")
        return binize(x, self.edges)

    def output_rows(self, out, n_rows):
        return [int(c) for c in out[:n_rows]]

    @classmethod
    def synthetic_state(cls, rng, n_trees=4, max_depth=3, n_features=8,
                        n_bins=16, n_classes=2, **_):
        inner = 2 ** max_depth - 1
        return {
            "feats": rng.integers(0, n_features,
                                  (n_trees, inner)).astype(np.int32),
            "thresh": rng.integers(0, n_bins - 1,
                                   (n_trees, inner)).astype(np.int32),
            "leaves": rng.integers(0, n_classes,
                                   (n_trees, 2 ** max_depth)
                                   ).astype(np.int32),
            "edges": np.sort(rng.normal(size=(n_features, n_bins - 1)),
                             axis=1).astype(_F32),
            "n_classes": np.int64(n_classes),
        }

    def synthetic_request(self, rng, n_rows):
        return {"x": rng.normal(size=(n_rows, self.n_features)).astype(
            _F32).tolist()}


class SVMPredict(Engine):
    """Linear decision function; the label is the host-side sign."""

    app = "svm"

    def _load(self, state: dict) -> None:
        _require(state, ("w", "b"), self.app)
        self.w = _np(state["w"], _F32).reshape(-1)
        self.b = _F32(np.asarray(state["b"]).reshape(()))
        self.d = self.w.shape[0]

    def _host_state(self):
        return (self.w, np.asarray(self.b, _F32))

    def _input_cols(self):
        return (self.d,)

    def step(self):
        def step(w, b, x):
            return x @ w + b                                # [b]

        return step

    def output_rows(self, out, n_rows):
        return [{"score": round(float(s), 6),
                 "label": 1 if s >= 0 else -1} for s in out[:n_rows]]

    @classmethod
    def synthetic_state(cls, rng, d=32, **_):
        return {"w": rng.normal(size=d).astype(_F32), "b": _F32(0.1)}

    def synthetic_request(self, rng, n_rows):
        return {"x": rng.normal(size=(n_rows, self.d)).astype(
            _F32).tolist()}


ENGINES: dict[str, type[Engine]] = {
    e.app: e for e in (KMeansAssign, MFSGDTopK, LDAInfer, MLPPredict,
                       RFPredict, SVMPredict)}


def make_engine(app: str, state: dict, mesh: WorkerMesh,
                **opts) -> Engine:
    if app not in ENGINES:
        raise ValueError(
            f"no serve engine for {app!r}; choose from {sorted(ENGINES)}")
    return ENGINES[app](state, mesh, **opts)
