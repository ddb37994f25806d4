"""Parallel linear SVM with a support-vector exchange — the port of
``harp_tpu.models.svm``.

Harp's ``edu.iu.svm``: each worker trains on its shard plus the current
global support vectors, the support vectors are gathered, and the loop
repeats.  Here the local solve is Pegasos-style sub-gradient descent on the
hinge loss; the "support vectors" are each worker's ``sv_per_worker`` most
violating rows (smallest margin), exchanged every outer round through
``reshard`` blocked(0) → replicated on ``sv_wire``; after the rounds w and b
are averaged over the workers.

Two inner solves (``SVMConfig.algo``): ``"xla"``, the reference's two
products a step in plain torch (:func:`_pegasos`), and ``"pallas"``, kernel
K5 (:func:`harp_tpu_torch.ops.svm_kernel.pegasos_grad`), one fused pass a
step (:func:`_pegasos_pallas`).  The 200-step loop never waits for the
device: the step size is a host number and ``b`` stays on the device.

Not ported yet: ``fit_sparse``, ``make_train_fn_ell`` and the CLI's
``--libsvm`` (ELL rows from the native libsvm loader; ROADMAP.md, Queue 1,
item 5).  Each raises ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from harp_tpu_torch.models.kmeans import _exact_f32
from harp_tpu_torch.models.stats import _shard_rows
from harp_tpu_torch.ops import svm_kernel
from harp_tpu_torch.parallel import collective as C
from harp_tpu_torch.parallel.mesh import WorkerMesh, num_workers, resolve_mesh
from harp_tpu_torch.utils import telemetry

_NOT_PORTED = ("the sparse ELL path is not ported yet (ROADMAP.md, Queue 1, "
               "item 5: the native libsvm loader)")


@dataclasses.dataclass
class SVMConfig:
    l2: float = 1e-3
    lr: float = 0.1
    inner_steps: int = 200    # Pegasos steps per outer round
    outer_rounds: int = 5     # support-vector exchange rounds
    sv_per_worker: int = 256  # most-violating rows each worker sends
    # the exchange's wire: "bf16"/"int8" narrow every float leaf of the
    # [nw*k, d] rows, labels and masks with one rounding per exchange
    sv_wire: str = "exact"
    # the dtype x is staged in; "bf16" halves the bytes K5 streams
    x_dtype: str = "f32"
    # inner solve: "xla" (plain torch) or "pallas" (kernel K5)
    algo: str = "xla"

    def __post_init__(self):
        if self.sv_wire not in ("exact", "bf16", "int8"):
            raise ValueError(
                f"sv_wire must be exact|bf16|int8, got {self.sv_wire!r}")
        if self.x_dtype not in ("f32", "bf16"):
            raise ValueError(
                f"x_dtype must be f32|bf16, got {self.x_dtype!r}")
        if self.algo not in ("xla", "pallas"):
            raise ValueError(f"algo must be xla|pallas, got {self.algo!r}")


def _lr(cfg: SVMConfig, t: int) -> float:
    """Step ``t``'s size, rounded as the reference's f32 arithmetic rounds
    it (a host number: the loop never reads the device)."""
    f32 = np.float32
    return float(f32(cfg.lr) / (f32(1.0) + f32(0.01) * f32(t)))


def _pegasos(w, b, x, y, sample_w, cfg: SVMConfig):
    """Batched hinge-loss subgradient descent on (x, y) with weights: two
    products a step, the reference's ``xla`` arm (a bf16 ``x`` promotes to
    f32, as there)."""
    xf = x.to(torch.float32)
    denom = sample_w.sum().clamp_min(1.0)
    for t in range(cfg.inner_steps):
        margin = y * (xf @ w + b)
        vy = (margin < 1.0).to(torch.float32) * sample_w * y
        lr = _lr(cfg, t)
        gw = cfg.l2 * w - (vy @ xf) / denom
        gb = -vy.sum() / denom
        w, b = w - lr * gw, b - lr * gb
    return w, b


def _pegasos_pallas(w, b, x, y, sample_w, cfg: SVMConfig):
    """:func:`_pegasos` on kernel K5: one fused pass a step.  The same
    update sequence, so it matches the ``xla`` arm to accumulation-order
    rounding (f32 ``x``)."""
    denom = sample_w.sum().clamp_min(1.0)
    x = x.contiguous()
    for t in range(cfg.inner_steps):
        gw, gs = svm_kernel.pegasos_grad(w, b, x, y, sample_w)
        lr = _lr(cfg, t)
        # gw is Σ coef·x (un-normalised) and gs = Σ coef = −denom·gb
        w = w - lr * (cfg.l2 * w - gw / denom)
        b = b + lr * gs / denom
    return w, b


def _most_violating(score, k: int):
    """Indices of the ``k`` smallest scores, ties toward the lower index:
    ``lax.top_k(-score, k)``'s choice (a stable sort; ``torch.topk``
    promises no order among ties)."""
    return torch.argsort(score, stable=True)[:k]


def _train(x, y, sample_w, cfg: SVMConfig, k: int):
    """This worker's outer rounds → the averaged (w [d], b) on every worker.
    ``x`` [n_loc, d], ``y`` and ``sample_w`` [n_loc] are the local shard."""
    nw, d, dev = num_workers(), x.shape[1], x.device
    w = torch.zeros((d,), dtype=torch.float32, device=dev)
    b = torch.zeros((), dtype=torch.float32, device=dev)
    sv_rows = torch.zeros((nw * k, d), dtype=x.dtype, device=dev)
    sv_y = torch.zeros((nw * k,), dtype=torch.float32, device=dev)
    sv_m = torch.zeros((nw * k,), dtype=torch.float32, device=dev)
    solve = _pegasos_pallas if cfg.algo == "pallas" else _pegasos
    inf = torch.tensor(float("inf"), device=dev)
    for _ in range(cfg.outer_rounds):
        w, b = solve(w, b, torch.cat([x, sv_rows]), torch.cat([y, sv_y]),
                     torch.cat([sample_w, sv_m]), cfg)
        # margin violators of the local shard -> the k most violating
        score = torch.where(sample_w > 0,
                            y * (x.to(torch.float32) @ w + b), inf)
        idx = _most_violating(score, k)
        cand_m = (score[idx] < 1.0).to(torch.float32)
        sv_rows, sv_y, sv_m = C.reshard(
            (x[idx], y[idx], cand_m), C.ShardSpec.blocked(0),
            C.ShardSpec.replicated(), wire=cfg.sv_wire)
    return C.allreduce(w, C.Combiner.AVG), C.allreduce(b, C.Combiner.AVG)


class SVM:
    """Host driver (the mapCollective residue for edu.iu.svm).  Binary,
    y ∈ {-1, +1}.  Runs on this worker's card unless ``device`` (or
    ``mesh``) says otherwise; ``state`` (from ``convert.
    svm_state_from_numpy``) sets a trained model."""

    def __init__(self, cfg: SVMConfig | None = None,
                 mesh: WorkerMesh | None = None, device=None,
                 state: dict | None = None):
        self.mesh = resolve_mesh(mesh, device)
        self.cfg = cfg or SVMConfig()
        self.w = None
        self.b = None
        if state is not None:
            self.w = state["w"].detach().cpu().numpy()
            self.b = float(state["b"])

    def fit(self, x, y):
        x = np.asarray(x, np.float32)
        y = np.asarray(y, np.float32)
        if not set(np.unique(y)) <= {-1.0, 1.0}:
            raise ValueError("labels must be ±1")
        _exact_f32(self.mesh.device)
        xt = torch.from_numpy(x)
        if self.cfg.x_dtype == "bf16":
            # cast before sharding, so the staged bytes halve
            xt = xt.to(torch.bfloat16)
        # padded rows get y = 0 and weight 0: zero hinge gradient, never
        # chosen as support vectors (their margin is masked to +inf)
        xd, yd, swd = _shard_rows(self.mesh, xt, y)
        k = min(self.cfg.sv_per_worker, xd.shape[0])
        with telemetry.span("svm.fit"), \
                telemetry.ledger.run("svm.fit", steps=self.cfg.outer_rounds):
            w, b = _train(xd, yd, swd, self.cfg, k)
            self.w, self.b = w.cpu().numpy(), float(b)
        return self

    def fit_sparse(self, ids, vals, mask, y, n_features: int):
        raise NotImplementedError("SVM.fit_sparse: " + _NOT_PORTED)

    def decision_function(self, x):
        return np.asarray(x, np.float32) @ self.w + self.b

    def predict(self, x):
        return np.sign(self.decision_function(x))

    def accuracy(self, x, y):
        return float((self.predict(x) == np.asarray(y)).mean())


def make_train_fn_ell(*args, **kwargs):
    raise NotImplementedError("make_train_fn_ell: " + _NOT_PORTED)


def synthetic_data(n: int, d: int, seed: int = 0):
    """The reference benchmark's task: a random hyperplane, labels from its
    side plus a little noise."""
    rng = np.random.default_rng(seed)
    true_w = rng.normal(size=d).astype(np.float32)
    x = rng.normal(size=(n, d)).astype(np.float32)
    y = np.sign(x @ true_w + 0.1 * rng.normal(size=n)).astype(np.float32)
    return x, y


def benchmark(n=500_000, d=128, mesh=None, seed=0, sv_wire="exact",
              x_dtype="f32", algo="xla", device=None):
    """Samples per second of one timed ``fit`` after an untimed one, and
    the training accuracy on the first 50,000 rows."""
    mesh = resolve_mesh(mesh, device)
    x, y = synthetic_data(n, d, seed)
    model = SVM(SVMConfig(sv_wire=sv_wire, x_dtype=x_dtype, algo=algo),
                mesh=mesh)
    model.fit(x, y)  # warmup: builds the kernel, fills the allocator
    t0 = time.perf_counter()
    model.fit(x, y)
    dt = time.perf_counter() - t0
    return {"fit_sec": dt, "samples_per_sec": n / dt,
            "train_acc": model.accuracy(x[:50_000], y[:50_000]),
            "n": n, "d": d, "sv_wire": sv_wire, "x_dtype": x_dtype,
            "algo": algo, "num_workers": mesh.num_workers}


def main(argv=None):
    import argparse

    from harp_tpu_torch.utils.metrics import benchmark_json

    p = argparse.ArgumentParser(
        description="harp-tpu SVM on PyTorch (edu.iu.svm parity)")
    p.add_argument("--n", type=int, default=500_000)
    p.add_argument("--d", type=int, default=128)
    p.add_argument("--libsvm", default=None, metavar="FILE",
                   help="train on a libsvm-format file (not ported yet)")
    p.add_argument("--zero-based", action="store_true",
                   help="file indices start at 0 (with --libsvm)")
    p.add_argument("--algo", choices=("xla", "pallas"), default="xla",
                   help="inner solve (pallas = kernel K5)")
    p.add_argument("--device", default=None,
                   help="torch device (default: this worker's card; 'cpu' "
                        "runs on the CPU)")
    args = p.parse_args(argv)
    if args.libsvm:
        raise NotImplementedError("--libsvm: " + _NOT_PORTED)
    mesh = WorkerMesh(args.device)
    print(benchmark_json("svm_cli", benchmark(args.n, args.d, mesh=mesh,
                                              algo=args.algo), mesh.device))
    return 0


if __name__ == "__main__":
    main()
