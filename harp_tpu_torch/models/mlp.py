"""Neural net (MLP) — graded config #4, MNIST with a gradient allreduce; the
port of ``harp_tpu.models.mlp``.

Harp-DAAL's ``edu.iu.daal_nn`` trains an MLP data-parallel: each worker
computes gradients on its shard, a Harp ``allreduce`` combines them, and
every worker applies the same update, so the weights stay replicated.

:class:`MLPTrainer` is that loop: autograd through the MLP, the gradients
averaged with the app-level verb (``C.allreduce``, or
``C.allreduce_quantized`` on a bf16/int8 ``grad_wire``), then the update.
With ``zero1`` the optimizer state is sharded instead: the gradient shards
are pushed to their owners (``C.push`` / ``C.push_quantized``), each worker
updates its 1/nw slice of the flat parameter vector, and the slices are
pulled back (``C.pull``).  The optimizers (sgd, momentum, adam) are plain
elementwise functions on lists of tensors, written with optax's formulas
in optax's order, so the replicated and ZeRO-1 paths share one update.

:class:`TPMLPTrainer` is the tensor-parallel extension on a
:func:`~harp_tpu_torch.parallel.mesh.mesh_2d` (data × model) layout: even
layers are column-parallel (``w`` split on its output dim, ``b`` with it),
odd ones row-parallel (``w`` split on its input dim; the partial products
are summed over the model group and the replicated ``b`` added after the
sum), the logits are gathered over the model group when the last layer is
column-parallel, and the gradients are averaged over the data group.  The
model-group collectives are ``torch.autograd.Function`` pairs, each with
its adjoint as its backward (Megatron's f and g), kept out of the verbs.

f32 products on the card run in full f32 (TF32 off).  The batch order of
:meth:`MLPTrainer.fit_resident` comes from a ``torch.Generator`` on the
worker's device (the reference's ``jax.random.permutation`` cannot be
reproduced), seeded alike on every worker.

``fit_ckpt`` trains epochs of :meth:`MLPTrainer.fit_resident` with
checkpoint/resume (:func:`harp_tpu_torch.utils.fault.fit_epochs`).

With telemetry on, each epoch of :meth:`MLPTrainer.fit` is held to a
warn-mode flight budget: exactly this worker's batch bytes cross to the
device, and nothing is built after the first epoch.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from harp_tpu_torch.ingest import IngestPipeline
from harp_tpu_torch.models.kmeans import _exact_f32
from harp_tpu_torch.parallel import collective as C
from harp_tpu_torch.parallel.mesh import (Mesh2D, WorkerMesh, mesh_2d,
                                         num_workers, resolve_mesh, worker_id)
from harp_tpu_torch.utils import flightrec
from harp_tpu_torch.utils.timing import device_sync



@dataclasses.dataclass
class MLPConfig:
    sizes: Sequence[int] = (784, 512, 256, 10)  # MNIST default (daal_nn MLP)
    lr: float = 0.01
    optimizer: str = "sgd"  # sgd | momentum | adam
    half_precision: bool = False  # bf16 activations, f32 params
    # gradient wire: "f32" (exact) | "bf16" | "int8"; loss and accuracy
    # always reduce exactly
    grad_wire: str = "f32"
    # ZeRO-1: push gradient shards, update the local 1/nw slice of the
    # optimizer state, pull the parameter shards back
    zero1: bool = False

    def __post_init__(self):
        if self.grad_wire not in ("f32", "bf16", "int8"):
            raise ValueError(
                f"grad_wire must be f32|bf16|int8, got {self.grad_wire!r}")


def init_params(cfg: MLPConfig, generator: torch.Generator) -> list[dict]:
    """He-initialised f32 layers ``[{"w": [fan_in, fan_out], "b": [fan_out]},
    ...]`` from ``generator`` (on the CPU)."""
    params = []
    for fan_in, fan_out in zip(cfg.sizes[:-1], cfg.sizes[1:]):
        w = torch.randn((fan_in, fan_out), generator=generator,
                        dtype=torch.float32)
        params.append({"w": w * math.sqrt(2.0 / fan_in),
                       "b": torch.zeros((fan_out,), dtype=torch.float32)})
    return params


def forward(params, x, cfg: MLPConfig):
    h = x.to(torch.bfloat16) if cfg.half_precision else x
    for layer in params[:-1]:
        h = torch.relu(h @ layer["w"].to(h.dtype) + layer["b"].to(h.dtype))
    last = params[-1]
    logits = h @ last["w"].to(h.dtype) + last["b"].to(h.dtype)
    return logits.to(torch.float32)


def loss_fn(params, x, y, cfg: MLPConfig):
    logits = forward(params, x, cfg)
    return F.cross_entropy(logits, y), logits


def _leaves(params) -> list:
    """The parameter leaves in the reference's flattening order: each
    layer's dict by sorted key, so ``b`` before ``w``."""
    return [layer[k] for layer in params for k in sorted(layer)]


def _unleaves(params, leaves) -> list[dict]:
    it = iter(leaves)
    return [{k: next(it) for k in sorted(layer)} for layer in params]


class Optimizer:
    """sgd, momentum (``optax.sgd(lr, momentum=0.9)``) or adam
    (``optax.adam(lr)``) over lists of tensors, with optax's formulas in
    its order: momentum ``t = g + 0.9·t``; adam ``mu``, ``nu``, ``count``,
    the bias corrections, ``mu_hat / (sqrt(nu_hat + 0) + 1e-8)``; then
    ``p + u·(−lr)``.  ``state`` is ``{}``, ``{"trace": [...]}`` or
    ``{"count": int32 scalar, "mu": [...], "nu": [...]}``."""

    def __init__(self, name: str, lr: float):
        if name not in ("sgd", "momentum", "adam"):
            raise ValueError(f"unknown optimizer {name!r}")
        self.name, self.lr = name, float(lr)

    def init(self, leaves: list) -> dict:
        if self.name == "sgd":
            return {}
        if self.name == "momentum":
            return {"trace": [torch.zeros_like(p) for p in leaves]}
        return {"count": torch.zeros((), dtype=torch.int32,
                                     device=leaves[0].device),
                "mu": [torch.zeros_like(p) for p in leaves],
                "nu": [torch.zeros_like(p) for p in leaves]}

    @torch.no_grad()
    def update(self, grads: list, state: dict, params: list):
        """``(new params, new state)``: one step of the optimizer."""
        if self.name == "sgd":
            u, state = list(grads), state
        elif self.name == "momentum":
            u = torch._foreach_add(list(grads),
                                   torch._foreach_mul(state["trace"], 0.9))
            state = {"trace": u}
        else:
            b1, b2 = 0.9, 0.999
            mu = torch._foreach_add(torch._foreach_mul(list(grads), 1 - b1),
                                    torch._foreach_mul(state["mu"], b1))
            nu = torch._foreach_add(
                torch._foreach_mul(torch._foreach_mul(list(grads),
                                                      list(grads)), 1 - b2),
                torch._foreach_mul(state["nu"], b2))
            count = state["count"] + 1
            c = count.to(torch.float32)
            one = torch.ones((), dtype=torch.float32, device=c.device)
            bc1 = one - torch.full_like(c, b1) ** c
            bc2 = one - torch.full_like(c, b2) ** c
            mu_hat = [m / bc1 for m in mu]
            nu_hat = [v / bc2 for v in nu]
            u = torch._foreach_div(mu_hat, torch._foreach_add(
                torch._foreach_sqrt(nu_hat), 1e-8))
            state = {"count": count, "mu": mu, "nu": nu}
        return torch._foreach_add(list(params),
                                  torch._foreach_mul(u, -self.lr)), state


def make_optimizer(cfg: MLPConfig) -> Optimizer:
    return Optimizer(cfg.optimizer, cfg.lr)


def _loss_and_grads(params, x, y, cfg: MLPConfig, fwd=None):
    """(loss, acc, gradient leaves) of this worker's batch."""
    live = [{k: p.detach().requires_grad_() for k, p in layer.items()}
            for layer in params]
    with torch.enable_grad():
        if fwd is None:
            loss, logits = loss_fn(live, x, y, cfg)
        else:
            logits = fwd(live, x)
            loss = F.cross_entropy(logits, y)
        grads = torch.autograd.grad(loss, _leaves(live))
    acc = (logits.detach().argmax(-1) == y).to(torch.float32).mean()
    return loss.detach(), acc, list(grads)


def _step_body(opt: Optimizer, cfg: MLPConfig, combine):
    """The train step: gradients → ``combine`` (the DP gradient allreduce)
    → the optimizer update."""

    def step(params, opt_state, x, y):
        loss, acc, grads = _loss_and_grads(params, x, y, cfg)
        grads, loss, acc = combine((grads, loss, acc))
        leaves, opt_state = opt.update(grads, opt_state, _leaves(params))
        return _unleaves(params, leaves), opt_state, loss, acc

    return step


def _grad_combine(cfg: MLPConfig):
    """The DP gradient allreduce on the configured wire; loss and accuracy
    always reduce exactly."""
    if cfg.grad_wire == "f32":
        return lambda t: C.allreduce(t, C.Combiner.AVG)
    wire = {"bf16": torch.bfloat16, "int8": torch.int8}[cfg.grad_wire]

    def combine(tree):
        grads, loss, acc = tree
        n = num_workers()
        grads = [g / n for g in C.allreduce_quantized(grads, wire_dtype=wire)]
        loss, acc = C.allreduce((loss, acc), C.Combiner.AVG)
        return grads, loss, acc

    return combine


def param_count(cfg: MLPConfig) -> int:
    return sum(fi * fo + fo for fi, fo in zip(cfg.sizes[:-1], cfg.sizes[1:]))


def zero1_shard_len(cfg: MLPConfig, n_workers: int) -> int:
    """Per-worker slice of the flattened parameter vector (ceil-padded)."""
    return -(-param_count(cfg) // n_workers)


def _flat(leaves: list, pad: int) -> torch.Tensor:
    return F.pad(torch.cat([t.reshape(-1) for t in leaves]), (0, pad))


def _split_like(flat: torch.Tensor, like: list) -> list:
    """``flat``'s leading elements cut into views shaped like ``like``."""
    out, at = [], 0
    for t in like:
        out.append(flat[at:at + t.numel()].view_as(t))
        at += t.numel()
    return out


def _zero1_grad_shard(grads: list, cfg: MLPConfig, nw: int, pad: int):
    """Average-reduce the gradient leaves to this worker's flat [L] slice.

    f32: one exact push (AVG).  bf16: the quantized push.  int8: quantized
    per leaf against one stacked MAX allreduce of the leaves' |max|, the
    int32 push exact, each position dequantized by its leaf's scale."""
    if cfg.grad_wire == "f32":
        return C.push(_flat(grads, pad), C.Combiner.AVG)
    if cfg.grad_wire == "bf16":
        return C.push_quantized(_flat(grads, pad),
                                wire_dtype=torch.bfloat16) / nw
    amax = C.allreduce(torch.stack([g.abs().amax().to(torch.float32)
                                    for g in grads]), C.Combiner.MAX)
    qs, scale_segs = [], []
    for i, g in enumerate(grads):
        q, scale = C.quantize_to_int8(g.reshape(-1), amax[i])
        qs.append(q)
        scale_segs.append(scale.expand(g.numel()))
    total = C.push(_flat(qs, pad).to(torch.int32), C.Combiner.ADD)  # exact
    L = total.shape[0]
    w = worker_id()
    my_scale = _flat(scale_segs, pad)[w * L:(w + 1) * L]
    return total.to(torch.float32) * my_scale / nw


def _zero1_step_body(opt: Optimizer, cfg: MLPConfig, nw: int):
    """ZeRO-1 twin of :func:`_step_body`: ``opt_state`` is this worker's
    slice of the optimizer state over the flat parameter vector."""

    def step(params, opt_state, x, y):
        loss, acc, grads = _loss_and_grads(params, x, y, cfg)
        loss, acc = C.allreduce((loss, acc), C.Combiner.AVG)
        leaves = _leaves(params)
        total = sum(p.numel() for p in leaves)
        L = -(-total // nw)
        pad = nw * L - total
        gsh = _zero1_grad_shard(grads, cfg, nw, pad)              # [L]
        w = worker_id()
        psh = _flat(leaves, pad)[w * L:(w + 1) * L]
        (psh,), opt_state = opt.update([gsh], opt_state, [psh])
        flat = C.pull(psh)                                        # [nw·L]
        return (_unleaves(params, _split_like(flat, leaves)), opt_state,
                loss, acc)

    return step


def _effective_batch(batch_size: int, n: int, n_workers: int) -> int:
    """Batch size used: capped at n, rounded down to a worker multiple,
    at least one sample per worker (shared by fit and load_resident)."""
    return max(n_workers, (min(batch_size, n) // n_workers) * n_workers)


def _batch_reader(x, y, batch_size, order):
    """Stage-1 reader for the ingest pipeline: contiguous views of the
    caller's arrays; the shuffle permutes batch indices (``order``, redrawn
    each epoch by the caller), never rows."""

    def read(j):
        lo = int(order[j]) * batch_size
        return x[lo:lo + batch_size], y[lo:lo + batch_size]

    return read


def _check_params(params: list, sizes) -> None:
    want = [((fi, fo), (fo,)) for fi, fo in zip(sizes[:-1], sizes[1:])]
    got = [(tuple(p["w"].shape), tuple(p["b"].shape)) for p in params]
    if got != want:
        raise ValueError(f"params {got} do not fit sizes {tuple(sizes)}")


class MLPTrainer:
    """The host side (the mapCollective residue for edu.iu.daal_nn).  Runs on
    this worker's card unless ``device`` (or ``mesh``) says otherwise;
    ``state`` (from ``convert.mlp_params_from_numpy``) sets the params and,
    when it has one, the optimizer state."""

    def __init__(self, cfg: MLPConfig | None = None,
                 mesh: WorkerMesh | None = None, seed=0, device=None,
                 state: dict | None = None):
        self.mesh = resolve_mesh(mesh, device)
        self.cfg = cfg or MLPConfig()
        self._opt = make_optimizer(self.cfg)
        dev = self.mesh.device
        _exact_f32(dev)
        if state is None:
            params = init_params(self.cfg, torch.Generator().manual_seed(
                seed))
        else:
            params = state["params"]
        _check_params(params, self.cfg.sizes)
        self.params = [{k: v.to(dev, torch.float32) for k, v in p.items()}
                       for p in params]
        nw = self.mesh.num_workers
        if self.cfg.zero1:
            L = zero1_shard_len(self.cfg, nw)
            self.opt_state = self._opt.init(
                [torch.zeros((L,), dtype=torch.float32, device=dev)])
            self._step = _zero1_step_body(self._opt, self.cfg, nw)
        else:
            self.opt_state = self._opt.init(_leaves(self.params))
            self._step = _step_body(self._opt, self.cfg,
                                    _grad_combine(self.cfg))
        if state is not None and state.get("opt_state") is not None:
            self.opt_state = self._own_state(state["opt_state"])
        self._shuffle_counter = 0
        self._resident = None

    def _own_state(self, given: dict) -> dict:
        """A converted optimizer state laid out as this trainer's: every
        vector leaf's shape checked, and under ZeRO-1 the [nw·L] vectors cut
        to this worker's slice."""
        out = {}
        for key, want in self.opt_state.items():
            if key not in given:
                raise ValueError(f"opt_state lacks {key!r} for "
                                 f"{self.cfg.optimizer}")
            if key == "count":
                out[key] = given[key].to(self.mesh.device, torch.int32)
                continue
            have = [self.mesh.shard_array(v, 0) if self.cfg.zero1
                    else v.to(self.mesh.device) for v in given[key]]
            if [t.shape for t in have] != [t.shape for t in want]:
                shapes = [tuple(t.shape) for t in have]
                raise ValueError(
                    f"opt_state[{key!r}] shapes {shapes} do not fit "
                    f"{[tuple(t.shape) for t in want]}")
            out[key] = have
        return out

    def _shard(self, x, y):
        return (self.mesh.shard_array(np.asarray(x, np.float32), 0),
                self.mesh.shard_array(np.asarray(y, np.int64), 0))

    def train_batch(self, x, y):
        """x: [b, features], y: [b] int labels; b divisible by num_workers."""
        x, y = self._shard(x, y)
        self.params, self.opt_state, loss, acc = self._step(
            self.params, self.opt_state, x, y)
        return float(device_sync(loss)), float(device_sync(acc))

    def load_resident(self, x, y, batch_size=8192, seed=0):
        """Stage the dataset on the device for :meth:`fit_resident`, rows in
        input order; when the batch-divisibility trim must drop rows it
        drops a uniform random subset (``seed``).  Returns the usable
        sample count."""
        n = x.shape[0]
        nw = self.mesh.num_workers
        if n < nw:
            raise ValueError(
                f"need at least {nw} samples (one per worker), got {n}")
        batch_size = _effective_batch(batch_size, n, nw)
        usable = (n // batch_size) * batch_size
        xs_host = np.asarray(x, np.float32)
        ys_host = np.asarray(y, np.int64)
        if usable < n:
            rng = np.random.default_rng(seed)
            keep = np.sort(rng.choice(n, size=usable, replace=False))
            xs_host, ys_host = xs_host[keep], ys_host[keep]
        xs, ys = self._shard(xs_host, ys_host)
        self._resident = (xs, ys, batch_size // nw, usable // batch_size)
        return usable

    def fit_resident(self, epochs=1, seed=0):
        """Train on the :meth:`load_resident`-staged data, the batch order
        redrawn every epoch on the device.  Successive calls advance the
        shuffle seed.  Returns [(last_loss, last_acc)] per epoch, read back
        once."""
        if self._resident is None:
            raise RuntimeError("call load_resident() before fit_resident()")
        xs, ys, bpw, nb = self._resident
        xs_b = xs.view(nb, bpw, -1)
        ys_b = ys.view(nb, bpw)
        gen = torch.Generator(device=self.mesh.device)
        gen.manual_seed(seed + 1 + self._shuffle_counter)
        self._shuffle_counter += epochs
        last = []
        for _ in range(epochs):
            order = torch.randperm(nb, generator=gen, device=self.mesh.device)
            for i in range(nb):
                j = order[i:i + 1]
                self.params, self.opt_state, loss, acc = self._step(
                    self.params, self.opt_state,
                    xs_b.index_select(0, j)[0], ys_b.index_select(0, j)[0])
            last.append(torch.stack([loss, acc]))
        stats = torch.stack(last).cpu().numpy()  # one readback
        return [(float(l), float(a)) for l, a in stats]

    def fit_ckpt(self, x, y, epochs, ckpt_dir=None, *, batch_size=8192,
                 ckpt_every=5, max_restarts=3, fault=None, seed=0):
        """Epoch training with checkpoint/resume (the contract of MF-SGD's
        and LDA's ``fit``): one epoch is one :meth:`fit_resident` epoch, and
        the params, the optimizer state and the shuffle counter are
        checkpointed, so a resumed adam/momentum run continues the same
        trajectory.  Returns [(last_loss, last_acc)] for the epochs this
        call ran."""
        from harp_tpu_torch.utils.fault import (check_restored_shapes,
                                                fit_epochs, to_device)

        self.load_resident(x, y, batch_size=batch_size, seed=seed)
        history: list = []

        def like(template, restored):
            # the restored nest placed as the live one: device and dtype
            if isinstance(template, dict):
                return {k: like(template[k], restored[k]) for k in template}
            if isinstance(template, (list, tuple)):
                return type(template)(like(t, r)
                                      for t, r in zip(template, restored))
            return to_device(restored, template.device, template.dtype)

        def set_state(state):
            # opt_state too: matching params with another optimizer must
            # refuse here, not fail later
            check_restored_shapes([
                ("params", state["params"], self.params),
                ("opt_state", state["opt_state"], self.opt_state)])
            self.params = like(self.params, state["params"])
            self.opt_state = like(self.opt_state, state["opt_state"])
            self._shuffle_counter = int(state["shuffle"])

        fit_epochs(
            lambda: history.append(self.fit_resident(epochs=1, seed=seed)[0]),
            lambda: {"params": self.params, "opt_state": self.opt_state,
                     "shuffle": self._shuffle_counter},
            set_state, epochs, ckpt_dir, ckpt_every=ckpt_every,
            max_restarts=max_restarts, fault=fault, phase="mlp.epochs")
        return history

    def fit(self, x, y, batch_size=8192, epochs=1, shuffle_seed=0,
            prefetch=2):
        """Host-streamed epoch training through the ingest pipeline
        (:class:`~harp_tpu_torch.ingest.IngestPipeline`): batches are
        contiguous views of ``x``/``y``, the per-epoch shuffle permutes
        batch indices, and with ``prefetch >= 2`` batch j+1's cast and copy
        run ahead of batch j's step.  Returns [(loss, acc)] per step."""
        n = x.shape[0]
        nw = self.mesh.num_workers
        if n < nw:
            raise ValueError(
                f"need at least {nw} samples (one per worker), got {n}")
        batch_size = _effective_batch(batch_size, n, nw)
        n_batches = n // batch_size
        x = np.asarray(x)
        y = np.asarray(y)
        rng = np.random.default_rng(shuffle_seed)
        order = np.arange(n_batches)  # re-permuted in place per epoch

        def prep(batch):
            xb, yb = batch
            return np.asarray(xb, np.float32), np.asarray(yb, np.int64)

        # this worker's f32 rows and int64 labels of every batch
        epoch_bytes = n_batches * (batch_size // nw) * (x.shape[1] * 4 + 8)
        history = []
        with IngestPipeline(_batch_reader(x, y, batch_size, order), prep,
                            lambda b: self._shard(*b), depth=max(1, prefetch),
                            tag="mlp.fit") as pipe:
            for e in range(epochs):
                order[:] = rng.permutation(n_batches)
                with flightrec.budget(h2d_bytes=epoch_bytes,
                                      compiles=None if e == 0 else 0,
                                      action="warn", tag="mlp.fit.ingest"):
                    for xb, yb in pipe.stream(n_batches):
                        self.params, self.opt_state, loss, acc = self._step(
                            self.params, self.opt_state, xb, yb)
                        history.append((float(device_sync(loss)),
                                        float(device_sync(acc))))
        return history

    @torch.no_grad()
    def predict(self, x):
        xs = torch.from_numpy(np.asarray(x, np.float32)).to(self.mesh.device)
        return forward(self.params, xs, self.cfg).cpu().numpy()

    def accuracy(self, x, y):
        return float((self.predict(x).argmax(-1) == np.asarray(y)).mean())


# ---- tensor parallelism: the model-group collectives -----------------------

def _all_reduce(x: torch.Tensor, group, size: int) -> torch.Tensor:
    y = x.clone()
    if size > 1:
        dist.all_reduce(y, group=group)
    return y


class _CopyToModel(torch.autograd.Function):
    """f: the identity forward; the backward sums the gradient over the
    model group (each rank holds a partial gradient of a replicated
    input)."""

    @staticmethod
    def forward(ctx, x, group, size):
        ctx.group, ctx.size = group, size
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group, ctx.size), None, None


class _ReduceFromModel(torch.autograd.Function):
    """g: the forward sums the partial products over the model group; the
    backward is the identity."""

    @staticmethod
    def forward(ctx, x, group, size):
        return _all_reduce(x, group, size)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _GatherFromModel(torch.autograd.Function):
    """The forward gathers the model group's column blocks along the last
    dim; the backward keeps this rank's block."""

    @staticmethod
    def forward(ctx, x, group, size, index):
        ctx.size, ctx.index = size, index
        if size == 1:
            return x.clone()
        parts = [torch.empty(x.shape, dtype=x.dtype, device=x.device)
                 for _ in range(size)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=-1)

    @staticmethod
    def backward(ctx, g):
        return (g.chunk(ctx.size, dim=-1)[ctx.index].contiguous(), None,
                None, None)


def _default_mesh(cfg: MLPConfig, device) -> Mesh2D:
    """The largest model axis that divides every sharded layer dim (the
    output dim of even layers, the input dim of odd ones) and the worker
    count, the rest data."""
    sizes = cfg.sizes
    sharded_dims = [sizes[i + 1] if i % 2 == 0 else sizes[i]
                    for i in range(len(sizes) - 1)]
    g = math.gcd(*sharded_dims)
    n_dev = num_workers()
    n_model = max(d for d in range(1, min(g, n_dev) + 1)
                  if g % d == 0 and n_dev % d == 0)
    return mesh_2d(n_dev // n_model, n_model, device)


class TPMLPTrainer:
    """Tensor-parallel MLP on a 2-D (data × model) layout (module doc):
    the same global loss and gradients as the DP trainer."""

    def __init__(self, cfg: MLPConfig | None = None,
                 mesh: Mesh2D | None = None, seed=0, device=None,
                 state: dict | None = None):
        self.cfg = cfg or MLPConfig()
        if self.cfg.zero1:
            raise ValueError(
                "zero1 is DP-only: the TP trainer's optimizer state follows "
                "its parameter shards; replicating it would break the memory "
                "contract zero1 promises")
        if self.cfg.grad_wire != "f32":
            raise ValueError(
                f"grad_wire={self.cfg.grad_wire!r} is DP-only: use "
                "MLPTrainer for a quantized gradient wire")
        self.mesh = mesh if mesh is not None else _default_mesh(self.cfg,
                                                                device)
        if self.mesh.data_index is None:
            raise ValueError(f"worker {worker_id()} is outside the "
                             f"{self.mesh.n_data}x{self.mesh.n_model} mesh")
        n_model = self.mesh.n_model
        self._n_data = self.mesh.n_data
        sizes = self.cfg.sizes
        for i, (fan_in, fan_out) in enumerate(zip(sizes[:-1], sizes[1:])):
            sharded_dim = fan_out if i % 2 == 0 else fan_in
            if sharded_dim % n_model != 0:
                raise ValueError(
                    f"TP needs layer {i}'s "
                    f"{'output' if i % 2 == 0 else 'input'} dim "
                    f"({sharded_dim}) divisible by the model axis "
                    f"({n_model}); adjust MLPConfig.sizes or the mesh")
        self._opt = make_optimizer(self.cfg)
        dev = self.mesh.device
        _exact_f32(dev)
        params = (init_params(self.cfg, torch.Generator().manual_seed(seed))
                  if state is None else state["params"])
        _check_params(params, sizes)
        j = self.mesh.model_index
        self.params = []
        for i, layer in enumerate(params):
            w, b = layer["w"], layer["b"]
            if i % 2 == 0:  # column-parallel: the output dim
                w, b = w.chunk(n_model, 1)[j], b.chunk(n_model, 0)[j]
            else:           # row-parallel: the input dim
                w = w.chunk(n_model, 0)[j]
            self.params.append({"w": w.to(dev, torch.float32).contiguous(),
                                "b": b.to(dev, torch.float32).contiguous()})
        self.opt_state = self._opt.init(_leaves(self.params))

    def _forward(self, params, x):
        m = self.mesh
        h = x.to(torch.bfloat16) if self.cfg.half_precision else x
        last = len(params) - 1
        for i, layer in enumerate(params):
            w, b = layer["w"].to(h.dtype), layer["b"].to(h.dtype)
            if i % 2 == 0:
                h = _CopyToModel.apply(h, m.model_group, m.n_model) @ w + b
            else:
                h = _ReduceFromModel.apply(h @ w, m.model_group,
                                           m.n_model) + b
            if i < last:
                h = torch.relu(h)
        if last % 2 == 0:  # the logits are split over the model group
            h = _GatherFromModel.apply(h, m.model_group, m.n_model,
                                       m.model_index)
        return h.to(torch.float32)

    def train_batch(self, x, y):
        """x: [b, features], y: [b]; b must be divisible by the data axis."""
        if len(x) % self._n_data != 0:
            raise ValueError(
                f"batch size {len(x)} not divisible by the data axis "
                f"({self._n_data}); round the batch like MLPTrainer.fit does")
        rows = len(x) // self._n_data
        lo = self.mesh.data_index * rows
        dev = self.mesh.device
        xb = torch.from_numpy(np.asarray(x[lo:lo + rows], np.float32)).to(dev)
        yb = torch.from_numpy(np.asarray(y[lo:lo + rows], np.int64)).to(dev)
        loss, acc, grads = _loss_and_grads(self.params, xb, yb, self.cfg,
                                           self._forward)
        # one data-group average of every gradient, the loss and the acc
        flat = _all_reduce(torch.cat([g.reshape(-1) for g in grads]
                                     + [loss.reshape(1), acc.reshape(1)]),
                           self.mesh.data_group, self._n_data) / self._n_data
        leaves, self.opt_state = self._opt.update(
            _split_like(flat, grads), self.opt_state, _leaves(self.params))
        self.params = _unleaves(self.params, leaves)
        return float(flat[-2]), float(flat[-1])

    def full_params(self) -> list[dict]:
        """The whole parameters as numpy arrays, gathered over the model
        group (every rank of the group calls it)."""
        m = self.mesh
        out = []
        for i, layer in enumerate(self.params):
            if i % 2 == 0:
                w = _GatherFromModel.apply(layer["w"], m.model_group,
                                           m.n_model, m.model_index)
                b = _GatherFromModel.apply(layer["b"], m.model_group,
                                           m.n_model, m.model_index)
            else:
                w = _GatherFromModel.apply(layer["w"].T, m.model_group,
                                           m.n_model, m.model_index).T
                b = layer["b"]
            out.append({"w": w.cpu().numpy(), "b": b.cpu().numpy()})
        return out


def synthetic_mnist(n=60_000, d=784, classes=10, seed=0, noise=0.8):
    """MNIST-shaped synthetic task: class prototype plus noise, so a real
    decision boundary exists (the reference's generator)."""
    rng = np.random.default_rng(seed)
    protos = rng.normal(size=(classes, d)).astype(np.float32)
    y = rng.integers(0, classes, n).astype(np.int32)
    x = 0.5 * protos[y] + rng.normal(size=(n, d)).astype(np.float32) * noise
    return x, y


def benchmark(n=60_000, batch=8192, steps=50, mesh=None, cfg=None,
              device=None):
    """Samples per second through the DP training step at MNIST shapes.

    The headline times :meth:`MLPTrainer.fit_resident` (the data staged on
    the device once); ``samples_per_sec_hostloop`` times ``steps`` calls of
    the step on one staged batch.  The same windows as the reference's."""
    mesh = resolve_mesh(mesh, device)
    cfg = cfg or MLPConfig()
    trainer = MLPTrainer(cfg, mesh)
    x, y = synthetic_mnist(n=max(n, batch), d=cfg.sizes[0],
                           classes=cfg.sizes[-1])
    xb, yb = trainer._shard(x[:batch], y[:batch])

    trainer.train_batch(x[:batch], y[:batch])  # warm-up
    t0 = time.perf_counter()
    for _ in range(steps):
        trainer.params, trainer.opt_state, loss, acc = trainer._step(
            trainer.params, trainer.opt_state, xb, yb)
    device_sync(loss)
    dt_host = time.perf_counter() - t0

    usable = trainer.load_resident(x, y, batch_size=batch)
    epochs = max(8, (steps * batch) // usable) * 8
    trainer.fit_resident(epochs=epochs)  # warm with the same epoch count
    t0 = time.perf_counter()
    hist = trainer.fit_resident(epochs=epochs)
    dt_res = time.perf_counter() - t0
    return {
        "samples_per_sec": usable * epochs / dt_res,
        "samples_per_sec_hostloop": batch * steps / dt_host,
        "steps_per_sec": usable * epochs / batch / dt_res,
        "loss": hist[-1][0],
        "acc": hist[-1][1],
        "train_acc": hist[-1][1],
        "grad_wire": cfg.grad_wire,
        "batch": batch,
        "num_workers": mesh.num_workers,
        "half_precision": cfg.half_precision,
    }


def main(argv=None):
    import argparse

    from harp_tpu_torch.utils.metrics import benchmark_json

    p = argparse.ArgumentParser(
        description="harp-tpu MLP on PyTorch (edu.iu.daal_nn parity)")
    p.add_argument("--n", type=int, default=60_000,
                   help="synthetic MNIST samples")
    p.add_argument("--batch", type=int, default=8192)
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--optimizer", default="sgd")
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--train", action="store_true",
                   help="2-epoch training demo")
    p.add_argument("--device", default=None,
                   help="torch device (default: this worker's card; 'cpu' "
                        "runs on the CPU)")
    args = p.parse_args(argv)
    cfg = MLPConfig(optimizer=args.optimizer, half_precision=args.bf16)
    mesh = WorkerMesh(args.device)
    if args.train:
        x, y = synthetic_mnist(n=args.n)
        tr = MLPTrainer(cfg, mesh)
        hist = tr.fit(x, y, batch_size=args.batch, epochs=2)
        print(benchmark_json("mlp_fit_cli", {
            "first_loss": float(hist[0][0]), "last_loss": float(hist[-1][0]),
            "train_acc": float(tr.accuracy(x[:10000], y[:10000]))},
            mesh.device))
    else:
        print(benchmark_json("mlp_cli", benchmark(
            n=args.n, batch=args.batch, steps=args.steps, cfg=cfg,
            mesh=mesh),
            mesh.device))
    return 0


if __name__ == "__main__":
    main()
