"""Runnable pipeline-parallel + expert-parallel training demo — the port of
the reference's ``examples/pipeline_moe_app.py``.

Composes the two parallelism strategies Harp lacked the way a Harp app
composes verbs:

1. GPipe pipeline: each worker owns ONE stage of a deep tanh-MLP;
   microbatches enter at stage 0 and activations hop the worker ring
   (``rotate``) — :func:`~harp_tpu_torch.parallel.pipeline.
   pipeline_loss_and_grads` differentiates through the hops, so plain SGD
   on each worker's stage trains the whole stack.  The loss must descend.
2. Switch MoE layer: the same workers, one expert each, tokens routed by
   a gating argmax through ONE ``regroup`` (all-to-all) each way —
   checked against the dense host reference at the reference's rtol 2e-4
   / atol 2e-5.

Every weight is drawn with numpy from ``default_rng(0)`` in the
reference's order.  One worker is one stage and one expert.

Run:  python -m harp_tpu_torch.examples.pipeline_moe_app [--device cpu]
          [--steps 20] [--width 16] [--microbatches 4] [--lr 0.2]

Without ``--device cpu`` it runs on this worker's card and raises where
there is none.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from harp_tpu_torch import WorkerMesh
from harp_tpu_torch.ops.moe import moe_ffn, reference_moe
from harp_tpu_torch.parallel import collective as C
from harp_tpu_torch.parallel.mesh import is_master
from harp_tpu_torch.parallel.pipeline import pipeline_loss_and_grads


def stage_fn(params: dict, h: torch.Tensor) -> torch.Tensor:
    return torch.tanh(h @ params["w"] + params["b"])


def loss_fn(outs: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    return ((outs - targets) ** 2).mean()


def run(steps: int = 20, width: int = 16, microbatches: int = 4,
        lr: float = 0.2, *, mesh: WorkerMesh | None = None) -> dict:
    """Both parts; returns the pipeline's losses, the MoE's largest
    difference from the host reference and its dropped tokens.  Raises
    AssertionError where the loss does not descend or the MoE disagrees."""
    mesh = mesh or WorkerMesh()
    nw, me, dev = mesh.num_workers, mesh.rank, mesh.device
    w = width
    rng = np.random.default_rng(0)

    # --- 1. GPipe pipeline training over the worker ring ---
    params = {
        "w": (rng.normal(size=(nw, w, w)) * 0.5).astype(np.float32),
        "b": np.zeros((nw, w), np.float32),
    }
    # teacher-student: targets from the same stack under other weights,
    # so the regression is realizable and the loss visibly descends
    teacher = {
        "w": (rng.normal(size=(nw, w, w)) * 0.5).astype(np.float32),
        "b": (rng.normal(size=(nw, w)) * 0.1).astype(np.float32),
    }
    x = rng.normal(size=(microbatches, 8, w)).astype(np.float32)
    tgt = np.asarray(x)
    for s in range(nw):
        tgt = np.tanh(tgt @ teacher["w"][s] + teacher["b"][s])

    stage = {k: torch.from_numpy(a[me].copy()).to(dev)
             for k, a in params.items()}
    xs, ts = torch.from_numpy(x).to(dev), torch.from_numpy(tgt).to(dev)
    losses = []
    for _ in range(steps):
        loss, grads = pipeline_loss_and_grads(stage_fn, loss_fn, stage, xs,
                                              ts, mesh=mesh)
        # each worker updates ITS stage
        stage = {k: stage[k] - lr * grads[k] for k in stage}
        losses.append(float(loss))
    if is_master():
        print(f"pipeline[{nw} stages x {microbatches} microbatches] "
              f"loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    assert losses[-1] < losses[0], "pipeline training must descend"

    # --- 2. Switch MoE layer through the regroup dispatch ---
    d, hdim, cap = w, 2 * w, 8
    moe_w = {
        "gate": rng.normal(size=(d, nw)).astype(np.float32),
        "w1": (rng.normal(size=(nw, d, hdim)) * 0.5).astype(np.float32),
        "b1": np.zeros((nw, hdim), np.float32),
        "w2": (rng.normal(size=(nw, hdim, d)) * 0.5).astype(np.float32),
        "b2": np.zeros((nw, d), np.float32),
    }
    tokens = rng.normal(size=(nw * cap, d)).astype(np.float32)
    mine = {k: torch.from_numpy(np.ascontiguousarray(a[me])).to(dev)
            for k, a in moe_w.items() if k != "gate"}
    y, dropped = moe_ffn(mesh.shard_array(tokens, 0),
                         mesh.replicated(moe_w["gate"]), mine["w1"],
                         mine["b1"], mine["w2"], mine["b2"], capacity=cap)
    y = C.allgather(y).cpu().numpy()
    ref = reference_moe(tokens, moe_w["gate"], moe_w["w1"], moe_w["b1"],
                        moe_w["w2"], moe_w["b2"], cap, nw)
    np.testing.assert_allclose(y, ref, rtol=2e-4, atol=2e-5)
    dropped = int(dropped)
    if is_master():
        print(f"moe[{nw} experts, capacity {cap}] == dense reference "
              f"(dropped={dropped})")
    return {"workers": nw, "losses": losses,
            "moe_max_abs_err": float(np.abs(y - ref).max()),
            "dropped": dropped}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default=None,
                   help="torch device (default: this worker's card; 'cpu' "
                        "runs on the CPU)")
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--width", type=int, default=16)
    p.add_argument("--microbatches", type=int, default=4)
    p.add_argument("--lr", type=float, default=0.2)
    args = p.parse_args(argv)
    if args.steps < 2:
        p.error("--steps must be >= 2 (the descent check compares "
                "first and last step)")
    out = run(args.steps, args.width, args.microbatches, args.lr,
              mesh=WorkerMesh(args.device))
    return {"workers": out["workers"], "loss_first": out["losses"][0],
            "loss_final": out["losses"][-1],
            "moe_max_abs_err": out["moe_max_abs_err"],
            "dropped": out["dropped"]}


if __name__ == "__main__":
    main()
