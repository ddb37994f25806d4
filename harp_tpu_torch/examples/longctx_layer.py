"""Runnable long-context transformer layer — the sequence-parallel stack,
the port of the reference's ``examples/longctx_layer.py``.

Sequence-sharded activations, shard-local RoPE
(:mod:`harp_tpu_torch.ops.rope`), windowed causal GQA ring attention
(:mod:`harp_tpu_torch.ops.ring_attention`), the output projection, a
teacher-student MSE, and a data-parallel gradient allreduce through the
same ``allreduce`` verb every app uses: training steps of a transformer
attention layer whose sequence need not fit on one card.  Each worker
(process) holds its block of the sequence; with no process group it is
one worker holding all of it.

Run:  python -m harp_tpu_torch.examples.longctx_layer [--device cpu]
          [--seq 512] [--heads 8] [--kv-heads 2] [--dim 16] [--window 64]
          [--steps 10]

Mistral-7B-v0.1's attention block is ``--heads 32 --kv-heads 8 --dim 128
--window 4096`` (model width 4096).  Without ``--device cpu`` it runs on
this worker's card and raises where there is none.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from harp_tpu_torch.convert import longctx_params_from_numpy
from harp_tpu_torch.ops.ring_attention import ring_attention
from harp_tpu_torch.ops.rope import apply_rope
from harp_tpu_torch.parallel import collective as C
from harp_tpu_torch.parallel.collective import Combiner
from harp_tpu_torch.parallel.mesh import WorkerMesh, is_master


def init_arrays(seq: int, heads: int, kv_heads: int, dim: int,
                seed: int = 0) -> tuple[dict, np.ndarray, dict]:
    """(params, x, teacher) as numpy, drawn in the reference's order from
    ``default_rng(seed)``: the student weights, the [1, seq, heads·dim]
    input, then the teacher weights."""
    h, g, d = heads, kv_heads, dim
    model_d = h * d
    rng = np.random.default_rng(seed)
    params = {
        "wq": rng.normal(size=(model_d, h * d)).astype(np.float32) * 0.05,
        "wk": rng.normal(size=(model_d, g * d)).astype(np.float32) * 0.05,
        "wv": rng.normal(size=(model_d, g * d)).astype(np.float32) * 0.05,
        "wo": rng.normal(size=(h * d, model_d)).astype(np.float32) * 0.05,
    }
    x = rng.normal(size=(1, seq, model_d)).astype(np.float32)
    # teacher-student: the target is the same layer under other weights, so
    # the regression is realizable and the loss visibly descends
    teacher = {k: rng.normal(size=v.shape).astype(np.float32) * 0.05
               for k, v in params.items()}
    return params, x, teacher


def layer(params: dict, x: torch.Tensor, *, heads: int, kv_heads: int,
          dim: int, window: int | None) -> torch.Tensor:
    """The attention layer on this worker's [b, s_local, model_d] shard."""
    b, s, _ = x.shape
    h, g, d = heads, kv_heads, dim
    q = apply_rope((x @ params["wq"]).reshape(b, s, h, d))
    k = apply_rope((x @ params["wk"]).reshape(b, s, g, d))
    v = (x @ params["wv"]).reshape(b, s, g, d)
    o = ring_attention(q, k, v, causal=True, window=window)
    return o.reshape(b, s, h * d) @ params["wo"]


def train_step(params: dict, x: torch.Tensor, y: torch.Tensor, **shape
               ) -> tuple[dict, torch.Tensor]:
    """One step ``p - 2.0 · g``: the MSE on this worker's shard, its
    gradient (through the ring), and one allreduce (AVG) of the gradients
    and the loss, so every worker applies the same update."""
    p = {k: t.detach().requires_grad_() for k, t in params.items()}
    loss = ((layer(p, x, **shape) - y) ** 2).mean()
    loss.backward()
    grads = {k: t.grad for k, t in p.items()}
    grads, loss = C.allreduce((grads, loss.detach()), Combiner.AVG)
    return {k: params[k] - 2.0 * grads[k] for k in params}, loss


def run(seq: int = 512, heads: int = 8, kv_heads: int = 2, dim: int = 16,
        window: int | None = 64, steps: int = 10, *,
        mesh: WorkerMesh | None = None) -> tuple[list[float], dict]:
    """``steps`` training steps from :func:`init_arrays`: returns the losses
    and the final parameters (tensors on the mesh's device)."""
    mesh = mesh or WorkerMesh()
    params, x, teacher = init_arrays(seq, heads, kv_heads, dim)
    shape = {"heads": heads, "kv_heads": kv_heads, "dim": dim,
             "window": window}
    params = longctx_params_from_numpy(params, mesh.device)
    teacher = longctx_params_from_numpy(teacher, mesh.device)
    xs = mesh.shard_array(x, 1)                 # shard the sequence dim
    with torch.no_grad():
        target = layer(teacher, xs, **shape)
    losses = []
    for _ in range(steps):
        params, loss = train_step(params, xs, target, **shape)
        losses.append(float(loss))
    return losses, params


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default=None,
                   help="torch device (default: this worker's card; 'cpu' "
                        "runs on the CPU)")
    p.add_argument("--seq", type=int, default=512)
    p.add_argument("--heads", type=int, default=8)
    p.add_argument("--kv-heads", type=int, default=2)
    p.add_argument("--dim", type=int, default=16)
    p.add_argument("--window", type=int, default=64)
    p.add_argument("--steps", type=int, default=10)
    args = p.parse_args(argv)
    if args.steps < 1:
        p.error("--steps must be >= 1")
    mesh = WorkerMesh(args.device)
    h, g = args.heads, args.kv_heads
    losses, _ = run(args.seq, h, g, args.dim, args.window, args.steps,
                    mesh=mesh)
    out = {"workers": mesh.num_workers, "seq": args.seq,
           "heads": f"{h}q/{g}kv", "window": args.window,
           "loss_first": round(losses[0], 5),
           "loss_final": round(losses[-1], 5)}
    if is_master():
        print(out)
    return out


if __name__ == "__main__":
    main()
