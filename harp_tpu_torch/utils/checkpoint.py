"""Checkpoint / resume: the port of ``harp_tpu.utils.checkpoint``.

Harp has no checkpoint API of its own: its apps write model tables to HDFS
every k iterations, and a failed YARN task restarts the job from the last
dump.  :class:`CheckpointManager` is that dump as a framework utility: a
state (a dict/list/tuple nest of tensors, numpy arrays and Python scalars)
and its step, in atomic directories, keeping the last ``keep``, with a
``latest_step``/``restore`` pair for a driver's ``--resume``.

**Crash-atomic writes.**  :meth:`CheckpointManager.save` writes into
``tmp.<step>`` and renames it to ``step_<step>`` only once the write is
complete; every reader ignores ``tmp.*``.  Just before the rename the save
calls :func:`harp_tpu_torch.utils.fault.notify_ckpt_write`, the fault
plane's ``ckpt_write`` site: a fault injected there is a crash after the
bytes landed and before they count, so it leaves a ``tmp.*`` directory and
the earlier steps untouched.  Against a checkpoint damaged by other means
(a truncated copy), :meth:`restore_latest` (and :meth:`restore` with
``step=None``) falls back step by step to the newest one that restores.

**On-disk format (the port's own).**  The reference stores through orbax,
a JAX library; the port does not, and a reference checkpoint does not
restore here.  ``step_<step>/`` holds, for every worker rank ``r``,
``rank_<r>.npz`` (the state's arrays, written by numpy and read with
``allow_pickle=False``) and ``rank_<r>.json`` (the nest: dicts, lists,
tuples, Python scalars and ``None``, with each array's place).  Nothing is
unpickled.  Restored arrays come back as numpy arrays (bfloat16 ones as
CPU tensors, which numpy lacks).

**Workers.**  The port runs one process a worker, and each worker saves
its own state (its shards of a sharded model; replicated state is saved by
every worker).  All write into the same ``tmp.<step>``; after a barrier
rank 0 renames and prunes, and a second barrier releases the group.  On
restore every worker reads its own file, and the workers agree on success
(one gather of a flag) so that they fall back together.  A checkpoint
restores only on the world size that wrote it.
"""

from __future__ import annotations

import json
import os
import shutil
import warnings
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from harp_tpu_torch.utils import fault


def _world() -> tuple[int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _barrier() -> None:
    if _world()[1] > 1:
        dist.barrier()


def _all_ok(ok: bool) -> bool:
    """True when every worker's ``ok`` is."""
    if _world()[1] == 1:
        return ok
    flags: list = [None] * _world()[1]
    dist.all_gather_object(flags, bool(ok))
    return all(flags)


def _flatten(tree: Any, arrays: list) -> Any:
    """The JSON record of ``tree``; its arrays appended to ``arrays``."""
    if isinstance(tree, dict):
        if not all(isinstance(k, str) for k in tree):
            raise TypeError("checkpoint dict keys must be strings")
        return {"dict": {k: _flatten(v, arrays) for k, v in tree.items()}}
    if isinstance(tree, (list, tuple)):
        kind = "list" if isinstance(tree, list) else "tuple"
        return {kind: [_flatten(v, arrays) for v in tree]}
    if tree is None or isinstance(tree, (bool, int, float, str)):
        return {"py": tree}
    if isinstance(tree, torch.Tensor):
        t = tree.detach().cpu()
        if t.dtype == torch.bfloat16:
            arrays.append(t.view(torch.int16).numpy())
            return {"array": len(arrays) - 1, "bf16": True}
        arrays.append(t.numpy())
        return {"array": len(arrays) - 1}
    arrays.append(np.asarray(tree))
    if arrays[-1].dtype == object:
        raise TypeError(f"cannot checkpoint a {type(tree).__name__}")
    return {"array": len(arrays) - 1}


def _unflatten(rec: dict, arrays) -> Any:
    if "dict" in rec:
        return {k: _unflatten(v, arrays) for k, v in rec["dict"].items()}
    if "list" in rec:
        return [_unflatten(v, arrays) for v in rec["list"]]
    if "tuple" in rec:
        return tuple(_unflatten(v, arrays) for v in rec["tuple"])
    if "py" in rec:
        return rec["py"]
    a = arrays[f"a{rec['array']}"]
    if rec.get("bf16"):
        return torch.from_numpy(a.copy()).view(torch.bfloat16)
    return a


class CheckpointManager:
    """Save/restore a state nest and its step under ``root``."""

    def __init__(self, root: str, keep: int = 3):
        self.root = os.path.abspath(root)
        self.keep = keep
        os.makedirs(self.root, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.root, f"step_{step:012d}")

    def _tmp_path(self, step: int) -> str:
        return os.path.join(self.root, f"tmp.{step:012d}")

    def steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.root):
            if name.startswith("step_"):
                try:
                    out.append(int(name.split("_")[1]))
                except (IndexError, ValueError):
                    continue
        return sorted(out)

    def latest_step(self) -> int | None:
        s = self.steps()
        return s[-1] if s else None

    def save(self, step: int, state: Any) -> str:
        """Write ``state`` for ``step`` and prune all but the newest
        ``keep``; returns the step's directory.

        Crash-atomic: the files land in ``tmp.<step>`` and only a complete
        write is renamed to ``step_<step>`` (one directory-entry swap), so
        a kill at any point leaves the earlier set intact, plus at most an
        ignored ``tmp.*`` (cleared by the next save of that step)."""
        rank, world = _world()
        final, tmp = self._path(step), self._tmp_path(step)
        if rank == 0:
            shutil.rmtree(tmp, ignore_errors=True)  # from a crashed save
            os.makedirs(tmp)
        _barrier()
        arrays: list = []
        tree = _flatten(state, arrays)
        base = os.path.join(tmp, f"rank_{rank:05d}")
        with open(base + ".npz", "wb") as f:
            np.savez(f, **{f"a{i}": a for i, a in enumerate(arrays)})
        with open(base + ".json", "w") as f:
            json.dump({"step": step, "world": world, "tree": tree}, f)
        # the fault plane's ckpt_write site: the bytes are down, the rename
        # that makes them count is not
        fault.notify_ckpt_write(final)
        _barrier()
        if rank == 0:
            if os.path.exists(final):  # a re-save of the step replaces it
                shutil.rmtree(final, ignore_errors=True)
            os.rename(tmp, final)
            for old in self.steps()[: -self.keep] if self.keep else []:
                shutil.rmtree(self._path(old), ignore_errors=True)
        _barrier()
        return final

    def restore_latest(self) -> tuple[int, Any]:
        """(newest restorable step, state), the entry of every resume.  A
        damaged step (truncated or missing files) is skipped with a
        warning and the step before it restores instead.  Raises
        FileNotFoundError when no step under the root restores."""
        steps = self.steps()
        if not steps:
            raise FileNotFoundError(f"no checkpoints under {self.root}")
        last_err: Exception | None = None
        for step in reversed(steps):
            try:
                got, err = self._read_step(step), None
            except Exception as e:  # noqa: BLE001 - fall back, loudly
                got, err = None, e
            if _all_ok(err is None):
                return got
            last_err = err or RuntimeError("another worker's file is damaged")
            warnings.warn(
                f"checkpoint {self._path(step)} failed to restore "
                f"({type(last_err).__name__}: {last_err}); falling back to "
                "the previous step", RuntimeWarning, stacklevel=2)
        raise FileNotFoundError(
            f"no restorable checkpoint under {self.root} "
            f"(newest error: {last_err})")

    def restore(self, step: int | None = None) -> tuple[int, Any]:
        """Restore (step, state); the latest restorable if step is None."""
        if step is None:
            return self.restore_latest()
        return self._read_step(step)

    def _read_step(self, step: int) -> tuple[int, Any]:
        rank, world = _world()
        base = os.path.join(self._path(step), f"rank_{rank:05d}")
        with open(base + ".json") as f:
            meta = json.load(f)
        if meta.get("world") != world:
            raise ValueError(
                f"{self._path(step)} was written by {meta.get('world')} "
                f"workers, not {world}")
        with np.load(base + ".npz", allow_pickle=False) as arrays:
            state = _unflatten(meta["tree"], arrays)
        return step, state
