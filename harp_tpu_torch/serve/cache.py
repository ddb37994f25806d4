"""The compiled-graph cache: each rung's step captured once at startup —
the port of ``harp_tpu.serve.cache``.

The reference persists AOT-compiled XLA executables, so a warm restart
compiles nothing.  Here a rung's step is captured once at startup as a
CUDA graph (:class:`RungExecutable`), and a batch is one replay: the
reference's "one dispatch of a cached executable".  A CUDA graph cannot
outlive its process, so what the disk keeps (:class:`GraphCache`) is each
key's record: its code fingerprint and the capture's footprint.  A warm
restart therefore builds no kernel, hits the cache once a rung and
captures exactly one graph a rung; the steady state captures nothing.  On
the CPU the step runs eagerly and nothing is captured.

**Buffer sets.**  A captured graph reads and writes fixed buffers, and the
continuous plane keeps ``depth`` batches in flight (it dispatches batch
t+1 before it reads batch t back).  So a rung holds ``depth`` buffer sets:
a pinned host staging buffer each (the H2D of a batch runs from it without
blocking the host) and a device output each.  A dispatch replays the
rung's one graph, which reads its static input and writes its static
output, then copies that output into the slot's buffer, so batch t's
answer survives batch t+1's replay until it is read back.  Staging waits
for the slot's previous H2D before it rewrites the slot's host buffer.

**A collective inside a step.**  On more than one worker the MF-SGD
top-k step gathers candidates across the group.  A capture keeps the
collective out: the parts before and after it are two graphs, and the
gather runs between their replays; the whole is still one tracked
dispatch.  On one worker the gather is a copy and the step is one graph.

Keys bind a record to everything that could invalidate it: the torch and
CUDA versions, the device's name and the world size, every input's shape
and dtype (the rung's included), the engine's ``cache_tag`` (options baked
into the step), and a code fingerprint over the serve package, the
parallel layer and the engine's model module.  Records are written by an
atomic rename; a corrupt record warns and counts as a miss.
"""

from __future__ import annotations

import hashlib
import json
import os
import warnings
from typing import Callable

import numpy as np
import torch

from harp_tpu_torch.parallel.mesh import num_workers


def code_fingerprint(extra_modules: tuple = ()) -> str:
    """sha1 over the serve package's sources, the parallel layer and any
    engine model modules: a changed step must miss."""
    import harp_tpu_torch.parallel.collective as _coll
    import harp_tpu_torch.parallel.mesh as _mesh
    import harp_tpu_torch.serve as pkg

    h = hashlib.sha1()
    paths = []
    pkg_dir = os.path.dirname(os.path.abspath(pkg.__file__))
    for fn in sorted(os.listdir(pkg_dir)):
        if fn.endswith(".py"):
            paths.append(os.path.join(pkg_dir, fn))
    for mod in (_coll, _mesh) + tuple(extra_modules):
        f = getattr(mod, "__file__", None)
        if f and f.endswith(".py"):
            paths.append(f)
    for p in paths:
        with open(p, "rb") as fh:
            h.update(fh.read())
    return h.hexdigest()[:16]


def _device_tag(device: torch.device) -> str:
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    return f"{device.type}:{name}:{num_workers()}"


def _sig(tensors) -> str:
    return ";".join(f"{tuple(t.shape)}/{t.dtype}" for t in tensors)


def cuda_capture(fn: Callable[[], object], label: str):
    """The card's capture: ``(replay, out)`` from
    :func:`harp_tpu_torch.utils.timing.capture_graph`; ``replay.pool_bytes``
    is the graph pool the capture reserved."""
    from harp_tpu_torch.utils.timing import capture_graph

    graph, out = capture_graph(fn, label=label)

    def replay():
        graph.replay()

    replay.pool_bytes = graph.pool_bytes
    return replay, out


def default_capture(device: torch.device):
    """The card captures; the CPU runs the step eagerly (None)."""
    return cuda_capture if device.type == "cuda" else None


def _nbytes(tree) -> int:
    from harp_tpu_torch.utils.telemetry import tree_leaves

    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def _empty_like(tree):
    if isinstance(tree, (tuple, list)):
        return type(tree)(_empty_like(t) for t in tree)
    return torch.empty_like(tree)


def _copy_into(dst, src) -> None:
    if isinstance(dst, (tuple, list)):
        for d, s in zip(dst, src):
            _copy_into(d, s)
    else:
        dst.copy_(src)


class Staged:
    """A staged batch: the slot whose host buffer it went through, and
    its bytes (the memory ledger's view of the consumed input)."""

    __slots__ = ("slot", "nbytes")

    def __init__(self, slot: int, nbytes: int):
        self.slot = slot
        self.nbytes = nbytes


class RungExecutable:
    """One ladder rung's step with ``depth`` buffer sets (module
    docstring).  ``capture(fn, label) -> (replay, out)`` captures ``fn``
    (``out`` is what its call returned, rewritten by every ``replay()``);
    None runs the step eagerly.

    :meth:`stage` puts a padded host batch into the rung's static input
    through a free slot; calling the executable with the state and that
    token runs the step and returns the slot's output; :meth:`release`
    frees the slot once its output was read back."""

    def __init__(self, engine, rung: int, depth: int,
                 capture: Callable | None = None, label: str = "serve"):
        if depth < 1:
            raise ValueError(f"buffer sets {depth} must be >= 1")
        self.engine, self.rung, self.depth = engine, rung, int(depth)
        self.captured = capture is not None
        dev = engine.mesh.device
        state = engine.state_args()
        shape, dtype = engine.input_shape(rung), engine.input_torch_dtype()
        self.x = torch.zeros(shape, dtype=dtype, device=dev)
        self._host = ([torch.zeros(shape, dtype=dtype).pin_memory()
                       for _ in range(self.depth)] if dev.type == "cuda"
                      else [None] * self.depth)
        self._h2d_done: list = [None] * self.depth
        self._busy = [False] * self.depth
        self.signature = _sig(tuple(state) + (self.x,))
        self.argument_bytes = _nbytes(tuple(state) + (self.x,))
        split = engine.split_step() if num_workers() > 1 else None
        #: graphs this rung captured (0 eager, 2 with a collective split)
        self.graphs = 0 if capture is None else (1 if split is None else 2)
        if capture is None:
            step = engine.step()
            self._run = lambda: step(*state, self.x)
            self._out = None
        elif split is None:
            step = engine.step()
            replay, self._out = capture(lambda: step(*state, self.x),
                                        f"{label}.b{rung}")
            self._run = replay
            replays = [replay]
        else:
            # the collective stays out of the capture: two graphs, the
            # gather replayed eagerly between them into static buffers
            local, gather, merge = split
            replay_a, part = capture(lambda: local(*state, self.x),
                                     f"{label}.b{rung}.local")
            gathered = gather(part)
            replay_b, self._out = capture(lambda: merge(gathered),
                                          f"{label}.b{rung}.merge")
            replays = [replay_a, replay_b]

            def run():
                replay_a()
                _copy_into(gathered, gather(part))
                replay_b()

            self._run = run
        # the captures' graph pools, less the static output that lives there
        self.temp_bytes = (sum(getattr(r, "pool_bytes", 0) for r in replays)
                           - _nbytes(self._out)) if self.captured else 0
        self._slots = ([_empty_like(self._out) for _ in range(self.depth)]
                       if self._out is not None else [None] * self.depth)
        self.output_bytes = (_nbytes(self._out) * (1 + self.depth)
                             if self._out is not None else 0)

    def footprint(self) -> dict | None:
        """The capture's footprint (None when nothing was captured)."""
        if not self.captured:
            return None
        from harp_tpu_torch.utils import memrec

        return memrec.footprint_from_capture(
            self.argument_bytes, self.output_bytes, self.temp_bytes)

    # -- the batch cycle ---------------------------------------------------
    def stage(self, arr: np.ndarray) -> Staged:
        """Put one padded batch into the rung's static input through a
        free slot (one counted H2D)."""
        try:
            slot = self._busy.index(False)
        except ValueError:
            raise RuntimeError(
                f"rung {self.rung}: all {self.depth} buffer sets hold "
                "batches not yet read back") from None
        done = self._h2d_done[slot]
        if done is not None:  # the slot's host buffer may still be read
            done.synchronize()
        self.engine.put_input(arr, dst=self.x, host=self._host[slot])
        if self._host[slot] is not None:
            ev = torch.cuda.Event()
            ev.record()
            self._h2d_done[slot] = ev
        return Staged(slot, int(arr.nbytes))

    def __call__(self, *args):
        staged = args[-1]
        if not isinstance(staged, Staged):
            raise TypeError("call a rung with the state and a stage() token")
        slot = staged.slot
        if self._busy[slot]:
            raise RuntimeError(
                f"rung {self.rung}: buffer set {slot} is in flight")
        out = self._run()
        if self._out is not None:
            _copy_into(self._slots[slot], self._out)
            out = self._slots[slot]
        else:  # eager: a fresh output, remembered by its slot
            self._slots[slot] = out
        self._busy[slot] = True
        return out

    def release(self, out) -> None:
        """Free the slot whose output ``out`` is (after its readback)."""
        for i, s in enumerate(self._slots):
            if self._busy[i] and s is out:
                self._busy[i] = False
                if self._out is None:
                    self._slots[i] = None
                return
        raise RuntimeError(f"rung {self.rung}: no buffer set in flight "
                           "holds this output")

    def in_flight(self) -> int:
        return sum(self._busy)


class GraphCache:
    """The disk records of captured rungs: ``get_or_build(name, engine,
    rung, depth, capture)`` builds the rung (capturing its graph on the
    card) and counts a hit when a valid record of its key exists, else a
    miss (and writes the record).  ``hits``/``misses`` count per
    instance."""

    def __init__(self, cache_dir: str, fingerprint: str | None = None):
        self.cache_dir = os.path.abspath(cache_dir)
        os.makedirs(self.cache_dir, exist_ok=True)
        self.fingerprint = fingerprint or code_fingerprint()
        self.hits = 0
        self.misses = 0

    def _key(self, name: str, device: torch.device, signature: str) -> str:
        sig = "|".join([name, torch.__version__, str(torch.version.cuda),
                        _device_tag(device), self.fingerprint, signature])
        return hashlib.sha1(sig.encode()).hexdigest()[:24]

    def _path(self, key: str) -> str:
        return os.path.join(self.cache_dir, f"graph_{key}.json")

    def footprint(self, key: str) -> dict | None:
        """The persisted footprint of ``key``, or None."""
        rec = self._read(key)
        fp = rec.get("footprint") if rec else None
        return fp if isinstance(fp, dict) else None

    def _read(self, key: str) -> dict | None:
        path = self._path(key)
        try:
            with open(path) as fh:
                rec = json.load(fh)
            if not isinstance(rec, dict) or rec.get("key") != key \
                    or rec.get("fingerprint") != self.fingerprint:
                raise ValueError("record does not match its key")
            return rec
        except FileNotFoundError:
            return None
        except (OSError, ValueError) as e:
            # the cache can lose, never lie: a bad record is a miss
            warnings.warn(f"serve cache record {os.path.basename(path)} "
                          f"unreadable ({type(e).__name__}: {e}) — "
                          "recapturing", RuntimeWarning)
            return None

    def _write(self, key: str, name: str, footprint: dict | None) -> None:
        path = self._path(key)
        tmp = f"{path}.{os.getpid()}.tmp"
        try:
            with open(tmp, "w") as fh:
                json.dump({"key": key, "name": name,
                           "fingerprint": self.fingerprint,
                           "footprint": footprint}, fh)
            os.replace(tmp, path)
        except OSError as e:
            warnings.warn(f"serve cache write failed ({e}) — the record "
                          "stays in memory only", RuntimeWarning)
            try:
                os.unlink(tmp)
            except OSError:
                pass

    def get_or_build(self, name: str, engine, rung: int, depth: int,
                     capture: Callable | None) -> RungExecutable:
        from harp_tpu_torch.utils import memrec

        exe = RungExecutable(engine, rung, depth, capture, label=name)
        key = self._key(name, engine.mesh.device, exe.signature)
        rec = self._read(key)
        fp = exe.footprint()
        if rec is not None:
            self.hits += 1
            memrec.note_executable(f"{name}.b{rung}",
                                   self.footprint(key) or fp, source="cache")
        else:
            self.misses += 1
            self._write(key, name, fp)
            memrec.note_executable(f"{name}.b{rung}", fp, source="capture")
        return exe
