"""Build the CUDA kernels under ``harp_tpu_torch/csrc`` at first use.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for ``sm_90a`` into its own shared library, loaded with ``ctypes``; shared
device code lives in ``csrc/*.cuh`` headers.  The library lands in
``harp_tpu_torch/_build/`` (git ignores it) under a name keyed by a hash of
the source, the headers it includes and the flags, so an edited source or
header rebuilds the libraries that use it and an unchanged one is reused.
:func:`build` compiles several sources at once, one ``nvcc`` process each,
all started together; each build counts as one compile on the flight
recorder's CompileWatch.

Nothing here runs at import time: the CPU tests import every module of the
port on a machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)

#: per source built in this process: {"seconds": wall, "log": nvcc output}
BUILD_LOG: dict[str, dict] = {}
_LIBS: dict[str, ctypes.CDLL] = {}


def sources() -> list[str]:
    """Names of every kernel source (``csrc/<name>.cu``)."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def headers(path: Path) -> list[Path]:
    """The headers of ``csrc/`` that ``path`` includes (``#include "..."``),
    directly or through another header, in order of first inclusion."""
    found: list[Path] = []
    todo = [path]
    while todo:
        for inc in _INCLUDE.findall(todo.pop(0).read_text()):
            h = CSRC / inc
            if h.exists() and h not in found:
                found.append(h)
                todo.append(h)
    return found


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` lands, named by a hash of the
    source, the headers it includes and the flags."""
    path = CSRC / f"{name}.cu"
    src = path.read_bytes() + b"".join(h.read_bytes() for h in headers(path))
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{key}.so"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit on PATH or under CUDA_HOME")


def build(names: list[str] | None = None, timeout_s: float = 600.0) -> None:
    """Compile every named source whose library is missing, in parallel.
    Raises with the compiler's output if one fails; stops the others."""
    todo = [n for n in (names or sources()) if not library_path(n).exists()]
    if not todo:
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    try:
        for name in todo:
            tmp = BUILD_DIR / f"{library_path(name).name}.{os.getpid()}.tmp"
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True), tmp, time.perf_counter())
        deadline = time.monotonic() + timeout_s
        for name, (proc, tmp, t0) in procs.items():
            log, _ = proc.communicate(timeout=max(deadline - time.monotonic(), 1))
            if proc.returncode:
                raise RuntimeError(f"nvcc failed on csrc/{name}.cu:\n{log}")
            os.replace(tmp, library_path(name))
            BUILD_LOG[name] = {"seconds": time.perf_counter() - t0, "log": log}
            from harp_tpu_torch.utils import flightrec

            flightrec.on_build(name, BUILD_LOG[name]["seconds"])
    finally:
        for proc, tmp, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            tmp.unlink(missing_ok=True)


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = _LIBS[name] = ctypes.CDLL(str(library_path(name)))
    return lib


def bind(name: str, signatures: dict[str, list]) -> ctypes.CDLL:
    """The library of ``csrc/<name>.cu`` with each entry point of
    ``signatures`` ({function: ctypes argtypes}) typed, returning an int
    CUDA error code.  Pointers and the stream must be ``c_void_p``: an
    untyped Python int would be cut to 32 bits."""
    lib = load(name)
    for fn, argtypes in signatures.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if err:
        raise RuntimeError(f"{what}: CUDA error {err}")


def require(t, what: str, dtypes, shape, device) -> None:
    """A kernel wrapper's check of one tensor argument: its device, dtype
    (one of ``dtypes``), shape and contiguity, raising on what the kernel
    does not take."""
    if t.device != device:
        raise ValueError(f"{what} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{what} has dtype {t.dtype}, expected one of "
                        f"{[str(d) for d in dtypes]}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")
