"""Compile-on-first-use for the port's native loader (g++ → .so, ctypes).

``loader.cpp`` beside this file is built into ``harp_tpu_torch/_build/``
(git ignores it) under a name keyed by a hash of the source and of the
host CPU's feature flags (``-march=native`` binaries are CPU-specific).
Nothing is built when a module is imported: :func:`load_native` builds on
its first call, and returns None where no ``g++`` exists, so the callers
take their numpy parse instead.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_SRC = Path(__file__).resolve().parent / "loader.cpp"
BUILD_DIR = _SRC.parent.parent / "_build"
_LIB: ctypes.CDLL | None = None
_TRIED = False


def so_path() -> Path:
    h = hashlib.sha256(_SRC.read_bytes())
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("flags"):
                    h.update(line.encode())
                    break
    except OSError:
        import platform

        h.update(platform.processor().encode())
    return BUILD_DIR / f"harp_native_{h.hexdigest()[:16]}.so"


def native_available() -> bool:
    return shutil.which("g++") is not None or so_path().exists()


def load_native() -> ctypes.CDLL | None:
    """The ctypes library, built if needed; None if it cannot be."""
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    so = so_path()
    if not so.exists():
        if shutil.which("g++") is None:
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # build to a temporary file, then rename: parallel-safe
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = ["g++", "-O3", "-march=native", "-std=c++17", "-shared",
               "-fPIC", "-pthread", str(_SRC), "-o", tmp]
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=300)
            os.replace(tmp, so)
        except (subprocess.CalledProcessError, subprocess.TimeoutExpired):
            os.unlink(tmp)
            return None
    lib = ctypes.CDLL(str(so))
    i64, i64p = ctypes.c_int64, ctypes.POINTER(ctypes.c_int64)
    fp = ctypes.POINTER(ctypes.c_float)
    sigs = {
        "harp_count_rows": ([ctypes.c_char_p, ctypes.c_int, i64p, i64p],
                            ctypes.c_int),
        "harp_load_csv_f32": ([ctypes.c_char_p, ctypes.c_int, fp, i64, i64],
                              ctypes.c_int),
        "harp_csv_count_stream": ([ctypes.c_char_p, i64p, i64p],
                                  ctypes.c_int),
        "harp_csv_stream_open": ([ctypes.c_char_p, i64], ctypes.c_void_p),
        "harp_csv_stream_cols": ([ctypes.c_void_p], i64),
        "harp_csv_stream_next": ([ctypes.c_void_p, fp, i64], i64),
        "harp_csv_stream_close": ([ctypes.c_void_p], None),
    }
    for name, (argtypes, restype) in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, restype
    _LIB = lib
    return _LIB
