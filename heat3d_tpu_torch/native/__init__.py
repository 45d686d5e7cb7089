"""ctypes loader for the port's native C++ reference stepper.

The port's copy of the JAX package's ``native`` module: the same
``heat3d_native.cpp`` (OpenMP, fp64), built with ``g++ -O3 -fopenmp
-shared -fPIC`` on first use into the package's ``_build/`` directory
(git-ignored, beside the CUDA libraries), never next to the source. The
library's name carries a hash of the source and the flags, so an edited
source rebuilds; the compile writes a pid-unique temp file and
``os.replace``s it into place under an ``fcntl`` lock, so concurrent
processes (test workers, ranks) never load a half-written library.
Degrades gracefully: without a compiler, or when the build fails,
``available()`` is False, ``build_error()`` says why, and the golden
model's ``impl='auto'`` falls back to NumPy.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_HERE = Path(__file__).resolve().parent
_SRC = _HERE / "heat3d_native.cpp"
BUILD_DIR = _HERE.parent / "_build"
# no -march=native: a library left in _build must stay valid on another
# host of the same architecture, and the stepper is bandwidth-bound anyway
CXX_FLAGS = ("-O3", "-fopenmp", "-shared", "-fPIC")
_ABI_VERSION = 1

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_error: Optional[str] = None


def library_path() -> Path:
    """Where the built library lives: ``_build/libheat3d_native-<hash>.so``
    (the hash of the source and the flags)."""
    h = hashlib.sha256(_SRC.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libheat3d_native-{h.hexdigest()[:16]}.so"


def _build(so: Path) -> Optional[str]:
    """Compile the shared library; returns an error string or None."""
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = ["g++", *CXX_FLAGS, "-o", str(tmp), str(_SRC)]
    try:
        import fcntl

        with open(str(so) + ".lock", "w") as lockf:
            fcntl.flock(lockf, fcntl.LOCK_EX)
            try:
                # another process may have finished the build while we waited
                if so.exists():
                    return None
                proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
                if proc.returncode != 0:
                    return f"g++ failed: {proc.stderr[-2000:]}"
                os.replace(tmp, so)
            finally:
                if tmp.exists():
                    tmp.unlink()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"g++ launch failed: {e}"
    return None


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_error
    with _lock:
        if _lib is not None or _build_error is not None:
            return _lib
        so = library_path()
        if not so.exists():
            err = _build(so)
            if err:
                _build_error = err
                return None
        try:
            lib = ctypes.CDLL(str(so))
        except OSError as e:
            _build_error = f"dlopen failed: {e}"
            return None
        if lib.heat3d_native_abi_version() != _ABI_VERSION:
            _build_error = "ABI version mismatch; delete the stale library"
            return None
        lib.heat3d_run_f64.restype = ctypes.c_int
        lib.heat3d_run_f64.argtypes = [
            ctypes.POINTER(ctypes.c_double),
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_double),
            ctypes.c_int64, ctypes.c_int, ctypes.c_double,
        ]
        lib.heat3d_diff_sumsq_f64.restype = ctypes.c_double
        lib.heat3d_diff_sumsq_f64.argtypes = [
            ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_double),
            ctypes.c_int64,
        ]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def build_error() -> Optional[str]:
    _load()
    return _build_error


def run(
    u0: np.ndarray,
    taps: np.ndarray,
    num_steps: int,
    periodic: bool,
    bc_value: float = 0.0,
) -> np.ndarray:
    """num_steps explicit-Euler updates of interior field u0 (float64 copy
    returned; u0 untouched)."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native stepper unavailable: {_build_error}")
    u = np.ascontiguousarray(u0, dtype=np.float64).copy()
    t = np.ascontiguousarray(taps, dtype=np.float64)
    if u.ndim != 3 or t.shape != (3, 3, 3):
        raise ValueError(f"bad shapes: u {u.shape}, taps {t.shape}")
    rc = lib.heat3d_run_f64(
        u.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        *map(ctypes.c_int64, u.shape),
        t.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        ctypes.c_int64(num_steps),
        ctypes.c_int(1 if periodic else 0),
        ctypes.c_double(bc_value),
    )
    if rc != 0:
        raise RuntimeError(f"heat3d_run_f64 returned {rc}")
    return u


def diff_sumsq(a: np.ndarray, b: np.ndarray) -> float:
    """sum((a - b)**2) in fp64 (the residual reduction), without NumPy
    temporaries."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native stepper unavailable: {_build_error}")
    aa = np.ascontiguousarray(a, dtype=np.float64)
    bb = np.ascontiguousarray(b, dtype=np.float64)
    if aa.size != bb.size:
        raise ValueError("size mismatch")
    return float(
        lib.heat3d_diff_sumsq_f64(
            aa.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            bb.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            ctypes.c_int64(aa.size),
        )
    )
