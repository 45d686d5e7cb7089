"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into a shared library with a
plain C interface, loaded with ``ctypes`` (no PyTorch headers, so a build
takes seconds). Builds happen on first use, into ``_build/`` inside the
package (listed in ``.gitignore``), named by a hash of the source and the
flags, so an edited source rebuilds and concurrent processes never load a
half-written file.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3",
    # no FMA contraction anywhere: the kernels must round like eager PyTorch
    "--fmad=false",
    "-Xptxas", "-v",
    "-shared", "-Xcompiler", "-fPIC",
)


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH,
    else ``/usr/local/cuda/bin/nvcc``."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    which = shutil.which("nvcc")
    if which:
        candidates.append(which)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH, /usr/local/cuda/bin): "
        "the port's CUDA kernels are built from source on first use"
    )


def _target(name: str) -> Path:
    src = CSRC_DIR / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _build(name: str) -> float:
    """Compile ``csrc/<name>.cu`` unless it is built already; returns the
    wall seconds of the build (0.0 when it was built). The compiler's output
    (``-Xptxas -v``: registers, shared memory, spills) lands beside the
    library as ``.log``."""
    so = _target(name)
    if so.exists():
        return 0.0
    # a pid-suffixed temp file, renamed into place: a concurrent process
    # never loads a half-written library
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, check=False,
    )
    so.with_suffix(".log").write_text(proc.stdout)
    if proc.returncode != 0:
        raise RuntimeError(f"kernel build failed: {name}: nvcc exit "
                           f"{proc.returncode}\n{proc.stdout}")
    os.replace(tmp, so)
    return time.perf_counter() - t0


def build_all(names=None) -> Dict[str, float]:
    """Compile the named sources (default: every ``csrc/*.cu``), one
    ``nvcc`` per source, all started together. Returns the wall seconds of
    each build (0.0 for a library already built)."""
    if names is None:
        names = sorted(p.stem for p in CSRC_DIR.glob("*.cu"))
    BUILD_DIR.mkdir(exist_ok=True)
    with ThreadPoolExecutor(max(1, len(names))) as pool:
        return dict(zip(names, pool.map(_build, names)))


def build_log(name: str) -> str:
    """The compiler output of the last build of ``name`` (may be empty)."""
    log = _target(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The built library for ``csrc/<name>.cu``, building it first if
    needed. Called by the kernel wrappers at their first CUDA launch."""
    build_all([name])
    return ctypes.CDLL(str(_target(name)))
