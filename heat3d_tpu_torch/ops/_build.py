"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into a shared library with a
plain C interface, loaded with ``ctypes`` (no PyTorch headers, so a build
takes seconds). Builds happen on first use, into ``_build/`` inside the
package (listed in ``.gitignore``), named by a hash of the source, the
shared headers (``csrc/*.cuh``) and the flags, so an edited source or
header rebuilds and concurrent processes never load a half-written file.
A source may take flags of its own from its wrapper (``source_flags``: the
stream, direct and fused kernels' chain table).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
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


def source_flags(name: str) -> tuple:
    """Flags of ``csrc/<name>.cu`` beyond ``NVCC_FLAGS``: the stream,
    direct and fused kernels take their compile-time tap chains from the
    stream wrapper's table."""
    if name in ("stencil_stream", "stencil_direct", "stencil_fused"):
        from heat3d_tpu_torch.ops.stencil_stream import nvcc_defines

        return nvcc_defines()
    return ()


def _target(name: str) -> Path:
    # the source and every header beside it: an edited shared header must
    # rebuild each library that includes it
    h = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS + source_flags(name)).encode())
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
        [nvcc_path(), *NVCC_FLAGS, *source_flags(name), "-o", str(tmp),
         str(CSRC_DIR / f"{name}.cu")],
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


def ptxas_report(name: str) -> Dict[str, Dict[str, int]]:
    """Per kernel (mangled name) of the last build of ``name``: registers,
    spill stores and spill loads (bytes), from the compiler's ``-Xptxas -v``
    lines."""
    report, entry = {}, None
    for line in build_log(name).splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = report.setdefault(m.group(1), {})
            continue
        if entry is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            entry["spill_stores"], entry["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            entry["registers"] = int(m.group(1))
    return report


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The built library for ``csrc/<name>.cu``, building it first if
    needed. Called by the kernel wrappers at their first CUDA launch."""
    build_all([name])
    return ctypes.CDLL(str(_target(name)))
