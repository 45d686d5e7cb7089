"""Exchange-path stencil kernels: the ghost-padded field in, its interior
after one update, or after k = 2..4 fused updates, out.

Port of ``heat3d_tpu.ops.stencil_pallas``:

- :func:`apply_taps_stream` is the counterpart of
  ``apply_taps_pallas_stream`` and of the dispatcher ``apply_taps_pallas``
  (whose windowed form exists only because a TPU plane ring can overflow
  VMEM): (nx+2, ny+2, nz+2) in, (nx, ny, nz) out;
- :func:`apply_taps_streamk` is the counterpart of
  ``apply_taps_pallas_streamk``: width-k padded (nx+2k, ...) in, the
  interior after k updates out, each intermediate rounded to the storage
  dtype and, under Dirichlet, pinned to ``bc_value`` outside the domain;
  :func:`apply_taps_stream2` is its k=2 form (``apply_taps_pallas_stream2``).

For a CUDA tensor each wrapper launches its hand-written kernel from
``csrc/stencil_stream.cu`` (built on first use by ``ops._build``) or
raises; for a CPU tensor it runs the kernel's plain version:
``stencil_eager.apply_taps_padded`` for the stream kernel, and
:func:`apply_taps_streamk_ref` (k ``apply_taps_padded`` applications with
the pins between, ``parallel.step._local_stepk``'s arithmetic on the padded
block) for streamk. On the same device the kernels equal their plain
versions bitwise. The tap chain is ``stencil_direct``'s emission program.

Each wrapper counts its kernel launches in ``<wrapper>.launches``
(``apply_taps_stream2`` counts as ``apply_taps_streamk``, whose kernel it
launches); ``reset_launch_counts`` zeroes them.

Not ported yet: the Mehrstellen route (``HEAT3D_MEHRSTELLEN``), which
raises here, and bf16 compute dtype (the port computes in float32).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import numpy as np
import torch

from heat3d_tpu_torch.ops.stencil_direct import (
    _DTYPE_CODES,
    _Program,
    _xchunk,
    chain_program,
    check_route,
    check_tensors,
    storage_bc,
)
from heat3d_tpu_torch.ops.stencil_eager import apply_taps_padded, pin_outside

_LIB = "stencil_stream"
STREAMK_DEPTHS = (2, 3, 4)


def apply_taps_streamk_ref(
    upk: torch.Tensor, taps: np.ndarray, k: int, periodic: bool = False,
    bc_value: float = 0.0,
) -> torch.Tensor:
    """Plain version of :func:`apply_taps_streamk`: k ``apply_taps_padded``
    applications over the width-k padded block, each but the last rounded
    to the storage dtype (``apply_taps_padded`` returns it) and, under
    Dirichlet, pinned to ``bc_value`` wherever its global index (padded
    index - k) lies outside the (nx, ny, nz) domain."""
    interior = [n - 2 * k for n in upk.shape]
    cur = upk
    for j in range(1, k + 1):
        cur = apply_taps_padded(cur, taps)
        r = k - j  # ghost rings cur still carries
        if r > 0 and not periodic:
            idx = [torch.arange(-r, n + r, device=cur.device) for n in interior]
            cur = pin_outside(cur, idx, interior, bc_value)
    return cur


@functools.lru_cache(maxsize=None)
def _lib():
    from heat3d_tpu_torch.ops import _build

    lib = _build.load(_LIB)
    lib.heat3d_stream_launch.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.POINTER(_Program), ctypes.c_void_p,
    ]
    lib.heat3d_stream_launch.restype = ctypes.c_int
    for fn in ("heat3d_stream_tile_y", "heat3d_stream_tile_z"):
        getattr(lib, fn).argtypes = []
        getattr(lib, fn).restype = ctypes.c_int
    lib.heat3d_streamk_smem_bytes.argtypes = [ctypes.c_int]
    lib.heat3d_streamk_smem_bytes.restype = ctypes.c_int
    return lib


def streamk_smem_bytes(k: int) -> int:
    """Dynamic shared memory of one streamk block at depth k (builds and
    loads the library; CUDA hosts only)."""
    return _lib().heat3d_streamk_smem_bytes(k)


def _interior(up: torch.Tensor, k: int):
    if up.dim() != 3:
        raise ValueError(f"padded field must be 3-D, got shape {tuple(up.shape)}")
    shape = tuple(n - 2 * k for n in up.shape)
    if min(shape) < 1:
        raise ValueError(
            f"padded field {tuple(up.shape)} has no interior at width {k}"
        )
    return shape


def _launch(k, up, taps, periodic, bc_value, out) -> torch.Tensor:
    if up.device.type != "cuda":
        raise ValueError(f"no kernel for device {up.device}")
    shape = _interior(up, k)
    out = check_tensors(up, out, shape)
    lib = _lib()
    prog = chain_program(taps)
    bc = storage_bc(bc_value, up.dtype)
    xchunk = _xchunk(shape, lib.heat3d_stream_tile_y(), lib.heat3d_stream_tile_z())
    with torch.cuda.device(up.device):
        stream = torch.cuda.current_stream(up.device).cuda_stream
        err = lib.heat3d_stream_launch(
            k, _DTYPE_CODES[up.dtype], up.data_ptr(), out.data_ptr(), *shape,
            xchunk, int(bool(periodic)), bc, ctypes.byref(prog), stream,
        )
    if err != 0:
        raise RuntimeError(
            f"stream kernel (k={k}) launch failed: error {err}"
            + (" (bad arguments)" if err == 1000 else "")
        )
    return out


def apply_taps_stream(
    up: torch.Tensor, taps: np.ndarray, out: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """One update from a ghost-padded block: (nx+2, ny+2, nz+2) in,
    (nx, ny, nz) out in the same dtype (float32 or bfloat16 storage,
    float32 compute). ``out`` (optional, preallocated) must not overlap
    ``up``."""
    taps = check_route(taps)
    if up.device.type == "cpu":
        _interior(up, 1)
        res = apply_taps_padded(up, taps)
        return res if out is None else out.copy_(res)
    out = _launch(1, up, taps, False, 0.0, out)
    apply_taps_stream.launches += 1
    return out


def apply_taps_streamk(
    upk: torch.Tensor,
    taps: np.ndarray,
    k: int,
    periodic: bool = False,
    bc_value: float = 0.0,
    out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """k = 2..4 fused updates from a width-k ghost-padded block:
    (nx+2k, ny+2k, nz+2k) in, the (nx, ny, nz) interior after k updates
    out, equal to :func:`apply_taps_streamk_ref`. The ghosts must come from
    the exchange (``parallel.halo``): under periodic boundaries they are
    the wrap, which the kernel does not make."""
    if k not in STREAMK_DEPTHS:
        raise ValueError(f"streamk kernel wants k in {STREAMK_DEPTHS}, got {k}")
    taps = check_route(taps)
    if upk.device.type == "cpu":
        _interior(upk, k)
        res = apply_taps_streamk_ref(upk, taps, k, periodic, bc_value)
        return res if out is None else out.copy_(res)
    out = _launch(k, upk, taps, periodic, bc_value, out)
    apply_taps_streamk.launches += 1
    return out


def apply_taps_stream2(
    up2: torch.Tensor,
    taps: np.ndarray,
    periodic: bool = False,
    bc_value: float = 0.0,
    out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Two fused updates from a width-2 padded block: the k=2 instance of
    :func:`apply_taps_streamk` (counterpart of ``apply_taps_pallas_stream2``)."""
    return apply_taps_streamk(up2, taps, 2, periodic, bc_value, out=out)


apply_taps_stream.launches = 0
apply_taps_streamk.launches = 0

KERNELS = (apply_taps_stream, apply_taps_streamk)


def launch_counts() -> dict:
    return {k.__name__: k.launches for k in KERNELS}


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


def make_stream_compute(cfg):
    """The exchange path's padded-block compute through the stream kernel,
    ``(up, taps, out=None) -> interior``: counterpart of
    ``make_pallas_compute(cfg)``. The kernel reads everything it needs
    from the block (shape, storage dtype), so ``cfg`` selects nothing."""

    def compute(up: torch.Tensor, taps: np.ndarray, out=None) -> torch.Tensor:
        return apply_taps_stream(up, taps, out=out)

    return compute
