"""BC-fused direct-stencil kernels: one update, or two fused updates, of the
unpadded field, with the boundary ghosts synthesized inside the kernel.

Port of ``heat3d_tpu.ops.stencil_pallas_direct`` (``apply_taps_direct``,
``apply_taps_direct2``). For a CUDA tensor each wrapper launches its
hand-written kernel from ``csrc/stencil_direct.cu`` (built on first use by
``ops._build``) or raises; for a CPU tensor it runs the kernel's plain
version, ``apply_taps_direct_ref`` / ``apply_taps_direct2_ref``: the ghost
pad plus the tap chain of ``ops.stencil_eager``, once or twice, rounding
through the storage dtype between the two updates. On the same device the
kernels equal their plain versions bitwise.

Each wrapper counts its kernel launches in ``<wrapper>.launches``, so a run
can show that it went through the kernel, and their output cells in
``<wrapper>.cells``; ``reset_launch_counts`` zeroes them.

Not ported yet: the Mehrstellen q-ring route (``HEAT3D_MEHRSTELLEN``), which
raises here, and bf16 compute dtype (the port computes in float32).
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import Optional

import numpy as np
import torch

from heat3d_tpu_torch.core.config import BoundaryCondition
from heat3d_tpu_torch.core.stencils import (
    _CountToken,
    accumulate_taps,
    decompose_mehrstellen,
    flat_taps,
    mehrstellen_enabled,
)
from heat3d_tpu_torch.ops.stencil_eager import apply_taps_padded, pad_local

_LIB = "stencil_direct"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# Blocks a launch aims for: with the tile count below this, x is cut into
# chunks (each costs 2*halo extra plane reads) so the card has several
# waves of blocks to schedule.
_TARGET_BLOCKS = 4096
_MIN_XCHUNK = 32


class _Term(ctypes.Structure):
    _fields_ = [
        ("src", ctypes.c_int),
        ("row", ctypes.c_int),
        ("dk", ctypes.c_int),
        ("w", ctypes.c_float),
    ]


class _Program(ctypes.Structure):
    _fields_ = [("n", ctypes.c_int), ("t", _Term * 27)]


def emission_program(taps: np.ndarray):
    """The tap chain as the kernels evaluate it: ``accumulate_taps`` under
    the current factoring knobs, recorded as ``(src, row, dk, w)`` entries
    in emission order. ``src`` 0/1/2 is the x-1/x/x+1 plane and 3 the sum
    of the x-1 and x+1 planes; ``row`` 0/1/2 is the y-1/y/y+1 row and 3 the
    sum of the y-1 and y+1 rows; ``w`` is ``np.float32`` of the weight."""
    entries = []
    weights = []
    tok = _CountToken()

    def scalar(w):
        weights.append(float(np.float32(w)))
        return tok

    def term(di, dj, dk):
        src = 3 if di == "xsum" else di + 1
        row = 3 if dj == "ysum" else dj + 1
        entries.append((src, row, dk))
        return tok

    accumulate_taps(flat_taps(taps), term, scalar)
    return tuple((s, r, dk, w) for (s, r, dk), w in zip(entries, weights))


@functools.lru_cache(maxsize=64)
def _program(taps_bytes: bytes, factor_7pt: str, factor_y: str) -> _Program:
    # the two factoring knobs are part of the key: the chain they select is
    # read from the environment inside accumulate_taps
    taps = np.frombuffer(taps_bytes, dtype=np.float64).reshape(3, 3, 3)
    entries = emission_program(taps)
    if not 1 <= len(entries) <= 27:
        raise ValueError(f"tap chain of {len(entries)} entries (want 1..27)")
    prog = _Program()
    prog.n = len(entries)
    for i, (s, r, dk, w) in enumerate(entries):
        prog.t[i] = _Term(s, r, dk, w)
    return prog


def check_route(taps: np.ndarray) -> np.ndarray:
    taps = np.ascontiguousarray(taps, dtype=np.float64)
    if taps.shape != (3, 3, 3):
        raise ValueError(f"taps must be (3,3,3), got {taps.shape}")
    if mehrstellen_enabled() and decompose_mehrstellen(taps) is not None:
        raise ValueError(
            "HEAT3D_MEHRSTELLEN: the Mehrstellen q-ring route of the direct "
            "kernels is not ported yet; unset it to run the tap chain"
        )
    return taps


def _bc(periodic: bool) -> BoundaryCondition:
    return BoundaryCondition.PERIODIC if periodic else BoundaryCondition.DIRICHLET


def apply_taps_direct_ref(
    u: torch.Tensor, taps: np.ndarray, periodic: bool = False,
    bc_value: float = 0.0,
) -> torch.Tensor:
    """Plain version of :func:`apply_taps_direct`: ghost pad + tap chain."""
    return apply_taps_padded(pad_local(u, _bc(periodic), bc_value), taps)


def apply_taps_direct2_ref(
    u: torch.Tensor, taps: np.ndarray, periodic: bool = False,
    bc_value: float = 0.0,
) -> torch.Tensor:
    """Plain version of :func:`apply_taps_direct2`: two plain updates, the
    intermediate held in the storage dtype."""
    mid = apply_taps_direct_ref(u, taps, periodic, bc_value)
    return apply_taps_direct_ref(mid, taps, periodic, bc_value)


def check_tensors(
    u: torch.Tensor, out: Optional[torch.Tensor], out_shape=None
) -> torch.Tensor:
    """Check a kernel's input ``u`` and its optional preallocated ``out``
    (shape ``out_shape``, default ``u``'s); return ``out`` or a new one."""
    out_shape = tuple(u.shape) if out_shape is None else tuple(out_shape)
    if u.dim() != 3:
        raise ValueError(f"field must be 3-D, got shape {tuple(u.shape)}")
    if u.dtype not in _DTYPE_CODES:
        raise ValueError(f"field dtype {u.dtype} not supported (float32, bfloat16)")
    if not u.is_contiguous():
        raise ValueError("field must be contiguous")
    if max(u.shape) >= 2**31:
        raise ValueError(f"extent too large: {tuple(u.shape)}")
    if out is None:
        return torch.empty(out_shape, dtype=u.dtype, device=u.device)
    if tuple(out.shape) != out_shape or out.dtype != u.dtype or out.device != u.device:
        raise ValueError(
            f"out must match the result: got {tuple(out.shape)} {out.dtype} "
            f"{out.device}, want {out_shape} {u.dtype} {u.device}"
        )
    if not out.is_contiguous():
        raise ValueError("out must be contiguous")
    lo_u, lo_o = u.data_ptr(), out.data_ptr()
    if lo_u < lo_o + out.nbytes and lo_o < lo_u + u.nbytes:
        raise ValueError(
            "out overlaps the field: the kernel reads neighbours, so it "
            "cannot update in place"
        )
    return out


def chain_program(taps: np.ndarray) -> _Program:
    """The kernels' emission program of ``taps`` under the current
    factoring knobs (cached per taps and knobs)."""
    return _program(
        taps.tobytes(),
        os.environ.get("HEAT3D_FACTOR_7PT", ""),
        os.environ.get("HEAT3D_FACTOR_Y", "1"),
    )


def storage_bc(bc_value: float, dtype: torch.dtype) -> float:
    """``bc_value`` rounded to the storage dtype, as the plain version's
    constant pad (and the Pallas kernels' ``dtype.type(bc)``) rounds it."""
    return float(torch.full((), bc_value, dtype=dtype).float())


def _xchunk(shape, ty: int, tz: int) -> int:
    """x-chunk length of a launch over (nx, ny, nz) with (ty, tz) tiles."""
    nx, ny, nz = shape
    tiles = -(-ny // ty) * -(-nz // tz)
    chunks = max(1, min(-(-_TARGET_BLOCKS // tiles), -(-nx // _MIN_XCHUNK)))
    return -(-nx // chunks)


@functools.lru_cache(maxsize=None)
def _lib():
    from heat3d_tpu_torch.ops import _build

    lib = _build.load(_LIB)
    lib.heat3d_direct_launch.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.POINTER(_Program), ctypes.c_void_p,
    ]
    lib.heat3d_direct_launch.restype = ctypes.c_int
    for fn in ("heat3d_direct_tile_y", "heat3d_direct_tile_z"):
        getattr(lib, fn).argtypes = []
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def _launch(halo, u, taps, periodic, bc_value, out) -> torch.Tensor:
    if u.device.type != "cuda":
        raise ValueError(f"no kernel for device {u.device}")
    out = check_tensors(u, out)
    lib = _lib()
    prog = chain_program(taps)
    bc = storage_bc(bc_value, u.dtype)
    nx, ny, nz = u.shape
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        err = lib.heat3d_direct_launch(
            halo, _DTYPE_CODES[u.dtype], u.data_ptr(), out.data_ptr(),
            nx, ny, nz,
            _xchunk(u.shape, lib.heat3d_direct_tile_y(), lib.heat3d_direct_tile_z()),
            int(bool(periodic)), bc,
            ctypes.byref(prog), stream,
        )
    if err != 0:
        raise RuntimeError(
            f"direct-stencil kernel (halo {halo}) launch failed: error {err}"
            + (" (bad arguments)" if err == 1000 else "")
        )
    return out


def apply_taps_direct(
    u: torch.Tensor,
    taps: np.ndarray,
    periodic: bool = False,
    bc_value: float = 0.0,
    out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """One explicit-Euler update of the whole (1,1,1)-mesh field: unpadded
    (nx, ny, nz) in, (nx, ny, nz) out in the same dtype (float32 or
    bfloat16 storage, float32 compute). ``out`` (optional, preallocated)
    must not overlap ``u``."""
    taps = check_route(taps)
    if u.device.type == "cpu":
        res = apply_taps_direct_ref(u, taps, periodic, bc_value)
        return res if out is None else out.copy_(res)
    out = _launch(1, u, taps, periodic, bc_value, out)
    apply_taps_direct.launches += 1
    apply_taps_direct.cells += out.numel()
    return out


def apply_taps_direct2(
    u: torch.Tensor,
    taps: np.ndarray,
    periodic: bool = False,
    bc_value: float = 0.0,
    out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Two fused updates of the whole (1,1,1)-mesh field in one sweep, the
    intermediate rounded to the storage dtype and its Dirichlet domain
    ghosts pinned to ``bc_value``: equal to two :func:`apply_taps_direct`
    calls."""
    taps = check_route(taps)
    if u.device.type == "cpu":
        res = apply_taps_direct2_ref(u, taps, periodic, bc_value)
        return res if out is None else out.copy_(res)
    out = _launch(2, u, taps, periodic, bc_value, out)
    apply_taps_direct2.launches += 1
    apply_taps_direct2.cells += out.numel()
    return out


KERNELS = (apply_taps_direct, apply_taps_direct2)


def launch_counts() -> dict:
    return {k.__name__: k.launches for k in KERNELS}


def cell_counts() -> dict:
    return {k.__name__: k.cells for k in KERNELS}


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = k.cells = 0


reset_launch_counts()
