"""BC-fused direct-stencil kernels: one update, or two fused updates, of the
unpadded field, with the boundary ghosts synthesized inside the kernel.

Port of ``heat3d_tpu.ops.stencil_pallas_direct`` (``apply_taps_direct``,
``apply_taps_direct2``). For a CUDA tensor each wrapper launches its
hand-written kernel from ``csrc/stencil_direct.cu`` (built on first use by
``ops._build``) or raises; for a CPU tensor it runs the kernel's plain
version, ``apply_taps_direct_ref`` / ``apply_taps_direct2_ref``: the ghost
pad plus ``ops.stencil_eager.apply_taps_padded`` (the tap chain, or the
Mehrstellen route under ``HEAT3D_MEHRSTELLEN``), once or twice, rounding
through the storage dtype between the two updates. On the same device the
kernels equal their plain versions bitwise.

The kernel source has an instance with the chain fixed at compile time for
each entry of the stream kernels' table (``stencil_stream.CHAINS``, which
the build passes to ``nvcc`` for both sources), a compile-time instance of
the Mehrstellen q-ring route (:data:`MEHRSTELLEN`: the JAX kernels' route
under ``HEAT3D_MEHRSTELLEN`` for taps that decompose as
``a*delta + b*S + d*F``, the 27pt set), and a generic instance that
interprets any other program; :func:`direct_instance` picks one. A launch
error raises: no launch falls back to another instance.

Every instance runs in either compute dtype (``compute_dtype``, the JAX
kernels' ``compute_dtype``): float32, or bf16, where each field value read
and each multiply and add is rounded to bf16 (``csrc/stencil_common.cuh``:
the compile-time instances take the rounding as a policy, ``Bf16Math``,
an instance of their own; the generic one as a flag of its program). The
weights are :func:`stencil_eager.compute_weight`'s, as in the plain
version.

Each wrapper counts its kernel launches in ``<wrapper>.launches``, so a run
can show that it went through the kernel, the launches that took the
generic instance in ``<wrapper>.generic_launches``, those that took the
Mehrstellen instance in ``<wrapper>.mehrstellen_launches``, those in bf16
compute in ``<wrapper>.compute_bf16_launches`` (of them on the Mehrstellen
instance in ``<wrapper>.compute_bf16_mehrstellen_launches``), and the
output cells in ``<wrapper>.cells`` (of the Mehrstellen launches in
``<wrapper>.mehrstellen_cells``); ``reset_launch_counts`` zeroes them.
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
    MEHRSTELLEN_OPS,
    _CountToken,
    accumulate_taps,
    decompose_mehrstellen,
    flat_taps,
    mehrstellen_enabled,
)
from heat3d_tpu_torch.ops.stencil_eager import apply_taps_padded, compute_weight, pad_local

_LIB = "stencil_direct"
# The instance code of the Mehrstellen q-ring route in the kernel's
# interface (csrc/stencil_chain.cuh SPEC_MEHR), beside the chain codes of
# ``stencil_stream.CHAINS`` (0 generic, 1 7pt, 2 27pt).
MEHRSTELLEN = 3
# fp32 operations per cell and update of that instance (and of its plain
# version), each multiply and add its own rounded op: z131 3, y131 3, S 3,
# the three face sums 3, psum 2, the combine 5. The bench rows' chain_ops
# give the JAX package's count of the route, MEHRSTELLEN_OPS.
MEHRSTELLEN_KERNEL_OPS = 19
# the storage dtype's code in the kernels' interface; the compute dtype's
# code (F32Math / Bf16Math of csrc/stencil_common.cuh) is the same
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# Blocks a launch of the generic instance aims for: with the tile count
# below this, x is cut into chunks (each costs 2*halo extra plane reads) so
# the card has several waves of blocks to schedule. The compile-time
# instances aim for _WAVES waves of the blocks the card holds at once
# (``wave_xchunk``).
_TARGET_BLOCKS = 4096
_WAVES = 16
_MIN_XCHUNK = 32


class _Term(ctypes.Structure):
    _fields_ = [
        ("src", ctypes.c_int),
        ("row", ctypes.c_int),
        ("dk", ctypes.c_int),
        ("w", ctypes.c_float),
    ]


class _Program(ctypes.Structure):
    # bf16: set by the library from the launch's compute code
    _fields_ = [("n", ctypes.c_int), ("bf16", ctypes.c_int), ("t", _Term * 27)]


def compute_code(compute_dtype: torch.dtype) -> int:
    """The kernels' code of ``compute_dtype`` (float32 0, bfloat16 1), or
    raise."""
    if compute_dtype not in _DTYPE_CODES:
        raise ValueError(f"compute dtype {compute_dtype} not supported (float32, bfloat16)")
    return _DTYPE_CODES[compute_dtype]


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


def chain_ops(taps: np.ndarray, mehrstellen: bool = False) -> int:
    """fp32 operations per cell and update of ``taps``' emission program
    under the current factoring knobs, with each plane and row sum counted
    once (as the plain version caches them): the bench rows' ``chain_ops``
    and the flops of a kernel's bound. With ``mehrstellen`` (the route ran)
    and taps that decompose, the JAX package's count of the Mehrstellen
    route, ``MEHRSTELLEN_OPS``."""
    if mehrstellen and decompose_mehrstellen(taps) is not None:
        return MEHRSTELLEN_OPS
    prog = emission_program(taps)
    sums = {("x",)} if any(s == 3 for s, _, _, _ in prog) else set()
    sums |= {("y", s) for s, r, _, _ in prog if r == 3}
    return 2 * len(prog) - 1 + len(sums)


@functools.lru_cache(maxsize=64)
def _program(taps_bytes: bytes, factor_7pt: str, factor_y: str,
             compute_dtype: torch.dtype) -> _Program:
    # the two factoring knobs are part of the key: the chain they select is
    # read from the environment inside accumulate_taps
    taps = np.frombuffer(taps_bytes, dtype=np.float64).reshape(3, 3, 3)
    entries = emission_program(taps)
    if not 1 <= len(entries) <= 27:
        raise ValueError(f"tap chain of {len(entries)} entries (want 1..27)")
    prog = _Program()
    prog.n = len(entries)
    for i, (s, r, dk, w) in enumerate(entries):
        prog.t[i] = _Term(s, r, dk, compute_weight(w, compute_dtype))
    return prog


def check_taps(taps: np.ndarray) -> np.ndarray:
    """``taps`` as a contiguous float64 (3, 3, 3) array, or raise."""
    taps = np.ascontiguousarray(taps, dtype=np.float64)
    if taps.shape != (3, 3, 3):
        raise ValueError(f"taps must be (3,3,3), got {taps.shape}")
    return taps


def mehrstellen_route(taps: np.ndarray) -> bool:
    """Whether the direct kernels take the Mehrstellen q-ring route for
    ``taps`` under the current environment: the JAX gate
    (``stencil_pallas_direct._mehrstellen_q_ring``), the knob on and the
    taps decomposing as ``a*delta + b*S + d*F``."""
    return mehrstellen_enabled() and decompose_mehrstellen(taps) is not None


def _bc(periodic: bool) -> BoundaryCondition:
    return BoundaryCondition.PERIODIC if periodic else BoundaryCondition.DIRICHLET


def apply_taps_direct_ref(
    u: torch.Tensor, taps: np.ndarray, periodic: bool = False,
    bc_value: float = 0.0, compute_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Plain version of :func:`apply_taps_direct`: ghost pad + the update
    of the route the environment selects (tap chain or Mehrstellen) in
    ``compute_dtype``."""
    return apply_taps_padded(pad_local(u, _bc(periodic), bc_value), taps,
                             mehrstellen=None, compute_dtype=compute_dtype)


def apply_taps_direct2_ref(
    u: torch.Tensor, taps: np.ndarray, periodic: bool = False,
    bc_value: float = 0.0, compute_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Plain version of :func:`apply_taps_direct2`: two plain updates, the
    intermediate held in the storage dtype."""
    mid = apply_taps_direct_ref(u, taps, periodic, bc_value, compute_dtype)
    return apply_taps_direct_ref(mid, taps, periodic, bc_value, compute_dtype)


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


def chain_program(taps: np.ndarray, compute_dtype: torch.dtype = torch.float32) -> _Program:
    """The kernels' emission program of ``taps`` under the current
    factoring knobs, its weights in ``compute_dtype`` (cached per taps,
    knobs and compute dtype)."""
    compute_code(compute_dtype)
    return _program(
        taps.tobytes(),
        os.environ.get("HEAT3D_FACTOR_7PT", ""),
        os.environ.get("HEAT3D_FACTOR_Y", "1"),
        compute_dtype,
    )


@functools.lru_cache(maxsize=64)
def _mehrstellen_program(taps_bytes: bytes, compute_dtype: torch.dtype) -> _Program:
    taps = np.frombuffer(taps_bytes, dtype=np.float64).reshape(3, 3, 3)
    coeffs = decompose_mehrstellen(taps)
    if coeffs is None:
        raise ValueError("the Mehrstellen instance needs taps a*delta + b*S + d*F")
    prog = _Program()
    prog.n = 3
    for i, c in enumerate(coeffs):
        prog.t[i] = _Term(0, 0, 0, compute_weight(c, compute_dtype))
    return prog


def mehrstellen_program(taps: np.ndarray,
                        compute_dtype: torch.dtype = torch.float32) -> _Program:
    """The Mehrstellen instance's arguments in the kernel's program record:
    three entries whose weights are ``decompose_mehrstellen(taps)``'s
    (a, b, d) as :func:`stencil_eager.compute_weight`, the rounding of the
    plain version."""
    compute_code(compute_dtype)
    return _mehrstellen_program(check_taps(taps).tobytes(), compute_dtype)


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


def wave_xchunk(nx: int, tiles: int, resident: int, waves: int = _WAVES,
                min_chunk: int = _MIN_XCHUNK) -> int:
    """x-chunk length of a compile-time launch over ``nx`` planes and
    ``tiles`` (y, z) tiles: x is cut into chunks (each costs 2*halo extra
    plane reads) until the launch holds ``waves`` waves of ``resident``
    blocks (the blocks the card holds at once), with chunks no shorter than
    ``min_chunk`` planes. Many short blocks keep every SM busy to the end
    of the launch; a few long ones leave a last wave on few SMs
    (``scripts/torch_direct_probe.py`` sweeps the chunk count). The fused
    kernels use the same rule with their own waves and floor."""
    if nx < 1:
        return 1
    chunks = max(1, min(-(-waves * resident // max(1, tiles)), -(-nx // min_chunk)))
    return -(-nx // chunks)


@functools.lru_cache(maxsize=None)
def _lib():
    from heat3d_tpu_torch.ops import _build

    lib = _build.load(_LIB)
    lib.heat3d_direct_launch.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_float, ctypes.POINTER(_Program), ctypes.c_void_p,
    ]
    lib.heat3d_direct_launch.restype = ctypes.c_int
    for fn in ("heat3d_direct_tile_y", "heat3d_direct_tile_z"):
        getattr(lib, fn).argtypes = [ctypes.c_int, ctypes.c_int]
        getattr(lib, fn).restype = ctypes.c_int
    for fn in ("heat3d_direct_smem_bytes", "heat3d_direct_blocks_per_sm",
               "heat3d_direct_registers"):
        getattr(lib, fn).argtypes = [ctypes.c_int] * 4
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def direct_instance(taps: np.ndarray) -> int:
    """The kernel instance that runs ``taps`` under the current knobs:
    :data:`MEHRSTELLEN` where :func:`mehrstellen_route` holds, else the
    stream kernels' choice (``stencil_stream.stream_instance``, one table,
    :data:`stencil_stream.CHAINS`), 0 for the generic one."""
    from heat3d_tpu_torch.ops.stencil_stream import stream_instance

    taps = check_taps(taps)
    return MEHRSTELLEN if mehrstellen_route(taps) else stream_instance(taps)


def instance_resources(halo: int, instance: int, dtype: torch.dtype,
                       compute_dtype: torch.dtype = torch.float32) -> dict:
    """Dynamic shared memory (bytes), registers a thread and resident blocks
    per SM of one kernel instance (storage ``dtype``, ``compute_dtype``) on
    the current CUDA device (builds and loads the library; CUDA hosts
    only)."""
    lib = _lib()
    code = (_DTYPE_CODES[dtype], compute_code(compute_dtype))
    return {"smem_bytes": lib.heat3d_direct_smem_bytes(halo, instance, *code),
            "registers": lib.heat3d_direct_registers(halo, instance, *code),
            "blocks_per_sm": lib.heat3d_direct_blocks_per_sm(halo, instance, *code)}


@functools.lru_cache(maxsize=256)
def _launch_xchunk(shape, halo: int, inst: int, device: int, dtype: torch.dtype,
                   compute_dtype: torch.dtype = torch.float32) -> int:
    """The x-chunk of a launch over ``shape``: :func:`wave_xchunk` for a
    compile-time instance, from its resident blocks on ``device``; the
    generic instance keeps the first design's rule (``_xchunk``)."""
    lib = _lib()
    ty, tz = lib.heat3d_direct_tile_y(halo, inst), lib.heat3d_direct_tile_z(halo, inst)
    if inst == 0:
        return _xchunk(shape, ty, tz)
    with torch.cuda.device(device):
        per_sm = lib.heat3d_direct_blocks_per_sm(halo, inst, _DTYPE_CODES[dtype],
                                                 compute_code(compute_dtype))
    if per_sm < 1:
        raise RuntimeError(f"direct instance (halo {halo}, {inst}, {dtype}, compute "
                           f"{compute_dtype}) fits no SM")
    resident = per_sm * torch.cuda.get_device_properties(device).multi_processor_count
    return wave_xchunk(shape[0], -(-shape[1] // ty) * -(-shape[2] // tz), resident)


def _launch(wrapper, halo, u, taps, periodic, bc_value, out,
            instance=None, xchunk=None, compute_dtype=torch.float32) -> torch.Tensor:
    """Launch ``instance`` (default ``direct_instance(taps)``) at ``halo``
    in ``compute_dtype`` with x-chunks of ``xchunk`` planes (default
    ``_launch_xchunk``) and count it on ``wrapper``."""
    if u.device.type != "cuda":
        raise ValueError(f"no kernel for device {u.device}")
    out = check_tensors(u, out)
    if u.data_ptr() % 4:
        # bf16 rows are copied as aligned element pairs
        raise ValueError("field must start on a 4-byte boundary")
    lib = _lib()
    ccode = compute_code(compute_dtype)
    inst = direct_instance(taps) if instance is None else instance
    prog = (mehrstellen_program(taps, compute_dtype) if inst == MEHRSTELLEN
            else chain_program(taps, compute_dtype))
    bc = storage_bc(bc_value, u.dtype)
    nx, ny, nz = u.shape
    if xchunk is None:
        xchunk = _launch_xchunk(tuple(u.shape), halo, inst, u.device.index, u.dtype,
                                compute_dtype)
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        err = lib.heat3d_direct_launch(
            halo, inst, _DTYPE_CODES[u.dtype], ccode, u.data_ptr(), out.data_ptr(),
            nx, ny, nz, xchunk, int(bool(periodic)), bc, ctypes.byref(prog), stream,
        )
    if err != 0:
        raise RuntimeError(
            f"direct-stencil kernel (halo {halo}) launch failed: error {err}"
            + (" (bad arguments)" if err == 1000 else "")
        )
    wrapper.launches += 1
    wrapper.generic_launches += inst == 0
    wrapper.mehrstellen_launches += inst == MEHRSTELLEN
    wrapper.compute_bf16_launches += ccode == 1
    wrapper.compute_bf16_mehrstellen_launches += ccode == 1 and inst == MEHRSTELLEN
    wrapper.cells += out.numel()
    wrapper.mehrstellen_cells += out.numel() if inst == MEHRSTELLEN else 0
    return out


def apply_taps_direct(
    u: torch.Tensor,
    taps: np.ndarray,
    periodic: bool = False,
    bc_value: float = 0.0,
    out: Optional[torch.Tensor] = None,
    compute_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """One explicit-Euler update of the whole (1,1,1)-mesh field: unpadded
    (nx, ny, nz) in, (nx, ny, nz) out in the same dtype (float32 or
    bfloat16 storage; float32 or bfloat16 ``compute_dtype``). ``out``
    (optional, preallocated) must not overlap ``u``."""
    taps = check_taps(taps)
    if u.device.type == "cpu":
        res = apply_taps_direct_ref(u, taps, periodic, bc_value, compute_dtype)
        return res if out is None else out.copy_(res)
    return _launch(apply_taps_direct, 1, u, taps, periodic, bc_value, out,
                   compute_dtype=compute_dtype)


def apply_taps_direct2(
    u: torch.Tensor,
    taps: np.ndarray,
    periodic: bool = False,
    bc_value: float = 0.0,
    out: Optional[torch.Tensor] = None,
    compute_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Two fused updates of the whole (1,1,1)-mesh field in one sweep, the
    intermediate rounded to the storage dtype and its Dirichlet domain
    ghosts pinned to ``bc_value``: equal to two :func:`apply_taps_direct`
    calls."""
    taps = check_taps(taps)
    if u.device.type == "cpu":
        res = apply_taps_direct2_ref(u, taps, periodic, bc_value, compute_dtype)
        return res if out is None else out.copy_(res)
    return _launch(apply_taps_direct2, 2, u, taps, periodic, bc_value, out,
                   compute_dtype=compute_dtype)


def launch_instance(
    halo: int,
    instance: int,
    u: torch.Tensor,
    taps: np.ndarray,
    periodic: bool = False,
    bc_value: float = 0.0,
    out: Optional[torch.Tensor] = None,
    xchunk: Optional[int] = None,
    compute_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """:func:`apply_taps_direct` (halo 1) or :func:`apply_taps_direct2`
    (halo 2) on a named kernel instance, for measurements: the generic
    instance (0) takes any chain, a compile-time one only its own, the
    Mehrstellen one (:data:`MEHRSTELLEN`) only taps that decompose (else
    the launch raises); ``xchunk`` forces the x-chunk length. CUDA tensors
    only; counted on the wrapper as usual."""
    taps = check_taps(taps)
    wrapper = apply_taps_direct if halo == 1 else apply_taps_direct2
    return _launch(wrapper, halo, u, taps, periodic, bc_value, out, instance, xchunk,
                   compute_dtype)


KERNELS = (apply_taps_direct, apply_taps_direct2)


def launch_counts() -> dict:
    return {k.__name__: k.launches for k in KERNELS}


def generic_launch_counts() -> dict:
    return {k.__name__: k.generic_launches for k in KERNELS}


def mehrstellen_launch_counts() -> dict:
    return {k.__name__: k.mehrstellen_launches for k in KERNELS}


def mehrstellen_cell_counts() -> dict:
    return {k.__name__: k.mehrstellen_cells for k in KERNELS}


def compute_bf16_launch_counts() -> dict:
    """Launches of each wrapper in bf16 compute."""
    return {k.__name__: k.compute_bf16_launches for k in KERNELS}


def compute_bf16_mehrstellen_launch_counts() -> dict:
    """Launches of each wrapper on the Mehrstellen instance in bf16 compute."""
    return {k.__name__: k.compute_bf16_mehrstellen_launches for k in KERNELS}


def cell_counts() -> dict:
    return {k.__name__: k.cells for k in KERNELS}


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = k.generic_launches = k.mehrstellen_launches = k.cells = 0
        k.mehrstellen_cells = k.compute_bf16_launches = 0
        k.compute_bf16_mehrstellen_launches = 0


reset_launch_counts()
