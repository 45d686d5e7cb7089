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
  dtype and, under Dirichlet, pinned to ``bc_value`` beyond the domain
  faces the block touches (``edges``; a shard inside the mesh keeps its
  neighbours' ring values, as the JAX kernel pins at domain-edge shards
  only);
  :func:`apply_taps_stream2` is its k=2 form (``apply_taps_pallas_stream2``).

For a CUDA tensor each wrapper launches its hand-written kernel from
``csrc/stencil_stream.cu`` (built on first use by ``ops._build``) or
raises; for a CPU tensor it runs the kernel's plain version:
``stencil_eager.apply_taps_padded`` for the stream kernel, and
:func:`apply_taps_streamk_ref` (k ``apply_taps_padded`` applications with
the pins between, ``parallel.step._local_stepk``'s arithmetic on the padded
block) for streamk. On the same device the kernels equal their plain
versions bitwise. The tap chain is ``stencil_direct``'s emission program.

The kernel source has an instance with the chain fixed at compile time for
each entry of :data:`CHAINS` (the build passes the table to ``nvcc``), and
a generic instance that interprets any other program;
:func:`stream_instance` picks one by comparing the emission program's
``(src, row, dk)`` sequence with the table.

Every instance runs in either compute dtype (``compute_dtype``: float32,
or bf16 with each field read and each multiply and add rounded to bf16),
as ``stencil_direct``'s: a compile-time instance of its own for each
``CHAINS`` entry, the generic one by a flag of its program.

Each wrapper counts its kernel launches in ``<wrapper>.launches``
(``apply_taps_stream2`` counts as ``apply_taps_streamk``, whose kernel it
launches), the launches that took the generic instance in
``<wrapper>.generic_launches``, those in bf16 compute in
``<wrapper>.compute_bf16_launches`` and the output cells it computed in
``<wrapper>.cells``; ``reset_launch_counts`` zeroes them.

Under ``HEAT3D_MEHRSTELLEN`` these kernels run the tap chain, as the JAX
package's windowed stream/streamk kernels do (they have no Mehrstellen
form), and so do their plain versions (``mehrstellen=False``).
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import Optional

import numpy as np
import torch

from heat3d_tpu_torch.ops.stencil_direct import (
    _DTYPE_CODES,
    _Program,
    _xchunk,
    chain_program,
    check_taps,
    check_tensors,
    compute_code,
    emission_program,
    storage_bc,
)
from heat3d_tpu_torch.ops.stencil_eager import apply_taps_padded, pin_outside

_LIB = "stencil_stream"
STREAMK_DEPTHS = (2, 3, 4)
# The emission programs with an instance of their own in the kernel source,
# as (src, row, dk) in emission order (``emission_program``'s fields; src
# 0/1/2 plane x-1/x/x+1, 3 their sum; row 0/1/2 y-1/y/y+1, 3 the sum of
# y-1 and y+1), keyed by the instance's code in the kernel's interface.
# The build passes each to nvcc (``nvcc_defines``); code 0 is the generic
# instance, which interprets any program.
CHAINS = {
    # the 7pt stencil's plain lexicographic chain
    1: ("7pt", ((0, 1, 0), (1, 0, 0), (1, 1, -1), (1, 1, 0), (1, 1, 1),
                (1, 2, 0), (2, 1, 0))),
    # the 27pt stencil's x- and y-factored chain: the x-sum plane's y-sum
    # row and middle row, then the middle plane's
    2: ("27pt", tuple((s, r, dk) for s, r in ((3, 3), (3, 1), (1, 3), (1, 1))
                      for dk in (-1, 0, 1))),
}
GENERIC = 0
_MACROS = {1: "HEAT3D_CHAIN_7PT", 2: "HEAT3D_CHAIN_27PT"}
# a block that is the whole domain touches all six domain faces
ALL_EDGES = (True,) * 6


def edge_bits(edges) -> int:
    """The kernel's 6-bit mask of (x_lo, x_hi, y_lo, y_hi, z_lo, z_hi)."""
    if len(edges) != 6:
        raise ValueError(f"edges must be 6 flags (x_lo .. z_hi), got {edges}")
    return sum(1 << i for i, e in enumerate(edges) if e)


def apply_taps_streamk_ref(
    upk: torch.Tensor, taps: np.ndarray, k: int, periodic: bool = False,
    bc_value: float = 0.0, edges=ALL_EDGES, compute_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Plain version of :func:`apply_taps_streamk`: k ``apply_taps_padded``
    applications of the tap chain in ``compute_dtype`` (under the
    Mehrstellen knob too, as the kernel) over the width-k padded block,
    each but the last rounded
    to the storage dtype (``apply_taps_padded`` returns it) and, under
    Dirichlet, pinned to ``bc_value`` wherever its block index (padded
    index - k) lies outside [0, n) beyond a domain face the block touches
    (``edges``)."""
    interior = [n - 2 * k for n in upk.shape]
    cur = upk
    for j in range(1, k + 1):
        cur = apply_taps_padded(cur, taps, mehrstellen=False, compute_dtype=compute_dtype)
        r = k - j  # ghost rings cur still carries
        if r > 0 and not periodic:
            idx = [torch.arange(-r, n + r, device=cur.device) for n in interior]
            cur = pin_outside(cur, idx, interior, bc_value, edges)
    return cur


def nvcc_defines() -> tuple:
    """The ``-D`` flags that give the kernel source :data:`CHAINS`: each
    chain as one string literal of three digits a term, ``src``, ``row``
    and ``dk + 1`` (nvcc splits a ``-D`` value at commas)."""
    return tuple(
        f'-D{_MACROS[code]}="' + "".join(f"{s}{r}{dk + 1}" for s, r, dk in chain) + '"'
        for code, (_, chain) in sorted(CHAINS.items())
    )


def chain_sequence(taps: np.ndarray) -> tuple:
    """``emission_program(taps)``'s ``(src, row, dk)`` sequence under the
    current factoring knobs."""
    return tuple((s, r, dk) for s, r, dk, _ in emission_program(taps))


@functools.lru_cache(maxsize=64)
def _instance(taps_bytes: bytes, factor_7pt: str, factor_y: str) -> int:
    # the knobs are part of the key, as for stencil_direct.chain_program
    taps = np.frombuffer(taps_bytes, dtype=np.float64).reshape(3, 3, 3)
    seq = chain_sequence(taps)
    for code, (_, chain) in CHAINS.items():
        if seq == chain:
            return code
    return GENERIC


def stream_instance(taps: np.ndarray) -> int:
    """The kernel instance that runs ``taps`` under the current factoring
    knobs: the code of the :data:`CHAINS` entry whose sequence equals the
    emission program's, else :data:`GENERIC`."""
    taps = check_taps(taps)
    return _instance(
        taps.tobytes(),
        os.environ.get("HEAT3D_FACTOR_7PT", ""),
        os.environ.get("HEAT3D_FACTOR_Y", "1"),
    )


@functools.lru_cache(maxsize=None)
def _lib():
    from heat3d_tpu_torch.ops import _build

    lib = _build.load(_LIB)
    lib.heat3d_stream_launch.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.POINTER(_Program),
        ctypes.c_void_p,
    ]
    lib.heat3d_stream_launch.restype = ctypes.c_int
    for fn in ("heat3d_stream_tile_y", "heat3d_stream_tile_z"):
        getattr(lib, fn).argtypes = [ctypes.c_int, ctypes.c_int]
        getattr(lib, fn).restype = ctypes.c_int
    for fn in ("heat3d_stream_smem_bytes", "heat3d_stream_blocks_per_sm",
               "heat3d_stream_registers"):
        getattr(lib, fn).argtypes = [ctypes.c_int] * 4
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def instance_resources(k: int, instance: int, dtype: torch.dtype,
                       compute_dtype: torch.dtype = torch.float32) -> dict:
    """Dynamic shared memory (bytes), registers a thread and resident
    blocks per SM of one kernel instance (storage ``dtype``,
    ``compute_dtype``) on the current CUDA device (builds and loads the
    library; CUDA hosts only)."""
    lib = _lib()
    code = (_DTYPE_CODES[dtype], compute_code(compute_dtype))
    return {"smem_bytes": lib.heat3d_stream_smem_bytes(k, instance, *code),
            "registers": lib.heat3d_stream_registers(k, instance, *code),
            "blocks_per_sm": lib.heat3d_stream_blocks_per_sm(k, instance, *code)}


def _interior(up: torch.Tensor, k: int):
    if up.dim() != 3:
        raise ValueError(f"padded field must be 3-D, got shape {tuple(up.shape)}")
    shape = tuple(n - 2 * k for n in up.shape)
    if min(shape) < 1:
        raise ValueError(
            f"padded field {tuple(up.shape)} has no interior at width {k}"
        )
    return shape


def _launch(wrapper, k, up, taps, periodic, bc_value, out,
            edges=ALL_EDGES, compute_dtype=torch.float32) -> torch.Tensor:
    """Launch instance ``stream_instance(taps)`` at depth k in
    ``compute_dtype`` and count it on ``wrapper``."""
    if up.device.type != "cuda":
        raise ValueError(f"no kernel for device {up.device}")
    shape = _interior(up, k)
    out = check_tensors(up, out, shape)
    if up.data_ptr() % 4:
        # bf16 rows are copied as aligned element pairs
        raise ValueError("padded field must start on a 4-byte boundary")
    lib = _lib()
    ccode = compute_code(compute_dtype)
    prog = chain_program(taps, compute_dtype)
    inst = stream_instance(taps)
    bc = storage_bc(bc_value, up.dtype)
    xchunk = _xchunk(shape, lib.heat3d_stream_tile_y(k, inst),
                     lib.heat3d_stream_tile_z(k, inst))
    with torch.cuda.device(up.device):
        stream = torch.cuda.current_stream(up.device).cuda_stream
        err = lib.heat3d_stream_launch(
            k, inst, _DTYPE_CODES[up.dtype], ccode, up.data_ptr(), out.data_ptr(),
            *shape, xchunk, int(bool(periodic)), bc, edge_bits(edges),
            ctypes.byref(prog), stream,
        )
    if err != 0:
        raise RuntimeError(
            f"stream kernel (k={k}) launch failed: error {err}"
            + (" (bad arguments)" if err == 1000 else "")
        )
    wrapper.launches += 1
    wrapper.generic_launches += inst == GENERIC
    wrapper.compute_bf16_launches += ccode == 1
    wrapper.cells += out.numel()
    return out


def apply_taps_stream(
    up: torch.Tensor, taps: np.ndarray, out: Optional[torch.Tensor] = None,
    compute_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """One update from a ghost-padded block: (nx+2, ny+2, nz+2) in,
    (nx, ny, nz) out in the same dtype (float32 or bfloat16 storage;
    float32 or bfloat16 ``compute_dtype``). ``out`` (optional,
    preallocated) must not overlap ``up``."""
    taps = check_taps(taps)
    if up.device.type == "cpu":
        _interior(up, 1)
        res = apply_taps_padded(up, taps, mehrstellen=False, compute_dtype=compute_dtype)
        return res if out is None else out.copy_(res)
    return _launch(apply_taps_stream, 1, up, taps, False, 0.0, out,
                   compute_dtype=compute_dtype)


def apply_taps_streamk(
    upk: torch.Tensor,
    taps: np.ndarray,
    k: int,
    periodic: bool = False,
    bc_value: float = 0.0,
    out: Optional[torch.Tensor] = None,
    edges=ALL_EDGES,
    compute_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """k = 2..4 fused updates from a width-k ghost-padded block:
    (nx+2k, ny+2k, nz+2k) in, the (nx, ny, nz) interior after k updates
    out, equal to :func:`apply_taps_streamk_ref`. The ghosts must come from
    the exchange (``parallel.halo``): under periodic boundaries they are
    the wrap, which the kernel does not make. ``edges`` are the domain
    faces the block touches (a shard's ``Shard.edges``; all six for a
    whole-domain block)."""
    if k not in STREAMK_DEPTHS:
        raise ValueError(f"streamk kernel wants k in {STREAMK_DEPTHS}, got {k}")
    taps = check_taps(taps)
    edge_bits(edges)
    if upk.device.type == "cpu":
        _interior(upk, k)
        res = apply_taps_streamk_ref(upk, taps, k, periodic, bc_value, edges,
                                     compute_dtype)
        return res if out is None else out.copy_(res)
    return _launch(apply_taps_streamk, k, upk, taps, periodic, bc_value, out, edges,
                   compute_dtype)


def apply_taps_stream2(
    up2: torch.Tensor,
    taps: np.ndarray,
    periodic: bool = False,
    bc_value: float = 0.0,
    out: Optional[torch.Tensor] = None,
    compute_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Two fused updates from a width-2 padded block: the k=2 instance of
    :func:`apply_taps_streamk` (counterpart of ``apply_taps_pallas_stream2``)."""
    return apply_taps_streamk(up2, taps, 2, periodic, bc_value, out=out,
                              compute_dtype=compute_dtype)


KERNELS = (apply_taps_stream, apply_taps_streamk)


def launch_counts() -> dict:
    return {k.__name__: k.launches for k in KERNELS}


def generic_launch_counts() -> dict:
    return {k.__name__: k.generic_launches for k in KERNELS}


def cell_counts() -> dict:
    return {k.__name__: k.cells for k in KERNELS}


def compute_bf16_launch_counts() -> dict:
    """Launches of each wrapper in bf16 compute."""
    return {k.__name__: k.compute_bf16_launches for k in KERNELS}


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = k.generic_launches = k.cells = k.compute_bf16_launches = 0


reset_launch_counts()


def make_stream_compute(cfg):
    """The exchange path's padded-block compute through the stream kernel,
    ``(up, taps, out=None) -> interior``: counterpart of
    ``make_pallas_compute(cfg)``. The kernel reads the shape and the
    storage dtype from the block; ``cfg`` gives the compute dtype."""
    compute_dtype = getattr(torch, cfg.precision.compute)

    def compute(up: torch.Tensor, taps: np.ndarray, out=None) -> torch.Tensor:
        return apply_taps_stream(up, taps, out=out, compute_dtype=compute_dtype)

    return compute
