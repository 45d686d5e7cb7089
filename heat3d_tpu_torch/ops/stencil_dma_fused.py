"""Fused DMA-overlap stencil kernels: the x-face pushes to the ring
neighbours, the interior sweep while they fly, and the skin planes after
the waits, in one kernel.

Port of ``heat3d_tpu.ops.stencil_dma_fused`` (``apply_step_fused_dma``,
``apply_superstep_fused_dma``, the gates ``fused_dma_supported`` /
``fused_dma_3d_supported`` / ``fused_dma2_supported`` and
``substitute_dirichlet_x_edges``). For CUDA shards each wrapper launches a
hand-written kernel from ``csrc/stencil_fused.cu`` (built on first use by
``ops._build``), one cooperative launch per device over every shard the
device holds, or raises; for CPU shards it
runs the kernels' plain version, :func:`reference_fused_step` /
:func:`reference_fused_superstep` (the JAX ``reference_fused_step_xla`` /
``reference_fused_superstep_xla``): a ring shift of the x faces from the
neighbouring shards, bc substituted at Dirichlet x domain faces, the
(nx+2w, ny, nz) stack padded in y/z as a domain boundary (wrap or bc), and
``apply_taps_padded`` with the tap chain. On the same device the kernels
equal their plain versions bitwise. Under ``HEAT3D_MEHRSTELLEN`` the
kernels and their plain versions keep the tap chain, as the JAX fused
kernels do.

Scope (the JAX gates' shape rules): a mesh sharded along x (>= 2 shards)
and along nothing else (the slab kernels) or also along y or z (the 3D
route, whose caller patches the y/z shells); nx >= 2 (one update) or
nx >= 4 (two); unpadded shards, the kernel backend and axis ordering are
the dispatch gate's part (``parallel.step``). The JAX gates also reject
a shard whose resident ghost planes and plane ring do not fit the TPU's
VMEM (``_fused_choose_chunk``, ``_GHOST_BUDGET``): the CUDA kernel tiles
(y, z) and keeps the ghost planes in device memory, so it has no such
limit, and the port's gates accept every shape the rules above allow.

Each kernel (one update or two) has an instance with the chain fixed at
compile time for each entry of the stream kernels' table
(``stencil_stream.CHAINS``: ``fused_chain_kernel<T, H, S>``, the direct
kernel's sweep over the shard's planes and the landing buffers) and a
generic instance that interprets any other program (``fused_kernel<T, H>``,
the first design); ``stencil_stream.stream_instance`` picks one, as for
the direct and stream kernels, and :func:`launch_instance` forces one for
a measurement. A launch error raises: no launch falls back to another
instance.

The landing buffers, flag words, arrival counters, device tables and epoch
live in a :class:`FusedState`, one per (mesh, width, send ranges, storage
dtype, boundary), built and zeroed on the stream its kernels run on.

Each instance runs in either compute dtype (``compute_dtype``: float32,
or bf16 with each field read and each multiply and add rounded to bf16),
as ``stencil_direct``'s: the compile-time instances have one of their own
(``fused_chain_kernel<T, H, S, Bf16Math>``), the generic one takes a flag
of its program.

``<wrapper>.launches`` counts launches (one per device and call),
``<wrapper>.cells`` their output cells, ``<wrapper>.generic_launches``
the launches that took the generic instance and
``<wrapper>.compute_bf16_launches`` those in bf16 compute;
``launch_counts``, ``generic_launch_counts`` and
``compute_bf16_launch_counts`` report them.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from heat3d_tpu_torch.ops.halo_dma import device_table, enable_peer_access
from heat3d_tpu_torch.ops.stencil_direct import (
    _DTYPE_CODES,
    _Program,
    chain_program,
    check_taps,
    compute_code,
    storage_bc,
)
from heat3d_tpu_torch.ops.stencil_direct import wave_xchunk as _direct_wave_xchunk
from heat3d_tpu_torch.ops.stencil_eager import apply_taps_padded
from heat3d_tpu_torch.ops.stencil_stream import GENERIC, stream_instance

_LIB = "stencil_fused"
# a wait that has not seen its neighbours' pushes after this long traps
TIMEOUT_NS = 2_000_000_000
# the generic instance: interior tiles a launch aims for (x is cut into
# chunks below that)
_TARGET_TILES = 4096
_MIN_XCHUNK = 16
# the compile-time instances: waves of resident blocks the interior tiles
# aim for, by halo, with chunks no shorter than _MIN_CHAIN_XCHUNK planes
# (``wave_xchunk``)
_WAVES = {1: 48, 2: 24}
_MIN_CHAIN_XCHUNK = 16
_ERRORS = {1000: "bad arguments", 1002: "no cooperative launch on this device",
           1003: "no block fits an SM"}


class _Shard(ctypes.Structure):
    _fields_ = [
        ("glo", ctypes.c_void_p),
        ("ghi", ctypes.c_void_p),
        ("flags", ctypes.c_void_p),
        ("nparts", ctypes.c_int),
        ("wait_lo", ctypes.c_int),
        ("wait_hi", ctypes.c_int),
        ("rank", ctypes.c_int),
    ]


class _Send(ctypes.Structure):
    _fields_ = [
        ("dst", ctypes.c_void_p),
        ("flag", ctypes.c_void_p),
        ("counter", ctypes.c_void_p),
        ("shard", ctypes.c_int),
        ("x0", ctypes.c_int),
        ("y0", ctypes.c_int),
        ("y1", ctypes.c_int),
        ("tile0", ctypes.c_int),
        ("ntiles", ctypes.c_int),
    ]


MAX_LOCAL = 16
MAX_PARTS = 8


class _Args(ctypes.Structure):
    _fields_ = [
        ("u", ctypes.c_void_p * MAX_LOCAL),
        ("out", ctypes.c_void_p * MAX_LOCAL),
        ("shards", ctypes.c_void_p),
        ("sends", ctypes.c_void_p),
        ("epoch", ctypes.c_ulonglong),
        ("timeout_ns", ctypes.c_longlong),
        ("nlocal", ctypes.c_int),
        ("nsends", ctypes.c_int),
        ("push_tiles", ctypes.c_int),
        ("nx", ctypes.c_int),
        ("ny", ctypes.c_int),
        ("nz", ctypes.c_int),
        ("xchunk", ctypes.c_int),
        ("periodic", ctypes.c_int),
        ("bc", ctypes.c_float),
        ("prog", _Program),
    ]


@functools.lru_cache(maxsize=None)
def _lib():
    from heat3d_tpu_torch.ops import _build

    lib = _build.load(_LIB)
    for fn in ("heat3d_fused_init", "heat3d_fused_max_local", "heat3d_fused_max_parts",
               "heat3d_fused_push_chunk", "heat3d_fused_args_bytes",
               "heat3d_fused_shard_bytes", "heat3d_fused_send_bytes"):
        getattr(lib, fn).argtypes = []
        getattr(lib, fn).restype = ctypes.c_int
    for fn in ("heat3d_fused_tile_y", "heat3d_fused_tile_z"):
        getattr(lib, fn).argtypes = [ctypes.c_int] * 2
        getattr(lib, fn).restype = ctypes.c_int
    for fn in ("heat3d_fused_blocks_per_sm", "heat3d_fused_registers",
               "heat3d_fused_smem_bytes"):
        getattr(lib, fn).argtypes = [ctypes.c_int] * 4
        getattr(lib, fn).restype = ctypes.c_int
    lib.heat3d_fused_error.argtypes = []
    lib.heat3d_fused_error.restype = ctypes.c_uint
    lib.heat3d_fused_launch.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.POINTER(_Args),
        ctypes.c_void_p]
    lib.heat3d_fused_launch.restype = ctypes.c_int
    layout = {
        "max_local": (lib.heat3d_fused_max_local(), MAX_LOCAL),
        "max_parts": (lib.heat3d_fused_max_parts(), MAX_PARTS),
        "args": (lib.heat3d_fused_args_bytes(), ctypes.sizeof(_Args)),
        "shard": (lib.heat3d_fused_shard_bytes(), ctypes.sizeof(_Shard)),
        "send": (lib.heat3d_fused_send_bytes(), ctypes.sizeof(_Send)),
    }
    bad = {k: v for k, v in layout.items() if v[0] != v[1]}
    if bad:
        raise RuntimeError(f"fused kernel: library layout differs from the wrapper's: {bad}")
    err = lib.heat3d_fused_init()
    if err != 0:
        raise RuntimeError(f"fused kernel: error word allocation failed: error {err}")
    return lib


def instance_resources(halo: int, instance: int, dtype: torch.dtype,
                       compute_dtype: torch.dtype = torch.float32) -> dict:
    """Resident blocks per SM (the cooperative grid is this times the SM
    count), registers a thread and dynamic shared memory (bytes) of one
    instance of the fused kernel of ``halo`` updates (storage ``dtype``,
    ``compute_dtype``) on the current CUDA device: ``instance`` 0 the
    interpreted kernel, else a compile-time chain. CUDA hosts only."""
    lib = _lib()
    code = (_DTYPE_CODES[dtype], compute_code(compute_dtype))
    return {"blocks_per_sm": lib.heat3d_fused_blocks_per_sm(halo, instance, *code),
            "registers": lib.heat3d_fused_registers(halo, instance, *code),
            "smem_bytes": lib.heat3d_fused_smem_bytes(halo, instance, *code)}


def fused_instance(halo: int, taps: np.ndarray) -> int:
    """The instance a launch of ``halo`` (1 or 2) updates takes under the
    current factoring knobs: ``stream_instance(taps)``, 0 (the generic
    instance) for a chain outside ``CHAINS``."""
    return stream_instance(taps)


def raise_if_timed_out() -> None:
    """Raise if a fused kernel's wait has timed out (its neighbours' pushes
    never signalled); the trap it took also fails the next synchronisation."""
    code = _lib().heat3d_fused_error()
    if code:
        c = code - 1
        side = "low" if c % 2 == 0 else "high"
        raise RuntimeError(
            f"fused halo wait timed out: shard {c // 2}, {side} x ghost (no "
            f"signal within {TIMEOUT_NS / 1e9:.0f} s)"
        )


# ---- gates -----------------------------------------------------------------


def _x_slab(mesh_shape) -> bool:
    return mesh_shape[0] >= 2 and mesh_shape[1] == 1 and mesh_shape[2] == 1


def fused_dma_supported(local_shape, mesh_shape, taps=None, in_itemsize: int = 4,
                        out_itemsize: int = 4, compute_itemsize: int = 4) -> bool:
    """The one-update slab kernel's shape scope: an x-slab mesh (>= 2
    shards along x, none along y or z) and nx >= 2, for any 3x3x3 taps (an
    x-slab has no corner neighbours: the landed plane is the whole
    neighbour data, its y/z frame a domain boundary). The itemsizes are the
    JAX gate's arguments; the card has no VMEM budget to hold them to (see
    the module docstring)."""
    return local_shape[0] >= 2 and _x_slab(mesh_shape)


def fused_dma_3d_supported(local_shape, mesh_shape, taps=None, in_itemsize: int = 4,
                           out_itemsize: int = 4, compute_itemsize: int = 4) -> bool:
    """The 3D route's scope: a mesh sharded along x (>= 2) and along y or
    z, nx >= 2; the slab scope stays with :func:`fused_dma_supported`, so
    the two routes exclude each other."""
    return (local_shape[0] >= 2 and mesh_shape[0] >= 2
            and (mesh_shape[1] > 1 or mesh_shape[2] > 1))


def fused_dma2_supported(local_shape, mesh_shape, taps=None, in_itemsize: int = 4,
                         out_itemsize: int = 4, compute_itemsize: int = 4) -> bool:
    """The two-update slab kernel's scope: an x-slab mesh and nx >= 4 (the
    epilogue reads planes 0..3 and nx-4..nx-1 as distinct planes)."""
    return local_shape[0] >= 4 and _x_slab(mesh_shape)


# ---- plain versions --------------------------------------------------------


def substitute_dirichlet_x_edges(glo, ghi, shard, periodic: bool, bc_value: float):
    """The read side of the ghost-landing contract: at a Dirichlet x domain
    face the ghost is ``bc_value`` (rounded to storage) whatever landed;
    periodic rings pass through (the wrap is genuine data)."""
    if periodic:
        return glo, ghi
    if shard.edges[0]:
        glo = torch.full_like(glo, bc_value)
    if shard.edges[1]:
        ghi = torch.full_like(ghi, bc_value)
    return glo, ghi


def ring_ghosts(us: Sequence[torch.Tensor], mesh, width: int, periodic: bool,
                bc_value: float) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Per shard (rank order) its x ghost slabs ``(glo, ghi)``, each
    (width, ny, nz): the ring neighbours' faces (the torus transfer always
    runs), bc at Dirichlet x domain faces."""
    res = []
    for s in mesh.shards:
        lo = mesh.neighbor(s, 0, -1, True)
        hi = mesh.neighbor(s, 0, +1, True)
        nx = us[lo.rank].shape[0]
        glo = us[lo.rank][nx - width:].to(us[s.rank].device)
        ghi = us[hi.rank][:width].to(us[s.rank].device)
        res.append(substitute_dirichlet_x_edges(glo, ghi, s, periodic, bc_value))
    return res


def _pad_yz(stack: torch.Tensor, periodic: bool, bc_value: float) -> torch.Tensor:
    """Pad y and z by one as a domain boundary: wrap, or bc."""
    if periodic:
        stack = torch.cat([stack[:, -1:], stack, stack[:, :1]], 1)
        return torch.cat([stack[:, :, -1:], stack, stack[:, :, :1]], 2)
    return torch.nn.functional.pad(stack, (1, 1, 1, 1), mode="constant", value=bc_value)


def reference_fused_step(us: Sequence[torch.Tensor], taps: np.ndarray, mesh,
                         periodic: bool = False, bc_value: float = 0.0,
                         return_ghosts: bool = False,
                         compute_dtype: torch.dtype = torch.float32):
    """Plain version of :func:`apply_step_fused_dma`: per shard the ring
    ghosts (:func:`ring_ghosts`), the (nx+2, ny, nz) stack padded in y/z
    as a domain boundary, and the tap chain in ``compute_dtype`` (under
    the Mehrstellen knob too: the fused kernels, as the JAX ones, have no
    Mehrstellen form). With ``return_ghosts`` also the landed (ny, nz)
    planes per shard, bc substituted."""
    ghosts = ring_ghosts(us, mesh, 1, periodic, bc_value)
    outs = [apply_taps_padded(_pad_yz(torch.cat([glo, u, ghi]), periodic, bc_value), taps,
                              mehrstellen=False, compute_dtype=compute_dtype)
            for u, (glo, ghi) in zip(us, ghosts)]
    if return_ghosts:
        return outs, [(glo[0], ghi[0]) for glo, ghi in ghosts]
    return outs


def reference_fused_superstep(us: Sequence[torch.Tensor], taps: np.ndarray, mesh,
                              periodic: bool = False, bc_value: float = 0.0,
                              compute_dtype: torch.dtype = torch.float32):
    """Plain version of :func:`apply_superstep_fused_dma`: two plain steps
    (the intermediate held in the storage dtype)."""
    for _ in range(2):
        us = reference_fused_step(us, taps, mesh, periodic, bc_value,
                                  compute_dtype=compute_dtype)
    return us


# ---- the state -------------------------------------------------------------


def check_bounds(bounds, ny: int) -> Tuple[Tuple[int, int], ...]:
    """The send ranges: contiguous, non-empty, tiling [0, ny)."""
    bounds = tuple((int(a), int(b)) for a, b in bounds)
    if not 1 <= len(bounds) <= MAX_PARTS:
        raise ValueError(f"{len(bounds)} send ranges (want 1..{MAX_PARTS})")
    at = 0
    for a, b in bounds:
        if a != at or b <= a:
            raise ValueError(f"send ranges {bounds} do not tile [0, {ny})")
        at = b
    if at != ny:
        raise ValueError(f"send ranges {bounds} do not tile [0, {ny})")
    return bounds


class _Group:
    """The shards of one device: one launch, on ``stream``."""

    def __init__(self, device, shards):
        self.device = device
        self.shards = shards
        self.stream = shards[0].stream or torch.cuda.current_stream(device)
        self.entered = torch.cuda.Event()
        self.targets = []  # the other groups this one pushes into
        self.table = self.sends = self.counters = None
        self.nsends = self.push_tiles = 0


class FusedState:
    """The protocol state of one fused route: per shard two landing buffers
    (``width`` x ny x nz, storage dtype) and 2 x MAX_PARTS flag words (the
    low and high ghost's, one per send range); per device its launch
    stream (its first shard's), the arrival counters (one per send), the
    shard and send tables in device memory and an "entered" event; and the
    epoch. Everything is zeroed on the stream the kernels run on, so a
    state built mid-run, while the shard streams are busy, is zeroed before
    any kernel of it signals. On CPU shards the plain version needs none of
    it."""

    def __init__(self, mesh, width: int, dtype: torch.dtype, periodic: bool,
                 bounds=None):
        if width not in (1, 2):
            raise ValueError(f"fused kernels take width 1 or 2, got {width}")
        if mesh.shape[0] < 2:
            raise ValueError(f"fused kernels need >= 2 shards along x, mesh {mesh.shape}")
        nx, ny, nz = mesh.local_shape
        self.mesh = mesh
        self.width = width
        self.dtype = dtype
        self.periodic = bool(periodic)
        self.bounds = check_bounds(bounds or ((0, ny),), ny)
        self.epoch = 0
        self.groups: List[_Group] = []
        self.glo, self.ghi, self.flags = {}, {}, {}
        if any(s.device.type == "cuda" for s in mesh.shards):
            self._build()

    def _build(self) -> None:
        lib = _lib()
        chunk = lib.heat3d_fused_push_chunk()
        mesh, w = self.mesh, self.width
        nx, ny, nz = mesh.local_shape
        by_dev = {}
        for s in mesh.shards:
            if s.device.type != "cuda":
                raise ValueError("fused kernels: every shard on CUDA, or every shard on the CPU")
            by_dev.setdefault(s.device, []).append(s)
        for dev, shards in by_dev.items():
            if len(shards) > MAX_LOCAL:
                raise ValueError(
                    f"fused kernels: {len(shards)} shards on {dev}, at most {MAX_LOCAL}")
            self.groups.append(_Group(dev, shards))
        if len(self.groups) > 1:
            enable_peer_access(mesh.devices)
        group_of = {}
        for g in self.groups:
            with torch.cuda.device(g.device), torch.cuda.stream(g.stream):
                for s in g.shards:
                    group_of[s.rank] = g
                    self.glo[s.rank] = torch.zeros((w, ny, nz), dtype=self.dtype, device=g.device)
                    self.ghi[s.rank] = torch.zeros((w, ny, nz), dtype=self.dtype, device=g.device)
                    self.flags[s.rank] = torch.zeros(2 * MAX_PARTS, dtype=torch.int64,
                                                     device=g.device)
        word = 8
        for g in self.groups:
            sends, shards = [], []
            for li, s in enumerate(g.shards):
                nb_lo = mesh.neighbor(s, 0, -1, self.periodic)
                nb_hi = mesh.neighbor(s, 0, +1, self.periodic)
                shards.append(_Shard(self.glo[s.rank].data_ptr(), self.ghi[s.rank].data_ptr(),
                                     self.flags[s.rank].data_ptr(), len(self.bounds),
                                     int(nb_lo is not None), int(nb_hi is not None), s.rank))
                # my high face lands as the high neighbour's low ghost (its
                # side 0), my low face as the low neighbour's high ghost
                for nb, x0, side in ((nb_hi, nx - w, 0), (nb_lo, 0, 1)):
                    if nb is None:
                        continue
                    if group_of[nb.rank] is not g and group_of[nb.rank] not in g.targets:
                        g.targets.append(group_of[nb.rank])
                    dst = (self.glo if side == 0 else self.ghi)[nb.rank]
                    for p, (a, b) in enumerate(self.bounds):
                        sends.append([dst.data_ptr(),
                                      self.flags[nb.rank].data_ptr()
                                      + (side * MAX_PARTS + p) * word,
                                      li, x0, a, b, -(-(w * (b - a) * nz) // chunk)])
            with torch.cuda.device(g.device), torch.cuda.stream(g.stream):
                g.counters = torch.zeros(max(1, len(sends)), dtype=torch.int32,
                                         device=g.device)
                table = (_Send * max(1, len(sends)))()
                tile0 = 0
                for i, (dst, flag, li, x0, a, b, ntiles) in enumerate(sends):
                    table[i] = _Send(dst, flag, g.counters.data_ptr() + 4 * i,
                                     li, x0, a, b, tile0, ntiles)
                    tile0 += ntiles
                g.nsends, g.push_tiles = len(sends), tile0
                g.sends = device_table(table, g.device)
                g.table = device_table((_Shard * len(shards))(*shards), g.device)


# ---- launch ----------------------------------------------------------------


def _check(us, outs, mesh, state: FusedState):
    shape = tuple(mesh.local_shape)
    if len(us) != len(mesh):
        raise ValueError(f"{len(us)} shards for a mesh of {len(mesh)}")
    if outs is not None and len(outs) != len(mesh):
        raise ValueError(f"{len(outs)} outputs for a mesh of {len(mesh)}")
    for s in mesh.shards:
        u = us[s.rank]
        if tuple(u.shape) != shape or u.dtype != state.dtype or u.device != s.device:
            raise ValueError(
                f"shard {s.rank}: want {shape} {state.dtype} on {s.device}, got "
                f"{tuple(u.shape)} {u.dtype} {u.device}")
        if u.dtype not in _DTYPE_CODES or not u.is_contiguous():
            raise ValueError("shards must be contiguous float32 or bfloat16")
        if u.data_ptr() % 4:
            # bf16 rows are copied as aligned element pairs
            raise ValueError("shards must start on a 4-byte boundary")
        if outs is not None:
            o = outs[s.rank]
            if (tuple(o.shape) != shape or o.dtype != u.dtype or o.device != u.device
                    or not o.is_contiguous()):
                raise ValueError(f"out of shard {s.rank} must match its field")
            for x in us:
                if (x.device == o.device and x.data_ptr() < o.data_ptr() + o.nbytes
                        and o.data_ptr() < x.data_ptr() + x.nbytes):
                    raise ValueError("an output overlaps a field: the kernel "
                                     "reads neighbours, so it cannot update in place")


def _xchunk(inner: int, tiles_yz: int) -> int:
    """Interior x-chunk length of the interpreted kernels: enough interior
    tiles to fill the card."""
    if inner < 1:
        return 1
    chunks = max(1, min(-(-_TARGET_TILES // max(1, tiles_yz)), -(-inner // _MIN_XCHUNK)))
    return -(-inner // chunks)


# interior x-chunk length of a compile-time instance over ``inner`` planes
# and ``tiles_yz`` (y, z) tiles over all shards of the launch: the direct
# kernels' rule at the fused kernels' floor and their waves (``waves=``,
# ``_WAVES`` of the halo; the grid's blocks take the tiles in a fixed
# stride, so the last wave is as uneven as one tile in a block's share)
wave_xchunk = functools.partial(_direct_wave_xchunk, min_chunk=_MIN_CHAIN_XCHUNK)


@functools.lru_cache(maxsize=256)
def _launch_xchunk(halo: int, instance: int, local_shape, nlocal: int, device: int,
                   dtype: torch.dtype, compute_dtype: torch.dtype = torch.float32) -> int:
    """The interior x-chunk of a launch: :func:`wave_xchunk` from the
    compile-time instance's resident blocks on ``device``; the interpreted
    kernels keep the first design's rule (``_xchunk``)."""
    lib = _lib()
    nx, ny, nz = local_shape
    tiles_yz = nlocal * -(-ny // lib.heat3d_fused_tile_y(halo, instance)) * \
        -(-nz // lib.heat3d_fused_tile_z(halo, instance))
    if instance == GENERIC:
        return _xchunk(nx - 2 * halo, tiles_yz)
    with torch.cuda.device(device):
        per_sm = lib.heat3d_fused_blocks_per_sm(halo, instance, _DTYPE_CODES[dtype],
                                                compute_code(compute_dtype))
    if per_sm < 1:
        raise RuntimeError(f"fused instance (halo {halo}, {instance}, {dtype}, compute "
                           f"{compute_dtype}) fits no SM")
    resident = per_sm * torch.cuda.get_device_properties(device).multi_processor_count
    return wave_xchunk(nx - 2 * halo, tiles_yz, resident, waves=_WAVES[halo])


def launch(halo: int, us, taps, mesh, state: FusedState, periodic: bool,
           bc_value: float, outs, wrapper, instance=None,
           xchunk: Optional[int] = None,
           compute_dtype: torch.dtype = torch.float32) -> List[torch.Tensor]:
    """One fused launch per device of ``state``: ``halo`` updates of every
    shard in ``compute_dtype`` on ``instance`` (default
    :func:`fused_instance`) with interior x-chunks of ``xchunk`` planes
    (default :func:`_launch_xchunk`); counts each launch on
    ``wrapper.launches`` (and ``wrapper.generic_launches`` when it took the
    generic instance, ``wrapper.compute_bf16_launches`` in bf16 compute)
    and its output cells on ``wrapper.cells``."""
    if state.width != halo or state.periodic != bool(periodic):
        raise ValueError(
            f"state is width {state.width}, periodic={state.periodic}; the launch "
            f"wants width {halo}, periodic={bool(periodic)}")
    if mesh is not state.mesh:
        raise ValueError("the state belongs to another mesh")
    _check(us, outs, mesh, state)
    nx, ny, nz = mesh.local_shape
    if nx < 2 * halo:
        raise ValueError(f"fused kernel of {halo} update(s) needs nx >= {2 * halo}, got {nx}")
    lib = _lib()
    raise_if_timed_out()
    ccode = compute_code(compute_dtype)
    prog = chain_program(taps, compute_dtype)
    inst = fused_instance(halo, taps) if instance is None else instance
    bc = storage_bc(bc_value, state.dtype)
    outs = list(outs) if outs is not None else [None] * len(mesh)
    state.epoch += 1
    for g in state.groups:
        cur = torch.cuda.current_stream(g.device)
        with torch.cuda.device(g.device):
            g.stream.wait_stream(cur)
            for s in g.shards:
                if s.stream is not None and s.stream is not g.stream:
                    g.stream.wait_stream(s.stream)
            with torch.cuda.stream(g.stream):
                for s in g.shards:
                    if outs[s.rank] is None:
                        outs[s.rank] = torch.empty_like(us[s.rank])
            g.entered.record(g.stream)
    for g in state.groups:
        for h in g.targets:
            g.stream.wait_event(h.entered)
        args = _Args()
        for li, s in enumerate(g.shards):
            args.u[li] = us[s.rank].data_ptr()
            args.out[li] = outs[s.rank].data_ptr()
        args.shards = g.table.data_ptr()
        args.sends = g.sends.data_ptr()
        args.epoch = state.epoch
        args.timeout_ns = TIMEOUT_NS
        args.nlocal = len(g.shards)
        args.nsends = g.nsends
        args.push_tiles = g.push_tiles
        args.nx, args.ny, args.nz = nx, ny, nz
        args.xchunk = xchunk or _launch_xchunk(halo, inst, tuple(mesh.local_shape),
                                               len(g.shards), g.device.index, state.dtype,
                                               compute_dtype)
        args.periodic = int(bool(periodic))
        args.bc = bc
        args.prog = prog
        with torch.cuda.device(g.device):
            err = lib.heat3d_fused_launch(halo, inst, _DTYPE_CODES[state.dtype], ccode,
                                          ctypes.byref(args), g.stream.cuda_stream)
        if err != 0:
            raise RuntimeError(
                f"fused kernel (halo {halo}, instance {inst}) launch failed on "
                f"{g.device}: error {err}"
                + (f" ({_ERRORS[err]})" if err in _ERRORS else ""))
        wrapper.launches += 1
        wrapper.generic_launches += inst == GENERIC
        wrapper.compute_bf16_launches += ccode == 1
        wrapper.cells += len(g.shards) * nx * ny * nz
    _join(state)
    return outs


def _join(state: FusedState) -> None:
    """Every shard stream and the caller's stream wait for the launch
    streams."""
    for g in state.groups:
        with torch.cuda.device(g.device):
            for s in g.shards:
                if s.stream is not None and s.stream is not g.stream:
                    s.stream.wait_stream(g.stream)
            torch.cuda.current_stream(g.device).wait_stream(g.stream)


def _landed(mesh, state: FusedState, periodic: bool, bc_value: float):
    """The landed (ny, nz) planes of every shard after a width-1 launch, bc
    written over the buffers at Dirichlet x domain faces (no neighbour
    pushes there), on each device's launch stream."""
    for g in state.groups:
        with torch.cuda.device(g.device), torch.cuda.stream(g.stream):
            for s in g.shards:
                if not periodic and s.edges[0]:
                    state.glo[s.rank].fill_(bc_value)
                if not periodic and s.edges[1]:
                    state.ghi[s.rank].fill_(bc_value)
    _join(state)
    return [(state.glo[s.rank][0], state.ghi[s.rank][0]) for s in mesh.shards]


def _into(res, outs):
    if outs is None:
        return res
    for o, r in zip(outs, res):
        o.copy_(r)
    return list(outs)


def apply_step_fused_dma(us: Sequence[torch.Tensor], taps: np.ndarray, mesh,
                         state: Optional[FusedState] = None, periodic: bool = False,
                         bc_value: float = 0.0, outs: Optional[Sequence[torch.Tensor]] = None,
                         return_ghosts: bool = False,
                         compute_dtype: torch.dtype = torch.float32):
    """One update of every shard of an x-sharded ``mesh`` (fields ``us`` in
    rank order, each the unpadded local block) in ``compute_dtype``, the
    x-face pushes to the ring neighbours in flight under the interior
    sweep. ``state`` is the route's :class:`FusedState` (width 1,
    whole-face sends); ``outs`` (optional) preallocated results. With
    ``return_ghosts`` also the landed (ny, nz) x ghost planes per shard, bc
    at Dirichlet x domain faces: ``(outs, [(glo, ghi), ...])``; the planes
    are the state's buffers, valid until its next launch."""
    return _step(apply_step_fused_dma, us, taps, mesh, state, periodic, bc_value, outs,
                 return_ghosts, compute_dtype=compute_dtype)


def apply_superstep_fused_dma(us: Sequence[torch.Tensor], taps: np.ndarray, mesh,
                              state: Optional[FusedState] = None, periodic: bool = False,
                              bc_value: float = 0.0,
                              outs: Optional[Sequence[torch.Tensor]] = None,
                              compute_dtype: torch.dtype = torch.float32):
    """Two updates of every shard of an x-slab ``mesh`` in one sweep, the
    width-2 face pushes in flight under the interior sweep; the
    intermediate rounded to storage and pinned to bc at Dirichlet domain
    faces: equal to two :func:`apply_step_fused_dma` calls."""
    return _superstep(apply_superstep_fused_dma, us, taps, mesh, state, periodic,
                      bc_value, outs, compute_dtype=compute_dtype)


def _step(wrapper, us, taps, mesh, state, periodic, bc_value, outs, return_ghosts=False,
          instance=None, xchunk=None, compute_dtype=torch.float32):
    taps = check_taps(taps)
    if us[0].device.type == "cpu":
        res = reference_fused_step(us, taps, mesh, periodic, bc_value, return_ghosts,
                                   compute_dtype)
        if return_ghosts:
            return _into(res[0], outs), res[1]
        return _into(res, outs)
    if state is None:
        raise ValueError("a CUDA launch needs its FusedState")
    res = launch(1, us, taps, mesh, state, periodic, bc_value, outs, wrapper, instance,
                 xchunk, compute_dtype)
    if return_ghosts:
        return res, _landed(mesh, state, periodic, bc_value)
    return res


def _superstep(wrapper, us, taps, mesh, state, periodic, bc_value, outs, instance=None,
               xchunk=None, compute_dtype=torch.float32):
    taps = check_taps(taps)
    if mesh.local_shape[0] < 4:
        raise ValueError(f"the two-update fused kernel needs nx >= 4, got {mesh.local_shape}")
    if us[0].device.type == "cpu":
        return _into(reference_fused_superstep(us, taps, mesh, periodic, bc_value,
                                               compute_dtype), outs)
    if state is None:
        raise ValueError("a CUDA launch needs its FusedState")
    return launch(2, us, taps, mesh, state, periodic, bc_value, outs, wrapper, instance,
                  xchunk, compute_dtype)


def launch_instance(instance: int, us: Sequence[torch.Tensor], taps: np.ndarray, mesh,
                    state: FusedState, periodic: bool = False, bc_value: float = 0.0,
                    outs: Optional[Sequence[torch.Tensor]] = None, wrapper=None,
                    xchunk: Optional[int] = None,
                    compute_dtype: torch.dtype = torch.float32):
    """:func:`apply_step_fused_dma` (a width-1 ``state``) or
    :func:`apply_superstep_fused_dma` (width 2) on a named instance, for
    measurements: the generic instance (0) takes any chain, a compile-time
    one only its own (else the launch raises); ``xchunk`` overrides the
    interior x-chunk. CUDA shards only; counted on ``wrapper`` (default the
    DMA wrapper of the state's width; the RDMA rows pass
    ``stencil_fused_rdma``'s)."""
    if us[0].device.type != "cuda":
        raise ValueError(f"no kernel for device {us[0].device}")
    if state.width == 1:
        return _step(wrapper or apply_step_fused_dma, us, taps, mesh, state, periodic,
                     bc_value, outs, instance=instance, xchunk=xchunk,
                     compute_dtype=compute_dtype)
    return _superstep(wrapper or apply_superstep_fused_dma, us, taps, mesh, state, periodic,
                      bc_value, outs, instance, xchunk, compute_dtype)


KERNELS = (apply_step_fused_dma, apply_superstep_fused_dma)


def launch_counts() -> dict:
    return {k.__name__: k.launches for k in KERNELS}


def generic_launch_counts() -> dict:
    """Launches of each wrapper that took the generic instance."""
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
