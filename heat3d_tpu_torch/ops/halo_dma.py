"""DMA halo exchange: each shard's kernel pushes its face slabs into its
neighbours' ghost slabs and signals them; a wait kernel on each shard
spins until its own ghosts have landed.

Port of ``heat3d_tpu.ops.halo_pallas`` (``exchange_axis_dma`` and its two
kernels ``_exchange_axis_dma_width1`` / ``_exchange_axis_dma_slab``, width
1..4). For CUDA blocks :func:`exchange_axis_dma` launches, for every shard
of the mesh, ``halo_push_kernel`` on the shard's stream, then for every
shard ``halo_wait_kernel`` (``csrc/halo_dma.cu``, built on first use by
``ops._build``); for CPU blocks it runs the kernels' plain version,
:func:`exchange_axis_dma_ref`: the ``ppermute`` transport's slab copies of
the same axis (``parallel.halo.exchange_axis_slabs``), which the JAX
package holds its DMA exchange to bitwise.

The flag words, arrival counters and epochs live in a :class:`DmaState`,
which an ``ExchangePlan`` (``parallel.plan``) owns beside the padded blocks
the peers write into: peer pointers stay valid for the plan's life.
Shards on different GPUs need peer access, which :class:`DmaState` enables
or raises; there is no staged fallback.

``exchange_axis_dma.launches`` counts push launches (one push + wait pair
per shard and axis); ``launch_counts`` reports it as ``halo_dma``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import torch

from heat3d_tpu_torch.ops.stencil_direct import _DTYPE_CODES
from heat3d_tpu_torch.parallel.halo import exchange_axis_slabs

_LIB = "halo_dma"
# a wait that has not seen its neighbours' pushes after this long traps
TIMEOUT_NS = 2_000_000_000
_BAD_ARGS = 1000
_NO_PEER = 1001


class _Side(ctypes.Structure):
    _fields_ = [
        ("dst", ctypes.c_void_p),
        ("flag", ctypes.c_void_p),
        ("src_off", ctypes.c_int * 3),
        ("dst_off", ctypes.c_int * 3),
        ("fill", ctypes.c_int),
    ]


class _Push(ctypes.Structure):
    _fields_ = [
        ("src", ctypes.c_void_p),
        ("P", ctypes.c_int * 3),
        ("E", ctypes.c_int * 3),
        ("side", _Side * 2),
        ("counter", ctypes.c_void_p),
        ("epoch", ctypes.c_ulonglong),
        ("bc_bits", ctypes.c_uint),
        ("elem_bytes", ctypes.c_int),
    ]


@functools.lru_cache(maxsize=None)
def _lib():
    from heat3d_tpu_torch.ops import _build

    lib = _build.load(_LIB)
    lib.heat3d_halo_init.argtypes = []
    lib.heat3d_halo_init.restype = ctypes.c_int
    lib.heat3d_halo_error.argtypes = []
    lib.heat3d_halo_error.restype = ctypes.c_uint
    lib.heat3d_halo_enable_peer.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.heat3d_halo_enable_peer.restype = ctypes.c_int
    lib.heat3d_halo_push.argtypes = [ctypes.POINTER(_Push), ctypes.c_void_p]
    lib.heat3d_halo_push.restype = ctypes.c_int
    lib.heat3d_halo_wait.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_ulonglong, ctypes.c_longlong,
        ctypes.c_uint, ctypes.c_void_p,
    ]
    lib.heat3d_halo_wait.restype = ctypes.c_int
    err = lib.heat3d_halo_init()
    if err != 0:
        raise RuntimeError(f"DMA halo: error word allocation failed: error {err}")
    return lib


def raise_if_timed_out() -> None:
    """Raise if a wait kernel has timed out (its neighbours' pushes never
    signalled); the trap it took also fails the next synchronisation."""
    code = _lib().heat3d_halo_error()
    if code:
        c = code - 1
        raise RuntimeError(
            f"DMA halo wait timed out: shard {c // 4}, axis {c % 4} (no "
            f"signal within {TIMEOUT_NS / 1e9:.0f} s)"
        )


def enable_peer_access(devices: Sequence[torch.device]) -> None:
    """Let every pair of the distinct CUDA devices store into each other;
    raises where a pair cannot (the DMA exchange has no staged fallback)."""
    idx = sorted({d.index for d in devices if d.type == "cuda"})
    for a in idx:
        for b in idx:
            if a == b:
                continue
            err = _lib().heat3d_halo_enable_peer(a, b)
            if err == _NO_PEER:
                raise RuntimeError(
                    f"DMA halo: cuda:{a} cannot access cuda:{b} as a peer; "
                    "the DMA exchange needs peer access (use halo='ppermute')"
                )
            if err != 0:
                raise RuntimeError(f"DMA halo: enabling peer access {a}->{b}: error {err}")


class DmaState:
    """The protocol state of one plan's DMA exchanges: per shard six flag
    words (axis x side, written by the neighbours' pushes) and an arrival
    counter, on the shard's device, and the epoch of the exchange."""

    def __init__(self, mesh):
        # zeroed on the shard's own stream: a neighbour's push into these
        # flags waits for the shard's "entered" event, recorded on that
        # stream later, so the zeroing can never land after a signal (a
        # zero-fill on the caller's stream is unordered with the shard
        # streams, and runs late when it shares a hardware queue with a
        # busy shard stream)
        self.flags, self.counters = [], []
        for s in mesh.shards:
            with mesh.on(s):
                self.flags.append(torch.zeros(6, dtype=torch.int64, device=s.device))
                self.counters.append(torch.zeros(1, dtype=torch.int32, device=s.device))
        self.epoch = 0
        if any(s.device.type == "cuda" for s in mesh.shards):
            enable_peer_access(mesh.devices)


def _bc_bits(bc_value: float, dtype: torch.dtype) -> int:
    """``bc_value`` rounded to the storage dtype (as the plain version's
    fill rounds it), as raw bits."""
    t = torch.full((), bc_value, dtype=dtype)
    bits = t.view(torch.int16 if dtype == torch.bfloat16 else torch.int32).item()
    return bits & (0xFFFF if dtype == torch.bfloat16 else 0xFFFFFFFF)


# plain version of :func:`exchange_axis_dma`: the ppermute transport's slab
# copies of the same axis, shard after shard on the current stream
exchange_axis_dma_ref = exchange_axis_slabs


def _slab(axis, at, w):
    """Origin of an axis-``axis`` slab at ``at`` in padded coordinates."""
    return [at if a == axis else (0 if a < axis else w) for a in range(3)]


def launch_args(pads, mesh, axis: int, width: int, periodic: bool,
                bc_value: float, state: DmaState, sync=None):
    """The arguments of one axis of the DMA exchange, in launch order:
    ``pushes``, one ``(shard, _Push)`` per shard, then ``waits``, one
    ``(shard, low flag address or None, high flag address or None, error
    code)`` per shard, at epoch ``state.epoch``. Side 0 of a push carries
    the low face to the low neighbour's high ghost slab (its flag word
    ``2 * axis + 1``), side 1 the high face to the high neighbour's low
    ghost slab (word ``2 * axis``); at a domain face the side fills the
    shard's own ghost slab with the bc bits and signals nobody. ``sync``
    (a ``parallel.plan.StreamSync``) makes each shard's stream wait until
    the blocks it pushes into have entered the exchange."""
    local, w = mesh.local_shape, width
    n = local[axis]
    P = tuple(m + 2 * w for m in local)
    E = tuple(w if a == axis else (P[a] if a < axis else local[a]) for a in range(3))
    bc = _bc_bits(bc_value, pads[0].dtype)
    elem = pads[0].element_size()
    word = state.flags[0].element_size()
    pushes = []
    for shard in mesh.shards:
        push = _Push()
        push.src = pads[shard.rank].data_ptr()
        push.P[:] = P
        push.E[:] = E
        push.counter = state.counters[shard.rank].data_ptr()
        push.epoch = state.epoch
        push.bc_bits = bc
        push.elem_bytes = elem
        for k, (direction, face, ghost, own) in enumerate((
            (-1, w, n + w, 0),   # low face -> low nb's high ghost (its side 1)
            (+1, n, 0, n + w),   # high face -> high nb's low ghost (its side 0)
        )):
            nb = mesh.neighbor(shard, axis, direction, periodic)
            side = push.side[k]
            if nb is None:  # domain face: fill my own ghost slab, signal nobody
                side.dst = pads[shard.rank].data_ptr()
                side.flag = None
                side.dst_off[:] = _slab(axis, own, w)
                side.src_off[:] = _slab(axis, own, w)
                side.fill = 1
            else:
                side.dst = pads[nb.rank].data_ptr()
                side.flag = state.flags[nb.rank].data_ptr() + (2 * axis + 1 - k) * word
                side.dst_off[:] = _slab(axis, ghost, w)
                side.src_off[:] = _slab(axis, face, w)
                side.fill = 0
                if sync is not None:
                    sync.wait_entered(shard, nb)
        pushes.append((shard, push))
    waits = []
    for shard in mesh.shards:
        flags = state.flags[shard.rank].data_ptr()
        f = [
            None if mesh.neighbor(shard, axis, d, periodic) is None
            else flags + (2 * axis + side) * word
            for side, d in ((0, -1), (1, +1))
        ]
        waits.append((shard, f[0], f[1], 1 + shard.rank * 4 + axis))
    return pushes, waits


def exchange_axis_dma(pads, mesh, axis: int, width: int, periodic: bool,
                      bc_value: float, state: DmaState, sync=None) -> None:
    """Axis ``axis`` of the sharded exchange by DMA: every shard pushes its
    two width-``width`` face slabs (full padded extent on earlier axes,
    interior on later ones) into its neighbours' padded blocks ``pads``
    (rank order) and signals them, then every shard waits for its own two
    ghost slabs (:func:`launch_args`). The axis must have mesh size >= 2
    (a size-1 axis moves nothing between shards). Callers bump
    ``state.epoch`` once per exchange."""
    if mesh.shape[axis] < 2:
        raise ValueError(f"axis {axis} has mesh size 1: no DMA exchange")
    if pads[0].device.type == "cpu":
        exchange_axis_dma_ref(pads, mesh, axis, width, periodic, bc_value)
        return
    for p in pads:
        if p.device.type != "cuda":
            raise ValueError(f"no kernel for device {p.device}")
        if p.dtype not in _DTYPE_CODES or not p.is_contiguous():
            raise ValueError("padded blocks must be contiguous float32 or bfloat16")
    lib = _lib()
    raise_if_timed_out()
    pushes, waits = launch_args(pads, mesh, axis, width, periodic, bc_value, state, sync)
    for shard, push in pushes:
        _launch(lib.heat3d_halo_push, shard, ctypes.byref(push))
        exchange_axis_dma.launches += 1
    for shard, f0, f1, code in waits:
        _launch(lib.heat3d_halo_wait, shard, f0, f1, state.epoch, TIMEOUT_NS, code)


def _launch(fn, shard, *args) -> None:
    with torch.cuda.device(shard.device):
        stream = (shard.stream if shard.stream is not None
                  else torch.cuda.current_stream(shard.device))
        err = fn(*args, stream.cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"DMA halo kernel launch failed on shard {shard.rank}: error {err}"
            + (" (bad arguments)" if err == _BAD_ARGS else "")
        )


exchange_axis_dma.launches = 0


def launch_counts() -> dict:
    return {"halo_dma": exchange_axis_dma.launches}


def reset_launch_counts() -> None:
    exchange_axis_dma.launches = 0
