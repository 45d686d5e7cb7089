"""DMA halo exchange: each shard's face slabs go into its neighbours' ghost
slabs, and each shard's own ghosts are waited for, by two kernel launches
per device and axis.

Port of ``heat3d_tpu.ops.halo_pallas`` (``exchange_axis_dma`` and its two
kernels ``_exchange_axis_dma_width1`` / ``_exchange_axis_dma_slab``, width
1..4). For CUDA blocks :func:`exchange_axis_dma` enqueues, per device, one
``halo_push_kernel`` launch over every shard the device holds and one
``halo_wait_kernel`` launch over every flag word those shards are owed
(``csrc/halo_dma.cu``, built on first use by ``ops._build``); for CPU
blocks it runs the kernels' plain version, :func:`exchange_axis_dma_ref`:
the ``ppermute`` transport's slab copies of the same axis
(``parallel.halo.exchange_axis_slabs``), which the JAX package holds its
DMA exchange to bitwise.

What a launch needs but the epoch and the bc bits is fixed for the life of
a plan: :func:`launch_table` lays it out per device (one item per side of
each shard, one wait entry per owed flag word), and :class:`DmaState`
builds every axis's tables once, in device memory, over the padded blocks
it is given. The flag words, arrival counters and epochs live there too;
an ``ExchangePlan`` (``parallel.plan``) owns the state beside the padded
blocks the peers write into, so peer pointers stay valid for the plan's
life. Shards on different GPUs need peer access, which :class:`DmaState`
enables or raises; there is no staged fallback.

``exchange_axis_dma.launches`` counts kernel launches (a push and, where a
shard of the device is owed a flag, a wait per device and axis; until the
tables it counted one push per shard) and ``exchange_axis_dma.cells`` the
ghost cells they write (two slabs a shard); ``launch_counts`` and
``cell_counts`` report them as ``halo_dma``.
"""

from __future__ import annotations

import ctypes
import functools
import weakref
from typing import Dict, List, Sequence

import torch

from heat3d_tpu_torch.ops.stencil_direct import _DTYPE_CODES
from heat3d_tpu_torch.parallel.halo import exchange_axis_slabs

_LIB = "halo_dma"
# a wait that has not seen its neighbours' pushes after this long traps
TIMEOUT_NS = 2_000_000_000
_BAD_ARGS = 1000
_NO_PEER = 1001
_FLAG_BYTES = 8


class _Item(ctypes.Structure):
    """One side of one shard's push (``HaloItem``)."""

    _fields_ = [
        ("src", ctypes.c_void_p),
        ("dst", ctypes.c_void_p),
        ("flag", ctypes.c_void_p),
        ("src_off", ctypes.c_int * 3),
        ("dst_off", ctypes.c_int * 3),
        ("fill", ctypes.c_int),
    ]


class _Wait(ctypes.Structure):
    """One flag word a device's shards are owed (``HaloWait``)."""

    _fields_ = [("flag", ctypes.c_void_p), ("code", ctypes.c_uint), ("unused", ctypes.c_int)]


class _Launch(ctypes.Structure):
    """One (device, axis) of a plan's exchange (``HaloLaunch``)."""

    _fields_ = [
        ("items", ctypes.c_void_p),
        ("waits", ctypes.c_void_p),
        ("counter", ctypes.c_void_p),
        ("nitems", ctypes.c_int),
        ("nwaits", ctypes.c_int),
        ("P", ctypes.c_int * 3),
        ("E", ctypes.c_int * 3),
        ("elem_bytes", ctypes.c_int),
        ("device", ctypes.c_int),
        ("stream", ctypes.c_void_p),
        ("others", ctypes.c_void_p),
        ("nothers", ctypes.c_int),
        ("fork", ctypes.c_void_p),
        ("join", ctypes.c_void_p),
    ]


@functools.lru_cache(maxsize=None)
def _lib():
    from heat3d_tpu_torch.ops import _build

    lib = _build.load(_LIB)
    for fn in ("heat3d_halo_init", "heat3d_halo_item_bytes", "heat3d_halo_wait_bytes",
               "heat3d_halo_launch_bytes"):
        getattr(lib, fn).argtypes = []
        getattr(lib, fn).restype = ctypes.c_int
    lib.heat3d_halo_error.argtypes = []
    lib.heat3d_halo_error.restype = ctypes.c_uint
    lib.heat3d_halo_enable_peer.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.heat3d_halo_enable_peer.restype = ctypes.c_int
    lib.heat3d_halo_events.argtypes = [
        ctypes.c_int, ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_void_p)]
    lib.heat3d_halo_events.restype = ctypes.c_int
    lib.heat3d_halo_event_free.argtypes = [ctypes.c_void_p]
    lib.heat3d_halo_event_free.restype = None
    lib.heat3d_halo_exchange.argtypes = [
        ctypes.POINTER(_Launch), ctypes.c_ulonglong, ctypes.c_uint, ctypes.c_longlong]
    lib.heat3d_halo_exchange.restype = ctypes.c_int
    layout = {
        "item": (lib.heat3d_halo_item_bytes(), ctypes.sizeof(_Item)),
        "wait": (lib.heat3d_halo_wait_bytes(), ctypes.sizeof(_Wait)),
        "launch": (lib.heat3d_halo_launch_bytes(), ctypes.sizeof(_Launch)),
    }
    bad = {k: v for k, v in layout.items() if v[0] != v[1]}
    if bad:
        raise RuntimeError(f"DMA halo: library layout differs from the wrapper's: {bad}")
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


class DmaLaunch:
    """One device's launch of one axis of a plan's exchange: the shards the
    device holds (rank order; the first one's stream is the launch stream),
    the push ``items`` (one per side of each shard: source and destination
    block, slab origins, the receiver's flag word, or a bc fill of the
    shard's own ghost slab), the ``waits`` (one per flag word the shards
    are owed, with its error code), the ranks of receivers on other devices
    (``remote``) and the slab geometry; on CUDA also the tables in device
    memory and the launch arguments (:func:`_prepare`)."""

    def __init__(self, device, shards, items, waits, remote, P, E, cells):
        self.device = device
        self.shards = shards
        self.items = items    # list of _Item
        self.waits = waits    # list of _Wait
        self.remote = remote
        self.P = P
        self.E = E
        self.cells = cells    # ghost cells the launch writes
        self.args = None      # _Launch, on CUDA
        self._keep = ()       # what the device pointers of ``args`` live in

    @property
    def kernel_launches(self) -> int:
        return 1 + (len(self.waits) > 0)


class DmaState:
    """The protocol state and launch tables of one plan's DMA exchanges
    over its padded blocks ``pads`` (rank order) at ``width``: per shard six
    flag words (axis x side, written by the neighbours' pushes), on the
    shard's device; per device the shards it holds and an arrival counter
    per axis; the epoch of the exchange; and ``launches[axis]``, the
    launches of each axis of mesh size >= 2 (:func:`launch_table`), built
    here, with their tables in device memory when the blocks are CUDA
    tensors. The blocks must outlive the state: the tables hold their
    addresses."""

    def __init__(self, mesh, pads, width: int, periodic: bool):
        self.mesh = mesh
        self.groups: Dict[torch.device, list] = {}
        for s in mesh.shards:
            self.groups.setdefault(s.device, []).append(s)
        # zeroed on the shard's own stream: a neighbour's push into these
        # flags waits for the shard's stream (one device) or its "entered"
        # event (another device), both later in that stream, so the zeroing
        # can never land after a signal (a zero-fill on the caller's stream
        # is unordered with the shard streams, and runs late when it shares
        # a hardware queue with a busy shard stream)
        self.flags = []
        for s in mesh.shards:
            with mesh.on(s):
                self.flags.append(torch.zeros(6, dtype=torch.int64, device=s.device))
        self.counters = {}
        for dev, shards in self.groups.items():
            with mesh.on(shards[0]):
                self.counters[dev] = torch.zeros(3, dtype=torch.int32, device=dev)
        self.epoch = 0
        self.blocks = (tuple(p.data_ptr() for p in pads), width, bool(periodic))
        cuda = pads[0].device.type == "cuda"
        if cuda:
            enable_peer_access(mesh.devices)
        self.launches: Dict[int, List[DmaLaunch]] = {}
        for axis in range(3):
            if mesh.shape[axis] < 2:
                continue
            launches = launch_table(pads, mesh, axis, width, periodic, self)
            if cuda:
                for lau in launches:
                    _prepare(lau, self, axis, pads[0].element_size())
            self.launches[axis] = launches


def _prepare(lau: DmaLaunch, state: DmaState, axis: int, elem_bytes: int) -> None:
    """Copy ``lau``'s items and waits into device memory (on its launch
    stream), make its fork and join events and fill ``lau.args``."""
    lib = _lib()
    lead = lau.shards[0]
    stream = lead.stream or torch.cuda.current_stream(lau.device)
    with torch.cuda.device(lau.device), torch.cuda.stream(stream):
        items = device_table((_Item * len(lau.items))(*lau.items), lau.device)
        waits = (device_table((_Wait * len(lau.waits))(*lau.waits), lau.device)
                 if lau.waits else None)
    others = [s.stream for s in lau.shards[1:]
              if s.stream is not None and s.stream is not stream]
    handles = (ctypes.c_void_p * max(1, len(others)))(*[o.cuda_stream for o in others])
    fork, join = ctypes.c_void_p(), ctypes.c_void_p()
    err = lib.heat3d_halo_events(lau.device.index, ctypes.byref(fork), ctypes.byref(join))
    for e in (fork, join):
        if e.value:
            weakref.finalize(lau, lib.heat3d_halo_event_free, e.value)
    if err != 0:
        raise RuntimeError(f"DMA halo: event creation on {lau.device} failed: error {err}")
    a = _Launch()
    a.items = items.data_ptr()
    a.waits = waits.data_ptr() if waits is not None else None
    a.counter = state.counters[lau.device].data_ptr() + 4 * axis
    a.nitems, a.nwaits = len(lau.items), len(lau.waits)
    a.P[:] = lau.P
    a.E[:] = lau.E
    a.elem_bytes = elem_bytes
    a.device = lau.device.index
    a.stream = stream.cuda_stream
    a.others = ctypes.cast(handles, ctypes.c_void_p)
    a.nothers = len(others)
    a.fork, a.join = fork.value, join.value
    lau.args = a
    lau._keep = (items, waits, handles, stream)


def device_table(cstruct, device) -> torch.Tensor:
    """A ctypes table copied into device memory (on the current stream)."""
    host = torch.frombuffer(bytearray(bytes(cstruct)), dtype=torch.uint8)
    return host.to(device)


@functools.lru_cache(maxsize=64)
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


def launch_table(pads, mesh, axis: int, width: int, periodic: bool,
                 state: DmaState) -> List[DmaLaunch]:
    """The launches of one axis of the DMA exchange, one per device of
    ``state.groups`` (pointers as integers; no CUDA needed). Item 2i of a
    launch carries its shard i's low face to the low neighbour's high ghost
    slab (its flag word ``2 * axis + 1``), item 2i+1 the high face to the
    high neighbour's low ghost slab (word ``2 * axis``); at a domain face
    the item fills the shard's own ghost slab with the bc bits and signals
    nobody. Each shard is owed the flag word of each side that has a
    neighbour (error code ``1 + rank * 4 + axis``)."""
    local, w = mesh.local_shape, width
    n = local[axis]
    P = tuple(m + 2 * w for m in local)
    E = tuple(w if a == axis else (P[a] if a < axis else local[a]) for a in range(3))
    ghost = _ghost_slab_cells(P, axis, w)
    launches = []
    for dev, shards in state.groups.items():
        items, waits, remote = [], [], []
        for shard in shards:
            src = pads[shard.rank].data_ptr()
            for k, (direction, face, ghost_at, own) in enumerate((
                (-1, w, n + w, 0),   # low face -> low nb's high ghost (its side 1)
                (+1, n, 0, n + w),   # high face -> high nb's low ghost (its side 0)
            )):
                nb = mesh.neighbor(shard, axis, direction, periodic)
                if nb is None:  # domain face: fill my own ghost slab, signal nobody
                    items.append(_Item(src, src, None, (ctypes.c_int * 3)(*_slab(axis, own, w)),
                                       (ctypes.c_int * 3)(*_slab(axis, own, w)), 1))
                    continue
                flag = (state.flags[nb.rank].data_ptr()
                        + (2 * axis + 1 - k) * _FLAG_BYTES)
                items.append(_Item(src, pads[nb.rank].data_ptr(), flag,
                                   (ctypes.c_int * 3)(*_slab(axis, face, w)),
                                   (ctypes.c_int * 3)(*_slab(axis, ghost_at, w)), 0))
                if nb.device != dev and nb.rank not in remote:
                    remote.append(nb.rank)
            flags = state.flags[shard.rank].data_ptr()
            for side, d in ((0, -1), (1, +1)):
                if mesh.neighbor(shard, axis, d, periodic) is not None:
                    waits.append(_Wait(flags + (2 * axis + side) * _FLAG_BYTES,
                                       1 + shard.rank * 4 + axis, 0))
        launches.append(DmaLaunch(dev, shards, items, waits, remote, P, E,
                                  2 * ghost * len(shards)))
    return launches


def exchange_axis_dma(pads, mesh, axis: int, width: int, periodic: bool,
                      bc_value: float, state: DmaState, sync=None) -> None:
    """Axis ``axis`` of the sharded exchange by DMA: every shard pushes its
    two width-``width`` face slabs (full padded extent on earlier axes,
    interior on later ones) into its neighbours' padded blocks ``pads``
    (rank order) and signals them, then every shard waits for its own two
    ghost slabs; per device one push and one wait launch on its first
    shard's stream, after the device's other shard streams, which then wait
    for it (:func:`launch_table`). ``sync`` (a ``parallel.plan.StreamSync``)
    makes a launch wait until the blocks it pushes into on other devices
    have entered the exchange. ``state`` is the :class:`DmaState` built over
    these blocks, width and boundary. The axis must have mesh size >= 2 (a
    size-1 axis moves nothing between shards). Callers bump ``state.epoch``
    once per exchange."""
    if mesh.shape[axis] < 2:
        raise ValueError(f"axis {axis} has mesh size 1: no DMA exchange")
    cpu = pads[0].device.type == "cpu"
    if not cpu:
        for p in pads:
            if p.device.type != "cuda":
                raise ValueError(f"no kernel for device {p.device}")
            if p.dtype not in _DTYPE_CODES or not p.is_contiguous():
                raise ValueError("padded blocks must be contiguous float32 or bfloat16")
    if state.blocks != (tuple(p.data_ptr() for p in pads), width, bool(periodic)):
        raise ValueError("the DMA state was built for other padded blocks, width "
                         "or boundary")
    if cpu:
        exchange_axis_dma_ref(pads, mesh, axis, width, periodic, bc_value)
        return
    lib = _lib()
    raise_if_timed_out()
    bc = _bc_bits(float(bc_value), pads[0].dtype)
    for lau in state.launches[axis]:
        if sync is not None:
            for r in lau.remote:
                sync.wait_entered(lau.shards[0], mesh.shards[r])
        err = lib.heat3d_halo_exchange(ctypes.byref(lau.args), state.epoch, bc, TIMEOUT_NS)
        if err != 0:
            raise RuntimeError(
                f"DMA halo kernel launch failed on {lau.device}: error {err}"
                + (" (bad arguments)" if err == _BAD_ARGS else ""))
        exchange_axis_dma.launches += lau.kernel_launches
        exchange_axis_dma.cells += lau.cells


def _ghost_slab_cells(padded_shape, axis: int, width: int) -> int:
    """Cells of one width-``width`` ghost slab of ``axis``: the full padded
    extent on earlier axes, the interior on later ones."""
    n = 1
    for a, m in enumerate(padded_shape):
        n *= width if a == axis else (m if a < axis else m - 2 * width)
    return n


def launch_counts() -> dict:
    return {"halo_dma": exchange_axis_dma.launches}


def cell_counts() -> dict:
    """Ghost cells the DMA kernels wrote (two slabs a shard and axis)."""
    return {"halo_dma": exchange_axis_dma.cells}


def reset_launch_counts() -> None:
    exchange_axis_dma.launches = exchange_axis_dma.cells = 0


reset_launch_counts()
