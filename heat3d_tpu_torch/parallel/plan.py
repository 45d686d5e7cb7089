"""Persistent halo-exchange plans over a mesh of shards.

Port of ``heat3d_tpu.parallel.plan`` (``ExchangePlan``, ``plan_for``): a
plan is built once per (mesh, boundary condition, width, transport, storage
dtype, ordering, plan mode) and reused by every step. It
owns what the exchange reuses: each shard's padded block (the exchange
writes into it, the stencil kernel reads it), and for the DMA transport the
flag words, counters and epoch (``ops.halo_dma.DmaState``). The DMA pushes
store into other shards' blocks through their base pointers, so the blocks
are allocated once here and never reallocated.

``apply`` runs the axis-ordered exchange (``parallel.halo``): on a one-shard
mesh ``exchange_halo`` into the plan's block; otherwise

- each shard copies its field into the interior of its padded block;
- for x, then y, then z: on an axis of mesh size 1 each shard fills its own
  ghosts (self-wrap, or bc); otherwise the ``ppermute`` transport copies
  each shard's face slabs into its neighbours' ghost slabs
  (``push_axis_slabs``), or the ``dma`` transport launches, per device,
  one push and one wait kernel over every shard the device holds
  (``ops.halo_dma.exchange_axis_dma``, its launch tables kept in the
  plan's ``DmaState``).

Under ``halo_order='pairwise'`` (ppermute only, on every mesh, a one-shard
mesh too, as the JAX plan takes ``exchange_halo_pairwise`` there) each
shard copies its field into the interior, then every shard pushes its six
raw faces of the field at once (``push_pairwise_faces``) and then waits
for all its neighbours' pushes; the edge and corner zones of the blocks
hold ``bc_value``, written when the plan first sees that value
(``fill_pairwise_edges``: nothing else writes them).

Stream order (:class:`StreamSync`, CUDA meshes of several shards, one
stream per shard): at the start of an exchange each shard records an
"entered" event, after all its earlier work on its block, so a neighbour's
push into that block waits for it (the TPU kernel's neighbour barrier);
on the ppermute transport each shard records a "pushed" event after its
pushes of an axis and its neighbours wait for it before the next axis or
the compute; on the DMA transport the wait kernels take that place, and
each device's launch orders itself after the device's shard streams and
they after it (the "entered" events order pushes into blocks on other
devices).

:class:`BatchedExchangePlan` is the axis-ordered ppermute exchange of a
batch of fields (the ensemble's members), blocks with a leading batch
extent and per-member boundary values, in one process.

:class:`FacesPlan` is the same for ``exchange_halo_faces`` (the
faces-direct step): six ghost face buffers per shard and no padded block.
Its ``x_ghosts`` seeding takes the x faces from the fused kernel's landed
planes instead of an x transfer (the 3D fused route).

Across processes (one process per GPU, ``parallel.distributed``) each
plan holds this process's shards only and a wire (``parallel.wire``).
On the peer wire (every rank on one host) the plan's receiving buffers
are allocated mappable and exchanged once with the other processes, a
push into a neighbour on another process stores into its mapped block or
face, and :class:`StreamSync` adds, for every shard, an "entered" and a
"pushed" word: ``enter`` and ``push_done`` signal the shard's own word
with the plan's exchange or round epoch on its stream, and waiting for a
remote shard waits on its mapped word (``ops.peer``). Both ranks count
the epochs identically: one exchange a ``copy_interior`` (or faces
``apply``), one round a :meth:`_Plan._push_axes`. The DMA transport
pushes into the mapped blocks and flag words of remote receivers
(``ops.halo_dma``); on the CPU its plain version across processes is the
slab copies of the ppermute transport through the wire. On the host wire
(ranks on several hosts) a push into a remote neighbour is a send, each
ghost fed from another process a receive, all posted as one
``batch_isend_irecv`` a round and waited for before the round's events;
the DMA transport is refused there. Neighbours on the same process keep
their device copies either way.

Plan modes (port of the JAX plan's ``halo_plan``), kept in a
:class:`Schedule` of the :class:`ExchangePlan` (the faces exchange is
always monolithic, as the JAX one): ``monolithic`` copies each face whole;
``partitioned`` copies each face as sub-blocks along its first non-exchange dim
(:data:`DEFAULT_PARTITIONS` of them, :func:`partition_bounds`), faces below
:func:`part_min_bytes` whole. The ghosts are byte-equal either way. The
fused RDMA kernels take the x faces' ranges as their send table
(``Schedule.face_partition_bounds``). ``HEAT3D_NO_PLAN`` runs the
monolithic schedule (:func:`effective_halo_plan`).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from heat3d_tpu_torch.core.config import BoundaryCondition
from heat3d_tpu_torch.obs.trace import named_phase
from heat3d_tpu_torch.ops import peer
from heat3d_tpu_torch.parallel.halo import (
    _check_width,
    exchange_axis_slabs,
    exchange_halo,
    face_shapes,
    fill_pairwise_edges,
    interior,
    padded_shape,
    part_dim,
    push_axis_faces,
    push_axis_slabs,
    push_pairwise_faces,
    recv_axis_faces,
    recv_axis_slabs,
    recv_pairwise_faces,
)
from heat3d_tpu_torch.parallel import wire as wires

# the mesh's axis names (``MeshConfig.axis_names``), in the per-axis
# ``heat3d.halo.<axis>`` ranges
AXIS_NAMES = ("x", "y", "z")

TRANSPORTS = ("ppermute", "dma")
HALO_PLANS = ("monolithic", "partitioned")
HALO_ORDERS = ("axis", "pairwise")

# sub-blocks per face in partitioned mode
DEFAULT_PARTITIONS = 2
# a face below this many bytes ships whole even when partitioned
DEFAULT_PART_MIN_BYTES = 1 << 20
ENV_NO_PLAN = "HEAT3D_NO_PLAN"
ENV_PART_MIN_BYTES = "HEAT3D_PLAN_PART_MIN_BYTES"


def part_min_bytes() -> int:
    """The partition granularity floor: ``HEAT3D_PLAN_PART_MIN_BYTES``, or
    the default (also for a malformed value)."""
    raw = os.environ.get(ENV_PART_MIN_BYTES)
    if raw is None or raw == "":
        return DEFAULT_PART_MIN_BYTES
    try:
        return max(0, int(raw))
    except ValueError:
        return DEFAULT_PART_MIN_BYTES


def partition_bounds(extent: int, parts: int) -> Tuple[Tuple[int, int], ...]:
    """Split ``[0, extent)`` into up to ``parts`` contiguous sub-ranges, as
    even as possible, never empty."""
    p = max(1, min(int(parts), int(extent)))
    base, rem = divmod(int(extent), p)
    bounds, start = [], 0
    for i in range(p):
        step = base + (1 if i < rem else 0)
        bounds.append((start, start + step))
        start += step
    return tuple(bounds)


def make_schedule(mesh_shape, width: int, mode: str, halo_order: str = "axis") -> "Schedule":
    """The schedule of a width-``width`` exchange in plan mode ``mode`` and
    ordering ``halo_order`` at the configured granularity floor
    (:func:`part_min_bytes`)."""
    return Schedule(tuple(mesh_shape), width, mode, min_part_bytes=part_min_bytes(),
                    halo_order=halo_order)


def effective_halo_plan(cfg) -> str:
    """The plan mode that runs: ``HEAT3D_NO_PLAN`` degrades partitioned to
    monolithic. Bench rows record this value."""
    if os.environ.get(ENV_NO_PLAN):
        return "monolithic"
    return cfg.halo_plan


@dataclasses.dataclass(frozen=True)
class Schedule:
    """The message schedule of one exchange (port of the JAX
    ``ExchangePlan``'s schedule fields and metadata)."""

    mesh_shape: Tuple[int, int, int]
    width: int
    mode: str = "monolithic"
    partitions: int = DEFAULT_PARTITIONS
    min_part_bytes: int = DEFAULT_PART_MIN_BYTES
    halo_order: str = "axis"

    def __post_init__(self):
        if self.mode not in HALO_PLANS:
            raise ValueError(f"plan mode must be monolithic|partitioned, got {self.mode!r}")
        if self.halo_order not in HALO_ORDERS:
            raise ValueError(f"halo order must be axis|pairwise, got {self.halo_order!r}")

    def _face_partitions(self, face_shape, itemsize: int) -> int:
        elems = 1
        for n in face_shape:
            elems *= int(n)
        return 1 if elems * itemsize < self.min_part_bytes else self.partitions

    def face_bounds(self, axis: int, face_shape, itemsize: int):
        """The sub-block ranges along ``part_dim(axis)`` of a face of
        ``face_shape``: one whole range unless partitioned and at or above
        the floor."""
        extent = int(face_shape[part_dim(axis)])
        if self.mode != "partitioned":
            return ((0, extent),)
        return partition_bounds(extent, self._face_partitions(face_shape, itemsize))

    def face_partition_bounds(self, axis: int, local_shape, itemsize: int):
        """The sub-block decomposition of ``axis``'s faces of a
        ``local_shape`` shard, width ``self.width`` (the JAX
        ``ExchangePlan.face_partition_bounds``)."""
        face = tuple(self.width if d == axis else int(local_shape[d]) for d in range(3))
        return self.face_bounds(axis, face, itemsize)

    def messages_per_exchange(self) -> int:
        """Face copies one exchange issues per shard at the schedule's
        ceiling (the floor may ship small faces whole)."""
        per_face = self.partitions if self.mode == "partitioned" else 1
        return sum(2 * per_face for n in self.mesh_shape if n > 1)

    def traffic(self, local_shape, itemsize: int) -> Dict[str, int]:
        """Messages and boundary bytes one exchange sends per shard, with
        the face extension of the axis ordering (the pairwise faces are
        raw) and the floor."""
        ext = list(local_shape)
        w = self.width
        messages = bytes_sent = 0
        for axis, size in enumerate(self.mesh_shape):
            if size > 1:
                face = [w if d == axis else ext[d] for d in range(3)]
                messages += 2 * len(self.face_bounds(axis, face, itemsize))
                bytes_sent += 2 * face[0] * face[1] * face[2] * itemsize
            if self.halo_order == "axis":
                ext[axis] += 2 * w
        return {"messages": messages, "bytes_per_device": bytes_sent}


class StreamSync:
    """The events of the exchange protocol, one pair per shard; every call
    is a no-op on the CPU and on a one-shard mesh (one stream). Across
    processes on the peer wire (:meth:`attach`) each shard also has an
    "entered" and a "pushed" word: its own are signalled at the plan's
    epochs (:meth:`begin_exchange`, :meth:`begin_round`), a remote shard's
    are waited on, bounded by the process group's timeout; on the CPU the
    signal is a host store and the wait a host poll. On the host wire a
    remote shard has none (its messages order themselves)."""

    def __init__(self, mesh):
        self.mesh = mesh
        on = [s.stream is not None for s in mesh.shards]
        self.entered = [torch.cuda.Event() if x else None for x in on]
        self.pushed = [torch.cuda.Event() if x else None for x in on]
        self.wire = None
        self.exchanges = 0
        self.rounds = 0

    def attach(self, wire) -> None:
        """Take the protocol words of a :class:`~heat3d_tpu_torch.parallel.wire.PeerWire`."""
        self.wire = wire

    def begin_exchange(self) -> None:
        self.exchanges += 1

    def begin_round(self) -> None:
        self.rounds += 1

    def _signal(self, shard, which: int, epoch: int) -> None:
        if self.wire is not None:
            peer.signal(self.wire.word(shard, which), epoch, shard.stream)

    def _wait(self, shard, target, which: int, epoch: int) -> None:
        peer.wait(self.wire.word(target, which), epoch, shard.stream,
                  code=1 + 2 * target.rank + which)

    def enter(self, shard) -> None:
        """On the shard's stream: its earlier work on its blocks is done."""
        if shard.stream is not None:
            self.entered[shard.rank].record(shard.stream)
        self._signal(shard, wires.ENTERED, self.exchanges)

    def wait_entered(self, shard, target) -> None:
        """The shard's stream waits until ``target`` has entered."""
        if self.wire is not None and not self.mesh.is_local(target):
            self._wait(shard, target, wires.ENTERED, self.exchanges)
        elif shard.stream is not None and target is not shard and target.stream is not None:
            shard.stream.wait_event(self.entered[target.rank])

    def push_done(self, shard) -> None:
        if shard.stream is not None:
            self.pushed[shard.rank].record(shard.stream)
        self._signal(shard, wires.PUSHED, self.rounds)

    def wait_pushes(self, shard, sources) -> None:
        """The shard's stream waits for the pushes of ``sources``."""
        for src in sources:
            if src is None or src is shard:
                continue
            if self.wire is not None and not self.mesh.is_local(src):
                self._wait(shard, src, wires.PUSHED, self.rounds)
            elif shard.stream is not None and src.stream is not None:
                shard.stream.wait_event(self.pushed[src.rank])


def _neighbors(mesh, shard, axis, periodic):
    return [mesh.neighbor(shard, axis, d, periodic) for d in (-1, +1)]


class _Plan:
    def __init__(self, mesh, bc: BoundaryCondition, width: int):
        _check_width(mesh.local_shape, width)
        self.mesh = mesh
        self.bc = bc
        self.width = width
        self.sync = StreamSync(mesh)
        # the allocation of the buffers peers store into, by the transport
        # to shards on other processes (None: one process)
        self.alloc = wires.allocator(wires.transport_of(mesh))
        self.wire = None

    def _connect(self, buffers) -> None:
        """Open the wire to the other processes over this process's
        receiving ``buffers`` (per local shard, a tuple)."""
        self.wire = wires.connect(self.mesh, buffers)
        if self.wire is not None and not self.wire.staged:
            self.sync.attach(self.wire)

    @property
    def periodic(self) -> bool:
        return self.bc is BoundaryCondition.PERIODIC

    def _push_axes(self, axes, push, receive) -> None:
        """Axes ``axes`` on the ppermute transport in one round: every shard
        pushes (after its targets entered), the round's messages between
        processes are exchanged on the host wire (``receive(s)`` posts
        shard s's receives), then every shard waits for its neighbours'
        along those axes."""
        mesh, sync, p, wire = self.mesh, self.sync, self.periodic, self.wire
        sync.begin_round()
        if wire is not None:
            wire.begin()
        for s in mesh.local_shards:
            for axis in axes:
                for nb in _neighbors(mesh, s, axis, p):
                    if nb is not None:
                        sync.wait_entered(s, nb)
            with mesh.on(s):
                push(s)
            sync.push_done(s)
        if wire is not None and wire.staged:
            for s in mesh.local_shards:
                receive(s)
            wire.flush()
        for axis in axes:
            if mesh.shape[axis] > 1:
                for s in mesh.local_shards:
                    sync.wait_pushes(s, _neighbors(mesh, s, axis, p))
        if wire is not None and not wire.staged:
            wire.flush()


class ExchangePlan(_Plan):
    """The padded-block exchange of one (mesh, bc, width, transport, dtype)."""

    def __init__(self, mesh, bc: BoundaryCondition, width: int,
                 transport: str, dtype: torch.dtype, mode: str = "monolithic",
                 halo_order: str = "axis"):
        if transport not in TRANSPORTS:
            raise ValueError(f"unknown halo transport {transport!r}")
        if mode == "partitioned" and transport != "ppermute":
            raise ValueError(
                "halo_plan='partitioned' applies to the ppermute transport; "
                "the DMA slab kernels ship whole faces by construction")
        if halo_order == "pairwise" and transport != "ppermute":
            raise ValueError(
                "halo_order='pairwise' applies to the ppermute transport; the "
                "DMA exchange kernels implement axis-ordered propagation")
        super().__init__(mesh, bc, width)
        self.schedule = make_schedule(mesh.shape, width, mode, halo_order)
        self.halo_order = halo_order
        # the bc value the pairwise blocks' edge and corner zones hold
        self._edges_bc = None
        self.transport = transport
        self.dtype = dtype
        want = padded_shape(mesh.local_shape, width)
        local = mesh.local_shards
        self.pads: List[torch.Tensor] = [self.alloc(want, dtype, s.device) for s in local]
        self.dma = None
        # the DMA kernels run on CUDA blocks; on the CPU across processes
        # the plain version is the slab copies through the wire
        dma = transport == "dma" and len(mesh) > 1 and not (
            mesh.multiprocess and local[0].device.type == "cpu")
        # across processes the DMA flag words are mapped by peers as well
        flags = ([self.alloc((6,), torch.int64, s.device) for s in local]
                 if dma and mesh.multiprocess else None)
        self._connect([(pad,) for pad in self.pads] if flags is None
                      else list(zip(self.pads, flags)))
        if dma:
            from heat3d_tpu_torch.ops.halo_dma import DmaState

            self.dma = DmaState(mesh, self.pads, width, self.periodic, flags=flags,
                                wire=self.wire)

    def apply(self, us: Sequence[torch.Tensor], bc_value: float) -> List[torch.Tensor]:
        """The padded blocks of the fields ``us`` (rank order), ghosts
        filled: ``(n + 2w)`` per axis. The blocks are the plan's own, valid
        until its next ``apply``. On a sharded or pairwise plan this is
        :meth:`copy_interior` then :meth:`push_faces`. One
        ``heat3d.halo_exchange`` range (``obs.trace``) holds it all."""
        with named_phase("halo_exchange"):
            if len(self.mesh) == 1 and self.halo_order == "axis":
                exchange_halo(us[0], self.bc, bc_value, self.width, out=self.pads[0])
                return self.pads
            self.copy_interior(us, bc_value)
            self.push_faces(us, bc_value)
            return self.pads

    def copy_interior(self, us: Sequence[torch.Tensor], bc_value: float) -> None:
        """The first part of an exchange: each shard enters it and copies its
        field into the interior of its block on its stream (under pairwise,
        after filling the edge and corner zones when ``bc_value`` is new)."""
        mesh, w = self.mesh, self.width
        inner = interior(mesh.local_shape, w)
        edges = self.halo_order == "pairwise" and self._edges_bc != bc_value
        self.sync.begin_exchange()
        for s, u, pad in zip(mesh.local_shards, us, self.pads):
            self.sync.enter(s)
            with mesh.on(s):
                if edges:
                    fill_pairwise_edges(pad, mesh.local_shape, w, bc_value)
                pad[inner] = u
        if edges:
            self._edges_bc = bc_value

    def push_faces(self, us: Sequence[torch.Tensor], bc_value: float) -> None:
        """The rest of an exchange, every ghost slab: pairwise, all shards'
        raw faces of ``us`` at once, then one wait; else axis by axis, each
        shard's face slabs of its block (the slab copies, or the DMA
        kernels on an axis of mesh size >= 2, one epoch an exchange)."""
        mesh, w, p = self.mesh, self.width, self.periodic
        wire, sched = self.wire, self.schedule
        if self.halo_order == "pairwise":
            self._push_axes((0, 1, 2), lambda s: push_pairwise_faces(
                self.pads, us, mesh, s, w, p, bc_value, sched, wire),
                lambda s: recv_pairwise_faces(wire, self.pads, mesh, s, w, p, sched))
            return
        if self.dma is not None:
            self.dma.epoch += 1
        for axis in range(3):
            # per-axis range nested under heat3d.halo_exchange: a trace
            # attributes each axis's copies or DMA launches to it
            with named_phase(f"halo.{AXIS_NAMES[axis]}"):
                if self.dma is not None and mesh.shape[axis] > 1:
                    from heat3d_tpu_torch.ops.halo_dma import exchange_axis_dma

                    exchange_axis_dma(self.pads, mesh, axis, w, p, bc_value,
                                      self.dma, self.sync)
                else:
                    self._push_axes((axis,), lambda s, axis=axis: push_axis_slabs(
                        self.pads, mesh, s, axis, w, p, bc_value, sched, wire),
                        lambda s, axis=axis: recv_axis_slabs(
                            wire, self.pads, mesh, s, axis, w, p, sched))


class BatchedExchangePlan:
    """The axis-ordered ppermute exchange of a batch of fields (the
    ensemble's members, ``serve.ensemble``) over one mesh of shards: per
    shard a padded block with a leading batch extent, ``(B, n + 2w)``,
    allocated once and reused by every apply. The ghosts of member m are
    those of a width-``width`` :class:`ExchangePlan` apply of member m
    alone with its own boundary value (byte-equal), but the fills come from
    a (B, 1, 1, 1) storage-dtype tensor, so no member's value is read on
    the host. One process; every copy on the current stream, in shard
    order (no shard streams, so no events); faces ship whole (a
    partitioned plan's sub-blocks carry the same bytes)."""

    def __init__(self, mesh, bc: BoundaryCondition, width: int, dtype: torch.dtype,
                 batch: int):
        if mesh.multiprocess:
            raise ValueError("the batched exchange runs in one process")
        _check_width(mesh.local_shape, width)
        self.mesh = mesh
        self.bc = bc
        self.width = width
        self.dtype = dtype
        self.batch = batch
        want = (batch,) + padded_shape(mesh.local_shape, width)
        self.pads: List[torch.Tensor] = [
            torch.empty(want, dtype=dtype, device=s.device) for s in mesh.local_shards
        ]

    def apply(self, us: Sequence[torch.Tensor], bcv: torch.Tensor) -> List[torch.Tensor]:
        """The padded blocks of the batched fields ``us`` (rank order, each
        (B, nx, ny, nz)), ghosts filled, valid until the next apply."""
        mesh, w = self.mesh, self.width
        periodic = self.bc is BoundaryCondition.PERIODIC
        inner = interior(mesh.local_shape, w)
        with named_phase("halo_exchange"):
            for u, pad in zip(us, self.pads):
                pad[inner] = u
            for axis in range(3):
                with named_phase(f"halo.{AXIS_NAMES[axis]}"):
                    exchange_axis_slabs(self.pads, mesh, axis, w, periodic, bcv)
            return self.pads


class FacesPlan(_Plan):
    """``exchange_halo_faces`` of one (mesh, bc, width, dtype): the six
    ghost face buffers of every shard (ppermute transport)."""

    def __init__(self, mesh, bc: BoundaryCondition, width: int, dtype: torch.dtype):
        super().__init__(mesh, bc, width)
        self.faces = [
            tuple(self.alloc(sh, dtype, s.device)
                  for sh in face_shapes(mesh.local_shape, width))
            for s in mesh.local_shards
        ]
        self._connect(self.faces)

    def apply(self, us: Sequence[torch.Tensor], bc_value: float,
              x_ghosts: Optional[Sequence[tuple]] = None) -> List[tuple]:
        """Per shard (rank order) its ghost faces (xlo, xhi, ylo, yhi, zlo,
        zhi): x faces (w, ny, nz), y faces (nx+2w, w, nz), z faces
        (nx+2w, ny+2w, w), valid until the next ``apply``. ``x_ghosts``
        (per shard ``(xlo, xhi)``, each (w, ny, nz) or (ny, nz) at w=1,
        bc already at Dirichlet x domain faces) are x faces that landed
        another way: they are copied in and the x transfer is skipped; the
        y/z copies carry their corners as usual."""
        mesh, w, p = self.mesh, self.width, self.periodic
        with named_phase("halo_exchange"):
            self.sync.begin_exchange()
            for s in mesh.local_shards:
                self.sync.enter(s)
            if x_ghosts is not None:
                for s, (xlo, xhi) in zip(mesh.local_shards, x_ghosts):
                    with mesh.on(s):
                        mine = self.faces[s.slot]
                        mine[0].copy_(xlo.reshape(mine[0].shape))
                        mine[1].copy_(xhi.reshape(mine[1].shape))
            for axis in range(0 if x_ghosts is None else 1, 3):
                with named_phase(f"halo.{AXIS_NAMES[axis]}"):
                    self._push_axes((axis,), lambda s, axis=axis: push_axis_faces(
                        us, self.faces, mesh, s, axis, w, p, bc_value, self.wire),
                        lambda s, axis=axis: recv_axis_faces(
                            self.wire, self.faces, mesh, s, axis, p))
            return self.faces


class Exchanges:
    """The plans of one solver, built on first use: padded-block plans by
    width, face plans by width, and the fused kernels' states by width and
    send ranges. ``mode`` and ``halo_order`` are the plan mode and ordering
    of the padded-block plans."""

    def __init__(self, mesh, bc: BoundaryCondition, transport: str = "ppermute",
                 mode: str = "monolithic", halo_order: str = "axis"):
        for knob, value in (("halo", transport), ("halo_plan", mode)):
            if value == "auto":
                raise ValueError(
                    f"the exchange plans got the unresolved auto knob {knob}='auto': "
                    "resolve the config first (heat3d_tpu_torch.tune.resolve_config)")
        self.mesh = mesh
        self.bc = bc
        self.transport = transport
        self.mode = mode
        self.halo_order = halo_order
        self.plans = {}
        self.face_plans = {}
        self.fused_states = {}

    def schedule(self, width: int, mode: Optional[str] = None) -> Schedule:
        """The message schedule of this solver's width-``width`` exchange,
        in plan mode ``mode`` (default: the plans' own)."""
        return make_schedule(self.mesh.shape, width, mode or self.mode, self.halo_order)

    def plan(self, width: int, dtype: torch.dtype) -> ExchangePlan:
        p = self.plans.get(width)
        if p is None or p.dtype != dtype:
            p = self.plans[width] = ExchangePlan(
                self.mesh, self.bc, width, self.transport, dtype, self.mode,
                self.halo_order)
        return p

    def faces(self, width: int, dtype: torch.dtype) -> FacesPlan:
        p = self.face_plans.get(width)
        if p is None or p.faces[0][0].dtype != dtype:
            p = self.face_plans[width] = FacesPlan(self.mesh, self.bc, width, dtype)
        return p

    def fused(self, width: int, dtype: torch.dtype, bounds=None):
        """The fused kernels' state (``ops.stencil_dma_fused.FusedState``)
        of width ``width`` and send ranges ``bounds`` (default: whole
        faces), built on first use, on the stream its kernels run on."""
        from heat3d_tpu_torch.ops.stencil_dma_fused import FusedState

        key = (width, dtype, None if bounds is None else tuple(bounds))
        st = self.fused_states.get(key)
        if st is None:
            st = self.fused_states[key] = FusedState(
                self.mesh, width, dtype, self.bc is BoundaryCondition.PERIODIC, bounds)
        return st
