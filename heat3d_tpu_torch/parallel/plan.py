"""Persistent halo-exchange plans over a mesh of shards.

Port of the monolithic subset of ``heat3d_tpu.parallel.plan``
(``ExchangePlan``, ``plan_for``): a plan is built once per (mesh, boundary
condition, width, transport, storage dtype) and reused by every step. It
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
  (``push_axis_slabs``), or the ``dma`` transport launches the push/wait
  kernels (``ops.halo_dma.exchange_axis_dma``).

Stream order (:class:`StreamSync`, CUDA meshes of several shards, one
stream per shard): at the start of an exchange each shard records an
"entered" event, after all its earlier work on its block, so a neighbour's
push into that block waits for it (the TPU kernel's neighbour barrier);
on the ppermute transport each shard records a "pushed" event after its
pushes of an axis and its neighbours wait for it before the next axis or
the compute; on the DMA transport the wait kernels take that place.

:class:`FacesPlan` is the same for ``exchange_halo_faces`` (the
faces-direct step): six ghost face buffers per shard and no padded block.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from heat3d_tpu_torch.core.config import BoundaryCondition
from heat3d_tpu_torch.parallel.halo import (
    _check_width,
    exchange_halo,
    face_shapes,
    interior,
    padded_shape,
    push_axis_faces,
    push_axis_slabs,
)

TRANSPORTS = ("ppermute", "dma")


class StreamSync:
    """The events of the exchange protocol, one pair per shard; every call
    is a no-op on the CPU and on a one-shard mesh (one stream)."""

    def __init__(self, mesh):
        self.mesh = mesh
        on = [s.stream is not None for s in mesh.shards]
        self.entered = [torch.cuda.Event() if x else None for x in on]
        self.pushed = [torch.cuda.Event() if x else None for x in on]

    def enter(self, shard) -> None:
        """On the shard's stream: its earlier work on its blocks is done."""
        if shard.stream is not None:
            self.entered[shard.rank].record(shard.stream)

    def wait_entered(self, shard, target) -> None:
        """The shard's stream waits until ``target`` has entered."""
        if shard.stream is not None and target is not shard:
            shard.stream.wait_event(self.entered[target.rank])

    def push_done(self, shard) -> None:
        if shard.stream is not None:
            self.pushed[shard.rank].record(shard.stream)

    def wait_pushes(self, shard, sources) -> None:
        """The shard's stream waits for the pushes of ``sources``."""
        if shard.stream is None:
            return
        for src in sources:
            if src is not None and src is not shard:
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

    @property
    def periodic(self) -> bool:
        return self.bc is BoundaryCondition.PERIODIC

    def _push_axis(self, axis: int, push) -> None:
        """One axis on the ppermute transport: every shard pushes (after its
        targets entered), then every shard waits for its neighbours'."""
        mesh, sync, p = self.mesh, self.sync, self.periodic
        for s in mesh.shards:
            for nb in _neighbors(mesh, s, axis, p):
                if nb is not None:
                    sync.wait_entered(s, nb)
            with mesh.on(s):
                push(s)
            sync.push_done(s)
        if mesh.shape[axis] > 1:
            for s in mesh.shards:
                sync.wait_pushes(s, _neighbors(mesh, s, axis, p))


class ExchangePlan(_Plan):
    """The padded-block exchange of one (mesh, bc, width, transport, dtype)."""

    def __init__(self, mesh, bc: BoundaryCondition, width: int,
                 transport: str, dtype: torch.dtype):
        if transport not in TRANSPORTS:
            raise ValueError(f"unknown halo transport {transport!r}")
        super().__init__(mesh, bc, width)
        self.transport = transport
        self.dtype = dtype
        want = padded_shape(mesh.local_shape, width)
        self.pads: List[torch.Tensor] = [
            torch.empty(want, dtype=dtype, device=s.device) for s in mesh.shards
        ]
        self.dma = None
        if transport == "dma" and len(mesh) > 1:
            from heat3d_tpu_torch.ops.halo_dma import DmaState

            self.dma = DmaState(mesh)

    def apply(self, us: Sequence[torch.Tensor], bc_value: float) -> List[torch.Tensor]:
        """The padded blocks of the fields ``us`` (rank order), ghosts
        filled: ``(n + 2w)`` per axis. The blocks are the plan's own, valid
        until its next ``apply``."""
        mesh, w, p = self.mesh, self.width, self.periodic
        if len(mesh) == 1:
            exchange_halo(us[0], self.bc, bc_value, w, out=self.pads[0])
            return self.pads
        inner = interior(mesh.local_shape, w)
        for s, u, pad in zip(mesh.shards, us, self.pads):
            self.sync.enter(s)
            with mesh.on(s):
                pad[inner] = u
        if self.dma is not None:
            self.dma.epoch += 1
        for axis in range(3):
            if self.dma is not None and mesh.shape[axis] > 1:
                from heat3d_tpu_torch.ops.halo_dma import exchange_axis_dma

                exchange_axis_dma(self.pads, mesh, axis, w, p, bc_value,
                                  self.dma, self.sync)
            else:
                self._push_axis(axis, lambda s, axis=axis: push_axis_slabs(
                    self.pads, mesh, s, axis, w, p, bc_value))
        return self.pads


class FacesPlan(_Plan):
    """``exchange_halo_faces`` of one (mesh, bc, width, dtype): the six
    ghost face buffers of every shard (ppermute transport)."""

    def __init__(self, mesh, bc: BoundaryCondition, width: int, dtype: torch.dtype):
        super().__init__(mesh, bc, width)
        self.faces = [
            tuple(torch.empty(sh, dtype=dtype, device=s.device)
                  for sh in face_shapes(mesh.local_shape, width))
            for s in mesh.shards
        ]

    def apply(self, us: Sequence[torch.Tensor], bc_value: float) -> List[tuple]:
        """Per shard (rank order) its ghost faces (xlo, xhi, ylo, yhi, zlo,
        zhi): x faces (w, ny, nz), y faces (nx+2w, w, nz), z faces
        (nx+2w, ny+2w, w), valid until the next ``apply``."""
        mesh, w, p = self.mesh, self.width, self.periodic
        for s in mesh.shards:
            self.sync.enter(s)
        for axis in range(3):
            self._push_axis(axis, lambda s, axis=axis: push_axis_faces(
                us, self.faces, mesh, s, axis, w, p, bc_value))
        return self.faces


class Exchanges:
    """The plans of one solver, built on first use: padded-block plans by
    width, face plans by width."""

    def __init__(self, mesh, bc: BoundaryCondition, transport: str = "ppermute"):
        self.mesh = mesh
        self.bc = bc
        self.transport = transport
        self.plans = {}
        self.face_plans = {}

    def plan(self, width: int, dtype: torch.dtype) -> ExchangePlan:
        p = self.plans.get(width)
        if p is None or p.dtype != dtype:
            p = self.plans[width] = ExchangePlan(
                self.mesh, self.bc, width, self.transport, dtype)
        return p

    def faces(self, width: int, dtype: torch.dtype) -> FacesPlan:
        p = self.face_plans.get(width)
        if p is None or p.faces[0][0].dtype != dtype:
            p = self.face_plans[width] = FacesPlan(self.mesh, self.bc, width, dtype)
        return p
