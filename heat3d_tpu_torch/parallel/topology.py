"""The mesh of shards: which device and stream each shard of the field
lives on, where it sits in the global grid, and who its neighbours are.

Port of ``heat3d_tpu.parallel.topology`` (``build_mesh``) and of the
neighbour graph of ``heat3d_tpu.parallel.halo.shift_perm``. The JAX package
runs one controller over a ``jax.sharding.Mesh`` of devices; so does the
port: one process holds a :class:`ShardMesh` whose shards are tensors, each
on its own device. By default shard i (rank order of
``core.decomposition.coords_of_rank``) is on ``cuda:i`` and building the
mesh raises when too few GPUs are visible; an explicit ``device`` puts every
shard on that one device (``device="cpu"`` for the tests, ``cuda:0`` to run
a sharded solve on one card).

On CUDA, a mesh of several shards gives each shard a stream of its own, even
when shards share a device: the shard's work runs on it (``mesh.on(shard)``)
and the halo exchange orders the streams with events (``parallel.plan``).
``fork``/``join`` tie the shard streams to the caller's current streams, so
a caller that launches on its current stream sees the solver's work in
order. A one-shard mesh runs on the caller's current stream.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import List, Optional, Tuple, Union

import torch

from heat3d_tpu_torch.core.config import SolverConfig
from heat3d_tpu_torch.core.decomposition import coords_of_rank, rank_of_coords


def shift_perm(n: int, direction: int, periodic: bool):
    """(source, dest) pairs shifting data one step along a ring of size n:
    ``direction=+1`` sends shard i's slab to shard i+1. Non-periodic drops
    the wrap pair. The same neighbour graph as the JAX package's."""
    if periodic:
        return [(i, (i + direction) % n) for i in range(n)]
    if direction > 0:
        return [(i, i + 1) for i in range(n - 1)]
    return [(i, i - 1) for i in range(1, n)]


@dataclasses.dataclass(eq=False)
class Shard:
    """One shard of the field: its rank and mesh coordinates, its device and
    stream (None: the caller's current stream), its origin in the global
    storage grid, and whether it touches each domain face (``edges``:
    x_lo, x_hi, y_lo, y_hi, z_lo, z_hi)."""

    rank: int
    coords: Tuple[int, int, int]
    device: torch.device
    stream: Optional["torch.cuda.Stream"]
    origin: Tuple[int, int, int]
    edges: Tuple[bool, bool, bool, bool, bool, bool]


class ShardMesh:
    """The shards of one (Px, Py, Pz) mesh over a ``local_shape`` block
    each, in rank order."""

    def __init__(self, shape, local_shape, devices: List[torch.device]):
        self.shape = tuple(shape)
        self.local_shape = tuple(local_shape)
        n = self.shape[0] * self.shape[1] * self.shape[2]
        if len(devices) != n:
            raise ValueError(f"mesh {self.shape} needs {n} devices, got {len(devices)}")
        streams = n > 1
        self.shards: List[Shard] = []
        for rank, dev in enumerate(devices):
            coords = coords_of_rank(rank, self.shape)
            edges = tuple(
                e for c, p in zip(coords, self.shape) for e in (c == 0, c == p - 1)
            )
            stream = (
                torch.cuda.Stream(device=dev) if streams and dev.type == "cuda" else None
            )
            self.shards.append(Shard(
                rank, coords, dev, stream,
                tuple(c * m for c, m in zip(coords, self.local_shape)), edges,
            ))

    def __len__(self) -> int:
        return len(self.shards)

    @property
    def devices(self) -> List[torch.device]:
        return [s.device for s in self.shards]

    def at(self, coords) -> Shard:
        return self.shards[rank_of_coords(tuple(coords), self.shape)]

    def neighbor(self, shard: Shard, axis: int, direction: int,
                 periodic: bool) -> Optional[Shard]:
        """The shard one step along ``axis`` in ``direction`` (+1/-1), or
        None at a non-periodic domain face (``shift_perm``'s dropped pair)."""
        c = list(shard.coords)
        c[axis] += direction
        if periodic:
            c[axis] %= self.shape[axis]
        elif not 0 <= c[axis] < self.shape[axis]:
            return None
        return self.at(c)

    def on(self, shard: Shard):
        """Context in which the shard's work is launched: its stream."""
        if shard.stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(shard.stream)

    def fork(self) -> None:
        """Every shard stream waits for its device's current stream (the
        caller's inputs are ready before the shards read them)."""
        for s in self.shards:
            if s.stream is not None:
                s.stream.wait_stream(torch.cuda.current_stream(s.device))

    def join(self) -> None:
        """Every device's current stream waits for the shard streams on it
        (the caller sees the shards' results in order)."""
        for s in self.shards:
            if s.stream is not None:
                torch.cuda.current_stream(s.device).wait_stream(s.stream)


def mesh_devices(n: int, device: Union[str, torch.device, None]) -> List[torch.device]:
    """One device per shard: ``cuda:i`` for shard i by default (raising when
    fewer than n GPUs are visible, as ``build_mesh`` raises), else the one
    explicit ``device`` (cpu or cuda) for every shard. Without CUDA only an
    explicit cpu device is accepted: the port never drops to the CPU on its
    own."""
    if device is not None:
        device = torch.device(device)
        if device.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {device}")
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {device} requested but CUDA is not available")
        return [device] * n
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: heat3d_tpu_torch runs on the GPU; pass "
            "device='cpu' explicitly to run the kernels' plain versions"
        )
    avail = torch.cuda.device_count()
    if n == 1:
        return [torch.device("cuda", torch.cuda.current_device())]
    if avail < n:
        raise ValueError(
            f"mesh of {n} shards needs {n} devices, only {avail} visible "
            "(pass device='cuda:0' to put every shard on one card)"
        )
    return [torch.device("cuda", i) for i in range(n)]


def build_shard_mesh(cfg: SolverConfig, device=None) -> ShardMesh:
    """The ShardMesh of ``cfg.mesh`` over ``cfg.local_shape`` blocks."""
    return ShardMesh(
        cfg.mesh.shape, cfg.local_shape, mesh_devices(cfg.mesh.num_devices, device)
    )
