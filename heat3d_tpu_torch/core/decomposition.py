"""Cartesian domain-decomposition index math.

Reference parity (SURVEY.md §2 C3): the reference computes local extents
``nx = NX/Px`` (plus remainder handling) and neighbor ranks from
MPI_Cart_create/MPI_Cart_shift. On TPU the sharding machinery owns data
placement, but explicit extent math is still needed for: checkpoint
shard naming, per-shard initial conditions, tests of uneven division, and
the golden-vs-distributed comparisons.

Coordinates are lexicographic: rank = (px*Py + py)*Pz + pz, matching both
MPI_Cart_create's row-major default and jax.sharding.Mesh device order.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


def coords_of_rank(rank: int, mesh_shape: Tuple[int, int, int]) -> Tuple[int, int, int]:
    px_, py_, pz_ = mesh_shape
    if not (0 <= rank < px_ * py_ * pz_):
        raise ValueError(f"rank {rank} out of range for mesh {mesh_shape}")
    pz = rank % pz_
    py = (rank // pz_) % py_
    px = rank // (pz_ * py_)
    return (px, py, pz)


def rank_of_coords(coords: Tuple[int, int, int], mesh_shape: Tuple[int, int, int]) -> int:
    px, py, pz = coords
    px_, py_, pz_ = mesh_shape
    if not (0 <= px < px_ and 0 <= py < py_ and 0 <= pz < pz_):
        raise ValueError(f"coords {coords} out of range for mesh {mesh_shape}")
    return (px * py_ + py) * pz_ + pz


def neighbor_rank(
    rank: int,
    mesh_shape: Tuple[int, int, int],
    axis: int,
    direction: int,
    periodic: bool,
) -> int | None:
    """MPI_Cart_shift analogue: rank of the neighbor one step along ``axis``
    in ``direction`` (+1/-1); None at a non-periodic edge (MPI_PROC_NULL)."""
    coords = list(coords_of_rank(rank, mesh_shape))
    coords[axis] += direction
    if periodic:
        coords[axis] %= mesh_shape[axis]
    elif not (0 <= coords[axis] < mesh_shape[axis]):
        return None
    return rank_of_coords(tuple(coords), mesh_shape)


def local_extent(global_n: int, parts: int, index: int) -> Tuple[int, int]:
    """(start, size) of block ``index`` of ``global_n`` cells over ``parts``
    blocks. Handles uneven division the canonical way (first ``global_n %
    parts`` blocks get one extra cell) — SURVEY.md §7.3 item 4. Note the
    distributed execution path takes a different route for uneven grids
    (equal blocks over a bc-padded storage shape, SolverConfig.padded_shape);
    this function is the general contract used by tests and checkpoint
    indexing."""
    if not (0 <= index < parts):
        raise ValueError(f"index {index} out of range for {parts} parts")
    base, rem = divmod(global_n, parts)
    size = base + (1 if index < rem else 0)
    start = index * base + min(index, rem)
    return start, size


@dataclasses.dataclass(frozen=True)
class Subdomain:
    """One rank's block of the global grid: offsets and sizes per axis."""

    rank: int
    coords: Tuple[int, int, int]
    start: Tuple[int, int, int]
    shape: Tuple[int, int, int]

    @property
    def slices(self) -> Tuple[slice, slice, slice]:
        return tuple(slice(s, s + n) for s, n in zip(self.start, self.shape))  # type: ignore[return-value]


def subdomain(
    rank: int,
    grid_shape: Tuple[int, int, int],
    mesh_shape: Tuple[int, int, int],
) -> Subdomain:
    coords = coords_of_rank(rank, mesh_shape)
    ext = [local_extent(g, p, c) for g, p, c in zip(grid_shape, mesh_shape, coords)]
    return Subdomain(
        rank=rank,
        coords=coords,
        start=tuple(e[0] for e in ext),  # type: ignore[arg-type]
        shape=tuple(e[1] for e in ext),  # type: ignore[arg-type]
    )


def all_subdomains(grid_shape, mesh_shape):
    n = mesh_shape[0] * mesh_shape[1] * mesh_shape[2]
    return [subdomain(r, grid_shape, mesh_shape) for r in range(n)]
