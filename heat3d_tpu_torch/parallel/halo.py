"""Ghost-cell halo exchange of the field's shards.

Port of ``heat3d_tpu.parallel.halo``. Exchanges are axis-ordered (x, then
y, then z), each axis moving slabs of the blocks the earlier axes already
padded, so edge and corner ghosts equal a global pad. Dirichlet ghosts at
domain faces hold ``bc_value`` rounded to the storage dtype; periodic ghosts
wrap (on an axis of mesh size 1, a shard's own opposite faces: the
self-wrap).

- :func:`exchange_halo`: one device's whole block (a (1,1,1) mesh), into a
  padded buffer; byte-equal to the JAX ``exchange(u, cfg, width)`` there.
  ``parallel.plan.ExchangePlan`` runs it on a one-shard mesh.
- :func:`push_axis_slabs`: one shard's part of one axis of the sharded
  exchange, the ``ppermute`` transport: the shard's two width-w face slabs
  (full padded extent on earlier axes, interior on later ones) copied into
  the opposite ghost slabs of its neighbours' padded blocks, or its own
  domain-face ghosts filled. It is also the plain version of the DMA halo
  kernel (``ops.halo_dma``). ``parallel.plan.ExchangePlan`` runs it over
  every shard and orders the shards' streams.
- :func:`push_axis_faces`: the same for ``exchange_halo_faces`` (the
  faces-direct step): the six ghost faces of each shard without its padded
  block, y faces x-extended and z faces x+y-extended, corners included.

It is data movement: the result is byte-equal to the JAX package's
``exchange``/``exchange_halo_faces`` under ``shard_map``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from heat3d_tpu_torch.core.config import BoundaryCondition


def padded_shape(shape, width: int):
    return tuple(n + 2 * width for n in shape)


def axis_slab(axis: int, lo: int, hi: int, local_shape, width: int):
    """Index of the padded-block slab [lo, hi) along ``axis``, spanning the
    padded extent of earlier axes and the interior of later ones: what
    axis ``axis`` of the axis-ordered exchange reads and writes."""
    return tuple(
        slice(lo, hi) if a == axis
        else slice(None) if a < axis
        else slice(width, width + n)
        for a, n in enumerate(local_shape)
    )


def interior(local_shape, width: int):
    return tuple(slice(width, width + n) for n in local_shape)


def _check_width(shape, width: int) -> None:
    if width < 1:
        raise ValueError(f"halo width must be >= 1, got {width}")
    for axis, n in enumerate(shape):
        if n < width:
            raise ValueError(
                f"halo width {width} exceeds local extent {n} on axis {axis}"
            )


def exchange_halo(
    u: torch.Tensor,
    bc: BoundaryCondition,
    bc_value: float = 0.0,
    width: int = 1,
    out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """(nx, ny, nz) -> (nx+2w, ny+2w, nz+2w) with the ghosts filled, for a
    block that is the whole domain. Raises, as the JAX ``exchange_axis``
    does, when an extent is smaller than the width. ``out`` (optional) is
    the padded buffer to fill; it must not overlap ``u``."""
    if u.dim() != 3:
        raise ValueError(f"field must be 3-D, got shape {tuple(u.shape)}")
    _check_width(u.shape, width)
    want = padded_shape(u.shape, width)
    if out is None:
        out = torch.empty(want, dtype=u.dtype, device=u.device)
    elif tuple(out.shape) != want or out.dtype != u.dtype or out.device != u.device:
        raise ValueError(
            f"out must be the padded buffer {want} {u.dtype} {u.device}, got "
            f"{tuple(out.shape)} {out.dtype} {out.device}"
        )
    out[interior(u.shape, width)] = u
    periodic = bc is BoundaryCondition.PERIODIC
    for axis in range(3):
        _self_axis(out, tuple(u.shape), axis, width, periodic, bc_value)
    return out


def _self_axis(pad, local_shape, axis, w, periodic, bc_value) -> None:
    """Axis ``axis`` of a block with no neighbour along it: the self-wrap
    (periodic) or the bc fill of both ghost slabs."""
    n = local_shape[axis]
    lo_ghost = axis_slab(axis, 0, w, local_shape, w)
    hi_ghost = axis_slab(axis, n + w, n + 2 * w, local_shape, w)
    if periodic:
        pad[lo_ghost] = pad[axis_slab(axis, n, n + w, local_shape, w)]
        pad[hi_ghost] = pad[axis_slab(axis, w, 2 * w, local_shape, w)]
    else:
        pad[lo_ghost] = bc_value
        pad[hi_ghost] = bc_value


def push_axis_slabs(pads: Sequence[torch.Tensor], mesh, shard, axis: int,
                    width: int, periodic: bool, bc_value: float) -> None:
    """Shard ``shard``'s part of axis ``axis`` of the sharded exchange into
    the padded blocks ``pads`` (rank order), on the current stream: its low
    face slab into its low neighbour's high ghost slab and its high face
    slab into its high neighbour's low ghost slab; at a Dirichlet domain
    face its own ghost slab is filled with ``bc_value``; on an axis of mesh
    size 1, the self-wrap. The face slabs carry the ghosts of earlier axes,
    so those must have landed."""
    local, w = mesh.local_shape, width
    pad = pads[shard.rank]
    if mesh.shape[axis] == 1:
        _self_axis(pad, local, axis, w, periodic, bc_value)
        return
    n = local[axis]
    for direction, face, ghost in (
        (-1, (w, 2 * w), (n + w, n + 2 * w)),  # low face -> low nb's high ghost
        (+1, (n, n + w), (0, w)),              # high face -> high nb's low ghost
    ):
        nb = mesh.neighbor(shard, axis, direction, periodic)
        if nb is None:
            own = (0, w) if direction < 0 else (n + w, n + 2 * w)
            pad[axis_slab(axis, *own, local, w)] = bc_value
        else:
            pads[nb.rank][axis_slab(axis, *ghost, local, w)].copy_(
                pad[axis_slab(axis, *face, local, w)]
            )


def exchange_axis_slabs(pads, mesh, axis, width, periodic, bc_value) -> None:
    """One axis of the sharded exchange for every shard, in rank order on
    the current stream (the plain version of the DMA halo kernel)."""
    for shard in mesh.shards:
        push_axis_slabs(pads, mesh, shard, axis, width, periodic, bc_value)


# ---- faces only (the faces-direct step) ------------------------------------


def face_shapes(local_shape, width: int):
    """Shapes of the six ghost faces (xlo, xhi, ylo, yhi, zlo, zhi)."""
    n0, n1, n2 = local_shape
    w = width
    x, y, z = (w, n1, n2), (n0 + 2 * w, w, n2), (n0 + 2 * w, n1 + 2 * w, w)
    return (x, x, y, y, z, z)


def _send_parts(u: torch.Tensor, faces, axis: int, low: bool, w: int):
    """The send face of ``u`` along ``axis`` (its low or high width-w
    boundary), as ``(index in the receiving face buffer, source view)``
    parts: x faces are raw, y faces carry the x ghosts, z faces the x and y
    ghosts (how the axis order propagates corners)."""
    n0, n1, _ = u.shape
    n = u.shape[axis]
    sl = slice(0, w) if low else slice(n - w, n)
    full = slice(None)
    if axis == 0:
        return [((full,), u[sl])]
    xlo, xhi = faces[0], faces[1]
    if axis == 1:
        return [
            ((slice(0, w),), xlo[:, sl]),
            ((slice(w, w + n0),), u[:, sl]),
            ((slice(w + n0, None),), xhi[:, sl]),
        ]
    ylo, yhi = faces[2], faces[3]
    mid = slice(w, w + n1)
    return [
        ((full, slice(0, w)), ylo[:, :, sl]),
        ((slice(0, w), mid), xlo[:, :, sl]),
        ((slice(w, w + n0), mid), u[:, :, sl]),
        ((slice(w + n0, None), mid), xhi[:, :, sl]),
        ((full, slice(w + n1, None)), yhi[:, :, sl]),
    ]


def _write_parts(dst: torch.Tensor, parts) -> None:
    for idx, src in parts:
        dst[idx].copy_(src)


def push_axis_faces(us: Sequence[torch.Tensor], faces: List[tuple], mesh, shard,
                    axis: int, width: int, periodic: bool, bc_value: float) -> None:
    """Shard ``shard``'s part of axis ``axis`` of ``exchange_halo_faces`` on
    the current stream: its send faces into its neighbours' ghost face
    buffers (``faces[rank]`` = the six buffers of that shard), its own
    domain-face ghosts filled with ``bc_value``, or the self-wrap."""
    u, mine = us[shard.rank], faces[shard.rank]
    lo_i, hi_i = 2 * axis, 2 * axis + 1
    if mesh.shape[axis] == 1:
        if periodic:
            _write_parts(mine[lo_i], _send_parts(u, mine, axis, False, width))
            _write_parts(mine[hi_i], _send_parts(u, mine, axis, True, width))
        else:
            mine[lo_i].fill_(bc_value)
            mine[hi_i].fill_(bc_value)
        return
    for direction, own, theirs in ((-1, lo_i, hi_i), (+1, hi_i, lo_i)):
        nb = mesh.neighbor(shard, axis, direction, periodic)
        if nb is None:
            mine[own].fill_(bc_value)
        else:
            _write_parts(faces[nb.rank][theirs],
                         _send_parts(u, mine, axis, direction < 0, width))
