"""Ghost-cell halo exchange of one device's block.

Port of the single-device form of ``heat3d_tpu.parallel.halo``
(``exchange_halo`` / ``exchange_axis`` on a (1,1,1) mesh, where every face
is a domain face): the block grows by ``width`` ghost layers per side,
axis by axis (x, then y, then z), each axis padding the array the earlier
axes already padded, so edge and corner ghosts equal a global pad.
Dirichlet ghosts hold ``bc_value`` rounded to the storage dtype; periodic
ghosts are the block's own opposite faces (the self-wrap).

It is data movement (the JAX exchange is XLA concatenates): the interior
and the face slabs are copied into a padded buffer, which the caller may
preallocate once and pass as ``out``. The result is byte-equal to the JAX
package's ``exchange(u, cfg, width)`` on a (1,1,1) mesh.
"""

from __future__ import annotations

from typing import Optional

import torch

from heat3d_tpu_torch.core.config import BoundaryCondition


def padded_shape(shape, width: int):
    return tuple(n + 2 * width for n in shape)


def exchange_halo(
    u: torch.Tensor,
    bc: BoundaryCondition,
    bc_value: float = 0.0,
    width: int = 1,
    out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """(nx, ny, nz) -> (nx+2w, ny+2w, nz+2w) with the ghosts filled.
    Raises, as the JAX ``exchange_axis`` does, when an extent is smaller
    than the width. ``out`` (optional) is the padded buffer to fill; it
    must not overlap ``u``."""
    if u.dim() != 3:
        raise ValueError(f"field must be 3-D, got shape {tuple(u.shape)}")
    if width < 1:
        raise ValueError(f"halo width must be >= 1, got {width}")
    for axis, n in enumerate(u.shape):
        if n < width:
            raise ValueError(
                f"halo width {width} exceeds local extent {n} on axis {axis}"
            )
    want = padded_shape(u.shape, width)
    if out is None:
        out = torch.empty(want, dtype=u.dtype, device=u.device)
    elif tuple(out.shape) != want or out.dtype != u.dtype or out.device != u.device:
        raise ValueError(
            f"out must be the padded buffer {want} {u.dtype} {u.device}, got "
            f"{tuple(out.shape)} {out.dtype} {out.device}"
        )
    w = width
    nx, ny, nz = u.shape
    out[w : w + nx, w : w + ny, w : w + nz] = u
    periodic = bc is BoundaryCondition.PERIODIC
    # axis by axis: axis a's ghost slabs span the extents the earlier axes
    # already padded (and only the interior of the later ones)
    for axis, n in enumerate((nx, ny, nz)):
        span = [
            slice(None) if a < axis else slice(w, w + m)
            for a, m in enumerate((nx, ny, nz))
        ]

        def at(lo: int, hi: int):
            idx = list(span)
            idx[axis] = slice(lo, hi)
            return tuple(idx)

        if periodic:
            out[at(0, w)] = out[at(n, n + w)]
            out[at(n + w, n + 2 * w)] = out[at(w, 2 * w)]
        else:
            out[at(0, w)] = bc_value
            out[at(n + w, n + 2 * w)] = bc_value
    return out
