"""Plain PyTorch stencil update: the contract every kernel is held against.

Port of ``heat3d_tpu.ops.stencil_jnp``: the same shifted-slice tap chain,
in the same ``core.stencils.accumulate_taps`` emission order, on tensors.
Eager PyTorch runs each multiply and each add as its own rounded operation
(no FMA contraction), so a CUDA kernel that evaluates the chain with
``__fmul_rn``/``__fadd_rn`` in the same order equals it bitwise on the same
device. These functions run on any device; on the CPU they are the stand-in
for the kernels (``ops.stencil_direct``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from heat3d_tpu_torch.core.config import BoundaryCondition
from heat3d_tpu_torch.core.stencils import accumulate_taps, flat_taps


def pad_local(
    u: torch.Tensor, bc: BoundaryCondition, bc_value: float = 0.0
) -> torch.Tensor:
    """Single-device ghost pad: the whole domain boundary is local.

    Dirichlet ghosts hold ``bc_value`` rounded to the field's dtype;
    periodic ghosts wrap (index arithmetic, so any extent >= 1 works)."""
    if bc is BoundaryCondition.PERIODIC:
        idx = [
            torch.arange(-1, n + 1, device=u.device) % n for n in u.shape
        ]
        return u[idx[0]][:, idx[1]][:, :, idx[2]]
    return F.pad(u, (1, 1, 1, 1, 1, 1), mode="constant", value=bc_value)


def apply_taps_padded(up: torch.Tensor, taps: np.ndarray) -> torch.Tensor:
    """Apply 3x3x3 update taps to a ghost-padded ``up`` of shape
    (nx+2, ny+2, nz+2); returns the (nx, ny, nz) interior update in
    ``up``'s dtype, computed in float32 (the port's one compute dtype).
    Tap weights are embedded as ``np.float32(w)``, the rounding
    ``jnp.asarray(w, float32)`` applies."""
    flat = flat_taps(taps)
    if not flat:
        raise ValueError("stencil has no taps")
    acc = _chain_accumulate(up.float(), flat, lambda w: float(np.float32(w)))
    return acc.to(up.dtype)


def _chain_accumulate(upc: torch.Tensor, flat, scalar) -> torch.Tensor:
    """THE shifted-slice emission of the tap chain over a ghost-padded
    compute-dtype tensor ``upc``; the plane/row caches are the x/y
    factoring reuse that accumulate_taps' emission order assumes."""
    nx, ny, nz = upc.shape[0] - 2, upc.shape[1] - 2, upc.shape[2] - 2
    cache = {}

    def plane(di):  # (nx, ny+2, nz+2)
        if di == "xsum":
            if "p" not in cache:
                cache["p"] = upc[0:nx] + upc[2 : 2 + nx]
            return cache["p"]
        return upc[1 + di : 1 + di + nx]

    def term(di, dj, dk):
        src = plane(di)
        if dj == "ysum":
            key = ("ys", di)
            if key not in cache:  # (nx, ny, nz+2)
                cache[key] = src[:, 0:ny] + src[:, 2 : 2 + ny]
            return cache[key][:, :, 1 + dk : 1 + dk + nz]
        return src[:, 1 + dj : 1 + dj + ny, 1 + dk : 1 + dk + nz]

    return accumulate_taps(flat, term, scalar)


def apply_taps_conv_padded(up: torch.Tensor, taps: np.ndarray) -> torch.Tensor:
    """The ``backend='conv'`` arm, port of ``stencil_jnp.apply_taps_conv_padded``:
    one ``F.conv3d`` (cross-correlation, as XLA's conv: no kernel flip,
    matching ``out[c] = sum_d T[d] u[c+d-1]``) of the float32 taps over
    the ghost-padded block, VALID, in float32 with TF32 off on the card.
    The JAX package computes it outside any Pallas kernel too: a library
    call is this arm's definition. Not bitwise to the tap chain (cuDNN and
    oneDNN sum in their own order)."""
    w = torch.from_numpy(np.asarray(taps, dtype=np.float32)).to(up.device)
    allow = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        y = F.conv3d(up.float()[None, None], w[None, None])
    finally:
        torch.backends.cudnn.allow_tf32 = allow
    return y[0, 0].to(up.dtype)


def pin_outside(
    arr: torch.Tensor, global_indices, extents, bc_value: float, edges=None
) -> torch.Tensor:
    """``arr`` with every cell whose global index (``global_indices[a]``, a
    1-D index tensor per axis) lies outside ``[0, extents[a])`` on any axis
    set to ``bc_value`` rounded to ``arr``'s dtype. ``edges`` (x_lo, x_hi,
    y_lo, y_hi, z_lo, z_hi; default all True) limits the pins to the sides
    whose flag is set: a shard pins only beyond the domain faces it
    touches."""
    edges = (True,) * 6 if edges is None else edges
    mask = None
    for axis, (g, n) in enumerate(zip(global_indices, extents)):
        shape = [1, 1, 1]
        shape[axis] = -1
        m = torch.ones_like(g, dtype=torch.bool)
        if edges[2 * axis]:
            m = m & (g >= 0)
        if edges[2 * axis + 1]:
            m = m & (g < n)
        m = m.reshape(shape)
        mask = m if mask is None else mask & m
    bc = torch.full((), bc_value, dtype=arr.dtype, device=arr.device)
    return torch.where(mask, arr, bc)


def residual_sumsq(
    u_new: torch.Tensor,
    u_old: torch.Tensor,
    residual_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Sum of squared update differences, accumulated in ``residual_dtype``
    (fp32 even under bf16 storage). A plain reduction, as in the JAX
    package, where it is XLA and not a Pallas kernel. The summation order
    differs from XLA's, so the two agree to fp32 rounding, not bitwise."""
    d = u_new.to(residual_dtype) - u_old.to(residual_dtype)
    return torch.sum(d * d, dtype=residual_dtype)
