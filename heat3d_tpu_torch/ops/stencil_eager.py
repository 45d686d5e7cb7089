"""Plain PyTorch stencil update: the contract every kernel is held against.

Port of ``heat3d_tpu.ops.stencil_jnp``: the same shifted-slice tap chain,
in the same ``core.stencils.accumulate_taps`` emission order, on tensors.
Eager PyTorch runs each multiply and each add as its own rounded operation
(no FMA contraction), so a CUDA kernel that evaluates the chain with
``__fmul_rn``/``__fadd_rn`` in the same order equals it bitwise on the same
device. The Mehrstellen route (``HEAT3D_MEHRSTELLEN``, taps that factor as
``a*delta + b*S + d*F``) is held to the same standard in its own canonical
order (:func:`_apply_mehrstellen_padded`). Under bf16 compute
(``compute_dtype=torch.bfloat16``, the JAX package's
``Precision.compute='bfloat16'``) the chain runs on bf16 tensors: eager
PyTorch computes each bf16 multiply and add in float and rounds it once to
bf16, the rounding of eager JAX and of the kernels' bf16 policy. These
functions run on any device; on the CPU they are the stand-in for the
kernels (``ops.stencil_direct``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from heat3d_tpu_torch.core.config import BoundaryCondition
from heat3d_tpu_torch.core.stencils import (
    accumulate_taps,
    decompose_mehrstellen,
    flat_taps,
    mehrstellen_enabled,
)


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


def compute_weight(w: float, compute_dtype: torch.dtype = torch.float32) -> float:
    """Tap weight (or Mehrstellen coefficient) ``w`` as the update
    multiplies by it: ``np.float32(w)``, rounded on to bf16 under bf16
    compute (what ``jnp.asarray(w, compute_dtype)`` gives). A bf16 tensor
    times a Python float is computed in float with the float as given, so
    the weight must already be a bf16 value."""
    w32 = np.float32(w)
    if compute_dtype == torch.float32:
        return float(w32)
    return float(torch.tensor(w32).to(compute_dtype))


def apply_taps_padded(
    up: torch.Tensor, taps: np.ndarray, mehrstellen: Optional[bool] = None,
    compute_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Apply 3x3x3 update taps to a ghost-padded ``up`` of shape
    (nx+2, ny+2, nz+2); returns the (nx, ny, nz) interior update in
    ``up``'s dtype, computed in ``compute_dtype`` (float32 or bfloat16):
    ``up`` cast to it, each multiply and add one rounded operation of it.
    Tap weights are embedded as :func:`compute_weight`, the rounding
    ``jnp.asarray(w, compute_dtype)`` applies.

    ``mehrstellen`` pins the route, as in the JAX package: None follows
    ``HEAT3D_MEHRSTELLEN`` (``core.stencils.mehrstellen_enabled``); True
    takes the Mehrstellen route (:func:`_apply_mehrstellen_padded`) where
    the taps decompose as ``a*delta + b*S + d*F``; False forces the tap
    chain. Callers beside a kernel that runs the chain under the knob (the
    exchange-path and fused kernels' plain versions, the overlap faces
    around them) pass False."""
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"compute dtype {compute_dtype} (float32 or bfloat16)")
    upc = up.to(compute_dtype)
    if mehrstellen is None:
        mehrstellen = mehrstellen_enabled()
    if mehrstellen:
        coeffs = decompose_mehrstellen(taps)
        if coeffs is not None:
            return _apply_mehrstellen_padded(upc, coeffs).to(up.dtype)
    flat = flat_taps(taps)
    if not flat:
        raise ValueError("stencil has no taps")
    acc = _chain_accumulate(upc, flat, lambda w: compute_weight(w, compute_dtype))
    return acc.to(up.dtype)


def _apply_mehrstellen_padded(upc: torch.Tensor, coeffs) -> torch.Tensor:
    """The Mehrstellen route over a ghost-padded compute-dtype ``upc``,
    port of ``stencil_jnp._apply_mehrstellen_padded``: three 1D [1,3,1]
    sums build S, the six face neighbours build F, one 3-term combine. One
    rounded op of ``upc``'s dtype per step, in the canonical order:

      z131 = (z- + z+) + 3*u       per z-line of the padded block
      y131 = (y- + y+) + 3*z131    per y-line of z131 (a plane's q)
      S    = (x- + x+) + 3*y131    over x-planes of y131
      psum = (px + py) + pz        face sums of the padded block
      out  = (a*u0 + b*S) + d*psum

    ``coeffs`` are ``decompose_mehrstellen``'s (a, b, d), embedded as
    :func:`compute_weight` like the tap weights (3.0 is exact in both)."""
    nx, ny, nz = upc.shape[0] - 2, upc.shape[1] - 2, upc.shape[2] - 2
    a, b, d = (compute_weight(c, upc.dtype) for c in coeffs)
    z131 = (upc[:, :, 0:nz] + upc[:, :, 2 : nz + 2]) + 3.0 * upc[:, :, 1 : nz + 1]
    y131 = (z131[:, 0:ny] + z131[:, 2 : ny + 2]) + 3.0 * z131[:, 1 : ny + 1]
    s = (y131[0:nx] + y131[2 : nx + 2]) + 3.0 * y131[1 : nx + 1]
    c = upc[1 : nx + 1, 1 : ny + 1, 1 : nz + 1]
    px = upc[0:nx, 1 : ny + 1, 1 : nz + 1] + upc[2 : nx + 2, 1 : ny + 1, 1 : nz + 1]
    py = upc[1 : nx + 1, 0:ny, 1 : nz + 1] + upc[1 : nx + 1, 2 : ny + 2, 1 : nz + 1]
    pz = upc[1 : nx + 1, 1 : ny + 1, 0:nz] + upc[1 : nx + 1, 1 : ny + 1, 2 : nz + 2]
    psum = (px + py) + pz
    return (a * c + b * s) + d * psum


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


def apply_taps_conv_padded(up: torch.Tensor, taps: np.ndarray,
                           compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The ``backend='conv'`` arm, port of ``stencil_jnp.apply_taps_conv_padded``:
    one ``F.conv3d`` (cross-correlation, as XLA's conv: no kernel flip,
    matching ``out[c] = sum_d T[d] u[c+d-1]``) of the taps over the
    ghost-padded block, VALID, in ``compute_dtype`` (block and taps cast to
    it), with TF32 off on the card. The JAX package computes it outside
    any Pallas kernel too: a library call is this arm's definition. Not
    bitwise to the tap chain (cuDNN and oneDNN sum in their own order and
    precision)."""
    w = torch.from_numpy(np.asarray(taps, dtype=np.float32)).to(up.device, compute_dtype)
    allow = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        y = F.conv3d(up.to(compute_dtype)[None, None], w[None, None])
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
