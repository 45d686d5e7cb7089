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
    compute_dtype: torch.dtype = torch.float32, out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Apply 3x3x3 update taps to a ghost-padded ``up`` of shape
    (nx+2, ny+2, nz+2); returns the (nx, ny, nz) interior update in
    ``out_dtype`` (None: ``up``'s dtype), computed in ``compute_dtype``
    (float32 or bfloat16): ``up`` cast to it, each multiply and add one
    rounded operation of it. Tap weights are embedded as
    :func:`compute_weight`, the rounding ``jnp.asarray(w, compute_dtype)``
    applies. ``out_dtype=compute_dtype`` keeps the sweep unrounded to the
    storage dtype (the time integrators subtract the previous level first).

    ``mehrstellen`` pins the route, as in the JAX package: None follows
    ``HEAT3D_MEHRSTELLEN`` (``core.stencils.mehrstellen_enabled``); True
    takes the Mehrstellen route (:func:`_apply_mehrstellen_padded`) where
    the taps decompose as ``a*delta + b*S + d*F``; False forces the tap
    chain. Callers beside a kernel that runs the chain under the knob (the
    exchange-path and fused kernels' plain versions, the overlap faces
    around them) pass False."""
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"compute dtype {compute_dtype} (float32 or bfloat16)")
    out_dtype = out_dtype or up.dtype
    upc = up.to(compute_dtype)
    if mehrstellen is None:
        mehrstellen = mehrstellen_enabled()
    if mehrstellen:
        coeffs = decompose_mehrstellen(taps)
        if coeffs is not None:
            coeffs = [compute_weight(c, compute_dtype) for c in coeffs]
            return _apply_mehrstellen_padded(upc, coeffs).to(out_dtype)
    flat = flat_taps(taps)
    if not flat:
        raise ValueError("stencil has no taps")
    acc = _chain_accumulate(upc, flat, lambda w: compute_weight(w, compute_dtype))
    return acc.to(out_dtype)


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

    ``coeffs`` are (a, b, d) as the update multiplies by them: the solo
    apply's :func:`compute_weight` floats (3.0 is exact in both dtypes), or
    the ensemble's per-member (B, 1, 1, 1) compute-dtype tensors. The axes
    are ``upc``'s last three, so a batch of members (B, nx+2, ny+2, nz+2)
    runs the same ops."""
    nx, ny, nz = upc.shape[-3] - 2, upc.shape[-2] - 2, upc.shape[-1] - 2
    a, b, d = coeffs
    z131 = (upc[..., 0:nz] + upc[..., 2 : nz + 2]) + 3.0 * upc[..., 1 : nz + 1]
    y131 = (z131[..., 0:ny, :] + z131[..., 2 : ny + 2, :]) + 3.0 * z131[..., 1 : ny + 1, :]
    s = ((y131[..., 0:nx, :, :] + y131[..., 2 : nx + 2, :, :])
         + 3.0 * y131[..., 1 : nx + 1, :, :])
    c = upc[..., 1 : nx + 1, 1 : ny + 1, 1 : nz + 1]
    px = upc[..., 0:nx, 1 : ny + 1, 1 : nz + 1] + upc[..., 2 : nx + 2, 1 : ny + 1, 1 : nz + 1]
    py = upc[..., 1 : nx + 1, 0:ny, 1 : nz + 1] + upc[..., 1 : nx + 1, 2 : ny + 2, 1 : nz + 1]
    pz = upc[..., 1 : nx + 1, 1 : ny + 1, 0:nz] + upc[..., 1 : nx + 1, 1 : ny + 1, 2 : nz + 2]
    psum = (px + py) + pz
    return (a * c + b * s) + d * psum


def _chain_accumulate(upc: torch.Tensor, flat, scalar) -> torch.Tensor:
    """THE shifted-slice emission of the tap chain over a ghost-padded
    compute-dtype tensor ``upc``; the plane/row caches are the x/y
    factoring reuse that accumulate_taps' emission order assumes. The axes
    are ``upc``'s last three: a batch of members (B, nx+2, ny+2, nz+2)
    runs the same ops, with ``scalar`` giving (B, 1, 1, 1) weights."""
    nx, ny, nz = upc.shape[-3] - 2, upc.shape[-2] - 2, upc.shape[-1] - 2
    cache = {}

    def plane(di):  # (..., nx, ny+2, nz+2)
        if di == "xsum":
            if "p" not in cache:
                cache["p"] = upc[..., 0:nx, :, :] + upc[..., 2 : 2 + nx, :, :]
            return cache["p"]
        return upc[..., 1 + di : 1 + di + nx, :, :]

    def term(di, dj, dk):
        src = plane(di)
        if dj == "ysum":
            key = ("ys", di)
            if key not in cache:  # (..., nx, ny, nz+2)
                cache[key] = src[..., 0:ny, :] + src[..., 2 : 2 + ny, :]
            return cache[key][..., 1 + dk : 1 + dk + nz]
        return src[..., 1 + dj : 1 + dj + ny, 1 + dk : 1 + dk + nz]

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
    touches. The axes are ``arr``'s last three: a batch of members
    (B, nx, ny, nz) takes ``bc_value`` as a (B, 1, 1, 1) tensor of their
    values in ``arr``'s dtype."""
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
    if isinstance(bc_value, torch.Tensor):
        return torch.where(mask, arr, bc_value)
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


# ---- the parametric chain (the batched ensemble, ``serve.ensemble``) ------


def emission_positions(flat):
    """Representative (di, dj, dk) tap offsets, one per chain term, in the
    exact ``scalar()`` consumption order of ``accumulate_taps`` over ``flat``
    under the current factoring env (port of
    ``stencil_jnp.emission_positions``). A factored term (``"xsum"`` /
    ``"ysum"``) is represented by its +1-side tap: the factoring fires only
    when the +-1 patterns carry equal weights, so the +1 weight is the
    shared one. This maps a member's 3x3x3 taps onto the parametric chain's
    weight vector."""
    from heat3d_tpu_torch.core.stencils import _CountToken

    tok = _CountToken()
    out = []

    def term(di, dj, dk):
        out.append((1 if di == "xsum" else di, 1 if dj == "ysum" else dj, dk))
        return tok

    accumulate_taps(flat, term, lambda w: tok)
    return tuple(out)


def member_weights(member_taps, positions, compute_dtype: torch.dtype = torch.float32,
                   device=None) -> torch.Tensor:
    """The (B, T) compute-dtype weight tensor of the parametric chain: row m
    holds member m's taps at ``positions`` (:func:`emission_positions`),
    each rounded on the host as :func:`compute_weight` rounds a baked
    weight, so a member's chain multiplies by the same values as its solo
    apply."""
    rows = [
        [compute_weight(t[di + 1, dj + 1, dk + 1], compute_dtype) for di, dj, dk in positions]
        for t in member_taps
    ]
    return torch.tensor(rows, dtype=torch.float32, device=device).to(compute_dtype)


def _per_member(v: torch.Tensor) -> torch.Tensor:
    """A (B,) or () weight as a tensor that broadcasts over (B, nx, ny, nz)
    (or (nx, ny, nz))."""
    return v.reshape(v.shape + (1, 1, 1))


def apply_taps_padded_params(
    up: torch.Tensor, flat, weights: torch.Tensor,
    compute_dtype: torch.dtype = torch.float32, out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """The parametric tap apply (port of
    ``stencil_jnp.apply_taps_padded_params``): the emission of
    :func:`apply_taps_padded` with the weights as a tensor instead of
    embedded constants. ``up`` is (B, nx+2, ny+2, nz+2) (or one
    (nx+2, ny+2, nz+2) block); ``weights`` is (B, T) (or (T,)), already in
    ``compute_dtype`` (:func:`member_weights`): the i-th chain term of member
    m multiplies by ``weights[m, i]``, in :func:`emission_positions` order.
    ``flat`` is the nominal flat-tap structure the members share. Each
    multiply and add is one rounded operation, as on the solo path, so a
    member's result does not depend on the batch it is packed in."""
    out_dtype = out_dtype or up.dtype
    upc = up.to(compute_dtype)
    counter = [0]

    def scalar(_w):
        i = counter[0]
        counter[0] += 1
        return _per_member(weights[..., i])

    return _chain_accumulate(upc, flat, scalar).to(out_dtype)
