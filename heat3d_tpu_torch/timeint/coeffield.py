"""Spatially-varying coefficient fields: a(x) as a second array beside u.

Port of ``heat3d_tpu.timeint.coeffield`` (a serve surface: no
``SolverConfig`` knob). div(a grad u) discretized in flux form on the
7-point footprint:

    u' = u + dt/h_ax^2 * sum_ax [ (a_c+a_p)/2 (u_p - u_c)
                                 - (a_m+a_c)/2 (u_c - u_m) ]

The coefficient field rides the machinery of the solution: it is
ghost-exchanged by the same axis-ordered plan (``serve.ensemble`` runs the
batched plan over the members' fields) and zero on storage padding. At a
physical Dirichlet boundary the coefficient ghosts are zero, which zeroes
the boundary-face flux from outside; periodic ghosts wrap. The field
replaces ``grid.alpha`` (a uniform a == alpha reproduces the
constant-coefficient operator up to fp association).

The named initializers are copied from the JAX package (fp64 NumPy,
seeded), so a spec tuple gives the same field to the bit in both
packages: uniform (iid U[lo,hi]), layered (smooth z-gradient), checker
(lo/hi block checkerboard), lognormal (clipped).
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import numpy as np
import torch

from heat3d_tpu_torch.core.config import SolverConfig

COEF_FIELDS = ("uniform", "layered", "checker", "lognormal")


def make_coef_field(
    name: str,
    shape: Tuple[int, int, int],
    seed: int = 0,
    lo: float = 0.5,
    hi: float = 1.5,
) -> np.ndarray:
    """The named fp64 coefficient field on the GLOBAL grid. Every field
    is strictly positive (lo > 0 enforced) so the operator stays
    elliptic and the explicit bound dt <= h^2/(6 max a) holds."""
    if name not in COEF_FIELDS:
        raise ValueError(
            f"unknown coefficient field {name!r}; have {COEF_FIELDS}"
        )
    if not (0.0 < lo <= hi):
        raise ValueError(f"need 0 < lo <= hi, got lo={lo} hi={hi}")
    rng = np.random.default_rng(seed)
    if name == "uniform":
        return rng.uniform(lo, hi, size=shape)
    if name == "layered":
        z = (np.arange(shape[2], dtype=np.float64) + 0.5) / shape[2]
        prof = lo + (hi - lo) * 0.5 * (1.0 + np.sin(2.0 * np.pi * z))
        return np.broadcast_to(prof[None, None, :], shape).copy()
    if name == "checker":
        idx = np.add.outer(
            np.add.outer(np.arange(shape[0]) // 2, np.arange(shape[1]) // 2),
            np.arange(shape[2]) // 2,
        )
        return np.where(idx % 2 == 0, lo, hi).astype(np.float64)
    # lognormal: median sqrt(lo*hi), clipped into [lo, hi]
    mid = np.sqrt(lo * hi)
    sigma = 0.25 * np.log(hi / lo) if hi > lo else 0.0
    return np.clip(
        mid * np.exp(sigma * rng.standard_normal(shape)), lo, hi
    )


def varcoef_stable_dt(
    a_max: float, spacing: Tuple[float, float, float]
) -> float:
    """Explicit stability bound for the flux-form operator: dt <=
    1 / (2 a_max sum 1/h_i^2)."""
    return 1.0 / (2.0 * float(a_max) * sum(1.0 / h**2 for h in spacing))


def dt_factors(dts: Sequence[float], spacing, compute_dtype: torch.dtype,
               device=None) -> torch.Tensor:
    """The (B, 3) compute-dtype factors dt_m / h_ax^2 of the members'
    timesteps ``dts``: each dt rounded to the compute dtype, then divided by
    h^2 in float32 and rounded once more to the compute dtype on the host
    (what a device division of the compute-dtype dt by h^2 gives, without
    the card's reciprocal shortcut for a division by a scalar)."""
    dt_c = torch.tensor(np.asarray(dts, np.float64), dtype=torch.float64).to(compute_dtype)
    dt32 = dt_c.float().numpy()
    h2 = np.asarray([np.float32(h) ** 2 for h in spacing], np.float32)
    f = (dt32[:, None] / h2[None, :]).astype(np.float32)
    return torch.from_numpy(f).to(device).to(compute_dtype)


def _slab(ap: torch.Tensor, axis: int, off: int) -> torch.Tensor:
    """Interior-shaped slice of a 1-ring-padded block (its last three dims)
    shifted ``off`` along ``axis``."""
    lead = ap.dim() - 3
    sl = [slice(None)] * lead
    for ax in range(3):
        o = off if ax == axis else 0
        sl.append(slice(1 + o, ap.shape[lead + ax] - 1 + o))
    return ap[tuple(sl)]


def _local_flux_update(
    up: torch.Tensor, apad: torch.Tensor, cfg: SolverConfig,
    dt: Union[float, torch.Tensor], shard, bc_value=None,
) -> torch.Tensor:
    """One flux-form update of a shard from its width-1 padded blocks ``up``
    (the solution, ghosts at the bc value) and ``apad`` (the coefficient,
    ghosts zero at Dirichlet domain faces): per-axis face-averaged fluxes,
    compute-dtype accumulation, the storage-dtype result with the storage
    padding re-pinned (``parallel.step._pin_padding``). The blocks may carry
    a leading batch extent (the ensemble's members): ``dt`` is then the
    members' (B, 3) :func:`dt_factors` and ``bc_value`` a (B, 1, 1, 1)
    storage-dtype tensor; a Python float ``dt`` is the solo form (its
    factors rounded on the host)."""
    from heat3d_tpu_torch.ops.stencil_eager import compute_weight
    from heat3d_tpu_torch.parallel.step import _pin_padding

    cd = getattr(torch, cfg.precision.compute)
    sd = getattr(torch, cfg.precision.storage)
    up = up.to(cd)
    apad = apad.to(cd)
    uc = _slab(up, 0, 0)
    ac = _slab(apad, 0, 0)
    acc = uc
    for axis in range(3):
        u_p, u_m = _slab(up, axis, 1), _slab(up, axis, -1)
        a_p, a_m = _slab(apad, axis, 1), _slab(apad, axis, -1)
        flux = 0.5 * (ac + a_p) * (u_p - uc) - 0.5 * (a_m + ac) * (uc - u_m)
        if isinstance(dt, torch.Tensor):
            f = dt[..., axis].reshape(dt.shape[:-1] + (1, 1, 1))
        else:
            f = compute_weight(dt / cfg.grid.spacing[axis] ** 2, cd)
        acc = acc + f * flux
    return _pin_padding(acc.to(sd), cfg, shard, bc_value=bc_value)


def validate_config(cfg: SolverConfig) -> None:
    """Coefficient fields compose with the plain explicit route only:
    heat family, explicit-euler, tb=1, no overlap, jnp backend (pinned by
    the caller), ppermute halo."""
    problems = []
    if cfg.equation != "heat":
        problems.append(f"equation must be 'heat', got {cfg.equation!r}")
    if cfg.integrator != "explicit-euler":
        problems.append(
            f"integrator must be 'explicit-euler', got {cfg.integrator!r}"
        )
    if cfg.time_blocking > 1:
        problems.append(
            f"time_blocking must be 1, got {cfg.time_blocking} (the "
            "superstep ring recompute does not carry the second array)"
        )
    if cfg.overlap:
        problems.append("overlap=True unsupported")
    if cfg.backend not in ("jnp", "auto"):
        problems.append(f"backend must be 'jnp', got {cfg.backend!r}")
    if cfg.halo not in ("ppermute", "auto"):
        problems.append(f"halo must be 'ppermute', got {cfg.halo!r}")
    if problems:
        raise ValueError(
            "coefficient-field step unsupported for this config: "
            + "; ".join(problems)
            + " (docs/INTEGRATORS.md)"
        )


# ---- numpy reference (tests) -------------------------------------------------


def reference_varcoef_step(
    u: np.ndarray,
    a: np.ndarray,
    dt: float,
    spacing: Tuple[float, float, float],
    periodic: bool = True,
    bc_value: float = 0.0,
) -> np.ndarray:
    """fp64 full-grid flux-form update — the oracle for the sharded
    flux-form route (solution ghosts bc_value, coefficient ghosts zero)."""
    if periodic:
        up = np.pad(u.astype(np.float64), 1, mode="wrap")
        apd = np.pad(a.astype(np.float64), 1, mode="wrap")
    else:
        up = np.pad(
            u.astype(np.float64), 1, mode="constant",
            constant_values=bc_value,
        )
        apd = np.pad(
            a.astype(np.float64), 1, mode="constant", constant_values=0.0
        )
    n = u.shape

    def slab(arr, axis, off):
        sl = []
        for ax in range(3):
            o = off if ax == axis else 0
            sl.append(slice(1 + o, 1 + o + n[ax]))
        return arr[tuple(sl)]

    uc, ac = slab(up, 0, 0), slab(apd, 0, 0)
    acc = uc.copy()
    for axis in range(3):
        h2 = spacing[axis] ** 2
        u_p, u_m = slab(up, axis, 1), slab(up, axis, -1)
        a_p, a_m = slab(apd, axis, 1), slab(apd, axis, -1)
        acc += (dt / h2) * (
            0.5 * (ac + a_p) * (u_p - uc) - 0.5 * (a_m + ac) * (uc - u_m)
        )
    return acc
