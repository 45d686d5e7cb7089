"""The equation-family registry: named, parameterized PDE families.

Each family is a builder from ``(stencil kind, params, alpha)`` to an
:class:`~heat3d_tpu.eqn.spec.EquationSpec`, plus the metadata the lint
cross-checks (docs table row, CLI choice) and the fp64 manufactured-
solution reference the convergence tests drive (``mms_rates``: the decay
rate mu and phase rate omega of the periodic plane-wave solution
``u(x, t) = exp(-mu t) * sin(k . x - omega t)`` — every shipped family
is linear with constant coefficients, so a single plane wave is an exact
continuous solution; see core.golden.plane_wave).

``heat`` is the legacy 7pt/27pt heat equation re-authored as a spec —
the canonical surface now (``heat7()`` / ``heat27()`` return its specs
directly); its lowered taps are BIT-identical to the hardcoded
``stencil_taps`` path (tests/test_eqn.py pins it; the 4-device CPU-mesh
battery proves it e2e). The new families ride the same machinery:

- ``aniso-diffusion``   du/dt = alpha * div(D grad u), D = diag(dx,dy,dz)
- ``advection-diffusion`` du/dt = alpha * lap(u) - v . grad(u)
- ``reaction-diffusion``  du/dt = alpha * lap(u) + rate * u   (linear)
- ``wave``              d2u/dt2 = c^2 * lap(u)   (leapfrog two-level carry)
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Mapping, Tuple

import numpy as np

from heat3d_tpu_torch.core.stencils import STENCILS
from heat3d_tpu_torch.eqn.spec import EquationSpec, StencilSpec, Term


@dataclasses.dataclass(frozen=True)
class EquationFamily:
    """One registered PDE family (see module docstring).

    ``defaults`` are (name, value) pairs — the full parameter schema; a
    config's ``eq_params`` may override any subset (unknown names raise
    at config validation). ``kinds`` are the stencil footprints the
    family's diffusion leg supports. ``mms_rates(params, alpha, k)``
    returns the (mu, omega) plane-wave rates for physical wavevector
    ``k`` — the analytic reference every family must carry (the
    eqn-registry lint flags a family without one).
    ``stable_dt(params, alpha, spacing)`` is the family's explicit-Euler
    stability bound: ``GridConfig.stable_dt`` only knows the diffusion
    operator, so a default-derived dt can silently diverge under strong
    reaction/advection terms — config validation rejects a DEFAULT dt
    above this bound (an explicit --dt stays the author's contract,
    docs/EQUATIONS.md)."""

    name: str
    description: str
    kinds: Tuple[str, ...]
    defaults: Tuple[Tuple[str, float], ...]
    build: Callable[[str, Mapping[str, float], float], EquationSpec]
    mms_rates: Callable[
        [Mapping[str, float], float, Tuple[float, float, float]],
        Tuple[float, float],
    ]
    stable_dt: Callable[
        [Mapping[str, float], float, Tuple[float, float, float]], float
    ] = None


def _diffusion_bound(alpha, spacing, d=(1.0, 1.0, 1.0)):
    """dt <= 1 / (2 * sum_a alpha*d_a/h_a^2) — the classic forward-Euler
    diffusion bound (GridConfig.stable_dt at d = 1)."""
    return 1.0 / (
        2.0 * alpha * sum(di / h**2 for di, h in zip(d, spacing))
    )


def _diffusion_term(kind: str, alpha: float) -> Term:
    s = STENCILS[kind]
    return Term(
        name="diffusion",
        coeff=alpha,
        op=StencilSpec(
            weights=s.weights,
            scaling=(
                "laplacian-separable" if s.separable else "laplacian-uniform"
            ),
        ),
    )


# ---- heat (the legacy equation, spec-authored) ------------------------------


def _build_heat(kind, params, alpha) -> EquationSpec:
    return EquationSpec(family="heat", terms=(_diffusion_term(kind, alpha),))


def _heat_rates(params, alpha, k):
    return alpha * float(sum(kk * kk for kk in k)), 0.0


def _heat_stable_dt(params, alpha, spacing):
    return _diffusion_bound(alpha, spacing)


def _aniso_stable_dt(params, alpha, spacing):
    return _diffusion_bound(
        alpha, spacing, (params["dx"], params["dy"], params["dz"])
    )


def _advdiff_stable_dt(params, alpha, spacing):
    # central advection + diffusion, forward Euler: the diffusion bound
    # AND dt <= 2*alpha / sum(v_a^2) (the cell-Reynolds-composed
    # sufficient condition; v = 0 leaves the diffusion bound alone)
    bound = _diffusion_bound(alpha, spacing)
    v2 = sum(params[p] ** 2 for p in ("vx", "vy", "vz"))
    if v2 > 0.0:
        bound = min(bound, 2.0 * alpha / v2)
    return bound


def _reactdiff_stable_dt(params, alpha, spacing):
    # lambda(s) = 1 + dt*(rate - alpha*s), s in [0, 4*sum 1/h^2]:
    # a DECAY rate tightens the |lambda| >= -1 corner to
    # dt <= 2 / (alpha*s_max + |rate|); growth (rate > 0) amplifies the
    # k=0 mode physically, so it never loosens the bound
    s_max = 4.0 * sum(1.0 / h**2 for h in spacing)
    return 2.0 / (alpha * s_max + max(-params["rate"], 0.0))


def heat7() -> EquationSpec:
    """The 7-point heat spec at unit diffusivity — the canonical
    authoring form of the legacy hardcoded kernel."""
    return _build_heat("7pt", {}, 1.0)


def heat27() -> EquationSpec:
    """The isotropic 27-point heat spec at unit diffusivity."""
    return _build_heat("27pt", {}, 1.0)


# ---- anisotropic (per-axis) diffusion ---------------------------------------


def _build_aniso(kind, params, alpha) -> EquationSpec:
    w = np.zeros((3, 3, 3))
    dx, dy, dz = params["dx"], params["dy"], params["dz"]
    if min(dx, dy, dz) <= 0.0:
        raise ValueError(
            f"aniso-diffusion needs positive per-axis diffusivities, got "
            f"dx={dx} dy={dy} dz={dz}"
        )
    w[0, 1, 1] = w[2, 1, 1] = dx
    w[1, 0, 1] = w[1, 2, 1] = dy
    w[1, 1, 0] = w[1, 1, 2] = dz
    w[1, 1, 1] = -2.0 * (dx + dy + dz)
    return EquationSpec(
        family="aniso-diffusion",
        terms=(
            Term(
                name="diffusion",
                coeff=alpha,
                op=StencilSpec(weights=w, scaling="laplacian-separable"),
            ),
        ),
    )


def _aniso_rates(params, alpha, k):
    d = (params["dx"], params["dy"], params["dz"])
    return alpha * float(sum(di * ki * ki for di, ki in zip(d, k))), 0.0


# ---- advection-diffusion ----------------------------------------------------


def _build_advdiff(kind, params, alpha) -> EquationSpec:
    v = (params["vx"], params["vy"], params["vz"])
    w = np.zeros((3, 3, 3))
    # -v . grad(u), central difference: tap at +1 along axis a is
    # -v_a/(2 h_a), at -1 it is +v_a/(2 h_a) (the gradient scaling
    # supplies the 1/(2h))
    w[0, 1, 1], w[2, 1, 1] = v[0], -v[0]
    w[1, 0, 1], w[1, 2, 1] = v[1], -v[1]
    w[1, 1, 0], w[1, 1, 2] = v[2], -v[2]
    return EquationSpec(
        family="advection-diffusion",
        terms=(
            _diffusion_term(kind, alpha),
            Term(
                name="advection",
                coeff=1.0,
                op=StencilSpec(weights=w, scaling="gradient"),
            ),
        ),
    )


def _advdiff_rates(params, alpha, k):
    v = (params["vx"], params["vy"], params["vz"])
    mu = alpha * float(sum(kk * kk for kk in k))
    omega = float(sum(vi * ki for vi, ki in zip(v, k)))
    return mu, omega


# ---- wave (second order in time; leapfrog-integrated) -----------------------


def _build_wave(kind, params, alpha) -> EquationSpec:
    c = params["c"]
    if c <= 0.0:
        raise ValueError(f"wave needs a positive speed c, got c={c}")
    s = STENCILS[kind]
    # the spatial operator is c^2 * lap(u); grid.alpha is a DIFFUSION
    # knob and deliberately does not enter (the wave speed is the
    # family's own parameter, like advection's velocity)
    return EquationSpec(
        family="wave",
        terms=(
            Term(
                name="wave-laplacian",
                coeff=c * c,
                op=StencilSpec(
                    weights=s.weights,
                    scaling=(
                        "laplacian-separable"
                        if s.separable
                        else "laplacian-uniform"
                    ),
                ),
            ),
        ),
    )


def _wave_rates(params, alpha, k):
    # d2u/dt2 = c^2 lap(u): sin(k.x - omega t) is exact at omega = c|k|,
    # with zero decay — the leapfrog MMS reference
    return 0.0, params["c"] * float(np.sqrt(sum(kk * kk for kk in k)))


def _wave_stable_dt(params, alpha, spacing):
    # leapfrog CFL: dt^2 * lambda_max <= 4 with
    # lambda_max(-c^2 lap_h) = c^2 * sum_a 4/h_a^2
    return 1.0 / (
        params["c"] * float(np.sqrt(sum(1.0 / h**2 for h in spacing)))
    )


# ---- reaction-diffusion (linear reaction) -----------------------------------


def _build_reactdiff(kind, params, alpha) -> EquationSpec:
    w = np.zeros((3, 3, 3))
    w[1, 1, 1] = 1.0
    return EquationSpec(
        family="reaction-diffusion",
        terms=(
            _diffusion_term(kind, alpha),
            Term(
                name="reaction",
                coeff=params["rate"],
                op=StencilSpec(weights=w, scaling="none"),
            ),
        ),
    )


def _reactdiff_rates(params, alpha, k):
    return alpha * float(sum(kk * kk for kk in k)) - params["rate"], 0.0


# ---- registry ---------------------------------------------------------------

FAMILIES: Dict[str, EquationFamily] = {
    f.name: f
    for f in (
        EquationFamily(
            name="heat",
            description="explicit-Euler heat diffusion (the legacy "
            "hardcoded 7pt/27pt path, spec-authored; alpha from the grid)",
            kinds=("7pt", "27pt"),
            defaults=(),
            build=_build_heat,
            mms_rates=_heat_rates,
            stable_dt=_heat_stable_dt,
        ),
        EquationFamily(
            name="aniso-diffusion",
            description="anisotropic diffusion du/dt = alpha*div(D grad u) "
            "with per-axis diffusivities D = diag(dx, dy, dz)",
            kinds=("7pt",),
            defaults=(("dx", 1.0), ("dy", 0.5), ("dz", 0.25)),
            build=_build_aniso,
            mms_rates=_aniso_rates,
            stable_dt=_aniso_stable_dt,
        ),
        EquationFamily(
            name="advection-diffusion",
            description="advection-diffusion du/dt = alpha*lap(u) - "
            "v.grad(u), central-difference transport v = (vx, vy, vz)",
            kinds=("7pt",),
            defaults=(("vx", 1.0), ("vy", 0.0), ("vz", 0.0)),
            build=_build_advdiff,
            mms_rates=_advdiff_rates,
            stable_dt=_advdiff_stable_dt,
        ),
        EquationFamily(
            name="wave",
            description="second-order wave equation d2u/dt2 = c^2*lap(u), "
            "leapfrog-integrated over the two-level (u, u_prev) carry "
            "(integrator='leapfrog'; docs/INTEGRATORS.md)",
            kinds=("7pt", "27pt"),
            defaults=(("c", 1.0),),
            build=_build_wave,
            mms_rates=_wave_rates,
            stable_dt=_wave_stable_dt,
        ),
        EquationFamily(
            name="reaction-diffusion",
            description="linear reaction-diffusion du/dt = alpha*lap(u) + "
            "rate*u (rate < 0 decays, rate > 0 grows)",
            kinds=("7pt", "27pt"),
            defaults=(("rate", -1.0),),
            build=_build_reactdiff,
            mms_rates=_reactdiff_rates,
            stable_dt=_reactdiff_stable_dt,
        ),
    )
}

DEFAULT_FAMILY = "heat"
