"""heat3d_tpu.eqn — the declarative equation frontend (docs/EQUATIONS.md).

One entry point matters to the rest of the framework:
:func:`solver_taps` — SolverConfig in, 3x3x3 explicit-Euler update taps
out. ``parallel.step._solver_taps`` routes every step/superstep/phase
program through it, so a registered family (heat, aniso-diffusion,
advection-diffusion, reaction-diffusion, ...) rides the unchanged
halo/ExchangePlan/tune/serve/obs machinery: the spec compiles to taps,
the taps feed the one shared chain emission.

``HEAT3D_EQN_LEGACY=1`` routes the heat family through the pre-spec
hardcoded derivation kept verbatim — the bitwise parity reference arm
(tests/multidevice_checks.py "eqn"), same escape-hatch pattern as
``HEAT3D_NO_PLAN``.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

from heat3d_tpu_torch.eqn.families import (  # noqa: F401
    DEFAULT_FAMILY,
    FAMILIES,
    EquationFamily,
    heat7,
    heat27,
)
from heat3d_tpu_torch.eqn.spec import (  # noqa: F401
    EquationSpec,
    StencilSpec,
    Term,
    lower_taps,
    resolve_params,
    spec_fingerprint,
)

ENV_LEGACY = "HEAT3D_EQN_LEGACY"


def family_for(cfg) -> EquationFamily:
    """The registered family of ``cfg.equation`` (KeyError-free: config
    validation already rejected unknown names; this is the one lookup)."""
    fam = FAMILIES.get(cfg.equation)
    if fam is None:
        raise ValueError(
            f"unknown equation family {cfg.equation!r}; have "
            f"{sorted(FAMILIES)}"
        )
    return fam


def resolved_params(cfg) -> dict:
    """The family defaults merged with ``cfg.eq_params`` overrides."""
    fam = family_for(cfg)
    return resolve_params(dict(fam.defaults), tuple(cfg.eq_params))


def build_spec(cfg) -> EquationSpec:
    """Compile ``cfg`` (family + params + stencil kind + grid.alpha) to
    its :class:`EquationSpec`."""
    fam = family_for(cfg)
    if cfg.stencil.kind not in fam.kinds:
        raise ValueError(
            f"equation {fam.name!r} supports stencil kinds {fam.kinds}, "
            f"got {cfg.stencil.kind!r}"
        )
    return fam.build(cfg.stencil.kind, resolved_params(cfg), cfg.grid.alpha)


# Families whose explicit update operator is SYMMETRIC (no advection /
# odd-derivative term): the matrix-free CG solve (integrator=implicit-cg,
# heat3d_tpu.timeint.cg) requires a symmetric positive-definite system
# A = 2I - T, which an asymmetric T cannot provide.
CG_FAMILIES = ("heat", "aniso-diffusion", "reaction-diffusion")


def _validate_integrator(cfg, fam) -> None:
    """Integrator/family coupling (docs/INTEGRATORS.md): the wave family
    is second order in time and exists only under the two-level leapfrog
    carry; conversely leapfrog integrates nothing else. implicit-cg is
    restricted to symmetric operators (CG_FAMILIES) — and is the one
    integrator for which a dt above the family's explicit bound is the
    POINT, so the default-dt stability check stands down for it."""
    ti = getattr(cfg, "integrator", "explicit-euler")
    if fam.name == "wave" and ti != "leapfrog":
        raise ValueError(
            f"equation 'wave' is second order in time: it needs the "
            f"two-level leapfrog carry (integrator='leapfrog'), got "
            f"integrator={ti!r} (docs/INTEGRATORS.md)"
        )
    if ti == "leapfrog" and fam.name != "wave":
        raise ValueError(
            f"integrator='leapfrog' integrates the wave family's "
            f"second-order-in-time operator; {fam.name!r} is first order "
            "in time — use explicit-euler or implicit-cg "
            "(docs/INTEGRATORS.md)"
        )
    if ti == "implicit-cg" and fam.name not in CG_FAMILIES:
        raise ValueError(
            f"integrator='implicit-cg' needs a symmetric operator "
            f"(families {CG_FAMILIES}); {fam.name!r} breaks the "
            "conjugate-gradient symmetry contract (docs/INTEGRATORS.md)"
        )


def validate_config(cfg) -> None:
    """Config-time validation: family known, stencil kind supported,
    params resolvable, integrator/family coupling sound — and, for
    non-heat families with a DEFAULT (dt=None) timestep, the derived dt
    must respect the family's own explicit-Euler stability bound.
    ``GridConfig.effective_dt`` only knows the diffusion operator, so a
    strong reaction/advection term would otherwise let a default-dt run
    diverge silently (residual inf, rc 0); an EXPLICIT dt stays the
    author's contract (docs/EQUATIONS.md "Authoring guide"). The
    implicit-cg integrator is unconditionally stable, so the bound check
    stands down for it. Raises ValueError with the production message —
    SolverConfig.__post_init__ calls this so a bad --equation fails in
    ms, not at step-build time."""
    build_spec(cfg)
    fam = family_for(cfg)
    _validate_integrator(cfg, fam)
    if getattr(cfg, "integrator", "explicit-euler") == "implicit-cg":
        return
    if cfg.equation != "heat" and cfg.grid.dt is None and callable(
        fam.stable_dt
    ):
        bound = fam.stable_dt(
            resolved_params(cfg), cfg.grid.alpha, cfg.grid.spacing
        )
        dt = cfg.grid.effective_dt()
        if dt > bound * (1.0 + 1e-12):
            raise ValueError(
                f"equation {fam.name!r}: the default-derived dt "
                f"{dt:.4g} (0.9x the DIFFUSION stability bound) exceeds "
                f"this family's explicit-Euler bound {bound:.4g} at "
                f"these parameters — the run would diverge. Pass an "
                f"explicit dt <= {bound:.4g} (docs/EQUATIONS.md)"
            )


def solver_taps(cfg) -> np.ndarray:
    """THE tap derivation for a config: lower its equation spec at the
    grid's dt/spacing. Heat lowers bit-identically to the legacy
    ``stencil_taps`` path (the spec's diffusion term shares the
    ``scaled_laplacian`` body and the ``(dt*alpha)*lap`` association)."""
    if os.environ.get(ENV_LEGACY):
        if cfg.equation != "heat":
            raise ValueError(
                f"{ENV_LEGACY}=1 covers only the heat family (the legacy "
                f"hardcoded path never solved {cfg.equation!r})"
            )
        from heat3d_tpu_torch.core.stencils import STENCILS, stencil_taps

        return stencil_taps(
            STENCILS[cfg.stencil.kind],
            cfg.grid.alpha,
            cfg.grid.effective_dt(),
            cfg.grid.spacing,
        )
    return lower_taps(
        build_spec(cfg), cfg.grid.effective_dt(), cfg.grid.spacing
    )


def fingerprint(cfg) -> str:
    """The tune-cache key leg for this config's equation: the bare
    stencil kind for heat (so every committed cache entry predating the
    eqn subsystem stays byte-identical and addressable), else
    ``<family>:<kind>:<spec content hash>``."""
    if cfg.equation == "heat":
        return cfg.stencil.kind
    return (
        f"{cfg.equation}:{cfg.stencil.kind}:"
        f"{spec_fingerprint(build_spec(cfg))}"
    )


def mms_rates(cfg, k: Tuple[float, float, float]) -> Tuple[float, float]:
    """(mu, omega) plane-wave rates of ``cfg``'s equation at physical
    wavevector ``k`` — the analytic reference the convergence tests
    compare against (core.golden.plane_wave evaluates the solution)."""
    return family_for(cfg).mms_rates(resolved_params(cfg), cfg.grid.alpha, k)
