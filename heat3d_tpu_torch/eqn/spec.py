"""Declarative stencil/equation specs and the compiler that lowers them.

The Cerebras/Tenstorrent stencil papers (PAPERS.md) treat a stencil as
*data* — coefficients + footprint in, optimized schedule out. This module
is that authoring surface for the repo: an :class:`EquationSpec` is a sum
of spatial-operator terms (:class:`StencilSpec` + coefficient), and
:func:`lower_taps` lowers it to the ONE artifact every downstream layer
already consumes — the 3x3x3 explicit-Euler *update* tap array ``T`` with
``u_new[c] = sum_d T[d] u[c+d-1]``. Everything past the taps (the
``_chain_accumulate`` emission, halo plans, supersteps, the tuner, the
serve traced-bind, IR certification) is untouched by construction: a
spec-built program IS a tap-chain program.

Bitwise contract: the heat family's diffusion term lowers through
:func:`core.stencils.scaled_laplacian` — the SAME float arithmetic body
``stencil_taps`` runs — and a single-diffusion-term spec multiplies
``(dt * coeff) * lap`` exactly as the legacy path does, so spec-compiled
heat taps are bit-identical to the hardcoded path (test-pinned, and
proven e2e on a 4-device CPU mesh in tests/multidevice_checks.py).

Scope: linear, constant-coefficient operators on the 3x3x3 footprint —
one time level, explicit Euler. Per-cell coefficient *values* still vary
per ensemble member at runtime (the serve traced-bind feeds each member's
lowered tap values into one compiled parametric chain); spatially-varying
coefficient FIELDS and multi-level schemes (wave) are future families
(docs/EQUATIONS.md "Authoring guide").
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Mapping, Tuple

import numpy as np

from heat3d_tpu_torch.core.stencils import scaled_laplacian

# how a term's unit-spacing weights pick up the grid spacing
SCALINGS = (
    # per-axis 1/h^2 on the axis taps, center rebalanced — the exact
    # stencil_taps separable arithmetic (7pt Laplacian, anisotropic taps)
    "laplacian-separable",
    # uniform-spacing w / h^2 (the 27pt isotropic Laplacian)
    "laplacian-uniform",
    # first-derivative taps: each axis tap scaled by 1/(2*h_axis) — the
    # central-difference gradient (advection terms)
    "gradient",
    # raw weights, no spacing (zeroth-order/reaction terms)
    "none",
)


@dataclasses.dataclass(frozen=True)
class StencilSpec:
    """One spatial operator: 3x3x3 unit-spacing weights + spacing law.

    ``weights[di+1, dj+1, dk+1]`` multiplies ``u[c + (di,dj,dk)]``.
    Laplacian scalings require the weights to sum to 0 (a consistent
    second-difference operator); the gradient scaling requires
    axis-antisymmetric face taps and no off-axis entries.
    """

    weights: np.ndarray  # (3,3,3) float64
    scaling: str = "laplacian-separable"

    def __post_init__(self):
        w = np.asarray(self.weights, dtype=np.float64)
        if w.shape != (3, 3, 3):
            raise ValueError(f"spec weights must be (3,3,3), got {w.shape}")
        w = w.copy()
        w.setflags(write=False)
        object.__setattr__(self, "weights", w)
        if self.scaling not in SCALINGS:
            raise ValueError(
                f"unknown scaling {self.scaling!r}; have {SCALINGS}"
            )
        if self.scaling.startswith("laplacian") and abs(w.sum()) > 1e-12:
            raise ValueError(
                f"{self.scaling} weights must sum to 0, got {w.sum()}"
            )
        if self.scaling == "gradient":
            off_axis = w.copy()
            off_axis[0, 1, 1] = off_axis[2, 1, 1] = 0.0
            off_axis[1, 0, 1] = off_axis[1, 2, 1] = 0.0
            off_axis[1, 1, 0] = off_axis[1, 1, 2] = 0.0
            if np.any(off_axis != 0.0):
                raise ValueError(
                    "gradient weights must live on the six face taps only"
                )
            for lo, hi in (
                ((0, 1, 1), (2, 1, 1)),
                ((1, 0, 1), (1, 2, 1)),
                ((1, 1, 0), (1, 1, 2)),
            ):
                if w[lo] != -w[hi]:
                    raise ValueError(
                        "gradient weights must be axis-antisymmetric "
                        f"(w{lo} == -w{hi}), got {w[lo]} vs {w[hi]}"
                    )

    def scaled(self, spacing: Tuple[float, float, float]) -> np.ndarray:
        """The spacing-scaled spatial operator (float64)."""
        if self.scaling == "laplacian-separable":
            return scaled_laplacian(self.weights, spacing, True)
        if self.scaling == "laplacian-uniform":
            return scaled_laplacian(self.weights, spacing, False)
        if self.scaling == "gradient":
            hx, hy, hz = spacing
            out = np.zeros((3, 3, 3))
            out[0, 1, 1] = self.weights[0, 1, 1] / (2.0 * hx)
            out[2, 1, 1] = self.weights[2, 1, 1] / (2.0 * hx)
            out[1, 0, 1] = self.weights[1, 0, 1] / (2.0 * hy)
            out[1, 2, 1] = self.weights[1, 2, 1] / (2.0 * hy)
            out[1, 1, 0] = self.weights[1, 1, 0] / (2.0 * hz)
            out[1, 1, 2] = self.weights[1, 1, 2] / (2.0 * hz)
            return out
        return np.array(self.weights, dtype=np.float64)


@dataclasses.dataclass(frozen=True)
class Term:
    """``coeff * op`` — one named addend of the spatial operator."""

    name: str
    coeff: float
    op: StencilSpec


@dataclasses.dataclass(frozen=True)
class EquationSpec:
    """du/dt = sum_i coeff_i * op_i(u), discretized explicit-Euler.

    ``terms`` order is load-bearing: lowering accumulates term
    contributions in spec order (deterministic float summation), so two
    specs with the same terms in the same order lower bit-identically.
    BC family, dtype contract, and mesh/plan knobs stay on SolverConfig —
    the spec describes the OPERATOR, the config describes the run.
    """

    family: str
    terms: Tuple[Term, ...]

    def __post_init__(self):
        if not self.terms:
            raise ValueError("an EquationSpec needs at least one term")
        names = [t.name for t in self.terms]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate term names: {names}")

    def footprint(
        self, dt: float, spacing: Tuple[float, float, float]
    ) -> Tuple[Tuple[int, int, int], ...]:
        """Nonzero tap offsets of the lowered update taps (sorted)."""
        from heat3d_tpu_torch.core.stencils import nonzero_taps

        taps = lower_taps(self, dt, spacing)
        return tuple(sorted(off for off, _ in nonzero_taps(taps)))


def lower_taps(
    spec: EquationSpec, dt: float, spacing: Tuple[float, float, float]
) -> np.ndarray:
    """Lower ``spec`` to explicit-Euler update taps:
    ``T = I + dt * sum_i coeff_i * scaled(op_i)``.

    Each term contributes ``(dt * coeff) * scaled`` — the scalar product
    formed FIRST, exactly the legacy ``dt * alpha * lap`` association —
    then contributions add in term order. A single-diffusion-term spec is
    therefore bit-identical to ``core.stencils.stencil_taps``.
    """
    taps = None
    for t in spec.terms:
        contrib = (dt * t.coeff) * t.op.scaled(spacing)
        taps = contrib if taps is None else taps + contrib
    taps[1, 1, 1] += 1.0
    return taps


def spec_fingerprint(spec: EquationSpec) -> str:
    """Deterministic short content hash of the spec structure + values —
    the tune-cache key leg for non-heat families (the heat family keys on
    the bare stencil kind so every committed entry stays addressable)."""
    h = hashlib.sha1()
    for t in spec.terms:
        h.update(
            f"{t.name}|{t.coeff!r}|{t.op.scaling}|".encode()
        )
        h.update(np.ascontiguousarray(t.op.weights).tobytes())
    return h.hexdigest()[:10]


def resolve_params(
    defaults: Mapping[str, float], overrides: Tuple[Tuple[str, float], ...]
) -> dict:
    """Family defaults merged with config overrides; unknown names raise
    (the config-validation surface — a typo'd --eq-param must fail in ms,
    not silently run the default equation)."""
    params = dict(defaults)
    for name, value in overrides:
        if name not in params:
            raise ValueError(
                f"unknown equation parameter {name!r}; this family has "
                f"{sorted(params)}"
            )
        v = float(value)
        if not np.isfinite(v):
            raise ValueError(f"equation parameter {name!r} must be finite")
        params[name] = v
    return params
