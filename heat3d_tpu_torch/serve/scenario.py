"""Scenario specs: what varies per ensemble member, what must be shared.

Port of ``heat3d_tpu.serve.scenario``: the same dataclasses, validation,
per-member configs and bucket keys.

A *scenario* is one independent heat problem: its initial condition, its
Dirichlet boundary value, its diffusivity/timestep, and its step budget.
A :class:`ScenarioBatch` packs B scenarios over ONE structural config —
grid, stencil kind, BC kind, mesh, precision, solver knobs — which is
exactly the set one batched loop can serve with the per-member values
as tensors (serve/ensemble.py). The queue
(serve/queue.py) buckets incoming requests by :meth:`ScenarioBatch
.bucket_key` so only compatible scenarios ever share a program.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple, Union

import numpy as np

from heat3d_tpu_torch.core.config import SolverConfig


@dataclasses.dataclass(frozen=True)
class Scenario:
    """One ensemble member's independent problem data.

    ``init`` — named initializer (core.golden.INITIALIZERS) or an explicit
    array of the TRUE grid shape. ``alpha``/``dt`` — the member's
    diffusivity and timestep (``dt=None`` = 0.9x the member's stable dt,
    same rule as GridConfig). ``bc_value`` — the member's Dirichlet
    boundary value (ignored under periodic BCs). ``steps`` — the member's
    step budget (``None`` = the batch default); members of one batch may
    carry different budgets — finished members freeze bitwise while the
    rest run on.
    """

    init: Union[str, np.ndarray] = "hot-cube"
    alpha: float = 1.0
    dt: Optional[float] = None
    bc_value: float = 0.0
    steps: Optional[int] = None
    seed: int = 0
    # Per-member equation-parameter overrides ((name, value) pairs —
    # e.g. a member's own advection velocity) on top of the BASE config's
    # equation family + eq_params. The traced bind feeds the member's
    # lowered tap values into the shared parametric chain, so per-member
    # spec coefficients ride with zero recompilation (docs/SERVING.md
    # "Per-member spec binding"); the footprint guard still applies —
    # values that change which taps are nonzero fail loudly at batch
    # construction.
    eq_params: Tuple[Tuple[str, float], ...] = ()
    # Which time integrator this request wants (core.config.INTEGRATORS;
    # None = the batch base's). One compiled program runs ONE integrator,
    # so the queue buckets on it (solver_bucket_key) and ScenarioBatch
    # requires every member that states one to agree.
    integrator: Optional[str] = None
    # Per-member spatially-varying diffusivity: a coefficient-FIELD spec
    # tuple ``(name, seed, lo, hi)`` resolved by
    # ``timeint.coeffield.make_coef_field`` (name alone or a prefix is
    # accepted; defaults seed=0, lo=0.5, hi=1.5). The field replaces the
    # member's scalar alpha in the flux-form update and rides the traced
    # bind as a runtime input; all-or-none across a batch (the varcoef
    # program has a different input signature).
    coef_field: Optional[Tuple] = None

    def __post_init__(self):
        if self.integrator is not None:
            from heat3d_tpu_torch.core.config import INTEGRATORS

            if self.integrator not in INTEGRATORS:
                raise ValueError(
                    f"scenario integrator {self.integrator!r} not in "
                    f"{INTEGRATORS}"
                )
        if self.coef_field is not None:
            cf = self.coef_field
            if isinstance(cf, str):
                cf = (cf,)
            cf = tuple(cf)
            if not 1 <= len(cf) <= 4:
                raise ValueError(
                    f"coef_field must be (name[, seed[, lo[, hi]]]), got "
                    f"{self.coef_field!r}"
                )
            name = str(cf[0])
            seed = int(cf[1]) if len(cf) > 1 else 0
            lo = float(cf[2]) if len(cf) > 2 else 0.5
            hi = float(cf[3]) if len(cf) > 3 else 1.5
            from heat3d_tpu_torch.timeint.coeffield import COEF_FIELDS

            if name not in COEF_FIELDS:
                raise ValueError(
                    f"unknown coefficient field {name!r}; have "
                    f"{COEF_FIELDS}"
                )
            if not 0.0 < lo <= hi:
                raise ValueError(
                    f"coef_field needs 0 < lo <= hi, got lo={lo} hi={hi}"
                )
            object.__setattr__(self, "coef_field", (name, seed, lo, hi))
        if self.alpha <= 0.0:
            raise ValueError(
                f"scenario alpha must be > 0, got {self.alpha} (alpha*dt=0 "
                "degenerates the tap footprint the batch shares)"
            )
        if self.dt is not None and self.dt <= 0.0:
            raise ValueError(f"scenario dt must be > 0, got {self.dt}")
        if self.steps is not None and self.steps < 0:
            raise ValueError(f"scenario steps must be >= 0, got {self.steps}")
        if not isinstance(self.eq_params, tuple):
            object.__setattr__(
                self,
                "eq_params",
                tuple((str(k), float(v)) for k, v in self.eq_params),
            )


class ScenarioBatch:
    """B scenarios over one structural :class:`SolverConfig`.

    ``base`` supplies everything the members share: grid shape/spacing,
    stencil kind + BC kind, mesh, precision, and the solver knobs
    (backend/halo/time_blocking/...). Each member's ``alpha``/``dt``/
    ``bc_value``/``steps`` override the base's per-member. Construction
    validates that every member's update taps occupy the SAME footprint
    as the base's (they always do for alpha*dt > 0 — the guard exists so
    a degenerate member fails loudly instead of silently changing the
    shared chain structure).
    """

    def __init__(self, base: SolverConfig, members: Sequence[Scenario]):
        members = tuple(members)
        if not members:
            raise ValueError("a ScenarioBatch needs at least one scenario")
        # integrator consistency: one compiled program runs ONE
        # integrator, so members that state one must agree — and the
        # stated one becomes the batch's effective base integrator
        # (requests carrying an integrator bucket apart via
        # solver_bucket_key before they ever reach a batch)
        stated = {m.integrator for m in members if m.integrator is not None}
        if len(stated) > 1:
            raise ValueError(
                f"members of one batch state conflicting integrators "
                f"{sorted(stated)} — one compiled program runs one "
                "integrator (the queue buckets on it; these requests "
                "should never have shared a batch)"
            )
        if stated:
            ti = stated.pop()
            if ti != base.integrator:
                base = dataclasses.replace(base, integrator=ti)
        # coefficient fields: all-or-none (the varcoef program takes the
        # field array as an extra runtime input — a mixed batch has no
        # single program signature), and only on the explicit heat sweep
        with_cf = sum(1 for m in members if m.coef_field is not None)
        if with_cf not in (0, len(members)):
            raise ValueError(
                f"{with_cf}/{len(members)} members carry coef_field — "
                "coefficient fields are all-or-none across a batch (the "
                "varcoef program has a different input signature)"
            )
        self.has_coef_fields = with_cf == len(members)
        if self.has_coef_fields:
            if base.equation != "heat" or base.integrator != "explicit-euler":
                raise ValueError(
                    "coef_field members need the explicit-euler heat "
                    f"sweep, got equation={base.equation!r} "
                    f"integrator={base.integrator!r} (docs/INTEGRATORS.md)"
                )
        self.base = base
        self.members = members
        self._check_footprints()

    def __len__(self) -> int:
        return len(self.members)

    # ---- per-member config materialization --------------------------------

    def member_dt(self, i: int) -> float:
        m = self.members[i]
        if m.dt is not None:
            return m.dt
        if m.coef_field is not None:
            # flux-form explicit bound at the field's MAX (hi clip):
            # same 0.9x safety rule as GridConfig.effective_dt
            from heat3d_tpu_torch.timeint.coeffield import varcoef_stable_dt

            return 0.9 * varcoef_stable_dt(
                m.coef_field[3], self.base.grid.spacing
            )
        g = dataclasses.replace(self.base.grid, alpha=m.alpha, dt=None)
        return g.effective_dt()

    def member_config(self, i: int) -> SolverConfig:
        """The full solo :class:`SolverConfig` member ``i`` describes —
        what a single-tenant :class:`HeatSolver3D` run of this scenario
        would be configured with (the bitwise reference the ensemble
        equivalence tests compare against). A member's ``eq_params``
        overlay the base's (member pairs win on name clashes)."""
        m = self.members[i]
        eq = dict(self.base.eq_params)
        eq.update(dict(m.eq_params))
        return dataclasses.replace(
            self.base,
            grid=dataclasses.replace(
                self.base.grid, alpha=m.alpha, dt=self.member_dt(i)
            ),
            stencil=dataclasses.replace(
                self.base.stencil, bc_value=m.bc_value
            ),
            run=dataclasses.replace(
                self.base.run, num_steps=self.member_steps(i), seed=m.seed
            ),
            eq_params=tuple(sorted(eq.items())),
        )

    def member_steps(self, i: int) -> int:
        m = self.members[i]
        return self.base.run.num_steps if m.steps is None else m.steps

    def member_coef_field(self, i: int) -> np.ndarray:
        """Member ``i``'s resolved fp64 coefficient field on the TRUE
        grid (deterministic from the spec tuple — rebuilt, never
        checkpointed)."""
        m = self.members[i]
        if m.coef_field is None:
            raise ValueError(f"scenario {i} carries no coef_field")
        from heat3d_tpu_torch.timeint.coeffield import make_coef_field

        name, seed, lo, hi = m.coef_field
        return make_coef_field(
            name, self.base.grid.shape, seed=seed, lo=lo, hi=hi
        )

    def member_taps(self, i: int) -> np.ndarray:
        """Member ``i``'s lowered update taps, via the equation frontend
        on the member's solo config — for the heat family this is
        bit-identical to the old inline ``stencil_taps(kind, alpha, dt,
        spacing)`` call (the eqn bitwise contract), and for spec-built
        families it carries the member's own equation coefficients into
        the traced bind."""
        from heat3d_tpu_torch import eqn

        return eqn.solver_taps(self.member_config(i))

    def _check_footprints(self) -> None:
        from heat3d_tpu_torch.core.stencils import flat_taps
        from heat3d_tpu_torch.parallel.step import _solver_taps

        want = tuple(
            (di, dj, dk) for di, dj, dk, _ in flat_taps(_solver_taps(self.base))
        )
        for i in range(len(self.members)):
            got = tuple(
                (di, dj, dk) for di, dj, dk, _ in flat_taps(self.member_taps(i))
            )
            if got != want:
                raise ValueError(
                    f"scenario {i}: its taps occupy footprint {got} but the "
                    f"batch's shared structure is {want} — members of one "
                    "batch must share the stencil footprint (alpha*dt > 0)"
                )

    # ---- queue bucketing ---------------------------------------------------

    def bucket_key(self) -> Tuple:
        """The structural compatibility key: scenarios whose batches share
        this key can be packed into ONE compiled ensemble program (the
        per-member values are runtime inputs; step budgets are traced, so
        they do NOT bucket). Coefficient-field batches run a different
        PROGRAM (the field array is an extra traced input), so the flag
        buckets — the field VALUES stay runtime inputs and do not."""
        key = solver_bucket_key(self.base)
        if self.has_coef_fields:
            key = key + ("coef-field",)
        return key


def request_bucket_key(base: SolverConfig, scenario: Scenario) -> Tuple:
    """The bucket key of ONE request: the base's structural key with the
    scenario's integrator override applied and the coef-field program
    flag appended — exactly what :meth:`ScenarioBatch.bucket_key` would
    say for a batch of such requests. Queues group by THIS key, so a
    request stating ``integrator='implicit-cg'`` (or carrying a
    coefficient field) can never pack with the plain explicit sweep of
    the same base."""
    ti = scenario.integrator
    if ti is not None and ti != base.integrator:
        base = dataclasses.replace(base, integrator=ti)
    key = solver_bucket_key(base)
    if scenario.coef_field is not None:
        key = key + ("coef-field",)
    return key


def solver_bucket_key(cfg: SolverConfig) -> Tuple:
    """The structural key of ``cfg``: everything that shapes the compiled
    ensemble program. Two requests sharing this key differ only in
    runtime inputs (IC, bc value, taps, budget)."""
    return (
        tuple(cfg.grid.shape),
        tuple(cfg.grid.spacing),
        cfg.stencil.kind,
        # equation family + base params shape the compiled chain (its
        # footprint and term structure) — requests of different families
        # must never pack into one program. Member-level eq_params stay
        # runtime inputs (the traced bind), so they deliberately do NOT
        # bucket.
        cfg.equation,
        tuple(cfg.eq_params),
        cfg.stencil.bc.value,
        tuple(cfg.mesh.shape),
        cfg.precision.storage,
        cfg.precision.compute,
        cfg.precision.residual,
        cfg.backend,
        cfg.halo,
        cfg.halo_order,
        cfg.overlap,
        cfg.time_blocking,
        # time integrator: a leapfrog carry or a CG solve is a
        # structurally different program — requests of different
        # integrators must never pack into one bucket
        cfg.integrator,
    )
