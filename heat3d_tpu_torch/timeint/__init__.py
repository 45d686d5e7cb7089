"""heat3d_tpu_torch.timeint — the time-integrator registry.

Port of ``heat3d_tpu.timeint`` (docs/INTEGRATORS.md). Generalizes the step
carry beyond explicit Euler's single field:

- ``explicit-euler`` — the default; ``HeatSolver3D`` keeps the kernel
  routes of ``parallel.step`` and never enters this package.
- ``leapfrog`` — the wave family's two-level carry ``(u, u_prev)``
  (:mod:`heat3d_tpu_torch.timeint.leapfrog`): one tap sweep and one
  subtraction per update, the superstep's ring recompute included.
- ``implicit-cg`` — matrix-free conjugate-gradient backward Euler
  (:mod:`heat3d_tpu_torch.timeint.cg`): unconditionally stable, dt far
  above the explicit bound, a keep-masked loop of a fixed trip count.

As in the JAX package, both integrators run the plain update of the jnp arm
(``ops.stencil_eager.apply_taps_padded``: the eager tap chain) over the
ghost blocks of the solver's ``parallel.plan`` exchange, with the ppermute
transport: the kernel routes fuse the single-level explicit update only.
A field is a list of shard tensors in rank order (``parallel.topology``);
the leapfrog carry is a pair of such lists. The spatially-varying
coefficient fields (:mod:`heat3d_tpu_torch.timeint.coeffield`) are a serve
surface: the ensemble runs their flux-form update, no integrator here does.
"""

from __future__ import annotations

import dataclasses

from heat3d_tpu_torch.core.config import (  # noqa: F401
    DEFAULT_INTEGRATOR,
    INTEGRATORS,
    SolverConfig,
)
from heat3d_tpu_torch.timeint import cg, leapfrog  # noqa: F401


class MultiLevelCheckpointError(ValueError):
    """A checkpoint's level structure does not match the integrator's
    carry: missing level manifest, wrong ``levels`` count, or a per-level
    shard shape mismatch. A ValueError, so a supervisor treats it as
    skip-this-generation, never quarantine (the shards are not corrupt:
    they are the wrong shape of state)."""


def carry_levels(integrator: str) -> int:
    """Field levels in the step carry: 2 for leapfrog, else 1."""
    return 2 if integrator == "leapfrog" else 1


def pin_config(cfg: SolverConfig) -> SolverConfig:
    """Resolve the 'auto' knobs of a non-default integrator without a
    tuning cache, as the JAX package does: the multi-level and implicit
    step functions are plain-chain + ppermute programs, so ``backend='auto'``
    pins to 'jnp', ``halo='auto'`` to 'ppermute' and ``time_blocking=0``
    to 1; ``halo_plan='auto'`` and ``fused_rdma='auto'`` take the JAX
    package's static fallbacks (``resolve_halo_plan``: 'monolithic';
    ``resolve_fused_rdma``: 'off'). Returns ``cfg`` itself when nothing
    is auto."""
    kw = {}
    if cfg.backend == "auto":
        kw["backend"] = "jnp"
    if cfg.halo == "auto":
        kw["halo"] = "ppermute"
    if cfg.halo_plan == "auto":
        kw["halo_plan"] = "monolithic"
    if cfg.fused_rdma == "auto":
        kw["fused_rdma"] = "off"
    if cfg.time_blocking == 0:
        kw["time_blocking"] = 1
    return dataclasses.replace(cfg, **kw) if kw else cfg


def validate_config(cfg: SolverConfig) -> None:
    """Structural validation for the non-default integrators' step
    functions (the family coupling itself — wave<->leapfrog, CG symmetry —
    is config-time: ``eqn._validate_integrator``). Raises ValueError
    listing every violation at once, with the JAX package's messages."""
    problems = []
    if cfg.integrator not in INTEGRATORS:
        problems.append(f"unknown integrator {cfg.integrator!r}")
    if cfg.backend != "jnp":
        problems.append(
            f"backend must be 'jnp' (got {cfg.backend!r}): the kernel "
            "routes fuse the single-level explicit update only"
        )
    if cfg.halo != "ppermute":
        problems.append(
            f"halo must be 'ppermute' (got {cfg.halo!r}): the DMA slab "
            "kernels are explicit-step-shaped"
        )
    if cfg.halo_order != "axis":
        problems.append(
            f"halo_order must be 'axis' (got {cfg.halo_order!r})"
        )
    if cfg.overlap:
        problems.append(
            "overlap=True unsupported (the interior/boundary split is "
            "explicit-step-shaped)"
        )
    if cfg.integrator == "implicit-cg" and cfg.time_blocking != 1:
        problems.append(
            f"implicit-cg needs time_blocking=1 (got {cfg.time_blocking}): "
            "each solve already amortizes many matvecs per exchange"
        )
    if cfg.integrator == "leapfrog" and cfg.time_blocking < 1:
        problems.append(
            f"leapfrog needs time_blocking >= 1, got {cfg.time_blocking}"
        )
    if problems:
        raise ValueError(
            f"integrator {cfg.integrator!r} unsupported for this config: "
            + "; ".join(problems)
            + " (docs/INTEGRATORS.md)"
        )


def make_step_fn(cfg: SolverConfig, mesh, with_residual: bool = False, exchanges=None,
                 workspace=None):
    """The integrator's one-step function over the mesh's shards. Leapfrog
    maps the two-level carry ``(us, ups) -> (us_new, us)``; implicit-cg
    maps ``us -> us_new``. ``with_residual`` appends the global change
    residual (a 0-d float32 tensor) in both cases. ``exchanges`` are the
    solver's plans; ``workspace`` the CG's shared Krylov vectors."""
    validate_config(cfg)
    if cfg.integrator == "leapfrog":
        return leapfrog.make_step_fn(cfg, mesh, with_residual=with_residual,
                                     exchanges=exchanges)
    if cfg.integrator == "implicit-cg":
        return cg.make_step_fn(cfg, mesh, with_residual=with_residual, exchanges=exchanges,
                               workspace=workspace)
    raise ValueError(
        f"integrator {cfg.integrator!r} has no timeint step function "
        "(explicit-euler rides parallel.step)"
    )


def make_multistep_fn(cfg: SolverConfig, mesh, exchanges=None, ring=None, workspace=None):
    """The integrator's fixed-step loop. Leapfrog: ``(carry, n) -> carry``.
    implicit-cg: ``(us, n) -> (us, cg_iters, cg_relres)``, the last
    solve's statistics as 0-d tensors. ``ring`` keeps the loop's spare
    buffers between calls (``parallel.step.PingPong``)."""
    validate_config(cfg)
    if cfg.integrator == "leapfrog":
        return leapfrog.make_multistep_fn(cfg, mesh, exchanges=exchanges, ring=ring)
    if cfg.integrator == "implicit-cg":
        return cg.make_multistep_fn(cfg, mesh, exchanges=exchanges, ring=ring,
                                    workspace=workspace)
    raise ValueError(
        f"integrator {cfg.integrator!r} has no timeint step function "
        "(explicit-euler rides parallel.step)"
    )
