"""The search space's mesh factorizations and validity gates.

The part of ``heat3d_tpu.tune.space`` the elastic re-plan of a supervised
run needs (``resilience.elastic``): :func:`mesh_candidates`,
:func:`apply_knobs`, :func:`survivor_candidates` and :func:`prune_reason`.
Pruning reuses the port's OWN validation instead of a parallel rule set
that would drift: ``SolverConfig.__post_init__`` (with ``check_ported``)
rejects structurally invalid combos, and :func:`prune_reason` builds the
port's solver and its fixed-step loop, so every route gate a real run
would hit raises the same ``ValueError`` here. A solver build allocates
no field (the plans' padded blocks come with the first step), and each
candidate's solver is released before the next is built.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

from heat3d_tpu_torch.core.config import MeshConfig, SolverConfig, dims_create


def mesh_candidates(num_devices: int) -> Tuple[Tuple[int, int, int], ...]:
    """Distinct factorization candidates for ``num_devices``: the 1D
    x-slab (the reference's default), the balanced 3D block
    (MPI_Dims_create analogue), and the 2D pencil between them."""
    out = [(num_devices, 1, 1), dims_create(num_devices)]
    for px in range(2, num_devices + 1):
        if num_devices % px == 0:
            out.append((px, num_devices // px, 1))
            break
    seen: List[Tuple[int, int, int]] = []
    for m in out:
        if m not in seen:
            seen.append(m)
    return tuple(seen)


def apply_knobs(base: SolverConfig, knobs: Dict[str, Any]) -> SolverConfig:
    """``base`` with ``knobs`` overridden (``mesh`` takes a (Px,Py,Pz)
    tuple). Raises ``ValueError`` for structurally invalid combos —
    ``SolverConfig.__post_init__`` is the single source of those rules."""
    kw: Dict[str, Any] = {}
    for k, v in knobs.items():
        if k == "mesh":
            kw["mesh"] = MeshConfig(shape=tuple(v))
        else:
            kw[k] = v
    return dataclasses.replace(base, **kw)


def survivor_candidates(
    base: SolverConfig,
    num_devices: int,
    validate: bool = True,
    make_solver: Optional[Callable[[SolverConfig], object]] = None,
) -> List[SolverConfig]:
    """Certified degraded configs for ``base`` over ``num_devices``
    surviving devices, slab-first (:func:`mesh_candidates`), each passing
    three production gates so a degraded run only ever lands on a config a
    normal run could have used:

    - ``SolverConfig.__post_init__`` (structural validity, ported routes);
    - the **re-stitch contract**: the candidate's ``padded_shape`` equals
      ``base``'s, because the checkpoint being stitched onto the survivor
      mesh was saved in ``base``'s storage shape
      (``HeatSolver3D.load_checkpoint`` rejects another);
    - :func:`prune_reason` building the real solver with ``make_solver``
      (the run's factory, so the candidate is built where the run's
      shards live), unless ``validate`` is False.
    """
    out: List[SolverConfig] = []
    if num_devices < 1:
        return out
    for m in mesh_candidates(num_devices):
        try:
            cfg = apply_knobs(base, {"mesh": m})
        except ValueError:
            continue
        if cfg.padded_shape != base.padded_shape:
            continue
        if validate and prune_reason(cfg, make_solver) is not None:
            continue
        out.append(cfg)
    return out


def prune_reason(
    cfg: SolverConfig,
    make_solver: Optional[Callable[[SolverConfig], object]] = None,
) -> Optional[str]:
    """Why ``cfg`` cannot run in the CURRENT environment, or None.

    Builds the solver (``make_solver(cfg)``, default ``HeatSolver3D(cfg)``)
    and its fixed-step loop, so the gates are the production gates: routes,
    transports, time-blocking constraints, device availability. The solver
    is dropped before returning."""
    if make_solver is None:
        from heat3d_tpu_torch.models.heat3d import HeatSolver3D

        make_solver = HeatSolver3D
    try:
        solver = make_solver(cfg)
        # the superstep's constraints are checked on first use of the
        # fixed-step loop: force them now
        solver._multistep  # noqa: B018 - building IS the validation
    except (ValueError, NotImplementedError, ImportError) as e:
        return f"{type(e).__name__}: {str(e)[:160]}"
    del solver
    return None
