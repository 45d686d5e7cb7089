"""Elastic degradation: survivor-mesh re-factorization for supervised runs.

Port of ``heat3d_tpu.resilience.elastic``. A backend loss in ``wait`` mode
is a wait state (probe until the original backend returns, then resume on
the original mesh); in ``elastic`` mode it is a re-plan event:

- **heal_mode** (``HEAT3D_HEAL_MODE`` / ``--heal-mode``): ``wait``
  (default), ``elastic`` (on a confirmed loss, re-probe the device set and
  re-factorize over survivors), or ``auto`` (heal-wait first; the heal
  DEADLINE triggers the elastic fallback).
- **Survivor meshes are certified, not improvised**:
  :func:`survivor_config` takes the mesh factorizations of
  ``tune.space.survivor_candidates`` and keeps the first that passes the
  port's production validation (the config's checks and a real solver
  build, ``prune_reason``) and the re-stitch contract (the checkpoint's
  storage shape ``padded_shape`` preserved, so the ``gen-<step>`` shards
  stitch onto the new mesh through ``utils.checkpoint``'s cross-mesh
  path).
- **The re-stitch is the existing path**: :func:`refactor_and_restitch`
  builds the solver for the survivor config and loads the newest good
  generation onto it. The port keeps no process-wide plan cache: a
  solver's exchange plans, DMA launch tables and fused states live in the
  solver, so the supervisor drops the old solver, with its plans, before
  this builds the new one, whose plans are built by its first step.
- **Deadline knob**: ``HEAT3D_HEAL_DEADLINE_S`` caps the heal wait
  (:func:`default_heal_policy`); in ``auto`` mode its expiry is what
  flips the run from waiting to degrading.

Survivors are counted by ``backendprobe.probe_device_count`` (the CUDA
devices a fresh process sees) unless a fault plan or the caller's
``device_probe`` says otherwise. A run whose shards all share one
``device`` (``--device cuda:0``) counts its shards as devices, as the JAX
package's device mesh does: such a run that loses its card and finds one
answering again re-plans onto a (1,1,1) mesh on that card.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Callable, Optional

from heat3d_tpu_torch import obs
from heat3d_tpu_torch.resilience.retry import RetryPolicy

log = logging.getLogger("heat3d.elastic")

ENV_HEAL_MODE = "HEAT3D_HEAL_MODE"
ENV_HEAL_DEADLINE = "HEAT3D_HEAL_DEADLINE_S"
HEAL_MODES = ("wait", "elastic", "auto")

DEFAULT_HEAL_DEADLINE_S = 1800.0


def resolve_heal_mode(mode: Optional[str] = None) -> str:
    """The concrete heal mode: explicit argument > ``HEAT3D_HEAL_MODE``
    env > ``wait``. Raises on unknown values — a typo'd mode silently
    heal-waiting forever is the exact failure this knob exists to end."""
    mode = mode or os.environ.get(ENV_HEAL_MODE) or "wait"
    if mode not in HEAL_MODES:
        raise ValueError(
            f"unknown heal_mode {mode!r} (want one of {HEAL_MODES}; "
            f"{ENV_HEAL_MODE} is the env default)"
        )
    return mode


def heal_deadline_s(default: float = DEFAULT_HEAL_DEADLINE_S) -> float:
    """The heal-wait total deadline: ``HEAT3D_HEAL_DEADLINE_S`` override,
    else ``default``. A non-numeric or non-positive override falls back
    (the knob must never kill the recovery it bounds)."""
    raw = os.environ.get(ENV_HEAL_DEADLINE)
    if raw:
        try:
            v = float(raw)
            if v > 0:
                return v
            log.warning(
                "%s=%r is not positive; using %.0fs",
                ENV_HEAL_DEADLINE, raw, default,
            )
        except ValueError:
            log.warning(
                "%s=%r is not a number; using %.0fs",
                ENV_HEAL_DEADLINE, raw, default,
            )
    return default


def default_heal_policy() -> RetryPolicy:
    """The supervisor's heal-wait policy, deadline-capped by
    ``HEAT3D_HEAL_DEADLINE_S``: probe every 60 s, 1.5x backoff capped at
    5 min, jittered. In ``wait`` mode the deadline is where an unhealable
    backend finally re-raises instead of waiting forever; in ``auto`` mode
    it is what triggers the elastic fallback."""
    return RetryPolicy(
        base_delay_s=60.0,
        multiplier=1.5,
        max_delay_s=300.0,
        jitter_frac=0.1,
        deadline_s=heal_deadline_s(),
    )


def probe_survivors(
    plan=None,
    device_probe: Optional[Callable[[], Optional[int]]] = None,
) -> Optional[int]:
    """How many devices survive, or None when nothing answers.

    The injected :class:`~heat3d_tpu_torch.resilience.faults.FaultPlan`
    override is consulted first (the deterministic CPU tier), then the
    caller's ``device_probe`` (tests), then the bounded out-of-process
    ``backendprobe.probe_device_count`` — never an in-process CUDA call
    whose context may be the thing that failed. No CUDA device answering
    counts as nothing answering."""
    if plan is not None:
        override = plan.device_override()
        if override is not None:
            return override
    if device_probe is not None:
        return device_probe()
    from heat3d_tpu_torch.utils.backendprobe import probe_device_count

    return probe_device_count() or None


def survivor_config(base_cfg, num_devices: int, make_solver_for=None):
    """The certified degraded config for ``num_devices`` survivors, or
    None when no candidate passes (the caller falls back to heal-wait
    semantics). ``make_solver_for`` builds each candidate's solver for the
    validation (default ``HeatSolver3D(cfg)``; the supervisor passes the
    run's factory, so candidates are built where the run's shards live)."""
    if num_devices < 1:
        return None
    from heat3d_tpu_torch.tune.space import survivor_candidates

    cands = survivor_candidates(base_cfg, num_devices, make_solver=make_solver_for)
    return cands[0] if cands else None


def refactor_and_restitch(
    new_cfg,
    make_solver_for: Callable[[object], object],
    ckpt_root: str,
    *,
    old_mesh,
    step: int,
    survivors: int,
    direction: str = "degrade",
):
    """Build the solver on ``new_cfg``'s mesh and re-stitch the newest
    good generation onto it. Returns ``(solver, loaded, quarantined,
    restitch_s)`` with the supervisor's ``load_latest_generation``
    semantics (``loaded`` None = nothing loadable; the caller applies the
    same refuse-to-restart rules as a normal resume). The caller drops the
    old solver first: its plans and buffers are bound to the old mesh.
    ONE ``elastic_refactor`` ledger event records old/new mesh, survivor
    count and re-stitch seconds — the outage-attribution row ``obs
    summary`` reads."""
    from heat3d_tpu_torch.resilience.supervisor import load_latest_generation

    t0 = time.monotonic()
    solver = make_solver_for(new_cfg)
    loaded, quarantined = load_latest_generation(solver, ckpt_root)
    restitch_s = time.monotonic() - t0
    obs.get().event(
        "elastic_refactor",
        direction=direction,
        old_mesh=list(old_mesh),
        new_mesh=list(new_cfg.mesh.shape),
        old_devices=int(
            old_mesh[0] * old_mesh[1] * old_mesh[2]
        ),
        survivors=int(survivors),
        lost_devices=int(
            old_mesh[0] * old_mesh[1] * old_mesh[2]
            - new_cfg.mesh.num_devices
        ),
        restitch_s=round(restitch_s, 6),
        step=int(step),
        resumed_from=None if loaded is None else int(loaded[1]),
        quarantined=quarantined,
    )
    obs.REGISTRY.counter(
        "elastic_refactors_total", "survivor-mesh re-factorizations"
    ).inc(direction=direction)
    log.warning(
        "elastic refactor (%s): mesh %s -> %s (%d survivor(s)), "
        "re-stitch %.3fs",
        direction, tuple(old_mesh), new_cfg.mesh.shape, survivors,
        restitch_s,
    )
    return solver, loaded, quarantined, restitch_s
