"""The single-device stencil step, superstep, fixed-step loop and
convergence loop.

Port of the (1,1,1)-mesh routes of ``heat3d_tpu.parallel.step``: there
every update of a single-shard solve dispatches the BC-fused direct kernel
(``apply_taps_direct``, tb=1) or its fused two-update form
(``apply_taps_direct2``, tb=2); here the same two kernels carry it
(``ops.stencil_direct``). The JAX package's ``fori_loop``/``while_loop``
become Python loops that launch one kernel per update (or superstep); its
ping-pong pair carry becomes two preallocated buffers the kernels write
into alternately, so a loop allocates nothing per step.

Every function takes and returns torch tensors on the solver's device.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from heat3d_tpu_torch import eqn
from heat3d_tpu_torch.core.config import BoundaryCondition, SolverConfig
from heat3d_tpu_torch.ops.stencil_direct import (
    apply_taps_direct,
    apply_taps_direct2,
)
from heat3d_tpu_torch.ops.stencil_eager import residual_sumsq

# (u, out=None) -> u_new; out, when given, is a preallocated buffer
StepFn = Callable[..., torch.Tensor]


def _solver_taps(cfg: SolverConfig) -> np.ndarray:
    return eqn.solver_taps(cfg)


def _residual_dtype(cfg: SolverConfig) -> torch.dtype:
    return getattr(torch, cfg.precision.residual)


def make_step_fn(
    cfg: SolverConfig,
    taps: Optional[np.ndarray] = None,
    with_residual: bool = False,
) -> StepFn:
    """``(u, out=None) -> u_new`` (or ``-> (u_new, residual_sumsq)``): one
    update through the direct kernel. ``taps`` default to the config's
    (``eqn.solver_taps``)."""
    taps = _solver_taps(cfg) if taps is None else taps
    periodic = cfg.stencil.bc is BoundaryCondition.PERIODIC
    bc_value = cfg.stencil.bc_value

    def step(u: torch.Tensor, out: Optional[torch.Tensor] = None):
        return apply_taps_direct(u, taps, periodic, bc_value, out=out)

    if not with_residual:
        return step
    res_dtype = _residual_dtype(cfg)

    def step_r(u: torch.Tensor, out: Optional[torch.Tensor] = None):
        u_new = step(u, out)
        return u_new, residual_sumsq(u_new, u, res_dtype)

    return step_r


def make_superstep_fn(
    cfg: SolverConfig, taps: Optional[np.ndarray] = None
) -> StepFn:
    """``(u, out=None) -> u_after_2_updates``: the tb=2 superstep through
    the fused two-update kernel."""
    if cfg.time_blocking != 2:
        raise ValueError(
            f"time_blocking={cfg.time_blocking}: only the tb=2 superstep is "
            "ported"
        )
    # the same floor as the JAX package: the superstep's intermediate needs
    # a genuine interior to recompute into
    min_extent = max(3, cfg.time_blocking)
    if min(cfg.local_shape) < min_extent:
        raise ValueError(
            f"time_blocking={cfg.time_blocking} needs local extents >= "
            f"{min_extent} (k ghost layers plus the shrinking recompute "
            f"rings), got {cfg.local_shape}"
        )
    taps = _solver_taps(cfg) if taps is None else taps
    periodic = cfg.stencil.bc is BoundaryCondition.PERIODIC
    bc_value = cfg.stencil.bc_value

    def superstep(u: torch.Tensor, out: Optional[torch.Tensor] = None):
        return apply_taps_direct2(u, taps, periodic, bc_value, out=out)

    return superstep


class PingPong:
    """Apply a step function ``count`` times between two buffers.

    The spare buffer is allocated once and kept: after each run the buffer
    not holding the result becomes the next spare. The input tensor is
    consumed (it may be overwritten), as the JAX package donates it."""

    def __init__(self):
        self._spare: Optional[torch.Tensor] = None

    def spare_for(self, u: torch.Tensor) -> torch.Tensor:
        s = self._spare
        if (
            s is None
            or s.shape != u.shape
            or s.dtype != u.dtype
            or s.device != u.device
            or s.data_ptr() == u.data_ptr()
        ):
            s = torch.empty_like(u)
        self._spare = None
        return s

    def keep(self, t: torch.Tensor) -> None:
        self._spare = t

    def run(self, step_fn: StepFn, u: torch.Tensor, count: int) -> torch.Tensor:
        if count <= 0:
            return u
        a, b = u, self.spare_for(u)
        for _ in range(count):
            b = step_fn(a, out=b)
            a, b = b, a
        self.keep(b)
        return a


def make_multistep_fn(
    cfg: SolverConfig,
    taps: Optional[np.ndarray] = None,
    pingpong: Optional[PingPong] = None,
) -> Callable[[torch.Tensor, int], torch.Tensor]:
    """``(u, num_steps) -> u_after``. With tb=2 the loop advances in
    ``num_steps // 2`` supersteps plus one trailing single step for an odd
    count; both loops ping-pong between the same two buffers."""
    taps = _solver_taps(cfg) if taps is None else taps
    pp = pingpong or PingPong()
    step = make_step_fn(cfg, taps)

    if cfg.time_blocking == 2:
        superstep = make_superstep_fn(cfg, taps)

        def run2(u: torch.Tensor, num_steps: int) -> torch.Tensor:
            u = pp.run(superstep, u, num_steps // 2)
            return pp.run(step, u, num_steps % 2)

        return run2

    def run(u: torch.Tensor, num_steps: int) -> torch.Tensor:
        return pp.run(step, u, num_steps)

    return run


def make_converge_fn(
    cfg: SolverConfig,
    taps: Optional[np.ndarray] = None,
    pingpong: Optional[PingPong] = None,
) -> Callable[[torch.Tensor, int, float], Tuple[torch.Tensor, int, float]]:
    """``(u, max_steps, tol) -> (u, steps_taken, last_residual)``: iterate
    until the L2 residual of one update drops to ``tol`` or below.

    With ``cfg.run.residual_every = K > 1`` each round advances K-1 updates
    through the fixed-step loop (supersteps included), then one residual
    step, so the host reads the residual every K updates; the run never
    passes ``max_steps`` and ``steps_taken`` counts real updates. With
    K <= 1 every update is a residual step."""
    taps = _solver_taps(cfg) if taps is None else taps
    pp = pingpong or PingPong()
    step_r = make_step_fn(cfg, taps, with_residual=True)
    every = max(1, cfg.run.residual_every or 1)
    multistep = make_multistep_fn(cfg, taps, pp) if every > 1 else None

    def run(u: torch.Tensor, max_steps: int, tol: float):
        # float32 threshold and residual, as the JAX package compares them
        tol2 = float(np.float32(tol) * np.float32(tol))
        i = 0
        r2 = math.inf
        while i < max_steps and r2 > tol2:
            n = 0
            if multistep is not None:
                n = min(every - 1, max_steps - 1 - i)
                u = multistep(u, n)
            spare = pp.spare_for(u)
            u_new, r2_t = step_r(u, out=spare)
            pp.keep(u)
            u = u_new
            r2 = float(r2_t)
            i += n + 1
        return u, i, float(np.sqrt(np.float32(r2)))

    return run
