"""The single-device stencil step, superstep, fixed-step loop and
convergence loop.

Port of the (1,1,1)-mesh routes of ``heat3d_tpu.parallel.step``, dispatched
in the JAX order:

- one update (``make_step_fn``): the BC-fused direct kernel
  (``apply_taps_direct``), unless ``HEAT3D_NO_DIRECT`` is set or the backend
  is ``jnp``/``conv``; then the exchange path: a width-1 halo exchange
  (``parallel.halo``) and the padded-block compute of the backend (the
  stream kernel, or the plain/conv arm);
- a superstep of k = ``time_blocking`` updates (``make_superstep_fn``): at
  k=2 the fused direct2 kernel under the same rule; else, at k in {2, 3, 4}
  with the kernel backend, one width-k exchange and the fused streamk
  kernel; else ``_local_stepk``: one width-k exchange and k padded-block
  computes with the out-of-domain ring cells pinned between them.

The JAX package's ``fori_loop``/``while_loop`` become Python loops that
launch one kernel per update (or superstep); its ping-pong pair carry
becomes two preallocated buffers the kernels write into alternately, and
the exchange path writes its padded block into a buffer kept per width, so
a loop allocates nothing per step on the kernel routes.

Every function takes and returns torch tensors on the solver's device.
"""

from __future__ import annotations

import logging
import math
import os
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from heat3d_tpu_torch import eqn
from heat3d_tpu_torch.core.config import BoundaryCondition, SolverConfig
from heat3d_tpu_torch.ops.stencil_direct import (
    apply_taps_direct,
    apply_taps_direct2,
)
from heat3d_tpu_torch.ops.stencil_eager import pin_outside, residual_sumsq
from heat3d_tpu_torch.ops.stencil_stream import STREAMK_DEPTHS, apply_taps_streamk
from heat3d_tpu_torch.parallel.halo import exchange_halo, padded_shape

# (u, out=None) -> u_new; out, when given, is a preallocated buffer
StepFn = Callable[..., torch.Tensor]
# (up, taps, out=None) -> the interior update of a ghost-padded block
LocalCompute = Callable[..., torch.Tensor]

_logged_paths: set = set()


def _log_step_path_once(msg: str) -> None:
    """INFO-log a route selection once per process (the step functions are
    built several times per solver)."""
    if msg not in _logged_paths:
        _logged_paths.add(msg)
        logging.getLogger(__name__).info("%s", msg)


def _solver_taps(cfg: SolverConfig) -> np.ndarray:
    return eqn.solver_taps(cfg)


def _residual_dtype(cfg: SolverConfig) -> torch.dtype:
    return getattr(torch, cfg.precision.residual)


def _periodic(cfg: SolverConfig) -> bool:
    return cfg.stencil.bc is BoundaryCondition.PERIODIC


class PadBuffers:
    """The exchange path's padded blocks, one per halo width, allocated on
    first use and reused by every later step (and shared by the step
    functions of one solver)."""

    def __init__(self):
        self._bufs: Dict[int, torch.Tensor] = {}

    def get(self, u: torch.Tensor, width: int) -> torch.Tensor:
        want = padded_shape(u.shape, width)
        b = self._bufs.get(width)
        if b is None or tuple(b.shape) != want or b.dtype != u.dtype or b.device != u.device:
            b = self._bufs[width] = torch.empty(want, dtype=u.dtype, device=u.device)
        return b


def exchange(
    u_local: torch.Tensor, cfg: SolverConfig, width: int = 1,
    out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Ghost exchange of the config's boundary condition at ``width``."""
    return exchange_halo(u_local, cfg.stencil.bc, cfg.stencil.bc_value, width, out=out)


def _pin_outside_domain(
    arr: torch.Tensor, cfg: SolverConfig, local_indices, bc_value=None
) -> torch.Tensor:
    """Pin cells of ``arr`` whose GLOBAL index lies outside the domain to
    bc_value (Dirichlet; periodic has no out-of-domain cells, wrap ghosts
    are genuine). ``local_indices[a]`` gives each dim's local indices; on
    the one device of a (1,1,1) mesh local index i is global index i."""
    if _periodic(cfg):
        return arr
    if bc_value is None:
        bc_value = cfg.stencil.bc_value
    return pin_outside(arr, local_indices, cfg.grid.shape, bc_value)


def _fill_mid_ghosts(
    mid: torch.Tensor, cfg: SolverConfig, rings: int = 1, bc_value=None
) -> torch.Tensor:
    """Between the applications of a temporally-blocked superstep, pin the
    cells of the ring-carrying intermediate that are not true interior
    cells back to bc_value, exactly as the unfused sequence sees them.
    ``mid`` carries ``rings`` ghost rings: local index i maps to global
    index i - rings."""
    idx = [torch.arange(-rings, n + rings, device=mid.device) for n in cfg.local_shape]
    return _pin_outside_domain(mid, cfg, idx, bc_value=bc_value)


def _local_step(
    u_local: torch.Tensor,
    taps: np.ndarray,
    cfg: SolverConfig,
    compute_padded: LocalCompute,
    pad: Optional[torch.Tensor] = None,
    out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """One update on the exchange path: width-1 exchange, padded compute."""
    up = exchange(u_local, cfg, out=pad)
    return compute_padded(up, taps, out=out)


def _local_stepk(
    u_local: torch.Tensor,
    taps: np.ndarray,
    cfg: SolverConfig,
    compute_padded: LocalCompute,
    pad: Optional[torch.Tensor] = None,
    out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """One temporally-blocked superstep: ``k = cfg.time_blocking`` updates
    per ghost exchange (exchange width-k ghosts, apply the stencil k times;
    application j consumes the ring application j-1 produced)."""
    k = cfg.time_blocking
    cur = exchange(u_local, cfg, width=k, out=pad)
    for j in range(k):
        rings = k - 1 - j  # ghost rings still carried by the result
        cur = compute_padded(cur, taps, out=out if rings == 0 else None)
        if rings > 0:
            cur = _fill_mid_ghosts(cur, cfg, rings)
    return cur


def _kernel_backend(cfg: SolverConfig) -> bool:
    return cfg.backend in ("auto", "pallas")


def step_route(cfg: SolverConfig) -> str:
    """The route of one update: ``direct`` (the BC-fused direct kernel,
    JAX ``_direct_kernel_fn`` on a (1,1,1) mesh) unless
    ``HEAT3D_NO_DIRECT`` is set or the backend is jnp/conv; else
    ``exchange`` (width-1 exchange + the backend's padded compute)."""
    if _kernel_backend(cfg) and not os.environ.get("HEAT3D_NO_DIRECT"):
        return "direct"
    return "exchange"


def superstep_route(cfg: SolverConfig) -> str:
    """The route of one k-update superstep (k = time_blocking >= 2):
    ``direct2`` at k=2 under :func:`step_route`'s rule; else ``streamk``
    at k in {2, 3, 4} with the kernel backend (JAX ``_fused_streamk_fn``);
    else ``stepk`` (``_local_stepk`` with the backend's padded compute, so
    k >= 5 runs the stream kernel k times with pins between)."""
    k = cfg.time_blocking
    if k == 2 and step_route(cfg) == "direct":
        return "direct2"
    if k in STREAMK_DEPTHS and _kernel_backend(cfg):
        return "streamk"
    return "stepk"


def superstep_cell_updates(cfg: SolverConfig) -> tuple:
    """(raw, effective) cell updates ONE superstep executes: ``effective``
    is the k useful sweeps over the block; ``raw`` is the recompute
    trapezoid every superstep implementation pays (application j of k
    updates the (n + 2r)-extent slab still carrying r = k-1-j ghost
    rings). At k <= 1 raw == effective."""
    k = max(1, cfg.time_blocking)
    nx, ny, nz = cfg.local_shape
    effective = k * nx * ny * nz
    raw = sum((nx + 2 * r) * (ny + 2 * r) * (nz + 2 * r) for r in range(k))
    return raw, effective


def redundant_flops_frac(cfg: SolverConfig) -> float:
    """Fraction of a superstep's executed stencil FLOPs that are redundant
    ghost-ring recompute (0.0 at time_blocking <= 1): the
    ``cost_redundant_flops_frac`` bench-row field."""
    raw, effective = superstep_cell_updates(cfg)
    return 0.0 if raw <= effective else 1.0 - effective / raw


def _compute_for(cfg: SolverConfig, compute_padded: Optional[LocalCompute]):
    """``compute_padded``, or the config's backend (``models.heat3d``)."""
    if compute_padded is not None:
        return compute_padded
    from heat3d_tpu_torch.models.heat3d import _select_backend

    return _select_backend(cfg)


def _backend_label(cfg: SolverConfig) -> str:
    from heat3d_tpu_torch.models.heat3d import resolved_backend_name

    name = resolved_backend_name(cfg)
    return "stream kernel" if name == "pallas" else f"{name} arm"


def make_step_fn(
    cfg: SolverConfig,
    taps: Optional[np.ndarray] = None,
    with_residual: bool = False,
    compute_padded: Optional[LocalCompute] = None,
    pads: Optional[PadBuffers] = None,
) -> StepFn:
    """``(u, out=None) -> u_new`` (or ``-> (u_new, residual_sumsq)``): one
    update on :func:`step_route`'s route. ``taps`` default to the config's
    (``eqn.solver_taps``); ``compute_padded`` to the config's backend."""
    taps = _solver_taps(cfg) if taps is None else taps
    periodic = _periodic(cfg)
    bc_value = cfg.stencil.bc_value

    if step_route(cfg) == "direct":
        _log_step_path_once("step path: single-shard direct kernel (no padded copy)")

        def step(u: torch.Tensor, out: Optional[torch.Tensor] = None):
            return apply_taps_direct(u, taps, periodic, bc_value, out=out)

    else:
        compute = _compute_for(cfg, compute_padded)
        pads = pads or PadBuffers()
        _log_step_path_once(
            f"step path: width-1 exchange + {_backend_label(cfg)} (padded copy)"
        )

        def step(u: torch.Tensor, out: Optional[torch.Tensor] = None):
            return _local_step(u, taps, cfg, compute, pads.get(u, 1), out)

    if not with_residual:
        return step
    res_dtype = _residual_dtype(cfg)

    def step_r(u: torch.Tensor, out: Optional[torch.Tensor] = None):
        u_new = step(u, out)
        return u_new, residual_sumsq(u_new, u, res_dtype)

    return step_r


def make_superstep_fn(
    cfg: SolverConfig,
    taps: Optional[np.ndarray] = None,
    compute_padded: Optional[LocalCompute] = None,
    pads: Optional[PadBuffers] = None,
) -> StepFn:
    """``(u, out=None) -> u_after_k_updates``, k = ``cfg.time_blocking``
    >= 2, on :func:`superstep_route`'s route."""
    k = cfg.time_blocking
    if k < 2:
        raise ValueError(f"a superstep needs time_blocking >= 2, got {k}")
    # the same floor as the JAX package: k ghost layers must fit the block
    # and the shrinking-ring intermediates need a genuine interior
    min_extent = max(3, k)
    if min(cfg.local_shape) < min_extent:
        raise ValueError(
            f"time_blocking={k} needs local extents >= "
            f"{min_extent} (k ghost layers plus the shrinking recompute "
            f"rings), got {cfg.local_shape}"
        )
    taps = _solver_taps(cfg) if taps is None else taps
    periodic = _periodic(cfg)
    bc_value = cfg.stencil.bc_value
    route = superstep_route(cfg)
    pads = pads or PadBuffers()

    if route == "direct2":
        _log_step_path_once("superstep path: single-shard fused direct2 kernel")

        def superstep(u: torch.Tensor, out: Optional[torch.Tensor] = None):
            return apply_taps_direct2(u, taps, periodic, bc_value, out=out)

    elif route == "streamk":
        _log_step_path_once(
            f"superstep path: width-{k} exchange + fused {k}-sweep streamk "
            "kernel (shrinking-ring recompute)"
        )

        def superstep(u: torch.Tensor, out: Optional[torch.Tensor] = None):
            upk = exchange(u, cfg, width=k, out=pads.get(u, k))
            return apply_taps_streamk(upk, taps, k, periodic, bc_value, out=out)

    else:
        compute = _compute_for(cfg, compute_padded)
        _log_step_path_once(
            f"superstep path: width-{k} exchange + {k} x {_backend_label(cfg)} "
            "with ring pins between"
        )

        def superstep(u: torch.Tensor, out: Optional[torch.Tensor] = None):
            return _local_stepk(u, taps, cfg, compute, pads.get(u, k), out)

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
    compute_padded: Optional[LocalCompute] = None,
    pads: Optional[PadBuffers] = None,
) -> Callable[[torch.Tensor, int], torch.Tensor]:
    """``(u, num_steps) -> u_after``. With ``time_blocking = k > 1`` the
    loop advances in ``num_steps // k`` supersteps, then ``num_steps % k``
    single steps through the step function (the direct kernel on the
    default route); both loops ping-pong between the same two buffers."""
    taps = _solver_taps(cfg) if taps is None else taps
    pp = pingpong or PingPong()
    pads = pads or PadBuffers()
    step = make_step_fn(cfg, taps, compute_padded=compute_padded, pads=pads)
    k = cfg.time_blocking

    if k > 1:
        superstep = make_superstep_fn(cfg, taps, compute_padded, pads)

        def runk(u: torch.Tensor, num_steps: int) -> torch.Tensor:
            u = pp.run(superstep, u, num_steps // k)
            return pp.run(step, u, num_steps % k)

        return runk

    def run(u: torch.Tensor, num_steps: int) -> torch.Tensor:
        return pp.run(step, u, num_steps)

    return run


def make_converge_fn(
    cfg: SolverConfig,
    taps: Optional[np.ndarray] = None,
    pingpong: Optional[PingPong] = None,
    compute_padded: Optional[LocalCompute] = None,
    pads: Optional[PadBuffers] = None,
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
    pads = pads or PadBuffers()
    step_r = make_step_fn(cfg, taps, True, compute_padded, pads)
    every = max(1, cfg.run.residual_every or 1)
    multistep = (
        make_multistep_fn(cfg, taps, pp, compute_padded, pads) if every > 1 else None
    )

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
