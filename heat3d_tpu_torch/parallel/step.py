"""The stencil step, superstep, fixed-step loop and convergence loop over a
mesh of shards.

Port of ``heat3d_tpu.parallel.step``. A field is a list of shard tensors in
rank order (``parallel.topology.ShardMesh``); one shard is the whole field
on a (1,1,1) mesh. Routes, in the JAX dispatch order:

- one update (``make_step_fn``), :func:`step_route`:
  ``direct``: the BC-fused direct kernel (``apply_taps_direct``) on a
  (1,1,1) mesh; ``faces-direct``: on a larger mesh, the faces-only
  exchange (``exchange_halo_faces``), the direct kernel over each unpadded
  shard, and the shard-boundary shells of sharded axes recomputed from the
  exchanged faces (``_local_step_direct_faces``); else ``exchange``: a
  width-1 halo exchange (``parallel.plan``, transport ``cfg.halo``) and the
  padded-block compute of the backend (the stream kernel, or the
  plain/conv arm), with storage padding re-pinned on uneven grids;
- a superstep of k = ``time_blocking`` updates (``make_superstep_fn``),
  :func:`superstep_route`: ``direct2`` / ``faces-direct2`` at k=2 under the
  direct rule; else ``streamk`` at k in {2, 3, 4} with the kernel backend
  on unpadded shards (one width-k exchange and the fused streamk kernel,
  pinning ring cells only beyond the domain faces a shard touches); else
  ``stepk`` (``_local_stepk``: one width-k exchange and k padded-block
  computes with the out-of-domain ring cells pinned between them).

The direct routes need ``halo='ppermute'``, no ``HEAT3D_NO_DIRECT``, the
kernel backend and an even decomposition (the JAX ``_direct_kernel_fn``
and ``_kernel_env_gate``); ``halo='dma'`` always takes the exchange path.

The JAX package's ``fori_loop``/``while_loop`` become Python loops that
launch one kernel per update (or superstep) on each shard; its ping-pong
pair carry becomes two buffers per shard that the kernels write into
alternately, and the exchange plans keep their padded blocks, so a loop
allocates nothing per step on the kernel routes. The residual's ``psum`` is
a float32 sum of the shards' partial sums in shard order.

Every function takes and returns torch tensors on the shards' devices,
and launches each shard's work on that shard's stream (``mesh.on``); the
solver ties those streams to the caller's (``ShardMesh.fork``/``join``).
"""

from __future__ import annotations

import logging
import math
import os
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from heat3d_tpu_torch import eqn
from heat3d_tpu_torch.core.config import BoundaryCondition, SolverConfig
from heat3d_tpu_torch.ops.stencil_direct import (
    apply_taps_direct,
    apply_taps_direct2,
)
from heat3d_tpu_torch.ops.stencil_eager import (
    apply_taps_padded,
    pin_outside,
    residual_sumsq,
)
from heat3d_tpu_torch.ops.stencil_stream import STREAMK_DEPTHS, apply_taps_streamk
from heat3d_tpu_torch.parallel.plan import Exchanges

Fields = List[torch.Tensor]
# (us, outs=None) -> the shards after the update(s); outs, when given, are
# preallocated buffers, one per shard
StepFn = Callable[..., Fields]
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


def _storage_dtype(cfg: SolverConfig) -> torch.dtype:
    return getattr(torch, cfg.precision.storage)


def _periodic(cfg: SolverConfig) -> bool:
    return cfg.stencil.bc is BoundaryCondition.PERIODIC


def _single(cfg: SolverConfig) -> bool:
    return cfg.mesh.shape == (1, 1, 1)


def make_exchanges(cfg: SolverConfig, mesh) -> Exchanges:
    """The exchange plans of one solver (transport ``cfg.halo``)."""
    return Exchanges(mesh, cfg.stencil.bc, cfg.halo)


def _per_shard(mesh, fn, *lists) -> list:
    """``fn(shard, *items)`` for every shard, on the shard's stream."""
    res = []
    for i, s in enumerate(mesh.shards):
        with mesh.on(s):
            res.append(fn(s, *(items[i] for items in lists)))
    return res


def _outs(mesh, outs):
    return [None] * len(mesh) if outs is None else outs


# ---- pins ------------------------------------------------------------------


def _pin_padding(u: torch.Tensor, cfg: SolverConfig, shard, bc_value=None) -> torch.Tensor:
    """For uneven decompositions, re-pin the shard's storage-padding cells
    (global index >= grid extent) to bc_value after an update, in place:
    real cells next to the true boundary then read bc_value from their
    padded neighbours, exactly the Dirichlet ghost, and padded cells add
    nothing to the residual."""
    if not cfg.is_padded:
        return u
    if bc_value is None:
        bc_value = cfg.stencil.bc_value
    for axis, (g, n, o) in enumerate(zip(cfg.grid.shape, cfg.local_shape, shard.origin)):
        start = max(0, g - o)
        if g != cfg.padded_shape[axis] and start < n:
            idx = [slice(None)] * 3
            idx[axis] = slice(start, None)
            u[tuple(idx)] = bc_value
    return u


def _pin_outside_domain(
    arr: torch.Tensor, cfg: SolverConfig, local_indices, bc_value=None,
    origin=(0, 0, 0),
) -> torch.Tensor:
    """Pin cells of ``arr`` whose GLOBAL index lies outside the domain to
    bc_value (Dirichlet; periodic has no out-of-domain cells, wrap ghosts
    are genuine). ``local_indices[a]`` gives each dim's local indices; local
    index i is global index ``origin[a] + i`` (the shard's origin)."""
    if _periodic(cfg):
        return arr
    if bc_value is None:
        bc_value = cfg.stencil.bc_value
    global_indices = [o + i for o, i in zip(origin, local_indices)]
    return pin_outside(arr, global_indices, cfg.grid.shape, bc_value)


def _fill_mid_ghosts(
    mid: torch.Tensor, cfg: SolverConfig, rings: int = 1, bc_value=None,
    origin=(0, 0, 0),
) -> torch.Tensor:
    """Between the applications of a temporally-blocked superstep, pin the
    cells of the ring-carrying intermediate that are not true interior
    cells (domain ghosts and uneven-decomposition padding) back to
    bc_value, exactly as the unfused sequence sees them. ``mid`` carries
    ``rings`` ghost rings: local index i maps to global index
    ``origin + i - rings``."""
    idx = [torch.arange(-rings, n + rings, device=mid.device) for n in cfg.local_shape]
    return _pin_outside_domain(mid, cfg, idx, bc_value=bc_value, origin=origin)


# ---- local updates ---------------------------------------------------------


def _local_step(
    up: torch.Tensor, taps: np.ndarray, cfg: SolverConfig,
    compute_padded: LocalCompute, shard, out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """One update on the exchange path from the shard's width-1 padded
    block."""
    return _pin_padding(compute_padded(up, taps, out=out), cfg, shard)


def _local_stepk(
    upk: torch.Tensor, taps: np.ndarray, cfg: SolverConfig,
    compute_padded: LocalCompute, shard, out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """One temporally-blocked superstep from the shard's width-k padded
    block, k = ``cfg.time_blocking``: apply the stencil k times;
    application j consumes the ring application j-1 produced, pinned."""
    k = cfg.time_blocking
    cur = upk
    for j in range(k):
        rings = k - 1 - j  # ghost rings still carried by the result
        cur = compute_padded(cur, taps, out=out if rings == 0 else None)
        if rings > 0:
            cur = _fill_mid_ghosts(cur, cfg, rings, origin=shard.origin)
    return _pin_padding(cur, cfg, shard)


def _padded_slab(u: torch.Tensor, faces, axis: int, start: int, w: int = 1,
                 thickness: Optional[int] = None) -> torch.Tensor:
    """``thickness``-thick slice [start, start+thickness) along ``axis`` of
    the VIRTUAL width-``w`` ghost-padded shard (padded coordinates), fully
    w-padded in the other two axes, reassembled from the shard and its six
    exchanged faces without the padded volume ever existing. Default
    thickness 2w+1 (one output plane's dependence)."""
    thickness = thickness if thickness is not None else 2 * w + 1
    xlo, xhi, ylo, yhi, zlo, zhi = faces
    nx, ny, nz = u.shape
    s = slice(start, start + thickness)
    rng = range(start, start + thickness)
    if axis == 0:
        parts = []
        for p in rng:
            if p < w:
                parts.append(xlo[p : p + 1])
            elif p >= nx + w:
                parts.append(xhi[p - nx - w : p - nx - w + 1])
            else:
                parts.append(u[p - w : p - w + 1])
        core = torch.cat(parts, 0)  # (thickness, ny, nz)
        core = torch.cat([ylo[s], core, yhi[s]], 1)
        return torch.cat([zlo[s], core, zhi[s]], 2)
    if axis == 1:

        def xrow(p):  # x-extended row at padded y coord p: (nx+2w, 1, nz)
            if p < w:
                return ylo[:, p : p + 1]
            if p >= ny + w:
                return yhi[:, p - ny - w : p - ny - w + 1]
            q = p - w
            return torch.cat([xlo[:, q : q + 1], u[:, q : q + 1], xhi[:, q : q + 1]], 0)

        core = torch.cat([xrow(p) for p in rng], 1)
        return torch.cat([zlo[:, s], core, zhi[:, s]], 2)

    def xycol(p):  # x+y-extended column at padded z coord p: (nx+2w, ny+2w, 1)
        if p < w:
            return zlo[:, :, p : p + 1]
        if p >= nz + w:
            return zhi[:, :, p - nz - w : p - nz - w + 1]
        q = p - w
        mid = torch.cat([xlo[:, :, q : q + 1], u[:, :, q : q + 1], xhi[:, :, q : q + 1]], 0)
        return torch.cat([ylo[:, :, q : q + 1], mid, yhi[:, :, q : q + 1]], 1)

    return torch.cat([xycol(p) for p in rng], 2)


def _planes(axis: int, start: int, stop: int):
    idx = [slice(None)] * 3
    idx[axis] = slice(start, stop)
    return tuple(idx)


def _patch_boundary_shells(out, u, faces, taps, cfg: SolverConfig):
    """Recompute the 1-deep shard-boundary shells of the sharded axes (where
    the direct kernel's local ghost synthesis is wrong) from virtual padded
    slabs over the exchanged ``faces``, and patch them into ``out``. Axes
    of mesh size 1 are skipped: the kernel's local BC/wrap is exact there.
    The shells use the plain chain: the JAX package computes them outside
    any kernel too, and on the card it equals the kernel bitwise."""
    for axis in range(3):
        if cfg.mesh.shape[axis] == 1:
            continue
        n = u.shape[axis]
        for start in (0, n - 1):
            shell = apply_taps_padded(_padded_slab(u, faces, axis, start), taps)
            out[_planes(axis, start, start + 1)] = shell
    return out


def _local_step_direct_faces(u, faces, taps, cfg: SolverConfig, shard, out=None):
    """Faces-direct update of one shard: the BC-fused direct kernel over the
    unpadded shard (its in-kernel domain ghosts are exact on axes of mesh
    size 1, wrong only in the outermost shell of sharded axes), then those
    shells patched from the exchanged faces."""
    out = apply_taps_direct(u, taps, _periodic(cfg), cfg.stencil.bc_value, out=out)
    return _patch_boundary_shells(out, u, faces, taps, cfg)


def _pin_slab_mid(mid, cfg: SolverConfig, axis: int, start: int, origin):
    """Dirichlet ghost pinning for a slab-shaped superstep intermediate, the
    slab analogue of _fill_mid_ghosts: ``mid`` carries one ghost ring;
    along ``axis`` its plane q maps to local index start + q - 1 (``start``
    in width-2 padded coordinates), on the other axes index r to r - 1."""
    idx = [
        start - 1 + torch.arange(mid.shape[a], device=mid.device)
        if a == axis
        else torch.arange(mid.shape[a], device=mid.device) - 1
        for a in range(3)
    ]
    return _pin_outside_domain(mid, cfg, idx, origin=origin)


def _local_superstep_direct_faces(u, faces, taps, cfg: SolverConfig, shard, out=None):
    """Faces-direct two-update superstep of one shard: the fused direct2
    kernel over the unpadded shard, then the outermost TWO planes per side
    of each sharded axis recomputed from 6-thick virtual width-2 padded
    slabs (apply, pin the intermediate's domain ghosts, apply) and patched
    in."""
    out = apply_taps_direct2(u, taps, _periodic(cfg), cfg.stencil.bc_value, out=out)
    for axis, size in enumerate(cfg.mesh.shape):
        if size == 1:
            continue
        n = u.shape[axis]
        for start in (0, n - 2):  # width-2 padded coords; final planes
            slab = _padded_slab(u, faces, axis, start, w=2, thickness=6)
            mid = _pin_slab_mid(apply_taps_padded(slab, taps), cfg, axis, start,
                                shard.origin)
            out[_planes(axis, start, start + 2)] = apply_taps_padded(mid, taps)
    return out


# ---- routes ----------------------------------------------------------------


def _kernel_backend(cfg: SolverConfig) -> bool:
    return cfg.backend in ("auto", "pallas")


def _direct_ok(cfg: SolverConfig) -> bool:
    """The JAX ``_direct_kernel_fn`` gate: the kernel backend, no
    ``HEAT3D_NO_DIRECT``, the ppermute transport, an even decomposition."""
    return (
        _kernel_backend(cfg)
        and not os.environ.get("HEAT3D_NO_DIRECT")
        and cfg.halo == "ppermute"
        and not cfg.is_padded
    )


def step_route(cfg: SolverConfig) -> str:
    """The route of one update: ``direct`` (the direct kernel, (1,1,1)
    mesh), ``faces-direct`` (the same on a larger mesh, with faces and
    shells) under the direct gate; else ``exchange``."""
    if _direct_ok(cfg):
        return "direct" if _single(cfg) else "faces-direct"
    return "exchange"


def superstep_route(cfg: SolverConfig) -> str:
    """The route of one k-update superstep (k = time_blocking >= 2):
    ``direct2``/``faces-direct2`` at k=2 under the direct gate; else
    ``streamk`` at k in {2, 3, 4} with the kernel backend on an even
    decomposition (JAX ``_fused_streamk_fn``); else ``stepk``
    (``_local_stepk`` with the backend's padded compute, so k >= 5 runs the
    stream kernel k times with pins between)."""
    k = cfg.time_blocking
    if k == 2 and _direct_ok(cfg):
        return "direct2" if _single(cfg) else "faces-direct2"
    if k in STREAMK_DEPTHS and _kernel_backend(cfg) and not cfg.is_padded:
        return "streamk"
    return "stepk"


def superstep_cell_updates(cfg: SolverConfig) -> tuple:
    """(raw, effective) cell updates ONE superstep executes on one shard:
    ``effective`` is the k useful sweeps over the block; ``raw`` is the
    recompute trapezoid every superstep implementation pays (application j
    of k updates the (n + 2r)-extent slab still carrying r = k-1-j ghost
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


def _exchange_label(cfg: SolverConfig, width: int) -> str:
    if _single(cfg):
        return f"width-{width} exchange"
    return f"width-{width} {cfg.halo} exchange over mesh {cfg.mesh.shape}"


def _sum_partials(mesh, parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """The float32 sum of per-shard partial sums, in shard order, on the
    first shard's device (the JAX residual's ``psum``)."""
    if len(parts) == 1:
        return parts[0]
    mesh.join()
    dev = parts[0].device
    total = None
    for p in parts:
        if p.device.type == "cuda":
            # made on a shard stream, read on the current one
            p.record_stream(torch.cuda.current_stream(p.device))
        p = p.to(dev)
        total = p if total is None else total + p
    return total


def _with_residual(cfg, mesh, step: StepFn) -> StepFn:
    res_dtype = _residual_dtype(cfg)

    def step_r(us: Fields, outs: Optional[Fields] = None):
        new = step(us, outs)
        parts = _per_shard(mesh, lambda s, a, b: residual_sumsq(a, b, res_dtype),
                           new, us)
        return new, _sum_partials(mesh, parts)

    return step_r


def make_step_fn(
    cfg: SolverConfig,
    mesh,
    taps: Optional[np.ndarray] = None,
    with_residual: bool = False,
    compute_padded: Optional[LocalCompute] = None,
    exchanges: Optional[Exchanges] = None,
) -> StepFn:
    """``(us, outs=None) -> us_new`` (or ``-> (us_new, residual_sumsq)``):
    one update of every shard of ``mesh`` on :func:`step_route`'s route.
    ``taps`` default to the config's (``eqn.solver_taps``);
    ``compute_padded`` to the config's backend."""
    taps = _solver_taps(cfg) if taps is None else taps
    periodic = _periodic(cfg)
    bc_value = cfg.stencil.bc_value
    dtype = _storage_dtype(cfg)
    ex = exchanges or make_exchanges(cfg, mesh)
    route = step_route(cfg)

    if route == "direct":
        _log_step_path_once("step path: single-shard direct kernel (no padded copy)")

        def step(us: Fields, outs: Optional[Fields] = None):
            return _per_shard(
                mesh, lambda s, u, out: apply_taps_direct(u, taps, periodic, bc_value, out=out),
                us, _outs(mesh, outs))

    elif route == "faces-direct":
        _log_step_path_once(
            f"step path: faces-direct direct kernel + shell patches (mesh "
            f"{cfg.mesh.shape}, faces-only exchange, no padded copy)"
        )

        def step(us: Fields, outs: Optional[Fields] = None):
            faces = ex.faces(1, dtype).apply(us, bc_value)
            return _per_shard(
                mesh, lambda s, u, f, out: _local_step_direct_faces(u, f, taps, cfg, s, out),
                us, faces, _outs(mesh, outs))

    else:
        compute = _compute_for(cfg, compute_padded)
        _log_step_path_once(
            f"step path: {_exchange_label(cfg, 1)} + {_backend_label(cfg)} "
            "(padded copy)"
        )

        def step(us: Fields, outs: Optional[Fields] = None):
            pads = ex.plan(1, dtype).apply(us, bc_value)
            return _per_shard(
                mesh, lambda s, up, out: _local_step(up, taps, cfg, compute, s, out),
                pads, _outs(mesh, outs))

    return _with_residual(cfg, mesh, step) if with_residual else step


def make_superstep_fn(
    cfg: SolverConfig,
    mesh,
    taps: Optional[np.ndarray] = None,
    compute_padded: Optional[LocalCompute] = None,
    exchanges: Optional[Exchanges] = None,
) -> StepFn:
    """``(us, outs=None) -> us_after_k_updates``, k = ``cfg.time_blocking``
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
    dtype = _storage_dtype(cfg)
    ex = exchanges or make_exchanges(cfg, mesh)
    route = superstep_route(cfg)

    if route == "direct2":
        _log_step_path_once("superstep path: single-shard fused direct2 kernel")

        def superstep(us: Fields, outs: Optional[Fields] = None):
            return _per_shard(
                mesh, lambda s, u, out: apply_taps_direct2(u, taps, periodic, bc_value, out=out),
                us, _outs(mesh, outs))

    elif route == "faces-direct2":
        _log_step_path_once(
            f"superstep path: faces-direct fused direct2 kernel + 2-deep shell "
            f"patches (mesh {cfg.mesh.shape}, no padded copy)"
        )

        def superstep(us: Fields, outs: Optional[Fields] = None):
            faces = ex.faces(2, dtype).apply(us, bc_value)
            return _per_shard(
                mesh,
                lambda s, u, f, out: _local_superstep_direct_faces(u, f, taps, cfg, s, out),
                us, faces, _outs(mesh, outs))

    elif route == "streamk":
        _log_step_path_once(
            f"superstep path: {_exchange_label(cfg, k)} + fused {k}-sweep "
            "streamk kernel (shrinking-ring recompute)"
        )

        def superstep(us: Fields, outs: Optional[Fields] = None):
            pads = ex.plan(k, dtype).apply(us, bc_value)
            return _per_shard(
                mesh,
                lambda s, upk, out: apply_taps_streamk(
                    upk, taps, k, periodic, bc_value, out=out, edges=s.edges),
                pads, _outs(mesh, outs))

    else:
        compute = _compute_for(cfg, compute_padded)
        _log_step_path_once(
            f"superstep path: {_exchange_label(cfg, k)} + {k} x "
            f"{_backend_label(cfg)} with ring pins between"
        )

        def superstep(us: Fields, outs: Optional[Fields] = None):
            pads = ex.plan(k, dtype).apply(us, bc_value)
            return _per_shard(
                mesh, lambda s, upk, out: _local_stepk(upk, taps, cfg, compute, s, out),
                pads, _outs(mesh, outs))

    return superstep


class PingPong:
    """Apply a step function ``count`` times between two buffers per shard.

    The spare buffers are allocated once (on the caller's current stream)
    and kept: after each run the buffers not holding the result become the
    next spares. The input tensors are consumed (they may be overwritten),
    as the JAX package donates them."""

    def __init__(self):
        self._spare: Optional[Fields] = None

    def spare_for(self, us: Fields) -> Fields:
        spare = self._spare
        self._spare = None
        if spare is None or len(spare) != len(us):
            spare = [None] * len(us)
        out = []
        for s, u in zip(spare, us):
            if (
                s is None
                or s.shape != u.shape
                or s.dtype != u.dtype
                or s.device != u.device
                or s.data_ptr() == u.data_ptr()
            ):
                s = torch.empty_like(u)
            out.append(s)
        return out

    def keep(self, ts: Fields) -> None:
        self._spare = list(ts)

    def run(self, step_fn: StepFn, us: Fields, count: int) -> Fields:
        if count <= 0:
            return us
        a, b = list(us), self.spare_for(us)
        for _ in range(count):
            b = step_fn(a, b)
            a, b = b, a
        self.keep(b)
        return a


def make_multistep_fn(
    cfg: SolverConfig,
    mesh,
    taps: Optional[np.ndarray] = None,
    pingpong: Optional[PingPong] = None,
    compute_padded: Optional[LocalCompute] = None,
    exchanges: Optional[Exchanges] = None,
) -> Callable[[Fields, int], Fields]:
    """``(us, num_steps) -> us_after``. With ``time_blocking = k > 1`` the
    loop advances in ``num_steps // k`` supersteps, then ``num_steps % k``
    single steps through the step function; both loops ping-pong between
    the same two buffers per shard."""
    taps = _solver_taps(cfg) if taps is None else taps
    pp = pingpong or PingPong()
    ex = exchanges or make_exchanges(cfg, mesh)
    step = make_step_fn(cfg, mesh, taps, compute_padded=compute_padded, exchanges=ex)
    k = cfg.time_blocking

    if k > 1:
        superstep = make_superstep_fn(cfg, mesh, taps, compute_padded, ex)

        def runk(us: Fields, num_steps: int) -> Fields:
            us = pp.run(superstep, us, num_steps // k)
            return pp.run(step, us, num_steps % k)

        return runk

    def run(us: Fields, num_steps: int) -> Fields:
        return pp.run(step, us, num_steps)

    return run


def make_converge_fn(
    cfg: SolverConfig,
    mesh,
    taps: Optional[np.ndarray] = None,
    pingpong: Optional[PingPong] = None,
    compute_padded: Optional[LocalCompute] = None,
    exchanges: Optional[Exchanges] = None,
) -> Callable[[Fields, int, float], Tuple[Fields, int, float]]:
    """``(us, max_steps, tol) -> (us, steps_taken, last_residual)``: iterate
    until the L2 residual of one update drops to ``tol`` or below.

    With ``cfg.run.residual_every = K > 1`` each round advances K-1 updates
    through the fixed-step loop (supersteps included), then one residual
    step, so the host reads the residual every K updates; the run never
    passes ``max_steps`` and ``steps_taken`` counts real updates. With
    K <= 1 every update is a residual step."""
    taps = _solver_taps(cfg) if taps is None else taps
    pp = pingpong or PingPong()
    ex = exchanges or make_exchanges(cfg, mesh)
    step_r = make_step_fn(cfg, mesh, taps, True, compute_padded, ex)
    every = max(1, cfg.run.residual_every or 1)
    multistep = (
        make_multistep_fn(cfg, mesh, taps, pp, compute_padded, ex) if every > 1 else None
    )

    def run(us: Fields, max_steps: int, tol: float):
        # float32 threshold and residual, as the JAX package compares them
        tol2 = float(np.float32(tol) * np.float32(tol))
        i = 0
        r2 = math.inf
        while i < max_steps and r2 > tol2:
            n = 0
            if multistep is not None:
                n = min(every - 1, max_steps - 1 - i)
                us = multistep(us, n)
            spare = pp.spare_for(us)
            us_new, r2_t = step_r(us, spare)
            pp.keep(us)
            us = us_new
            r2 = float(r2_t)
            i += n + 1
        return us, i, float(np.sqrt(np.float32(r2)))

    return run
