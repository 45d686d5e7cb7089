"""Roofline attribution: what fraction of the hardware's peak did each
phase achieve?

Two complementary models, one module:

**Row model** (the analytic HBM traffic model + vector op-cost model of
the tap chain, applied to measured bench rows): exact for the step paths
this package emits.

**Analytic phase model**: the bytes each route's kernels and copies must
move and the operations of the tap chain, per PHASE program
(``parallel.step.phase_programs``: the programs are keyed by the same
``heat3d.*`` names the phase ranges and the profiler trace tables use, so
a cost record joins a measured phase on one key). The counts live here,
as functions of the config: :func:`kernel_bound`, :func:`superstep_bound`,
:func:`fused_bound`, :func:`sharded_superstep_bound` and
:func:`halo_exchange_bytes` are the one yardstick of every bound the
package reports (``chip_smoke.py`` imports them; ``PERF.md``'s bound
column reads them), and :func:`step_cost_fields` / :func:`halo_cost_fields`
put the same counts on the ledger's ``step_cost`` event and on every bench
row (``cost_flops_per_step`` / ``cost_bytes_per_step``). Combined with
per-backend peak specs (:data:`PEAK_SPECS`) this turns a measured phase
time into achieved-vs-peak fractions: the ``obs roofline`` live table,
the ``roofline`` section of ``obs summary``.

The byte counts are each input read once and each output written once
(the least a phase must move), not what the kernels measure; a fraction
near 100% of the memory rate is the bound reached. Peak specs:
``peak_spec('cuda')`` takes the card's published memory rate (by name,
:data:`BANDWIDTH`) and its published fp32 rate (:data:`FP32_FLOPS`); env
overrides ``HEAT3D_PEAK_MEM_GBPS`` / ``HEAT3D_PEAK_GFLOPS`` win. The rate
``obs roofline --calibrate`` measures (what the densest tap chain
achieves) is stored and shown beside the peaks, never divided by: the
stencils are memory-bound, so their achieved GFLOP/s sits far below the
card's rate, and a peak set to it would read a memory-bound phase as
compute-bound.

Failure posture: cost accounting is telemetry — every consumer treats a
raised :func:`step_cost_fields` as "fields unavailable", never as a run
failure.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Any, Dict, List, Optional, Tuple

# ---- per-backend peak specs -------------------------------------------------

# Device-memory bytes/s by card-name fragment (published, SXM H100 at 700 W
# unless the name says otherwise; first match wins) and the fp32 non-tensor
# FLOP/s of an H100 SXM: the rates every bound of the package is taken at.
BANDWIDTH = (("H200", 4.8e12), ("NVL", 3.9e12), ("PCIe", 2.0e12), ("H100", 3.35e12))
FP32_FLOPS = 67e12

# Peaks the achieved fractions divide by. mem_gbps = device memory (cuda) /
# host DRAM (cpu) stream rate; vector_gflops = the sustainable fp32
# non-tensor rate (the tap chains run on the CUDA cores, not the tensor
# cores). The cuda entry's memory rate comes from the card's name
# (:func:`card_bandwidth`); the CPU defaults are order-of-magnitude
# nominals for a single host process.
PEAK_SPECS: Dict[str, Dict[str, Optional[float]]] = {
    "cuda": {"mem_gbps": None, "vector_gflops": FP32_FLOPS / 1e9},
    "cpu": {"mem_gbps": 20.0, "vector_gflops": 50.0},
}
_FALLBACK_SPEC: Dict[str, Optional[float]] = {
    "mem_gbps": None,
    "vector_gflops": None,
}


def bandwidth(name: str) -> float:
    """The published device-memory rate (bytes/s) of the card ``name``
    (``torch.cuda.get_device_name``); raises for a card not on record."""
    for frag, bw in BANDWIDTH:
        if frag in name:
            return bw
    raise RuntimeError(f"no bandwidth on record for {name!r}")


def card_bandwidth() -> Optional[float]:
    """:func:`bandwidth` of the current card, or None (no card, or one not
    on record). Never raises and never touches CUDA on a CPU build."""
    try:
        import torch

        if torch.version.cuda is None or not torch.cuda.is_available():
            return None
        return bandwidth(torch.cuda.get_device_name(0))
    except Exception:  # noqa: BLE001 - telemetry fails soft
        return None


def current_platform() -> str:
    """``cuda`` when the build sees a card, else ``cpu`` (the platform a
    live table or a calibration in this process measures)."""
    try:
        import torch

        if torch.version.cuda is not None and torch.cuda.is_available():
            return "cuda"
    except ImportError:
        pass
    return "cpu"


def peak_spec(platform: str) -> Dict[str, Optional[float]]:
    """Peak spec for ``platform``; precedence per field: env override
    (``HEAT3D_PEAK_MEM_GBPS`` / ``HEAT3D_PEAK_GFLOPS``) > for ``cuda``, the
    card's published memory rate > the static defaults. A calibrated rate
    (:func:`calibrated_gflops`) never enters: it is what a kernel
    achieved, not what the card can do."""
    spec = dict(PEAK_SPECS.get(platform, _FALLBACK_SPEC))
    if platform == "cuda" and spec.get("mem_gbps") is None:
        bw = card_bandwidth()
        if bw is not None:
            spec["mem_gbps"] = bw / 1e9
    for env, key in (
        ("HEAT3D_PEAK_MEM_GBPS", "mem_gbps"),
        ("HEAT3D_PEAK_GFLOPS", "vector_gflops"),
    ):
        v = os.environ.get(env)
        if v:
            try:
                spec[key] = float(v)
            except ValueError:
                pass  # a bad override must not kill a report
    return spec


def calibrated_gflops(platform: str) -> Optional[float]:
    """The GFLOP/s ``obs roofline --calibrate`` stored for this process's
    card, or None: a diagnostic shown beside the peaks (what the densest
    tap chain achieves here). Looked up only when the CURRENT process runs
    ``platform`` (a CPU box summarizing card rows has no card's figure).
    Never raises."""
    try:
        if current_platform() != platform:
            return None
        from heat3d_tpu_torch.tune.cache import chip_generation, load_peak

        return load_peak(chip_generation())
    except Exception:  # noqa: BLE001 - telemetry fails soft
        return None


# ---- the analytic cost model ------------------------------------------------


def flops_per_update(taps, mehrstellen: bool = False) -> int:
    """fp32 operations per cell and update of the tap chain, with the plane
    and row sums counted once (as the plain version caches them): the
    package's ``chain_ops``, which the bench rows carry too."""
    from heat3d_tpu_torch.ops.stencil_direct import chain_ops

    return chain_ops(taps, mehrstellen=mehrstellen)


def trapezoid_cells(local, k: int) -> int:
    """Cells one k-update superstep of a block of shape ``local`` computes:
    update j of k covers the extent still carrying r = k-1-j ghost rings
    (the raw trapezoid of ``streamk_cost_estimate``)."""
    return sum((local[0] + 2 * r) * (local[1] + 2 * r) * (local[2] + 2 * r)
               for r in range(k))


def bound_ms(bytes_moved: float, ops: float, bw: float):
    """Least time on the card: the bytes at its memory rate or the
    operations at its fp32 rate, whichever is larger: (ms, "bytes" or
    "operations")."""
    t_bytes = bytes_moved / bw * 1e3
    t_ops = ops / FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_bound(name: str, n: int, k: int, itemsize: int, flops: int, bw: float):
    """Bound of one launch at n^3: the kernel's input read once and its
    output written once; the updates it computes (the raw trapezoid for
    streamk)."""
    if name in ("apply_taps_direct", "apply_taps_direct2"):
        return bound_ms(2 * n**3 * itemsize, n**3 * k * flops, bw)
    return bound_ms(((n + 2 * k) ** 3 + n**3) * itemsize,
                    trapezoid_cells((n, n, n), k) * flops, bw)


BOUND_PASSES = {
    "faces": "per shard: read u, write u_new (2 field passes), plus each "
             "ghost face cell read once from its neighbour and written once",
    "exchange": "per shard: read u, write the width-k padded block, read it, "
                "write u_new (4 passes), plus each ghost cell read once from "
                "its neighbour",
    "fused": "per shard: read u, write u_new (2 field passes), plus each x-face "
             "slab sent read once and written once into the neighbour's landing "
             "buffer",
}

DIRECT_ROUTES = ("direct", "direct2")
FACES_ROUTES = ("faces-direct", "faces-direct2", "fused-dma-3d")
FUSED_ROUTES = ("fused-dma", "fused-dma2", "fused-rdma", "fused-rdma2")


def x_sends(mesh, periodic: bool) -> int:
    """The x-face sends of one fused launch over ``mesh``: one each way
    between x neighbours (a Dirichlet x domain face sends nothing)."""
    px, py, pz = mesh
    return 2 * (px if periodic else px - 1) * py * pz


def superstep_bytes_ops(route: str, mesh, local, k: int, itemsize: int, flops: int,
                        periodic: bool = False) -> Tuple[int, int]:
    """(bytes, operations) one step (k = 1) or superstep of k updates of the
    solve must move and compute, over every shard of ``mesh`` with blocks
    of shape ``local``, on the route ``route`` (``parallel.step``
    ``step_route`` / ``superstep_route``). Bytes: each input read once and
    each output written once (:data:`BOUND_PASSES`): a direct sweep reads
    and writes the field; the exchange path also writes the width-k padded
    block and reads it (on a mesh, each ghost cell read once more from its
    neighbour); faces-direct adds each ghost face cell read and written; a
    fused launch each x-face slab sent. Operations: the k useful updates
    (direct, faces-direct, fused), or each shard's raw trapezoid (the
    exchange path)."""
    shards = mesh[0] * mesh[1] * mesh[2]
    cells = local[0] * local[1] * local[2]
    total = shards * cells
    if route in FUSED_ROUTES:
        moved = 2 * total + 2 * x_sends(mesh, periodic) * k * local[1] * local[2]
        return moved * itemsize, total * k * flops
    if route in DIRECT_ROUTES:
        return 2 * total * itemsize, total * k * flops
    if route in FACES_ROUTES:
        m = local
        faces = 2 * (k * m[1] * m[2] + (m[0] + 2 * k) * k * m[2]
                     + (m[0] + 2 * k) * (m[1] + 2 * k) * k)
        return shards * (2 * cells + 2 * faces) * itemsize, total * k * flops
    padded = (local[0] + 2 * k) * (local[1] + 2 * k) * (local[2] + 2 * k)
    if shards == 1:
        return 2 * (cells + padded) * itemsize, trapezoid_cells(local, k) * flops
    raw = cells if k == 1 else trapezoid_cells(local, k)
    return (shards * (2 * cells + 2 * padded + (padded - cells)) * itemsize,
            shards * raw * flops)


def superstep_bound(route: str, n: int, k: int, itemsize: int, flops: int, bw: float):
    """Bound of one superstep (or step) of the solve at n^3 on one shard:
    the direct kernels read and write the field once; the exchange path
    also writes the width-k padded copy and reads the field for it (four
    field passes)."""
    moved, ops = superstep_bytes_ops(route if route in DIRECT_ROUTES else "exchange",
                                     (1, 1, 1), (n, n, n), k, itemsize, flops)
    return bound_ms(moved, ops, bw)


def fused_bound(n: int, mesh, k: int, itemsize: int, flops: int, bw: float,
                periodic: bool = False):
    """Bound of one fused launch (the whole step or superstep of the x-slab
    fused routes) over an n^3 grid on ``mesh``: (ms, "bytes"/"operations",
    bytes); the operations are the k useful updates."""
    local = tuple(n // p for p in mesh)
    moved, ops = superstep_bytes_ops("fused-dma", mesh, local, k, itemsize, flops,
                                     periodic)
    t, by = bound_ms(moved, ops, bw)
    return t, by, moved


def sharded_superstep_bound(route: str, n: int, mesh, k: int, itemsize: int,
                            flops: int, bw: float):
    """Bound of one superstep (or step) of the sharded solve of an n^3 grid
    over ``mesh``: (ms, "bytes"/"operations", bytes) from the passes of
    :data:`BOUND_PASSES`; the operations are the k useful updates (the
    faces-direct and fused routes; the 3D fused route counts as
    faces-direct, whose bytes it moves) or each shard's raw trapezoid (the
    exchange path and the overlap split, as :func:`superstep_bound`)."""
    if route in FUSED_ROUTES:
        return fused_bound(n, mesh, k, itemsize, flops, bw)
    local = tuple(n // p for p in mesh)
    if not (route.startswith("faces") or route == "fused-dma-3d"):
        route = "exchange"
    moved, ops = superstep_bytes_ops(route, mesh, local, k, itemsize, flops)
    t, by = bound_ms(moved, ops, bw)
    return t, by, moved


def halo_exchange_bytes(mesh_shape, local, order: str, itemsize: int,
                        periodic: bool = False) -> int:
    """Bytes one width-1 padded-block exchange must move: every shard's
    field read and written into its block's interior; each ghost slab of a
    side with a neighbour (or a periodic self-wrap) read and written, of a
    Dirichlet domain face written; a slab spans the earlier axes' ghosts
    under axis order, the raw face under pairwise. The pairwise edge zones
    are written once a plan, not an exchange."""
    shards = mesh_shape[0] * mesh_shape[1] * mesh_shape[2]
    cells = local[0] * local[1] * local[2]
    total = 2 * cells * shards
    for axis in range(3):
        slab = 1
        for a, m in enumerate(local):
            slab *= 1 if a == axis else (m + 2 if a < axis and order == "axis" else m)
        p = mesh_shape[axis]
        for c in range(p):
            for has_nb in ((c > 0) or (periodic and p > 1), (c < p - 1) or (periodic and p > 1)):
                moved = 2 if has_nb or (periodic and p == 1) else 1
                total += moved * slab * shards // p
    return total * itemsize


def _itemsize(cfg) -> int:
    return 2 if cfg.precision.storage == "bfloat16" else 4


def _periodic(cfg) -> bool:
    return cfg.stencil.bc.value == "periodic"


def _flops(cfg) -> int:
    """Operations per cell and update of ``cfg``'s taps on the route the
    environment selects: the Mehrstellen instance's count where the
    direct kernels run it, the JAX package's count of the route on the
    plain arm, else the tap chain's."""
    from heat3d_tpu_torch import eqn
    from heat3d_tpu_torch.ops.stencil_direct import MEHRSTELLEN_KERNEL_OPS
    from heat3d_tpu_torch.parallel.step import mehrstellen_route

    q_ring = mehrstellen_route(cfg)
    if q_ring and cfg.backend != "jnp":
        return MEHRSTELLEN_KERNEL_OPS
    return flops_per_update(eqn.solver_taps(cfg), mehrstellen=q_ring)


def step_route_of(cfg) -> str:
    """The route ``cfg``'s hot loop runs: the superstep's at k > 1, else
    the step's (``parallel.step``)."""
    from heat3d_tpu_torch.parallel.step import step_route, superstep_route

    return superstep_route(cfg) if cfg.time_blocking > 1 else step_route(cfg)


def step_cost(cfg) -> Tuple[int, int]:
    """(bytes, operations) of ONE call of the program ``cfg``'s hot loop
    runs (a superstep of k = ``time_blocking`` updates at k > 1), over
    every shard: :func:`superstep_bytes_ops` on :func:`step_route_of`."""
    return superstep_bytes_ops(step_route_of(cfg), cfg.mesh.shape, cfg.local_shape,
                               max(1, cfg.time_blocking), _itemsize(cfg), _flops(cfg),
                               _periodic(cfg))


def step_cost_fields(cfg_or_solver) -> Dict[str, Optional[float]]:
    """Cost fields for the program the hot loop actually runs, whole-mesh
    numbers from the analytic model, normalized PER UPDATE: the step at
    ``time_blocking == 1``, the k-update superstep divided by k at k > 1
    (one exchange amortized over k updates, ghost-ring recompute
    included). Takes a config or a solver (its ``cfg``). Raises on any
    failure; callers treat that as "fields unavailable" (telemetry fails
    soft), never as a run failure."""
    from heat3d_tpu_torch.parallel.step import redundant_flops_frac

    cfg = getattr(cfg_or_solver, "cfg", cfg_or_solver)
    updates = max(1, cfg.time_blocking)
    bytes_, flops = step_cost(cfg)
    # Raw-vs-effective honesty for temporally-blocked supersteps: the
    # counted flops are RAW on the exchange path (the card executes the
    # shrinking-ring recompute trapezoid); the effective fraction discounts
    # them to the k useful sweeps so a deep-tb "win" that is mostly
    # recompute is visible from the fields alone.
    frac = redundant_flops_frac(cfg)
    raw_per_step = flops / updates
    return {
        "cost_flops_per_step": raw_per_step,
        "cost_bytes_per_step": bytes_ / updates,
        "cost_redundant_flops_frac": frac,
        "cost_effective_flops_per_step": raw_per_step * (1.0 - frac),
    }


def halo_cost_fields(cfg) -> Dict[str, Optional[float]]:
    """Bytes of ONE width-1 padded-block exchange of ``cfg`` (the
    ``halo_exchange`` phase program, :func:`halo_exchange_bytes`), so bench
    halo rows carry their own achieved-vs-peak denominator."""
    return {"cost_bytes_per_step": halo_exchange_bytes(
        cfg.mesh.shape, cfg.local_shape, cfg.halo_order, _itemsize(cfg),
        _periodic(cfg))}


def phase_cost(cfg, phase: str) -> Dict[str, Any]:
    """(flops, bytes) of one call of ``phase``'s program
    (``parallel.step.phase_programs``): ``step`` and ``fused_dma`` the hot
    loop's step or superstep (:func:`step_cost`); ``halo_exchange`` the
    width-1 padded-block exchange; ``stencil`` the route's kernel alone on
    every shard (a direct sweep: field read and written; a streamk or
    padded-block sweep: the padded block read, the field written);
    ``residual`` two fields read."""
    from heat3d_tpu_torch.parallel.step import (
        PHASE_FUSED, PHASE_HALO, PHASE_RESIDUAL, PHASE_STENCIL, PHASE_STEP,
        stencil_phase_kind,
    )

    item, k = _itemsize(cfg), max(1, cfg.time_blocking)
    shards = cfg.mesh.num_devices
    local = cfg.local_shape
    cells = local[0] * local[1] * local[2]
    if phase in (PHASE_STEP, PHASE_FUSED):
        b, f = step_cost(cfg)
        return {"flops": f, "bytes": b}
    if phase == PHASE_HALO:
        return {"flops": 0, "bytes": halo_cost_fields(cfg)["cost_bytes_per_step"]}
    if phase == PHASE_RESIDUAL:
        # two fields read, one subtract, one multiply and one add a cell
        return {"flops": 3 * cells * shards, "bytes": 2 * cells * shards * item}
    if phase == PHASE_STENCIL:
        kind, kk = stencil_phase_kind(cfg)
        flops = _flops(cfg)
        if kind == "direct":
            return {"flops": shards * cells * kk * flops, "bytes": 2 * shards * cells * item}
        padded = (local[0] + 2 * kk) * (local[1] + 2 * kk) * (local[2] + 2 * kk)
        return {"flops": shards * trapezoid_cells(local, kk) * flops,
                "bytes": shards * (padded + cells) * item}
    raise ValueError(f"unknown phase {phase!r}")


def record_step_cost(solver, **extra: Any) -> Optional[Dict[str, Any]]:
    """Compute :func:`step_cost_fields` for ``solver`` and append one
    ``step_cost`` ledger event (plus the platform, so ``obs summary`` can
    pick the right peak spec). Fails soft: any error becomes an
    ``ok: false`` event and a None return."""
    from heat3d_tpu_torch import obs

    if not obs.get().active:
        return None
    try:
        fields = step_cost_fields(solver)
        fields["platform"] = solver.device.type
    except Exception as e:  # noqa: BLE001 - telemetry fails soft
        obs.get().event(
            "step_cost", ok=False,
            error=f"{type(e).__name__}: {str(e)[:200]}",
        )
        return None
    obs.get().event("step_cost", ok=True, **fields, **extra)
    return fields


# ---- the live per-phase table ----------------------------------------------


def phase_costs_and_times(
    cfg, iters: int = 3, warmup: int = 1, device=None,
) -> List[Dict[str, Any]]:
    """Build each phase program of ``cfg``
    (:func:`heat3d_tpu_torch.parallel.step.phase_programs`), take its
    analytic cost (:func:`phase_cost`), and time it: one record per phase
    with ``flops``, ``bytes``, ``seconds`` (best of ``iters``) and the
    achieved rates. On the card the time is CUDA events around the
    program's launches (``utils.timing.cuda_time``); on the CPU it is the
    host clock (the plain versions; never a device figure)."""
    import time as _time

    from heat3d_tpu_torch.models.heat3d import HeatSolver3D
    from heat3d_tpu_torch.parallel.step import phase_programs

    solver = HeatSolver3D(cfg, device=device)
    programs = phase_programs(cfg, solver)
    us = solver._shards(solver.zeros_state())
    on_card = solver.device.type == "cuda"
    if on_card:
        from heat3d_tpu_torch.utils.timing import cuda_time

    out = []
    seen = {}
    for phase, fn in programs.items():
        if id(fn) in seen:  # fused_dma aliases the step program
            rec = dict(seen[id(fn)])
            rec["phase"] = phase
            rec["alias_of"] = seen[id(fn)]["phase"]
            out.append(rec)
            continue
        try:
            cost = phase_cost(cfg, phase)
        except Exception as e:  # noqa: BLE001 - keep the table best-effort
            out.append({"phase": phase,
                        "error": f"{type(e).__name__}: {str(e)[:200]}"})
            continue
        flops, bytes_ = cost["flops"], cost["bytes"]

        def once():
            solver.mesh.fork()
            fn(us)
            solver.mesh.join()

        for _ in range(warmup):
            once()
        times = []
        for _ in range(iters):
            if on_card:
                times.append(cuda_time(once))
            else:
                t0 = _time.perf_counter()
                once()
                times.append(_time.perf_counter() - t0)
        sec = min(times)
        rec = {
            "phase": phase,
            "flops": flops,
            "bytes": bytes_,
            "seconds": sec,
            "gflops": (flops / sec / 1e9) if flops else None,
            "gbps": (bytes_ / sec / 1e9) if bytes_ else None,
        }
        if phase == "step" and cfg.time_blocking > 1:
            # the step program is the k-update SUPERSTEP: its flops/gflops
            # are RAW (recompute trapezoid included on the exchange path).
            # Attach the effective side — useful updates per second and the
            # recompute discount — so the table can show both.
            from heat3d_tpu_torch.parallel.step import redundant_flops_frac

            rec["updates_per_call"] = cfg.time_blocking
            rec["redundant_flops_frac"] = redundant_flops_frac(cfg)
            rec["eff_gcell_per_s"] = (
                cfg.grid.num_cells * cfg.time_blocking / sec / 1e9
            )
        seen[id(fn)] = rec
        out.append(rec)
    return out


def _pct(v: Optional[float], peak: Optional[float]) -> str:
    if v is None or not peak:
        return "-"
    return f"{v / peak:7.1%}"


def print_live_table(
    cfg, records: List[Dict[str, Any]], platform: str, out=None
) -> None:
    """The per-phase achieved-vs-peak table ``obs roofline`` prints:
    phase, analytic flops/bytes, measured time, achieved GFLOP/s and GB/s,
    and the fraction of each peak — plus which ceiling binds."""
    out = out or sys.stdout
    spec = peak_spec(platform)
    mem, vec = spec.get("mem_gbps"), spec.get("vector_gflops")
    cal = calibrated_gflops(platform)
    grid = "x".join(str(g) for g in cfg.grid.shape)
    print(
        f"roofline [{platform}] grid={grid} stencil={cfg.stencil.kind} "
        f"dtype={cfg.precision.storage} tb={cfg.time_blocking} "
        f"backend={cfg.backend} "
        f"(peaks: mem {mem or '?'} GB/s, vector {vec or '?'} GFLOP/s"
        + (f"; calibrated {cal:.2f} GFLOP/s, not a peak" if cal else "") + ")",
        file=out,
    )
    print(
        f"{'phase':<16} {'flops':>12} {'bytes':>12} {'time':>10} "
        f"{'GFLOP/s':>9} {'GB/s':>8} {'%flops':>8} {'%mem':>8} {'bound':>6}",
        file=out,
    )
    for r in records:
        if "error" in r:
            print(f"{r['phase']:<16} error: {r['error']}", file=out)
            continue
        alias = f" (= {r['alias_of']})" if r.get("alias_of") else ""
        fm = _pct(r.get("gflops"), vec)
        bm = _pct(r.get("gbps"), mem)
        bound = "?"
        if r.get("gbps") is not None and mem:
            bound = "mem"
            if (
                r.get("gflops") is not None
                and vec
                and r["gflops"] / vec > r["gbps"] / mem
            ):
                bound = "flops"
        # Deep-tb honesty: the superstep's %flops is achieved-vs-peak on
        # RAW flops; print the EFFECTIVE rate (useful updates only) and the
        # recompute discount next to it
        eff = ""
        if r.get("eff_gcell_per_s") is not None:
            eff = (
                f"  eff {r['eff_gcell_per_s']:.3f} Gcell/s "
                f"({r.get('redundant_flops_frac', 0.0):.0%} recompute, "
                f"{r.get('updates_per_call')} upd/call)"
            )
        print(
            f"{r['phase']:<16} "
            f"{r['flops'] if r['flops'] is not None else '-':>12} "
            f"{r['bytes'] if r['bytes'] is not None else '-':>12} "
            f"{r['seconds'] * 1e3:>8.2f}ms "
            f"{r['gflops'] if r['gflops'] is not None else 0:>9.2f} "
            f"{r['gbps'] if r['gbps'] is not None else 0:>8.2f} "
            f"{fm:>8} {bm:>8} {bound:>6}{alias}{eff}",
            file=out,
        )


# ---- profile -> roofline join ----------------------------------------------


def phase_cost_records(cfg) -> Dict[str, Dict[str, Any]]:
    """Cost records per phase program — the COST side of the
    profile→roofline join (:func:`profile_join_records`): each phase of
    ``parallel.step.phase_programs`` through :func:`phase_cost`. No
    timing, no device — the measured side comes from the profile
    capture."""
    from heat3d_tpu_torch.parallel.step import PHASE_FUSED, PHASE_STEP, phase_names

    out: Dict[str, Dict[str, Any]] = {}
    for phase in phase_names(cfg):
        if phase == PHASE_FUSED:  # the fused launch is the whole step
            rec = dict(out[PHASE_STEP])
            rec["alias_of"] = PHASE_STEP
            out[phase] = rec
            continue
        try:
            out[phase] = phase_cost(cfg, phase)
        except Exception as e:  # noqa: BLE001 - keep the join best-effort
            out[phase] = {"error": f"{type(e).__name__}: {str(e)[:200]}"}
    return out


def _phase_calls(phase: str, steps: int, tb: int) -> Optional[int]:
    """How many times the phase program ran across ``steps`` updates: one
    stencil sweep per update (per superstep: the phase program is the
    route's kernel of k updates); one exchange (one fused kernel) per tb
    updates. None means "total time only, no achieved rate": residual
    cadence is run-configured and not recoverable from the capture, and
    the ``step`` range's device time is EXCLUSIVE (launches inside the
    inner stencil/halo ranges attribute there, leaving only glue) —
    dividing the FULL step program's cost by glue-only time would claim
    absurd fractions of peak."""
    from heat3d_tpu_torch.parallel.step import (
        PHASE_FUSED,
        PHASE_HALO,
        PHASE_STENCIL,
    )

    if phase == PHASE_STENCIL:
        return max(1, steps // max(1, tb))
    if phase in (PHASE_HALO, PHASE_FUSED):
        return max(1, steps // max(1, tb))
    return None


def profile_join_records(
    cfg, phase_us: Dict[str, float], steps: int
) -> List[Dict[str, Any]]:
    """THE join: measured per-phase DEVICE time from a ``--profile``
    capture (``obs.perf.timeline.profile_phase_totals`` — keyed by the
    ``heat3d.*`` phase ranges) against the analytic FLOPs/bytes of the
    same-named phase programs. One record per phase: total device time, its share of
    attributed device time, per-call device seconds (``steps`` and
    ``cfg.time_blocking`` set the call counts), and the achieved
    GFLOP/s / GB/s those imply — "stencil at X% of HBM peak, halo at Y%"
    from measured times, not span wall-clock."""
    from heat3d_tpu_torch.parallel.step import (
        PHASE_FUSED,
        PHASE_HALO,
        PHASE_STEP,
        PHASES,
    )

    costs = phase_cost_records(cfg)
    tb = cfg.time_blocking
    # Fused-route captures (DMA-overlap or in-kernel RDMA) run NO
    # standalone exchange — the halo bytes move inside the step-scope
    # kernel. Joining the halo_exchange program's bytes against
    # the capture's (absent) halo span would print the phase as missing
    # when it honestly VANISHED into the fused kernel, so drop it from
    # the join; its traffic is already attributed to the fused span.
    fused_active = costs.get(PHASE_FUSED, {}).get("alias_of") == PHASE_STEP
    if fused_active and phase_us.get(PHASE_HALO) is None:
        costs.pop(PHASE_HALO, None)
    attributed = sum(
        us for ph, us in phase_us.items() if ph != "(unattributed)"
    )
    records: List[Dict[str, Any]] = []
    order = (
        [ph for ph in PHASES if ph in costs]
        + [ph for ph in costs if ph not in PHASES]
        + [ph for ph in sorted(phase_us) if ph not in costs]
    )
    for phase in order:
        cost = costs.get(phase, {})
        us = phase_us.get(phase)
        rec: Dict[str, Any] = {
            "phase": phase,
            "device_us": None if us is None else round(us, 3),
            "share": (
                round(us / attributed, 4)
                if us is not None and attributed > 0
                and phase != "(unattributed)"
                else None
            ),
            "flops": cost.get("flops"),
            "bytes": cost.get("bytes"),
        }
        if cost.get("error"):
            rec["error"] = cost["error"]
        if cost.get("alias_of"):
            rec["alias_of"] = cost["alias_of"]
        calls = _phase_calls(phase, steps, tb)
        if us is not None and calls:
            sec = us * 1e-6 / calls
            rec["calls"] = calls
            rec["seconds"] = sec
            flops, bytes_ = cost.get("flops"), cost.get("bytes")
            rec["gflops"] = (flops / sec / 1e9) if flops and sec > 0 else None
            rec["gbps"] = (bytes_ / sec / 1e9) if bytes_ and sec > 0 else None
        records.append(rec)
    return records


def print_profile_table(
    cfg, records: List[Dict[str, Any]], platform: str, steps: int,
    artifact: str, out=None,
) -> None:
    """The measured-device-time achieved-vs-peak table ``heat3d obs
    roofline --from-profile`` prints. Same peak specs and %-of-peak
    semantics as the live table; the time column is DEVICE time from the
    capture, divided over the calls the run made."""
    out = out or sys.stdout
    spec = peak_spec(platform)
    mem, vec = spec.get("mem_gbps"), spec.get("vector_gflops")
    grid = "x".join(str(g) for g in cfg.grid.shape)
    print(
        f"roofline from profile [{platform}] grid={grid} "
        f"stencil={cfg.stencil.kind} tb={cfg.time_blocking} steps={steps} "
        f"(peaks: mem {mem or '?'} GB/s, vector {vec or '?'} GFLOP/s)\n"
        f"  measured device time: {artifact}",
        file=out,
    )
    print(
        f"{'phase':<16} {'dev total':>10} {'share':>6} {'per-call':>10} "
        f"{'GFLOP/s':>9} {'GB/s':>8} {'%flops':>8} {'%mem':>8}",
        file=out,
    )
    for r in records:
        if r.get("error"):
            print(f"{r['phase']:<16} cost error: {r['error']}", file=out)
            continue
        dev = (
            f"{r['device_us'] / 1e3:.3f}ms"
            if r.get("device_us") is not None
            else "-"
        )
        share = f"{r['share']:.1%}" if r.get("share") is not None else "-"
        per_call = (
            f"{r['seconds'] * 1e6:.1f}us" if r.get("seconds") else "-"
        )
        gf = f"{r['gflops']:.2f}" if r.get("gflops") is not None else "-"
        gb = f"{r['gbps']:.2f}" if r.get("gbps") is not None else "-"
        alias = f" (= {r['alias_of']})" if r.get("alias_of") else ""
        print(
            f"{r['phase']:<16} {dev:>10} {share:>6} {per_call:>10} "
            f"{gf:>9} {gb:>8} {_pct(r.get('gflops'), vec):>8} "
            f"{_pct(r.get('gbps'), mem):>8}{alias}",
            file=out,
        )


def _steps_from_ledger(path: str, run_id: Optional[str] = None) -> Optional[int]:
    """Stepped updates of ONE run segment — the ``steps`` fields of its
    ok run_loop/chunk spans. The profile bracket covers exactly one
    run's timed loop (``--profile``'s documented scope), but ledgers
    hold many segments (APPEND bench sessions thread one
    ``$HEAT3D_LEDGER`` through every row) — summing across them would
    inflate the step count and corrupt every per-call rate. Default:
    the LAST segment with step spans (the run that just wrote the
    capture); ``run_id`` selects another explicitly."""
    from heat3d_tpu_torch.obs.cli import STEP_SPANS, read_ledger

    per_run: Dict[str, int] = {}
    order: List[str] = []
    for r in read_ledger(path):
        if (
            r.get("kind") == "span"
            and r.get("event") in STEP_SPANS
            and r.get("status") == "ok"
            and isinstance(r.get("steps"), int)
        ):
            rid = str(r.get("run_id"))
            if rid not in per_run:
                order.append(rid)
            per_run[rid] = per_run.get(rid, 0) + r["steps"]
    if run_id is not None:
        return per_run.get(str(run_id)) or None
    return (per_run[order[-1]] if order else 0) or None


# ---- peak calibration -------------------------------------------------------


def calibrate_vpu_peak(
    grid: int = 512,
    iters: int = 3,
    backend: str = "auto",
    cache_path: Optional[str] = None,
    device=None,
) -> Dict[str, Any]:
    """Measure the GFLOP/s of the densest tap chain — the 27pt tb=1
    stencil program, the direct kernel on the card — and store it under
    the card's name in the tuning store (``tune.cache.store_peak``, the
    JAX store's ``peaks`` section). The figure is a floor on the card's
    fp32 rate, not the rate: the kernel is memory-bound, so the roofline
    shows it beside the peaks (:func:`calibrated_gflops`) and never
    divides by it. Returns the record; raises when the
    stencil phase produced no usable flops/seconds (callers print the
    error; calibration is an explicit operator action, not fail-soft
    telemetry)."""
    from heat3d_tpu_torch.core.config import (
        GridConfig,
        MeshConfig,
        Precision,
        RunConfig,
        SolverConfig,
        StencilConfig,
    )
    from heat3d_tpu_torch.tune.cache import chip_generation, store_peak

    cfg = SolverConfig(
        grid=GridConfig.cube(grid),
        stencil=StencilConfig(kind="27pt"),
        mesh=MeshConfig(shape=(1, 1, 1)),
        precision=Precision.fp32(),
        run=RunConfig(num_steps=1),
        backend=backend,
        time_blocking=1,
    )
    records = phase_costs_and_times(cfg, iters=iters, device=device)
    stencil = next(
        (r for r in records if r.get("phase") == "stencil"), None
    )
    if not stencil or stencil.get("error"):
        raise RuntimeError(
            "calibration needs the stencil phase program: "
            f"{(stencil or {}).get('error', 'phase missing')}"
        )
    gflops = stencil.get("gflops")
    if not isinstance(gflops, (int, float)) or gflops <= 0:
        raise RuntimeError("stencil phase reported no flops")
    chip = chip_generation()
    path = store_peak(
        chip,
        float(gflops),
        path=cache_path,
        source=f"27pt tb=1 {grid}^3 stencil phase, backend={backend}",
    )
    from heat3d_tpu_torch import obs

    obs.get().event(
        "peak_calibrated", chip=chip, vector_gflops=float(gflops),
        grid=grid, backend=backend, path=path,
    )
    return {
        "chip": chip,
        "vector_gflops": float(gflops),
        "seconds": stencil.get("seconds"),
        "path": path,
    }


# ---- row model ---------------------------------------------------------------


def bytes_per_cell_update(row) -> tuple:
    """Traffic model per path (BASELINE.md 'HBM traffic model')."""
    item = 2 if row["dtype"] == "bfloat16" else 4
    tb = row.get("time_blocking", 1)
    mesh = row.get("mesh", [1, 1, 1])
    single = all(m == 1 for m in mesh)
    halo = row.get("halo", "ppermute")
    overlap = row.get("overlap", False)
    # the direct kernels apply on unpadded shards for ppermute transport;
    # DMA transport and tb>2 keep the padded exchange (one extra volume
    # read+write per exchange). Prefer the RESOLVED selection the harness
    # recorded (exact even for HEAT3D_NO_DIRECT A/B rows); derive for
    # legacy rows.
    if row.get("fused_rdma_path"):
        # fused in-kernel RDMA superstep: the halo bytes ride remote
        # copies INSIDE the sweep kernel (no standalone exchange phase),
        # so HBM traffic is one unpadded read+write per sweep of tb
        # updates — counting an exchange copy here would double-count
        # bytes the kernel never materializes
        per_update = 2 * item / tb
        path = f"fused-rdma{'' if tb == 1 else '2'}"
        if row.get("halo_plan") == "partitioned":
            path += "+planned-partitioned"
        return per_update, path
    if row.get("fused_dma_path"):
        # fused DMA-overlap kernels: unpadded streaming sweep, one
        # read+write per sweep of tb updates — same traffic shape as the
        # direct kernels
        return 2 * item / tb, f"fused-dma{'' if tb == 1 else '2'}"
    if row.get("streamk_path"):
        # fused k-sweep streaming kernel (deep tb): the width-k exchange
        # still materializes the padded copy (one r+w per superstep), but
        # the k updates then share ONE sweep of it — vs k sweeps on the
        # plain exchange path
        return 4 * item / tb, f"streamk(tb={tb})"
    direct = row.get("direct_path")
    if direct is None:
        direct = halo == "ppermute" and tb in (1, 2)
    if direct and not (overlap and tb == 2):
        per_update = 2 * item / tb  # one read + one write per sweep of tb
        path = f"direct{'' if tb == 1 else '2'}{'' if single else '+faces'}"
    else:
        # exchange path: padded copy (r+w) once per exchange + sweep per
        # update (tb updates share one exchange)
        per_update = 2 * item + 2 * item / tb
        path = f"exchange(tb={tb})"
    # planned-exchange arm: a partitioned plan ships the SAME boundary
    # bytes as monolithic in sub-block messages (the p50 A/B measures
    # schedule, not traffic) — label the path so partitioned rows are
    # attributable without changing the byte model
    if row.get("halo_plan") == "partitioned":
        path += "+planned-partitioned"
    return per_update, path


def vpu_ops_per_cell_update(row):
    """Vector ops/cell/update of the row's tap chain. Prefers the
    ``chain_ops`` the harness recorded at measurement time (exact even for
    factoring-knob A/B rows); falls back to re-deriving under the CURRENT
    factoring env for rows predating that field. Tap VALUES don't matter
    for the count, only which offsets are nonzero, so nominal
    alpha/dt/spacing are fine for the fallback."""
    if "chain_ops" in row:
        return row["chain_ops"]  # may be None: conv rows run no tap chain
    if row.get("backend") == "conv":
        return None
    from heat3d_tpu_torch.core.stencils import chain_ops_for

    return chain_ops_for(row.get("stencil", "7pt"))


def iter_result_rows(path, kinds=None, start_line=1, stop_line=None):
    """Yield ``(lineno, row)`` bench rows from a results file, tolerating
    log-style line prefixes ("factor_y=0 tb=1: {...}" — the factoring A/B
    stages log their rows rather than appending them to the suite
    record). ``kinds`` filters on the ``bench`` field; the 1-indexed
    ``[start_line, stop_line)`` window is how the regression gate scopes
    "this session's rows" (the ONE parser both this module and
    obs/perf/regress.py read rows through)."""
    with open(path) as f:
        for i, line in enumerate(f, start=1):
            if i < start_line or (stop_line is not None and i >= stop_line):
                continue
            line = line.strip()
            brace = line.find("{")
            if brace < 0:
                continue
            try:
                r = json.loads(line[brace:])
            except json.JSONDecodeError:
                continue
            if isinstance(r, dict) and (
                kinds is None or r.get("bench") in kinds
            ):
                yield i, r


def load_rows(paths: List[str]) -> List[Dict[str, Any]]:
    """Throughput rows from row files (see :func:`iter_result_rows`)."""
    return [
        r
        for results in paths
        for _, r in iter_result_rows(results, kinds=("throughput",))
    ]


def report_rows(rows, hbm_gbps: float, vpu_gops, out=None) -> None:
    out = out or sys.stdout
    print(
        f"{'grid':>6} {'dtype':>8} {'st':>4} {'tb':>2} {'path':>16} "
        f"{'B/cell/upd':>10} {'ops':>4} {'ceiling':>9} {'bind':>4} "
        f"{'measured':>9} {'achieved':>8}",
        file=out,
    )
    for r in rows:
        per_update, path = bytes_per_cell_update(r)
        bw_ceiling = hbm_gbps / per_update  # Gcell/s/chip
        ops = vpu_ops_per_cell_update(r)
        ceiling, bind = bw_ceiling, "hbm"
        # ops is None for conv rows (one convolution call, no tap chain): the
        # VPU model doesn't apply — report against the HBM ceiling only
        if vpu_gops is not None and ops is not None:
            vpu_ceiling = vpu_gops / ops
            if vpu_ceiling < bw_ceiling:
                ceiling, bind = vpu_ceiling, "vpu"
        meas = r["gcell_per_sec_per_chip"]
        grid = (
            r["grid"][0]
            if len(set(r["grid"])) == 1
            else "x".join(map(str, r["grid"]))
        )
        flag = " (RTT!)" if r.get("rtt_dominated") else ""
        # compute dtype doesn't change HBM traffic (storage dtype does),
        # but label it so bf16-compute A/B rows are tellable apart
        if r.get("compute_dtype", "float32") != "float32":
            flag = " (c=bf16)" + flag
        print(
            f"{grid:>6} {r['dtype']:>8} {r.get('stencil', '7pt'):>4} "
            f"{r.get('time_blocking', 1):>2} {path:>16} "
            f"{per_update:>10.1f} {'n/a' if ops is None else ops:>4} "
            f"{ceiling:>9.1f} {bind:>4} "
            f"{meas:>9.2f} {meas / ceiling:>7.1%}{flag}",
            file=out,
        )


def fit_op_cost(rows, out=None) -> None:
    """Least-squares time/cell/update = a + b*ops over rows that differ
    ONLY in their emitted chain (same grid/dtype/tb/path). A good linear
    fit is direct evidence the kernels are compute-bound in chain ops;
    a >> b would instead indict fixed per-cell cost (assembly/shifts)."""
    from collections import defaultdict

    out = out or sys.stdout
    groups = defaultdict(list)
    for r in rows:
        if r.get("rtt_dominated"):
            continue
        _, path = bytes_per_cell_update(r)
        # compute_dtype/backend in the key: a bf16-compute A/B row has the
        # same chain_ops as its fp32-compute twin but different per-op
        # cost — pooling them would corrupt the fit silently
        key = (
            tuple(r["grid"]), r["dtype"],
            r.get("compute_dtype", "float32"), r.get("backend", "auto"),
            r.get("time_blocking", 1), path,
        )
        ops = vpu_ops_per_cell_update(r)
        if ops is None:
            continue  # conv rows: no tap chain, nothing to fit against
        ns_per_cell = 1.0 / r["gcell_per_sec_per_chip"]  # ns/cell/update
        groups[key].append((ops, ns_per_cell))
    printed = False
    for key, pts in sorted(groups.items()):
        by_ops = {}
        for ops, t in pts:
            by_ops.setdefault(ops, []).append(t)
        if len(by_ops) < 2:
            continue
        xs, ys = zip(*((o, min(ts)) for o, ts in sorted(by_ops.items())))
        n = len(xs)
        mx, my = sum(xs) / n, sum(ys) / n
        sxx = sum((x - mx) ** 2 for x in xs)
        b = sum((x - mx) * (y - my) for x, y in zip(xs, ys)) / sxx
        a = my - b * mx
        if n >= 3:
            ss_res = sum((y - (a + b * x)) ** 2 for x, y in zip(xs, ys))
            ss_tot = sum((y - my) ** 2 for y in ys) or 1e-30
            fit_q = f"R^2={1 - ss_res / ss_tot:.3f}"
        else:
            # a line through 2 points always "fits"; don't dress that up
            fit_q = "2-point (no linearity evidence)"
        grid, dtype, cdtype, backend, tb, path = key
        cflag = "" if cdtype == "float32" else f" c={cdtype}"
        glabel = (
            f"{grid[0]}^3"
            if len(set(grid)) == 1
            else "x".join(map(str, grid))
        )
        if b <= 0:
            # higher-ops rows timed FASTER: noise or a confound — that's
            # anti-evidence of compute-boundedness, not an infinite rate
            verdict = "non-positive slope — unfittable/not compute-bound"
        else:
            verdict = (
                f"marginal {1.0 / b:.0f} Gop/s, "
                f"fixed {a / (a + b * xs[0]):.0%} of the {xs[0]}-op chain"
            )
        print(
            f"\nfit {glabel} {dtype}{cflag} tb={tb} {path}: "
            f"t/cell = {a:.3f} + {b:.4f}*ops ns "
            f"({verdict}, {fit_q}, points={list(by_ops)})",
            file=out,
        )
        printed = True
    if not printed:
        print(
            "\nfit: no group has >=2 distinct chain_ops values "
            "(need factoring A/B rows, e.g. HEAT3D_FACTOR_Y=0)",
            file=sys.stderr,
        )


# ---- CLI -------------------------------------------------------------------


def _cfg_from_args(args):
    from heat3d_tpu_torch.core.config import (
        GridConfig,
        MeshConfig,
        Precision,
        RunConfig,
        SolverConfig,
        StencilConfig,
    )

    return SolverConfig(
        grid=GridConfig.cube(args.grid),
        stencil=StencilConfig(kind=args.stencil),
        mesh=MeshConfig(shape=(1, 1, 1)),
        precision=Precision.bf16() if args.dtype == "bf16" else Precision.fp32(),
        run=RunConfig(num_steps=1),
        backend=args.backend,
        time_blocking=args.time_blocking,
    )


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="heat3d obs roofline",
        description="Achieved-vs-peak attribution. With row files: the "
        "analytic traffic/op-cost model over measured bench rows. "
        "Without: build this config's phase programs, take their analytic "
        "cost, time them (CUDA events on the card), and print the "
        "per-phase achieved-vs-peak table (works on CPU, --device cpu).",
    )
    ap.add_argument(
        "results", nargs="*",
        help="row files (bench_results.jsonl / extracted A/B rows); "
        "empty selects the live per-phase mode",
    )
    ap.add_argument("--hbm-gbps", type=float, default=3350.0,
                    help="card memory rate (GB/s); H100 SXM 3350")
    ap.add_argument("--vpu-gops", type=float, default=None,
                    help="VPU vector throughput (Gop/s, one op = one "
                    "full-width FMA or add); calibrate from a measured "
                    "compute-bound row — no default on purpose")
    ap.add_argument("--fit", action="store_true",
                    help="(row mode) fit time/cell/update = a + b*ops per "
                    "config group — linearity in ops IS the compute-bound "
                    "evidence")
    ap.add_argument("--grid", type=int, default=32,
                    help="(live mode) cube edge")
    ap.add_argument("--stencil", choices=["7pt", "27pt"], default="7pt")
    ap.add_argument("--dtype", choices=["fp32", "bf16"], default="fp32")
    ap.add_argument("--backend",
                    choices=["auto", "jnp", "pallas", "conv"], default="auto")
    ap.add_argument("--time-blocking", type=int, default=1)
    ap.add_argument("--iters", type=int, default=3,
                    help="(live mode) timing iterations per phase")
    ap.add_argument("--from-profile", default=None, metavar="DIR",
                    help="join MEASURED per-phase device times from a "
                    "--profile capture (dir or .pt.trace.json) onto this "
                    "config's cost_analysis model — achieved-vs-peak from "
                    "device time, not span wall-clock (needs the config "
                    "flags to match the profiled run)")
    ap.add_argument("--steps", type=int, default=None,
                    help="(with --from-profile) updates the capture "
                    "covers; default: reconstructed from --ledger's "
                    "run_loop/chunk spans, else 1 (per-call rates then "
                    "read as per-capture)")
    ap.add_argument("--ledger", default=None,
                    help="(with --from-profile) run ledger of the "
                    "profiled run — supplies the step count (the LAST "
                    "run segment with step spans; --run selects another)")
    ap.add_argument("--run", default=None, metavar="RUN_ID",
                    help="(with --from-profile --ledger) the ledger run "
                    "segment the capture belongs to")
    ap.add_argument("--calibrate", action="store_true",
                    help="measure the 27pt tb=1 stencil phase (the direct "
                    "kernel on the card) and store its achieved GFLOP/s "
                    "under this card's name (the tuning store; the live "
                    "table shows it beside the peaks, never divides by it)")
    ap.add_argument("--cache", default=None,
                    help="(with --calibrate) tuning-cache store path "
                    "(default $HEAT3D_TUNE_CACHE)")
    ap.add_argument("--json", action="store_true",
                    help="(live mode) machine-readable records instead of "
                    "the table")
    ap.add_argument("--device", default=None,
                    help="(live mode, --calibrate) torch device of the "
                    "programs (default: the card when one is visible; "
                    "'cpu' runs the kernels' plain versions, host-timed)")
    args = ap.parse_args(argv)

    if args.calibrate:
        try:
            rec = calibrate_vpu_peak(
                grid=args.grid,
                iters=args.iters,
                backend=args.backend,
                cache_path=args.cache,
                device=args.device,
            )
        except Exception as e:  # noqa: BLE001 - report, don't traceback
            print(f"roofline --calibrate: {e}", file=sys.stderr)
            return 1
        if args.json:
            print(json.dumps(rec))
        else:
            print(
                f"calibrated {rec['chip']}: the 27pt tap chain achieves "
                f"{rec['vector_gflops']:.2f} GFLOP/s "
                f"(stored in {rec['path']})"
            )
        return 0

    if args.from_profile:
        from heat3d_tpu_torch.obs.perf.timeline import profile_phase_totals

        try:
            phase_us, artifact = profile_phase_totals(args.from_profile)
        except (RuntimeError, OSError) as e:
            print(f"roofline --from-profile: {e}", file=sys.stderr)
            return 1
        steps = args.steps
        if steps is None and args.ledger:
            try:
                steps = _steps_from_ledger(args.ledger, run_id=args.run)
            except OSError as e:
                print(
                    f"roofline --from-profile: cannot read ledger: {e}",
                    file=sys.stderr,
                )
                return 2
            if steps is None:
                which = (
                    f"run {args.run}" if args.run else "any run segment"
                )
                print(
                    f"roofline --from-profile: no ok step spans for "
                    f"{which} in {args.ledger} — treating the capture as "
                    "ONE update (rates read as per-capture)",
                    file=sys.stderr,
                )
        elif steps is None:
            print(
                "roofline --from-profile: no --steps/--ledger — treating "
                "the capture as ONE update (rates read as per-capture)",
                file=sys.stderr,
            )
        steps = steps or 1
        cfg = _cfg_from_args(args)
        records = profile_join_records(cfg, phase_us, steps)
        platform = current_platform()
        if args.json:
            print(
                json.dumps(
                    {
                        "platform": platform,
                        "artifact": artifact,
                        "steps": steps,
                        "phases": records,
                    }
                )
            )
        else:
            print_profile_table(cfg, records, platform, steps, artifact)
        return 0

    if args.results:
        rows = load_rows(args.results)
        if not rows:
            print("no throughput rows found", file=sys.stderr)
            return 1
        report_rows(rows, args.hbm_gbps, args.vpu_gops)
        if args.fit:
            fit_op_cost(rows)
        return 0

    cfg = _cfg_from_args(args)
    records = phase_costs_and_times(cfg, iters=args.iters, device=args.device)
    platform = (
        current_platform() if args.device is None
        else ("cuda" if str(args.device).startswith("cuda") else "cpu")
    )
    if args.json:
        print(json.dumps({"platform": platform, "phases": records}))
    else:
        print_live_table(cfg, records, platform)
    return 0


if __name__ == "__main__":
    sys.exit(main())
