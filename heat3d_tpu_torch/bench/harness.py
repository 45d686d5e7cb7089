"""The judged benchmarks on CUDA devices: throughput and halo p50.

Port of ``heat3d_tpu.bench.harness`` (``bench_throughput``, ``bench_halo``,
``run_suite``). ``bench_throughput``: Gcell-updates per
second of ``HeatSolver3D.run``, best of ``repeats`` timed runs after a
warmup, with the step count calibrated up until a run lasts long enough to
average over many launches. Under a non-Euler integrator the timed loop is
the ``timeint`` one (the two-level leapfrog carry, or the CG solves) and
the row describes the config the solver pinned (``timeint.pin_config``).
Times come from CUDA events on one device (utils.timing), or from the host
clock between synchronisations of every device when the shards span
several. Rows keep the JAX row's field names
where the field exists, plus the mesh, the halo transport, the shards per
device and the routes; the Gcell/s are effective updates of the GLOBAL
grid (cells x steps / time), never the raw recompute of a superstep's
ghost rings, which ``cost_redundant_flops_frac`` reports. ``throughput_row``
builds the row from the timings, so the JAX package's provenance lint
(``analysis.provenance.check_row``) can judge a row built without a card.

``bench_halo``: the latency of one full 3D ghost exchange of the solver's
width-1 padded-block plan (its transport, ordering and effective plan
mode), as ``halo_loop`` runs it: k exchanges back to back with each
shard's six received ghost faces folded onto its own boundary faces, so
every transfer is live in the carry and the only other work is
face-sized. One program of k exchanges is timed as one span; the p50 and
``p95_mean_us`` are over ``iters`` programs, each divided by k (the tail
is of program means, not of single exchanges). ``halo_row`` builds that
row from timings. ``run_suite`` gives a throughput row per config and one
halo row per distinct exchange shape.
"""

from __future__ import annotations

import datetime
import json
import sys
import time
from typing import Dict, List, Optional

import torch

from heat3d_tpu_torch import eqn, obs, ops, timeint
from heat3d_tpu_torch.core.config import DEFAULT_INTEGRATOR, SolverConfig
from heat3d_tpu_torch.models.heat3d import HeatSolver3D, resolved_backend_name
from heat3d_tpu_torch.ops.stencil_direct import chain_ops
from heat3d_tpu_torch.parallel.plan import effective_halo_plan, make_schedule
from heat3d_tpu_torch.parallel.step import (
    make_exchanges,
    mehrstellen_route,
    redundant_flops_frac,
    resolve_fused_rdma,
    step_route,
    superstep_route,
)
from heat3d_tpu_torch.parallel.topology import build_shard_mesh
from heat3d_tpu_torch.utils.timing import (
    calibrate_trip_count,
    cuda_time,
    percentile,
    sync_rtt,
)

# a timed run lasts at least this long
_FLOOR_S = 0.2


def _utc_now() -> str:
    return datetime.datetime.now(datetime.timezone.utc).strftime(
        "%Y-%m-%dT%H:%M:%SZ"
    )


def _sync_all(devices) -> None:
    for d in devices:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def _timer(devices):
    """``timed(go)`` -> seconds of ``go()``: CUDA events on one device, else
    the host clock between synchronisations of every device (on the CPU,
    the host clock alone)."""
    def timed(go) -> float:
        if len(devices) == 1 and devices[0].type == "cuda":
            with torch.cuda.device(devices[0]):
                return cuda_time(go)
        t0 = time.perf_counter()
        go()
        _sync_all(devices)
        return time.perf_counter() - t0

    return timed


def bench_throughput(
    cfg: SolverConfig,
    steps: int = 50,
    warmup: int = 2,
    repeats: int = 3,
    device=None,
) -> Dict:
    """Gcell-updates/s of the kernel time loop on CUDA (every shard on
    ``device`` when given, else shard i on ``cuda:i``). ``steps`` is a
    floor, calibrated up; the best run is reported. ``ms_per_launch`` is
    the best run's time over its supersteps and remainder steps (on the
    exchange path each is an exchange plus a kernel launch per shard);
    ``kernel_launches`` counts each kernel's launches in the benchmark.
    Only an explicit ``device='cpu'`` measures the CPU (the kernels' plain
    versions on the host clock, for the CPU tuner and the tests): that row
    says ``platform: 'cpu'``, never a device figure."""
    on_cpu = device is not None and torch.device(device).type == "cpu"
    if not on_cpu and not torch.cuda.is_available():
        raise RuntimeError("bench_throughput measures a CUDA device; none found")
    before = ops.launch_counts()
    solver = HeatSolver3D(cfg, device=device)
    devices = sorted({s.device for s in solver.mesh.shards}, key=str)
    if devices[0].type != "cuda" and not on_cpu:
        raise RuntimeError("bench_throughput measures CUDA devices")
    u = solver.init_state("hot-cube")
    for _ in range(warmup):
        u = solver.run(u, steps)
    _sync_all(devices)

    timer = _timer(devices)

    def timed(n: int) -> float:
        def go():
            nonlocal u
            u = solver.run(u, n)

        return timer(go)

    steps_requested = steps
    steps, first = calibrate_trip_count(timed, _FLOOR_S, start=steps)
    times = [first] + [timed(steps) for _ in range(repeats - 1)]
    after = ops.launch_counts()
    row = throughput_row(
        solver.cfg, steps=steps, steps_requested=steps_requested, times=times,
        devices=devices, shards=len(solver.mesh),
        sync_rtt_s=0.0 if on_cpu else sync_rtt(devices[0]),
        kernel_launches={k: after[k] - before[k] for k in after},
    )
    _ledger_bench_row(row)
    obs.REGISTRY.histogram(
        "bench_step_latency_seconds", "bench throughput per-step latency"
    ).observe(min(times) / steps)
    return row


def throughput_row(
    cfg: SolverConfig,
    steps: int,
    steps_requested: int,
    times,
    devices,
    shards: int,
    sync_rtt_s: float,
    kernel_launches: Dict[str, int],
) -> Dict:
    """The throughput row of ``steps``-step runs of ``cfg`` that took
    ``times`` seconds on ``devices`` (``shards`` shards over them): the
    timing numbers as given, the routes and provenance fields from ``cfg``
    under the current environment (a non-Euler integrator's config as the
    solver pins it). Measures nothing itself."""
    if cfg.integrator != DEFAULT_INTEGRATOR:
        cfg = timeint.pin_config(cfg)
    tb = cfg.time_blocking
    per_run = steps // tb + steps % tb
    route = superstep_route(cfg) if tb > 1 else step_route(cfg)
    schedule = make_schedule(cfg.mesh.shape, tb, effective_halo_plan(cfg), cfg.halo_order)
    itemsize = torch.empty((), dtype=getattr(torch, cfg.precision.storage)).element_size()
    best = min(times)
    updates = cfg.grid.num_cells * steps
    gcells = updates / best / 1e9
    on_card = devices[0].type == "cuda"
    q_ring = mehrstellen_route(cfg)
    return {
        "bench": "throughput",
        "ts": _utc_now(),
        "platform": "gpu" if on_card else devices[0].type,
        "device_name": torch.cuda.get_device_name(devices[0]) if on_card else str(devices[0]),
        "grid": list(cfg.grid.shape),
        "stencil": cfg.stencil.kind,
        "bc": cfg.stencil.bc.value,
        "equation": cfg.equation,
        "integrator": cfg.integrator,
        "mesh": list(cfg.mesh.shape),
        "halo": cfg.halo,
        "overlap": cfg.overlap,
        # the plan mode that ran (HEAT3D_NO_PLAN runs monolithic) and the
        # fused-RDMA knob after its environment override
        "halo_plan": effective_halo_plan(cfg),
        "fused_rdma": resolve_fused_rdma(cfg),
        # the route provenance of the JAX row: which kernel the hot path
        # resolved to (the superstep's at tb > 1, else the step's)
        "direct_path": route in ("direct", "direct2"),
        "streamk_path": route == "streamk",
        "fused_dma_path": route.startswith("fused-dma"),
        "fused_rdma_path": route.startswith("fused-rdma"),
        # the Mehrstellen route ran (knob, taps, a compute that has it)
        "mehrstellen_route": q_ring,
        # the JAX row marks a route resolved to its XLA reference contract
        # off the TPU; the port has no such tier (a CUDA tensor launches
        # its kernel or raises), so on the card these are honestly False
        "fused_dma_emulated": False,
        "streamk_emulated": False,
        "fused_rdma_emulated": False,
        # ops per cell and update of the emitted tap chain under the
        # factoring knobs at measurement time, or the JAX package's count
        # of the Mehrstellen route where it ran; one conv call has no chain
        "chain_ops": (None if cfg.backend == "conv"
                      else chain_ops(eqn.solver_taps(cfg), mehrstellen=q_ring)),
        # the plan schedule of one exchange: face copies (sub-blocks
        # counted) and boundary bytes sent per shard
        "messages_per_exchange": schedule.messages_per_exchange(),
        "plan_traffic": schedule.traffic(cfg.local_shape, itemsize),
        "devices": len(devices),
        "shards_per_device": shards // len(devices),
        "dtype": cfg.precision.storage,
        "compute_dtype": cfg.precision.compute,
        "backend": resolved_backend_name(cfg),
        "time_blocking": cfg.time_blocking,
        "step_route": step_route(cfg),
        "superstep_route": superstep_route(cfg) if tb > 1 else None,
        "steps": steps,
        "steps_requested": steps_requested,
        "batch_shape": [1],
        "members_per_step": 1,
        "seconds_best": best,
        "seconds_all": list(times),
        # one synchronize after an empty launch, the JAX row's sync RTT; the
        # times above come from CUDA events, so it is not subtracted
        "sync_rtt_s": sync_rtt_s,
        # a run this short is within twice the round trip (the JAX rule):
        # the tuner never lets such a row win
        "rtt_dominated": best < 2 * sync_rtt_s,
        "gcell_per_sec": gcells,
        "gcell_per_sec_per_chip": gcells / len(devices),
        "gcell_updates_per_sec": gcells,
        "launches_per_run": per_run,
        "ms_per_launch": best / per_run * 1e3,
        # fraction of a superstep's executed stencil flops that are
        # ghost-ring recompute: the discount between the effective Gcell/s
        # above and what the card executed
        "cost_redundant_flops_frac": redundant_flops_frac(cfg),
        # every launch of the whole benchmark (warmup and calibration too)
        "kernel_launches": kernel_launches,
        # the analytic bytes and operations of one update of this config
        # (obs.perf.roofline, the bound's yardstick), so a row's
        # achieved-vs-peak is computable from the row alone
        **_cost_fields("step_cost_fields", cfg),
    }


def _cost_fields(name: str, cfg: SolverConfig) -> Dict:
    """``obs.perf.roofline.<name>(cfg)`` (``step_cost_fields`` or
    ``halo_cost_fields``); fails soft: null cost fields and the error, never
    a lost row."""
    fields = {"cost_flops_per_step": None, "cost_bytes_per_step": None}
    if name == "halo_cost_fields":
        fields.pop("cost_flops_per_step")
    try:
        from heat3d_tpu_torch.obs.perf import roofline

        fields.update(getattr(roofline, name)(cfg))
    except Exception as e:  # noqa: BLE001 - telemetry fails soft
        fields["cost_analysis_error"] = f"{type(e).__name__}: {str(e)[:120]}"
    return fields


def _ledger_bench_row(row: Dict) -> None:
    """Mirror a measured row into the run ledger. The row's ``ts`` (UTC
    measurement-time string) collides with the ledger envelope's ``ts``
    (unix float at write time) — respelled ``ts_`` (the trailing-underscore
    rule) so a consumer can still join ledger events to rows by
    timestamp."""
    obs.get().event(
        "bench_row", **{("ts_" if k == "ts" else k): v for k, v in row.items()}
    )


def fold_ghosts(u, pad) -> None:
    """Overwrite the boundary faces of ``u`` (nx, ny, nz) in place with the
    ghost faces of its width-1 padded block ``pad``, in the JAX loop's
    order: x-low, x-high, y-low, y-high, z-low, z-high (later faces win
    on the shared edges)."""
    nx, ny, nz = u.shape
    u[0] = pad[0, 1:1 + ny, 1:1 + nz]
    u[nx - 1] = pad[nx + 1, 1:1 + ny, 1:1 + nz]
    u[:, 0] = pad[1:1 + nx, 0, 1:1 + nz]
    u[:, ny - 1] = pad[1:1 + nx, ny + 1, 1:1 + nz]
    u[:, :, 0] = pad[1:1 + nx, 1:1 + ny, 0]
    u[:, :, nz - 1] = pad[1:1 + nx, 1:1 + ny, nz + 1]


def halo_loop(plan, mesh, us, k: int, bc_value: float):
    """``k`` exchanges of the width-1 plan ``plan`` back to back (the body
    of the JAX ``bench_halo`` loop): each ``plan.apply(us, bc_value)``,
    then each shard's received ghost faces folded onto its own boundary
    faces (:func:`fold_ghosts`) on its stream, so every transfer feeds the
    next exchange. ``us`` (rank order) is the carry, changed in place and
    returned. The shard streams fork from the caller's stream before and
    join it after, so events on the caller's stream bracket the loop."""
    if plan.width != 1:
        raise ValueError(f"the halo loop folds width-1 ghosts, plan width {plan.width}")
    mesh.fork()
    for _ in range(k):
        pads = plan.apply(us, bc_value)
        for s, u, pad in zip(mesh.shards, us, pads):
            with mesh.on(s):
                fold_ghosts(u, pad)
    mesh.join()
    return us


def bench_halo(
    cfg: SolverConfig,
    iters: int = 10,
    warmup: int = 2,
    k: Optional[int] = None,
    device=None,
) -> Dict:
    """p50 latency of one full 3D ghost exchange on CUDA (every shard on
    ``device`` when given, else shard i on ``cuda:i``): the solver's
    width-1 padded-block plan over its mesh, from a zero field in the
    storage dtype, timed as ``halo_loop`` programs of ``k`` exchanges
    (calibrated from 25 up to a program of at least ``_FLOOR_S`` when not
    given), ``iters`` of them, each divided by ``k``. One device: CUDA
    events; several: the host clock between synchronisations of every
    device. The sync RTT is recorded, not subtracted."""
    if not torch.cuda.is_available():
        raise RuntimeError("bench_halo measures a CUDA device; none found")
    before = ops.launch_counts()["halo_dma"]
    mesh = build_shard_mesh(cfg, device)
    devices = sorted({s.device for s in mesh.shards}, key=str)
    if devices[0].type != "cuda":
        raise RuntimeError("bench_halo measures CUDA devices")
    dtype = getattr(torch, cfg.precision.storage)
    plan = make_exchanges(cfg, mesh).plan(1, dtype)
    us = [torch.zeros(mesh.local_shape, dtype=dtype, device=s.device) for s in mesh.shards]
    bcv = cfg.stencil.bc_value
    for _ in range(warmup):
        halo_loop(plan, mesh, us, 1, bcv)
    _sync_all(devices)
    timer = _timer(devices)

    def timed(n: int) -> float:
        return timer(lambda: halo_loop(plan, mesh, us, n, bcv))

    if k is None:
        k, _ = calibrate_trip_count(timed, _FLOOR_S, start=25)
    times = [timed(k) / k for _ in range(iters)]
    halo_hist = obs.REGISTRY.histogram(
        "halo_exchange_latency_seconds",
        "per-exchange halo latency (program mean)",
    )
    for t in times:
        halo_hist.observe(t)
    row = halo_row(cfg, k, iters, times, devices, len(mesh), sync_rtt(devices[0]),
                   exchange_kernel_launches=ops.launch_counts()["halo_dma"] - before)
    _ledger_bench_row(row)
    # opt-in per-link probe (HEAT3D_COMM_PROBE): each (axis, direction,
    # sub-block) link of this plan timed alone, its comm_probe events
    # beside this row; env-gated and fail-soft
    from heat3d_tpu_torch.obs.comm.probe import maybe_probe

    maybe_probe(cfg, device=device)
    return row


def halo_row(
    cfg: SolverConfig,
    k: int,
    iters: int,
    times,
    devices,
    shards: int,
    sync_rtt_s: float,
    exchange_kernel_launches: int = 0,
) -> Dict:
    """The halo row of ``iters`` programs of ``k`` exchanges of ``cfg``'s
    width-1 plan that took ``times`` seconds per exchange on ``devices``
    (``shards`` shards over them): the JAX row's fields, plus the
    transport, the device, the shards per device and the DMA kernel
    launches of the benchmark. Measures nothing itself."""
    itemsize = torch.empty((), dtype=getattr(torch, cfg.precision.storage)).element_size()
    eff = effective_halo_plan(cfg)
    traffic = make_schedule(cfg.mesh.shape, 1, eff, cfg.halo_order).traffic(
        cfg.local_shape, itemsize)
    nx, ny, nz = cfg.local_shape
    on_card = devices[0].type == "cuda"
    return {
        "bench": "halo",
        "ts": _utc_now(),
        "platform": "gpu" if on_card else devices[0].type,
        "device_name": torch.cuda.get_device_name(devices[0]) if on_card else str(devices[0]),
        "grid": list(cfg.grid.shape),
        "mesh": list(cfg.mesh.shape),
        "dtype": cfg.precision.storage,
        "halo": cfg.halo,
        "halo_order": cfg.halo_order,
        # the plan mode that ran (HEAT3D_NO_PLAN runs monolithic)
        "halo_plan": eff,
        # the plan schedule's own model of one exchange per shard
        "plan_messages_per_exchange": traffic["messages"],
        "plan_bytes_per_device": traffic["bytes_per_device"],
        "iters": iters,
        "exchanges_per_program": k,
        "p50_us": percentile(times, 50) * 1e6,
        # the 95th percentile of per-program means, not a per-exchange tail
        "p95_mean_us": percentile(times, 95) * 1e6,
        "min_us": min(times) * 1e6,
        # the times come from CUDA events (one device) or synchronised
        # host clocks; the round trip is recorded beside them, not
        # subtracted
        "sync_rtt_us": sync_rtt_s * 1e6,
        "sync_rtt_s": sync_rtt_s,
        "rtt_dominated": min(times) * k < 2 * sync_rtt_s,
        "ici": shards > 1,
        "halo_bytes_per_device": 2 * (ny * nz + nx * nz + nx * ny) * itemsize,
        "devices": len(devices),
        "shards_per_device": shards // len(devices),
        "exchange_kernel_launches": exchange_kernel_launches,
        # the bytes one exchange must move (obs.perf.roofline), so the p50
        # has its own achieved-vs-peak fraction
        **_cost_fields("halo_cost_fields", cfg),
    }


def run_suite(
    configs: List[SolverConfig],
    steps: int = 50,
    out=None,
    device=None,
    iters: int = 10,
    repeats: int = 3,
    state_path: Optional[str] = None,
) -> List[Dict]:
    """A throughput row for each config (best of ``repeats``), and a halo
    row (``iters`` programs) once per distinct exchange shape: (grid, mesh,
    storage dtype, transport, ordering, effective plan mode). The halo
    latency depends on nothing else, so configs that differ only in tb,
    backend or stencil share one halo row. Each row is printed to ``out``
    (default stdout) as one JSON line as it lands.

    With ``state_path`` every landed row is journaled in a
    :class:`~heat3d_tpu_torch.resilience.sweepstate.SweepState` under its
    ``row_key``, and an interrupted sweep (SIGTERM, backend death) RESUMES
    AT THE FIRST MISSING ROW on the next invocation: journaled rows are
    re-emitted from the journal, not re-measured. The fault hook
    (``HEAT3D_FAULTS=sigterm:row=K``) fires before each measured row, so
    the resume path is testable on the CPU."""
    from heat3d_tpu_torch.resilience.faults import FaultPlan
    from heat3d_tpu_torch.resilience.sweepstate import SweepState, row_key

    out = out or sys.stdout
    state = SweepState(state_path) if state_path else None
    plan = FaultPlan.from_env()
    results = []
    halo_seen = set()
    row_index = 0

    def one_row(key: str, measure) -> None:
        nonlocal row_index
        done = state.record(key) if state is not None else None
        if done is not None and done.get("record") is not None:
            row = done["record"]
            # re-emitted from the journal, NOT re-measured: the ledger
            # must tell the two apart
            obs.get().event("bench_row_replayed", key=key)
        else:
            plan.on_sweep_row(row_index)
            row_index += 1
            with obs.get().span("bench_row_measure", key=key):
                row = measure()
            if state is not None:
                # only a row measured on the card retires its journal
                # entry; one that says it ran elsewhere stays pending
                if row.get("platform") in (None, "gpu"):
                    state.mark_done(key, row)
                else:
                    obs.get().event("bench_row_pending", key=key,
                                    platform=row.get("platform"), want_platform="gpu")
                    print(f"suite: row {key} measured on {row.get('platform')!r}, "
                          "not 'gpu' — left pending", file=sys.stderr)
        results.append(row)
        print(json.dumps(row), file=out, flush=True)

    for cfg in configs:
        one_row(row_key(cfg, "throughput"),
                lambda cfg=cfg: bench_throughput(cfg, steps=steps, repeats=repeats,
                                                 device=device))
        key = (cfg.grid.shape, cfg.mesh.shape, cfg.precision.storage, cfg.halo,
               cfg.halo_order, effective_halo_plan(cfg))
        if key not in halo_seen:
            halo_seen.add(key)
            one_row(row_key(cfg, "halo"),
                    lambda cfg=cfg: bench_halo(cfg, iters=iters, device=device))
    return results
