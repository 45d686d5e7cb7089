"""Throughput benchmark of the solver's fixed-step loop on CUDA devices.

Port of ``heat3d_tpu.bench.harness.bench_throughput``: Gcell-updates per
second of ``HeatSolver3D.run``, best of ``repeats`` timed runs after a
warmup, with the step count calibrated up until a run lasts long enough to
average over many launches. Times come from CUDA events on one device
(utils.timing), or from the host clock between synchronisations of every
device when the shards span several. Rows keep the JAX row's field names
where the field exists, plus the mesh, the halo transport, the shards per
device and the routes; the Gcell/s are effective updates of the GLOBAL
grid (cells x steps / time), never the raw recompute of a superstep's
ghost rings, which ``cost_redundant_flops_frac`` reports. ``throughput_row``
builds the row from the timings, so the JAX package's provenance lint
(``analysis.provenance.check_row``) can judge a row built without a card.
"""

from __future__ import annotations

import datetime
import time
from typing import Dict

import torch

from heat3d_tpu_torch import eqn, ops
from heat3d_tpu_torch.core.config import SolverConfig
from heat3d_tpu_torch.models.heat3d import HeatSolver3D, resolved_backend_name
from heat3d_tpu_torch.ops.stencil_direct import chain_ops, mehrstellen_route as _q_ring
from heat3d_tpu_torch.parallel.plan import effective_halo_plan, make_schedule
from heat3d_tpu_torch.parallel.step import (
    redundant_flops_frac,
    resolve_fused_rdma,
    step_route,
    superstep_route,
)
from heat3d_tpu_torch.utils.timing import calibrate_trip_count, cuda_time, sync_rtt

# a timed run lasts at least this long
_FLOOR_S = 0.2


def _utc_now() -> str:
    return datetime.datetime.now(datetime.timezone.utc).strftime(
        "%Y-%m-%dT%H:%M:%SZ"
    )


def _sync_all(devices) -> None:
    for d in devices:
        torch.cuda.synchronize(d)


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
    ``kernel_launches`` counts each kernel's launches in the benchmark."""
    if not torch.cuda.is_available():
        raise RuntimeError("bench_throughput measures a CUDA device; none found")
    before = ops.launch_counts()
    solver = HeatSolver3D(cfg, device=device)
    devices = sorted({s.device for s in solver.mesh.shards}, key=str)
    if devices[0].type != "cuda":
        raise RuntimeError("bench_throughput measures CUDA devices")
    u = solver.init_state("hot-cube")
    for _ in range(warmup):
        u = solver.run(u, steps)
    _sync_all(devices)

    def timed(n: int) -> float:
        def go():
            nonlocal u
            u = solver.run(u, n)

        if len(devices) == 1:
            with torch.cuda.device(devices[0]):
                return cuda_time(go)
        t0 = time.perf_counter()
        go()
        _sync_all(devices)
        return time.perf_counter() - t0

    steps_requested = steps
    steps, first = calibrate_trip_count(timed, _FLOOR_S, start=steps)
    times = [first] + [timed(steps) for _ in range(repeats - 1)]
    after = ops.launch_counts()
    return throughput_row(
        cfg, steps=steps, steps_requested=steps_requested, times=times,
        devices=devices, shards=len(solver.mesh), sync_rtt_s=sync_rtt(devices[0]),
        kernel_launches={k: after[k] - before[k] for k in after},
    )


_DIRECT_ROUTES = ("direct", "direct2", "faces-direct", "faces-direct2")


def mehrstellen_route(cfg: SolverConfig) -> bool:
    """Whether the Mehrstellen route runs for ``cfg`` under the current
    environment (port of the JAX ``_mehrstellen_route``): the knob on, the
    solver's taps decomposing, and a compute that implements the route,
    the plain update (``backend='jnp'``) or the direct kernels' q-ring
    instance (a direct route at tb 1 or 2). The exchange-path and fused
    kernels keep the tap chain."""
    if not _q_ring(eqn.solver_taps(cfg)):
        return False
    if resolved_backend_name(cfg) == "jnp":
        return True
    tb = cfg.time_blocking
    route = superstep_route(cfg) if tb > 1 else step_route(cfg)
    return tb in (1, 2) and route in _DIRECT_ROUTES


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
    under the current environment. Measures nothing itself."""
    tb = cfg.time_blocking
    per_run = steps // tb + steps % tb
    route = superstep_route(cfg) if tb > 1 else step_route(cfg)
    schedule = make_schedule(cfg.mesh.shape, tb, effective_halo_plan(cfg))
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
    }
