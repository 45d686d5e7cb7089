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
ghost rings, which ``cost_redundant_flops_frac`` reports.
"""

from __future__ import annotations

import datetime
import time
from typing import Dict

import torch

from heat3d_tpu_torch import ops
from heat3d_tpu_torch.core.config import SolverConfig
from heat3d_tpu_torch.models.heat3d import HeatSolver3D, resolved_backend_name
from heat3d_tpu_torch.parallel.step import (
    redundant_flops_frac,
    step_route,
    superstep_route,
)
from heat3d_tpu_torch.utils.timing import calibrate_trip_count, cuda_time

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
    tb = cfg.time_blocking
    per_run = steps // tb + steps % tb
    best = min(times)
    updates = cfg.grid.num_cells * steps
    gcells = updates / best / 1e9
    return {
        "bench": "throughput",
        "ts": _utc_now(),
        "platform": "gpu",
        "device_name": torch.cuda.get_device_name(devices[0]),
        "grid": list(cfg.grid.shape),
        "stencil": cfg.stencil.kind,
        "bc": cfg.stencil.bc.value,
        "equation": cfg.equation,
        "integrator": cfg.integrator,
        "mesh": list(cfg.mesh.shape),
        "halo": cfg.halo,
        "devices": len(devices),
        "shards_per_device": len(solver.mesh) // len(devices),
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
        "seconds_all": times,
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
        "kernel_launches": {k: after[k] - before[k] for k in after},
    }
