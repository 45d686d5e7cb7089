"""Throughput benchmark of the solver's fixed-step loop on one CUDA device.

Port of ``heat3d_tpu.bench.harness.bench_throughput``: Gcell-updates per
second of ``HeatSolver3D.run``, best of ``repeats`` timed runs after a
warmup, with the step count calibrated up until a run lasts long enough to
average over many launches. Times come from CUDA events (utils.timing).
Rows keep the JAX row's field names where the field exists.
"""

from __future__ import annotations

import datetime
from typing import Dict

import torch

from heat3d_tpu_torch.core.config import SolverConfig
from heat3d_tpu_torch.models.heat3d import HeatSolver3D
from heat3d_tpu_torch.ops import stencil_direct
from heat3d_tpu_torch.utils.timing import calibrate_trip_count, cuda_time

# a timed run lasts at least this long
_FLOOR_S = 0.2


def _utc_now() -> str:
    return datetime.datetime.now(datetime.timezone.utc).strftime(
        "%Y-%m-%dT%H:%M:%SZ"
    )


def bench_throughput(
    cfg: SolverConfig,
    steps: int = 50,
    warmup: int = 2,
    repeats: int = 3,
) -> Dict:
    """Gcell-updates/s of the compiled-kernel time loop on the current CUDA
    device. ``steps`` is a floor, calibrated up; the best run is reported.
    ``ms_per_launch`` is the best run's time over its kernel launches;
    ``kernel_launches`` counts each kernel's launches in the benchmark."""
    if not torch.cuda.is_available():
        raise RuntimeError("bench_throughput measures a CUDA device; none found")
    before = stencil_direct.launch_counts()
    solver = HeatSolver3D(cfg)
    u = solver.init_state("hot-cube")
    for _ in range(warmup):
        u = solver.run(u, steps)
    torch.cuda.synchronize()

    def timed(n: int) -> float:
        def go():
            nonlocal u
            u = solver.run(u, n)

        return cuda_time(go)

    steps_requested = steps
    steps, first = calibrate_trip_count(timed, _FLOOR_S, start=steps)
    times = [first] + [timed(steps) for _ in range(repeats - 1)]
    after = stencil_direct.launch_counts()
    tb = cfg.time_blocking
    per_run = steps // tb + steps % tb
    best = min(times)
    updates = cfg.grid.num_cells * steps
    gcells = updates / best / 1e9
    return {
        "bench": "throughput",
        "ts": _utc_now(),
        "platform": "gpu",
        "device_name": torch.cuda.get_device_name(),
        "grid": list(cfg.grid.shape),
        "stencil": cfg.stencil.kind,
        "bc": cfg.stencil.bc.value,
        "equation": cfg.equation,
        "integrator": cfg.integrator,
        "mesh": list(cfg.mesh.shape),
        "dtype": cfg.precision.storage,
        "compute_dtype": cfg.precision.compute,
        "backend": cfg.backend,
        "time_blocking": cfg.time_blocking,
        "steps": steps,
        "steps_requested": steps_requested,
        "batch_shape": [1],
        "members_per_step": 1,
        "seconds_best": best,
        "seconds_all": times,
        "gcell_per_sec": gcells,
        "gcell_per_sec_per_chip": gcells / cfg.mesh.num_devices,
        "gcell_updates_per_sec": gcells,
        "launches_per_run": per_run,
        "ms_per_launch": best / per_run * 1e3,
        # every launch of the whole benchmark (warmup and calibration too)
        "kernel_launches": {k: after[k] - before[k] for k in after},
    }
