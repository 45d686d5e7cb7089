"""Ensemble throughput measurement — the batched counterpart of
``bench.harness.bench_throughput``, with its row discipline.

Port of ``heat3d_tpu.serve.bench``. The row is a normal ``bench:
throughput`` record (the same ledger mirror, the JAX package's provenance
contract) whose ``batch_shape`` / ``members_per_step`` fields carry the
ensemble workload: ``gcell_per_sec`` counts EVERY member's cell updates,
so the per-member effective rate is ``gcell_per_sec / members_per_step``
(``obs summary`` and ``obs regress`` report that split, so an ensemble win
can never pass for, or hide, a single-run change). Times come from CUDA
events on one device, or the host clock between synchronisations of every
device the shards span (``bench.harness``); only an explicit
``device='cpu'`` measures the host (``platform: 'cpu'``).
"""

from __future__ import annotations

from typing import Dict

import torch

from heat3d_tpu_torch import eqn, obs, ops
from heat3d_tpu_torch.parallel.plan import effective_halo_plan
from heat3d_tpu_torch.serve.ensemble import EnsembleSolver
from heat3d_tpu_torch.serve.scenario import ScenarioBatch


def bench_ensemble_throughput(
    batch: ScenarioBatch,
    steps: int = 50,
    warmup: int = 2,
    repeats: int = 3,
    batch_mesh: int = 1,
    device=None,
) -> Dict:
    """Gcell-updates/sec of the batched ensemble loop (ALL members'
    updates counted; per-member effective rate = total / members), every
    member at ``steps`` (a floor, calibrated up until a run lasts long
    enough); the best of ``repeats`` timed runs after ``warmup``."""
    from heat3d_tpu_torch.bench.harness import (
        _FLOOR_S,
        _cost_fields,
        _ledger_bench_row,
        _sync_all,
        _timer,
        _utc_now,
    )
    from heat3d_tpu_torch.ops.stencil_direct import chain_ops
    from heat3d_tpu_torch.parallel.step import redundant_flops_frac
    from heat3d_tpu_torch.utils.timing import calibrate_trip_count, sync_rtt

    on_cpu = device is not None and torch.device(device).type == "cpu"
    if not on_cpu and not torch.cuda.is_available():
        raise RuntimeError("bench_ensemble_throughput measures a CUDA device; none found")
    before = ops.launch_counts()
    solver = EnsembleSolver(batch, batch_mesh=batch_mesh, bind="traced", device=device)
    cfg, B = solver.cfg, solver.B
    devices = sorted({s.device for s in solver.mesh.local_shards}, key=str)
    u = solver.init_state()
    for _ in range(warmup):
        u = solver.run(u, steps)
    _sync_all(devices)
    timer = _timer(devices)

    def timed(n: int) -> float:
        def go():
            nonlocal u
            u = solver.run(u, int(n))

        return timer(go)

    steps_requested = steps
    steps, first = calibrate_trip_count(timed, _FLOOR_S, start=steps)
    times = [first] + [timed(steps) for _ in range(repeats - 1)]
    after = ops.launch_counts()
    best = min(times)
    rtt = 0.0 if on_cpu else sync_rtt(devices[0])
    gcells = B * cfg.grid.num_cells * steps / best / 1e9
    on_card = devices[0].type == "cuda"
    n_dev = len(devices)
    row = {
        "bench": "throughput",
        "ts": _utc_now(),
        "platform": "gpu" if on_card else devices[0].type,
        "device_name": torch.cuda.get_device_name(devices[0]) if on_card else str(devices[0]),
        "grid": list(cfg.grid.shape),
        "stencil": cfg.stencil.kind,
        "bc": cfg.stencil.bc.value,
        "equation": cfg.equation,
        # the ensemble packs the explicit sweep only, and says so
        "integrator": cfg.integrator,
        "mesh": list(cfg.mesh.shape),
        "dtype": cfg.precision.storage,
        "compute_dtype": cfg.precision.compute,
        "backend": cfg.backend,
        "time_blocking": cfg.time_blocking,
        "overlap": cfg.overlap,
        "halo": cfg.halo,
        "halo_order": cfg.halo_order,
        "halo_plan": effective_halo_plan(cfg),
        # the fused routes never run on the batched path: rows record what
        # ran
        "fused_rdma": "off",
        "steps": steps,
        "steps_requested": steps_requested,
        "seconds_best": best,
        "seconds_all": list(times),
        # times come from CUDA events, so the round trip is not subtracted
        "sync_rtt_s": rtt,
        "rtt_dominated": best < 2 * rtt,
        "gcell_per_sec": gcells,
        "gcell_per_sec_per_chip": gcells / n_dev,
        "gcell_updates_per_sec": gcells,
        "devices": n_dev,
        "shards_per_device": len(solver.mesh) // n_dev,
        # the ensemble workload axis: total / members_per_step is the
        # per-member effective rate the obs reports print
        "batch_shape": [B],
        "members_per_step": B,
        "batch_mesh": solver.batch_mesh,
        # route provenance: the batched path is the plain chain (or the
        # Mehrstellen route under its knob); no kernel route resolves
        "chain_ops": chain_ops(eqn.solver_taps(cfg), mehrstellen=solver._mehrstellen),
        "mehrstellen_route": solver._mehrstellen,
        "direct_path": False,
        "fused_dma_path": False,
        "fused_dma_emulated": False,
        "streamk_path": False,
        "streamk_emulated": False,
        "fused_rdma_path": False,
        "fused_rdma_emulated": False,
        "step_route": "ensemble",
        "superstep_route": "ensemble" if cfg.time_blocking > 1 else None,
        "cost_redundant_flops_frac": redundant_flops_frac(cfg),
        # every hand-written kernel launch of the benchmark: none on this
        # path, as in the JAX package's route
        "kernel_launches": {k: after[k] - before[k] for k in after},
        # the analytic bytes and operations of ONE member's update
        **_cost_fields("step_cost_fields", cfg),
    }
    _ledger_bench_row(row)
    obs.REGISTRY.histogram(
        "bench_step_latency_seconds", "bench throughput per-step latency"
    ).observe(best / steps)
    return row
