"""Command line: ``python -m heat3d_tpu_torch --grid N --steps S ...``.

Port of a subset of ``heat3d_tpu.cli``: build the config, run the solver
(fixed steps, or to a residual tolerance), and print one JSON summary line
with the JAX CLI's key names (``gcell_updates_per_sec``, ``residual_l2``,
``golden_pass``, ...) plus the routes and the kernel launch counts of the
run. ``--mesh Px Py Pz`` splits the field into shards, by default shard i
on ``cuda:i``; ``--device D`` puts every shard on D (``cpu`` runs the
kernels' plain versions; ``cuda:0`` runs a sharded solve on one card).
Runs on the GPU unless ``--device cpu`` is given. Human-readable errors go
to stderr with exit code 2.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import List, Optional

import numpy as np
import torch

from heat3d_tpu_torch.core.config import (
    BoundaryCondition,
    GridConfig,
    MeshConfig,
    Precision,
    RunConfig,
    SolverConfig,
    StencilConfig,
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="heat3d_tpu_torch",
        description="3D heat-equation solver on CUDA GPUs (the PyTorch "
        "port of heat3d_tpu)",
    )
    p.add_argument(
        "--grid", type=int, nargs="+", default=[128],
        help="global interior grid: one int (cube) or three (NX NY NZ)",
    )
    p.add_argument("--stencil", choices=["7pt", "27pt"], default="7pt")
    p.add_argument("--bc", choices=["dirichlet", "periodic"], default="dirichlet")
    p.add_argument("--bc-value", type=float, default=0.0)
    p.add_argument("--mesh", type=int, nargs="+", default=[1, 1, 1],
                   help="mesh of shards Px Py Pz (one int = 1D slab; default "
                   "1 1 1): shard i on cuda:i unless --device is given")
    p.add_argument("--halo", choices=["ppermute", "dma"], default="ppermute",
                   help="ghost-exchange transport between shards: slab copies "
                   "(ppermute) or the DMA peer-write kernel")
    p.add_argument("--overlap", action="store_true",
                   help="overlap the halo exchange with the interior sweep: "
                   "with --halo dma the fused DMA-overlap kernel (x-sharded "
                   "meshes; tb 1, and tb 2 on x-slabs), with ppermute "
                   "faces-direct (tb 1) or the interior/boundary split")
    p.add_argument("--halo-plan", choices=["monolithic", "partitioned"],
                   default="monolithic",
                   help="exchange-plan mode: each face copied whole, or as "
                   "sub-blocks (value-identical; pins the exchange path, "
                   "except for --fused-rdma on, whose sends ride it)")
    p.add_argument("--fused-rdma", choices=["off", "on"], default="off",
                   help="fused in-kernel RDMA step: the x-face pushes inside "
                   "the stencil kernel on the plan's sub-blocks (x-slab "
                   "meshes, --time-blocking <= 2, --halo ppermute)")
    p.add_argument("--dtype", choices=["fp32", "bf16"], default="fp32",
                   help="field storage dtype; residual always accumulates fp32")
    p.add_argument("--compute-dtype", choices=["fp32", "bf16"], default="fp32",
                   help="stencil compute dtype: bf16 rounds every read, multiply "
                   "and add of the update to bf16 (BASELINE.json config 5's "
                   "bf16 stencil); residual still accumulates fp32")
    p.add_argument("--time-blocking", type=int, default=1,
                   help="updates per superstep, k >= 1 (2 = the fused "
                   "two-update direct kernel; 3-4 = one width-k exchange and "
                   "the fused streamk kernel; HEAT3D_NO_DIRECT=1 puts every "
                   "route on the exchange path)")
    p.add_argument("--backend", choices=["auto", "pallas", "jnp", "conv"],
                   default="auto",
                   help="padded-block compute of the exchange path: auto/pallas "
                   "= the CUDA kernels, jnp = the plain PyTorch chain, conv = "
                   "one F.conv3d (jnp and conv also take every update off the "
                   "direct kernels)")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--init", default="hot-cube", help="hot-cube | gaussian | random")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--tol", type=float, default=None,
                   help="run to convergence at this L2 residual instead of "
                   "fixed steps (--steps is then the cap)")
    p.add_argument("--residual-every", type=int, default=0,
                   help="residual every K steps (0 = only at the end)")
    p.add_argument("--golden-check", action="store_true",
                   help="compare against the fp64 NumPy golden model")
    p.add_argument("--device", default=None,
                   help="torch device of every shard (default: shard i on "
                   "cuda:i; the current CUDA device for one shard)")
    return p


def config_from_args(args) -> SolverConfig:
    grid_shape = tuple(args.grid * 3 if len(args.grid) == 1 else args.grid)
    if len(grid_shape) != 3:
        raise ValueError("--grid takes 1 or 3 ints")
    mesh = tuple(args.mesh + [1, 1] if len(args.mesh) == 1 else args.mesh)
    if len(mesh) != 3:
        raise ValueError("--mesh takes 1 or 3 ints")
    return SolverConfig(
        grid=GridConfig(shape=grid_shape),
        mesh=MeshConfig(shape=mesh),
        halo=args.halo,
        overlap=args.overlap,
        halo_plan=args.halo_plan,
        fused_rdma=args.fused_rdma,
        stencil=StencilConfig(
            kind=args.stencil,
            bc=BoundaryCondition(args.bc),
            bc_value=args.bc_value,
        ),
        precision=Precision(
            storage="bfloat16" if args.dtype == "bf16" else "float32",
            compute="bfloat16" if args.compute_dtype == "bf16" else "float32",
        ),
        run=RunConfig(
            num_steps=args.steps,
            tolerance=args.tol,
            seed=args.seed,
            residual_every=args.residual_every,
        ),
        time_blocking=args.time_blocking,
        backend=args.backend,
    )


def main(argv: Optional[List[str]] = None) -> int:
    try:
        return _main(argv)
    except (ValueError, RuntimeError) as e:
        print(f"heat3d_tpu_torch: error: {e}", file=sys.stderr)
        return 2


def _sync(solver) -> None:
    for d in {s.device for s in solver.mesh.shards}:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def _main(argv: Optional[List[str]]) -> int:
    from heat3d_tpu_torch.models.heat3d import HeatSolver3D, resolved_backend_name
    from heat3d_tpu_torch.ops import launch_counts
    from heat3d_tpu_torch.parallel.plan import effective_halo_plan
    from heat3d_tpu_torch.parallel.step import (
        resolve_fused_rdma,
        step_route,
        superstep_route,
    )

    args = build_parser().parse_args(argv)
    cfg = config_from_args(args)
    solver = HeatSolver3D(cfg, device=args.device)
    u = solver.init_state(args.init)
    # warm up (kernel build and first launch) outside the timed window
    solver.step_with_residual(solver.zeros_state())
    _sync(solver)

    before = launch_counts()
    residual = None
    t0 = time.perf_counter()
    if cfg.run.tolerance is not None:
        result = solver.run_to_convergence(
            u, tol=cfg.run.tolerance, max_steps=cfg.run.num_steps
        )
        u, done, residual = result.u, result.steps, result.residual
    else:
        total = cfg.run.num_steps
        done = 0
        while done < total:
            # to the next residual point or the end; the last update of
            # each segment is the residual step, so exactly `total` run
            nxt = total
            if args.residual_every:
                nxt = min(total, (done // args.residual_every + 1) * args.residual_every)
            n = nxt - done
            if n > 1:
                u = solver.run(u, n - 1)
            u, r2 = solver.step_with_residual(u)
            residual = float(np.sqrt(np.float64(float(r2))))
            if args.residual_every:
                print(f"step {nxt} residual {residual:.6e}", file=sys.stderr)
            done = nxt
    _sync(solver)
    elapsed = time.perf_counter() - t0
    after = launch_counts()

    # a rate from a CPU run is not a device metric: reported only on the GPU
    on_gpu = solver.device.type == "cuda"
    rate = cfg.grid.num_cells * max(done, 1) / elapsed / 1e9 if on_gpu else None
    devices = {s.device for s in solver.mesh.shards}
    summary = {
        "grid": list(cfg.grid.shape),
        "stencil": cfg.stencil.kind,
        "equation": cfg.equation,
        "integrator": cfg.integrator,
        "mesh": list(cfg.mesh.shape),
        "halo": cfg.halo,
        "overlap": cfg.overlap,
        "halo_plan": effective_halo_plan(cfg),
        "fused_rdma": resolve_fused_rdma(cfg),
        "shards_per_device": len(solver.mesh) // len(devices),
        "step_route": step_route(cfg),
        "superstep_route": superstep_route(cfg) if cfg.time_blocking > 1 else None,
        "dtype": cfg.precision.storage,
        "compute_dtype": cfg.precision.compute,
        "backend": resolved_backend_name(cfg),
        "time_blocking": cfg.time_blocking,
        "platform": "gpu" if on_gpu else "cpu",
        "device_name": torch.cuda.get_device_name(solver.device) if on_gpu else "cpu",
        "steps": done,
        "seconds": elapsed,
        "residual_l2": residual,
        "gcell_updates_per_sec": rate,
        "gcell_updates_per_sec_per_chip": None if rate is None else rate / len(devices),
        "kernel_launches": {k: after[k] - before[k] for k in after},
    }
    if args.golden_check:
        from heat3d_tpu_torch import eqn
        from heat3d_tpu_torch.core import golden

        g = golden.run(
            golden.make_init(args.init, cfg.grid.shape, seed=cfg.run.seed),
            cfg.grid, cfg.stencil, done, taps=eqn.solver_taps(cfg),
        )
        got = solver.gather(u).astype(np.float64)
        err = float(np.max(np.abs(got - g)))
        rel = err / max(float(np.max(np.abs(g))), 1e-300)
        summary["golden_max_abs_err"] = err
        summary["golden_rel_err"] = rel
        # the JAX CLI's tolerance: bf16 anywhere in the chain (storage or
        # stencil compute) caps accuracy at bf16's ~3 decimal digits
        fp32_chain = (cfg.precision.storage == "float32"
                      and cfg.precision.compute == "float32")
        tol = 1e-5 if fp32_chain else 5e-2
        summary["golden_pass"] = bool(rel < tol)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
