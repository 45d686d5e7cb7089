"""Command line: ``python -m heat3d_tpu_torch --grid N --steps S ...``.

Port of a subset of ``heat3d_tpu.cli``: build the config, run the solver
(fixed steps, or to a residual tolerance), and print one JSON summary line
with the JAX CLI's key names (``gcell_updates_per_sec``, ``residual_l2``,
``golden_pass``, ...) plus the routes and the kernel launch counts of the
run. ``--equation FAMILY`` with ``--eq-param NAME=VALUE`` picks the
equation family, ``--integrator`` the time integrator (the leapfrog and
implicit-CG ones run ``heat3d_tpu_torch.timeint``), and ``python -m
heat3d_tpu_torch eqn list|show`` inspects the family registry
(``eqn.cli``). ``--time-blocking 0`` and ``--halo/--halo-plan/--fused-rdma
auto`` resolve through the tuning cache before the run starts; ``python -m
heat3d_tpu_torch tune run|show|apply|clear|lint`` searches, shows and
edits it (``tune.cli``; ``--batch-members B`` searches the ensemble
workload). ``python -m heat3d_tpu_torch serve --smoke|--requests
FILE|--bench`` runs the batched scenario engine (``serve.cli``).
``--mesh Px Py Pz`` splits the field into shards, by
default shard i on ``cuda:i``; without ``--mesh`` every visible GPU takes
a shard of a balanced 3D mesh, as the JAX CLI's default (one shard under
an explicit ``--device``). ``--device D`` puts every shard on D (``cpu``
runs the kernels' plain versions; ``cuda:0`` runs a sharded solve on one
card). ``--dump-slice AXIS INDEX PATH`` saves one global plane as
``.npy``, ``--dump-vtk PATH`` the final field as legacy VTK.
``--checkpoint DIR`` saves the final state (``--checkpoint-every K``: also
every K steps) in the JAX package's checkpoint format and ``--resume``
continues from it; ``--supervise`` runs under the resilience supervisor
(``--watchdog``, ``--max-recoveries``, ``--heal-mode``, ``--reexpand``):
checkpoint generations in DIR, auto-resume, recovery from backend loss,
and ``--steps`` the target global step, so relaunching a killed command
finishes its run. SIGTERM exits with code 3 after Python's cleanup. Runs on
the GPU unless ``--device cpu`` is given. Human-readable errors go to
stderr with exit code 2. ``--ledger PATH`` (or ``$HEAT3D_LEDGER``) appends
the run ledger, ``--profile DIR`` captures a ``torch.profiler`` trace of
warmup and the timed loop, and ``python -m heat3d_tpu_torch obs ...``
reads them back (``obs.cli``).

``--coordinator HOST:PORT --num-processes P --process-id p`` (or the
``HEAT3D_*`` variables, ``parallel.distributed``) runs one process per GPU,
the reference's ``mpirun -np P`` launch: each process owns a contiguous
block of the mesh's shards, the faces to other processes go device to
device through mapped peer memory when every rank is on one host, else
staged through host buffers (``parallel.wire``, ``HEAT3D_WIRE``), the
residual, the gather and the checkpoint go through ``torch.distributed``
(gloo), and only rank 0 writes the summary, the dumps and the golden
verdict. ``--supervise`` exits 2 across processes, and so do the routes
that store into peer device memory (``--halo dma``, ``--fused-rdma on``)
on the host wire.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import List, Optional

import numpy as np
import torch

from heat3d_tpu_torch import obs
from heat3d_tpu_torch.core.config import (
    BoundaryCondition,
    GridConfig,
    MeshConfig,
    Precision,
    RunConfig,
    SolverConfig,
    StencilConfig,
)
from heat3d_tpu_torch.eqn.cli import parse_eq_params
from heat3d_tpu_torch.parallel import distributed
from heat3d_tpu_torch.utils.logging import emit_json, get_logger
from heat3d_tpu_torch.utils.timing import force_sync, maybe_profile

log = get_logger("heat3d.cli")


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
    p.add_argument("--spacing", type=float, nargs=3, default=[1.0, 1.0, 1.0])
    p.add_argument("--alpha", type=float, default=1.0, help="thermal diffusivity")
    p.add_argument("--dt", type=float, default=None, help="time step (default 0.9x stable)")
    p.add_argument("--stencil", choices=["7pt", "27pt"], default="7pt")
    # equation-family choices come from the live registry
    from heat3d_tpu_torch.core.config import INTEGRATORS
    from heat3d_tpu_torch.eqn import FAMILIES

    p.add_argument(
        "--equation", choices=sorted(FAMILIES), default="heat",
        help="equation family the tap compiler lowers onto the stencil "
        "footprint (heat3d eqn list; docs/EQUATIONS.md). 'heat' is the "
        "legacy path, spec-authored",
    )
    p.add_argument(
        "--eq-param", action="append", default=[], metavar="NAME=VALUE",
        help="equation-family parameter override (repeatable), e.g. "
        "--eq-param vx=2.0; defaults per `heat3d eqn show FAMILY`",
    )
    p.add_argument(
        "--integrator", choices=list(INTEGRATORS), default="explicit-euler",
        help="time integrator (docs/INTEGRATORS.md): 'explicit-euler' "
        "(default, the tuned explicit route), 'leapfrog' (the wave "
        "family's two-level carry), 'implicit-cg' (matrix-free CG "
        "backward Euler — unconditionally stable, dt may exceed the "
        "explicit CFL bound; HEAT3D_CG_MAX_ITERS/HEAT3D_CG_TOL tune "
        "the solve)",
    )
    p.add_argument("--bc", choices=["dirichlet", "periodic"], default="dirichlet")
    p.add_argument("--bc-value", type=float, default=0.0)
    p.add_argument("--mesh", type=int, nargs="+", default=None,
                   help="mesh of shards Px Py Pz (one int = 1D slab; default: "
                   "every visible GPU, balanced 3D; 1 1 1 under --device): "
                   "shard i on cuda:i unless --device is given")
    p.add_argument("--halo", choices=["ppermute", "dma", "auto"], default="ppermute",
                   help="ghost-exchange transport between shards: slab copies "
                   "(ppermute), the DMA peer-write kernel, or 'auto' — "
                   "resolve through the tuning cache (python -m "
                   "heat3d_tpu_torch tune) with a ppermute fallback")
    p.add_argument("--halo-order", choices=["axis", "pairwise"],
                   default="axis",
                   help="halo-exchange ordering: 'axis' (x->y->z, "
                   "corner-propagating — required by 27pt) or 'pairwise' "
                   "(all six face permutes concurrent, stagger-tolerant; "
                   "7pt only — the tuner A/Bs the two)")
    p.add_argument("--overlap", action="store_true",
                   help="overlap the halo exchange with the interior sweep: "
                   "with --halo dma the fused DMA-overlap kernel (x-sharded "
                   "meshes; tb 1, and tb 2 on x-slabs), with ppermute "
                   "faces-direct (tb 1) or the interior/boundary split")
    p.add_argument("--halo-plan", choices=["monolithic", "partitioned", "auto"],
                   default="monolithic",
                   help="exchange-plan mode: each face copied whole, or as "
                   "sub-blocks (value-identical; pins the exchange path, "
                   "except for --fused-rdma on, whose sends ride it), or "
                   "'auto' (resolve through the tuning cache)")
    p.add_argument("--fused-rdma", choices=["off", "on", "auto"], default="off",
                   help="fused in-kernel RDMA step: the x-face pushes inside "
                   "the stencil kernel on the plan's sub-blocks (x-slab "
                   "meshes, --time-blocking <= 2, --halo ppermute); 'auto' "
                   "resolves through the tuning cache")
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
                   "route on the exchange path); k=0 = auto via the tuning "
                   "cache")
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
    p.add_argument(
        "--dump-slice", nargs=3, metavar=("AXIS", "INDEX", "PATH"),
        default=None,
        help="after the run, save one global 2D plane as .npy: axis x|y|z "
        "(or 0|1|2), global index along it, output path — the reference "
        "class's visualization dump",
    )
    p.add_argument(
        "--dump-vtk", default=None, metavar="PATH",
        help="after the run, write the final field as legacy binary VTK "
        "STRUCTURED_POINTS (ParaView/VisIt — the reference class's "
        "visualization dump). Gathers the full field to the host: meant "
        "for inspection-sized grids; use --dump-slice for planes of "
        "large fields",
    )
    p.add_argument("--checkpoint", default=None, help="checkpoint directory")
    p.add_argument("--checkpoint-every", type=int, default=0)
    p.add_argument("--resume", action="store_true", help="resume from --checkpoint")
    p.add_argument(
        "--supervise", action="store_true",
        help="run under the resilience supervisor: checkpoint generations "
        "every --checkpoint-every steps into --checkpoint, watchdog the "
        "backend, auto-resume from the last good generation (quarantining "
        "corrupt ones). --steps is then the TARGET GLOBAL step: relaunching "
        "the same command after a kill finishes the run",
    )
    p.add_argument(
        "--watchdog", type=float, default=None, metavar="SECONDS",
        help="(with --supervise) per-chunk wall-clock budget; an overrun "
        "triggers a backend probe and, if it fails, checkpoint-resume "
        "recovery",
    )
    p.add_argument(
        "--max-recoveries", type=int, default=3,
        help="(with --supervise) give up after this many survived failures",
    )
    p.add_argument(
        "--heal-mode", choices=["wait", "elastic", "auto"], default=None,
        help="(with --supervise) what a confirmed backend loss means: "
        "'wait' = probe until the ORIGINAL backend returns (the "
        "HEAT3D_HEAL_DEADLINE_S deadline re-raises), 'elastic' = probe the "
        "DEVICE SET and re-plan the moment any survivors answer: "
        "re-factorize the mesh over the survivors, re-stitch the newest "
        "generation onto the degraded mesh, continue; 'auto' = wait "
        "first, degrade when the heal deadline expires or the backend "
        "heals smaller. Default $HEAT3D_HEAL_MODE, else wait",
    )
    p.add_argument(
        "--reexpand", action="store_true",
        help="(with --supervise --heal-mode elastic|auto) opt-in "
        "re-expand: while degraded, probe at each checkpoint boundary "
        "and re-factorize back onto the original mesh when full "
        "capacity returns",
    )
    p.add_argument("--device", default=None,
                   help="torch device of every shard (default: shard i on "
                   "cuda:i; the current CUDA device for one shard)")
    p.add_argument("--profile", "--profile-dir", dest="profile_dir",
                   default=None, metavar="DIR",
                   help="capture a torch.profiler trace (Chrome-trace JSON, "
                   "Perfetto) of the timed region into DIR: CPU activity, "
                   "and the card's kernels and copies on a GPU run; the "
                   "artifact path and the capture overhead are recorded "
                   "into the run ledger as a profile_capture event. "
                   "--profile-dir is the legacy spelling")
    p.add_argument(
        "--ledger", default=None, metavar="PATH",
        help="append the run ledger (JSONL span/event stream) here; "
        "defaults to $HEAT3D_LEDGER; inspect with `python -m "
        "heat3d_tpu_torch obs summary PATH`",
    )
    p.add_argument("--coordinator", default=None,
                   help="multi-process coordinator HOST:PORT (rank 0's rendezvous)")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    return p


def _default_mesh(device) -> MeshConfig:
    """Every device of the world in a balanced 3D mesh (the JAX CLI's
    default over its devices): the GPUs each process sees times the
    processes; one shard per process under an explicit ``--device`` or
    without CUDA (where building the solver then names what is missing)."""
    procs = distributed.process_count()
    if device is not None or not torch.cuda.is_available():
        return MeshConfig.for_devices(procs) if procs > 1 else MeshConfig()
    return MeshConfig.for_devices(torch.cuda.device_count() * procs)


def config_from_args(args) -> SolverConfig:
    grid_shape = tuple(args.grid * 3 if len(args.grid) == 1 else args.grid)
    if len(grid_shape) != 3:
        raise ValueError("--grid takes 1 or 3 ints")
    if args.mesh is None:
        mesh = _default_mesh(args.device)
    elif len(args.mesh) in (1, 3):
        mesh = MeshConfig(shape=tuple(args.mesh + [1, 1] if len(args.mesh) == 1
                                      else args.mesh))
    else:
        raise ValueError("--mesh takes 1 or 3 ints")
    return SolverConfig(
        grid=GridConfig(shape=grid_shape, spacing=tuple(args.spacing),
                        alpha=args.alpha, dt=args.dt),
        mesh=mesh,
        halo=args.halo,
        halo_order=args.halo_order,
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
            checkpoint_path=args.checkpoint,
            checkpoint_every=args.checkpoint_every,
            residual_every=args.residual_every,
        ),
        time_blocking=args.time_blocking,
        backend=args.backend,
        equation=args.equation,
        eq_params=parse_eq_params(args.eq_param),
        integrator=args.integrator,
    )


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    # `obs ...`: the ledger-inspection and perf surface (summary, tail,
    # check, trace, roofline, timeline, regress, merge), dispatched before
    # the solver parser ever sees the argv
    if argv and argv[0] == "obs":
        from heat3d_tpu_torch.obs.cli import main as obs_main

        return obs_main(argv[1:])
    # `eqn list|show`: the equation registry's inspection surface
    if argv and argv[0] == "eqn":
        from heat3d_tpu_torch.eqn.cli import main as eqn_main

        return eqn_main(argv[1:])
    # `tune run|show|apply|clear|lint`: the autotuner
    if argv and argv[0] == "tune":
        from heat3d_tpu_torch.tune.cli import main as tune_main

        return tune_main(argv[1:])
    # `serve --smoke|--requests|--bench`: the batched scenario engine
    if argv and argv[0] == "serve":
        from heat3d_tpu_torch.serve.cli import main as serve_main

        return serve_main(argv[1:])
    try:
        rc = _main(argv)
    except (ValueError, RuntimeError) as e:
        print(f"heat3d_tpu_torch: error: {e}", file=sys.stderr)
        obs.deactivate(rc=2, error=f"{type(e).__name__}: {str(e)[:200]}")
        distributed.shutdown(clean=False)
        return 2
    except BaseException as e:
        # the ledger must record HOW the run ended even on crashes and
        # SIGTERM (SystemExit): close-with-error, then re-raise
        obs.deactivate(rc=1, error=f"{type(e).__name__}: {str(e)[:200]}")
        distributed.shutdown(clean=False)
        raise
    obs.export_at_exit()
    obs.deactivate(rc=rc)
    distributed.shutdown()
    return rc


def parse_dump_slice(spec, grid_shape):
    """``(axis, index, path)`` of ``--dump-slice AXIS INDEX PATH``, checked
    against the grid before the run (the JAX CLI's errors)."""
    axis_s, index_s, path = spec
    axis = {"x": 0, "y": 1, "z": 2}.get(axis_s.lower())
    if axis is None:
        try:
            axis = int(axis_s)
        except ValueError:
            raise ValueError(
                f"--dump-slice axis must be x|y|z or 0|1|2, got {axis_s!r}"
            ) from None
    if not 0 <= axis <= 2:
        raise ValueError(f"--dump-slice axis must be 0..2, got {axis}")
    try:
        index = int(index_s)
    except ValueError:
        raise ValueError(f"--dump-slice index must be an int, got {index_s!r}") from None
    if not 0 <= index < grid_shape[axis]:
        raise ValueError(
            f"--dump-slice index {index} outside grid extent "
            f"{grid_shape[axis]} on axis {axis}"
        )
    return axis, index, path


def _main(argv: Optional[List[str]]) -> int:
    from heat3d_tpu_torch.models.heat3d import HeatSolver3D

    args = build_parser().parse_args(argv)
    # the process group first, so each rank's ledger carries its proc; the
    # ledger before config validation, so a run dying on a bad config
    # still leaves a ledger_open and an rc=2 close
    distributed.initialize(args.coordinator, args.num_processes, args.process_id)
    ledger = obs.activate(args.ledger, meta={"entry": "solve"})
    cfg = config_from_args(args)
    # the auto knobs resolve through the tuning cache BEFORE run_start, so
    # the ledger records the route that runs; the hit/miss/stale event
    # lands just above it (fails soft to the static defaults)
    from heat3d_tpu_torch.tune.cache import resolve_config

    cfg = resolve_config(cfg, device=args.device)
    distributed.check_config(cfg)
    if args.supervise and distributed.process_count() > 1:
        # single-controller only, as in the JAX CLI
        raise ValueError(distributed.SUPERVISE_REFUSED)
    if args.golden_check and cfg.integrator != "explicit-euler":
        # the JAX CLI's exit, before the run here
        raise SystemExit(
            f"--golden-check covers the explicit-Euler oracle only "
            f"(integrator={cfg.integrator!r}); the per-integrator "
            "accuracy gates live in tests/test_timeint.py "
            "(docs/INTEGRATORS.md)"
        )
    if args.supervise:
        # a bad HEAT3D_HEAL_MODE fails here, in ms, not mid-outage
        from heat3d_tpu_torch.resilience.elastic import resolve_heal_mode

        args.heal_mode = resolve_heal_mode(args.heal_mode)
    ledger.event(
        "run_start",
        grid=list(cfg.grid.shape),
        stencil=cfg.stencil.kind,
        equation=cfg.equation,
        integrator=cfg.integrator,
        mesh=list(cfg.mesh.shape),
        dtype=cfg.precision.storage,
        backend=cfg.backend,
        halo=cfg.halo,
        halo_order=cfg.halo_order,
        halo_plan=cfg.halo_plan,
        fused_rdma=cfg.fused_rdma,
        overlap=cfg.overlap,
        time_blocking=cfg.time_blocking,
        steps=cfg.run.num_steps,
        supervise=bool(args.supervise),
        heal_mode=args.heal_mode,
    )
    dump_slice = (None if args.dump_slice is None
                  else parse_dump_slice(args.dump_slice, cfg.grid.shape))
    if args.dump_vtk and distributed.is_coordinator():
        # a bad path must fail in ms, not after the run
        try:
            with open(args.dump_vtk, "ab"):
                pass
        except OSError as e:
            raise ValueError(f"--dump-vtk path not writable: {e}") from None
    solver = HeatSolver3D(cfg, device=args.device)
    # the solver's config: a non-Euler integrator pins its auto knobs
    cfg = solver.cfg
    # one step_cost ledger event (the analytic bytes and operations of the
    # step program) so `obs summary` can print the run's achieved-vs-peak
    # line; telemetry fails soft, never the run
    try:
        from heat3d_tpu_torch.obs.perf.roofline import record_step_cost

        record_step_cost(solver)
    except Exception as e:  # noqa: BLE001 - telemetry fails soft
        print(f"warning: step_cost telemetry unavailable: {e}", file=sys.stderr)
    if args.supervise:
        return _main_supervised(args, cfg, solver, dump_slice)

    start_step = 0
    if args.resume and args.checkpoint:
        u, start_step = solver.load_checkpoint(args.checkpoint)
        log.info("resumed from %s at step %d", args.checkpoint, start_step)
    else:
        u = solver.init_state(args.init)
    # the bracket covers warmup + the timed loop (checkpoint and report IO
    # stay out of the trace); a failed run still closes and flushes it
    with maybe_profile(args.profile_dir, cuda=solver.device.type == "cuda"):
        u, elapsed, done, residual, launches, wired = _timed_run(
            args, cfg, solver, u, start_step)
    extra = None
    if distributed.process_count() > 1:
        # each rank's exchange between processes in the timed loop
        # (parallel.wire.totals: rounds, messages, bytes, host seconds)
        # and its transport (peer or host)
        from heat3d_tpu_torch.parallel import wire

        extra = {"process_wire": distributed.all_gather_object(
            dict(wired, transport=wire.transport()))}
    if args.checkpoint:
        solver.save_checkpoint(args.checkpoint, u, start_step + done)
    return _finish(args, cfg, solver, u, elapsed, start_step + done, start_step,
                   residual, dump_slice, launches, extra_summary=extra)


def _timed_run(args, cfg, solver, u, start_step):
    """Warmup + the timed stepping loop: ``(u, elapsed, steps done,
    residual, kernel launches of the loop, the loop's wire counts)``."""
    from heat3d_tpu_torch.ops import launch_counts
    from heat3d_tpu_torch.parallel import wire

    # warm up (kernel build and first launch) outside the timed window
    with obs.get().span("warmup"), obs.annotate("warmup"):
        solver.step_with_residual(solver.zeros_state())
        force_sync(solver)

    before, wire_before = launch_counts(), wire.totals()
    # One span for the whole timed region ("run_loop", with a `steps`
    # field): the loop syncs the device only at the END, so per-chunk
    # sub-spans would record launch time, not execution. The heat3d.run_loop
    # range marks the same window in a profile (obs/perf/timeline.py).
    with obs.get().span("run_loop", step_start=start_step) as run_span, \
            obs.annotate("run_loop"):
        u, elapsed, done, residual = _loop(args, cfg, solver, u, start_step)
        run_span.add(steps=done, elapsed_s=elapsed)
    after, wire_after = launch_counts(), wire.totals()
    if done:
        obs.REGISTRY.histogram(
            "step_latency_seconds",
            "per-step wall latency (chunk dur / steps)",
        ).observe(elapsed / done)
    return (u, elapsed, done, residual, {k: after[k] - before[k] for k in after},
            {k: wire_after[k] - wire_before[k] for k in wire_after})


def _loop(args, cfg, solver, u, start_step):
    residual = None
    t0 = time.perf_counter()
    if cfg.run.tolerance is not None:
        result = solver.run_to_convergence(
            u, tol=cfg.run.tolerance, max_steps=cfg.run.num_steps
        )
        u, done, residual = result.u, result.steps, result.residual
    else:
        total = cfg.run.num_steps
        every = args.checkpoint_every if args.checkpoint else 0
        done = 0
        while done < total:
            # to the next boundary: a residual point, a checkpoint point or
            # the end; the last update of the run (and of each residual
            # segment) is a residual step, so exactly `total` run
            boundaries = [total]
            if args.residual_every:
                boundaries.append((done // args.residual_every + 1) * args.residual_every)
            if every:
                boundaries.append((done // every + 1) * every)
            nxt = min(boundaries)
            n = nxt - done
            if nxt == total or (args.residual_every and nxt % args.residual_every == 0):
                if n > 1:
                    u = solver.run(u, n - 1)
                u, r2 = solver.step_with_residual(u)
                residual = float(np.sqrt(np.float64(float(r2))))
                if args.residual_every:
                    log.info("step %d residual %.6e", start_step + nxt, residual)
                obs.get().event("residual", step=start_step + nxt,
                                residual_l2=residual)
            else:
                u = solver.run(u, n)
            done = nxt
            if every and done % every == 0 and done < total:  # final save below
                solver.save_checkpoint(args.checkpoint, u, start_step + done)
    force_sync(solver)
    return u, time.perf_counter() - t0, done, residual


def _main_supervised(args, cfg, solver, dump_slice) -> int:
    """The --supervise path: the supervisor owns init/resume, checkpoint
    cadence and recovery; this wrapper owns the argument checks and the
    report (the JAX CLI's ``_main_supervised``)."""
    import os

    from heat3d_tpu_torch.ops import launch_counts
    from heat3d_tpu_torch.resilience.supervisor import generation_dirs
    from heat3d_tpu_torch.utils import checkpoint as ckpt

    if not args.checkpoint:
        raise ValueError("--supervise requires --checkpoint DIR")
    if os.path.exists(
        os.path.join(args.checkpoint, ckpt.MANIFEST)
    ) and not generation_dirs(args.checkpoint):
        # a plain (flat) checkpoint lives here; the supervisor only scans
        # gen-* generations, so proceeding would silently restart at step
        # 0 and orphan the user's progress
        raise ValueError(
            f"--checkpoint {args.checkpoint} holds a plain checkpoint, "
            "not supervised generations — finish it with --resume "
            "(without --supervise), or point --supervise at a fresh "
            "directory"
        )
    if args.resume:
        print("--resume is implied by --supervise (auto-resumes from the "
              "newest good generation)", file=sys.stderr)
    if cfg.run.tolerance is not None:
        raise ValueError(
            "--supervise drives the fixed-step loop; convergence mode "
            "(--tol) is not supervised yet — drop one of the two flags"
        )
    if cfg.run.residual_every:
        print("warning: --residual-every is not supported under --supervise "
              "yet; only the final residual is reported", file=sys.stderr)
    if not args.checkpoint_every:
        print("warning: --supervise without --checkpoint-every K writes no "
              "mid-run generations: an outage loses the whole run, not K "
              "steps", file=sys.stderr)
    before = launch_counts()
    t0 = time.perf_counter()
    with maybe_profile(args.profile_dir, cuda=solver.device.type == "cuda"):
        result = solver.run_supervised(
            total_steps=cfg.run.num_steps,
            ckpt_root=args.checkpoint,
            checkpoint_every=args.checkpoint_every,
            watchdog_s=args.watchdog,
            max_recoveries=args.max_recoveries,
            init=args.init,
            heal_mode=args.heal_mode,
            reexpand=args.reexpand,
            # the device type this run STARTED on: a probe child that finds
            # no GPU must never count as a healed card
            want_platform=solver.device.type,
        )
    elapsed = time.perf_counter() - t0
    after = launch_counts()
    # heal waits are SLEEP, not work: left out of the throughput
    # denominator (each recovery's wait is itemized in the record); what
    # remains includes the kernels' build and any redone steps
    heal_s = sum(r.heal_wait_s for r in result.recoveries)
    busy = max(elapsed - heal_s, 1e-9)
    record = result.to_record()
    record["timing_note"] = (
        "seconds excludes heal waits but includes the kernel build and "
        "redone steps; not comparable to bench rows"
    )
    # report through the solver that PRODUCED u: a recovery may have
    # rebuilt it on another mesh
    final_solver = result.solver or solver
    return _finish(args, final_solver.cfg, final_solver, result.u, busy,
                   result.steps_done, result.start_step, result.residual, dump_slice,
                   {k: after[k] - before[k] for k in after},
                   extra_summary={"supervised": record})


def _finish(args, cfg, solver, u, elapsed, steps_done, start_step, residual,
            dump_slice, kernel_launches, extra_summary=None) -> int:
    """The report shared by the plain and supervised paths: dumps, the JSON
    summary (``steps`` counts this run's updates, the golden check the
    total from t=0)."""
    from heat3d_tpu_torch.models.heat3d import resolved_backend_name
    from heat3d_tpu_torch.parallel.plan import effective_halo_plan
    from heat3d_tpu_torch.parallel.step import (
        resolve_fused_rdma,
        step_route,
        superstep_route,
    )

    steps = steps_done - start_step
    # a rate from a CPU run is not a device metric: reported only on the GPU
    on_gpu = solver.device.type == "cuda"
    rate = cfg.grid.num_cells * max(steps, 1) / elapsed / 1e9 if on_gpu else None
    procs = distributed.process_count()
    devices = {s.device for s in solver.mesh.local_shards}
    summary = {
        "grid": list(cfg.grid.shape),
        "stencil": cfg.stencil.kind,
        "equation": cfg.equation,
        "integrator": cfg.integrator,
        "mesh": list(cfg.mesh.shape),
        "halo": cfg.halo,
        "halo_order": cfg.halo_order,
        "overlap": cfg.overlap,
        "halo_plan": effective_halo_plan(cfg),
        "fused_rdma": resolve_fused_rdma(cfg),
        "shards_per_device": len(solver.mesh.local_shards) // len(devices),
        "step_route": step_route(cfg),
        "superstep_route": superstep_route(cfg) if cfg.time_blocking > 1 else None,
        "dtype": cfg.precision.storage,
        "compute_dtype": cfg.precision.compute,
        "backend": resolved_backend_name(cfg),
        "time_blocking": cfg.time_blocking,
        "platform": "gpu" if on_gpu else "cpu",
        "device_name": torch.cuda.get_device_name(solver.device) if on_gpu else "cpu",
        "steps": steps,
        "seconds": elapsed,
        "residual_l2": residual,
        "gcell_updates_per_sec": rate,
        "gcell_updates_per_sec_per_chip": (None if rate is None
                                           else rate / (len(devices) * procs)),
        "kernel_launches": kernel_launches,
    }
    if procs > 1:
        # the world and each rank's own launches (rank order)
        summary["processes"] = procs
        summary["process_kernel_launches"] = distributed.all_gather_object(kernel_launches)
    if solver.last_cg_stats is not None:
        # the last implicit-cg solve of the run's fixed-step loop
        summary["cg_iters"], summary["cg_relres"] = solver.last_cg_stats
    # gathers are collectives every rank joins; rank 0 alone writes
    coordinator = distributed.is_coordinator()
    if dump_slice is not None:
        axis, index, path = dump_slice
        plane = solver.gather_slice(u, axis, index)
        if coordinator:
            np.save(path, plane)
        summary["slice_path"] = path
    if args.dump_vtk:
        from heat3d_tpu_torch.utils.vtkio import write_structured_points

        full = solver.gather(u)
        if coordinator:
            write_structured_points(args.dump_vtk, full, spacing=cfg.grid.spacing)
        summary["vtk_path"] = args.dump_vtk
    if extra_summary:
        summary.update(extra_summary)
    got = solver.gather(u) if args.golden_check else None
    if args.golden_check and coordinator:
        from heat3d_tpu_torch import eqn
        from heat3d_tpu_torch.core import golden

        # steps_done counts from t=0 even on --resume: the oracle advances
        # the original init by the run's TOTAL step count
        g = golden.run(
            golden.make_init(args.init, cfg.grid.shape, seed=cfg.run.seed),
            cfg.grid, cfg.stencil, steps_done, taps=eqn.solver_taps(cfg),
        )
        got = got.astype(np.float64)
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
    # the ledger's run_summary mirrors the stdout JSON, followed by the
    # final per-run metrics record
    obs.get().event("run_summary", **summary)
    obs.get().event("metrics_summary", metrics=obs.REGISTRY.snapshot())
    if coordinator:
        emit_json(summary)
    return 0


def run() -> int:
    """The program's entry (``python -m heat3d_tpu_torch``): SIGTERM (a
    ``timeout``) exits with code 3 after Python's cleanup, so a supervised
    run relaunched with the same command resumes from its generations."""
    from heat3d_tpu_torch.utils.backendprobe import install_sigterm_exit

    install_sigterm_exit()
    return main()


if __name__ == "__main__":
    sys.exit(run())
