"""``python -m heat3d_tpu_torch.bench`` — the judged benchmark rows as JSON.

Takes the solver command line's config flags (--grid, --stencil, --bc,
--dtype, --time-blocking, --mesh, --halo, --halo-order, --halo-plan,
--device, --steps, ...) plus --bench all|throughput|halo (default all: the
throughput row, then the halo row), --repeats (throughput runs) and
--iters (halo programs), and prints one JSON row per line. ``--sweep-state
FILE`` journals the rows of ``--bench all`` (``resilience.sweepstate``): an
interrupted sweep resumes at the first missing row. SIGTERM exits with
code 3. Needs a CUDA device. ``--ledger PATH`` (or ``$HEAT3D_LEDGER``)
mirrors each row into the run ledger (``bench_row``, the measure spans,
the metrics summary); ``--profile DIR`` (``--profile-dir``) captures a
``torch.profiler`` trace of the measurement."""

from __future__ import annotations

import argparse
import json
import sys

from heat3d_tpu_torch.bench.harness import bench_halo, bench_throughput, run_suite
from heat3d_tpu_torch.cli import build_parser, config_from_args


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="heat3d_tpu_torch.bench", parents=[build_parser()],
        add_help=False, conflict_handler="resolve",
    )
    p.add_argument("--bench", choices=["all", "throughput", "halo"], default="all")
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument("--iters", type=int, default=30, help="halo timing iterations")
    p.add_argument(
        "--sweep-state", default=None, metavar="FILE",
        help="journal landed rows here (resilience.sweepstate); an "
        "interrupted --bench all sweep resumes at the first missing row",
    )
    args = p.parse_args(argv)

    from heat3d_tpu_torch import obs
    from heat3d_tpu_torch.utils.timing import maybe_profile

    # --ledger comes in through the inherited solver parser; the env
    # fallback ($HEAT3D_LEDGER) threads ONE ledger through every row's
    # subprocess. Activated BEFORE config validation, so a row dying on a
    # bad config still leaves a record.
    obs.activate(args.ledger, meta={"entry": "bench", "bench": args.bench})
    try:
        cfg = config_from_args(args)
        # the card's activity unless the rows run elsewhere (None: the build's)
        cuda = None if args.device is None else str(args.device).startswith("cuda")
        with maybe_profile(args.profile_dir, cuda=cuda):
            if args.bench == "throughput":
                print(json.dumps(bench_throughput(cfg, steps=args.steps,
                                                  repeats=args.repeats,
                                                  device=args.device)))
            elif args.bench == "halo":
                print(json.dumps(bench_halo(cfg, iters=args.iters, device=args.device)))
            else:
                run_suite([cfg], steps=args.steps, device=args.device, iters=args.iters,
                          repeats=args.repeats, state_path=args.sweep_state)
    except BaseException as e:
        # the ledger must record HOW the row ended: a SIGTERM'd
        # (SystemExit) or crashed row closing with rc=0 would read as a
        # clean run in the post-mortem
        obs.deactivate(rc=1, error=f"{type(e).__name__}: {str(e)[:200]}")
        raise
    obs.get().event("metrics_summary", metrics=obs.REGISTRY.snapshot())
    obs.export_at_exit()
    obs.deactivate(rc=0)
    return 0


if __name__ == "__main__":
    # a row stopped by `timeout` (SIGTERM) exits 3 after Python's cleanup
    from heat3d_tpu_torch.utils.backendprobe import install_sigterm_exit

    install_sigterm_exit()
    sys.exit(main())
