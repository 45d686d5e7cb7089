"""``python -m heat3d_tpu_torch.bench`` — one throughput row as JSON.

Takes the solver command line's config flags (--grid, --stencil, --bc,
--dtype, --time-blocking, --mesh, --halo, --device, --steps, ...) plus
--repeats, and prints one JSON row. Needs a CUDA device."""

from __future__ import annotations

import argparse
import json
import sys

from heat3d_tpu_torch.bench.harness import bench_throughput
from heat3d_tpu_torch.cli import build_parser, config_from_args


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="heat3d_tpu_torch.bench", parents=[build_parser()],
        add_help=False, conflict_handler="resolve",
    )
    p.add_argument("--repeats", type=int, default=3)
    args = p.parse_args(argv)
    cfg = config_from_args(args)
    print(json.dumps(bench_throughput(cfg, steps=args.steps, repeats=args.repeats,
                                      device=args.device)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
