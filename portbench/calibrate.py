"""The readings that the comparison's limits are set from, in one process.

    python3 -m portbench.calibrate --workload <cell> --seeds 101,102,... \\
        --control-seeds 201,202,203 [--seconds S] [--out FILE]

For each seed of ``--seeds`` it makes a run of the cell as the benchmark
makes it (set-up, a window of ``--seconds`` that reaches the checked chunk,
the comparison) and prints its numbers: the largest over the seeds is the
lower reading of each. For each seed of ``--control-seeds`` it makes the
same run with the control in the program's place (the ``control`` of the
configuration's system module): the smallest is the upper reading. The limits
in ``limits/<cell>.json`` lie between the two. Needs the card, as a run
does; ``--out`` appends one JSON line a run.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m portbench.calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--out")
    args = p.parse_args(argv)

    from portbench import cells, run

    run.fix_environment(cells.ROOT)
    import torch

    if not torch.cuda.is_available():
        print("portbench.calibrate: needs a CUDA card", file=sys.stderr)
        return 2
    bench = cells.load_benchmark()
    cell = cells.workload(bench, args.workload)
    control = cells.system(cells.config(bench, cell["config"])).control
    sides = [("program", None, args.seeds), ("control", control, args.control_seeds)]
    readings = {}
    for side, make, seeds in sides:
        for seed in (int(s) for s in seeds.split(",") if s):
            t0 = time.perf_counter()
            res = run.measure(bench, cell, seed, args.seconds, False, "cuda", t0, make_solver=make)
            line = {"workload": args.workload, "side": side, "seed": seed,
                    "correct": res["correct"], "checks": res["checks"],
                    "seconds": time.perf_counter() - t0}
            print(json.dumps(line), flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(json.dumps(line) + "\n")
            for name, c in res["checks"].items():
                readings.setdefault(side, {}).setdefault(name, []).append(c["value"])
    summary = {"workload": args.workload,
               "lower": {k: max(v) for k, v in readings.get("program", {}).items()},
               "upper": {k: min(v) for k, v in readings.get("control", {}).items()}}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
