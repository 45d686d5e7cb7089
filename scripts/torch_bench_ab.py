#!/usr/bin/env python3
"""A/B of the port's throughput rows between two checkouts on one card.

    python3 scripts/torch_bench_ab.py A_DIR B_DIR [--rounds 1] -- <bench flags>

Runs ``python -m heat3d_tpu_torch.bench <bench flags>`` from checkout A,
then B, B, A (``--rounds`` times), each a fresh process that builds its own
kernels, and prints one JSON line per run (checkout, Gcell-updates/s, ms
per superstep, route) and one summary line with each checkout's runs.
Separate bench configs are separate invocations. Needs a CUDA device;
compare two versions only within one call on one card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys


def run(checkout: str, flags) -> dict:
    proc = subprocess.run(
        [sys.executable, "-m", "heat3d_tpu_torch.bench", *flags],
        cwd=checkout, capture_output=True, text=True, timeout=900,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"bench in {checkout} failed ({proc.returncode}):\n"
                           f"{proc.stderr[-3000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("a")
    p.add_argument("b")
    p.add_argument("--rounds", type=int, default=1)
    p.add_argument("flags", nargs=argparse.REMAINDER)
    args = p.parse_args(argv)
    flags = args.flags[1:] if args.flags[:1] == ["--"] else args.flags
    runs = {"a": [], "b": []}
    for _ in range(args.rounds):
        for side in ("a", "b", "b", "a"):
            row = run(getattr(args, side), flags)
            rate = row["gcell_updates_per_sec"]
            runs[side].append(rate)
            print(json.dumps({"checkout": side, "dir": getattr(args, side), "flags": flags,
                              "gcell_updates_per_sec": rate,
                              "ms_per_superstep": row["ms_per_launch"],
                              "route": row["superstep_route"] or row["step_route"],
                              "device_name": row["device_name"]}), flush=True)
    print(json.dumps({"flags": flags, "a": runs["a"], "b": runs["b"],
                      "b_over_a": sum(runs["b"]) / sum(runs["a"])}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
