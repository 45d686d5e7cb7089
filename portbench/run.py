"""One run of one cell of the benchmark.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds the program (``heat3d_tpu_torch``)
beside ``BENCHMARK.json`` and ``portbench/``. It needs as many CUDA cards
as the cell asks for and never falls back to the CPU. The last line of
standard output is one JSON object: ``correct``, ``attempted`` (chunks run
in the window), ``failed`` (checked answers out of their limits),
``metrics`` (the cell's end-to-end metrics; with ``--trace 1`` its
per-layer ones), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``: each number compared with its limit, which also close
standard error.

The run fixes its environment: every ``HEAT3D_*`` variable is cleared and
``HEAT3D_TUNE_DISABLE=1`` set (no tuning store moves the route); the
kernels build into the program's own ``_build/`` in the checkout, and any
Triton or extension cache goes to ``.portbench_cache/`` there.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# top-level module names the process must not hold once the window closes
FORBIDDEN = ("jax", "jaxlib", "flax", "heat3d_tpu")


def fix_environment(root: Path) -> None:
    for key in [k for k in os.environ if k.startswith("HEAT3D_")]:
        del os.environ[key]
    os.environ["HEAT3D_TUNE_DISABLE"] = "1"
    os.environ["USE_FLAX"] = "0"
    cache = root / ".portbench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def measure(bench: dict, cell: dict, seed: int, seconds: float, trace: bool, device: str,
            t_start: float, make_solver=None, grid=None, marks: dict = None) -> dict:
    """Drive the cell, read its metrics, compare its answers: the result's
    fields. ``make_solver`` and ``grid`` stand in for the program and the
    configuration's grid in tests and in the control;
    ``marks`` (host seconds since ``t_start``) go to standard error."""
    import torch

    from portbench import cells, check, drive

    config = cells.config(bench, cell["config"])
    mix = cells.mix(cell["traffic"])
    limits = cells.limits(cell["name"])
    run = drive.drive(config, mix, seed, seconds, trace, device, t_start,
                      make_solver=make_solver, grid=grid)
    ctx = {"config": config, "mix": mix, "run": run, "gpus": cell["chips"],
           "grid": tuple(grid or config["grid"])}
    metrics = {}
    for m in cells.metrics(bench, cell["name"], trace):
        value = cells.reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    t_ref = time.perf_counter()
    correct, failed, worst = check.judge(check.compare(config, mix, seed, run, device, grid),
                                         limits)
    parts = " ".join(f"{k} {v:.3f}" for k, v in {**(marks or {}), **run.setup_parts}.items())
    print(f"portbench: set-up {run.setup_s:.3f} s ({parts}); window {run.window_s:.3f} s, "
          f"{run.updates} updates, checked chunk {run.sample_chunk}; reference "
          f"{time.perf_counter() - t_ref:.3f} s", file=sys.stderr)
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": torch.cuda.get_device_name(0) if device == "cuda" else device,
           "count": cell["chips"], "memory_peak_bytes": run.memory_peak_bytes}
    result = {"correct": correct, "attempted": run.chunks, "failed": failed,
              "metrics": metrics, "device": dev}
    if trace and run.activity is not None:
        act = run.activity
        dev["busy_s"], dev["window_s"] = act["busy_s"], act["window_s"]
        ops = sorted(act["ops"].items(), key=lambda kv: -kv[1])[:10]
        result["breakdown"] = {"device_ops": [[k, v] for k, v in ops],
                               "idle_gaps": [[k, v] for k, v in act["gaps"][:10]]}
    # a number that is not finite prints as text, so the line stays JSON
    result["checks"] = {name: {"value": v if math.isfinite(v) else str(v), "limit": lim}
                        for name, (v, lim) in worst.items()}
    return result


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python3 -m portbench.run", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    from portbench import cells

    fix_environment(cells.ROOT)
    import torch

    marks = {"import_torch": time.perf_counter() - _T0}
    bench = cells.load_benchmark()
    cell = cells.workload(bench, args.workload)
    try:
        import heat3d_tpu_torch
    except ImportError as e:
        print(f"portbench: the program is not in this checkout: {e}", file=sys.stderr)
        return 2
    marks["import_program"] = time.perf_counter() - _T0
    where = Path(heat3d_tpu_torch.__file__).resolve()
    if cells.ROOT not in where.parents:
        print(f"portbench: the program must come from this checkout ({cells.ROOT}), "
              f"not {where}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: {args.workload} needs {cell['chips']} CUDA card(s); "
              f"this process sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    marks["context"] = time.perf_counter() - _T0
    result = measure(bench, cell, args.seed, args.seconds, bool(args.trace), "cuda", _T0,
                     marks=marks)
    found = forbidden_modules()
    if found:
        print(f"portbench: the process holds {', '.join(found)}; the port must not load them",
              file=sys.stderr)
        return 3
    from portbench.roofline import card

    checks = result.pop("checks")
    result["card"] = card()
    result["checks"] = checks
    print(f"portbench: {args.workload} seed {args.seed} on {result['card']}", file=sys.stderr)
    for name, c in result["checks"].items():
        verdict = "ok" if isinstance(c["value"], float) and c["value"] <= c["limit"] else "FAIL"
        print(f"check {name} {c['value']!r} limit {c['limit']!r} {verdict}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
