"""``python -m heat3d_tpu_torch serve`` — the synchronous solver-as-a-service
front end.

Port of ``heat3d_tpu.serve.cli`` (its synchronous modes, record parsing,
result lines and smoke requests)::

    serve --smoke [--device cpu]          # tiny 3-request, 2-bucket batch
    serve --requests FILE.jsonl           # submit scenarios, stream results
    serve --bench [--members B] [--row FILE]   # one ensemble throughput row

``--requests`` reads one scenario per JSONL line::

    {"grid": 64, "stencil": "7pt", "bc": "dirichlet", "bc_value": 1.0,
     "alpha": 0.5, "dt": null, "steps": 100, "init": "hot-cube",
     "seed": 0, "mesh": [1, 1, 1], "dtype": "fp32",
     "time_blocking": 1}

Requests sharing a structural bucket (grid/stencil/bc/mesh/dtype/knobs)
pack into one batch; results stream to stdout as JSON lines in submission
order (``--out DIR`` also saves each final field as ``req-<id>.npy``).
Ledger events (``serve_submit`` / ``serve_batch_start`` / ``serve_batch``
/ ``serve_result`` / ``serve_metrics_summary``) and queue metrics land in
the run ledger and metrics registry as at every other entry point.
``--device`` places every shard (``cpu``: the plain chain on the host;
default: the card). ``--row FILE`` appends the ``--bench`` row to FILE.

The always-on modes exit 2 with a "not ported yet" line naming the JAX
package's modules they need: ``--async``, ``--workers``, ``--no-aot``,
``--verdict`` (``serve/engine/``, ``serve/aot.py``); ``--loadgen``,
``--duration``, ``--monitor``, ``--abort-on-burn`` (``serve/loadgen.py``,
``obs/burn.py``); ``--slo`` and ``$HEAT3D_SLO_SPEC``
(``obs/perf/slo.py``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

import numpy as np

from heat3d_tpu_torch import obs
from heat3d_tpu_torch.utils.logging import get_logger

log = get_logger("heat3d.serve")

# flag (as its argparse dest) -> the JAX package's modules it needs
NOT_PORTED = {
    "async_": ("--async", "serve/engine/ and serve/aot.py"),
    "workers": ("--workers", "serve/engine/ and serve/aot.py"),
    "no_aot": ("--no-aot", "serve/engine/ and serve/aot.py"),
    "verdict": ("--verdict", "serve/engine/ and serve/aot.py"),
    "loadgen": ("--loadgen", "serve/loadgen.py and obs/burn.py"),
    "duration": ("--duration", "serve/loadgen.py and obs/burn.py"),
    "monitor": ("--monitor", "serve/loadgen.py and obs/burn.py"),
    "abort_on_burn": ("--abort-on-burn", "serve/loadgen.py and obs/burn.py"),
    "slo": ("--slo", "obs/perf/slo.py"),
}


def _base_from_record(rec: dict):
    from heat3d_tpu_torch.core.config import (
        BoundaryCondition,
        GridConfig,
        MeshConfig,
        Precision,
        RunConfig,
        SolverConfig,
        StencilConfig,
    )

    grid = rec.get("grid", 64)
    shape = tuple(grid if isinstance(grid, list) else [grid] * 3)
    mesh = rec.get("mesh")
    if mesh is None:
        mesh_cfg = MeshConfig()
    elif isinstance(mesh, list) and len(mesh) == 3:
        mesh_cfg = MeshConfig(shape=tuple(mesh))
    else:
        raise ValueError(f"request mesh must be [Px, Py, Pz], got {mesh!r}")
    dtype = rec.get("dtype", "fp32")
    return SolverConfig(
        grid=GridConfig(
            shape=shape, spacing=tuple(rec.get("spacing", (1.0, 1.0, 1.0)))
        ),
        stencil=StencilConfig(
            kind=rec.get("stencil", "7pt"),
            bc=BoundaryCondition(rec.get("bc", "dirichlet")),
        ),
        mesh=mesh_cfg,
        precision=Precision.bf16() if dtype == "bf16" else Precision.fp32(),
        run=RunConfig(num_steps=int(rec.get("steps", 100))),
        backend="jnp",
        halo="ppermute",
        time_blocking=int(rec.get("time_blocking", 1)),
        # equation family is STRUCTURAL (it shapes the chain, so it
        # buckets); the member-level eq_params below stay per-member values
        equation=rec.get("equation", "heat"),
    )


def _eq_pairs(rec: dict) -> tuple:
    ep = rec.get("eq_params") or {}
    if not isinstance(ep, dict):
        raise ValueError(
            f"request eq_params must be an object of name -> value, got "
            f"{ep!r}"
        )
    return tuple(sorted((str(k), float(v)) for k, v in ep.items()))


def _scenario_from_record(rec: dict):
    from heat3d_tpu_torch.serve.scenario import Scenario

    # coef_field arrives as ["name", seed, lo, hi] or a bare "name";
    # integrator as a string. Both bucket the request apart from plain
    # ones (scenario.request_bucket_key).
    cf = rec.get("coef_field")
    if isinstance(cf, str):
        cf = (cf,)
    elif cf is not None:
        cf = tuple(cf)
    return Scenario(
        init=rec.get("init", "hot-cube"),
        alpha=float(rec.get("alpha", 1.0)),
        dt=rec.get("dt"),
        bc_value=float(rec.get("bc_value", 0.0)),
        steps=rec.get("steps"),
        seed=int(rec.get("seed", 0)),
        eq_params=_eq_pairs(rec),
        integrator=rec.get("integrator"),
        coef_field=cf,
    )


def _result_line(r, out_dir: Optional[str]) -> dict:
    line = {
        "request_id": r.request_id,
        "steps": r.steps,
        "batch_members": r.batch_size,
        "queue_latency_s": round(r.queue_latency_s, 6),
        "field_mean": float(np.mean(np.asarray(r.field, np.float64))),
        "field_max": float(np.max(np.asarray(r.field, np.float64))),
    }
    if r.residual_sumsq is not None:
        line["residual_sumsq"] = r.residual_sumsq
    if r.snapshots is not None:
        line["snapshots"] = len(r.snapshots)
    if out_dir:
        path = os.path.join(out_dir, f"req-{r.request_id}.npy")
        np.save(path, r.field)
        line["field_path"] = path
    return line


def _smoke_requests() -> List[dict]:
    # two heterogeneous scenarios in one bucket + one in a second bucket:
    # exercises packing AND bucket separation in under a second on CPU
    return [
        {"grid": 16, "steps": 4, "alpha": 0.5, "bc_value": 1.0, "seed": 1},
        {"grid": 16, "steps": 6, "alpha": 0.8, "init": "gaussian", "seed": 2},
        {"grid": 12, "steps": 3, "alpha": 0.3},
    ]


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="heat3d_tpu_torch serve",
        description="batched scenario engine: queue scenario requests, "
        "pack shape-bucketed batches, stream per-member results",
    )
    p.add_argument("--requests", default=None, metavar="FILE.jsonl",
                   help="scenario submissions, one JSON object per line")
    p.add_argument("--smoke", action="store_true",
                   help="run a built-in tiny multi-bucket batch")
    p.add_argument("--bench", action="store_true",
                   help="measure one ensemble throughput row "
                   "(batch_shape/members_per_step provenance) and print it")
    p.add_argument("--row", default=None, metavar="FILE.jsonl",
                   help="(--bench) also append the row to this JSONL file")
    p.add_argument("--members", type=int, default=4,
                   help="(--bench) ensemble members")
    p.add_argument("--grid", type=int, default=32,
                   help="(--bench) grid edge")
    p.add_argument("--steps", type=int, default=20,
                   help="(--bench) step floor per trial")
    p.add_argument("--batch-mesh", type=int, default=1,
                   help="devices along the batch axis (the shards factorize "
                   "b x space; 1 = all spatial)")
    p.add_argument("--max-batch", type=int, default=None,
                   help="members per packed batch cap "
                   "(default $HEAT3D_SERVE_MAX_BATCH or 64)")
    p.add_argument("--snapshot-every", type=int, default=0,
                   help="stream per-member field snapshots every K steps "
                   "(0 = final field only)")
    p.add_argument("--residuals", action="store_true",
                   help="report each member's residual sum-of-squares "
                   "(one extra update per member)")
    p.add_argument("--out", default=None, metavar="DIR",
                   help="save each final field as DIR/req-<id>.npy")
    p.add_argument("--ledger", default=None,
                   help="run ledger path (default $HEAT3D_LEDGER)")
    p.add_argument("--device", default=None,
                   help="torch device of every shard (cpu: the plain chain "
                   "on the host; cuda:0: every shard on one card); default "
                   "shard i on cuda:i")
    # the always-on modes of the JAX front end: refused (NOT_PORTED)
    p.add_argument("--async", dest="async_", action="store_true",
                   help="(not ported yet) the async engine")
    p.add_argument("--workers", type=int, default=None,
                   help="(not ported yet) async engine workers")
    p.add_argument("--no-aot", action="store_true",
                   help="(not ported yet) async engine without its cache")
    p.add_argument("--verdict", action="store_true",
                   help="(not ported yet) the async engine's verdict line")
    p.add_argument("--loadgen", default=None, metavar="SPEC.json",
                   help="(not ported yet) the sustained-traffic soak")
    p.add_argument("--duration", type=float, default=None,
                   help="(not ported yet) the soak's duration")
    p.add_argument("--monitor", action="store_true",
                   help="(not ported yet) live SLO burn-rate monitoring")
    p.add_argument("--abort-on-burn", action="store_true",
                   help="(not ported yet) end the soak on an SLO burn")
    p.add_argument("--slo", default=None, metavar="SPEC.json",
                   help="(not ported yet) evaluate service-level objectives")
    return p


def _refused(args) -> Optional[str]:
    """The "not ported yet" line of the first refused flag (or of
    ``$HEAT3D_SLO_SPEC``) the command asks for, or None."""
    for dest, (flag, modules) in NOT_PORTED.items():
        if getattr(args, dest) not in (None, False):
            break
    else:
        if not os.environ.get("HEAT3D_SLO_SPEC"):
            return None
        flag, modules = "$HEAT3D_SLO_SPEC", NOT_PORTED["slo"][1]
    return (f"heat3d serve: {flag}: not ported yet (heat3d_tpu_torch has no "
            f"counterpart of the JAX package's {modules})")


def main(argv: Optional[List[str]] = None) -> int:
    args = _parser().parse_args(argv)
    msg = _refused(args)
    if msg is not None:
        print(msg, file=sys.stderr)
        return 2
    obs.activate(args.ledger, meta={"entry": "serve"})
    try:
        rc = _main(args)
    except (ValueError, TypeError, NotImplementedError, RuntimeError) as e:
        # TypeError covers malformed request VALUES (a JSON null where a
        # number belongs: int(None)): the same clean exit as any other bad
        # request, not a traceback
        print(f"heat3d serve: error: {e}", file=sys.stderr)
        obs.deactivate(rc=2, error=f"{type(e).__name__}: {str(e)[:200]}")
        return 2
    except BaseException as e:
        obs.deactivate(rc=1, error=f"{type(e).__name__}: {str(e)[:200]}")
        raise
    obs.export_at_exit()
    obs.deactivate(rc=rc)
    return rc


def _main(args) -> int:
    if args.bench:
        from heat3d_tpu_torch.core.config import GridConfig, SolverConfig
        from heat3d_tpu_torch.serve.bench import bench_ensemble_throughput
        from heat3d_tpu_torch.serve.scenario import Scenario, ScenarioBatch

        base = SolverConfig(grid=GridConfig.cube(args.grid), backend="jnp")
        members = [
            Scenario(alpha=0.3 + 0.4 * (m + 1) / args.members, seed=m)
            for m in range(args.members)
        ]
        row = bench_ensemble_throughput(
            ScenarioBatch(base, members),
            steps=args.steps,
            batch_mesh=args.batch_mesh,
            device=args.device,
        )
        print(json.dumps(row))
        if args.row:
            with open(args.row, "a") as f:
                f.write(json.dumps(row) + "\n")
        return 0

    if args.smoke:
        records = _smoke_requests()
    elif args.requests:
        records = []
        with open(args.requests) as f:
            for i, line in enumerate(f, start=1):
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError as e:
                    raise ValueError(
                        f"{args.requests}:{i}: unparseable request: {e}"
                    ) from None
                if not isinstance(rec, dict):
                    raise ValueError(
                        f"{args.requests}:{i}: request must be a JSON object"
                    )
                records.append(rec)
        if not records:
            raise ValueError(f"{args.requests}: no requests")
    else:
        print(
            "heat3d serve: need --requests FILE, --smoke, or --bench",
            file=sys.stderr,
        )
        return 2

    if args.out:
        os.makedirs(args.out, exist_ok=True)
    n = _serve_sync(args, records)
    if n != len(records):
        print(
            f"heat3d serve: delivered {n} of {len(records)} requests",
            file=sys.stderr,
        )
        return 1
    log.info("serve: %d result(s) streamed", n)
    return 0


def _serve_sync(args, records) -> int:
    """The submit-then-drain path (``ScenarioQueue``); returns the number
    of results streamed."""
    from heat3d_tpu_torch.serve.queue import ScenarioQueue

    queue = ScenarioQueue(
        max_batch=args.max_batch,
        batch_mesh=args.batch_mesh,
        snapshot_every=args.snapshot_every,
        with_residuals=args.residuals,
        device=args.device,
    )
    for rec in records:
        queue.submit(_base_from_record(rec), _scenario_from_record(rec))
    log.info("serve: %d request(s) queued", len(queue))
    n = 0
    for r in queue.drain():
        print(json.dumps(_result_line(r, args.out)), flush=True)
        n += 1
    return n


if __name__ == "__main__":
    sys.exit(main())
