"""``python -m heat3d_tpu_torch serve`` — the solver-as-a-service front end.

Port of ``heat3d_tpu.serve.cli`` (every mode, record parsing, result
lines, smoke requests, verdict lines and rc semantics)::

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
default: the card). ``--row FILE`` appends the ``--bench`` (or
``--loadgen``) row to FILE.

The always-on modes::

    serve --requests FILE --async [--workers N] [--no-aot] [--verdict]
    serve --loadgen MIX.json [--duration S] [--monitor] [--abort-on-burn]
    serve ... --slo SPEC.json               # or $HEAT3D_SLO_SPEC

``--async`` serves through the engine (``serve/engine/``; its warm-up,
``serve/aot.py``; ``--no-aot`` skips it and the first request pays the
first-use stall); a record's ``stream`` tags its delivery order.
``--loadgen`` replays a seeded open-loop mix against the engine
(``serve/loadgen.py``; ``--monitor`` judges burn rate live through
``obs/burn.py``, ``--abort-on-burn`` ends a condemned soak early).
``--slo`` judges the drain or the soak (``obs/perf/slo.py``): an
objective breach exits 1 even when every result delivered.
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
                   help="(--bench, --loadgen) also append the row (the "
                   "soak's: bench=soak) to this JSONL file")
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
    p.add_argument("--loadgen", default=None, metavar="SPEC.json",
                   help="sustained-traffic soak: replay a seeded open-"
                   "loop scenario-mix spec against the async engine "
                   "(Poisson arrivals, ramps, bursts, per-stream "
                   "admission control; serve/loadgen.py); with "
                   "--verdict the soak verdict prints to stdout, exit 0 "
                   "only when it passes")
    p.add_argument("--duration", type=float, default=None,
                   help="(--loadgen) override the spec's duration_s")
    p.add_argument("--monitor", action="store_true",
                   help="(--loadgen) live SLO burn-rate monitoring: a "
                   "thread tails the run's own ledger during the soak, "
                   "re-judging the SLO spec over sliding fast/slow "
                   "windows (obs/burn.py) and landing slo_burn_alert "
                   "events on each objective's rising edge; needs "
                   "--ledger/$HEAT3D_LEDGER")
    p.add_argument("--abort-on-burn", action="store_true",
                   help="(--loadgen, implies --monitor) end the replay "
                   "early when any objective alerts on both windows: "
                   "exit 1 with a partial verdict")
    p.add_argument("--async", dest="async_", action="store_true",
                   help="serve through the always-on async engine "
                   "(serve/engine): submissions are accepted while "
                   "batches are in flight, buckets execute on worker "
                   "threads on streams of their own, each bucket warmed "
                   "before its first batch (serve/aot.py)")
    p.add_argument("--workers", type=int, default=None,
                   help="(--async) concurrent batch-execution slots "
                   "(default $HEAT3D_SERVE_WORKERS or 2)")
    p.add_argument("--no-aot", action="store_true",
                   help="(--async) skip the warm-up: the first request of "
                   "a bucket pays its first-use stall, unmeasured")
    p.add_argument("--verdict", action="store_true",
                   help="(--async/--loadgen) print a one-line JSON verdict "
                   "to stdout after the results: delivery counts, engine "
                   "stats, warm-up hit/miss/stall figures")
    p.add_argument("--slo", default=None, metavar="SPEC.json",
                   help="evaluate service-level objectives against this "
                   "drain (default $HEAT3D_SLO_SPEC when set; "
                   "obs/perf/slo.py) — verdict prints to stderr, an "
                   "objective BREACH exits 1 even when every result "
                   "delivered")
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = _parser().parse_args(argv)
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
    if args.loadgen:
        if args.requests or args.smoke or args.bench:
            raise ValueError(
                "--loadgen is its own mode — it cannot combine with "
                "--requests/--smoke/--bench"
            )
        return _serve_loadgen(args)
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

    # SLO spec validates BEFORE the drain: a typo'd objective file must
    # not surface only after the batches already executed
    slo_spec = None
    if args.slo or os.environ.get("HEAT3D_SLO_SPEC"):
        from heat3d_tpu_torch.obs.perf import slo as slo_mod

        try:
            slo_spec = slo_mod.load_spec(args.slo)
        except OSError as e:
            # the same clean rc-2 exit every other bad input takes (the
            # outer handler catches ValueError)
            raise ValueError(f"--slo: {e}") from None

    if args.async_:
        summary, n, engine_stats = _serve_async(args, records)
    else:
        summary, n, engine_stats = _serve_sync(args, records)
    rc = 0
    if n != len(records):
        print(
            f"heat3d serve: delivered {n} of {len(records)} requests",
            file=sys.stderr,
        )
        rc = 1
    else:
        log.info("serve: %d result(s) streamed", n)
    if args.verdict:
        # the machine verdict line (stdout, AFTER the result stream):
        # delivery counts + engine/warm-up figures. The sync path has no
        # engine: the key is
        # OMITTED (not null) so consumers of the documented async shape
        # fail loudly on the wrong mode instead of dereferencing null.
        verdict = {
            "requests": len(records),
            "delivered": n,
            "ok": rc == 0,
        }
        if engine_stats is not None:
            verdict["engine"] = engine_stats
        print(json.dumps({"serve_verdict": verdict}), flush=True)

    # SLO wiring (docs/SERVING.md "SLOs"): judge THIS drain against the
    # declarative objectives — evaluated from the front-end's own summary
    # (the same dict the drain-final serve_metrics_summary event carried;
    # queue and async engine produce the identical shape), so the verdict
    # is live, not a ledger re-read. Verdict goes to stderr (stdout is
    # the result stream); a breach is rc 1.
    if slo_spec is not None:
        from heat3d_tpu_torch.obs.perf import slo as slo_mod

        report = slo_mod.evaluate(
            [], slo_spec, serve_summary={
                **summary,
                "source": "live engine" if args.async_ else "live queue",
            },
        )
        slo_mod.record_verdict(report)
        slo_mod.print_report(report, out=sys.stderr)
        # only serve-side objectives (latency, degraded budget) are
        # judgeable from a drain (the queue has no step spans or device
        # profile) — say so, so a mixed spec's step/halo ceilings don't
        # read as enforced here
        other = [
            o["name"]
            for o in report["objectives"]
            if o["kind"] not in ("serve_latency", "serve_degraded")
        ]
        if other:
            print(
                f"heat3d serve: note: {', '.join(other)} not evaluable "
                "at drain time — run `heat3d obs slo <ledger>` post-hoc",
                file=sys.stderr,
            )
        if report["verdict"] == "breach":
            return 1
    return rc


def _serve_loadgen(args) -> int:
    """The sustained-traffic soak (serve/loadgen.py): seeded open-loop
    replay against the async engine, SLO-judged, machine-verdicted.
    rc 0 only when the soak's own checks pass AND no SLO objective
    breached; rc 1 otherwise (the test-pinned contract)."""
    from heat3d_tpu_torch.obs.perf import slo as slo_mod
    from heat3d_tpu_torch.serve import loadgen

    with open(args.loadgen) as f:
        try:
            mix = json.load(f)
        except json.JSONDecodeError as e:
            raise ValueError(
                f"{args.loadgen}: unparseable loadgen spec: {e}"
            ) from None
    if not isinstance(mix, dict):
        raise ValueError(f"{args.loadgen}: loadgen spec must be an object")
    if args.duration is not None:
        mix["duration_s"] = args.duration

    # SLO resolution, validated BEFORE the soak burns its duration:
    # --slo / $HEAT3D_SLO_SPEC file > the mix's inline "slo" block > the
    # soak default (generous latency, a real degraded budget)
    if args.slo or os.environ.get("HEAT3D_SLO_SPEC"):
        try:
            slo_spec = slo_mod.load_spec(args.slo)
        except OSError as e:
            raise ValueError(f"--slo: {e}") from None
    elif isinstance(mix.get("slo"), dict):
        slo_spec = slo_mod.validate_spec(
            dict(mix["slo"]), origin=f"{args.loadgen}: slo"
        )
    else:
        slo_spec = dict(loadgen.DEFAULT_SOAK_SLO)

    # live-monitor resolution: the mix's "monitor" block tunes windows /
    # threshold / cadence; the FLAGS enable it (a committed spec should
    # not silently grow a monitoring thread). --abort-on-burn implies
    # --monitor. Monitoring without a ledger is a config error (rc 2,
    # validated before the soak burns its duration).
    monitor_cfg = None
    if args.monitor or args.abort_on_burn:
        if not obs.get().active:
            raise ValueError(
                "--monitor needs a run ledger (--ledger or "
                "$HEAT3D_LEDGER) — the live evaluator tails the run's "
                "own event stream"
            )
        mblock = mix.get("monitor")
        mblock = mblock if isinstance(mblock, dict) else {}
        monitor_cfg = {
            "spec": slo_spec,
            "abort_on_burn": bool(args.abort_on_burn),
            "interval_s": mblock.get("interval_s"),
            "fast_window_s": mblock.get("fast_window_s"),
            "slow_window_s": mblock.get("slow_window_s"),
            "threshold": mblock.get("threshold"),
        }

    verdict = loadgen.run_soak(
        mix, _base_from_record, _scenario_from_record,
        monitor=monitor_cfg, device=args.device,
    )
    report = slo_mod.evaluate(
        [], slo_spec,
        serve_summary={**verdict["summary"], "source": "soak"},
    )
    slo_mod.record_verdict(report)
    slo_mod.print_report(report, out=sys.stderr)
    ok = verdict["ok"] and report["verdict"] != "breach"
    if args.row:
        row = loadgen.soak_row(verdict, report["verdict"], device=args.device)
        with open(args.row, "a") as f:
            f.write(json.dumps(row) + "\n")
        log.info("soak row appended to %s", args.row)
    if args.verdict:
        out = {k: v for k, v in verdict.items() if k != "summary"}
        out["slo"] = report["verdict"]
        out["ok"] = ok
        print(json.dumps({"soak_verdict": out}), flush=True)
    if verdict.get("aborted"):
        mon_info = verdict.get("monitor") or {}
        print(
            "heat3d serve: soak ABORTED early on SLO burn "
            f"(alerted: {', '.join(mon_info.get('alerted', [])) or '?'}; "
            f"replayed {verdict['submitted']} of {verdict['arrivals']} "
            "arrivals) — partial verdict above",
            file=sys.stderr,
        )
    elif not verdict["ok"]:
        print(
            "heat3d serve: soak failed its own checks "
            f"(accounting_ok={verdict['accounting_ok']}, "
            f"order_ok={verdict['order_ok']}, "
            f"failed={verdict['failed']}, "
            f"compile_stall_after_warmup="
            f"{verdict['compile_stall_after_warmup']})",
            file=sys.stderr,
        )
    return 0 if ok else 1


def _serve_sync(args, records):
    """The submit-then-drain path (``ScenarioQueue``): returns its summary,
    the number of results streamed and no engine stats."""
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
    return queue.metrics_summary(), n, None


def _serve_async(args, records):
    """The always-on path (serve/engine): submissions land on the live
    engine, the result stream follows per-stream submission order, and a
    failed bucket costs only its own requests (the shortfall is the rc-1
    'delivered n of m' path, with the errors on stderr). The CLI knows
    its whole request set up front, so it defers dispatch until every
    submission landed (``autostart=False``): one optimally-packed batch
    per bucket, and DETERMINISTIC padded sizes — the same packing as the
    synchronous queue, so every result is the same."""
    from heat3d_tpu_torch.serve.engine import AsyncServeEngine

    engine = AsyncServeEngine(
        max_batch=args.max_batch,
        batch_mesh=args.batch_mesh,
        snapshot_every=args.snapshot_every,
        with_residuals=args.residuals,
        workers=args.workers,
        aot=False if args.no_aot else None,
        autostart=False,
        device=args.device,
    )
    n = 0
    try:
        for rec in records:
            engine.submit(
                _base_from_record(rec),
                _scenario_from_record(rec),
                # `or ""`: a JSON null stream means "no stream", not a
                # stream literally named "None"
                stream=str(rec.get("stream") or ""),
            )
        try:
            for r in engine.drain():
                print(json.dumps(_result_line(r, args.out)), flush=True)
                n += 1
        except RuntimeError as e:
            # failed bucket(s): everything deliverable already streamed —
            # the shortfall surfaces as 'delivered n of m' + rc 1
            print(f"heat3d serve: {e}", file=sys.stderr)
    finally:
        engine.shutdown()
    return engine.metrics_summary(), n, engine.stats()


if __name__ == "__main__":
    sys.exit(main())
