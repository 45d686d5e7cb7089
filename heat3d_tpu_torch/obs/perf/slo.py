"""Service-level objectives: ``heat3d obs slo`` — a declarative objective
spec evaluated from the run ledger (plus an optional profile capture)
into a burn-rate verdict.

Port of ``heat3d_tpu.obs.perf.slo`` (pure Python, the same spec, report
and rc). The serve queue records latency histograms; this module says
whether they meet declared *objectives*, the same way ``obs regress``
judges perf rows — a machine verdict with tolerance
structure and honest rc semantics (rc 1 ONLY on an objective breach;
warn and no-data exit 0, so a fresh deployment without traffic doesn't
redden CI).

**Objective spec** (JSON; ``--spec`` or ``HEAT3D_SLO_SPEC``)::

    {
      "warn_ratio": 0.9,
      "objectives": [
        {"name": "queue-p95", "kind": "serve_latency", "percentile": 95,
         "max_s": 0.5},
        {"name": "queue-p50-small", "kind": "serve_latency",
         "percentile": 50, "max_s": 0.1, "bucket": "(16, 16, 16)"},
        {"name": "step-p95", "kind": "step_time", "percentile": 95,
         "max_s": 0.05},
        {"name": "halo-share", "kind": "halo_share", "max_frac": 0.4}
      ]
    }

Four objective kinds:

- ``serve_latency`` — per-serve-bucket p50/p95 queue latency, from the
  ``serve_metrics_summary`` ledger event the queue emits at drain end
  (post-hoc evaluation never needs the live registry); ``bucket`` is a
  substring filter on the bucket key, absent = every bucket, and the
  WORST matching bucket governs. Falls back to reconstructing one
  ``(all)`` pseudo-bucket from ``serve_result`` events for pre-summary
  ledgers.
- ``step_time`` — per-run per-step latency ceiling, from the
  run_loop/chunk spans (the same reconstruction ``obs summary`` prints).
- ``halo_share`` — fraction of attributed device time spent in halo
  exchange, from a ``--profile`` capture's per-phase device totals
  (``obs.perf.timeline.profile_phase_totals``: the ``heat3d.*`` ranges
  of a ``torch.profiler`` trace); without a capture the objective reports
  ``no_data`` rather than guessing from wall-clock.
- ``serve_degraded`` — cumulative seconds the serving tier spent in
  degraded mode (backend-loss requeues open the window, the next
  successful batch closes it; docs/SERVING.md "Degraded-mode
  serving"), judged against a ``max_s`` degraded-time budget. Source
  is the same ``serve_metrics_summary`` (``degraded_s`` field —
  always present on summaries new enough to carry the feature;
  pre-elastic ledgers report ``no_data``, never a vacuous pass).

**Burn rate** = measured / objective. ``breach`` above 1.0, ``warn`` at
or above ``warn_ratio`` (spec field; ``HEAT3D_SLO_WARN_RATIO``
overrides; default 0.9) — the early-warning margin before the ceiling,
mirroring regress's warn band. The verdict lands in the ledger as an
``slo_verdict`` event (fail-soft, like all telemetry) and in ``heat3d
serve --slo``'s drain report (docs/SERVING.md).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Any, Dict, List, Optional

ENV_SLO_SPEC = "HEAT3D_SLO_SPEC"
ENV_SLO_WARN_RATIO = "HEAT3D_SLO_WARN_RATIO"
DEFAULT_WARN_RATIO = 0.9

KINDS = ("serve_latency", "step_time", "halo_share", "serve_degraded")

# The spec used when none is configured: ceilings generous enough that
# only a genuinely wedged run breaches them — so the CI smoke exercises
# the whole evaluate path without inventing policy for the operator.
DEFAULT_SPEC: Dict[str, Any] = {
    "default_spec": True,
    "warn_ratio": DEFAULT_WARN_RATIO,
    "objectives": [
        {"name": "serve-queue-p95", "kind": "serve_latency",
         "percentile": 95, "max_s": 60.0},
        {"name": "step-p95", "kind": "step_time",
         "percentile": 95, "max_s": 60.0},
    ],
}


def validate_spec(spec: Any, origin: str = "spec") -> Dict[str, Any]:
    """Validate an in-memory objective spec (the loadgen soak passes its
    mix's inline ``slo`` block through here — same rules as a file spec,
    with ``origin`` naming the source in errors). Returns the spec with
    objective names defaulted; raises ValueError on malformation."""
    if not isinstance(spec, dict) or not isinstance(
        spec.get("objectives"), list
    ):
        raise ValueError(f"{origin}: SLO spec needs an 'objectives' list")
    for i, o in enumerate(spec["objectives"]):
        if not isinstance(o, dict):
            raise ValueError(f"{origin}: objective #{i} must be an object")
        kind = o.get("kind")
        if kind not in KINDS:
            raise ValueError(
                f"{origin}: objective #{i} kind must be one of {KINDS}, "
                f"got {kind!r}"
            )
        target_key = "max_frac" if kind == "halo_share" else "max_s"
        if not isinstance(o.get(target_key), (int, float)) or o[target_key] <= 0:
            raise ValueError(
                f"{origin}: objective #{i} ({o.get('name', kind)}) needs a "
                f"positive {target_key}"
            )
        # p99 is soak-only in practice: the drain reservoir records
        # p50/p95, and the load generator merges a full-sample p99 into
        # the summary it hands evaluate()
        if kind in ("serve_latency", "step_time") and o.get(
            "percentile"
        ) not in (50, 95, 99):
            raise ValueError(
                f"{origin}: objective #{i} percentile must be 50, 95 or "
                "99 (the percentiles the metrics/soak layers record)"
            )
        o.setdefault("name", f"{kind}-#{i}")
    return spec


def load_spec(path: Optional[str] = None) -> Dict[str, Any]:
    """The objective spec at ``path`` (or ``$HEAT3D_SLO_SPEC``), validated;
    :data:`DEFAULT_SPEC` when neither is configured. Raises ValueError on
    a malformed spec and OSError on an unreadable path — an SLO gate that
    cannot read its objectives must say so, not pass vacuously (the same
    posture as regress's unreadable-input rc 2)."""
    path = path or os.environ.get(ENV_SLO_SPEC) or None
    if not path:
        return dict(DEFAULT_SPEC)
    with open(path) as f:
        try:
            spec = json.load(f)
        except json.JSONDecodeError as e:
            raise ValueError(f"{path}: unparseable SLO spec: {e}") from None
    spec = validate_spec(spec, origin=path)
    spec["path"] = path
    return spec


def _warn_ratio(spec: Dict[str, Any], override: Optional[float]) -> float:
    """Precedence: explicit argument > ``HEAT3D_SLO_WARN_RATIO`` > spec
    field > default — env beats the committed spec so an operator can
    tighten the early-warning margin for one session without editing
    policy files."""
    if override is not None:
        return override
    env = os.environ.get(ENV_SLO_WARN_RATIO)
    if env:
        try:
            return float(env)
        except ValueError:
            pass  # a bad override must not kill the gate
    wr = spec.get("warn_ratio")
    return float(wr) if isinstance(wr, (int, float)) else DEFAULT_WARN_RATIO


def serve_summary_from_events(
    events: List[Dict[str, Any]],
) -> Optional[Dict[str, Any]]:
    """The serve-side evaluation source: the LAST ``serve_metrics_summary``
    event (cumulative — later supersedes earlier), else a reconstruction
    from ``serve_result`` queue latencies as one ``(all)`` pseudo-bucket
    (pre-summary ledgers), else None."""
    from heat3d_tpu_torch.obs.metrics import percentile

    last = None
    for r in events:
        if r.get("event") == "serve_metrics_summary" and isinstance(
            r.get("buckets"), dict
        ):
            last = r
    if last is not None:
        return {
            "buckets": last["buckets"],
            "depth_max": last.get("depth_max"),
            # degraded-mode provenance (absent on pre-elastic ledgers —
            # the serve_degraded objective then reads no_data)
            "degraded": last.get("degraded"),
            "degraded_s": last.get("degraded_s"),
            "requeues": last.get("requeues"),
            "source": "serve_metrics_summary",
        }
    lat = [
        float(r["queue_latency_s"])
        for r in events
        if r.get("event") == "serve_result"
        and isinstance(r.get("queue_latency_s"), (int, float))
    ]
    if not lat:
        return None
    return {
        "buckets": {
            "(all)": {
                "count": len(lat),
                "p50_s": percentile(lat, 50),
                "p95_s": percentile(lat, 95),
                "max_s": max(lat),
            }
        },
        "depth_max": None,
        "source": "serve_result reconstruction",
    }


def _status(burn: Optional[float], warn_ratio: float) -> str:
    if burn is None:
        return "no_data"
    if burn > 1.0:
        return "breach"
    if burn >= warn_ratio:
        return "warn"
    return "ok"


def evaluate_objective(
    o: Dict[str, Any],
    serve_summary: Optional[Dict[str, Any]],
    step_samples: List[float],
    phase_us: Optional[Dict[str, float]],
    warn_ratio: float,
) -> Dict[str, Any]:
    """ONE objective judged against prepared inputs — the shared core
    behind both the post-hoc gate (:func:`evaluate`) and the streaming
    burn-rate monitor (``obs.burn.BurnEvaluator``), so the two paths
    cannot drift: same worst-bucket rule, same rounding, same status
    bands. Returns the per-objective record (value / target / burn_rate /
    status)."""
    from heat3d_tpu_torch.obs.metrics import percentile

    kind = o["kind"]
    rec: Dict[str, Any] = {
        "name": o.get("name", kind),
        "kind": kind,
    }
    value = None
    if kind == "serve_latency":
        rec["target_s"] = float(o["max_s"])
        field = f"p{o['percentile']}_s"
        want = o.get("bucket")
        per_bucket = {}
        for bucket, st in ((serve_summary or {}).get("buckets") or {}).items():
            if want and want not in str(bucket):
                continue
            v = st.get(field) if isinstance(st, dict) else None
            if isinstance(v, (int, float)):
                per_bucket[str(bucket)] = round(float(v), 6)
        if per_bucket:
            # the WORST matching bucket governs: an SLO met on average
            # but breached on one bucket is breached
            worst = max(per_bucket, key=per_bucket.get)
            value = per_bucket[worst]
            rec["bucket"] = worst
            rec["buckets"] = per_bucket
        burn = None if value is None else value / rec["target_s"]
    elif kind == "step_time":
        rec["target_s"] = float(o["max_s"])
        if step_samples:
            value = float(percentile(step_samples, o["percentile"]))
            rec["samples"] = len(step_samples)
        burn = None if value is None else value / rec["target_s"]
    elif kind == "serve_degraded":
        rec["target_s"] = float(o["max_s"])
        ds = (serve_summary or {}).get("degraded_s")
        if isinstance(ds, (int, float)):
            value = float(ds)
            if (serve_summary or {}).get("degraded"):
                rec["still_degraded"] = True
            rq = (serve_summary or {}).get("requeues")
            if isinstance(rq, int):
                rec["requeues"] = rq
        burn = None if value is None else value / rec["target_s"]
    else:  # halo_share
        rec["target_frac"] = float(o["max_frac"])
        if phase_us:
            known = {
                ph: us
                for ph, us in phase_us.items()
                if ph != "(unattributed)"
            }
            total = sum(known.values())
            if total > 0:
                value = known.get("halo_exchange", 0.0) / total
        burn = None if value is None else value / rec["target_frac"]
    rec["value"] = None if value is None else round(float(value), 6)
    rec["burn_rate"] = None if burn is None else round(burn, 4)
    rec["status"] = _status(burn, warn_ratio)
    return rec


def evaluate(
    events: List[Dict[str, Any]],
    spec: Dict[str, Any],
    serve_summary: Optional[Dict[str, Any]] = None,
    phase_us: Optional[Dict[str, float]] = None,
    warn_ratio: Optional[float] = None,
    step_samples: Optional[List[float]] = None,
) -> Dict[str, Any]:
    """Evaluate every objective in ``spec`` against the ledger ``events``
    (plus an optional live ``serve_summary`` — the serve CLI's drain
    wiring passes the queue's own summary so the verdict never waits on a
    ledger re-read — and a profile's ``phase_us`` for halo_share).
    ``step_samples`` overrides the ledger reconstruction (the streaming
    monitor passes its own accumulated samples). Returns the machine
    report: per-objective value/target/burn-rate/status and the overall
    verdict (``breach`` > ``warn`` > ``pass``)."""
    from heat3d_tpu_torch.obs.cli import step_latencies

    wr = _warn_ratio(spec, warn_ratio)
    if serve_summary is None:
        serve_summary = serve_summary_from_events(events)
    if step_samples is None:
        step_samples = step_latencies(events)

    results = [
        evaluate_objective(o, serve_summary, step_samples, phase_us, wr)
        for o in spec.get("objectives", [])
    ]

    statuses = [r["status"] for r in results]
    verdict = (
        "breach"
        if "breach" in statuses
        else "warn"
        if "warn" in statuses
        else "pass"
    )
    report = {
        "verdict": verdict,
        "warn_ratio": wr,
        "objectives": results,
        "sources": {
            "serve": (serve_summary or {}).get("source"),
            "step_samples": len(step_samples),
            "profile_phases": sorted(phase_us) if phase_us else None,
        },
    }
    if spec.get("default_spec"):
        report["default_spec"] = True
    if spec.get("path"):
        report["spec"] = spec["path"]
    return report


def print_report(report: Dict[str, Any], out=None) -> None:
    out = out or sys.stdout
    tag = {"ok": "ok    ", "warn": "WARN  ", "breach": "BREACH",
           "no_data": "n/a   "}
    for r in report["objectives"]:
        target = r.get("target_s", r.get("target_frac"))
        burn = (
            f"burn {r['burn_rate']:.2f}"
            if r.get("burn_rate") is not None
            else "no data"
        )
        value = f"{r['value']}" if r.get("value") is not None else "-"
        bucket = f" [{r['bucket']}]" if r.get("bucket") else ""
        print(
            f"  {tag.get(r['status'], r['status'])} {r['name']}{bucket}: "
            f"{value} vs {target} ({burn})",
            file=out,
        )
    extra = " (built-in default spec)" if report.get("default_spec") else ""
    print(f"slo verdict: {report['verdict']}{extra}", file=out)


def record_verdict(report: Dict[str, Any]) -> None:
    """One ``slo_verdict`` ledger event (fail-soft; NULL ledger = no-op):
    the verdict, per-objective burn rates, and the spec provenance."""
    from heat3d_tpu_torch import obs

    obs.get().event(
        "slo_verdict",
        verdict=report["verdict"],
        warn_ratio=report["warn_ratio"],
        objectives=[
            {
                "name": r["name"],
                "status": r["status"],
                "burn_rate": r.get("burn_rate"),
            }
            for r in report["objectives"]
        ],
        spec=report.get("spec"),
        default_spec=bool(report.get("default_spec")),
    )


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="heat3d obs slo",
        description="evaluate declarative service-level objectives "
        "(per-bucket serve latency, step-time ceilings, halo share) "
        "against a run ledger; rc 1 ONLY on an objective breach "
        "(warn/no-data exit 0 — the obs regress rc convention)",
    )
    ap.add_argument("ledger", help="run ledger file (JSONL event stream)")
    ap.add_argument("--spec", default=None, metavar="FILE.json",
                    help="objective spec (default $HEAT3D_SLO_SPEC, else "
                    "a built-in generous default so the path stays "
                    "exercised)")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="profile capture for halo_share objectives "
                    "(per-phase device totals via obs timeline)")
    ap.add_argument("--warn-ratio", type=float, default=None,
                    help="warn at this fraction of a ceiling (default "
                    "$HEAT3D_SLO_WARN_RATIO, spec warn_ratio, or 0.9)")
    ap.add_argument("--json", action="store_true",
                    help="print the machine-readable report")
    args = ap.parse_args(argv)

    try:
        spec = load_spec(args.spec)
    except (OSError, ValueError) as e:
        print(f"slo: {e}", file=sys.stderr)
        return 2
    try:
        from heat3d_tpu_torch.obs.cli import read_ledger

        events = read_ledger(args.ledger)
    except OSError as e:
        print(f"slo: cannot read ledger: {e}", file=sys.stderr)
        return 2

    phase_us = None
    if args.profile:
        from heat3d_tpu_torch.obs.perf.timeline import profile_phase_totals

        try:
            phase_us, _ = profile_phase_totals(args.profile)
        except (RuntimeError, OSError) as e:
            print(f"slo: profile ignored ({e})", file=sys.stderr)

    report = evaluate(
        events, spec, phase_us=phase_us, warn_ratio=args.warn_ratio
    )
    record_verdict(report)
    if args.json:
        print(json.dumps(report))
    else:
        print_report(report)
    return 1 if report["verdict"] == "breach" else 0


if __name__ == "__main__":
    sys.exit(main())
