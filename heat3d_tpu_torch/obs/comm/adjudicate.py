"""``obs adjudicate`` — one command from captured rows to the A/B stage
verdicts (torch-free).

A copy of the JAX package's ``obs/comm/adjudicate.py``, on the port's
``tune.decide`` and ``obs.metrics.percentile``. It consumes bench
``*.jsonl`` row files, run ledgers and ``obs merge`` outputs
(``bench_row`` events are unwrapped; plain rows pass through) and emits
every stage's verdict through :mod:`heat3d_tpu_torch.tune.decide`'s
pairing logic: rows pair only when every context field (grid, mesh,
dtype, platform, granularity-floor note, the OTHER stage knobs) matches
and exactly ONE stage knob differs, so rows from different shapes or
floors can never adjudicate each other.

Stage verdicts:

- ``pass`` — at least one single-knob pair, and no contradiction: the
  per-(context, value-pair) decisions never name two different decisive
  winners for the SAME comparison (duplicate measurements of one A/B
  disagreeing decisively is a measurement problem to resolve, not to
  average away). Per-context winners are reported; a winner flipping
  ACROSS contexts (partitioned wins above the granularity floor,
  monolithic below it) is expected, not a conflict.
- ``no-data`` — no rows carry the stage's knob, or rows exist but no
  pair differs in exactly that knob.
- ``fail`` — a same-context, same-value-pair decisive contradiction.

Exit code matches ``obs regress``: 1 only on a ``fail`` verdict —
``no-data`` and ``pass`` exit 0; 2 when an input is unreadable. The
verdict is also emitted as an ``adjudicate_verdict`` ledger event when a
ledger is active.
"""

from __future__ import annotations

import argparse
import json
import sys
from collections import defaultdict
from typing import Any, Dict, List, Optional, Tuple

from heat3d_tpu_torch.obs.metrics import percentile
from heat3d_tpu_torch.tune.decide import DEFAULT_MIN_WIN_PCT, decide, format_decision

# envelope fields Ledger._write owns; stripped when unwrapping bench_row
# events back into bench rows (plus merge's src tag)
_ENVELOPE = ("ts", "run_id", "proc", "seq", "event", "kind", "src")

# every knob any stage adjudicates — each stage's context includes the
# OTHER stages' knobs, so a halo_plan pair can never straddle two
# halo_orders
_STAGE_KNOBS = ("halo_plan", "halo_order", "time_blocking", "fused_rdma")

# context fields that must match for two rows to be comparable (the
# union present in the eligible rows is used — files predating a field
# still pair among themselves)
_CONTEXT_KEYS = (
    "bench", "grid", "mesh", "dtype", "platform", "note", "backend",
    "halo", "overlap", "stencil", "width",
) + _STAGE_KNOBS


def _p50_us(row: Dict[str, Any]) -> Optional[float]:
    v = row.get("p50_us")
    if isinstance(v, (int, float)) and not isinstance(v, bool):
        return float(v)
    return None


# The A/B stages (the JAX package's POD_RUNBOOK stages). Halo stages
# judge the bench_halo p50 latency (lower wins); the slab-width stage
# judges the throughput rows' per-chip rate through decide()'s own
# METRIC_KEYS lookup (higher wins).
STAGES: Tuple[Dict[str, Any], ...] = (
    {
        "stage": "halo_plan",
        "knob": "halo_plan",
        "bench": "halo",
        "metric": _p50_us,
        "prefer": "lower",
        "title": "monolithic-vs-partitioned exchange plan (p50_us)",
    },
    {
        "stage": "halo_order",
        "knob": "halo_order",
        "bench": "halo",
        "metric": _p50_us,
        "prefer": "lower",
        "title": "axis-vs-pairwise halo ordering (p50_us)",
    },
    {
        "stage": "slab_width",
        "knob": "time_blocking",
        "bench": "throughput",
        "metric": None,  # decide()'s throughput METRIC_KEYS
        "prefer": "higher",
        "title": "slab width / temporal-blocking depth (Gcell/s/chip)",
    },
    {
        # stage 3-fused: the fused in-kernel RDMA superstep vs the
        # unfused exchange route — rows stamp the EFFECTIVE knob
        # (bench/harness), so an env-forced arm pairs correctly
        "stage": "fused_rdma",
        "knob": "fused_rdma",
        "bench": "throughput",
        "metric": None,  # decide()'s throughput METRIC_KEYS
        "prefer": "higher",
        "title": "fused in-kernel RDMA superstep vs unfused (Gcell/s/chip)",
    },
)


def load_rows(path: str) -> List[Dict[str, Any]]:
    """Bench rows from ``path`` — a plain ``*.jsonl`` row file, a run
    ledger, or an ``obs merge`` output. Ledger ``bench_row`` events are
    unwrapped (envelope stripped, the respelled ``ts_`` measurement
    timestamp restored to ``ts``); non-row lines are skipped, unreadable
    files raise ``OSError`` (rc 2 at the CLI)."""
    from heat3d_tpu_torch.obs.cli import read_ledger

    rows: List[Dict[str, Any]] = []
    for e in read_ledger(path):
        if not isinstance(e, dict):
            continue
        if e.get("event") == "bench_row":
            row = {k: v for k, v in e.items() if k not in _ENVELOPE}
            if "ts_" in row:
                row["ts"] = row.pop("ts_")
            rows.append(row)
        elif "bench" in e and "event" not in e:
            rows.append(e)
    return rows


def _ctx_str(v: Any) -> str:
    if isinstance(v, (list, tuple)):
        return "x".join(str(x) for x in v)
    return "-" if v is None else str(v)


def _stage_verdict(
    st: Dict[str, Any],
    rows: List[Dict[str, Any]],
    min_win_pct: float,
) -> Dict[str, Any]:
    knob = st["knob"]
    metric = st["metric"]

    def _m(row):
        if metric is not None:
            return metric(row)
        from heat3d_tpu_torch.tune.decide import _metric

        return _metric(row)

    eligible = [
        r
        for r in rows
        if r.get("bench") == st["bench"] and knob in r and _m(r) is not None
    ]
    out: Dict[str, Any] = {
        "stage": st["stage"],
        "title": st["title"],
        "rows": len(eligible),
        "pairs": 0,
        "decisions": [],
        "winners": [],
        "conflicts": [],
    }
    if not eligible:
        out["verdict"] = "no-data"
        out["reason"] = f"no {st['bench']} rows carrying {knob}"
        return out
    ctx_keys = sorted(
        {k for r in eligible for k in _CONTEXT_KEYS if k in r} - {knob}
    )
    entries = [
        (
            {knob: _ctx_str(r[knob]),
             **{k: _ctx_str(r.get(k)) for k in ctx_keys}},
            r,
        )
        for r in eligible
    ]
    decisions = [
        d
        for d in decide(
            entries, min_win_pct, metric=_m, prefer=st["prefer"]
        )
        if d["knob"] == knob
    ]
    out["pairs"] = len(decisions)
    out["decisions"] = decisions
    if not decisions:
        out["verdict"] = "no-data"
        out["reason"] = (
            f"{len(eligible)} row(s) but no pair differs in {knob} alone"
        )
        return out
    # contradiction check: the SAME comparison (same context, same two
    # knob values) naming two different decisive winners. Distinct
    # winners across different value-pairs (tb=2 beats tb=1, tb=3 beats
    # tb=4) or across different contexts are legitimate outcomes.
    by_cmp: Dict[Tuple, set] = defaultdict(set)
    for d in decisions:
        if not d["decisive"]:
            continue
        cmp_key = (
            tuple(sorted(d["context"].items())),
            frozenset(d["values"]),
        )
        by_cmp[cmp_key].add(d["winner"])
    conflicts = [
        {
            "context": dict(ctx),
            "values": sorted(vals),
            "winners": sorted(winners),
        }
        for (ctx, vals), winners in sorted(by_cmp.items())
        if len(winners) > 1
    ]
    out["conflicts"] = conflicts
    # per-context champion: best representative (p50 across duplicates)
    # value in that context — the row the runbook's flip/keep call reads
    per_ctx: Dict[Tuple, Dict[str, List[float]]] = defaultdict(
        lambda: defaultdict(list)
    )
    for knobs, r in entries:
        ctx = tuple(
            sorted((k, v) for k, v in knobs.items() if k != knob)
        )
        per_ctx[ctx][knobs[knob]].append(float(_m(r)))
    lower = st["prefer"] == "lower"
    for ctx, vals in sorted(per_ctx.items()):
        if len(vals) < 2:
            continue
        reps = {v: percentile(ms, 50) for v, ms in vals.items()}
        ranked = sorted(reps.items(), key=lambda kv: kv[1], reverse=not lower)
        (win_v, win_m), (run_v, run_m) = ranked[0], ranked[1]
        margin = (
            (run_m / win_m - 1.0) if lower else (win_m / run_m - 1.0)
        ) * 100.0
        out["winners"].append(
            {
                "context": dict(ctx),
                "winner": win_v,
                "speedup_pct": round(margin, 1),
                "decisive": margin >= min_win_pct,
                "values": {v: round(m, 2) for v, m in reps.items()},
            }
        )
    if conflicts:
        out["verdict"] = "fail"
        out["reason"] = (
            f"{len(conflicts)} same-context comparison(s) with "
            "contradictory decisive winners"
        )
    else:
        out["verdict"] = "pass"
        out["reason"] = (
            f"{len(decisions)} pair(s), "
            f"{sum(1 for d in decisions if d['decisive'])} decisive"
        )
    return out


def adjudicate_rows(
    rows: List[Dict[str, Any]],
    min_win_pct: float = DEFAULT_MIN_WIN_PCT,
) -> Dict[str, Any]:
    """Every stage's verdict over ``rows`` plus the overall verdict and
    the ``obs regress``-compatible exit code (1 only on ``fail``)."""
    stages = [_stage_verdict(st, rows, min_win_pct) for st in STAGES]
    if any(s["verdict"] == "fail" for s in stages):
        overall = "fail"
    elif any(s["verdict"] == "pass" for s in stages):
        overall = "pass"
    else:
        overall = "no-data"
    return {
        "verdict": overall,
        "rc": 1 if overall == "fail" else 0,
        "rows": len(rows),
        "min_win_pct": min_win_pct,
        "stages": stages,
    }


def _emit_verdict(report: Dict[str, Any], inputs: List[str]) -> None:
    from heat3d_tpu_torch import obs

    obs.get().event(
        "adjudicate_verdict",
        verdict=report["verdict"],
        rc=report["rc"],
        rows=report["rows"],
        stages={s["stage"]: s["verdict"] for s in report["stages"]},
        inputs=[str(p) for p in inputs],
    )


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="heat3d_tpu_torch obs adjudicate",
        description="emit the A/B stage verdicts from bench "
        "row files / run ledgers / merged ledgers",
    )
    ap.add_argument("inputs", nargs="+",
                    help="bench *.jsonl row files, ledgers, or merges")
    ap.add_argument("--min-win", type=float, default=DEFAULT_MIN_WIN_PCT,
                    help="speedup %% below which a win is not decisive")
    ap.add_argument("--json", dest="as_json", action="store_true",
                    help="machine verdict (one JSON object) on stdout")
    args = ap.parse_args(argv)

    rows: List[Dict[str, Any]] = []
    for path in args.inputs:
        try:
            rows.extend(load_rows(path))
        except OSError as e:
            print(f"adjudicate: cannot read {path}: {e}", file=sys.stderr)
            return 2
    report = adjudicate_rows(rows, args.min_win)
    _emit_verdict(report, args.inputs)
    if args.as_json:
        print(json.dumps(report))
        return report["rc"]
    print(
        f"adjudicate: {report['rows']} row(s) from "
        f"{len(args.inputs)} input(s)"
    )
    for s in report["stages"]:
        print(f"stage {s['stage']} ({s['title']}): "
              f"{s['verdict']} — {s['reason']}")
        for d in s["decisions"]:
            print(f"  {format_decision(d)}")
        for w in s["winners"]:
            ctx = " ".join(
                f"{k}={v}" for k, v in sorted(w["context"].items())
                if k not in ("bench",)
            )
            call = "decisive" if w["decisive"] else "below threshold"
            print(
                f"  winner[{ctx or 'no context'}]: "
                f"{s['stage']}={w['winner']} by {w['speedup_pct']}% "
                f"({call})"
            )
        for c in s["conflicts"]:
            print(
                f"  CONFLICT: values {c['values']} -> winners "
                f"{c['winners']} in {c['context']}"
            )
    print(f"verdict: {report['verdict']} (rc {report['rc']})")
    return report["rc"]


if __name__ == "__main__":
    sys.exit(main())
