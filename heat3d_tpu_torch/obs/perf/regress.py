"""The automated perf-regression gate: ``obs regress`` (a copy of the JAX
package's gate, over the port's bench rows).

Compares a session's bench rows (the "current" file, optionally scoped
with ``--start-line`` to just the rows this session appended — the same
rule the provenance and ledger lints use) against the measured history:
other ``bench_results*.jsonl`` files, earlier rows of the current file,
and the committed driver artifacts (``BENCH_*.json``). Emits a
machine-readable pass/warn/fail verdict, so "did this change regress the
hot path" is a checked fact, not a claim.

Baseline rules (each one exists because a naive diff lied once):

- **Platform-aware**: a row only ever compares against history measured
  on the same platform class. ``platform: cpu`` rows — including driver
  records flagged ``cpu_fallback`` — never compare against committed TPU
  records (rows predating the platform field default to ``tpu``: the
  committed record is on-chip by convention, bench.py applies the same
  default). A CPU smoke run therefore gets ``no_baseline``, not a
  100x "regression".
- **Config-keyed**: throughput rows match on (stencil, grid, mesh,
  dtype, compute_dtype, time_blocking, overlap, halo, backend); halo rows
  on (grid, mesh, dtype, halo); driver records on (metric, grid, dtype,
  time_blocking, backend).
- **Best-of-history**: the baseline is the best prior number (max
  throughput / min halo p50) — comparing against a one-off slow historic
  row would wave regressions through.
- **RTT-honest**: ``rtt_dominated`` rows (current or baseline) are
  excluded — their numbers are link artifacts, not measurements.
- **Age-windowed on request**: ``--window N`` limits the baseline pool to
  the last N measurement sessions (distinct UTC measurement dates from
  row ``ts`` provenance), so an ancient best row that stopped being
  reproducible can age out.
- **Tune-aware**: the report lists tuning-cache entries that flipped a
  default knob (``tuned_configs``, :func:`tune_notes`): a tuned route
  change is a config change, not a silent regression.

Tolerance bands are per-metric percentages: a drop worse than
``--fail-pct`` (default 15) fails, worse than ``--warn-pct`` (default 8)
warns, else passes. Halo latency regresses UPWARD; the directions are
encoded per metric, not per flag.

Exit code: 1 only on a ``fail`` verdict — ``warn`` and ``no_baseline``
exit 0, so fresh configs and noisy-but-tolerable sessions don't redden a
suite that just measured them.
"""

from __future__ import annotations

import argparse
import glob as _glob
import json
import os
import sys
from typing import Any, Dict, List, Optional, Tuple

DEFAULT_WARN_PCT = 8.0
DEFAULT_FAIL_PCT = 15.0

# metric per bench kind: (field, direction) — +1 higher-is-better
METRICS: Dict[str, Tuple[str, int]] = {
    "throughput": ("gcell_per_sec_per_chip", +1),
    "halo": ("p50_us", -1),
    "driver": ("value", +1),
}


def band_status(
    delta_pct: float,
    warn_pct: float = DEFAULT_WARN_PCT,
    fail_pct: float = DEFAULT_FAIL_PCT,
) -> str:
    """pass/warn/fail for a signed regression percentage (positive =
    worse) — THE tolerance-band rule. :func:`compare` and the timeline
    drift detector (``obs.perf.timeline.detect_anomalies``) share it, so
    a step-time anomaly and a bench regression are judged by one band."""
    if delta_pct > fail_pct:
        return "fail"
    if delta_pct > warn_pct:
        return "warn"
    return "pass"


def _platform_class(row: Dict[str, Any]) -> str:
    """The comparability class: platform, with CPU-fallback driver records
    folded into 'cpu'. Rows predating the platform field are 'tpu' (the
    committed record is on-chip by convention — bench.py's rule)."""
    if row.get("cpu_fallback"):
        return "cpu"
    return str(row.get("platform") or "tpu")


def row_key(row: Dict[str, Any]) -> Optional[Tuple]:
    bench = row.get("bench")
    if bench == "throughput":
        return (
            "throughput",
            row.get("stencil", "7pt"),
            # equation-family leg: spec-built families never
            # cross-compare with heat — rows predating the field are
            # heat by construction (only heat existed)
            row.get("equation", "heat"),
            # time-integrator leg: a CG solve or two-level
            # leapfrog step must never cross-compare with the explicit
            # sweep — rows predating the field are explicit-euler by
            # construction (only it existed)
            row.get("integrator", "explicit-euler"),
            tuple(row.get("grid") or ()),
            tuple(row.get("mesh") or ()),
            row.get("dtype"),
            row.get("compute_dtype", "float32"),
            row.get("time_blocking", 1),
            bool(row.get("overlap")),
            row.get("halo", "ppermute"),
            row.get("halo_order", "axis"),
            row.get("halo_plan", "monolithic"),
            # fused-RDMA route leg: a fused superstep's rate must never
            # baseline against the unfused exchange path of the same
            # shape — rows predating the knob are off by construction
            row.get("fused_rdma", "off"),
            row.get("backend", "auto"),
            # ensemble workload axis: a packed batch's aggregate rate must
            # only ever baseline against the same batch shape — without
            # this key leg an ensemble win would mask (or fake) a
            # single-run regression (rows predating the field are solo)
            tuple(row.get("batch_shape") or (1,)),
            _platform_class(row),
        )
    if bench == "halo":
        return (
            "halo",
            tuple(row.get("grid") or ()),
            tuple(row.get("mesh") or ()),
            row.get("dtype"),
            row.get("halo", "ppermute"),
            row.get("halo_order", "axis"),
            row.get("halo_plan", "monolithic"),
            _platform_class(row),
        )
    if bench == "driver":
        return (
            "driver",
            row.get("metric"),
            row.get("grid"),
            row.get("dtype"),
            row.get("time_blocking", 1),
            row.get("backend", "auto"),
            _platform_class(row),
        )
    return None


def _rows_from_jsonl(path: str, start_line: int = 1, stop_line=None):
    """Bench rows from a JSONL results file, 1-indexed [start_line,
    stop_line) — the scoping handles "this session's rows" vs "the same
    file's earlier rows are history". Parsing is the shared
    ``roofline.iter_result_rows`` (one brace-tolerant parser for the
    whole perf package)."""
    from heat3d_tpu_torch.obs.perf.roofline import iter_result_rows

    rows = []
    try:
        row_iter = iter_result_rows(
            path,
            kinds=("throughput", "halo"),
            start_line=start_line,
            stop_line=stop_line,
        )
        for i, r in row_iter:
            r["_src"] = f"{path}:{i}"
            rows.append(r)
    except OSError:
        pass
    return rows


def _rows_from_driver_artifact(path: str) -> List[Dict[str, Any]]:
    """The committed BENCH_*.json driver artifacts: one record each
    (``parsed`` holds the JSON line bench.py printed). Converted to a
    pseudo-row keyed as bench='driver'."""
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, json.JSONDecodeError):
        return []
    rec = doc.get("parsed") if isinstance(doc, dict) else None
    if rec is None and isinstance(doc, dict) and "value" in doc:
        rec = doc
    if not (isinstance(rec, dict) and isinstance(rec.get("value"), (int, float))):
        return []
    detail = rec.get("detail") if isinstance(rec.get("detail"), dict) else {}
    return [
        {
            "bench": "driver",
            "metric": rec.get("metric"),
            "value": float(rec["value"]),
            "grid": detail.get("grid"),
            "dtype": detail.get("dtype"),
            "time_blocking": detail.get("time_blocking", 1),
            "backend": detail.get("backend", "auto"),
            "platform": detail.get("platform"),
            "cpu_fallback": bool(detail.get("cpu_fallback"))
            or bool(rec.get("error")),
            "_src": path,
        }
    ]


def load_history(paths: List[str]) -> List[Dict[str, Any]]:
    rows: List[Dict[str, Any]] = []
    for p in paths:
        if p.endswith(".json"):
            rows.extend(_rows_from_driver_artifact(p))
        else:
            rows.extend(_rows_from_jsonl(p))
    return rows


def compare(
    current: List[Dict[str, Any]],
    history: List[Dict[str, Any]],
    warn_pct: float = DEFAULT_WARN_PCT,
    fail_pct: float = DEFAULT_FAIL_PCT,
) -> Dict[str, Any]:
    """The gate. Returns the machine-readable report:
    ``{"verdict": "pass"|"warn"|"fail", "comparisons": [...],
    "no_baseline": [...], "skipped": [...]}``."""
    by_key: Dict[Tuple, List[Dict[str, Any]]] = {}
    for r in history:
        k = row_key(r)
        if k is not None and not r.get("rtt_dominated"):
            by_key.setdefault(k, []).append(r)

    comparisons, no_baseline, skipped = [], [], []
    for r in current:
        k = row_key(r)
        if k is None:
            continue
        bench = k[0]
        field, direction = METRICS[bench]
        members = r.get("members_per_step", 1)
        label = {
            "throughput": lambda r=r: (
                f"throughput {r.get('stencil', '7pt')} "
                f"{'x'.join(map(str, r.get('grid') or []))} "
                f"{r.get('dtype')} tb={r.get('time_blocking', 1)}"
                + (
                    f" B={members}"
                    if isinstance(members, int) and members > 1
                    else ""
                )
            ),
            "halo": lambda r=r: (
                f"halo {'x'.join(map(str, r.get('grid') or []))} "
                f"{r.get('dtype')}"
            ),
            "driver": lambda r=r: f"driver {r.get('metric')}",
        }[bench]()
        cur_v = r.get(field)
        if not isinstance(cur_v, (int, float)):
            skipped.append({"row": label, "reason": f"no {field}"})
            continue
        if r.get("rtt_dominated"):
            skipped.append({"row": label, "reason": "rtt_dominated"})
            continue
        # self-comparison can't happen through the CLI (current/history
        # split by line range, the current file is dropped from history
        # paths) — the identity check guards direct compare() callers only
        cands = [
            h.get(field)
            for h in by_key.get(k, [])
            if isinstance(h.get(field), (int, float)) and h is not r
        ]
        if not cands:
            no_baseline.append(
                {"row": label, "platform": _platform_class(r)}
            )
            continue
        baseline = max(cands) if direction > 0 else min(cands)
        # signed regression percentage: positive = worse
        if baseline == 0:
            skipped.append({"row": label, "reason": "zero baseline"})
            continue
        delta = (baseline - cur_v) / abs(baseline) * 100.0 * direction
        status = band_status(delta, warn_pct, fail_pct)
        comp = {
            "row": label,
            "metric": field,
            "platform": _platform_class(r),
            "current": cur_v,
            "baseline": baseline,
            "regression_pct": round(delta, 2),
            "status": status,
        }
        if bench == "throughput" and isinstance(members, int) and members > 1:
            # per-member effective rate: the honest serving number — the
            # aggregate counts every member's updates, so packing B
            # members multiplies it even when each member got slower
            comp["members_per_step"] = members
            comp["current_per_member"] = cur_v / members
            comp["baseline_per_member"] = baseline / members
        comparisons.append(comp)

    statuses = [c["status"] for c in comparisons]
    verdict = (
        "fail"
        if "fail" in statuses
        else "warn"
        if "warn" in statuses
        else "pass"
    )
    return {
        "verdict": verdict,
        "warn_pct": warn_pct,
        "fail_pct": fail_pct,
        "comparisons": comparisons,
        "no_baseline": no_baseline,
        "skipped": skipped,
    }


def filter_window(
    rows: List[Dict[str, Any]], window: Optional[int]
) -> List[Dict[str, Any]]:
    """History limited to the last ``window`` measurement SESSIONS, where
    a session is a distinct UTC measurement date (the ``ts`` provenance
    field every measured row carries). ``window`` None/0 keeps
    everything — the historical best-of-history behavior. Rows WITHOUT a
    parseable ``ts`` (pre-provenance rows, driver-artifact pseudo-rows)
    are excluded when a window is active: a baseline whose age cannot be
    established cannot be shown to be inside it — exactly the
    "ancient best row stops being reproducible" hygiene this knob exists
    for. Sessions are counted
    PER PLATFORM CLASS: two recent CPU debug sessions must not evict the
    TPU baseline pool (which the platform-aware keying exists to protect
    — windowing before it would disarm it). A negative window is a
    caller bug, not a slicing request — rejected."""
    if window is not None and window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if not window:
        return rows

    def _date(r: Dict[str, Any]) -> Optional[str]:
        ts = r.get("ts")
        if isinstance(ts, str) and len(ts) >= 10:
            d = ts[:10]
            if d[4:5] == "-" and d[7:8] == "-":
                return d
        return None

    dates_by_platform: Dict[str, set] = {}
    for r in rows:
        d = _date(r)
        if d:
            dates_by_platform.setdefault(_platform_class(r), set()).add(d)
    keep = {
        (plat, d)
        for plat, dates in dates_by_platform.items()
        for d in sorted(dates)[-window:]
    }
    return [
        r for r in rows if (_platform_class(r), _date(r)) in keep
    ]


def tune_notes() -> List[Dict[str, Any]]:
    """Tuning-store entries whose winning config differs from the static
    defaults — a tuned route change is a config change, not a silent
    regression, and these notes make that visible in the verdict (report
    field ``tuned_configs``; informational, never a comparison input).
    Fails soft to an empty list."""
    import dataclasses

    from heat3d_tpu_torch.core.config import SolverConfig

    # the static defaults ARE SolverConfig's field defaults — derived, so
    # a future default flip cannot desynchronize this report
    static = {
        f.name: f.default
        for f in dataclasses.fields(SolverConfig)
        if f.name in ("halo", "overlap", "time_blocking", "halo_order")
    }
    notes: List[Dict[str, Any]] = []
    try:
        from heat3d_tpu_torch.tune.cache import cache_path, load

        doc = load()
        for key, e in sorted((doc.get("entries") or {}).items()):
            if not isinstance(e, dict):
                continue
            cfgd = e.get("config") or {}
            flips = {
                k: cfgd.get(k)
                for k, dflt in static.items()
                if k in cfgd and cfgd.get(k) != dflt
            }
            if flips:
                notes.append(
                    {
                        "key": key,
                        "tuned": flips,
                        "config": cfgd,
                        "cache": cache_path(),
                    }
                )
    except Exception:  # noqa: BLE001 - awareness is informational
        return []
    return notes


def default_history_paths(current: Optional[str] = None) -> List[str]:
    """Default history: bench_results*.jsonl + BENCH_*.json next to the
    current results file AND in the working directory (a scratch-path
    session still sees the committed record; an out-of-repo invocation
    still finds the record next to its own file — without the anchor to
    ``current`` the gate passes vacuously from any other cwd)."""
    roots = [os.getcwd()]
    if current:
        d = os.path.dirname(os.path.abspath(current))
        if d not in roots:
            roots.append(d)
    out: List[str] = []
    seen = set()
    for root in roots:
        for pat in ("bench_results*.jsonl", "BENCH_*.json"):
            for p in sorted(_glob.glob(os.path.join(root, pat))):
                ap = os.path.abspath(p)
                if ap not in seen:
                    seen.add(ap)
                    out.append(p)
    return out


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="heat3d obs regress",
        description="perf-regression gate: compare bench rows against "
        "measured history with per-metric tolerance bands and "
        "platform-aware baselines",
    )
    ap.add_argument("current", help="this session's results file (.jsonl)")
    ap.add_argument(
        "--start-line", type=int, default=1,
        help="first line of CURRENT that belongs to this session (earlier "
        "lines become history — same scoping as the provenance lint)",
    )
    ap.add_argument(
        "--history", nargs="*", default=None,
        help="history files (.jsonl rows and/or BENCH_*.json driver "
        "artifacts); default: bench_results*.jsonl + BENCH_*.json in the "
        "current directory",
    )
    ap.add_argument("--warn-pct", type=float, default=DEFAULT_WARN_PCT)
    ap.add_argument("--fail-pct", type=float, default=DEFAULT_FAIL_PCT)
    def _window(s: str) -> int:
        n = int(s)
        if n < 0:
            raise argparse.ArgumentTypeError("--window must be >= 0")
        return n

    ap.add_argument(
        "--window", type=_window, default=None, metavar="N",
        help="baseline against the last N measurement sessions only "
        "(sessions = distinct UTC measurement dates from row ts "
        "provenance; rows without ts are excluded when windowing; 0 = "
        "all). Default: all of history",
    )
    ap.add_argument("--json", action="store_true",
                    help="print the machine-readable report (one JSON "
                    "object) instead of the table")
    args = ap.parse_args(argv)

    # a gate that can't read its input must say so, not pass vacuously
    # (a typo'd path would otherwise report "pass" forever)
    try:
        with open(args.current):
            pass
    except OSError as e:
        print(f"regress: cannot read current results: {e}", file=sys.stderr)
        return 2

    current = _rows_from_jsonl(args.current, start_line=args.start_line)
    history = _rows_from_jsonl(args.current, stop_line=args.start_line)
    hist_paths = (
        args.history
        if args.history is not None
        else default_history_paths(args.current)
    )
    cur_abs = os.path.abspath(args.current)
    history += load_history(
        [p for p in hist_paths if os.path.abspath(p) != cur_abs]
    )
    history = filter_window(history, args.window)
    report = compare(
        current, history, warn_pct=args.warn_pct, fail_pct=args.fail_pct
    )
    if args.window:
        report["window_sessions"] = args.window
    # autotune awareness: list cache entries that flipped a default knob,
    # so a route change reads as a route change, not a silent regression
    report["tuned_configs"] = tune_notes()

    if args.json:
        print(json.dumps(report))
    else:
        print(
            f"regress: {len(report['comparisons'])} compared, "
            f"{len(report['no_baseline'])} without baseline, "
            f"{len(report['skipped'])} skipped "
            f"(warn>{args.warn_pct}% fail>{args.fail_pct}%)"
        )
        for c in report["comparisons"]:
            arrow = {"pass": "ok  ", "warn": "WARN", "fail": "FAIL"}[
                c["status"]
            ]
            per_member = (
                f"  [{c['current_per_member']:.4g}/member]"
                if "current_per_member" in c
                else ""
            )
            print(
                f"  {arrow} {c['row']} [{c['platform']}]: "
                f"{c['current']:.4g} vs best {c['baseline']:.4g} "
                f"({c['regression_pct']:+.1f}% regression){per_member}"
            )
        for n in report["no_baseline"]:
            print(f"  new  {n['row']} [{n['platform']}]: no baseline")
        for s in report["skipped"]:
            print(f"  skip {s['row']}: {s['reason']}")
        for t in report["tuned_configs"]:
            flips = " ".join(f"{k}={v}" for k, v in t["tuned"].items())
            print(f"  note tune cache overrides defaults for {t['key']}: "
                  f"{flips}")
        print(f"verdict: {report['verdict']}")
    return 1 if report["verdict"] == "fail" else 0


if __name__ == "__main__":
    sys.exit(main())
