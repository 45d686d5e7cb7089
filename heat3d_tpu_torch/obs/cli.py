"""``heat3d obs`` — turn a run ledger into human-readable timelines and
p50/p95 tables.

Subcommands::

    heat3d obs summary LEDGER [--run RUN_ID]   # per-run spans + timeline
    heat3d obs tail LEDGER [-n N]              # last N events, one per line
    heat3d obs check LEDGER [...]              # schema lint (analysis/ledgerlint)
    heat3d obs roofline [...]                  # achieved-vs-peak (obs/perf/roofline)
    heat3d obs regress RESULTS [...]           # perf-regression gate (obs/perf/regress)
    heat3d obs merge LEDGERS... [...]          # multihost timeline join (obs/perf/merge)
    heat3d obs timeline LEDGERS... [...]       # Chrome-trace export + drift/stragglers (obs/perf/timeline)
    heat3d obs watch|slo|adjudicate ...        # not ported yet: exit 2

``summary`` is the operator's post-mortem view: for each run segment in
the ledger it prints the invocation, a span-duration table (count, total,
p50, p95 per event name), the derived **per-step latency** p50/p95
(reconstructed from ``steps``/``chunk`` spans carrying a ``steps`` field —
the number the bench harness computes independently at run time), and a
timeline of the notable events (faults, retries, heals, generation
transitions, checkpoint writes/quarantines) so an interrupted-and-resumed
session reads end to end.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from collections import defaultdict
from typing import Any, Dict, List, Optional

from heat3d_tpu_torch.obs.metrics import percentile

# events worth a timeline line (everything else shows in the span table)
NOTABLE = (
    "ledger_open",
    "run_start",
    "supervised_start",
    "fault_injected",
    "retry_outcome",
    "generation_save",
    "ckpt_corrupt",
    "ckpt_quarantine",
    "recovery",
    "elastic_refactor",
    "degraded_mode_enter",
    "degraded_mode_exit",
    "serve_requeue",
    "resume",
    "run_summary",
    "metrics_summary",
    "bench_row",
    "tune_search_start",
    "tune_trial",
    "tune_winner",
    "tune_budget_exhausted",
    "tune_cache_hit",
    "tune_cache_miss",
    "tune_cache_stale",
    "peak_calibrated",
    "serve_submit",
    "serve_batch_start",
    "serve_result",
    "serve_metrics_summary",
    "obs_anomaly",
    "slo_verdict",
    # live-monitor milestones (serve_span is deliberately absent: five
    # trace phases per delivered request would drown the timeline)
    "monitor_start",
    "slo_burn_alert",
    "monitor_summary",
    "timeline_export",
    # comm observatory (comm_probe is deliberately absent, like
    # serve_span: one row per link per probe pass would drown the
    # timeline — the per-link table renders them instead)
    "clock_align",
    "adjudicate_verdict",
    "run_end",
    "ledger_close",
)

# span names whose `steps` field makes them per-step latency samples
STEP_SPANS = ("steps", "chunk", "run_loop")


def read_ledger(path: str) -> List[Dict[str, Any]]:
    """All parseable events at ``path`` — including the rolled segments a
    HEAT3D_LEDGER_MAX_MB rotation left beside it (oldest first, so the
    concatenation is the writer's original append order). The base path
    must exist; a rolled sibling that races away mid-read is skipped."""
    from heat3d_tpu_torch.obs.ledger import ledger_segments

    events = []
    for seg in ledger_segments(path):
        try:
            f = open(seg)
        except OSError:
            if seg == path:
                raise
            continue
        with f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue  # the lint flags these; summary stays best-effort
                if isinstance(rec, dict):
                    events.append(rec)
    return events


def _fmt_ts(ts: Any) -> str:
    try:
        return time.strftime("%H:%M:%S", time.localtime(float(ts)))
    except (TypeError, ValueError):
        return "?"


def _fmt_s(v: Optional[float]) -> str:
    if v is None:
        return "-"
    if v >= 1.0:
        return f"{v:.3f}s"
    if v >= 1e-3:
        return f"{v * 1e3:.2f}ms"
    return f"{v * 1e6:.1f}us"


def step_latencies(events: List[Dict[str, Any]]) -> List[float]:
    """Per-step latency samples reconstructed from the step/chunk spans:
    one sample per span, dur_s / steps — the same rule the run-time
    metrics registry observes, so the two reconstructions are comparable."""
    out = []
    for r in events:
        if (
            r.get("kind") == "span"
            and r.get("event") in STEP_SPANS
            and r.get("status") == "ok"
            and isinstance(r.get("steps"), int)
            and r["steps"] > 0
            and isinstance(r.get("dur_s"), (int, float))
        ):
            out.append(float(r["dur_s"]) / r["steps"])
    return out


def _achieved_line(
    label: str,
    flops: Any,
    bytes_: Any,
    per_step_s: Any,
    platform: str,
) -> Optional[str]:
    """One roofline line: achieved GFLOP/s / GB/s for a per-step cost
    record against the platform's peak spec (obs/perf/roofline.py), or
    None when the record is incomplete."""
    if not (
        isinstance(per_step_s, (int, float))
        and per_step_s > 0
        and (isinstance(flops, (int, float)) or isinstance(bytes_, (int, float)))
    ):
        return None
    from heat3d_tpu_torch.obs.perf.roofline import peak_spec

    spec = peak_spec(platform)
    parts = []
    if isinstance(flops, (int, float)):
        g = flops / per_step_s / 1e9
        peak = spec.get("vector_gflops")
        pct = f" ({g / peak:.1%} of peak)" if peak else ""
        parts.append(f"{g:.2f} GFLOP/s{pct}")
    if isinstance(bytes_, (int, float)):
        g = bytes_ / per_step_s / 1e9
        peak = spec.get("mem_gbps")
        pct = f" ({g / peak:.1%} of peak)" if peak else ""
        parts.append(f"{g:.2f} GB/s{pct}")
    return f"   roofline {label} [{platform}]: " + "  ".join(parts)


def roofline_lines(events: List[Dict[str, Any]]) -> List[str]:
    """The ``roofline`` section of a run summary: achieved-vs-peak lines
    joining (a) bench_row events that carry the cost-analysis fields with
    their own measured seconds, and (b) a ``step_cost`` event with the
    run_loop span's per-step latency. Empty when the run recorded no cost
    telemetry; never raises (telemetry display fails soft too)."""
    lines: List[str] = []
    try:
        for r in events:
            if r.get("event") != "bench_row":
                continue
            grid = "x".join(str(g) for g in (r.get("grid") or []))
            if r.get("bench") == "halo" and isinstance(
                r.get("cost_bytes_per_step"), (int, float)
            ):
                # halo rows carry their own exchange-program bytes
                # (the analytic exchange bytes): the p50
                # divides them directly — no throughput-row join needed.
                # rtt_dominated rows are excluded, matching `obs regress`:
                # their p50 is mostly dispatch overhead, so bytes/p50
                # would claim an absurd fraction of peak
                p50 = r.get("p50_us")
                if (
                    isinstance(p50, (int, float))
                    and p50 > 0
                    and not r.get("rtt_dominated")
                ):
                    line = _achieved_line(
                        f"halo {grid} p50",
                        None,
                        r.get("cost_bytes_per_step"),
                        p50 * 1e-6,
                        str(r.get("platform", "?")),
                    )
                    if line:
                        lines.append(line)
                continue
            if isinstance(r.get("cost_flops_per_step"), (int, float)) or (
                isinstance(r.get("cost_bytes_per_step"), (int, float))
            ):
                steps = r.get("steps")
                sec = r.get("seconds_best")
                if isinstance(steps, int) and steps > 0 and isinstance(
                    sec, (int, float)
                ):
                    tb = r.get("time_blocking", 1)
                    label = f"bench {grid} tb={tb}"
                    # fused-route rows: say so in the label — the halo
                    # bytes ride inside the step kernel here, so these
                    # lines are not comparable to exchange-path rows of
                    # the same shape without the tag
                    if r.get("fused_rdma_path"):
                        label += " fused-rdma"
                    elif r.get("fused_dma_path"):
                        label += " fused-dma"
                    frac = r.get("cost_redundant_flops_frac")
                    if isinstance(frac, (int, float)) and frac > 0:
                        # deep-tb rows: flag how much of the raw rate is
                        # ghost-ring recompute, not simulated progress
                        label += f" ({frac:.0%} recompute)"
                    line = _achieved_line(
                        label,
                        r.get("cost_flops_per_step"),
                        r.get("cost_bytes_per_step"),
                        sec / steps,
                        str(r.get("platform", "?")),
                    )
                    if line:
                        lines.append(line)
        costs = [
            r
            for r in events
            if r.get("event") == "step_cost" and r.get("ok")
        ]
        loops = [
            r
            for r in events
            if r.get("kind") == "span"
            and r.get("event") == "run_loop"
            and isinstance(r.get("steps"), int)
            and r["steps"] > 0
            and isinstance(r.get("dur_s"), (int, float))
        ]
        if costs and loops:
            c, lp = costs[0], loops[0]
            line = _achieved_line(
                "run_loop",
                c.get("cost_flops_per_step"),
                c.get("cost_bytes_per_step"),
                lp["dur_s"] / lp["steps"],
                str(c.get("platform", "?")),
            )
            if line:
                lines.append(line)
    except Exception:  # noqa: BLE001 - a summary section must not kill summary
        return lines
    return lines


def ensemble_lines(events: List[Dict[str, Any]]) -> List[str]:
    """The ensemble section of a run summary: for every throughput
    bench_row aggregating more than one member per step (the batched
    scenario engine — docs/SERVING.md), print the total rate NEXT TO the
    per-member effective rate, so a packed batch's aggregate can never
    read as a single-run number. Empty for solo-only ledgers; never
    raises (summary sections fail soft)."""
    lines: List[str] = []
    try:
        for r in events:
            if r.get("event") != "bench_row" or r.get("bench") != "throughput":
                continue
            m = r.get("members_per_step")
            g = r.get("gcell_per_sec")
            if not (
                isinstance(m, int)
                and m > 1
                and isinstance(g, (int, float))
            ):
                continue
            grid = "x".join(str(x) for x in (r.get("grid") or []))
            bm = r.get("batch_mesh", 1)
            lines.append(
                f"   ensemble {grid} B={m} (batch_mesh={bm}): "
                f"{g:.4g} Gcell/s total -> {g / m:.4g} Gcell/s/member "
                f"effective"
            )
    except Exception:  # noqa: BLE001 - a summary section must not kill summary
        return lines
    return lines


def elastic_lines(events: List[Dict[str, Any]]) -> List[str]:
    """The elastic-degradation section of a run summary: each
    ``elastic_refactor`` (old mesh -> new mesh, re-stitch seconds) and
    the degraded windows (enter/exit pairs; an unclosed window is an
    honest ``still degraded``). Fails soft to [] like every summary
    section."""
    lines: List[str] = []
    try:
        for r in events:
            if r.get("event") == "elastic_refactor":
                lines.append(
                    f"   elastic {r.get('direction', 'degrade')}: "
                    f"mesh {r.get('old_mesh')} -> {r.get('new_mesh')} "
                    f"({r.get('survivors')} survivor(s), re-stitch "
                    f"{_fmt_s(r.get('restitch_s'))}) at step "
                    f"{r.get('step')}"
                )
            elif r.get("event") == "degraded_mode_enter":
                lines.append(
                    f"   degraded mode ENTER at step {r.get('step')} "
                    f"(mesh {r.get('mesh')})"
                )
            elif r.get("event") == "degraded_mode_exit":
                lines.append(
                    f"   degraded mode EXIT at step {r.get('step')} "
                    f"after {_fmt_s(r.get('degraded_s'))} "
                    f"(mesh {r.get('mesh')} restored)"
                )
        enters = sum(
            1 for r in events if r.get("event") == "degraded_mode_enter"
        )
        exits = sum(
            1 for r in events if r.get("event") == "degraded_mode_exit"
        )
        if enters > exits:
            lines.append("   degraded mode: still degraded at ledger end")
    except Exception:  # noqa: BLE001 - a summary section must not kill summary
        return []
    return lines


def summarize_run(run_id: str, events: List[Dict[str, Any]], out=None) -> None:
    out = out or sys.stdout
    head = events[0]
    procs = sorted({r.get("proc", 0) for r in events})
    print(f"\n== run {run_id} ({len(events)} events, procs {procs})", file=out)
    opens = [r for r in events if r.get("event") == "ledger_open"]
    if opens:
        argv = opens[0].get("argv")
        if argv:
            print(f"   argv: {' '.join(str(a) for a in argv)}", file=out)
    t_first, t_last = head.get("ts"), events[-1].get("ts")
    if isinstance(t_first, (int, float)) and isinstance(t_last, (int, float)):
        print(
            f"   wall: {_fmt_ts(t_first)} -> {_fmt_ts(t_last)} "
            f"({t_last - t_first:.3f}s)",
            file=out,
        )

    # span table
    by_name: Dict[str, List[float]] = defaultdict(list)
    errors: Dict[str, int] = defaultdict(int)
    for r in events:
        if r.get("kind") == "span" and isinstance(
            r.get("dur_s"), (int, float)
        ):
            by_name[r["event"]].append(float(r["dur_s"]))
            if r.get("status") == "error":
                errors[r["event"]] += 1
    if by_name:
        print(
            f"   {'span':<20} {'count':>6} {'total':>10} {'p50':>10} "
            f"{'p95':>10} {'err':>4}",
            file=out,
        )
        for name, durs in sorted(by_name.items(), key=lambda kv: -sum(kv[1])):
            print(
                f"   {name:<20} {len(durs):>6} {_fmt_s(sum(durs)):>10} "
                f"{_fmt_s(percentile(durs, 50)):>10} "
                f"{_fmt_s(percentile(durs, 95)):>10} "
                f"{errors.get(name, 0):>4}",
                file=out,
            )

    lat = step_latencies(events)
    if lat:
        print(
            f"   step latency ({len(lat)} chunks): "
            f"p50 {_fmt_s(percentile(lat, 50))}  "
            f"p95 {_fmt_s(percentile(lat, 95))}  "
            f"mean {_fmt_s(sum(lat) / len(lat))}",
            file=out,
        )

    # elastic-degradation section (docs/RESILIENCE.md): one line per
    # survivor-mesh re-factorization + the degraded windows, so an outage
    # that a run survived degraded is attributable at a glance
    for line in elastic_lines(events):
        print(line, file=out)

    # roofline section: cost-analysis telemetry joined with measured time
    for line in roofline_lines(events):
        print(line, file=out)

    # ensemble section: packed-batch rows split total vs per-member rate
    for line in ensemble_lines(events):
        print(line, file=out)

    # comm observatory: per-link probe table (obs/comm/report.py)
    try:
        from heat3d_tpu_torch.obs.comm.report import comm_lines

        for line in comm_lines(events):
            print(line, file=out)
    except Exception:  # noqa: BLE001 - a summary section must not kill summary
        pass

    # drift/straggler section: rolling-baseline step-time anomalies
    # (obs/perf/timeline.detect_anomalies — regress's tolerance bands);
    # fails soft like every other summary section
    try:
        from heat3d_tpu_torch.obs.perf.timeline import (
            detect_anomalies,
            format_anomaly,
        )

        anomalies = detect_anomalies(events)
        for a in anomalies[:8]:
            print(f"   {format_anomaly(a)}", file=out)
        if len(anomalies) > 8:
            print(f"   ... ({len(anomalies) - 8} more anomalies)", file=out)
    except Exception:  # noqa: BLE001 - a summary section must not kill summary
        pass

    # timeline of notable events
    shown = 0
    for r in events:
        name = r.get("event")
        if name not in NOTABLE or name == "ledger_open":
            continue
        detail_keys = [
            k
            for k in (
                "kind_", "step", "steps", "steps_done", "generation",
                "resumed_from", "stop_reason", "attempts", "fault", "path",
                "reason", "status", "bench", "grid", "ok",
                "key", "knobs", "applied", "speedup_vs_default",
                "vector_gflops",
                "request_id", "members", "padded", "queue_depth",
                "batch_members", "queue_latency_s",
                "verdict", "depth_max", "delivered", "batches",
                "span", "delta_pct", "events", "streams",
                "direction", "old_mesh", "new_mesh", "survivors",
                "restitch_s", "mesh", "degraded_s", "bucket", "attempt",
                "backoff_s", "anchor_event", "ci_s", "stages",
            )
            if k in r
        ]
        detail = " ".join(f"{k}={r[k]}" for k in detail_keys)
        print(f"   {_fmt_ts(r.get('ts'))} {name:<18} {detail}", file=out)
        shown += 1
        if shown >= 60:
            print("   ... (timeline truncated)", file=out)
            break


def cmd_summary(args) -> int:
    events = read_ledger(args.ledger)
    if not events:
        print(f"no events in {args.ledger}", file=sys.stderr)
        return 1
    runs: Dict[str, List[Dict[str, Any]]] = defaultdict(list)
    order: List[str] = []
    for r in events:
        rid = str(r.get("run_id"))
        if rid not in runs:
            order.append(rid)
        runs[rid].append(r)
    if args.run:
        if args.run not in runs:
            print(f"run {args.run} not in {args.ledger}", file=sys.stderr)
            return 1
        order = [args.run]
    print(f"ledger: {args.ledger} ({len(events)} events, {len(runs)} run(s))")
    for rid in order:
        summarize_run(rid, runs[rid])
    return 0


def _tail_line(r: Dict[str, Any]) -> str:
    base = (
        f"{_fmt_ts(r.get('ts'))} [{str(r.get('run_id'))[:8]}/"
        f"{r.get('proc', '?')}] {r.get('event', '?')}"
    )
    rest = {
        k: v
        for k, v in r.items()
        if k
        not in ("ts", "run_id", "proc", "seq", "event", "kind", "t0", "t1")
    }
    if r.get("kind") == "span":
        base += f" [{_fmt_s(rest.pop('dur_s', None))}]"
        rest.pop("depth", None)
    return f"{base} {json.dumps(rest, default=repr)}"


def cmd_tail(args) -> int:
    if getattr(args, "follow", False):
        return _tail_follow(args)
    events = read_ledger(args.ledger)
    for r in events[-args.n:]:
        print(_tail_line(r))
    return 0


def _tail_follow(args) -> int:
    """``tail --follow``: print the last N events, then poll the growing
    ledger (rotation-aware via LedgerTailer) until --duration elapses
    (0 = until interrupted)."""
    from heat3d_tpu_torch.obs.tailer import LedgerTailer

    tailer = LedgerTailer(args.ledger)
    deadline = (
        time.monotonic() + args.duration if args.duration > 0 else None
    )
    first = True
    try:
        while True:
            batch = tailer.poll()
            if first:
                batch = batch[-args.n:]
                first = False
            for r in batch:
                print(_tail_line(r))
            sys.stdout.flush()
            if deadline is not None and time.monotonic() >= deadline:
                return 0
            time.sleep(args.interval)
    except KeyboardInterrupt:
        return 0


def cmd_check(args) -> int:
    if getattr(args, "follow", False):
        return _check_follow(args)
    from heat3d_tpu_torch.obs.check import main as check_main

    flags = []
    if args.taxonomy:
        flags.append("--taxonomy")
    if args.start_line != 1:
        flags.extend(["--start-line", str(args.start_line)])
    return check_main(flags + args.ledgers)


def _check_follow(args) -> int:
    """``check --follow``: incremental live lint — tail each growing
    ledger and feed new lines through the same rules as the post-hoc
    check, reporting each defect once as it appears. rc 1 if any defect
    surfaced by the time --duration elapses (0 = until interrupted)."""
    from heat3d_tpu_torch.analysis.ledgerlint import StreamChecker
    from heat3d_tpu_torch.obs.tailer import LedgerTailer

    pairs = [
        (path, LedgerTailer(path), StreamChecker(taxonomy=args.taxonomy))
        for path in args.ledgers
    ]
    deadline = (
        time.monotonic() + args.duration if args.duration > 0 else None
    )
    defects = 0
    try:
        while True:
            for path, tailer, checker in pairs:
                for raw in tailer.poll_lines():
                    for line_no, desc in checker.feed(raw):
                        defects += 1
                        print(f"{path}:{line_no}: {desc}")
            sys.stdout.flush()
            if deadline is not None and time.monotonic() >= deadline:
                break
            time.sleep(args.interval)
    except KeyboardInterrupt:
        pass
    total = sum(c.lines_seen for _, _, c in pairs)
    print(
        f"check --follow: {total} line(s) across {len(pairs)} ledger(s), "
        f"{defects} defect(s)"
    )
    return 1 if defects else 0


def cmd_trace(args) -> int:
    """``obs trace LEDGER REQUEST``: one request's end-to-end
    decomposition — queue / pack / compute / deliver shares plus requeue
    gaps — reconstructed from its ``serve_span`` events (rotation-aware).
    ``REQUEST`` is the integer request id or the 12-hex trace id. rc 1
    when the request has no trace in the ledger, rc 2 unreadable."""
    try:
        events = read_ledger(args.ledger)
    except OSError as e:
        print(f"trace: cannot read ledger: {e}", file=sys.stderr)
        return 2
    want_rid: Optional[int] = None
    try:
        want_rid = int(args.request)
    except ValueError:
        pass
    spans = [
        r
        for r in events
        if r.get("event") == "serve_span"
        and isinstance(r.get("t0_wall"), (int, float))
        and isinstance(r.get("t1_wall"), (int, float))
        and (
            r.get("request_id") == want_rid
            if want_rid is not None
            else r.get("trace_id") == args.request
        )
    ]
    if not spans:
        print(
            f"trace: no serve_span events for request {args.request!r} "
            f"in {args.ledger}",
            file=sys.stderr,
        )
        return 1
    root = next((r for r in spans if r.get("span") == "request"), spans[0])
    t0 = min(float(r["t0_wall"]) for r in spans)
    total = max(float(root["t1_wall"]) - float(root["t0_wall"]), 1e-12)
    rid = root.get("request_id")
    # shed events cannot carry a request id (a shed request never got
    # one); requeues do — annotate from the serve_requeue events too
    requeues = [
        r
        for r in events
        if r.get("event") == "serve_requeue"
        and isinstance(r.get("request_ids"), list)
        and rid in r["request_ids"]
    ]
    phases = []
    for r in spans:
        w0, w1 = float(r["t0_wall"]), float(r["t1_wall"])
        rec = {
            "span": r.get("span"),
            "start_s": round(w0 - t0, 6),
            "dur_s": round(w1 - w0, 6),
            "share": round((w1 - w0) / total, 4),
        }
        for k in ("attempt", "backoff_s"):
            if r.get(k) is not None:
                rec[k] = r[k]
        phases.append(rec)
    phases.sort(key=lambda p: (p["start_s"], -p["dur_s"]))
    out = {
        "request_id": rid,
        "trace_id": root.get("trace_id"),
        "bucket": root.get("bucket"),
        "stream": root.get("stream"),
        "attempts": root.get("attempts"),
        "total_s": round(total, 6),
        "phases": phases,
        "requeues": len(requeues),
    }
    if args.as_json:
        print(json.dumps(out))
        return 0
    head = f"request {rid} trace {out['trace_id']}"
    if out.get("bucket"):
        head += f" bucket {out['bucket']}"
    if out.get("stream"):
        head += f" stream {out['stream']}"
    print(f"{head}: total {_fmt_s(total)} ({out['attempts']} attempt(s))")
    for p in phases:
        extra = ""
        if p["span"] == "requeue_gap":
            extra = (
                f"  (attempt {p.get('attempt')}, "
                f"backoff {_fmt_s(p.get('backoff_s'))})"
            )
        print(
            f"  {p['span']:<12} +{p['start_s']:.3f}s  "
            f"{_fmt_s(p['dur_s']):>10}  {p['share']:>7.1%}{extra}"
        )
    if requeues:
        print(f"  ({len(requeues)} serve_requeue event(s) touched this request)")
    return 0


# subcommands whose modules are not ported yet (the live serve-tier view,
# the SLO verdict, the A/B adjudication): they exit 2 with this note
NOT_PORTED = {
    "watch": "obs/burn.py and obs/perf/slo.py",
    "slo": "obs/perf/slo.py",
    "adjudicate": "obs/comm/adjudicate.py (it needs the autotuner's tune/decide.py)",
}


def not_ported(cmd: str) -> int:
    print(f"heat3d obs {cmd}: not ported yet (heat3d_tpu_torch has no "
          f"counterpart of the JAX package's {NOT_PORTED[cmd]})", file=sys.stderr)
    return 2


def main(argv: Optional[List[str]] = None) -> int:
    # these subcommands own their full argparse surfaces
    # (obs/perf/*.main, obs/comm/adjudicate.main); dispatch before the
    # ledger parser so their flags don't have to round-trip through it
    argv_l = list(sys.argv[1:] if argv is None else argv)
    owned = {
        "roofline": "heat3d_tpu_torch.obs.perf.roofline",
        "regress": "heat3d_tpu_torch.obs.perf.regress",
        "merge": "heat3d_tpu_torch.obs.perf.merge",
        "timeline": "heat3d_tpu_torch.obs.perf.timeline",
    }
    if argv_l and argv_l[0] in NOT_PORTED:
        return not_ported(argv_l[0])
    if argv_l and argv_l[0] in owned:
        import importlib

        mod = importlib.import_module(owned[argv_l[0]])
        return mod.main(argv_l[1:])

    p = argparse.ArgumentParser(
        prog="heat3d obs",
        description="inspect heat3d run ledgers (JSONL event streams) and "
        "judge performance (roofline / regress / merge — obs/perf)",
    )
    sub = p.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("summary", help="per-run span tables and timeline")
    s.add_argument("ledger")
    s.add_argument("--run", default=None, help="only this run_id")
    s.set_defaults(fn=cmd_summary)

    t = sub.add_parser("tail", help="last N events, one per line")
    t.add_argument("ledger")
    t.add_argument("-n", type=int, default=20)
    t.add_argument(
        "--follow", action="store_true",
        help="keep polling the growing ledger (rotation-aware)",
    )
    t.add_argument("--interval", type=float, default=0.5)
    t.add_argument(
        "--duration", type=float, default=0.0,
        help="stop following after this many seconds (0 = until ^C)",
    )
    t.set_defaults(fn=cmd_tail)

    c = sub.add_parser("check", help="schema lint (analysis/ledgerlint.py)")
    c.add_argument("ledgers", nargs="+")
    c.add_argument(
        "--taxonomy", action="store_true",
        help="also audit event names against the canonical registry "
        "(heat3d_tpu_torch/analysis/registry.py)",
    )
    c.add_argument(
        "--start-line", type=int, default=1,
        help="report only defects at/after this line (append-mode "
        "session scoping)",
    )
    c.add_argument(
        "--follow", action="store_true",
        help="live lint: tail the growing ledger(s) and report each "
        "defect once as it appears",
    )
    c.add_argument("--interval", type=float, default=0.5)
    c.add_argument(
        "--duration", type=float, default=0.0,
        help="stop following after this many seconds (0 = until ^C)",
    )
    c.set_defaults(fn=cmd_check)

    tr = sub.add_parser(
        "trace",
        help="one request's queue/pack/compute/deliver decomposition "
        "from its serve_span events",
    )
    tr.add_argument("ledger")
    tr.add_argument(
        "request", help="request id (integer) or 12-hex trace id"
    )
    tr.add_argument("--json", action="store_true", dest="as_json")
    tr.set_defaults(fn=cmd_trace)

    sub.add_parser(
        "watch", add_help=False,
        help="live serve-tier view (not ported yet: exits 2)",
    )

    # listed for --help discoverability; dispatched above before parsing
    sub.add_parser(
        "roofline", add_help=False,
        help="achieved-vs-peak: per-phase analytic-cost table (live) or "
        "the analytic row model over bench results",
    )
    sub.add_parser(
        "regress", add_help=False,
        help="perf-regression gate over bench history (pass/warn/fail)",
    )
    sub.add_parser(
        "merge", add_help=False,
        help="join per-process multihost ledgers with cross-host skew stats",
    )
    sub.add_parser(
        "timeline", add_help=False,
        help="unified performance timeline: Chrome-trace/Perfetto export "
        "+ step-time drift and host-straggler detection",
    )
    sub.add_parser(
        "slo", add_help=False,
        help="service-level objectives (not ported yet: exits 2)",
    )
    sub.add_parser(
        "adjudicate", add_help=False,
        help="A/B stage verdicts (not ported yet: exits 2)",
    )

    args = p.parse_args(argv_l)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
