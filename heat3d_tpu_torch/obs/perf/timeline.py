"""Unified performance timeline: one normalized event model over the run
ledger, ``obs merge``'d multihost streams, and ``--profile`` captures.

The paper's whole premise is overlap — compute hiding communication — yet
until this module no single command could answer "what fraction of a real
step was stencil vs halo vs stall". Three consumers share the model:

- **Chrome-trace export** (``heat3d obs timeline LEDGER -o trace.json``):
  ledger spans become nested ``X`` slices per process stream (multihost
  ledgers keep their ``src`` tags as separate process tracks), point
  events become instants, and a profile capture's per-phase device totals
  ride along as an aggregate track — one file, openable in Perfetto
  (ui.perfetto.dev) or ``chrome://tracing``.
- **Profile→roofline join**: :func:`profile_phase_totals` turns a
  ``--profile`` capture (a ``torch.profiler`` Chrome trace) into measured
  device microseconds per ``heat3d.*`` phase (the range names
  ``parallel.step.PHASES`` pins): each kernel, copy or fill on the card
  goes to the innermost ``heat3d.*`` range that held its launch, joined
  through the launch record's correlation id. ``obs roofline
  --from-profile`` divides the analytic FLOPs/bytes by it — achieved-vs-
  peak from *measured device time*, not span wall-clock — and
  :func:`device_activity` adds the device busy share of the timed window
  (the union of device intervals over every shard stream) and its longest
  idle gaps.
- **Drift/straggler detection** (:func:`detect_anomalies`): rolling
  per-span baselines over the per-step latency samples, classified with
  the same tolerance bands as ``obs regress`` (``band_status``), plus a
  cross-stream straggler check on merged multihost ledgers. Findings
  surface in ``obs summary``, in ``obs timeline --anomalies``, and as
  ``obs_anomaly`` ledger events.

The trace parsing is pure and works on the parsed JSON, so tests drive it
with synthetic traces.

Wall-time normalization: ledger spans carry ``t0``/``t1`` (per-process
monotonic) and ``ts`` (wall clock at write — spans are written AT CLOSE),
so a span's wall start is ``ts - dur_s`` without any cross-stream clock
fitting; cross-host placement inherits whatever wall-clock skew ``obs
merge`` already quantifies rather than pretending to correct it.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import sys
from collections import defaultdict
from typing import Any, Dict, List, Optional, Tuple

# ---- torch.profiler trace parsing ------------------------------------------

# innermost heat3d phase token in a range name: ranges nest
# (heat3d.step > heat3d.halo_exchange > heat3d.halo.x), and the INNERMOST
# range holding a launch is the phase that launch belongs to. The (?!py\b)
# lookahead keeps Python frames ("heat3d.py:301 run") from masquerading as
# a phase named "heat3d.py". Dotted sub-phases ("heat3d.halo.x") are one
# token: the continuation admits further components unless they open with
# a digit.
PHASE_RE = re.compile(
    r"heat3d\.(?!py\b)[A-Za-z_][A-Za-z0-9_]*"
    r"(?:\.(?!py\b)[A-Za-z_][A-Za-z0-9_]*)*"
)

# the device-side event categories of a torch.profiler Chrome trace
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# host records of a launch: the runtime call (cudaLaunchKernel, cudaMemcpyAsync
# ...) or, when the runtime is linked statically, the driver call
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
# the annotation range that marks the timed window (cli.py's run loop)
WINDOW_RANGE = "heat3d.run_loop"
UNATTRIBUTED = "(unattributed)"


def find_trace(logdir: str) -> Optional[str]:
    """The newest Chrome-trace JSON (``*.pt.trace.json``) under
    ``logdir``, or None."""
    pats = os.path.join(logdir, "**", "*.pt.trace.json")
    files = glob.glob(pats, recursive=True)
    return max(files, key=os.path.getmtime) if files else None


def phase_name(op_name: str):
    """The heat3d phase a range name carries (its innermost ``heat3d.*``
    token), or None for names outside any phase."""
    hits = PHASE_RE.findall(op_name)
    return hits[-1] if hits else None


def phase_totals(totals):
    """Group per-name totals by heat3d phase; names outside a phase land
    in ``(unattributed)``."""
    phases = defaultdict(float)
    for name, us in totals.items():
        phases[phase_name(name) or UNATTRIBUTED] += us
    return dict(phases)


def normalize_phase(token: str) -> str:
    """Canonical phase key for a ``heat3d.*`` range token: the prefix is
    stripped and the halo sub-ranges — per-axis (``halo.x``) and
    per-direction (``halo.x.lo``) — fold into ``halo_exchange``, so the
    roofline/timeline joins keep attributing the finer-grained exchange
    ranges to the one exchange phase instead of ``(unattributed)``. The
    names then join ``parallel.step.phase_programs`` / the ledger spans on
    one key."""
    if token.startswith("heat3d."):
        token = token[len("heat3d."):]
    if token == "halo" or token.startswith("halo."):
        return "halo_exchange"
    return token


def load_trace(path: str) -> Dict[str, Any]:
    """Parse one Chrome-trace JSON file (``torch.profiler``'s
    ``export_chrome_trace``)."""
    with open(path) as f:
        doc = json.load(f)
    if isinstance(doc, list):  # the bare-array form of the format
        doc = {"traceEvents": doc}
    return doc


def _num(v) -> Optional[float]:
    return float(v) if isinstance(v, (int, float)) else None


class _Ranges:
    """The ``heat3d.*`` ranges of one track (host thread or device
    stream), sorted by start: :meth:`innermost` finds the range holding a
    time (the latest-starting one that still covers it: ranges of one
    track nest)."""

    def __init__(self):
        self.items: List[Tuple[float, float, str]] = []
        self._starts: List[float] = []

    def add(self, t0: float, t1: float, name: str) -> None:
        self.items.append((t0, t1, name))

    def seal(self) -> None:
        self.items.sort(key=lambda r: (r[0], -r[1]))
        self._starts = [r[0] for r in self.items]

    def innermost(self, t: float) -> Optional[str]:
        import bisect

        i = bisect.bisect_right(self._starts, t)
        while i > 0:
            i -= 1
            t0, t1, name = self.items[i]
            if t0 <= t <= t1:
                return name
        return None

    def covering(self, t: float) -> List[str]:
        """Every range holding ``t``, outermost first."""
        return [n for t0, t1, n in self.items if t0 <= t <= t1]


def _collect(trace: Dict[str, Any]):
    """(device events, launch records by correlation, host annotation
    ranges by thread, device annotation ranges by stream, host cpu ops by
    thread) of a parsed trace."""
    device, launches = [], {}
    host_ranges: Dict[Any, _Ranges] = defaultdict(_Ranges)
    gpu_ranges: Dict[Any, _Ranges] = defaultdict(_Ranges)
    host_ops: Dict[Any, _Ranges] = defaultdict(_Ranges)
    for ev in trace.get("traceEvents") or []:
        if not isinstance(ev, dict) or ev.get("ph") != "X":
            continue
        cat = ev.get("cat")
        ts, dur = _num(ev.get("ts")), _num(ev.get("dur"))
        if ts is None or dur is None:
            continue
        args = ev.get("args") or {}
        name = str(ev.get("name", "?"))
        if cat in DEVICE_CATS:
            device.append({
                "name": name, "cat": cat, "t0": ts, "t1": ts + dur, "dur": dur,
                "corr": args.get("correlation"),
                "track": (ev.get("pid"), ev.get("tid")),
            })
        elif cat in LAUNCH_CATS:
            corr = args.get("correlation")
            if corr is not None:
                launches[corr] = (ts, (ev.get("pid"), ev.get("tid")))
        elif cat == "user_annotation" and name.startswith("heat3d."):
            host_ranges[(ev.get("pid"), ev.get("tid"))].add(ts, ts + dur, name)
        elif cat == "gpu_user_annotation" and name.startswith("heat3d."):
            gpu_ranges[(ev.get("pid"), ev.get("tid"))].add(ts, ts + dur, name)
        elif cat == "cpu_op":
            host_ops[(ev.get("pid"), ev.get("tid"))].add(ts, ts + dur, name)
    for group in (host_ranges, gpu_ranges, host_ops):
        for r in group.values():
            r.seal()
    return device, launches, host_ranges, gpu_ranges, host_ops


def _assign(device, launches, host_ranges, gpu_ranges) -> Dict[str, int]:
    """Give each device event its ``range`` (the innermost ``heat3d.*``
    range holding its launch on the launching host thread, joined through
    ``args.correlation``; failing that, the innermost device-side
    annotation range of its stream holding its start) and its ``window``
    flag (launched inside :data:`WINDOW_RANGE`). Returns how many events
    each way went."""
    how = {"correlation": 0, "stream": 0, "none": 0}
    for ev in device:
        ev["range"], ev["window"] = None, False
        launch = launches.get(ev["corr"])
        if launch is not None:
            t, thread = launch
            ranges = host_ranges.get(thread)
            if ranges is not None:
                ev["range"] = ranges.innermost(t)
                ev["window"] = WINDOW_RANGE in ranges.covering(t)
            ev["launch_t"] = t
            how["correlation"] += 1
            continue
        ranges = gpu_ranges.get(ev["track"])
        if ranges is not None:
            ev["range"] = ranges.innermost(ev["t0"])
            ev["window"] = WINDOW_RANGE in ranges.covering(ev["t0"])
        how["stream" if ev["range"] is not None else "none"] += 1
    return how


def device_phase_totals(trace: Dict[str, Any], window: bool = False) -> Dict[str, float]:
    """Measured device microseconds per normalized phase of a parsed
    torch trace: every device event (``cat`` kernel, gpu_memcpy,
    gpu_memset) goes to the innermost ``heat3d.*`` range that holds its
    launch (see :func:`device_activity`). Device time outside every range
    lands in ``(unattributed)`` — the honest bucket for launches the
    phase ranges don't cover. ``window``: only the events launched inside
    the timed window (:data:`WINDOW_RANGE`, when the trace has it)."""
    return device_activity(trace, window=window)["phase_us"]


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for t0, t1 in sorted(intervals):
        if out and t0 <= out[-1][1]:
            if t1 > out[-1][1]:
                out[-1] = (out[-1][0], t1)
        else:
            out.append((t0, t1))
    return out


def device_activity(trace: Dict[str, Any], window: bool = True,
                    gaps: int = 5) -> Dict[str, Any]:
    """What the device did in a parsed torch trace:

    - ``phase_us``: device us per normalized phase (innermost range of the
      launch; the host range joined through the launch record's
      correlation id, else the stream's device-side annotation ranges);
    - ``kernels``: device us and count per event name;
    - ``busy_us``: the union of the device intervals over every stream
      and device (overlapping shard streams count once), ``window_us``:
      first device start to last device end, and ``busy_share`` =
      busy / window;
    - ``gaps``: the ``gaps`` longest idle stretches inside the window,
      each with the host ``heat3d.*`` range and the innermost host op open
      at its midpoint on the launching thread;
    - ``host_ranges``: the ``heat3d.*`` ranges that thread opened inside
      the timed window (:data:`WINDOW_RANGE`);
    - ``assigned``: how many events joined by correlation, by stream, not
      at all.

    ``window``: only events launched inside the timed window
    (:data:`WINDOW_RANGE`), when the trace has that range."""
    device, launches, host_ranges, gpu_ranges, host_ops = _collect(trace)
    how = _assign(device, launches, host_ranges, gpu_ranges)
    if window and any(ev["window"] for ev in device):
        device = [ev for ev in device if ev["window"]]
    phase_us: Dict[str, float] = defaultdict(float)
    kernels: Dict[str, Dict[str, float]] = {}
    for ev in device:
        key = UNATTRIBUTED if ev["range"] is None else normalize_phase(ev["range"])
        phase_us[key] += ev["dur"]
        k = kernels.setdefault(ev["name"], {"us": 0.0, "count": 0})
        k["us"] += ev["dur"]
        k["count"] += 1
    busy = _union([(ev["t0"], ev["t1"]) for ev in device])
    busy_us = sum(t1 - t0 for t0, t1 in busy)
    window_us = (busy[-1][1] - busy[0][0]) if busy else 0.0
    # the host thread that launched most: its ranges name each gap
    threads = defaultdict(int)
    for ev in device:
        if "launch_t" in ev:
            threads[launches[ev["corr"]][1]] += 1
    main = max(threads, key=threads.get) if threads else None
    # the phase ranges the launching thread opened inside the window
    ranges = 0
    if main in host_ranges:
        spans = host_ranges[main].items
        wins = [(t0, t1) for t0, t1, n in spans if n == WINDOW_RANGE]
        ranges = sum(1 for t0, t1, n in spans if n != WINDOW_RANGE
                     and any(w0 <= t0 and t1 <= w1 for w0, w1 in wins))
    idle = sorted(((b[0] - a[1], a[1], b[0]) for a, b in zip(busy, busy[1:])),
                  reverse=True)[:gaps]
    gap_list = []
    for length, t0, t1 in idle:
        mid = 0.5 * (t0 + t1)
        rng = host_ranges[main].innermost(mid) if main in host_ranges else None
        op = host_ops[main].innermost(mid) if main in host_ops else None
        gap_list.append({"us": length, "t0": t0, "host_range": rng, "host_op": op})
    return {
        "phase_us": dict(phase_us),
        "kernels": kernels,
        "busy_us": busy_us,
        "window_us": window_us,
        "busy_share": (busy_us / window_us) if window_us > 0 else None,
        "gaps": gap_list,
        "events": len(device),
        "host_ranges": ranges,
        "assigned": how,
    }


def profile_phase_totals(path: str) -> Tuple[Dict[str, float], str]:
    """``(phase -> device us, artifact path)`` for a profile capture
    (``--profile DIR`` output, or one ``.pt.trace.json`` directly), over
    the timed window (:func:`device_activity` has the busy time, the
    window's length and the idle gaps besides). Raises RuntimeError when
    there is no artifact or no device events — the join consumers report
    that instead of printing an empty table."""
    artifact = path
    if os.path.isdir(path):
        artifact = find_trace(path)
        if artifact is None:
            raise RuntimeError(f"no .pt.trace.json under {path}")
    totals = device_activity(load_trace(artifact))["phase_us"]
    if not totals:
        raise RuntimeError(f"no device events in {artifact}")
    return totals, artifact


# ---- ledger -> normalized timeline ----------------------------------------


def timeline_events(events: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """The normalized event model: one record per ledger event with a
    wall-clock placement. Spans are written at close, so wall start is
    ``ts - dur_s``; points sit at ``ts``. Events without a numeric ``ts``
    are dropped (the ledger lint flags them; the timeline stays
    best-effort). ``src`` survives from ``obs merge``'d streams."""
    out: List[Dict[str, Any]] = []
    for r in events:
        ts = r.get("ts")
        if not isinstance(ts, (int, float)):
            continue
        rec = {
            "name": str(r.get("event", "?")),
            "kind": "span" if r.get("kind") == "span" else "point",
            "src": str(r.get("src", "")),
            "proc": r.get("proc", 0),
            "run_id": str(r.get("run_id", "")),
            "depth": r.get("depth", 0),
        }
        if rec["kind"] == "span" and isinstance(
            r.get("dur_s"), (int, float)
        ):
            rec["t_wall"] = float(ts) - float(r["dur_s"])
            rec["dur_s"] = float(r["dur_s"])
        else:
            # spans missing dur_s degrade to instants — best-effort, like
            # every other ledger reader
            rec["t_wall"] = float(ts)
            rec["dur_s"] = None
        rec["args"] = {
            k: v
            for k, v in r.items()
            if k
            not in (
                "ts", "run_id", "proc", "seq", "event", "kind",
                "t0", "t1", "dur_s", "depth", "src",
            )
        }
        out.append(rec)
    out.sort(key=lambda e: e["t_wall"])
    return out


def to_chrome_trace(
    tl_events: List[Dict[str, Any]],
    profile_totals: Optional[Dict[str, float]] = None,
) -> Dict[str, Any]:
    """Chrome-trace/Perfetto JSON (the legacy ``traceEvents`` format) from
    normalized timeline events. One integer pid per (src, proc) stream
    (named via ``M`` metadata events), spans as ``X`` complete events
    (nesting renders from time containment — the ledger guarantees proper
    per-thread nesting), points as ``i`` instants. A profile capture's
    per-phase totals export as ONE aggregate track: each phase is a slice
    whose duration is its total device time — honest about being an
    aggregate, not a placement (per-kernel placement lives in the
    capture's own Chrome trace, which Perfetto opens natively). ``serve_span`` request-trace
    events (points carrying wall-clock ``t0_wall``/``t1_wall`` — see
    serve/queue.new_trace) additionally render as a per-request
    waterfall: one dedicated pid, one tid per request, the queue / pack /
    compute / deliver phases (and requeue gaps) as slices under the
    request's root span."""
    trace: List[Dict[str, Any]] = []
    req_spans = [
        e
        for e in tl_events
        if e["name"] == "serve_span"
        and isinstance(e["args"].get("t0_wall"), (int, float))
        and isinstance(e["args"].get("t1_wall"), (int, float))
    ]
    if tl_events:
        base = min(e["t_wall"] for e in tl_events)
        if req_spans:
            # a request's queue phase starts at submit — earlier than any
            # serve_span EMISSION ts; the origin must cover it
            base = min(
                base, min(e["args"]["t0_wall"] for e in req_spans)
            )
    else:
        base = 0.0
    pids: Dict[Tuple[str, Any], int] = {}
    req_ids = {id(e) for e in req_spans}
    for e in tl_events:
        if id(e) in req_ids:
            continue  # rendered on the waterfall track below, not as instants
        stream = (e["src"], e["proc"])
        if stream not in pids:
            pid = len(pids) + 1
            pids[stream] = pid
            label = e["src"] or "ledger"
            trace.append(
                {
                    "name": "process_name", "ph": "M", "pid": pid,
                    "args": {"name": f"{label}/proc{e['proc']}"},
                }
            )
        pid = pids[stream]
        ts_us = round((e["t_wall"] - base) * 1e6, 3)
        if e["dur_s"] is not None:
            trace.append(
                {
                    "name": e["name"], "ph": "X", "pid": pid, "tid": 0,
                    "ts": ts_us, "dur": round(e["dur_s"] * 1e6, 3),
                    "args": e["args"],
                }
            )
        else:
            trace.append(
                {
                    "name": e["name"], "ph": "i", "s": "p", "pid": pid,
                    "tid": 0, "ts": ts_us, "args": e["args"],
                }
            )
    if req_spans:
        # the per-request waterfall: one tid per request, phases as X
        # slices at their wall-clock bounds (the root "request" span
        # contains its phases by time, so Perfetto nests them)
        pid = len(pids) + 1
        trace.append(
            {
                "name": "process_name", "ph": "M", "pid": pid,
                "args": {"name": "requests (serve traces)"},
            }
        )
        tids: Dict[Any, int] = {}
        for e in req_spans:
            a = e["args"]
            rid = a.get("request_id")
            if rid not in tids:
                tids[rid] = len(tids)
                trace.append(
                    {
                        "name": "thread_name", "ph": "M", "pid": pid,
                        "tid": tids[rid],
                        "args": {
                            "name": f"req {rid} [{a.get('trace_id')}]"
                        },
                    }
                )
            t0w, t1w = float(a["t0_wall"]), float(a["t1_wall"])
            trace.append(
                {
                    "name": str(a.get("span", "?")), "ph": "X",
                    "pid": pid, "tid": tids[rid],
                    "ts": round((t0w - base) * 1e6, 3),
                    "dur": round(max(t1w - t0w, 0.0) * 1e6, 3),
                    "args": {
                        k: v
                        for k, v in a.items()
                        if k not in ("t0_wall", "t1_wall") and v is not None
                    },
                }
            )
    if profile_totals:
        pid = len(pids) + 2 if req_spans else len(pids) + 1
        trace.append(
            {
                "name": "process_name", "ph": "M", "pid": pid,
                "args": {"name": "device profile (per-phase aggregate)"},
            }
        )
        for tid, (phase, us) in enumerate(
            sorted(profile_totals.items(), key=lambda kv: -kv[1])
        ):
            trace.append(
                {
                    "name": "thread_name", "ph": "M", "pid": pid,
                    "tid": tid, "args": {"name": phase},
                }
            )
            trace.append(
                {
                    "name": phase, "ph": "X", "pid": pid, "tid": tid,
                    "ts": 0.0, "dur": round(us, 3),
                    "args": {"aggregate_device_us": round(us, 3)},
                }
            )
    return {"traceEvents": trace, "displayTimeUnit": "ms"}


# ---- drift / straggler detection ------------------------------------------

# how many leading samples seed a rolling baseline before judging starts
BASELINE_SAMPLES = 4


def _span_samples(
    events: List[Dict[str, Any]],
) -> Dict[Tuple[str, Any, str, str], List[float]]:
    """Ordered latency samples per (src, proc, run_id, span name): for
    the step spans (``obs.cli.STEP_SPANS``) the sample is per-step
    latency (dur_s / steps — the same rule ``obs summary`` reconstructs
    with); for every other ok span it is the raw duration. run_id is in
    the key because one ledger file holds MANY run segments (APPEND
    bench sessions, the suite ledger) with legitimately different step
    times — a baseline must never cross a run boundary, or every
    config change reads as drift."""
    from heat3d_tpu_torch.obs.cli import STEP_SPANS

    out: Dict[Tuple[str, Any, str, str], List[float]] = defaultdict(list)
    for r in events:
        if r.get("kind") != "span" or r.get("status") != "ok":
            continue
        dur = r.get("dur_s")
        if not isinstance(dur, (int, float)):
            continue
        name = str(r.get("event"))
        key = (
            str(r.get("src", "")), r.get("proc", 0),
            str(r.get("run_id", "")), name,
        )
        if name in STEP_SPANS:
            steps = r.get("steps")
            if isinstance(steps, int) and steps > 0:
                out[key].append(float(dur) / steps)
        else:
            out[key].append(float(dur))
    return out


def detect_anomalies(
    events: List[Dict[str, Any]],
    warn_pct: Optional[float] = None,
    fail_pct: Optional[float] = None,
    baseline: int = BASELINE_SAMPLES,
) -> List[Dict[str, Any]]:
    """Step-time drift and host stragglers from a (possibly merged)
    ledger, classified with the SAME tolerance bands as ``obs regress``
    (latency regresses upward; default warn >8% / fail >15%).

    - **Drift** (``kind_: span_drift``): per (src, proc, run, span-name)
      stream — the run_id in the key keeps a baseline from crossing run
      boundaries, so an APPEND-session ledger of differently-configured
      runs doesn't read as drift — a rolling baseline (the p50 of the
      last ``baseline`` ACCEPTED samples; flagged samples don't poison
      it, so a sustained slowdown keeps firing instead of absorbing into
      the baseline) judges every sample after the seed window.
    - **Straggler** (``kind_: host_straggler``): with two or more
      distinct (src, proc) HOST identities carrying step samples (an
      ``obs merge``'d pod ledger, or multi-proc), each host's per-step
      p50 is judged against the fleet p50. Sequential runs in a
      single-host ledger are ONE identity — never compared against each
      other. DURATION-based, so it is immune to wall-clock skew.
    - **Late starter** (``kind_: start_straggler``): cross-host
      comparison of step-span WALL STARTS (``ts - dur_s``), matched by
      per-host sample index and judged as a fraction of the fleet's
      step-span p50. This one READS WALL CLOCKS, so it is exactly as
      trustworthy as the clocks are aligned: on raw merged ledgers a
      skewed host clock masquerades as a late starter, and ``obs merge
      --align`` / ``obs timeline --align`` is the documented cure (the
      tests pin both directions). Only LATE hosts flag — a fast clock
      reads as early, which is not a straggler.
    - **Slow link** (``kind_: link_straggler``): per-(axis, direction)
      ``comm_probe`` samples (the ``HEAT3D_COMM_PROBE`` probe — sub-block
      rows fold into their parent link) compared across hosts: each
      host's per-link p50 is judged against the fleet p50 for the SAME
      link, naming the slow link rather than just the slow host.
      DURATION-based like host_straggler, so skew-immune.

    All percentiles use ``obs.metrics.percentile`` (nearest-rank) — the
    one rule every obs reconstruction shares. Returns records ready to
    print (``format_anomaly``) or to emit as ``obs_anomaly`` ledger
    events (``emit_anomalies``); ``fail`` records sort first."""
    from heat3d_tpu_torch.obs.cli import STEP_SPANS
    from heat3d_tpu_torch.obs.metrics import percentile
    from heat3d_tpu_torch.obs.perf.regress import (
        DEFAULT_FAIL_PCT,
        DEFAULT_WARN_PCT,
        band_status,
    )

    warn_pct = DEFAULT_WARN_PCT if warn_pct is None else warn_pct
    fail_pct = DEFAULT_FAIL_PCT if fail_pct is None else fail_pct
    anomalies: List[Dict[str, Any]] = []
    samples = _span_samples(events)

    for (src, proc, run_id, name), vals in sorted(samples.items()):
        if len(vals) <= baseline:
            continue
        accepted = list(vals[:baseline])
        for i, v in enumerate(vals[baseline:], start=baseline):
            base = percentile(accepted[-baseline:], 50)
            if base <= 0:
                accepted.append(v)
                continue
            delta = (v - base) / base * 100.0
            status = band_status(delta, warn_pct, fail_pct)
            if status == "pass":
                accepted.append(v)
                continue
            anomalies.append(
                {
                    "kind_": "span_drift",
                    "span": name,
                    "src": src,
                    "proc": proc,
                    "run_id_": run_id,
                    "sample": i,
                    "value_s": round(v, 9),
                    "baseline_s": round(base, 9),
                    "delta_pct": round(delta, 2),
                    "status": status,
                    "per_step": name in STEP_SPANS,
                }
            )

    # straggler: cross-HOST comparison of per-step p50s (runs merged per
    # host — every host mixes the same session's runs, so the comparison
    # stays apples-to-apples)
    step_streams: Dict[Tuple[str, Any], List[float]] = defaultdict(list)
    for (src, proc, run_id, name), vals in samples.items():
        if name in STEP_SPANS and vals:
            step_streams[(src, proc)].extend(vals)
    if len(step_streams) > 1:
        p50s = {
            k: percentile(v, 50) for k, v in sorted(step_streams.items())
        }
        fleet = percentile(list(p50s.values()), 50)
        if fleet > 0:
            for (src, proc), p50 in p50s.items():
                delta = (p50 - fleet) / fleet * 100.0
                status = band_status(delta, warn_pct, fail_pct)
                if status != "pass":
                    anomalies.append(
                        {
                            "kind_": "host_straggler",
                            "src": src,
                            "proc": proc,
                            "p50_s": round(p50, 9),
                            "fleet_p50_s": round(fleet, 9),
                            "delta_pct": round(delta, 2),
                            "status": status,
                        }
                    )
    # late starter: cross-host comparison of step-span WALL STARTS
    # (ts - dur_s), index-matched so step i is compared against the
    # fleet's step i. Judged as a fraction of the fleet step-span p50;
    # wall-clock-based by construction (see docstring) — feed it aligned
    # time (obs merge --align) on multihost ledgers.
    start_streams: Dict[Tuple[str, Any], List[float]] = defaultdict(list)
    span_durs: List[float] = []
    for r in events:
        if r.get("kind") != "span" or r.get("status") != "ok":
            continue
        if str(r.get("event")) not in STEP_SPANS:
            continue
        ts, dur = r.get("ts"), r.get("dur_s")
        if isinstance(ts, (int, float)) and isinstance(dur, (int, float)):
            start_streams[(str(r.get("src", "")), r.get("proc", 0))].append(
                float(ts) - float(dur)
            )
            span_durs.append(float(dur))
    if len(start_streams) > 1 and span_durs:
        fleet_dur = percentile(span_durs, 50)
        n = min(len(v) for v in start_streams.values())
        if fleet_dur > 0 and n > 0:
            hosts = sorted(start_streams)
            med = [
                percentile([start_streams[h][i] for h in hosts], 50)
                for i in range(n)
            ]
            for h in hosts:
                offs = [start_streams[h][i] - med[i] for i in range(n)]
                off = percentile(offs, 50)
                delta = off / fleet_dur * 100.0
                status = band_status(delta, warn_pct, fail_pct)
                if status != "pass":
                    anomalies.append(
                        {
                            "kind_": "start_straggler",
                            "src": h[0],
                            "proc": h[1],
                            "offset_s": round(off, 9),
                            "fleet_span_p50_s": round(fleet_dur, 9),
                            "delta_pct": round(delta, 2),
                            "status": status,
                        }
                    )

    # slow link: per-(axis, direction) comm_probe samples compared
    # across hosts — the link, not just the host, gets named. Sub-block
    # rows fold into their parent link (one attribution unit).
    by_link: Dict[
        Tuple[str, str], Dict[Tuple[str, Any], List[float]]
    ] = defaultdict(lambda: defaultdict(list))
    for r in events:
        if r.get("event") != "comm_probe":
            continue
        t, ax, dr = r.get("t_s"), r.get("axis_name"), r.get("direction")
        if (
            isinstance(t, (int, float))
            and t > 0
            and isinstance(ax, str)
            and dr in ("lo", "hi")
        ):
            by_link[(ax, str(dr))][
                (str(r.get("src", "")), r.get("proc", 0))
            ].append(float(t))
    for (ax, dr), hosts_d in sorted(by_link.items()):
        if len(hosts_d) < 2:
            continue  # a link seen by one host has no fleet to lag
        p50s = {h: percentile(v, 50) for h, v in sorted(hosts_d.items())}
        fleet = percentile(list(p50s.values()), 50)
        if fleet <= 0:
            continue
        for (src, proc), p50 in p50s.items():
            delta = (p50 - fleet) / fleet * 100.0
            status = band_status(delta, warn_pct, fail_pct)
            if status != "pass":
                anomalies.append(
                    {
                        "kind_": "link_straggler",
                        "src": src,
                        "proc": proc,
                        "axis": ax,
                        "direction": dr,
                        "p50_s": round(p50, 9),
                        "fleet_p50_s": round(fleet, 9),
                        "delta_pct": round(delta, 2),
                        "status": status,
                    }
                )

    anomalies.sort(key=lambda a: (a["status"] != "fail", -a["delta_pct"]))
    return anomalies


def format_anomaly(a: Dict[str, Any]) -> str:
    tag = {"fail": "ANOMALY", "warn": "drift?"}.get(a["status"], a["status"])
    who = f"{a['src'] + '/' if a.get('src') else ''}proc{a.get('proc', 0)}"
    if a.get("kind_") == "host_straggler":
        return (
            f"{tag} straggler {who}: step p50 {a['p50_s'] * 1e3:.3f}ms vs "
            f"fleet {a['fleet_p50_s'] * 1e3:.3f}ms ({a['delta_pct']:+.1f}%)"
        )
    if a.get("kind_") == "start_straggler":
        return (
            f"{tag} late starter {who}: steps begin "
            f"{a['offset_s'] * 1e3:+.3f}ms vs fleet "
            f"({a['delta_pct']:+.1f}% of a step span; wall-clock-based — "
            "align merged ledgers first)"
        )
    if a.get("kind_") == "link_straggler":
        return (
            f"{tag} slow link {a.get('axis')}.{a.get('direction')} {who}: "
            f"p50 {a['p50_s'] * 1e6:.1f}us vs fleet "
            f"{a['fleet_p50_s'] * 1e6:.1f}us ({a['delta_pct']:+.1f}%)"
        )
    unit = "/step" if a.get("per_step") else ""
    return (
        f"{tag} {a.get('span')} {who} sample {a.get('sample')}: "
        f"{a['value_s'] * 1e3:.3f}ms{unit} vs baseline "
        f"{a['baseline_s'] * 1e3:.3f}ms ({a['delta_pct']:+.1f}%)"
    )


def emit_anomalies(anomalies: List[Dict[str, Any]]) -> None:
    """Append each anomaly as an ``obs_anomaly`` ledger event (a no-op
    without an active ledger — detection is read-side, the events are for
    pipelines that run the detector right after the run they observed)."""
    from heat3d_tpu_torch import obs

    for a in anomalies:
        obs.get().event("obs_anomaly", **a)


# ---- CLI -------------------------------------------------------------------


def _read_streams(
    paths: List[str], align: bool = False
) -> List[Dict[str, Any]]:
    """One ledger reads directly; several merge through
    ``obs.perf.merge.merge_ledgers`` so each keeps its ``src`` tag (the
    straggler detector and the per-stream tracks key on it).
    ``align=True`` merges onto the anchor-aligned clock (obs merge
    --align) so the wall-clock-based detectors judge estimated true
    time; it is meaningless (and ignored) for a single ledger."""
    if len(paths) == 1:
        from heat3d_tpu_torch.obs.cli import read_ledger

        return read_ledger(paths[0])
    from heat3d_tpu_torch.obs.perf.merge import merge_ledgers

    return merge_ledgers(paths, align=align)["events"]


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="heat3d obs timeline",
        description="unified performance timeline: normalize a run "
        "ledger (or several multihost ledgers) plus an optional "
        "--profile capture into one event model; export Chrome-trace/"
        "Perfetto JSON and detect step-time drift / host stragglers",
    )
    ap.add_argument("ledgers", nargs="+", help="run ledger file(s); "
                    "several are src-tagged and merged (obs merge)")
    ap.add_argument("-o", "--out", default=None, metavar="TRACE.json",
                    help="write the Chrome-trace JSON here (open in "
                    "Perfetto: ui.perfetto.dev)")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="profile capture dir (or .pt.trace.json): adds the "
                    "per-phase device-time aggregate track and the phase "
                    "table")
    ap.add_argument("--align", action="store_true",
                    help="merge multiple ledgers onto the anchor-aligned "
                    "clock (obs merge --align) before detection, so a "
                    "skewed host clock cannot masquerade as a late "
                    "starter")
    ap.add_argument("--anomalies", action="store_true",
                    help="also emit obs_anomaly ledger events for every "
                    "detected drift/straggler (detection itself always "
                    "runs)")
    ap.add_argument("--warn-pct", type=float, default=None,
                    help="drift warn band (default: obs regress's 8)")
    ap.add_argument("--fail-pct", type=float, default=None,
                    help="drift fail band (default: obs regress's 15)")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable report instead of the text "
                    "summary")
    args = ap.parse_args(argv)

    try:
        events = _read_streams(args.ledgers, align=args.align)
    except OSError as e:
        print(f"timeline: cannot read ledger: {e}", file=sys.stderr)
        return 2
    if not events:
        print(f"timeline: no events in {' '.join(args.ledgers)}",
              file=sys.stderr)
        return 1

    tl = timeline_events(events)
    profile_totals: Optional[Dict[str, float]] = None
    profile_note = None
    if args.profile:
        try:
            profile_totals, artifact = profile_phase_totals(args.profile)
            profile_note = artifact
        except (RuntimeError, OSError) as e:
            # the ledger timeline is still worth exporting without the
            # device track — degrade with a note, like every obs reader
            print(f"timeline: profile ignored ({e})", file=sys.stderr)

    anomalies = detect_anomalies(
        events, warn_pct=args.warn_pct, fail_pct=args.fail_pct
    )
    if args.anomalies and anomalies:
        emit_anomalies(anomalies)

    out_path = None
    if args.out:
        doc = to_chrome_trace(tl, profile_totals)
        with open(args.out, "w") as f:
            json.dump(doc, f)
        out_path = args.out
        from heat3d_tpu_torch import obs

        obs.get().event(
            "timeline_export",
            path=os.path.abspath(args.out),
            events=len(doc["traceEvents"]),
            streams=len({(e["src"], e["proc"]) for e in tl}),
            anomalies=len(anomalies),
        )

    spans = sum(1 for e in tl if e["dur_s"] is not None)
    if args.json:
        print(
            json.dumps(
                {
                    "events": len(tl),
                    "spans": spans,
                    "streams": len({(e["src"], e["proc"]) for e in tl}),
                    "out": out_path,
                    "profile": profile_note,
                    "phase_device_us": profile_totals,
                    "anomalies": anomalies,
                }
            )
        )
        return 0
    streams = len({(e["src"], e["proc"]) for e in tl})
    wall = tl[-1]["t_wall"] - tl[0]["t_wall"] if len(tl) > 1 else 0.0
    print(
        f"timeline: {len(tl)} events ({spans} spans) across {streams} "
        f"stream(s), {wall:.3f}s wall"
    )
    if profile_totals:
        total = sum(profile_totals.values()) or 1.0
        print(f"device time by phase ({profile_note}):")
        for phase, us in sorted(
            profile_totals.items(), key=lambda kv: -kv[1]
        ):
            print(f"  {us / 1e3:9.3f} ms  {100.0 * us / total:5.1f}%  {phase}")
    for a in anomalies[:10]:
        print("  " + format_anomaly(a))
    if len(anomalies) > 10:
        print(f"  ... ({len(anomalies) - 10} more anomalies)")
    if not anomalies:
        print("no drift/straggler anomalies detected")
    if out_path:
        print(f"wrote {out_path} (open in Perfetto: ui.perfetto.dev)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
