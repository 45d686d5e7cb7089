"""Open-loop sustained-traffic soak: seeded load generation + verdict.

Port of ``heat3d_tpu.serve.loadgen``: the schedule (one seed's pure-Python
arrivals), the spec grammar, the warmup ladder, the live monitor and the
verdict are the JAX package's; the soak runs on the card unless the
caller names ``device='cpu'``.

``heat3d serve --loadgen SPEC.json`` replays a declarative scenario-mix
spec against the async engine the way real traffic arrives — OPEN LOOP
(arrivals keep coming whether or not the service keeps up; a closed-loop
generator would self-throttle and hide every overload bug this soak
exists to find), Poisson inter-arrivals per stream, an optional diurnal
ramp shaping the rate over the run, and per-stream adversarial bursts.
The whole schedule derives from ONE seed (spec ``seed``, else
``HEAT3D_LOADGEN_SEED``), so a soak run replays exactly: same arrival
times, same stream, same scenario per arrival.

Spec shape (docs/SERVING.md "Load, overload & soak")::

    {
      "duration_s": 60,
      "seed": 7,
      "rate_hz": 4.0,                     # aggregate peak, split by weight
      "ramp": {"kind": "diurnal", "period_s": 30, "min_frac": 0.25},
      "engine": {"max_batch": 4, "max_per_stream": 8, "workers": 2},
      "streams": [
        {"name": "tenant-a", "weight": 3,
         "scenarios": [{"grid": 16, "alpha": 0.5, "steps": 4}, ...]},
        {"name": "flood", "weight": 1,
         "burst": {"every_s": 10, "len_s": 2, "multiplier": 8},
         "scenarios": [...]}
      ],
      "slo": { ... inline SLO spec, optional ... }
    }

The run: (1) **warmup** — every bucket in the mix is prewarmed across
its full pow2 padded-size ladder (continuous batching makes the padded
member count — the warm-up key — depend on arrival timing, so zero
``compile_stall`` after warmup is only achievable by warming every size
a batch could pad to; soak specs keep ``max_batch`` small for exactly
this reason; here a "size" is the eager ensemble's warm-up pass,
serve/aot.py); (2) **replay** — arrivals submit open-loop, shed
submissions (typed ``Backpressure``) are counted, not retried, and the
engine's :meth:`~heat3d_tpu_torch.serve.engine.AsyncServeEngine.
prewarm_forecast` runs between arrivals; a collector thread consumes
``results()`` concurrently, checking per-stream delivery order; (3)
**verdict** — accounting (admitted + shed == submitted), order, zero
failures, zero post-warmup compile stalls, and the SLO evaluation
(``serve_latency`` percentiles per bucket with computed p99, and the
``serve_degraded`` budget — the chaos leg injects partial-device-loss
mid-soak via ``HEAT3D_FAULTS`` and this objective judges the recovery)
fold into one machine-checked ``soak_verdict``.
"""

from __future__ import annotations

import dataclasses
import math
import os
import random
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from heat3d_tpu_torch import obs
from heat3d_tpu_torch.core.config import SolverConfig
from heat3d_tpu_torch.serve.queue import Backpressure, _padded_size
from heat3d_tpu_torch.serve.scenario import Scenario, solver_bucket_key
from heat3d_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

ENV_LOADGEN_SEED = "HEAT3D_LOADGEN_SEED"

# the soak's default SLO when the spec carries none: generous latency
# bounds (CPU soak smokes must pass on loaded CI hosts) but a REAL
# degraded budget — the chaos leg is only meaningful if recovery is
# actually judged
DEFAULT_SOAK_SLO: Dict[str, Any] = {
    "default_spec": True,
    "objectives": [
        {"name": "soak-p95", "kind": "serve_latency",
         "percentile": 95, "max_s": 120.0},
        {"name": "soak-p99", "kind": "serve_latency",
         "percentile": 99, "max_s": 240.0},
        {"name": "soak-degraded", "kind": "serve_degraded",
         "max_s": 30.0},
    ],
}


@dataclasses.dataclass(frozen=True)
class Arrival:
    """One scheduled request: fires ``t`` seconds into the soak on
    ``stream``, submitting that stream's ``record_index``-th scenario."""

    t: float
    stream: str
    record_index: int


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"loadgen spec: {msg}")


def validate_mix(mix: Dict[str, Any]) -> Dict[str, Any]:
    """Validate a scenario-mix spec (raises ValueError with the exact
    field at fault — a soak that dies an hour in on a typo\'d key is a
    wasted hour)."""
    _require(isinstance(mix, dict), "top level must be an object")
    known = {
        "duration_s", "seed", "rate_hz", "ramp", "engine", "streams", "slo",
        "monitor",
    }
    unknown = set(mix) - known
    _require(not unknown, f"unknown key(s) {sorted(unknown)}")
    dur = mix.get("duration_s")
    _require(
        isinstance(dur, (int, float)) and dur > 0,
        "duration_s must be a positive number",
    )
    rate = mix.get("rate_hz", 2.0)
    _require(
        isinstance(rate, (int, float)) and rate > 0,
        "rate_hz must be a positive number",
    )
    seed = mix.get("seed")
    _require(
        seed is None or isinstance(seed, int),
        "seed must be an integer",
    )
    ramp = mix.get("ramp")
    if ramp is not None:
        _require(isinstance(ramp, dict), "ramp must be an object")
        _require(
            ramp.get("kind", "diurnal") == "diurnal",
            f"ramp.kind {ramp.get('kind')!r} unknown (only 'diurnal')",
        )
        period = ramp.get("period_s", dur)
        _require(
            isinstance(period, (int, float)) and period > 0,
            "ramp.period_s must be a positive number",
        )
        frac = ramp.get("min_frac", 0.25)
        _require(
            isinstance(frac, (int, float)) and 0 <= frac <= 1,
            "ramp.min_frac must be in [0, 1]",
        )
    streams = mix.get("streams")
    _require(
        isinstance(streams, list) and streams,
        "streams must be a non-empty list",
    )
    names = set()
    for i, s in enumerate(streams):
        _require(isinstance(s, dict), f"streams[{i}] must be an object")
        name = s.get("name")
        _require(
            isinstance(name, str) and name,
            f"streams[{i}].name must be a non-empty string",
        )
        _require(name not in names, f"duplicate stream name {name!r}")
        names.add(name)
        w = s.get("weight", 1.0)
        _require(
            isinstance(w, (int, float)) and w > 0,
            f"streams[{i}].weight must be positive",
        )
        r = s.get("rate_hz")
        _require(
            r is None or (isinstance(r, (int, float)) and r > 0),
            f"streams[{i}].rate_hz must be positive when present",
        )
        burst = s.get("burst")
        if burst is not None:
            _require(
                isinstance(burst, dict),
                f"streams[{i}].burst must be an object",
            )
            for k in ("every_s", "len_s", "multiplier"):
                v = burst.get(k)
                _require(
                    isinstance(v, (int, float)) and v > 0,
                    f"streams[{i}].burst.{k} must be a positive number",
                )
        recs = s.get("scenarios")
        _require(
            isinstance(recs, list) and recs,
            f"streams[{i}].scenarios must be a non-empty list",
        )
        for j, rec in enumerate(recs):
            _require(
                isinstance(rec, dict),
                f"streams[{i}].scenarios[{j}] must be an object",
            )
    engine = mix.get("engine", {})
    _require(isinstance(engine, dict), "engine must be an object")
    monitor = mix.get("monitor")
    if monitor is not None:
        _require(isinstance(monitor, dict), "monitor must be an object")
        mon_known = {
            "interval_s", "fast_window_s", "slow_window_s", "threshold"
        }
        unknown_m = set(monitor) - mon_known
        _require(
            not unknown_m, f"monitor: unknown key(s) {sorted(unknown_m)}"
        )
        for k in mon_known:
            v = monitor.get(k)
            _require(
                v is None or (isinstance(v, (int, float)) and v > 0),
                f"monitor.{k} must be a positive number",
            )
    return mix


def _rate_factor(t: float, ramp: Optional[Dict[str, Any]], dur: float) -> float:
    """The diurnal shape: rate multiplier in [min_frac, 1] at soak time
    ``t`` — a raised cosine trough-to-peak over each period, the
    small-scale analog of a day's traffic curve."""
    if not ramp:
        return 1.0
    period = float(ramp.get("period_s", dur))
    frac = float(ramp.get("min_frac", 0.25))
    return frac + (1.0 - frac) * 0.5 * (
        1.0 - math.cos(2.0 * math.pi * t / period)
    )


def _burst_factor(t: float, burst: Optional[Dict[str, Any]]) -> float:
    """Adversarial bursts: ``multiplier`` x rate for ``len_s`` seconds
    every ``every_s`` — the pattern that wedges naive global-cap
    queues."""
    if not burst:
        return 1.0
    every = float(burst["every_s"])
    if t % every < float(burst["len_s"]):
        return float(burst["multiplier"])
    return 1.0


def generate_arrivals(mix: Dict[str, Any]) -> List[Arrival]:
    """The deterministic schedule: per-stream non-homogeneous Poisson
    arrivals by thinning (draw at the stream's PEAK rate, accept with
    probability rate(t)/peak), each stream seeded from
    ``f"{seed}:{name}"`` so adding a stream never perturbs another's
    schedule. Merged in time order."""
    dur = float(mix["duration_s"])
    ramp = mix.get("ramp")
    seed = mix.get("seed")
    if seed is None:
        seed = int(os.environ.get(ENV_LOADGEN_SEED, "0") or 0)
    total_rate = float(mix.get("rate_hz", 2.0))
    weights = {
        s["name"]: float(s.get("weight", 1.0)) for s in mix["streams"]
    }
    wsum = sum(weights.values())
    out: List[Arrival] = []
    for s in mix["streams"]:
        name = s["name"]
        base_rate = (
            float(s["rate_hz"]) if s.get("rate_hz") is not None
            else total_rate * weights[name] / wsum
        )
        burst = s.get("burst")
        peak = base_rate * (
            float(burst["multiplier"]) if burst else 1.0
        )
        rng = random.Random(f"{seed}:{name}")
        n_rec = len(s["scenarios"])
        t = 0.0
        while True:
            t += rng.expovariate(peak)
            if t >= dur:
                break
            rate_t = (
                base_rate * _rate_factor(t, ramp, dur) * _burst_factor(t, burst)
            )
            if rng.random() * peak <= rate_t:
                out.append(
                    Arrival(t=t, stream=name, record_index=rng.randrange(n_rec))
                )
    out.sort(key=lambda a: (a.t, a.stream))
    return out


def _pow2_ladder(max_batch: int) -> List[int]:
    """Every padded size continuous batching can produce up to
    ``max_batch``: 1, 2, 4, ... then max_batch itself."""
    sizes = []
    p = 1
    while p < max_batch:
        sizes.append(p)
        p *= 2
    sizes.append(max_batch)
    return sizes


def _warmup(engine, bases: List[SolverConfig]) -> Tuple[int, float]:
    """Prewarm every (bucket, padded-size) pair the mix can produce and
    WAIT for the builds — the post-warmup zero-``compile_stall``
    criterion starts counting after this returns. Returns (batch sizes
    warmed, seconds)."""
    t0 = time.monotonic()
    seen = set()
    waits = []
    for base in bases:
        bucket = str(solver_bucket_key(base))
        for size in _pow2_ladder(engine.max_batch):
            padded = _padded_size(size, engine.max_batch, engine.batch_mesh)
            if (bucket, padded) in seen:
                continue
            seen.add((bucket, padded))
            ev = engine.prewarm(base, expected_members=size, forecast=size)
            if ev is not None:
                waits.append(ev)
    for ev in waits:
        ev.wait(timeout=600)
    return len(waits), time.monotonic() - t0


def _percentile(sorted_vals: List[float], pct: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = min(
        len(sorted_vals) - 1, max(0, int(math.ceil(pct / 100.0 * len(sorted_vals))) - 1)
    )
    return sorted_vals[idx]


class _Monitor:
    """The soak's live leg (``serve --loadgen --monitor``): a thread that
    tails the run's OWN ledger while the replay is in flight, re-judging
    the SLO spec as burn rate over sliding fast/slow windows
    (:class:`heat3d_tpu_torch.obs.burn.BurnEvaluator`), landing one
    ``slo_burn_alert`` per objective RISING EDGE (enter-alerting, not
    every tick), and — under ``abort_on_burn`` — tripping the abort
    event the arrivals loop honors, so a soak that is already condemned
    dies in minutes with a machine-readable partial verdict instead of
    burning its full duration."""

    def __init__(self, engine, cfg: Dict[str, Any], ledger_path: str):
        from heat3d_tpu_torch.obs.burn import BurnEvaluator
        from heat3d_tpu_torch.obs.tailer import LedgerTailer

        self._engine = engine
        self._spec = cfg["spec"]
        self.abort_on_burn = bool(cfg.get("abort_on_burn"))
        self.interval_s = float(cfg.get("interval_s") or 2.0)
        self._be = BurnEvaluator(
            self._spec,
            fast_s=cfg.get("fast_window_s"),
            slow_s=cfg.get("slow_window_s"),
            threshold=cfg.get("threshold"),
        )
        self._tailer = LedgerTailer(ledger_path)
        self.abort = threading.Event()
        self.alerts = 0
        self.alerted: List[str] = []
        self._was_alerting: set = set()
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, name="heat3d-soak-monitor", daemon=True
        )

    def start(self) -> None:
        obs.get().event(
            "monitor_start",
            interval_s=self.interval_s,
            fast_window_s=self._be.fast_s,
            slow_window_s=self._be.slow_s,
            threshold=self._be.threshold,
            abort_on_burn=self.abort_on_burn,
            objectives=[
                o.get("name", o.get("kind"))
                for o in self._spec.get("objectives", [])
            ],
        )
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            self._tick()

    def _tick(self) -> None:
        # flush the engine's summary first (dirty-gated no-op when
        # clean) so the cumulative degraded/requeue budgets the
        # evaluator carries stay current between deliveries
        self._engine._emit_summary()
        self._be.consume(self._tailer.poll())
        rep = self._be.evaluate()
        now_alerting = set(rep["alerting"])
        for obj in rep["objectives"]:
            name = obj["name"]
            if name not in now_alerting or name in self._was_alerting:
                continue
            self.alerts += 1
            self.alerted.append(name)
            obs.get().event(
                "slo_burn_alert",
                objective=name,
                kind_=obj["kind"],
                fast_burn=obj["fast"]["burn"],
                slow_burn=obj["slow"]["burn"],
                fast_window_s=rep["fast_window_s"],
                slow_window_s=rep["slow_window_s"],
                threshold=rep["threshold"],
                value=obj["fast"]["value"],
                bucket=obj["fast"].get("bucket"),
            )
            log.warning(
                "SLO burn alert: %s fast=%.3gx slow=%.3gx (threshold "
                "%.3gx)",
                name, obj["fast"]["burn"] or 0.0,
                obj["slow"]["burn"] or 0.0, rep["threshold"],
            )
        self._was_alerting = now_alerting
        if now_alerting and self.abort_on_burn:
            self.abort.set()

    def finalize(self) -> Dict[str, Any]:
        """Stop the thread, drain the tail (the engine's final
        ``serve_metrics_summary`` landed at shutdown), and emit
        ``monitor_summary`` — the live evaluator's final state fed
        through the same shared core a post-hoc ``heat3d obs slo`` on
        this ledger uses, so the two agree by construction (the soak
        battery pins it). Returns the verdict's ``monitor`` block."""
        self._stop.set()
        self._thread.join(timeout=60)
        self._be.consume(self._tailer.poll())
        final = self._be.final_verdict()
        info = {
            "alerts": self.alerts,
            "alerted": self.alerted,
            "aborted": self.abort.is_set(),
            "fast_window_s": self._be.fast_s,
            "slow_window_s": self._be.slow_s,
            "threshold": self._be.threshold,
            "final": final["verdict"],
            "objectives": [
                {
                    "name": o["name"],
                    "status": o["status"],
                    "burn_rate": o["burn_rate"],
                }
                for o in final["objectives"]
            ],
        }
        obs.get().event("monitor_summary", **info)
        return info


def run_soak(
    mix: Dict[str, Any],
    base_for_record,
    scenario_for_record,
    slo_spec: Optional[Dict[str, Any]] = None,
    monitor: Optional[Dict[str, Any]] = None,
    device=None,
) -> Dict[str, Any]:
    """Execute the soak: warmup, open-loop replay, collect, judge.

    ``base_for_record(record) -> SolverConfig`` and
    ``scenario_for_record(record) -> Scenario`` translate the spec's
    scenario records (the CLI passes its own request-record builders, so
    the spec grammar matches ``--requests`` exactly).

    Returns the verdict dict (also landed as a ``soak_verdict`` ledger
    event). SLO evaluation happens in the CALLER (the CLI owns the spec
    resolution + report printing); this returns the raw material —
    per-bucket latency percentiles merged into the engine summary.
    ``device`` places the engine's solvers (``cpu`` for the tests;
    default the card)."""
    from heat3d_tpu_torch.serve.engine import AsyncServeEngine

    mix = validate_mix(mix)
    seed = mix.get("seed")
    if seed is None:
        seed = int(os.environ.get(ENV_LOADGEN_SEED, "0") or 0)
    arrivals = generate_arrivals(mix)
    dur = float(mix["duration_s"])
    eng_kw = dict(mix.get("engine", {}))
    engine = AsyncServeEngine(autostart=True, device=device, **eng_kw)

    # live monitoring leg: constructed BEFORE warmup so a misconfigured
    # monitor (no ledger to tail) fails at soak start, started after —
    # warmup emits no serve traffic worth judging
    mon: Optional[_Monitor] = None
    if monitor is not None:
        ledger_path = obs.get().path
        if not ledger_path:
            raise ValueError(
                "--monitor needs a run ledger (--ledger or "
                "$HEAT3D_LEDGER) — the live evaluator tails the run's "
                "own event stream"
            )
        mon = _Monitor(engine, monitor, ledger_path)

    # resolve every stream's records to (base, scenario) ONCE — a bad
    # record must fail at soak start, not minutes in
    resolved: Dict[str, List[Tuple[SolverConfig, Scenario]]] = {}
    for s in mix["streams"]:
        resolved[s["name"]] = [
            (base_for_record(rec), scenario_for_record(rec))
            for rec in s["scenarios"]
        ]
    bases = [b for recs in resolved.values() for b, _ in recs]

    obs.get().event(
        "loadgen_start",
        seed=seed,
        duration_s=dur,
        arrivals=len(arrivals),
        streams=[s["name"] for s in mix["streams"]],
        rate_hz=mix.get("rate_hz", 2.0),
    )
    warmed, warmup_s = _warmup(engine, bases)
    warm_stalls = engine.stats()["aot"]["stalls"]
    log.info(
        "soak warmup: %d batch size(s) in %.1fs (%d stall(s) absorbed); "
        "replaying %d arrival(s) over %.0fs",
        warmed, warmup_s, warm_stalls, len(arrivals), dur,
    )

    # rid -> (stream, bucket, cells, submit_t); written by the submitter
    # BEFORE the engine can deliver the result, read by the collector
    meta: Dict[int, Tuple[str, str, int, float]] = {}
    meta_lock = threading.Lock()
    delivered_by_stream: Dict[str, List[int]] = {}
    bucket_lat: Dict[str, List[float]] = {}
    delivered_steps_cells = [0.0]
    order_ok = [True]

    stop_collect = threading.Event()

    def collect():
        # results() returns whenever nothing submitted remains
        # undelivered — which happens repeatedly in a soak whose service
        # keeps up with arrivals — so loop until the replay is over AND
        # the engine has drained
        while True:
            for res in engine.results():
                with meta_lock:
                    stream, bucket, cells, t_sub = meta[res.request_id]
                lst = delivered_by_stream.setdefault(stream, [])
                if lst and res.request_id <= lst[-1]:
                    order_ok[0] = False
                lst.append(res.request_id)
                bucket_lat.setdefault(bucket, []).append(
                    time.monotonic() - t_sub
                )
                delivered_steps_cells[0] += res.steps * cells
            if stop_collect.is_set():
                return
            time.sleep(0.02)

    collector = threading.Thread(
        target=collect, name="heat3d-soak-collect", daemon=True
    )
    collector.start()

    if mon is not None:
        mon.start()
    # the abort event doubles as the arrivals-loop sleep: an alert mid
    # inter-arrival gap wakes the loop immediately instead of after the
    # gap (an unmonitored soak keeps a plain never-set event — one code
    # path, zero behavior change)
    abort_ev = mon.abort if mon is not None else threading.Event()

    submitted = 0
    shed = 0
    t0 = time.monotonic()
    last_forecast = t0
    for a in arrivals:
        if abort_ev.is_set():
            break
        now = time.monotonic()
        target = t0 + a.t
        if target > now and abort_ev.wait(target - now):
            break
        base, scenario = resolved[a.stream][a.record_index]
        cells = int(
            base.grid.shape[0] * base.grid.shape[1] * base.grid.shape[2]
        )
        submitted += 1
        with meta_lock:
            try:
                rid = engine.submit(base, scenario, stream=a.stream)
            except Backpressure:
                shed += 1
                continue
            meta[rid] = (
                a.stream, str(solver_bucket_key(base)), cells,
                time.monotonic(),
            )
        if time.monotonic() - last_forecast >= 1.0:
            last_forecast = time.monotonic()
            engine.prewarm_forecast()

    engine.shutdown(wait=True)
    stop_collect.set()
    collector.join(timeout=600)
    elapsed = time.monotonic() - t0

    # finalize AFTER shutdown (the engine's final serve_metrics_summary
    # has landed) and BEFORE the soak_verdict event, so the ledger reads
    # monitor_summary -> soak_verdict in causal order
    aborted = abort_ev.is_set()
    mon_info = mon.finalize() if mon is not None else None

    stats = engine.stats()
    summary = engine.metrics_summary()
    # computed per-bucket percentiles (the engine summary's reservoir
    # carries p50/p95 — the soak verdict additionally wants p99, and
    # wants it from the FULL sample, not the reservoir)
    per_bucket: Dict[str, Dict[str, float]] = {}
    for bucket, lats in bucket_lat.items():
        lats.sort()
        per_bucket[bucket] = {
            "n": len(lats),
            "p50_s": round(_percentile(lats, 50), 6),
            "p95_s": round(_percentile(lats, 95), 6),
            "p99_s": round(_percentile(lats, 99), 6),
        }
    # merge p99 into the summary buckets so an SLO percentile-99
    # objective can read it through the normal path (the reservoir
    # carries p50/p95 only)
    for bucket_name, rec in summary.get("buckets", {}).items():
        pb = per_bucket.get(bucket_name)
        if pb:
            rec["p99_s"] = pb["p99_s"]

    stalls_after_warmup = stats["aot"]["stalls"] - warm_stalls
    accounting_ok = (
        submitted == stats["submitted"]
        and stats["admitted"] + stats["shed"] == stats["submitted"]
        and shed == stats["shed"]
    )
    delivered_all = (
        stats["delivered"] == stats["admitted"] - stats["cancelled"]
        and stats["failed"] == 0
    )
    sustained = (
        delivered_steps_cells[0] / 1e9 / elapsed if elapsed > 0 else 0.0
    )
    verdict = {
        "seed": seed,
        "duration_s": round(elapsed, 3),
        "planned_duration_s": dur,
        "arrivals": len(arrivals),
        "submitted": stats["submitted"],
        "admitted": stats["admitted"],
        "shed": stats["shed"],
        "shed_by_stream": stats["shed_by_stream"],
        "delivered": stats["delivered"],
        "failed": stats["failed"],
        "requeues": stats["requeues"],
        "degraded_s": stats["degraded_s"],
        "batches": stats["batches"],
        "scale_events": stats["scale_events"],
        "prewarmed": stats["prewarmed"],
        "warmup_s": round(warmup_s, 3),
        "compile_stall_after_warmup": stalls_after_warmup,
        "sustained_member_gcell_per_s": round(sustained, 6),
        "per_bucket": per_bucket,
        "order_ok": order_ok[0],
        "accounting_ok": accounting_ok,
        "aot": stats["aot"],
        # an aborted soak is judged on what it replayed: ``partial``
        # flags the truncated schedule, ``aborted`` condemns the verdict
        # (rc 1 in the CLI) — the early-termination contract
        "aborted": aborted,
        "partial": stats["submitted"] < len(arrivals),
        "ok": bool(
            accounting_ok
            and order_ok[0]
            and delivered_all
            and stalls_after_warmup == 0
            and not aborted
        ),
        "summary": summary,
    }
    if aborted:
        verdict["abort_reason"] = "slo_burn"
    if mon_info is not None:
        verdict["monitor"] = mon_info
    obs.get().event(
        "soak_verdict",
        ok=verdict["ok"],
        aborted=aborted,
        seed=seed,
        duration_s=verdict["duration_s"],
        submitted=verdict["submitted"],
        admitted=verdict["admitted"],
        shed=verdict["shed"],
        delivered=verdict["delivered"],
        failed=verdict["failed"],
        requeues=verdict["requeues"],
        degraded_s=verdict["degraded_s"],
        compile_stall_after_warmup=stalls_after_warmup,
        sustained_member_gcell_per_s=verdict["sustained_member_gcell_per_s"],
        order_ok=order_ok[0],
        accounting_ok=accounting_ok,
    )
    return verdict


def soak_row(
    verdict: Dict[str, Any], slo_verdict: str, ts: Optional[str] = None,
    device=None,
) -> Dict[str, Any]:
    """The committed provenance row (``bench=soak``; the JAX package's
    provenance lint holds it — admitted + shed must equal submitted, the
    seed must replay the schedule, and the SLO verdict that judged the
    soak rides on the row). ``platform``/``devices``/``device_name`` are
    the torch device the soak ran on (``device``; default the card): the
    JAX row reads ``jax.default_backend()`` and ``jax.devices()``."""
    import datetime

    import torch

    dev = torch.device(device) if device is not None else torch.device("cuda")
    on_card = dev.type == "cuda"
    return {
        "ts": ts or datetime.datetime.now(datetime.timezone.utc).strftime(
            "%Y-%m-%dT%H:%M:%SZ"
        ),
        "bench": "soak",
        "platform": "gpu" if on_card else dev.type,
        "devices": torch.cuda.device_count() if on_card else 1,
        "device_name": torch.cuda.get_device_name(dev) if on_card else str(dev),
        "seed": verdict["seed"],
        "duration_s": verdict["duration_s"],
        "arrivals": verdict["arrivals"],
        "submitted": verdict["submitted"],
        "admitted": verdict["admitted"],
        "shed": verdict["shed"],
        "delivered": verdict["delivered"],
        "failed": verdict["failed"],
        "requeues": verdict["requeues"],
        "degraded_s": verdict["degraded_s"],
        "batches": verdict["batches"],
        "scale_events": verdict["scale_events"],
        "warmup_s": verdict["warmup_s"],
        "compile_stall_after_warmup": verdict["compile_stall_after_warmup"],
        "sustained_member_gcell_per_s": verdict[
            "sustained_member_gcell_per_s"
        ],
        "per_bucket": verdict["per_bucket"],
        "slo": slo_verdict,
        "ok": verdict["ok"],
    }
