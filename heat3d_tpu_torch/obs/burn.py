"""Streaming SLO evaluation: burn rate over sliding windows, live.

Port of ``heat3d_tpu.obs.burn`` (pure Python: the same windows, knobs,
alerts and final verdict).

``obs slo`` is post-hoc — a breach at minute 7 of an hours-long soak is
only discovered after the session is spent. :class:`BurnEvaluator`
consumes ledger events incrementally (from
:class:`heat3d_tpu_torch.obs.tailer.LedgerTailer`) and re-judges the SAME
objective spec continuously, as **burn rate over a fast/slow window
pair** (the SRE multi-window rule): an objective is *alerting* only when
BOTH windows burn at or above the threshold — the fast window for
responsiveness, the slow window so a single spike cannot page.

State is bounded: per-bucket latency samples live in ring-buffered
deques pruned past the slow window; nothing grows with run length except
the (tiny) step-time sample list, itself hard-capped.

The per-objective judgment is
:func:`heat3d_tpu_torch.obs.perf.slo.evaluate_objective` — the one shared core
the post-hoc gate also uses — and :meth:`final_verdict` feeds the same
inputs post-hoc evaluation would read from the finished ledger (last
``serve_metrics_summary``, cumulative step samples) through
:func:`~heat3d_tpu_torch.obs.perf.slo.evaluate`, so the live evaluator's final
state and a later ``heat3d obs slo`` on the same ledger agree by
construction (test-pinned in the soak battery).

Window semantics per objective kind:

- ``serve_latency`` — windowed per-bucket percentiles over the
  ``serve_result`` samples inside each window (worst bucket governs,
  same as post-hoc).
- ``step_time`` — windowed percentile over the step-span samples.
- ``serve_degraded`` — cumulative ``degraded_s`` from the latest
  ``serve_metrics_summary`` (a budget, not a rate: both windows see the
  same cumulative value).
- ``halo_share`` — needs a profile capture; always ``no_data`` live.
"""

from __future__ import annotations

import os
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Tuple

ENV_BURN_FAST = "HEAT3D_BURN_FAST_S"
ENV_BURN_SLOW = "HEAT3D_BURN_SLOW_S"
ENV_BURN_THRESHOLD = "HEAT3D_BURN_THRESHOLD"

DEFAULT_FAST_S = 60.0
DEFAULT_SLOW_S = 300.0
DEFAULT_THRESHOLD = 1.0

# per-bucket ring size: at the soak's observed arrival rates this holds
# far more than a slow window's worth; the cap only guards pathology
WINDOW_SAMPLE_CAP = 4096
STEP_SAMPLE_CAP = 100_000

# windowed counts of these flag the watch view's anomaly line
ANOMALY_EVENTS = (
    "serve_requeue",
    "serve_shed",
    "fault_injected",
    "worker_scale",
)


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name, "")
    if not raw:
        return default
    try:
        v = float(raw)
    except ValueError:
        return default
    return v if v > 0 else default


class BurnEvaluator:
    """Windowed incremental SLO evaluation over a live event stream."""

    def __init__(
        self,
        spec: Dict[str, Any],
        fast_s: Optional[float] = None,
        slow_s: Optional[float] = None,
        threshold: Optional[float] = None,
        warn_ratio: Optional[float] = None,
        min_samples: int = 1,
    ):
        from heat3d_tpu_torch.obs.perf.slo import _warn_ratio

        self.spec = spec
        self.fast_s = fast_s or _env_float(ENV_BURN_FAST, DEFAULT_FAST_S)
        self.slow_s = slow_s or _env_float(ENV_BURN_SLOW, DEFAULT_SLOW_S)
        if self.slow_s < self.fast_s:
            self.slow_s = self.fast_s
        self.threshold = (
            threshold
            if threshold is not None
            else _env_float(ENV_BURN_THRESHOLD, DEFAULT_THRESHOLD)
        )
        self.min_samples = max(1, min_samples)
        self._warn = _warn_ratio(spec, warn_ratio)
        # (wall ts, latency_s) per bucket, pruned past the slow window
        self._lat: Dict[str, Deque[Tuple[float, float]]] = {}
        self._steps: Deque[Tuple[float, float]] = deque(
            maxlen=STEP_SAMPLE_CAP
        )
        self._arrivals: Deque[float] = deque(maxlen=WINDOW_SAMPLE_CAP)
        self._deliveries: Deque[float] = deque(maxlen=WINDOW_SAMPLE_CAP)
        self._anomalies: Dict[str, Deque[float]] = {
            name: deque(maxlen=WINDOW_SAMPLE_CAP) for name in ANOMALY_EVENTS
        }
        self._last_summary: Optional[Dict[str, Any]] = None
        self._last_depth: Optional[int] = None
        self._all_lat: List[float] = []  # pre-summary fallback only
        self._t_end: Optional[float] = None  # live edge = max ts seen
        self.events_seen = 0

    # ---- ingest ----------------------------------------------------------

    def consume(self, events: List[Dict[str, Any]]) -> None:
        from heat3d_tpu_torch.obs.cli import STEP_SPANS

        for r in events:
            ts = r.get("ts")
            if not isinstance(ts, (int, float)):
                continue
            self.events_seen += 1
            if self._t_end is None or ts > self._t_end:
                self._t_end = float(ts)
            name = r.get("event")
            if name == "serve_result" and isinstance(
                r.get("queue_latency_s"), (int, float)
            ):
                bucket = str(r.get("bucket", "(all)"))
                dq = self._lat.get(bucket)
                if dq is None:
                    dq = self._lat[bucket] = deque(maxlen=WINDOW_SAMPLE_CAP)
                dq.append((float(ts), float(r["queue_latency_s"])))
                self._deliveries.append(float(ts))
                if self._last_summary is None:
                    self._all_lat.append(float(r["queue_latency_s"]))
            elif name == "serve_submit":
                self._arrivals.append(float(ts))
                if isinstance(r.get("queue_depth"), int):
                    self._last_depth = r["queue_depth"]
            elif name == "serve_metrics_summary" and isinstance(
                r.get("buckets"), dict
            ):
                self._last_summary = r
                self._all_lat = []  # superseded; drop the fallback state
            elif name in self._anomalies:
                self._anomalies[name].append(float(ts))
            elif (
                r.get("kind") == "span"
                and name in STEP_SPANS
                and r.get("status") == "ok"
                and isinstance(r.get("steps"), int)
                and r["steps"] > 0
                and isinstance(r.get("dur_s"), (int, float))
            ):
                self._steps.append(
                    (float(ts), float(r["dur_s"]) / r["steps"])
                )
        self._prune()

    def _prune(self) -> None:
        if self._t_end is None:
            return
        floor = self._t_end - self.slow_s
        for dq in self._lat.values():
            while dq and dq[0][0] < floor:
                dq.popleft()
        # step samples stay cumulative for final_verdict parity with the
        # post-hoc reconstruction; the deque maxlen bounds them

    # ---- windowed judgment ----------------------------------------------

    def _window_summary(self, window_s: float) -> Optional[Dict[str, Any]]:
        """A synthetic serve summary over the trailing ``window_s`` —
        the shape :func:`slo.evaluate_objective` reads, with percentiles
        computed from the windowed samples."""
        from heat3d_tpu_torch.obs.metrics import percentile

        if self._t_end is None:
            return None
        floor = self._t_end - window_s
        buckets: Dict[str, Dict[str, Any]] = {}
        for bucket, dq in self._lat.items():
            vals = [v for t, v in dq if t >= floor]
            if len(vals) < self.min_samples:
                continue
            buckets[bucket] = {
                "count": len(vals),
                "p50_s": percentile(vals, 50),
                "p95_s": percentile(vals, 95),
                "p99_s": percentile(vals, 99),
                "max_s": max(vals),
            }
        summary: Dict[str, Any] = {
            "buckets": buckets,
            "source": f"burn window {window_s:g}s",
        }
        # degraded time is a cumulative budget, not a windowed rate:
        # carry the latest engine summary's counters into every window
        if self._last_summary is not None:
            summary["degraded"] = self._last_summary.get("degraded")
            summary["degraded_s"] = self._last_summary.get("degraded_s")
            summary["requeues"] = self._last_summary.get("requeues")
        return summary

    def _window_steps(self, window_s: float) -> List[float]:
        if self._t_end is None:
            return []
        floor = self._t_end - window_s
        return [v for t, v in self._steps if t >= floor]

    def evaluate(self) -> Dict[str, Any]:
        """Judge every objective over the fast and slow windows. An
        objective is ``alerting`` when BOTH windows burn >= threshold."""
        from heat3d_tpu_torch.obs.perf.slo import evaluate_objective

        objectives = []
        for o in self.spec.get("objectives", []):
            windows = {}
            for label, win in (("fast", self.fast_s), ("slow", self.slow_s)):
                rec = evaluate_objective(
                    o,
                    self._window_summary(win),
                    self._window_steps(win),
                    None,
                    self._warn,
                )
                windows[label] = {
                    "window_s": win,
                    "burn": rec["burn_rate"],
                    "value": rec["value"],
                    "status": rec["status"],
                    "bucket": rec.get("bucket"),
                }
            alerting = all(
                w["burn"] is not None and w["burn"] >= self.threshold
                for w in windows.values()
            )
            objectives.append(
                {
                    "name": o.get("name", o["kind"]),
                    "kind": o["kind"],
                    "fast": windows["fast"],
                    "slow": windows["slow"],
                    "alerting": alerting,
                }
            )
        return {
            "objectives": objectives,
            "alerting": [x["name"] for x in objectives if x["alerting"]],
            "threshold": self.threshold,
            "fast_window_s": self.fast_s,
            "slow_window_s": self.slow_s,
        }

    # ---- watch view ------------------------------------------------------

    def status(self) -> Dict[str, Any]:
        """The live terminal view's data: rates, depth, windowed bucket
        percentiles, degraded state, burn per objective, anomaly flags."""
        win = self.fast_s
        floor = (self._t_end or 0.0) - win
        arr = sum(1 for t in self._arrivals if t >= floor)
        dlv = sum(1 for t in self._deliveries if t >= floor)
        flags = {
            name: n
            for name, dq in self._anomalies.items()
            if (n := sum(1 for t in dq if t >= floor))
        }
        summary = self._window_summary(win) or {}
        return {
            "t_end": self._t_end,
            "events_seen": self.events_seen,
            "window_s": win,
            "arrival_hz": round(arr / win, 3),
            "delivery_hz": round(dlv / win, 3),
            "queue_depth": self._last_depth,
            "buckets": summary.get("buckets") or {},
            "degraded": (self._last_summary or {}).get("degraded"),
            "degraded_s": (self._last_summary or {}).get("degraded_s"),
            "flags": flags,
            "burn": self.evaluate(),
        }

    # ---- post-hoc parity -------------------------------------------------

    def _posthoc_summary(self) -> Optional[Dict[str, Any]]:
        """The serve summary post-hoc evaluation would derive from this
        ledger — mirror :func:`slo.serve_summary_from_events` exactly."""
        from heat3d_tpu_torch.obs.metrics import percentile

        last = self._last_summary
        if last is not None:
            return {
                "buckets": last["buckets"],
                "depth_max": last.get("depth_max"),
                "degraded": last.get("degraded"),
                "degraded_s": last.get("degraded_s"),
                "requeues": last.get("requeues"),
                "source": "serve_metrics_summary",
            }
        if not self._all_lat:
            return None
        lat = self._all_lat
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

    def final_verdict(self) -> Dict[str, Any]:
        """The report a post-hoc ``heat3d obs slo`` over the same ledger
        would produce: same inputs, same shared core — the live/post-hoc
        agreement the soak battery pins."""
        from heat3d_tpu_torch.obs.perf.slo import evaluate

        return evaluate(
            [],
            self.spec,
            serve_summary=self._posthoc_summary(),
            warn_ratio=self._warn,
            step_samples=[v for _, v in self._steps],
        )
