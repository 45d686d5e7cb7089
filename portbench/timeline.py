"""What the device did inside the profiled window of a traced run, from a
``torch.profiler`` Chrome trace.

A copy of ``heat3d_tpu_torch/obs/perf/timeline.py``'s ``_collect``,
``_assign`` and ``_union`` (device events joined to their launch by
``args.correlation``, each given the innermost ``heat3d.*`` range open on
the launching thread; overlapping intervals merged), with one change: the
window is the benchmark's own ``portbench.window`` range, which opens after
the device has drained and closes after it drains again, and not the span
from the first device event to the last, so idle time at its edges counts.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Any, Dict, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
WINDOW = "portbench.window"
PHASE_PREFIX = "heat3d."


class _Ranges:
    """Ranges of one host thread, sorted by start; ranges of a thread nest."""

    def __init__(self):
        self.items: List[Tuple[float, float, str]] = []
        self._starts: List[float] = []

    def add(self, t0: float, t1: float, name: str) -> None:
        self.items.append((t0, t1, name))

    def seal(self) -> None:
        self.items.sort(key=lambda r: (r[0], -r[1]))
        self._starts = [r[0] for r in self.items]

    def innermost(self, t: float) -> Optional[str]:
        i = bisect.bisect_right(self._starts, t)
        while i > 0:
            i -= 1
            t0, t1, name = self.items[i]
            if t0 <= t <= t1:
                return name
        return None


def _num(v) -> Optional[float]:
    return float(v) if isinstance(v, (int, float)) else None


def union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for t0, t1 in sorted(intervals):
        if out and t0 <= out[-1][1]:
            if t1 > out[-1][1]:
                out[-1] = (out[-1][0], t1)
        else:
            out.append((t0, t1))
    return out


def activity(trace: Dict[str, Any], gaps: int = 10) -> Optional[Dict[str, Any]]:
    """Inside the ``portbench.window`` range of ``trace`` (times in s):

    - ``window_s``: the range's length; ``busy_s``: the union of the device
      events inside it, every stream counted once;
    - ``ops``: device seconds by event name; ``phases``: device seconds by
      the innermost ``heat3d.*`` range that held the event's launch
      (``None``: no range);
    - ``gaps``: the ``gaps`` longest idle stretches, the window's edges
      included, each with the host range open at its middle on the thread
      that launched most.

    None when the trace has no window or no device event in it."""
    device, launches, window = [], {}, None
    ranges: Dict[Any, _Ranges] = defaultdict(_Ranges)
    host_ops: Dict[Any, _Ranges] = defaultdict(_Ranges)
    for ev in trace.get("traceEvents") or []:
        if not isinstance(ev, dict) or ev.get("ph") != "X":
            continue
        ts, dur = _num(ev.get("ts")), _num(ev.get("dur"))
        if ts is None or dur is None:
            continue
        cat, name = ev.get("cat"), str(ev.get("name", "?"))
        args = ev.get("args") or {}
        thread = (ev.get("pid"), ev.get("tid"))
        if cat in DEVICE_CATS:
            device.append((ts, ts + dur, name, args.get("correlation")))
        elif cat in LAUNCH_CATS:
            if args.get("correlation") is not None:
                launches[args["correlation"]] = (ts, thread)
        elif cat == "user_annotation" and name == WINDOW:
            window = (ts, ts + dur)
        elif cat == "user_annotation" and name.startswith(PHASE_PREFIX):
            ranges[thread].add(ts, ts + dur, name)
        elif cat == "cpu_op":
            host_ops[thread].add(ts, ts + dur, name)
    if window is None:
        return None
    w0, w1 = window
    for group in (ranges, host_ops):
        for r in group.values():
            r.seal()
    inside = [(max(t0, w0), min(t1, w1), name, corr) for t0, t1, name, corr in device
              if t1 > w0 and t0 < w1]
    if not inside:
        return None
    ops: Dict[str, float] = defaultdict(float)
    phases: Dict[Optional[str], float] = defaultdict(float)
    threads: Dict[Any, int] = defaultdict(int)
    for t0, t1, name, corr in inside:
        ops[name] += (t1 - t0) * 1e-6
        launch = launches.get(corr)
        phase = None
        if launch is not None:
            threads[launch[1]] += 1
            if launch[1] in ranges:
                phase = ranges[launch[1]].innermost(launch[0])
        phases[phase] += (t1 - t0) * 1e-6
    busy = union([(t0, t1) for t0, t1, _, _ in inside])
    main = max(threads, key=threads.get) if threads else None
    edges = [w0] + [t for b in busy for t in b] + [w1]
    idle = sorted(((edges[i + 1] - edges[i], edges[i], edges[i + 1])
                   for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]),
                  reverse=True)[:gaps]
    gap_list = []
    for length, t0, t1 in idle:
        mid = 0.5 * (t0 + t1)
        label = ranges[main].innermost(mid) if main in ranges else None
        if label is None and main in host_ops:
            label = host_ops[main].innermost(mid)
        gap_list.append((label or WINDOW, length * 1e-6))
    return {
        "window_s": (w1 - w0) * 1e-6,
        "busy_s": sum(t1 - t0 for t0, t1 in busy) * 1e-6,
        "ops": dict(ops),
        "phases": dict(phases),
        "gaps": gap_list,
    }
