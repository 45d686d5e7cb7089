"""Ledger schema lint — the data-lint core behind ``obs check`` (a copy of
the JAX package's ``analysis/ledgerlint.py``), sharing the analysis
finding/report format.

Rules (per defect a ``(line, description)`` pair):

- every line parses as a JSON object;
- required fields (:data:`~heat3d_tpu_torch.obs.ledger.REQUIRED_FIELDS`) are
  present and well-typed; ``kind`` is ``point`` or ``span``;
- span events carry ``t0``/``t1``/``dur_s``/``depth``/``status`` with
  ``t1 >= t0`` and ``dur_s`` consistent;
- per ``(run_id, proc)``: ``seq`` strictly increases (an append-only
  stream cannot reorder), exactly one ``ledger_open`` exists and is that
  stream's first event, and spans form a proper nesting — each pair of
  spans is disjoint or contained, never partially overlapping (checked on
  the monotonic ``t0``/``t1`` bounds, so wall-clock steps can't fake a
  violation).

``--taxonomy`` additionally audits every event *name* in the stream
against the canonical registry
(:data:`heat3d_tpu_torch.analysis.registry.LEDGER_EVENTS`) — applied to actual
ledger files: an unregistered name in a stream means some emitter escaped
both the registry and the static scan (generated code, a foreign tool) and
the vocabulary is drifting.
"""

from __future__ import annotations

import json
import sys
from collections import defaultdict
from typing import Any, Dict, List, Tuple

from heat3d_tpu_torch.analysis.findings import ERROR, Finding, data_lint_main

# tolerance for float comparisons on span bounds: spans written at close
# under one lock are strictly ordered, but dur_s is stored rounded-ish
# (full float, really) — keep a small epsilon anyway
EPS = 1e-6
MAX_REPORT = 20

Defect = Tuple[int, str]


def _required_fields() -> Tuple[Tuple[str, ...], Tuple[str, ...]]:
    from heat3d_tpu_torch.obs.ledger import REQUIRED_FIELDS, SPAN_FIELDS

    return REQUIRED_FIELDS, SPAN_FIELDS


def _check_event(rec: Dict[str, Any]) -> List[str]:
    required, span_fields = _required_fields()
    problems = []
    for f in required:
        if f not in rec:
            problems.append(f"missing required field {f!r}")
    if "ts" in rec and not isinstance(rec["ts"], (int, float)):
        problems.append("ts is not a number")
    if "run_id" in rec and not (
        isinstance(rec["run_id"], str) and rec["run_id"]
    ):
        problems.append("run_id is not a non-empty string")
    if "proc" in rec and not isinstance(rec["proc"], int):
        problems.append("proc is not an int")
    if "seq" in rec and not isinstance(rec["seq"], int):
        problems.append("seq is not an int")
    kind = rec.get("kind")
    if "kind" in rec and kind not in ("point", "span"):
        problems.append(f"kind {kind!r} is not 'point' or 'span'")
    if kind == "span":
        for f in span_fields:
            if f not in rec:
                problems.append(f"span missing field {f!r}")
        t0, t1, dur = rec.get("t0"), rec.get("t1"), rec.get("dur_s")
        if all(isinstance(v, (int, float)) for v in (t0, t1, dur)):
            if t1 < t0 - EPS:
                problems.append(f"span ends before it starts (t0={t0}, t1={t1})")
            if abs((t1 - t0) - dur) > 1e-3:
                problems.append(
                    f"dur_s {dur} disagrees with t1-t0 {t1 - t0}"
                )
        if rec.get("status") not in ("ok", "error", None):
            problems.append(f"span status {rec.get('status')!r} invalid")
    return problems


def _check_taxonomy(rec: Dict[str, Any]) -> List[str]:
    from heat3d_tpu_torch.analysis.registry import LEDGER_EVENTS

    name, kind = rec.get("event"), rec.get("kind")
    if not isinstance(name, str):
        return []  # the schema rules already flagged it
    reg = LEDGER_EVENTS.get(name)
    if reg is None:
        return [
            f"event name {name!r} is not in the canonical registry "
            "(heat3d_tpu_torch/analysis/registry.LEDGER_EVENTS) — unregistered "
            "vocabulary in the stream"
        ]
    if kind in ("point", "span") and reg.get("kind") != kind:
        return [
            f"event {name!r} recorded as {kind} but registered as "
            f"{reg.get('kind')}"
        ]
    return []


def _check_nesting(
    spans: List[Tuple[int, float, float]]
) -> List[Defect]:
    """Spans (line, t0, t1) of one (run_id, proc) stream must form a
    laminar family: any two are disjoint or one contains the other. Sorted
    by (t0 asc, t1 desc), a stack scan finds every partial overlap."""
    bad: List[Defect] = []
    stack: List[Tuple[int, float, float]] = []
    for line, t0, t1 in sorted(spans, key=lambda s: (s[1], -s[2])):
        while stack and stack[-1][2] <= t0 + EPS:
            stack.pop()
        if stack and t1 > stack[-1][2] + EPS:
            bad.append(
                (
                    line,
                    f"span [{t0:.6f}, {t1:.6f}] partially overlaps span "
                    f"at line {stack[-1][0]} "
                    f"[{stack[-1][1]:.6f}, {stack[-1][2]:.6f}] — "
                    "not properly nested",
                )
            )
            continue
        stack.append((line, t0, t1))
    return bad


def check_file(
    path: str, start_line: int = 1, taxonomy: bool = False
) -> List[Defect]:
    """Every defect in the ledger at ``path`` as (line, description),
    line-ordered.

    ``start_line`` scopes the REPORT to defects at/after that line (the
    whole file is still parsed for stream context — seq chains and span
    nesting cross the boundary): APPEND-mode suite sessions lint only the
    segments THEY wrote, the same rule check_provenance.py applies to
    bench rows, so one historical defect cannot keep every resumed
    session permanently red.

    Rotated ledgers (``HEAT3D_LEDGER_MAX_MB`` rollover, oldest segment
    ``<stem>.0.jsonl``) are linted as ONE stream: given the base path, the
    rolled siblings are read first and line numbers continue across the
    concatenation — the writer's (run_id, proc, seq) stream spans the
    segments, so seq chains and the leading ledger_open only hold on the
    whole. Lint a rolled segment via its base path, not directly."""
    from heat3d_tpu_torch.obs.ledger import ledger_segments

    bad: List[Defect] = []
    streams: Dict[Tuple[str, int], List[Tuple[int, Dict[str, Any]]]] = (
        defaultdict(list)
    )
    i = 0
    for seg in ledger_segments(path):
        try:
            f = open(seg)
        except OSError as e:
            if seg == path:
                return [(0, f"cannot open {path}: {e}")]
            continue  # rolled sibling raced away: lint what remains
        with f:
            for line in f:
                i += 1
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    bad.append((i, "unparseable JSON"))
                    continue
                if not isinstance(rec, dict):
                    bad.append((i, "event is not a JSON object"))
                    continue
                for p in _check_event(rec):
                    bad.append((i, p))
                if taxonomy:
                    for p in _check_taxonomy(rec):
                        bad.append((i, p))
                if isinstance(rec.get("run_id"), str) and isinstance(
                    rec.get("proc"), int
                ):
                    streams[(rec["run_id"], rec["proc"])].append((i, rec))

    for (run_id, proc), events in sorted(streams.items()):
        label = f"run {run_id} proc {proc}"
        opens = [i for i, r in events if r.get("event") == "ledger_open"]
        if not opens:
            bad.append(
                (events[0][0], f"{label}: no ledger_open event (orphan run-id)")
            )
        elif len(opens) > 1:
            bad.append(
                (opens[1], f"{label}: duplicate ledger_open at line {opens[1]}")
            )
        elif opens[0] != events[0][0]:
            bad.append(
                (
                    opens[0],
                    f"{label}: ledger_open is not the stream's first event",
                )
            )
        prev_seq = None
        prev_line = None
        for i, r in events:
            seq = r.get("seq")
            if not isinstance(seq, int):
                continue
            if prev_seq is not None and seq <= prev_seq:
                bad.append(
                    (
                        i,
                        f"{label}: seq {seq} not above seq {prev_seq} at "
                        f"line {prev_line} (stream reordered or truncated "
                        "mid-write)",
                    )
                )
            prev_seq, prev_line = seq, i
        spans = [
            (i, float(r["t0"]), float(r["t1"]))
            for i, r in events
            if r.get("kind") == "span"
            and isinstance(r.get("t0"), (int, float))
            and isinstance(r.get("t1"), (int, float))
        ]
        bad.extend(
            (i, f"{label}: {msg}") for i, msg in _check_nesting(spans)
        )
    return sorted(d for d in bad if d[0] >= start_line)


class StreamChecker:
    """Incremental ledger lint over a live line stream — the core of
    ``heat3d obs check --follow``. Same per-event and per-stream rules as
    :func:`check_file`, fed one line at a time (e.g. from
    :class:`heat3d_tpu_torch.obs.tailer.LedgerTailer.poll_lines`); :meth:`feed`
    returns only the defects NEW since the previous call, so a watch loop
    prints each at most once. Line numbers count fed lines (the virtual
    concatenation across rotated segments).

    One live-mode divergence: a stream whose first event is not
    ``ledger_open`` is flagged immediately (a live writer always opens
    first), where the post-hoc lint waits for end-of-file to distinguish
    "no open" from "open arrived late"."""

    def __init__(self, taxonomy: bool = False):
        self._taxonomy = taxonomy
        self._line = 0
        self._streams: Dict[Tuple[str, int], Dict[str, Any]] = {}
        self._reported: set = set()

    @property
    def lines_seen(self) -> int:
        return self._line

    def feed(self, raw_line: str) -> List[Defect]:
        self._line += 1
        i = self._line
        bad: List[Defect] = []
        line = raw_line.strip()
        if not line:
            return bad
        try:
            rec = json.loads(line)
        except json.JSONDecodeError:
            return [(i, "unparseable JSON")]
        if not isinstance(rec, dict):
            return [(i, "event is not a JSON object")]
        bad.extend((i, p) for p in _check_event(rec))
        if self._taxonomy:
            bad.extend((i, p) for p in _check_taxonomy(rec))
        if not (
            isinstance(rec.get("run_id"), str)
            and isinstance(rec.get("proc"), int)
        ):
            return bad
        key = (rec["run_id"], rec["proc"])
        label = f"run {key[0]} proc {key[1]}"
        st = self._streams.get(key)
        if st is None:
            st = self._streams[key] = {
                "opens": 0, "prev_seq": None, "prev_line": None, "spans": []
            }
            if rec.get("event") != "ledger_open":
                bad.append(
                    (i, f"{label}: stream did not begin with ledger_open")
                )
        if rec.get("event") == "ledger_open":
            st["opens"] += 1
            if st["opens"] > 1:
                bad.append(
                    (i, f"{label}: duplicate ledger_open at line {i}")
                )
        seq = rec.get("seq")
        if isinstance(seq, int):
            if st["prev_seq"] is not None and seq <= st["prev_seq"]:
                bad.append(
                    (
                        i,
                        f"{label}: seq {seq} not above seq {st['prev_seq']} "
                        f"at line {st['prev_line']} (stream reordered or "
                        "truncated mid-write)",
                    )
                )
            st["prev_seq"], st["prev_line"] = seq, i
        if (
            rec.get("kind") == "span"
            and isinstance(rec.get("t0"), (int, float))
            and isinstance(rec.get("t1"), (int, float))
        ):
            st["spans"].append((i, float(rec["t0"]), float(rec["t1"])))
            # nesting is a whole-family property: rescan this stream's
            # accumulated spans and surface only not-yet-reported overlaps
            for ln, msg in _check_nesting(st["spans"]):
                d = (ln, f"{label}: {msg}")
                if d not in self._reported:
                    self._reported.add(d)
                    bad.append(d)
        return bad


def check_file_findings(
    path: str, start_line: int = 1, taxonomy: bool = False
) -> List[Finding]:
    """The same defects as :func:`check_file`, in the shared analysis
    finding format (data lints are error-severity by definition: a stream
    that cannot prove its own integrity is already lost)."""
    return [
        Finding(
            checker="ledger",
            severity=ERROR,
            path=path,
            line=line_no,
            code="DATA-LEDGER",
            message=desc,
        )
        for line_no, desc in check_file(path, start_line, taxonomy)
    ]


def main(argv=None) -> int:
    return data_lint_main(
        argv, "ledger", check_file, __doc__,
        taxonomy_flag=True, max_report=MAX_REPORT,
    )


if __name__ == "__main__":
    sys.exit(main())
