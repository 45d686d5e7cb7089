"""Pairwise single-knob A/B decisions over measured rows.

A copy of the JAX package's ``tune/decide.py`` (pure Python): the tuner's
search (:mod:`heat3d_tpu_torch.tune.measure`) feeds its trial rows
through :func:`decide` for the per-knob section of the ``tune run``
report, and ``obs adjudicate`` (:mod:`heat3d_tpu_torch.obs.comm.adjudicate`)
judges A/B stages with it.

Measurement logs hold each counterfactual side as ``<knob tokens>:
{throughput-row json}`` — e.g. ``factor_y=0 tb=2: {...}`` or ``direct:
{...}``. :func:`parse_lines` reads those lines, :func:`pair_rows` pairs rows
that differ in exactly one knob (all other knobs equal), and :func:`decide`
gives the speedup per pair plus a recommendation.

Usage::

    python -m heat3d_tpu_torch.tune.decide measure.log [more.log ...]
        [--all-sessions] [--min-win PCT]

By default only lines after the LAST session header in each file are
considered — any of the ``SESSION_HEADERS`` prefixes
(``=== tpu_measure_all``, ``=== pod_ab_fused``) starts a session (a log
accumulates many sessions; stale A/Bs from an older kernel would corrupt
the decision).
``--min-win`` (default 5.0) is the speedup percentage below which the
recommendation is "keep default" (measurement noise / not worth a flip).
"""

from __future__ import annotations

import argparse
import itertools
import json
import re
import sys

# any of these starts a measurement session; scoping keeps only lines
# after the LAST header present in the file (stale-session protection)
SESSION_HEADERS = ("=== tpu_measure_all", "=== pod_ab_fused")
_LINE = re.compile(r"^([A-Za-z0-9_=/. -]+?):\s*(\{.*\})\s*$")
# bench-harness rows vs CLI summary lines (stage 3g logs the latter) name
# the throughput metric differently; first present key wins
METRIC_KEYS = ("gcell_per_sec_per_chip", "gcell_updates_per_sec_per_chip")

DEFAULT_MIN_WIN_PCT = 5.0


def _metric(row: dict):
    for k in METRIC_KEYS:
        if k in row:
            return float(row[k])
    return None


def parse_knobs(prefix: str) -> dict:
    """``factor_y=0 tb=2`` -> {'factor_y': '0', 'tb': '2'};
    bare words become ``mode`` (``direct`` -> {'mode': 'direct'})."""
    knobs = {}
    for tok in prefix.split():
        if "=" in tok:
            k, v = tok.split("=", 1)
            knobs[k] = v
        else:
            knobs["mode"] = tok
    return knobs


def parse_lines(text: str, all_sessions: bool = False):
    """Yield (knobs, row) for every A/B line in the chosen session scope."""
    if not all_sessions:
        cut = max(
            (text.rindex(h) for h in SESSION_HEADERS if h in text),
            default=None,
        )
        if cut is not None:
            text = text[cut:]
    for line in text.splitlines():
        m = _LINE.match(line.strip())
        if not m:
            continue
        try:
            row = json.loads(m.group(2))
        except json.JSONDecodeError:
            continue
        if not (isinstance(row, dict) and _metric(row) is not None):
            continue
        yield parse_knobs(m.group(1)), row


def pair_rows(entries):
    """Yield (knob, fixed, a, b) for entry pairs differing in exactly one
    knob value; ``fixed`` is the shared remaining-knob context."""
    for (ka, ra), (kb, rb) in itertools.combinations(entries, 2):
        if set(ka) != set(kb):
            continue
        diff = [k for k in ka if ka[k] != kb[k]]
        if len(diff) != 1:
            continue
        k = diff[0]
        fixed = {n: v for n, v in ka.items() if n != k}
        # deterministic orientation: lower knob value first
        if str(ka[k]) <= str(kb[k]):
            yield k, fixed, (ka[k], ra), (kb[k], rb)
        else:
            yield k, fixed, (kb[k], rb), (ka[k], ra)


def decide(
    entries,
    min_win_pct: float = DEFAULT_MIN_WIN_PCT,
    metric=None,
    prefer: str = "higher",
):
    """Return decision dicts for every single-knob A/B pair found.

    ``metric`` overrides the throughput-key lookup with any
    ``row -> float | None`` extractor, and ``prefer='lower'`` flips the
    winner rule for cost-like metrics (latency p50s — ``obs adjudicate``
    judges the halo A/Bs this way). Defaults reproduce the historical
    behavior exactly: throughput keys, higher wins. The speedup margin
    is winner-relative-to-loser either way, so it stays symmetric.
    """
    metric_fn = _metric if metric is None else metric
    lower_wins = prefer == "lower"
    out = []
    for knob, fixed, (va, ra), (vb, rb) in pair_rows(entries):
        ga, gb = metric_fn(ra), metric_fn(rb)
        if ga is None or gb is None or ga <= 0 or gb <= 0:
            continue
        if lower_wins:
            winner = vb if gb <= ga else va
        else:
            winner = vb if gb >= ga else va
        # winner relative to LOSER, symmetric in orientation: the same gap
        # must yield the same margin whichever side the lower knob value is
        margin = (max(ga, gb) / min(ga, gb) - 1.0) * 100.0
        out.append(
            {
                "knob": knob,
                "context": fixed,
                "values": {va: round(ga, 2), vb: round(gb, 2)},
                "winner": winner,
                "speedup_pct": round(margin, 1),
                "decisive": margin >= min_win_pct,
                "recommend": (
                    f"{knob}={winner} wins {margin:.1f}%"
                    + ("" if margin >= min_win_pct else
                       " — below threshold, keep default")
                ),
            }
        )
    return out


def format_decision(d: dict) -> str:
    """One human-readable line per decision (the wrapper's table row)."""
    ctx = " ".join(f"{k}={v}" for k, v in sorted(d["context"].items()))
    vals = ", ".join(f"{v}: {g}" for v, g in d["values"].items())
    flag = "FLIP?" if d["decisive"] else "keep "
    return (
        f"[{flag}] {d['knob']:<12} ({ctx or 'no context'})  "
        f"{vals}  ->  {d['recommend']}"
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("logs", nargs="+", help="measurement logs to scan")
    ap.add_argument("--all-sessions", action="store_true",
                    help="consider every session in each log, not just the last")
    ap.add_argument("--min-win", type=float, default=DEFAULT_MIN_WIN_PCT,
                    help="speedup %% below which the call is 'keep default'")
    args = ap.parse_args(argv)
    # Pairing happens PER FILE: rows from different logs come from
    # different sessions/machines/kernel versions, and pairing across them
    # would silently defeat the stale-session protection.
    decisions = []
    found_any = False
    for path in args.logs:
        try:
            with open(path) as f:
                entries = list(parse_lines(f.read(), args.all_sessions))
        except OSError as e:
            print(f"ab_decide: cannot read {path}: {e}", file=sys.stderr)
            return 2
        found_any = found_any or bool(entries)
        decisions.extend(decide(entries, args.min_win))
    if not found_any:
        print("ab_decide: no A/B lines found in the chosen session scope",
              file=sys.stderr)
        return 1
    if not decisions:
        print("ab_decide: A/B lines found but no single-knob pairs",
              file=sys.stderr)
        return 1
    for d in sorted(decisions,
                    key=lambda d: (-d["decisive"], -d["speedup_pct"])):
        print(format_decision(d))
    return 0


if __name__ == "__main__":
    sys.exit(main())
