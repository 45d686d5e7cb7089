"""``heat3d obs merge`` — join per-process ledgers into one timeline.

A multihost run writes one ledger per process (each entry point activates
its own ``--ledger`` path; run ids are per-process). Post-mortem questions
— "did proc 3 start its chunk late", "which host stalled the collective"
— need the per-process streams on ONE timeline, plus an estimate of how
far the hosts' wall clocks disagree (events are stamped with each host's
own ``time.time()``; ``t0``/``t1`` are per-process monotonic and never
comparable across hosts).

The merge tags every event with its source file (``src``), stable-sorts
by wall ``ts`` (ties keep per-stream order, so each stream's ``seq``
stays monotone and the merged file still passes ``heat3d obs check`` /
``obs summary`` groups it per run segment), and computes **cross-host
skew stats** from anchor events: for every event name that appears
exactly once per source (``run_start``, ``ledger_open``,
``supervised_start``, ...), the spread of its ``ts`` across sources
bounds the skew-plus-real-stagger for that phase boundary; the reported
``skew_s`` per source is its offset from the earliest anchor. True clock
skew and genuine start stagger are indistinguishable from ledgers alone —
the stats say so rather than pretending otherwise.

``--align`` (the comm-observatory leg) goes
one step further: it subtracts each source's anchor offset from every
wall ``ts`` in that source's stream (the original stamp is preserved as
``ts_raw``), so downstream consumers — ``obs timeline --align``, the
cross-host straggler detectors — compare hosts on one estimated clock
and a skewed host clock can no longer masquerade as a straggler. The
correction is exactly as good as the anchor barrier: the recorded
``clock_align`` stats carry a confidence interval (``ci_s``) bounding
the alignment error by the worst residual once-per-source spread after
alignment plus the worst host's measured sync RTT, and real start
stagger widens it honestly. Monotonic ``t0``/``t1``/``dur_s`` are
per-process and are never rewritten.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from collections import defaultdict
from typing import Any, Dict, List, Optional

# preferred anchor events, most-synchronized-first: run_start is written
# right after distributed.initialize (a real barrier on multihost), so its
# spread is closest to pure clock skew
ANCHOR_PREFERENCE = ("run_start", "supervised_start", "ledger_open")


def read_events(path: str) -> List[Dict[str, Any]]:
    """``obs.cli.read_ledger`` (the ONE tolerant ledger parser — merge
    and summary/check must agree on which events they see) plus an
    unreadable-path warning instead of a raise."""
    from heat3d_tpu_torch.obs.cli import read_ledger

    try:
        return read_ledger(path)
    except OSError as e:
        print(f"merge: cannot open {path}: {e}", file=sys.stderr)
        return []


def merge_ledgers(
    paths: List[str], anchor: Optional[str] = None, align: bool = False
) -> Dict[str, Any]:
    """Merge the ledgers at ``paths``. Returns ``{"events": [...],
    "stats": {...}}`` — events tagged with ``src`` and sorted by ``ts``
    (stable: per-stream order preserved), stats as described in the
    module docstring. ``align=True`` additionally rewrites each
    source's wall timestamps onto the anchor-aligned clock (originals
    kept as ``ts_raw``; ``stats["clock_align"]`` records the offsets
    and the confidence interval)."""
    per_src: Dict[str, List[Dict[str, Any]]] = {}
    for p in paths:
        evs = read_events(p)
        src = os.path.basename(p)
        if src in per_src:  # two paths with one basename: disambiguate
            src = p
        for e in evs:
            e.setdefault("src", src)
        per_src[src] = evs

    merged: List[Dict[str, Any]] = []
    for evs in per_src.values():
        merged.extend(evs)
    merged.sort(
        key=lambda e: e["ts"] if isinstance(e.get("ts"), (int, float)) else 0.0
    )

    # pick the anchor: requested, else the first preference present in
    # EVERY source (a skew stat from an event only some hosts wrote would
    # compare different phase boundaries)
    def anchor_ts(evs: List[Dict[str, Any]], name: str) -> Optional[float]:
        for e in evs:
            if e.get("event") == name and isinstance(
                e.get("ts"), (int, float)
            ):
                return float(e["ts"])
        return None

    chosen = anchor
    if chosen is None:
        for cand in ANCHOR_PREFERENCE:
            if all(anchor_ts(evs, cand) is not None for evs in per_src.values()):
                chosen = cand
                break

    anchors = {
        src: anchor_ts(evs, chosen) if chosen else None
        for src, evs in per_src.items()
    }
    known = [v for v in anchors.values() if v is not None]
    base = min(known) if known else None

    sources = {}
    for src, evs in per_src.items():
        tss = [
            float(e["ts"])
            for e in evs
            if isinstance(e.get("ts"), (int, float))
        ]
        sources[src] = {
            "events": len(evs),
            "procs": sorted({e.get("proc") for e in evs if "proc" in e}),
            "run_ids": sorted(
                {str(e.get("run_id")) for e in evs if "run_id" in e}
            ),
            "t_first": min(tss) if tss else None,
            "t_last": max(tss) if tss else None,
            "anchor_ts": anchors[src],
            "skew_s": (
                round(anchors[src] - base, 6)
                if anchors[src] is not None and base is not None
                else None
            ),
        }

    # ``--align``: subtract each source's anchor offset from its wall
    # stamps, preserving the original as ``ts_raw``. Requires a common
    # anchor across >= 2 sources — with nothing to align against, the
    # merge stays raw and says so instead of silently rewriting time.
    aligned = False
    if align and chosen is not None and base is not None and len(known) > 1:
        for src, evs in per_src.items():
            off = sources[src]["skew_s"]
            sources[src]["align_offset_s"] = off
            if off:
                for e in evs:
                    if isinstance(e.get("ts"), (int, float)):
                        e["ts_raw"] = e["ts"]
                        e["ts"] = float(e["ts"]) - off
        merged.sort(
            key=lambda e: (
                e["ts"] if isinstance(e.get("ts"), (int, float)) else 0.0
            )
        )
        aligned = True

    stats = {
        "sources": sources,
        "anchor_event": chosen,
        "max_skew_s": (
            round(max(known) - min(known), 6) if len(known) > 1 else 0.0
        ),
        "note": (
            "skew_s mixes wall-clock skew with real start stagger; "
            "monotonic t0/t1 are per-process and never comparable "
            "across hosts"
        ),
        "total_events": len(merged),
    }

    # per-anchor-candidate spread table: every event name written exactly
    # once per source gives an independent skew sample along the run
    spreads = {}
    counts: Dict[str, Dict[str, int]] = defaultdict(lambda: defaultdict(int))
    first_ts: Dict[str, Dict[str, float]] = defaultdict(dict)
    for src, evs in per_src.items():
        for e in evs:
            name = e.get("event")
            if isinstance(name, str) and isinstance(
                e.get("ts"), (int, float)
            ):
                counts[name][src] += 1
                first_ts[name].setdefault(src, float(e["ts"]))
    for name, per in counts.items():
        if len(per) == len(per_src) > 1 and all(
            c == 1 for c in per.values()
        ):
            tss = list(first_ts[name].values())
            spreads[name] = round(max(tss) - min(tss), 6)
    stats["anchor_spreads_s"] = dict(
        sorted(spreads.items(), key=lambda kv: kv[1])
    )

    if aligned:
        # the chosen anchor's aligned spread is 0 by construction; the
        # worst REMAINING once-per-source spread bounds how well one
        # offset per host explained the rest of the run (residual skew
        # drift + real stagger), and each host's own timestamp jitter is
        # bounded by its measured sync RTT where one was recorded
        residual = max(
            (v for k, v in spreads.items() if k != chosen), default=0.0
        )
        rtts: Dict[str, Optional[float]] = {}
        for src, evs in per_src.items():
            vals = [
                float(e["sync_rtt_s"])
                for e in evs
                if isinstance(e.get("sync_rtt_s"), (int, float))
            ]
            rtts[src] = round(max(vals), 6) if vals else None
        ci = round(
            residual
            + max((v for v in rtts.values() if v is not None), default=0.0),
            6,
        )
        stats["clock_align"] = {
            "applied": True,
            "anchor_event": chosen,
            "offsets_s": {s: sources[s]["skew_s"] for s in per_src},
            "sync_rtt_s": rtts,
            "residual_spread_s": residual,
            "ci_s": ci,
            "note": (
                "offsets are each source's anchor skew; ci_s bounds the "
                "alignment error by the worst residual once-per-source "
                "spread plus the worst measured sync RTT — real stagger "
                "widens it honestly"
            ),
        }
        from heat3d_tpu_torch import obs

        obs.get().event(
            "clock_align",
            anchor_event=chosen,
            sources=len(per_src),
            max_offset_s=round(max(known) - min(known), 6),
            ci_s=ci,
        )
    elif align:
        stats["clock_align"] = {
            "applied": False,
            "anchor_event": chosen,
            "note": (
                "alignment needs an anchor event present in every "
                "source and >= 2 sources; merge left on raw clocks"
            ),
        }
    return {"events": merged, "stats": stats}


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="heat3d obs merge",
        description="join per-process run ledgers into one timeline with "
        "cross-host skew stats",
    )
    ap.add_argument("ledgers", nargs="+", help="per-process ledger files")
    ap.add_argument(
        "-o", "--out", default=None, metavar="PATH",
        help="write the merged timeline here (JSONL, src-tagged, "
        "ts-sorted); stats print to stdout either way",
    )
    ap.add_argument(
        "--anchor", default=None,
        help="event name to anchor skew on (default: first of "
        f"{'/'.join(ANCHOR_PREFERENCE)} present in every ledger)",
    )
    ap.add_argument(
        "--align", action="store_true",
        help="rewrite each source's wall timestamps onto the "
        "anchor-aligned clock (originals kept as ts_raw; the recorded "
        "clock_align stats carry the confidence interval)",
    )
    ap.add_argument("--json", action="store_true",
                    help="print stats as one JSON object")
    args = ap.parse_args(argv)

    result = merge_ledgers(args.ledgers, anchor=args.anchor, align=args.align)
    if args.out:
        with open(args.out, "w") as f:
            for e in result["events"]:
                f.write(json.dumps(e, default=repr) + "\n")
    stats = result["stats"]
    if args.json:
        print(json.dumps(stats))
        return 0
    print(
        f"merged {len(args.ledgers)} ledger(s), "
        f"{stats['total_events']} events"
        + (f" -> {args.out}" if args.out else "")
    )
    print(
        f"anchor: {stats['anchor_event'] or '(none common)'}  "
        f"max skew {stats['max_skew_s']}s"
    )
    for src, s in stats["sources"].items():
        skew = f"{s['skew_s']:+.3f}s" if s["skew_s"] is not None else "?"
        print(
            f"  {src}: procs {s['procs']} {s['events']} events "
            f"skew {skew} wall "
            f"[{s['t_first']}, {s['t_last']}]"
        )
    if stats["anchor_spreads_s"]:
        worst = sorted(
            stats["anchor_spreads_s"].items(), key=lambda kv: -kv[1]
        )[:5]
        print(
            "  spread per once-per-source event (skew + stagger): "
            + ", ".join(f"{n}={v}s" for n, v in worst)
        )
    ca = stats.get("clock_align")
    if ca is not None:
        if ca["applied"]:
            print(
                f"  aligned on {ca['anchor_event']}: "
                f"ci ±{ca['ci_s']}s (residual {ca['residual_spread_s']}s); "
                "originals kept as ts_raw"
            )
        else:
            print(f"  NOT aligned: {ca['note']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
