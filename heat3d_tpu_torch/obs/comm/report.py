"""Per-link aggregation of ``comm_probe`` events (jax-free).

Shared by ``obs summary``, ``obs watch`` and the tests: groups the
``comm_probe`` rows the probe (:mod:`heat3d_tpu_torch.obs.comm.probe`) emitted
by (axis, direction), reduces them to p50 latency and
predicted-vs-achieved bytes, and renders the small table both CLI
surfaces show. Sub-blocks of a partitioned exchange fold into their
parent (axis, direction) link — the *link* is the unit of attribution,
matching the ``link_straggler`` detector in
:mod:`heat3d_tpu_torch.obs.perf.timeline`.

Everything here fails soft and imports nothing heavier than stdlib —
``obs summary`` must keep working on a laptop with no accelerator stack.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Any, Dict, Iterable, List, Optional, Tuple

from heat3d_tpu_torch.obs.metrics import percentile

__all__ = ["comm_link_stats", "comm_lines"]


def _is_num(v: Any) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def comm_link_stats(events: Iterable[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Reduce ``comm_probe`` events to one record per (axis, direction).

    Returns a list of JSON-safe dicts sorted by (axis_name, direction),
    each with ``axis``, ``direction``, ``n`` (sample count, sub-blocks
    included), ``p50_us`` (p50 of per-sample link time), ``bytes``
    (plan-predicted bytes for the link, summed over its sub-blocks),
    ``gbps`` (predicted bytes over measured p50 time) and ``worst``
    (True on the slowest link). Empty list when no usable samples.
    """
    per_link: Dict[Tuple[str, str], List[Dict[str, Any]]] = defaultdict(list)
    for e in events:
        if e.get("event") != "comm_probe":
            continue
        ax, dr, t = e.get("axis_name"), e.get("direction"), e.get("t_s")
        if isinstance(ax, str) and dr in ("lo", "hi") and _is_num(t) and t > 0:
            per_link[(ax, str(dr))].append(e)
    out: List[Dict[str, Any]] = []
    for (ax, dr), rows in sorted(per_link.items()):
        # A link's predicted bytes is the sum over its distinct
        # sub-blocks (each sub-block row repeats across probe passes —
        # count each once); its time is the p50 over per-sub-block
        # samples summed per pass would over-model pipelining, so we
        # stay honest and report the p50 of the per-row samples next to
        # the per-row predicted bytes ratio.
        t_p50 = percentile([float(r["t_s"]) for r in rows], 50)
        by_block: Dict[Any, float] = {}
        for r in rows:
            b = r.get("bytes_predicted")
            if _is_num(b) and b > 0:
                by_block[r.get("sub_block")] = float(b)
        bytes_pred = sum(by_block.values())
        gbps = [
            float(r["bytes_predicted"]) / float(r["t_s"]) / 1e9
            for r in rows
            if _is_num(r.get("bytes_predicted")) and r["bytes_predicted"] > 0
        ]
        out.append(
            {
                "axis": ax,
                "direction": dr,
                "n": len(rows),
                "p50_us": round(t_p50 * 1e6, 3),
                "bytes": int(bytes_pred),
                "gbps": round(percentile(gbps, 50), 3) if gbps else None,
                "worst": False,
            }
        )
    if out:
        worst = max(out, key=lambda r: r["p50_us"])
        worst["worst"] = True
    return out


def _fmt_bytes(n: int) -> str:
    v = float(n)
    for unit in ("B", "KiB", "MiB", "GiB"):
        if v < 1024.0 or unit == "GiB":
            return f"{v:.0f}{unit}" if unit == "B" else f"{v:.1f}{unit}"
        v /= 1024.0
    return f"{n}B"


def comm_lines(events: Iterable[Dict[str, Any]], indent: str = "   ") -> List[str]:
    """Render the per-axis comm table for ``obs summary`` / ``obs watch``.

    Empty list when there are no ``comm_probe`` samples (the section
    simply does not appear). Never raises.
    """
    try:
        stats = comm_link_stats(events)
        if not stats:
            return []
        lines = ["", " comm links (probe):"]
        lines.append(
            f"{indent}{'link':<10} {'n':>4} {'p50':>12} {'pred bytes':>12} {'GB/s':>8}"
        )
        for s in stats:
            gbps = f"{s['gbps']:.3f}" if s["gbps"] is not None else "-"
            flag = "  <- worst" if s["worst"] and len(stats) > 1 else ""
            lines.append(
                f"{indent}{s['axis'] + '.' + s['direction']:<10} {s['n']:>4} "
                f"{s['p50_us']:>10.1f}us {_fmt_bytes(s['bytes']):>12} {gbps:>8}{flag}"
            )
        return lines
    except Exception:  # pragma: no cover - observability fails soft
        return []
