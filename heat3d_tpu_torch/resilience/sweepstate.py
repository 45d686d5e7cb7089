"""Resumable sweep state: an interrupted A/B sweep resumes at the first
missing row.

A copy of ``heat3d_tpu.resilience.sweepstate`` over the port's
``SolverConfig``: the same journal format and the same ``row_key``
strings, with the effective plan mode and fused-RDMA knob from the port's
own rules (``parallel.plan.effective_halo_plan``,
``parallel.step.resolve_fused_rdma``).

A measurement sweep is a sequence of rows (suite configs, A/B arms,
profile stages). When the backend dies or the sweep is killed, the rows
already landed must never be re-measured — the next window spends itself
on the MISSING rows.

``SweepState`` is an append-only JSONL journal of completed row keys.
Appends are O(one line) and crash-safe in the only way that matters: a
torn final line (power loss mid-append) is ignored on reload, so the worst
case is re-measuring the one row whose record tore. Shell scripts use
the CLI form::

    python -m heat3d_tpu_torch.resilience.sweepstate done  STATE KEY   # rc 0 if done
    python -m heat3d_tpu_torch.resilience.sweepstate mark  STATE KEY [JSON]
    python -m heat3d_tpu_torch.resilience.sweepstate list  STATE
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Iterable, List, Optional


class SweepState:
    """Per-row completion journal backed by one JSONL file.

    Keys are caller-chosen strings; make them a stable function of the
    row's full configuration (the bench harness uses
    :func:`row_key`), never of its position in the sweep — reordering
    the sweep must not orphan completed work.
    """

    def __init__(self, path: str):
        self.path = path
        self._done: Dict[str, dict] = {}
        self._load()

    def _load(self) -> None:
        try:
            f = open(self.path)
        except OSError:
            return
        with f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue  # torn tail line from a killed append
                if isinstance(rec, dict) and "key" in rec:
                    self._done[rec["key"]] = rec

    def is_done(self, key: str) -> bool:
        return key in self._done

    def record(self, key: str) -> Optional[dict]:
        return self._done.get(key)

    def mark_done(self, key: str, record: Optional[dict] = None) -> None:
        rec = {"key": key, "ts": time.time()}
        if record is not None:
            rec["record"] = record
        self._done[key] = rec
        d = os.path.dirname(os.path.abspath(self.path))
        os.makedirs(d, exist_ok=True)
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")
            f.flush()
            os.fsync(f.fileno())

    def pending(self, keys: Iterable[str]) -> List[str]:
        return [k for k in keys if not self.is_done(k)]

    def keys(self) -> List[str]:
        return list(self._done)


# Env knobs that select which kernel route a throughput row measures
# (the A/B counterfactual arms flip exactly these).
# They are row IDENTITY: two arms differing only in one of them must
# never share a journal entry, or a resume re-emits arm 0's record as
# arm 1's measurement.
ROUTE_ENV_KNOBS = (
    "HEAT3D_MEHRSTELLEN",
    "HEAT3D_FACTOR_Y",
    "HEAT3D_FACTOR_7PT",
    "HEAT3D_NO_DIRECT",
    "HEAT3D_DIRECT_INTERPRET",
    "HEAT3D_DIRECT_FORCE",
    # bypasses the exchange-plan layer (partitioned degrades to the
    # ad-hoc monolithic path — a different measured schedule)
    "HEAT3D_NO_PLAN",
    # forces/stands down the fused in-kernel RDMA superstep route — a
    # fused arm and an unfused arm must never share a journal entry
    "HEAT3D_FUSED_RDMA",
)


def row_key(cfg, bench: str = "throughput") -> str:
    """Stable row key for a bench config: every knob that changes what the
    row measures — config fields AND the route env knobs — none that
    doesn't (steps/repeats tune precision, not identity). Halo rows key
    on the EXCHANGE SHAPE only (grid, mesh, storage dtype, transport —
    run_suite's own dedup rule; route knobs don't touch the exchange):
    the same physical halo measurement must hit the same journal entry no
    matter which config in the sweep happened to land it first."""
    g = "x".join(str(v) for v in cfg.grid.shape)
    m = "x".join(str(v) for v in cfg.mesh.shape)
    # the halo-ordering knob changes what a row measures, so it is part
    # of the identity — suffixed ONLY when non-default, so every journal
    # written before the knob existed keeps resuming cleanly
    ho = "" if cfg.halo_order == "axis" else f":ho{cfg.halo_order}"
    # the exchange-plan mode changes the message schedule a row measures
    # — suffixed ONLY when non-default, same legacy-journal rule as ho.
    # The EFFECTIVE mode keys the journal (HEAT3D_NO_PLAN degrades
    # partitioned to the ad-hoc monolithic schedule; the key must match
    # what the row measured — one rule, parallel.plan).
    from heat3d_tpu_torch.parallel.plan import effective_halo_plan

    hp_mode = effective_halo_plan(cfg)
    hp = "" if hp_mode == "monolithic" else f":hp{hp_mode}"
    if bench == "halo":
        return (
            f"halo:g{g}:m{m}:{cfg.precision.storage}:h{cfg.halo}{ho}{hp}"
        )
    env_bits = ",".join(
        f"{k}={os.environ[k]}" for k in ROUTE_ENV_KNOBS if k in os.environ
    )
    # equation leg only when non-heat (same legacy-journal-compatible
    # suffix rule as :hp / halo_order): every pre-eqn journal key stays
    # byte-identical, and a spec-built family's stage can never collide
    # with the heat stage of the same shape
    eq = "" if cfg.equation == "heat" else f":eq{cfg.equation}"
    # time-integrator leg (same non-default suffix rule): a leapfrog or
    # CG stage of the same shape must not resume an explicit-euler row,
    # while every pre-timeint journal key stays byte-identical
    ti = (
        ""
        if cfg.integrator == "explicit-euler"
        else f":ti{cfg.integrator}"
    )
    # fused-RDMA leg (same non-default suffix rule): the EFFECTIVE knob
    # value (env override / auto fallback resolved — one rule,
    # parallel.step.resolve_fused_rdma), so a fused arm never resumes an
    # unfused row while every pre-fused journal key stays byte-identical
    from heat3d_tpu_torch.parallel.step import resolve_fused_rdma

    fr_mode = resolve_fused_rdma(cfg)
    fr = "" if fr_mode == "off" else f":fr{fr_mode}"
    return (
        f"{bench}:g{g}:m{m}:{cfg.stencil.kind}:{cfg.precision.storage}"
        f":c{cfg.precision.compute}:b{cfg.backend}:tb{cfg.time_blocking}"
        f":ov{int(cfg.overlap)}:h{cfg.halo}{ho}{hp}{eq}{ti}{fr}"
        + (f":env[{env_bits}]" if env_bits else "")
    )


def _main(argv=None) -> int:
    import sys

    argv = list(sys.argv[1:] if argv is None else argv)
    usage = "usage: sweepstate {done|mark|list} STATE_FILE [KEY] [RECORD_JSON]"
    if len(argv) < 2:
        print(usage, file=sys.stderr)
        return 2
    cmd, path = argv[0], argv[1]
    state = SweepState(path)
    if cmd == "list":
        for k in state.keys():
            print(k)
        return 0
    if len(argv) < 3:
        print(usage, file=sys.stderr)
        return 2
    key = argv[2]
    if cmd == "done":
        return 0 if state.is_done(key) else 1
    if cmd == "mark":
        record = json.loads(argv[3]) if len(argv) > 3 else None
        state.mark_done(key, record)
        return 0
    print(usage, file=sys.stderr)
    return 2


if __name__ == "__main__":
    import sys

    sys.exit(_main())
