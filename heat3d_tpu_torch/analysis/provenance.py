"""Provenance lint for the port's bench result records (a copy of the JAX
package's ``analysis/provenance.py``: the same rules, so a port row and a
JAX row are held to one standard), sharing the analysis finding/report
format.

A bench row must prove itself from the row alone: a ``ts`` naming its
measurement session, the route-provenance fields saying which kernel path
actually ran, ``sync_rtt_s`` making ``rtt_dominated`` auditable, and —
on ``time_blocking > 1`` rows — ``cost_redundant_flops_frac`` carrying
the deep-tb recompute tax. Rows that cannot prove those fail (rc 1).
Sessions appending to a shared file scope the lint with ``--start-line``
to the rows THEY wrote.

    python -m heat3d_tpu_torch.analysis.provenance [--start-line N] rows.jsonl

The knob-drift checker cross-references :data:`ROUTE_FIELDS` against the
port's bench harness, so a field required here but never recorded there
is a static lint failure before any row is ever measured.
"""

from __future__ import annotations

import json
import sys
from typing import List, Tuple

from heat3d_tpu_torch.analysis.findings import ERROR, Finding, data_lint_main

ROUTE_FIELDS = (
    "platform",
    "direct_path",
    "mehrstellen_route",
    "fused_dma_path",
    "fused_dma_emulated",
    "streamk_path",
    "streamk_emulated",
    # exchange-plan mode (monolithic | partitioned): the partitioned A/B
    # changes the message schedule, not the bytes — rows must carry it
    "halo_plan",
    # fused in-kernel RDMA route (fused_rdma='on' / HEAT3D_FUSED_RDMA):
    # the halo bytes move inside the step kernel, so the traffic model
    # and the fused-vs-unfused A/B must be keyable from the row alone;
    # the _emulated twin marks reference-contract (off-TPU) resolutions
    "fused_rdma_path",
    "fused_rdma_emulated",
)
MAX_REPORT = 20

Defect = Tuple[int, str]


def check_row(r: dict) -> list:
    problems = []
    ts = r.get("ts")
    if not (isinstance(ts, str) and ts):
        problems.append(
            "ts missing/null (row cannot prove its measurement session)"
        )
    if r.get("bench") == "throughput":
        for f in ROUTE_FIELDS:
            if f not in r:
                problems.append(f"missing route-provenance field {f!r}")
        # equation-family provenance (PR 11): families share stencil
        # footprints but not chains or stability envelopes — a
        # spec-built family's rate must be keyable from the row alone
        # so it never cross-compares with (or masquerades as) heat
        if not (isinstance(r.get("equation"), str) and r["equation"]):
            problems.append(
                "equation missing/empty (equation-family provenance — "
                "obs regress keys baselines on it; legacy rows key to "
                "heat)"
            )
        # integrator provenance (PR 19): integrators share grids but not
        # per-step work (CG matvecs, two-level carries) — a rate must be
        # keyable to its integrator from the row alone
        if not (isinstance(r.get("integrator"), str) and r["integrator"]):
            problems.append(
                "integrator missing/empty (time-integrator provenance — "
                "obs regress keys baselines on it; legacy rows key to "
                "explicit-euler)"
            )
        if "chain_ops" not in r:
            problems.append("missing route-provenance field 'chain_ops'")
        elif r["chain_ops"] is None and r.get("backend") != "conv":
            problems.append(
                "chain_ops is null on a non-conv row (op-count provenance "
                "lost)"
            )
        # temporally-blocked rows execute redundant ghost-ring recompute;
        # without the recorded fraction their Gcell/s cannot be discounted
        # to useful work at judging time (deep-tb honesty — a tb=4 "win"
        # must carry its own recompute tax on the row)
        tb = r.get("time_blocking", 1)
        if isinstance(tb, int) and tb > 1 and not isinstance(
            r.get("cost_redundant_flops_frac"), (int, float)
        ):
            problems.append(
                "cost_redundant_flops_frac missing/non-numeric on a "
                f"time_blocking={tb} row (redundant-compute provenance "
                "lost)"
            )
        # ensemble-workload honesty (PR 7): how many members does this
        # rate aggregate? A packed batch's total Gcell/s is otherwise
        # indistinguishable from a single-run rate at judging time (the
        # per-member effective rate is gcell_per_sec / members_per_step;
        # solo rows carry [1]/1, serve.bench rows carry [B]/B)
        bs = r.get("batch_shape")
        if not (
            isinstance(bs, list)
            and bs
            and all(isinstance(x, int) and x >= 1 for x in bs)
        ):
            problems.append(
                "batch_shape missing/invalid (ensemble-workload provenance "
                "— a packed batch's total rate must say so on the row)"
            )
        mp = r.get("members_per_step")
        if not (isinstance(mp, int) and mp >= 1):
            problems.append(
                "members_per_step missing/non-int (per-member effective "
                "rate not derivable from the row)"
            )
    elif r.get("bench") == "halo":
        if "platform" not in r:
            problems.append("missing 'platform'")
        # halo p50 rows are THE judged metric of the plan A/B: a row that
        # cannot say which exchange schedule it measured is unjudgeable
        if "halo_plan" not in r:
            problems.append(
                "missing 'halo_plan' (exchange-plan provenance — a "
                "partitioned p50 must not masquerade as monolithic)"
            )
    elif r.get("bench") == "weak_scaling":
        # weak-scaling harness rows (the JAX package's
        # scripts/weak_scaling.py): the rung's mesh, per-chip rate, and its post-heal status must be provable
        # from the row alone — a degraded rung's throughput unlabeled
        # would pollute the ≥90%-weak-scaling record
        if "platform" not in r:
            problems.append("missing 'platform'")
        if not isinstance(r.get("gcell_per_sec_per_chip"), (int, float)):
            problems.append(
                "gcell_per_sec_per_chip missing/non-numeric (the judged "
                "weak-scaling metric)"
            )
        if "post_heal" not in r or not isinstance(r["post_heal"], bool):
            problems.append(
                "post_heal missing/non-bool (elastic provenance — a rung "
                "measured after a re-factorization must say so)"
            )
        if r.get("post_heal") and not isinstance(
            r.get("recovery_s"), (int, float)
        ):
            problems.append(
                "recovery_s missing/non-numeric on a post_heal row (the "
                "chaos harness's judged recovery time)"
            )
    elif r.get("bench") == "soak":
        # sustained-traffic soak rows (serve/loadgen.py): the verdict's
        # conservation law and chaos provenance must be provable from
        # the row alone — a soak rate without its shed/degraded context
        # is indistinguishable from an unloaded drain
        if "platform" not in r:
            problems.append("missing 'platform'")
        if not isinstance(r.get("duration_s"), (int, float)):
            problems.append(
                "duration_s missing/non-numeric (soak length unprovable)"
            )
        if not isinstance(r.get("seed"), int):
            problems.append(
                "seed missing/non-int (the soak schedule is unreplayable)"
            )
        counts = {
            k: r.get(k)
            for k in ("submitted", "admitted", "shed", "delivered")
        }
        if not all(isinstance(v, int) for v in counts.values()):
            problems.append(
                "submitted/admitted/shed/delivered must all be ints "
                "(shed-request accounting lost)"
            )
        elif counts["admitted"] + counts["shed"] != counts["submitted"]:
            problems.append(
                "admitted + shed != submitted (the soak's conservation "
                "law does not hold on this row)"
            )
        if not isinstance(
            r.get("sustained_member_gcell_per_s"), (int, float)
        ):
            problems.append(
                "sustained_member_gcell_per_s missing/non-numeric (the "
                "judged soak metric)"
            )
        if not isinstance(r.get("degraded_s"), (int, float)):
            problems.append(
                "degraded_s missing/non-numeric (chaos provenance — a "
                "soak without its degraded budget is unjudgeable)"
            )
        if not (isinstance(r.get("slo"), str) and r["slo"]):
            problems.append(
                "slo missing/empty (the verdict that judged this soak)"
            )
    if r.get("bench") in ("throughput", "halo") and not isinstance(
        r.get("sync_rtt_s"), (int, float)
    ):
        problems.append(
            "sync_rtt_s missing/non-numeric (RTT-dominated samples not "
            "auditable from the row)"
        )
    # elastic provenance (any row kind): a row measured after a
    # survivor-mesh re-factorization must carry the mesh it actually ran
    # on — degraded throughput can never pollute baselines unlabeled
    if r.get("post_heal"):
        ms = r.get("mesh_shape")
        if not (
            isinstance(ms, list)
            and len(ms) == 3
            and all(isinstance(x, int) and x >= 1 for x in ms)
        ):
            problems.append(
                "mesh_shape missing/invalid on a post_heal row (the "
                "degraded mesh the rate was measured on)"
            )
    return problems


def check_file(path: str, start_line: int = 1) -> list:
    """(line_no, description) for every defect in ``path`` at or after
    ``start_line`` (1-based; earlier lines belong to a prior session)."""
    bad = []
    try:
        f = open(path)
    except OSError as e:
        return [(0, f"cannot open {path}: {e}")]
    with f:
        for i, line in enumerate(f, start=1):
            if i < start_line:
                continue
            line = line.strip()
            if not line:
                continue
            try:
                r = json.loads(line)
            except json.JSONDecodeError:
                bad.append((i, "unparseable JSON"))
                continue
            if not isinstance(r, dict) or r.get("bench") not in (
                "throughput",
                "halo",
                "weak_scaling",
                "soak",
            ):
                continue  # foreign lines (headline records, notes) pass
            for p in check_row(r):
                bad.append((i, p))
    return bad


def check_file_findings(path: str, start_line: int = 1) -> List[Finding]:
    """The same defects as :func:`check_file`, in the shared analysis
    finding format (data lints are error-severity by definition: a row
    that cannot prove its provenance is already lost)."""
    return [
        Finding(
            checker="provenance",
            severity=ERROR,
            path=path,
            line=line_no,
            code="DATA-PROV",
            message=desc,
        )
        for line_no, desc in check_file(path, start_line)
    ]


def main(argv=None) -> int:
    return data_lint_main(
        argv, "provenance", check_file, __doc__, max_report=MAX_REPORT
    )


if __name__ == "__main__":
    sys.exit(main())
