"""The kernel tier — the port's CUDA kernels checked on the card, behind
``python -m heat3d_tpu_torch lint --kernel``.

The source tier audits source; value parity (kernel = plain version,
bitwise) audits results. Neither sees what the JAX package's kernel tier
certifies for its Pallas kernels (DMA discipline, ring races, output
coverage, remote targets). On Hopper the counterparts of those blind spots
are out-of-bounds and shared-memory hazards, barrier misuse,
uninitialised reads, cells no thread writes and a ghost that lands from
the wrong shard. Over the judged matrix (:mod:`.cases`: one small case per
kernel instance of ``PERF.md`` §6 rows 1–12) seven families check them —

- :mod:`.sanitize`: ``kernel-memcheck``, ``kernel-races`` (with the
  seeded racy kernel it must flag), ``kernel-sync``, ``kernel-init``:
  each case under ``compute-sanitizer``, in a child;
- :mod:`.coverage` (``kernel-coverage``): NaN sentinels and guard bands
  around every output and landing buffer;
- :mod:`.remote` (``kernel-remote``): shards stamped with their index,
  every ghost held to the neighbour the mesh names;
- :mod:`.resources` (``kernel-resources``): shared memory, registers and
  blocks per SM of each instance against the card.

Findings report through the shared framework and fingerprint on
``(checker, case key, invariant)``. On the CPU (``--device cpu``) the
coverage and remote families run the plain versions; the others read
"not certified: no CUDA device" (a warning).
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence

from heat3d_tpu_torch.analysis.findings import Finding

# checker name -> module path, mirroring analysis.CHECKERS
KERNEL_CHECKERS = {
    "kernel-memcheck": "heat3d_tpu_torch.analysis.kernel.sanitize",
    "kernel-races": "heat3d_tpu_torch.analysis.kernel.sanitize",
    "kernel-sync": "heat3d_tpu_torch.analysis.kernel.sanitize",
    "kernel-init": "heat3d_tpu_torch.analysis.kernel.sanitize",
    "kernel-coverage": "heat3d_tpu_torch.analysis.kernel.coverage",
    "kernel-remote": "heat3d_tpu_torch.analysis.kernel.remote",
    "kernel-resources": "heat3d_tpu_torch.analysis.kernel.resources",
}


def _crashed(name: str, e: Exception, symbol: str) -> Finding:
    return Finding(
        checker=name, severity="error", path="heat3d_tpu_torch/analysis/kernel", line=0,
        code="ANL000", symbol=symbol,
        message=(f"checker crashed: {type(e).__name__}: {e} — fix the checker (a broken "
                 "lint is a silent green)"))


def run_kernel_checkers(root: str, names: Sequence[str], device="cuda:0",
                        scale: str = "small", cases: Optional[Sequence] = None,
                        seeded: bool = True, report: Optional[Dict] = None) -> List[Finding]:
    """Run the named families over the judged matrix (``scale``, or the
    given ``cases``) on ``device``; a crashed family or a broken matrix is
    an ANL000 error, never a silent green. Emits ``kernel_lint_start`` and
    ``kernel_lint_verdict`` (fail-soft: a no-op without a ledger). Fills
    ``report`` when given: the judged cases, each family's verdict per
    case, seconds per family, the resources table, the seeded kernel's
    verdict."""
    import torch

    from heat3d_tpu_torch import obs
    from heat3d_tpu_torch.analysis.kernel import coverage, remote, resources, sanitize
    from heat3d_tpu_torch.analysis.kernel.cases import judged_cases

    findings: List[Finding] = []
    report = {} if report is None else report
    report.update({"device": str(device), "scale": scale, "verdicts": {}, "seconds": {}})
    try:
        cases = list(cases) if cases is not None else judged_cases(scale)
    except Exception as e:  # noqa: BLE001 - surfaced as a finding
        findings.append(_crashed("kernel-matrix", e, "judged_cases"))
        cases = []
    report["cases"] = [c.key for c in cases]
    obs.get().event("kernel_lint_start", families=list(names), cases=len(cases),
                    devices=str(device))
    cuda = torch.device(device).type == "cuda" and torch.cuda.is_available()
    tools = [n for n in names if n in sanitize.TOOLS]
    if tools:
        try:
            findings.extend(sanitize.check(tools, cases, root, device, report, seeded))
        except Exception as e:  # noqa: BLE001
            findings.append(_crashed(",".join(tools), e, "sanitize"))
    for name, mod in (("kernel-coverage", coverage), ("kernel-remote", remote)):
        if name in names:
            t0 = time.perf_counter()
            try:
                findings.extend(mod.check(cases, device, report))
            except Exception as e:  # noqa: BLE001
                findings.append(_crashed(name, e, name))
            report["seconds"][name] = time.perf_counter() - t0
    if "kernel-resources" in names:
        t0 = time.perf_counter()
        if not cuda:
            report["verdicts"]["kernel-resources"] = {c.key: "not certified" for c in cases}
            findings.append(sanitize.uncertified(
                "kernel-resources", "kernel-resources|device", f"no CUDA device ({device})"))
        else:
            try:
                findings.extend(resources.check(cases, report))
            except Exception as e:  # noqa: BLE001
                findings.append(_crashed("kernel-resources", e, "kernel-resources"))
        report["seconds"]["kernel-resources"] = time.perf_counter() - t0
    counts = {"error": 0, "warning": 0, "info": 0}
    for f in findings:
        counts[f.severity] += 1
    obs.get().event("kernel_lint_verdict", families=list(names), **counts)
    return findings
