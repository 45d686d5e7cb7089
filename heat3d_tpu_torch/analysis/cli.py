"""``python -m heat3d_tpu_torch lint`` — run the port's checkers.

Usage::

    python -m heat3d_tpu_torch lint                        # the five source checkers
    python -m heat3d_tpu_torch lint --json                 # machine verdict (CI gate)
    python -m heat3d_tpu_torch lint --checker knob-drift   # one checker (repeatable / CSV)
    python -m heat3d_tpu_torch lint --write-baseline       # grandfather current findings
    python -m heat3d_tpu_torch lint --list                 # checker catalog
    python -m heat3d_tpu_torch lint --kernel [--json]      # kernel tier, on cuda:0
    python -m heat3d_tpu_torch lint --kernel --device cpu  # coverage + remote on the plain versions
    python -m heat3d_tpu_torch lint --all [--json]         # both tiers, one merged verdict

``--kernel`` switches to the kernel-tier catalog
(:mod:`heat3d_tpu_torch.analysis.kernel`): every CUDA kernel instance of
the port runs on a small case under ``compute-sanitizer`` (memcheck,
racecheck, synccheck, initcheck), against NaN sentinels and guard bands
(coverage) and on shards stamped with their index (remote), and each
instance's shared memory, registers and blocks per SM are held against
the card. Findings fingerprint on (checker, case key, invariant).
``--device cpu`` runs the coverage and remote families over the plain
versions; the sanitizer and resources families then read "not
certified: no CUDA device" (a warning, never a clean verdict).

``--ir`` exits 2: the JAX package's IR tier certifies traced programs,
and the port builds none.

Severity policy (``heat3d_tpu_torch/docs/ANALYSIS.md``): rc 1 **only** on
unsuppressed error-severity findings. Suppression is two-layer: inline
``# heat3d-lint: ok=<checker>`` comments on the flagged line, with the
reason beside them, and a baseline file at the repo root
(:data:`~heat3d_tpu_torch.analysis.findings.BASELINE_NAME`) of
line-number-free fingerprints. The port ships no baseline.
"""

from __future__ import annotations

import argparse
import importlib
import os
import sys
from typing import List, Optional

from heat3d_tpu_torch.analysis import CHECKERS, astutil
from heat3d_tpu_torch.analysis.findings import (
    BASELINE_NAME,
    Finding,
    apply_suppressions,
    exit_code,
    load_baseline,
    render_json,
    render_table,
    write_baseline,
)

IR_REFUSED = (
    "lint --ir: the IR tier certifies the JAX package's traced programs "
    "(jaxprs); the port builds no traced programs, so it has no IR tier — "
    "run `lint` (source) or `lint --kernel` (the CUDA kernels on the card)")


def run_checkers(root: str, names: List[str]) -> List[Finding]:
    """All findings from the named source checkers, in catalog order. A
    checker that crashes is itself an error finding — a broken lint must
    never read as a clean repo."""
    astutil.clear_cache()
    findings: List[Finding] = []
    for name in names:
        try:
            mod = importlib.import_module(CHECKERS[name])
            findings.extend(mod.check(root))
        except Exception as e:  # noqa: BLE001 - surfaced as a finding
            findings.append(
                Finding(
                    checker=name,
                    severity="error",
                    path="heat3d_tpu_torch/analysis",
                    line=0,
                    code="ANL000",
                    symbol=name,
                    message=(
                        f"checker crashed: {type(e).__name__}: {e} — fix "
                        "the checker (a broken lint is a silent green)"
                    ),
                )
            )
    return findings


def _resolve_checkers(raw: List[str], catalog=None) -> List[str]:
    catalog = CHECKERS if catalog is None else catalog
    if not raw:
        return list(catalog)
    names: List[str] = []
    for item in raw:
        for name in item.split(","):
            name = name.strip()
            if name not in catalog:
                raise SystemExit(
                    f"heat3d_tpu_torch lint: unknown checker {name!r} "
                    f"(known: {', '.join(catalog)})"
                )
            if name not in names:
                names.append(name)
    return names


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="heat3d_tpu_torch lint",
        description="SPMD-safety and invariant lints over the port "
        "(heat3d_tpu_torch/docs/ANALYSIS.md). rc 1 only on unsuppressed "
        "error-severity findings.",
    )
    p.add_argument("--json", action="store_true", help="machine verdict")
    p.add_argument(
        "--ir", action="store_true",
        help="the JAX package's IR tier: no counterpart in the port (exits 2)",
    )
    p.add_argument(
        "--kernel", action="store_true",
        help="run the kernel tier (every CUDA kernel instance under "
        "compute-sanitizer, NaN sentinels, stamped shards, resources) "
        "instead of the source checkers",
    )
    p.add_argument(
        "--all", action="store_true",
        help="run the source and kernel tiers with a single merged "
        "verdict and rc",
    )
    p.add_argument(
        "--device", default="cuda:0",
        help="the kernel tier's device (default cuda:0; cpu runs coverage "
        "and remote over the plain versions)",
    )
    p.add_argument(
        "--checker", action="append", default=[],
        help="run only this checker (repeatable, or comma-separated)",
    )
    p.add_argument(
        "--root", default=None,
        help="checkout root to lint (default: the root of the installed "
        "source tree)",
    )
    p.add_argument(
        "--baseline", default=None,
        help=f"baseline suppressions file (default: <root>/{BASELINE_NAME})",
    )
    p.add_argument(
        "--write-baseline", action="store_true",
        help="regenerate the baseline from the current unsuppressed "
        "findings and exit 0 (review the diff before committing)",
    )
    p.add_argument(
        "--no-suppress", action="store_true",
        help="report everything, ignoring the baseline and inline "
        "suppressions (audit view)",
    )
    p.add_argument(
        "--list", action="store_true", help="print the checker catalog"
    )
    args = p.parse_args(argv)

    if args.ir:
        print(f"heat3d_tpu_torch {IR_REFUSED}", file=sys.stderr)
        return 2
    if args.kernel and args.all:
        raise SystemExit(
            "heat3d_tpu_torch lint: --kernel and --all are mutually exclusive"
        )
    if args.kernel or args.all:
        from heat3d_tpu_torch.analysis.kernel import KERNEL_CHECKERS

        catalog = dict(KERNEL_CHECKERS) if args.kernel else {**CHECKERS, **KERNEL_CHECKERS}
    else:
        catalog = CHECKERS

    if args.list:
        for name, modpath in catalog.items():
            doc = (importlib.import_module(modpath).__doc__ or "").strip()
            print(f"{name}: {doc.splitlines()[0]}")
        return 0

    root = os.path.abspath(args.root) if args.root else astutil.repo_root()
    baseline_path = args.baseline or os.path.join(root, BASELINE_NAME)
    names = _resolve_checkers(args.checker, catalog)

    findings = run_checkers(root, [n for n in names if n in CHECKERS])
    kernel_names = [n for n in names if n not in CHECKERS]
    kernel_report: dict = {}
    if kernel_names:
        from heat3d_tpu_torch.analysis.kernel import run_kernel_checkers

        findings.extend(run_kernel_checkers(root, kernel_names, device=args.device,
                                            report=kernel_report))
    baseline = load_baseline(baseline_path)
    if args.no_suppress:
        kept, suppressed = findings, []
    else:
        kept, suppressed = apply_suppressions(root, findings, baseline)

    if args.write_baseline:
        # Regenerate from the current findings with only INLINE
        # suppressions applied — a still-firing grandfathered finding
        # must stay in the baseline, not silently drop out and red the
        # next run. Entries owned by checkers not run this invocation
        # are carried over verbatim.
        kept_inline, _ = apply_suppressions(root, findings, {})
        # never grandfather a checker crash: its fingerprint is anchored
        # on the checker name alone, so one baselined ANL000 would
        # suppress EVERY future crash of that checker
        kept_inline = [f for f in kept_inline if f.code != "ANL000"]
        carried = [
            e for e in baseline.values() if e.get("checker") not in names
        ]
        n = write_baseline(baseline_path, kept_inline, carry=carried)
        print(
            f"heat3d_tpu_torch lint: baseline written to {baseline_path} "
            f"({n} suppression(s))"
        )
        return 0

    if args.json:
        render_json(kept, suppressed, names,
                    extra={"kernel_tier": kernel_report} if kernel_names else None)
    else:
        render_table(kept, suppressed)
    return exit_code(kept)


if __name__ == "__main__":
    sys.exit(main())
