"""The finding record and the data-lint driver the ledger lint reports
through (a copy of the parts of the JAX package's ``analysis/findings.py``
that ``obs check`` reaches; its suppression baseline and lint renderers
belong to the source checkers, which are not ported).

Severity policy: ``error`` findings are invariant violations — rc 1;
``warning`` is drift that needs a decision but not a red build; ``info``
is context.
"""

from __future__ import annotations

import dataclasses
import hashlib
import re
from typing import Any, Dict, Optional

ERROR = "error"
WARNING = "warning"
INFO = "info"
SEVERITIES = (ERROR, WARNING, INFO)


@dataclasses.dataclass(frozen=True)
class Finding:
    """One defect: which checker, how bad, where, what."""

    checker: str  # checker name, e.g. "collective-divergence"
    severity: str  # error | warning | info
    path: str  # repo-relative file path
    line: int  # 1-based; 0 = file/project-level finding
    code: str  # stable short code, e.g. "ANL101"
    message: str
    symbol: Optional[str] = None  # enclosing function/registry key, if any

    def __post_init__(self):
        if self.severity not in SEVERITIES:
            raise ValueError(f"severity {self.severity!r} not in {SEVERITIES}")

    def fingerprint(self) -> str:
        """Line-number-free identity for baseline suppression: stable
        across unrelated edits to the file (numbers in the message are
        normalized away so shape/byte counts don't churn the baseline)."""
        anchor = self.symbol or re.sub(r"\d+", "N", self.message)
        base = f"{self.checker}|{self.code}|{self.path}|{anchor}"
        return hashlib.sha1(base.encode()).hexdigest()[:16]

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["fingerprint"] = self.fingerprint()
        return d


def data_lint_main(
    argv,
    label: str,
    check_file,
    doc: Optional[str],
    taxonomy_flag: bool = False,
    max_report: int = 20,
) -> int:
    """Shared CLI driver for the promoted data lints (ledger,
    provenance): one flag surface and report shape, so the two
    thin-wrapper scripts cannot drift. ``check_file(path, start_line
    [, taxonomy=...]) -> [(line, description), ...]``; rc 1 on any
    defect, 2 on usage errors."""
    import sys

    argv = list(sys.argv[1:] if argv is None else argv)
    start_line = 1
    taxonomy = False
    flags = ("--start-line", "--taxonomy") if taxonomy_flag else ("--start-line",)
    while argv and argv[0] in flags:
        if argv[0] == "--taxonomy":
            taxonomy = True
            argv = argv[1:]
            continue
        if len(argv) < 2:
            print("--start-line needs a value", file=sys.stderr)
            return 2
        start_line = int(argv[1])
        argv = argv[2:]
    if not argv:
        print(doc, file=sys.stderr)
        return 2
    kwargs = {"taxonomy": taxonomy} if taxonomy_flag else {}
    failed = False
    for path in argv:
        bad = check_file(path, start_line, **kwargs)
        if not bad:
            print(f"{label} ok: {path}")
            continue
        failed = True
        print(
            f"{label} FAIL: {path}: {len(bad)} defect(s)", file=sys.stderr
        )
        for line_no, desc in bad[:max_report]:
            print(f"  {path}:{line_no}: {desc}", file=sys.stderr)
        if len(bad) > max_report:
            print(f"  ... and {len(bad) - max_report} more", file=sys.stderr)
    return 1 if failed else 0
