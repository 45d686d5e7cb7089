"""The shared finding/severity/suppression framework every checker of the
port emits through (a copy of the JAX package's ``analysis/findings.py``,
with the port's own baseline name).

A checker is a function ``check(root, ...) -> List[Finding]``; the CLI
(``python -m heat3d_tpu_torch lint`` — :mod:`heat3d_tpu_torch.analysis.cli`)
runs them, applies the two suppression layers, and renders a human table or
``--json``. The contract downstream tooling relies on:

- **Severity policy**: ``error`` findings are invariant violations — rc 1;
  ``warning`` is drift that needs a decision but not a red build (and
  every kernel-tier case a tool could not certify); ``info`` is headroom
  context. Only unsuppressed *errors* fail the lint.
- **Suppression**: (a) an inline ``# heat3d-lint: ok=<checker>[,..]``
  comment on the flagged line, with the reason beside it; (b) the
  baseline file (:data:`BASELINE_NAME` at the repo root) holding
  fingerprints of grandfathered findings, written by ``lint
  --write-baseline``. The port ships no baseline: it is lint-clean with
  nothing grandfathered. Fingerprints are line-number-free (checker |
  code | path | symbol-or-normalized-message), so routine edits don't
  invalidate a baseline.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import re
from typing import Any, Dict, Iterable, List, Optional, Tuple

ERROR = "error"
WARNING = "warning"
INFO = "info"
SEVERITIES = (ERROR, WARNING, INFO)

# the port's own name: it never collides with the JAX package's
# ``.heat3d-lint-baseline.json`` in the same checkout
BASELINE_NAME = ".heat3d-torch-lint-baseline.json"
BASELINE_VERSION = 1

# inline suppression: `# heat3d-lint: ok` (all checkers) or
# `# heat3d-lint: ok=checker-a,checker-b` on the flagged line
_INLINE_RE = re.compile(r"#\s*heat3d-lint:\s*ok(?:=([\w,-]+))?")


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


# ---- suppression ----------------------------------------------------------


def load_baseline(path: str) -> Dict[str, Dict[str, Any]]:
    """fingerprint -> suppression entry from the baseline file (empty when
    the file is absent or unreadable — a broken baseline must surface the
    findings it hid, never hide them harder)."""
    try:
        with open(path) as f:
            data = json.load(f)
    except (OSError, json.JSONDecodeError):
        return {}
    if not isinstance(data, dict):
        return {}
    out: Dict[str, Dict[str, Any]] = {}
    for entry in data.get("suppressions") or []:
        if isinstance(entry, dict) and isinstance(entry.get("fingerprint"), str):
            out[entry["fingerprint"]] = entry
    return out


_ENTRY_KEYS = (
    "fingerprint", "checker", "code", "path", "symbol", "severity", "message"
)


def write_baseline(
    path: str,
    findings: Iterable[Finding],
    carry: Iterable[Dict[str, Any]] = (),
) -> int:
    """Regenerate the baseline from the given findings; returns the entry
    count. Entries carry enough context to review the file without
    re-running the lint. ``carry`` preserves prior entries verbatim —
    the CLI passes the entries owned by checkers NOT run this
    invocation, so ``--checker X --write-baseline`` cannot wipe every
    other checker's grandfathered sites."""
    entries = [
        {
            "fingerprint": f.fingerprint(),
            "checker": f.checker,
            "code": f.code,
            "path": f.path,
            "symbol": f.symbol,
            "severity": f.severity,
            "message": f.message,
        }
        for f in findings
    ]
    seen = {e["fingerprint"] for e in entries}
    for e in carry:
        if isinstance(e, dict) and e.get("fingerprint") not in seen:
            entries.append({k: e.get(k) for k in _ENTRY_KEYS})
            seen.add(e["fingerprint"])
    entries.sort(key=lambda e: (e["checker"], e["path"], e["fingerprint"]))
    payload = {"version": BASELINE_VERSION, "suppressions": entries}
    with open(path, "w") as f:
        json.dump(payload, f, indent=2)
        f.write("\n")
    return len(entries)


def _inline_suppressed(root: str, finding: Finding, cache: Dict[str, List[str]]) -> bool:
    if finding.line <= 0:
        return False
    path = os.path.join(root, finding.path)
    if path not in cache:
        try:
            with open(path) as f:
                cache[path] = f.readlines()
        except OSError:
            cache[path] = []
    lines = cache[path]
    if finding.line > len(lines):
        return False
    m = _INLINE_RE.search(lines[finding.line - 1])
    if not m:
        return False
    which = m.group(1)
    return which is None or finding.checker in which.split(",")


def apply_suppressions(
    root: str,
    findings: List[Finding],
    baseline: Dict[str, Dict[str, Any]],
) -> Tuple[List[Finding], List[Finding]]:
    """(kept, suppressed): baseline fingerprints and inline ``heat3d-lint:
    ok`` comments both suppress."""
    kept: List[Finding] = []
    suppressed: List[Finding] = []
    cache: Dict[str, List[str]] = {}
    for f in findings:
        if f.fingerprint() in baseline or _inline_suppressed(root, f, cache):
            suppressed.append(f)
        else:
            kept.append(f)
    return kept, suppressed


# ---- reporting ------------------------------------------------------------


def counts(findings: Iterable[Finding]) -> Dict[str, int]:
    c = {s: 0 for s in SEVERITIES}
    for f in findings:
        c[f.severity] += 1
    return c


def exit_code(findings: Iterable[Finding]) -> int:
    """rc 1 only on unsuppressed error-severity findings."""
    return 1 if any(f.severity == ERROR for f in findings) else 0


def render_table(
    findings: List[Finding], suppressed: List[Finding], out=None
) -> None:
    import sys

    out = out or sys.stdout
    by_checker: Dict[str, List[Finding]] = {}
    for f in findings:
        by_checker.setdefault(f.checker, []).append(f)
    sev_order = {ERROR: 0, WARNING: 1, INFO: 2}
    for checker in sorted(by_checker):
        print(f"\n[{checker}]", file=out)
        for f in sorted(
            by_checker[checker], key=lambda f: (sev_order[f.severity], f.path, f.line)
        ):
            loc = f"{f.path}:{f.line}" if f.line else f.path
            sym = f" ({f.symbol})" if f.symbol else ""
            print(f"  {f.severity.upper():<7} {f.code} {loc}{sym}: {f.message}", file=out)
    c = counts(findings)
    tail = f"{len(findings)} finding(s): {c[ERROR]} error, {c[WARNING]} warning, {c[INFO]} info"
    if suppressed:
        tail += f"; {len(suppressed)} suppressed"
    print(("\n" if findings else "") + tail, file=out)


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


def render_json(
    findings: List[Finding],
    suppressed: List[Finding],
    checkers_run: List[str],
    out=None,
    extra: Optional[Dict[str, Any]] = None,
) -> None:
    """The machine verdict; ``extra`` adds keys beside it (the kernel
    tier's per-case verdicts)."""
    import sys

    out = out or sys.stdout
    payload = {
        "version": 1,
        "checkers": checkers_run,
        "counts": counts(findings),
        "suppressed": len(suppressed),
        "rc": exit_code(findings),
        "findings": [f.to_dict() for f in findings],
        **(extra or {}),
    }
    json.dump(payload, out, indent=2, default=repr)
    out.write("\n")
